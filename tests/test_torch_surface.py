"""The port's public surface against the JAX package's (ROADMAP C4–C6).

* Every subpackage both packages have exports the reference's ``__all__``
  (and ``core.plan`` its ``TraceSpec``/``CheckpointSpec``), less only the
  names of items still open in ROADMAP A12/A13, listed in ``OPEN``.
* ``iomodel.mpu_io(p, B_M, *, continuous=False)`` gives the reference's
  values, and the continuous form holds the paper's Fig. 6 claim where the
  reference's ``tests/test_engine_strategies.py`` checks it.
* ``GraphSession.resolved_execution(strategy, residency, override=None)``
  takes the reference's arguments (the C4 cases live beside the
  execution-axis tests, ``tests/test_torch_packed_scan.py``).
"""
import importlib

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")

from repro.core import iomodel as jio  # noqa: E402

from repro_torch.core import iomodel as tio  # noqa: E402

SUBPACKAGES = [
    "core", "core.plan", "graph", "storage", "obs", "kernels", "serving",
    "reliability", "runtime.fault", "configs", "models",
    "core.distributed", "models.moe", "models.ssm", "models.rglru",
    "optim", "train", "data", "checkpoint", "optim.adamw", "train.loop", "train.step",
    "sharding", "sharding.rules",
]

# Names the reference exports whose ROADMAP items are still open.
OPEN = {
    "core.distributed": {"graph_input_specs"},  # A13 item 5: the dry run's stand-ins
}


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_all_holds_the_reference(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    missing = set(ref.__all__) - set(port.__all__) - OPEN.get(name, set())
    assert not missing, f"repro_torch.{name} lacks {sorted(missing)}"
    for n in port.__all__:
        assert hasattr(port, n), f"repro_torch.{name}.__all__ names {n!r}, which it lacks"


def test_the_open_names_are_really_open():
    """Each excluded name is still absent: the list shrinks as A12/A13 land."""
    for name, names in OPEN.items():
        port = importlib.import_module(f"repro_torch.{name}")
        assert not names & set(port.__all__), name


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("P", [1, 4, 16, 64])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.37, 0.5, 0.99, 1.0, 2.5])
def test_mpu_io_matches_the_reference(continuous, P, frac):
    for n, deg in ((1000, 8), (2_396_383, 27), (97, 1)):
        tp, jp = tio.IOParams(n=n, m=n * deg, P=P), jio.IOParams(n=n, m=n * deg, P=P)
        B_M = int(2 * n * tp.Ba * frac)
        assert tio.mpu_io(tp, B_M, continuous=continuous) == jio.mpu_io(jp, B_M, continuous=continuous)
    assert tio.mpu_io(tp, B_M) == tio.mpu_io(tp, B_M, continuous=False)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(100, 10**6), deg=st.integers(1, 32), P=st.integers(1, 64), frac=st.floats(0.0, 1.5))
def test_mpu_continuous_dominates_turbograph_like(n, deg, P, frac):
    """The paper's Fig. 6 claim in its continuous-Q setting, as the reference checks it."""
    p = tio.IOParams(n=n, m=n * deg, P=P)
    B_M = int(2 * n * p.Ba * frac)
    H = p.m * (p.Ba + p.Bv) / p.d
    if B_M > 0 and H <= 2.9 * p.n * p.Ba:
        r_tg, w_tg = tio.turbograph_like_io(p, B_M)
        r_c, w_c = tio.mpu_io(p, B_M, continuous=True)
        assert r_c + w_c <= r_tg + w_tg + 1e-6
    r, w = tio.mpu_io(p, B_M, continuous=True)
    assert (r, w) == jio.mpu_io(jio.IOParams(n=n, m=n * deg, P=P), B_M, continuous=True)
