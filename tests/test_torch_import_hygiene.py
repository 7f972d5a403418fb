"""The port stands alone: no JAX, nothing of ``repro``, no quiet CPU fall-back."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import identities as tid
from repro_torch.core.dsss import build_dsss
from repro_torch.core.session import GraphSession
from repro_torch.core.vertex_programs import BFS
from repro_torch.graph.generators import ring
from repro_torch.graph.preprocess import degree_and_densify
from repro_torch.kernels import packed_sweep as ps
from repro_torch.reliability import FaultPlan

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(repro_torch.__file__).resolve().parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.MULTILINE)


def test_import_pulls_in_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch, repro_torch.convert, repro_torch.kernels._build\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serving.llm_demo\n"
        "import repro_torch.kernels.flash_attention, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.launch.bench_dsss\n"
        "import repro_torch.launch.bench_packed, repro_torch.launch.b1_cases\n"
        "import repro_torch.core.algorithms, repro_torch.core.engine\n"
        "import repro_torch.core.baselines\n"
        "import repro_torch.obs, repro_torch.obs.__main__, repro_torch.runtime.trace_analysis\n"
        "import repro_torch.storage, repro_torch.storage.__main__, repro_torch.graph.io\n"
        "import repro_torch.reliability, repro_torch.reliability.repair, repro_torch.runtime.fault\n"
        "import repro_torch.serving, repro_torch.serving.server, repro_torch.serving.pool\n"
        "import repro_torch.core.distributed, repro_torch.launch.mesh\n"
        "import repro_torch.models.moe, repro_torch.models.ssm, repro_torch.models.rglru\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint, repro_torch.train\n"
        "import repro_torch.train.loop, repro_torch.launch.train, repro_torch.models.model\n"
        "import repro_torch.sharding, repro_torch.sharding.rules, repro_torch.sharding.fsdp\n"
        "import repro_torch.launch.bench_gloo\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_neither_jax_nor_repro(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), f"{path} imports jax or repro"


def _tiny_graph():
    return build_dsss(degree_and_densify(*ring(16)), 4)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphSession(_tiny_graph())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device("cuda")


def test_convert_without_a_device_raises_without_cuda(monkeypatch):
    from repro_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.attrs_from_numpy(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.aux_from_numpy({"x": np.zeros(4, np.float32)})
    assert convert.attrs_from_numpy(np.zeros(4, np.float32), device="cpu").device.type == "cpu"


def test_lm_entry_points_without_a_device_raise_without_cuda(monkeypatch):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_params
    from repro_torch.serving.llm_demo import ServeEngine

    cfg = get_config("gemma-2b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: Model(cfg),
        lambda: init_params(cfg, 0),
        lambda: ServeEngine(cfg),
        lambda: convert.lm_params_from_numpy(cfg, {}),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert Model(cfg, device="cpu").init(0).device.type == "cpu"


def test_bench_flash_without_cuda_exits_before_timing(monkeypatch):
    """The B3 timing script measures the card or nothing: no CPU numbers."""
    from repro_torch.launch import bench_flash

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_flash.main([])


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's CUDA path."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("kind", ["cuda", "meta"])
def test_wrapper_never_falls_back_to_the_plain_version(kind, monkeypatch):
    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(ps, "packed_sweep_update_ref", no_fallback)
    g = _tiny_graph()
    packed = g.packed_sweep()
    tiles = ps.prepare_packed_tiles(packed, has_weights=False, device="cpu")
    attrs = torch.zeros((1, g.n_pad), dtype=torch.int32)
    if kind == "cuda":
        attrs = attrs.as_subclass(_OnCuda)
    else:
        attrs = attrs.to("meta")
    acc = torch.full((1, g.n_pad), tid.INF_DEPTH, dtype=torch.int32)
    before = ps.launches
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        ps.packed_sweep_update(
            BFS(), attrs, acc, {}, tiles, torch.ones(g.P, dtype=torch.bool), False
        )
    assert ps.launches == before


def test_cpu_session_runs_the_plain_version():
    g = _tiny_graph()
    before = ps.launches
    res = GraphSession(g, device="cpu").run(
        repro_torch.ExecutionPlan(BFS(), max_iters=20, program_kwargs={"root": 0})
    )
    np.testing.assert_array_equal(res.attrs, np.arange(16))
    assert ps.launches == before  # launches count kernel launches only


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake nvcc refused the source' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="fake nvcc refused the source"):
        _build.load("packed_sweep")
    with pytest.raises(RuntimeError, match="exit 2"):
        _build.build_all()
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.parametrize(
    "kwargs,err",
    [
        # Disk residency is ported; it needs a session opened from a .dsss
        # file, and an in-memory graph refuses it, as in the JAX package.
        ({"residency": "disk", "memory_budget": 1000}, ValueError),
        ({"residency": "disk"}, ValueError),
        ({"execution": "packed", "residency": "disk"}, ValueError),
        ({"execution": "per_block", "residency": "disk"}, ValueError),
        ({"residency": "nowhere"}, ValueError),
        # fault_plan= is ported (ROADMAP A10, second part); a plan on an
        # in-memory graph still cannot ask for disk residency.
        ({"fault_plan": FaultPlan.crash_at_sweep(1), "residency": "disk"}, ValueError),
    ],
)
def test_unported_axes_raise(kwargs, err):
    with pytest.raises(err, match="must be one of|disk-backed session"):
        GraphSession(_tiny_graph(), device="cpu", **kwargs)


def test_unported_plans_raise():
    g = _tiny_graph()
    with pytest.raises(ValueError, match="disk-backed session"):
        GraphSession(g, device="cpu", memory_budget=1000).run(
            repro_torch.ExecutionPlan(BFS(), max_iters=4, residency="disk")
        )
    with pytest.raises(ValueError, match="disk-backed session"):
        GraphSession(g, device="cpu", memory_budget=1000).run(
            repro_torch.ExecutionPlan(BFS(), execution="packed", max_iters=4, residency="disk")
        )
    with pytest.raises(ValueError, match="host_memory_budget"):
        repro_torch.get_session(g, device="cpu", host_memory_budget=1000)
    # Checkpoints are ported (ROADMAP A10, second part): anything but a
    # CheckpointSpec is refused, as in the JAX package.
    with pytest.raises(TypeError, match="CheckpointSpec"):
        repro_torch.ExecutionPlan(BFS(), checkpoint=object())
