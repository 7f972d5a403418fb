"""The port's config registry answers as the JAX package's does, field for field."""
import dataclasses

import pytest

pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402

ARCHS = j_list_archs()


def test_same_archs_and_shapes():
    assert list_archs() == ARCHS and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()
    }
    for arch in ARCHS:
        for shape in jbase.SHAPES:
            assert tbase.shape_is_applicable(arch, shape) == jbase.shape_is_applicable(arch, shape)
    for x in (1, 127, 128, 129, 51_865, 92_553):
        assert tbase.pad_to_multiple(x) == jbase.pad_to_multiple(x)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, smoke):
    want = j_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_params() == want.num_params()
    assert got.active_params() == want.active_params()
    assert got.layer_kinds() == want.layer_kinds()
    assert got.scan_plan() == want.scan_plan()
    assert got.vocab_padded == want.vocab_padded
    assert got.q_per_kv == want.q_per_kv


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
