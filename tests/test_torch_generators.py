"""The remaining generators against the JAX package's, array for array."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.graph import generators as jgen  # noqa: E402

from repro_torch.graph import generators as tgen  # noqa: E402


@pytest.mark.parametrize(
    "kw", [dict(n=500, seed=0), dict(n=2000, k=8, seed=3), dict(n=3, seed=1), dict(n=1, seed=2)]
)
def test_random_geometric_equals_reference(kw):
    for a, b in zip(tgen.random_geometric(**kw), jgen.random_geometric(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 17])
def test_complete_equals_reference(n):
    for a, b in zip(tgen.complete(n), jgen.complete(n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_paper_dataset_names_equal_reference():
    assert tgen.paper_dataset_names() == jgen.paper_dataset_names()


@pytest.mark.parametrize("name", ["live-journal", "delaunay_n15"])
def test_paper_dataset_equals_reference(name):
    for a, b in zip(tgen.paper_dataset(name), jgen.paper_dataset(name)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_paper_dataset_table_equals_reference():
    assert tgen._PAPER_DATASETS == jgen._PAPER_DATASETS
    with pytest.raises(KeyError):
        tgen.paper_dataset("no-such-graph")
