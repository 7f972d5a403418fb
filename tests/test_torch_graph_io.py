"""The port's graph I/O (``repro_torch.graph.io``) against ``repro.graph.io``.

The chunked text reader is the external builder's front end: comments,
blank lines, CRLF, extra columns, chunk boundaries and malformed lines
must come out as the JAX package's. Also the npz round trips (dtypes kept)
and the preprocessing helpers of the streaming build
(``merge_unique_ids``, ``map_to_dense``).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.graph import io as jio  # noqa: E402
from repro.graph import preprocess as jpre  # noqa: E402

from repro_torch.graph import io as tio  # noqa: E402
from repro_torch.graph import preprocess as tpre  # noqa: E402

TEXT = (
    "# SNAP-style header\r\n"
    "1 2\r\n"
    "\r\n"
    "   3\t4   \r\n"
    "# mid-file comment\n"
    "5 6 0.5 extra columns\n"
    "1099511627776 7\n"
    "8 8 2.0\n"
)


def _write(tmp_path, text, name="edges.txt"):
    path = tmp_path / name
    path.write_bytes(text.encode())
    return str(path)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk_edges", [1, 2, 3, 5, 1 << 20])
@pytest.mark.parametrize("comment", ["#", "%"])
def test_iter_text_edges_matches_chunk_for_chunk(tmp_path, chunk_edges, comment):
    path = _write(tmp_path, TEXT.replace("#", comment))
    t = list(tio.iter_text_edges(path, comment=comment, chunk_edges=chunk_edges))
    j = list(jio.iter_text_edges(path, comment=comment, chunk_edges=chunk_edges))
    assert len(t) == len(j)
    for tc, jc in zip(t, j):
        _same(tc, jc)


@pytest.mark.parametrize("header", ["% header\n", "%\n"])
def test_other_comment_marks_are_not_comments(tmp_path, header):
    path = _write(tmp_path, header + "1 2\n")
    errors = []
    for mod in (tio, jio):
        with pytest.raises(ValueError) as err:
            mod.load_text_edges(path)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_load_text_edges_matches(tmp_path, weights, dtype):
    body = "\n".join(line for line in TEXT.replace("%", "#").splitlines()) + "\n"
    body = body.replace("1099511627776", "77")
    if weights:
        body = "\n".join(
            line if line.strip().startswith("#") or not line.strip() or len(line.split()) > 2
            else line + " 1.25"
            for line in body.splitlines()
        ) + "\n"
    path = _write(tmp_path, body)
    t = tio.load_text_edges(path, dtype=dtype, weights=weights, chunk_edges=2)
    j = jio.load_text_edges(path, dtype=dtype, weights=weights, chunk_edges=2)
    _same(t, j)
    assert len(t) == (3 if weights else 2)


@pytest.mark.parametrize(
    "line", ["7\n", "1 2 3\n4\n", "x y\n", "1 2\r\n3\r\n"]
)
def test_malformed_lines_raise_like_the_reference(tmp_path, line):
    path = _write(tmp_path, line)
    errors = []
    for mod in (tio, jio):
        with pytest.raises(ValueError) as err:
            mod.load_text_edges(path)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_weights_column_required_when_asked(tmp_path):
    path = _write(tmp_path, "1 2 0.5\n3 4\n")
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="malformed"):
            mod.load_text_edges(path, weights=True)


def test_empty_inputs(tmp_path):
    path = _write(tmp_path, "# only comments\n\n")
    for weights in (False, True):
        _same(
            tio.load_text_edges(path, weights=weights),
            jio.load_text_edges(path, weights=weights),
        )
    assert list(tio.iter_text_edges(path)) == []


@pytest.mark.parametrize("weighted", [False, True])
def test_npz_round_trips_keep_dtypes(tmp_path, weighted):
    src = np.array([1, 5, 9], np.uint32)
    dst = np.array([2, 2, 7], np.int16)
    w = np.array([0.5, 1.0, 2.0], np.float64) if weighted else None
    tio.save_edges(str(tmp_path / "t" / "e.npz"), src, dst, w)
    jio.save_edges(str(tmp_path / "j" / "e.npz"), src, dst, w)
    _same(
        [a for a in tio.load_edges(str(tmp_path / "t" / "e.npz")) if a is not None],
        [a for a in jio.load_edges(str(tmp_path / "j" / "e.npz")) if a is not None],
    )
    el = tpre.degree_and_densify(src, dst, weights=w)
    tio.save_edgelist(str(tmp_path / "el.npz"), el)
    back = tio.load_edgelist(str(tmp_path / "el.npz"))
    jback = jio.load_edgelist(str(tmp_path / "el.npz"))
    for f in ("src", "dst", "out_degree", "in_degree", "id_to_index", "weights"):
        a, b, c = getattr(el, f), getattr(back, f), getattr(jback, f)
        if a is None:
            assert b is None and c is None
            continue
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    assert back.n == jback.n == el.n


def test_merge_unique_ids_and_map_to_dense_match():
    rng = np.random.default_rng(4)
    chunks = [rng.integers(0, 1 << 40, size=n) for n in (0, 1, 50, 300)]
    chunks.append(np.array([3, 3, 3]))
    t_acc = j_acc = np.zeros(0, np.int64)
    for c in chunks:
        t_acc = tpre.merge_unique_ids(t_acc, c, c[::-1])
        j_acc = jpre.merge_unique_ids(j_acc, c, c[::-1])
        assert t_acc.dtype == j_acc.dtype
        np.testing.assert_array_equal(t_acc, j_acc)
    vals = np.concatenate(chunks[1:])
    np.testing.assert_array_equal(
        tpre.map_to_dense(t_acc, vals), jpre.map_to_dense(j_acc, vals)
    )
    assert tpre.map_to_dense(t_acc, vals).dtype == np.int32
    for mod, acc in ((tpre, t_acc), (jpre, j_acc)):
        with pytest.raises(KeyError):
            mod.map_to_dense(acc, np.array([1 << 41]))
        with pytest.raises(KeyError):
            mod.map_to_dense(np.zeros(0, np.int64), np.array([1]))
