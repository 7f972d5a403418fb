"""The port's ``.dsss`` store, builder and CLI against ``repro.storage``.

* ``write_dsss`` of the same graph gives byte-identical files in both
  packages (adaptive and subshard packings, a ``src_sorted`` layout, no
  packed section, weighted or not), and so do the external builder
  (``build_dsss_file``, through the in-RAM bucket load and the bounded
  k-way merge) and its text front end (``build_from_text``);
* a file written by the JAX package opens in the port with equal arrays
  and dtypes (graph, padded blocks, packed sweep), and the other way round;
* a bit flip and a truncation fail loudly; ``ReadPolicy`` re-reads, heals
  and quarantines as the reference's does, with the same counters;
* the CLI's ``build``/``info``/``verify`` print what the reference's print.
"""
import dataclasses
import filecmp
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core.dsss as jd  # noqa: E402
import repro.storage as js  # noqa: E402
import repro.storage.format as jfmt  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.generators import ring as j_ring  # noqa: E402
from repro.graph.generators import zipf as j_zipf  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402
from repro.obs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.storage.__main__ import main as j_cli  # noqa: E402

import repro_torch.core.dsss as td  # noqa: E402
import repro_torch.storage as ts  # noqa: E402
import repro_torch.storage.format as tfmt  # noqa: E402
from repro_torch.graph.preprocess import degree_and_densify as t_densify  # noqa: E402
from repro_torch.obs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.storage.__main__ import main as t_cli  # noqa: E402


def _raw(kind: str, weighted: bool):
    if kind == "rmat":
        src, dst = j_rmat(10, edge_factor=8, seed=5)
    elif kind == "ring":
        src, dst = j_ring(200)
    elif kind == "zipf":
        src, dst = j_zipf(300, 2400, seed=2)
    else:  # duplicates and self loops must round through identically
        src, dst = j_er(150, 900, seed=3)
        src = np.concatenate([src, src[:40], np.arange(8)])
        dst = np.concatenate([dst, dst[:40], np.arange(8)])
    w = None
    if weighted:
        w = np.random.default_rng(7).uniform(0.1, 2.0, size=len(src)).astype(np.float32)
    return np.asarray(src), np.asarray(dst), w


def _graphs(kind, weighted, P, src_sorted=False):
    src, dst, w = _raw(kind, weighted)
    jg = jd.build_dsss(j_densify(src, dst, weights=w, drop_self_loops=True), P, src_sorted=src_sorted)
    tg = td.build_dsss(t_densify(src, dst, weights=w, drop_self_loops=True), P, src_sorted=src_sorted)
    return jg, tg


def _chunks(kind, weighted, size):
    src, dst, w = _raw(kind, weighted)

    def chunks():
        for lo in range(0, len(src), size):
            part = (src[lo:lo + size], dst[lo:lo + size])
            yield part if w is None else part + (w[lo:lo + size],)

    return chunks


def _same_file(a, b):
    assert os.path.getsize(a) == os.path.getsize(b)
    assert filecmp.cmp(a, b, shallow=False), f"{a} and {b} differ"


CASES = [
    ("rmat", False, 1), ("rmat", True, 4), ("rmat", False, 8),
    ("ring", False, 4), ("zipf", True, 8), ("er", True, 5),
]


@pytest.mark.parametrize("packing", ["auto", "subshard", None])
@pytest.mark.parametrize("kind,weighted,P", CASES)
def test_write_dsss_is_byte_identical(tmp_path, kind, weighted, P, packing):
    jg, tg = _graphs(kind, weighted, P)
    js.write_dsss(jg, str(tmp_path / "j.dsss"), packing=packing)
    store = ts.write_dsss(tg, str(tmp_path / "t.dsss"), packing=packing)
    _same_file(str(tmp_path / "j.dsss"), str(tmp_path / "t.dsss"))
    assert store.meta["packing"] == ({"auto": "adaptive"}.get(packing, packing))


@pytest.mark.parametrize("weighted", [False, True])
def test_write_dsss_src_sorted_is_byte_identical(tmp_path, weighted):
    jg, tg = _graphs("er", weighted, 4, src_sorted=True)
    js.write_dsss(jg, str(tmp_path / "j.dsss"))
    ts.write_dsss(tg, str(tmp_path / "t.dsss"))
    _same_file(str(tmp_path / "j.dsss"), str(tmp_path / "t.dsss"))
    assert ts.open_dsss(str(tmp_path / "t.dsss")).meta["packing"] == "subshard"


@pytest.mark.parametrize("budget", [1 << 12, 1 << 20])  # k-way merge; in-RAM loads
@pytest.mark.parametrize("kind,weighted,P", CASES)
def test_external_build_is_byte_identical(tmp_path, kind, weighted, P, budget):
    chunks = _chunks(kind, weighted, 333)
    jstats = js.build_dsss_file(chunks, str(tmp_path / "j.dsss"), P, chunk_budget=budget,
                                drop_self_loops=True)
    tstats = ts.build_dsss_file(chunks, str(tmp_path / "t.dsss"), P, chunk_budget=budget,
                                drop_self_loops=True)
    _same_file(str(tmp_path / "j.dsss"), str(tmp_path / "t.dsss"))
    assert dataclasses.asdict(tstats) | {"path": 0} == dataclasses.asdict(jstats) | {"path": 0}
    # ... and equal to the in-memory writer of the same graph.
    _, tg = _graphs(kind, weighted, P)
    ts.write_dsss(tg, str(tmp_path / "w.dsss"))
    _same_file(str(tmp_path / "w.dsss"), str(tmp_path / "t.dsss"))
    # The ledger's bound: twice the budget, whose chunk floor is 1024 edges
    # of 64 transient bytes.
    assert tstats.peak_edge_bytes <= 2 * max(budget, 1024 * 64)
    if budget == 1 << 12 and kind == "rmat":  # buckets past the load: k-way merged
        assert tstats.streamed_buckets > 0


def test_external_build_without_packed_section_and_keeping_duplicates(tmp_path):
    chunks = _chunks("er", False, 100)
    for mod, name in ((js, "j"), (ts, "t")):
        mod.build_dsss_file(chunks, str(tmp_path / f"{name}.dsss"), 3, chunk_budget=1 << 14,
                            dedup=False, packing=None)
    _same_file(str(tmp_path / "j.dsss"), str(tmp_path / "t.dsss"))
    with pytest.raises(ValueError, match="packing"):
        ts.build_dsss_file(chunks, str(tmp_path / "x.dsss"), 3, packing="subshard")


@pytest.mark.parametrize("weighted", [False, True])
def test_build_from_text_is_byte_identical(tmp_path, weighted):
    src, dst, w = _raw("er", weighted)
    lines = ["# edge list\r"]
    for k in range(len(src)):
        lines.append(f"{src[k]} {dst[k]}" + (f" {float(w[k])!r}" if weighted else ""))
    text = tmp_path / "edges.txt"
    text.write_text("\n".join(lines) + "\n")
    kw = dict(weights=weighted, chunk_budget=1 << 14, drop_self_loops=True)
    js.build_from_text(str(text), str(tmp_path / "j.dsss"), 5, **kw)
    ts.build_from_text(str(text), str(tmp_path / "t.dsss"), 5, **kw)
    _same_file(str(tmp_path / "j.dsss"), str(tmp_path / "t.dsss"))


def _assert_store_equal(a, b):
    """Two opened stores (one per package): equal arrays and dtypes."""
    ga, gb = a.graph(), b.graph()
    assert (ga.n, ga.m, ga.P, ga.interval_size, ga.src_sorted) == (
        gb.n, gb.m, gb.P, gb.interval_size, gb.src_sorted
    )
    for f in ("src", "dst", "weights", "offsets", "out_degree", "in_degree",
              "hub_dst_flat", "hub_inv_flat", "hub_offsets"):
        x, y = getattr(ga, f), getattr(gb, f)
        if x is None:
            assert y is None, f
            continue
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
    np.testing.assert_array_equal(ga.edgelist.id_to_index, gb.edgelist.id_to_index)
    ha, hb = a.host_blocks(), b.host_blocks()
    assert list(ha) == list(hb)
    for k in ha:
        for leaf, x in ha[k].items():
            y = hb[k][leaf]
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=f"{k}:{leaf}")
            else:
                assert x == y, (k, leaf)
    pa, pb = a.packed(), b.packed()
    for f in dataclasses.fields(pa):
        x = getattr(pa, f.name)
        y = getattr(pb, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind,weighted,P", CASES[:4])
def test_each_package_opens_the_others_file(tmp_path, kind, weighted, P):
    jg, tg = _graphs(kind, weighted, P)
    js.write_dsss(jg, str(tmp_path / "j.dsss"))
    ts.write_dsss(tg, str(tmp_path / "t.dsss"))
    t_of_j = ts.open_dsss(str(tmp_path / "j.dsss"), verify=True)
    j_of_t = js.open_dsss(str(tmp_path / "t.dsss"), verify=True)
    _assert_store_equal(j_of_t, t_of_j)
    assert isinstance(t_of_j.array("src"), np.memmap)
    # The port's packed sweep from the file equals its in-memory packing.
    mine = tg.packed_sweep("adaptive")
    stored = t_of_j.packed()
    assert stored.interval_size == mine.interval_size
    for f in dataclasses.fields(mine):
        x = getattr(mine, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, getattr(stored, f.name), err_msg=f.name)
    np.testing.assert_array_equal(tg.host_blocks()[(0, 0)]["hub_inv"] if (0, 0) in tg.host_blocks()
                                  else np.zeros(0), t_of_j.host_blocks()[(0, 0)]["hub_inv"]
                                  if (0, 0) in t_of_j.host_blocks() else np.zeros(0))


def _flip(path, seg, delta=1):
    with open(path, "r+b") as f:
        f.seek(seg.offset + seg.nbytes // 2)
        b = f.read(1)
        f.seek(seg.offset + seg.nbytes // 2)
        f.write(bytes([(b[0] + delta) % 256]))


@pytest.mark.parametrize("segment", ["p_src", "blk_hub_inv", "offsets"])
def test_bit_flip_fails_loudly(tmp_path, segment):
    _, tg = _graphs("rmat", False, 4)
    path = str(tmp_path / "g.dsss")
    ts.write_dsss(tg, path)
    _flip(path, ts.open_dsss(path).segments[segment])
    for mod in (ts, js):
        with pytest.raises(mod.ChecksumError, match=segment):
            mod.open_dsss(path, verify=True)
        with pytest.raises(mod.ChecksumError):
            mod.verify_dsss(path)
        assert mod.open_dsss(path).segments[segment].nbytes > 0  # directory intact
    store = ts.open_dsss(path)
    assert store.scan() == [segment]


def test_truncation_and_bad_headers_fail_loudly(tmp_path):
    _, tg = _graphs("ring", False, 4)
    path = tmp_path / "g.dsss"
    ts.write_dsss(tg, str(path))
    data = path.read_bytes()
    cut = tmp_path / "cut.dsss"
    cut.write_bytes(data[: len(data) // 2])
    with pytest.raises(ts.FormatError, match="truncated"):
        ts.open_dsss(str(cut))
    seg = ts.open_dsss(str(path)).segments["p_src"]
    short = tmp_path / "short.dsss"
    # Keep the footer, lose the tail of one segment's bytes.
    short.write_bytes(data[: seg.offset + seg.nbytes // 2] + b"\0" * 0)
    with pytest.raises(ts.FormatError):
        ts.open_dsss(str(short), verify=True)
    tiny = tmp_path / "tiny.dsss"
    tiny.write_bytes(b"NXG")
    with pytest.raises(ts.FormatError, match="too small"):
        ts.open_dsss(str(tiny))
    bad = tmp_path / "bad.dsss"
    bad.write_bytes(b"XXXXXXXX" + data[8:])
    with pytest.raises(ts.FormatError, match="bad magic"):
        ts.open_dsss(str(bad))
    foot = tmp_path / "foot.dsss"
    foot.write_bytes(data[:-3] + bytes(b ^ 0xFF for b in data[-3:]))
    with pytest.raises(ts.ChecksumError, match="footer"):
        ts.open_dsss(str(foot))


def _read_counters(reg):
    return tuple(
        reg.value(name)
        for name in (
            "repro_storage_read_retries_total",
            "repro_storage_heals_total",
            "repro_storage_quarantines_total",
        )
    )


@pytest.mark.parametrize("torn", [0, 1, 2, 5])
def test_read_policy_retries_heals_and_quarantines(tmp_path, monkeypatch, torn):
    """``torn`` reads of a segment fail before it reads clean (5: never)."""
    _, tg = _graphs("rmat", False, 4)
    path = str(tmp_path / "g.dsss")
    ts.write_dsss(tg, path)
    results = []
    for fmt, mod, reg in ((tfmt, ts, T_REGISTRY), (jfmt, js, J_REGISTRY)):
        calls = {"n": 0}
        real = fmt.DSSSStore._checksum_segment

        def torn_read(self, seg, *args, _real=real, _calls=calls, **kw):
            if seg.name == "p_src" and _calls["n"] < torn:
                _calls["n"] += 1
                raise mod.ChecksumError("torn")
            return _real(self, seg, *args, **kw)

        monkeypatch.setattr(fmt.DSSSStore, "_checksum_segment", torn_read)
        monkeypatch.setattr(fmt.time, "sleep", lambda s: None)
        store = mod.open_dsss(path, read_policy=mod.ReadPolicy(max_retries=3, backoff_s=0.0))
        before = _read_counters(reg)
        outcome = "ok"
        try:
            store.ensure_segments(["offsets", "p_src", "p_src"])
        except mod.DegradedReadError as err:
            outcome = (err.segment, err.attempts, err.tile_range)
            with pytest.raises(mod.DegradedReadError):
                store.ensure_segment("p_src")  # quarantined: instant re-raise
        after = _read_counters(reg)
        results.append(
            (outcome, store.healed_reads, sorted(store.quarantined),
             tuple(b - a for a, b in zip(before, after)))
        )
    assert results[0] == results[1]
    if torn > 3:
        assert results[0][0][:2] == ("p_src", 4)
    else:
        assert results[0][0] == "ok" and results[0][1] == (1 if torn else 0)


def test_read_policy_validates_and_attach_faults_is_not_ported(tmp_path):
    """``attach_faults`` is ported (ROADMAP A10, second part): an injector's
    decisions reach the checksum reads, and attaching clears the memo of
    verified segments."""
    from repro_torch.reliability import FaultPlan

    for bad in ({"max_retries": -1}, {"backoff_s": -1.0}, {"backoff_factor": 0.5}):
        with pytest.raises(ValueError):
            ts.ReadPolicy(**bad)
    _, tg = _graphs("ring", False, 2)
    store = ts.write_dsss(tg, str(tmp_path / "g.dsss"))
    store.attach_faults(None)
    store.ensure_segment("p_src")  # no policy: a no-op
    healing = ts.open_dsss(str(tmp_path / "g.dsss"), read_policy=ts.ReadPolicy(max_retries=2, backoff_s=0.0))
    healing.ensure_segment("p_src")
    assert "p_src" in healing._verified
    healing.attach_faults(FaultPlan.storage_short("p_src", times=1).injector())
    assert not healing._verified
    healing.ensure_segment("p_src")  # the first read comes up short, the re-read heals
    assert healing.healed_reads == 1 and not healing.quarantined


def test_cli_matches_the_reference(tmp_path, capsys):
    src, dst, _ = _raw("er", False)
    text = tmp_path / "edges.txt"
    text.write_text("\n".join(f"{a} {b}" for a, b in zip(src, dst)) + "\n")
    outs = []
    for cli, name in ((t_cli, "t.dsss"), (j_cli, "j.dsss")):
        out = str(tmp_path / name)
        assert cli(["build", str(text), out, "--P", "4", "--drop-self-loops",
                    "--chunk-budget", "16384"]) == 0
        assert cli(["info", out]) == 0
        assert cli(["verify", out]) == 0
        outs.append(capsys.readouterr().out.replace(out, "OUT"))
    assert outs[0] == outs[1]
    _same_file(str(tmp_path / "t.dsss"), str(tmp_path / "j.dsss"))
    _flip(str(tmp_path / "t.dsss"), ts.open_dsss(str(tmp_path / "t.dsss")).segments["dst"])
    assert t_cli(["verify", str(tmp_path / "t.dsss")]) == 1
    assert "checksum mismatch" in capsys.readouterr().err
    assert t_cli(["info", str(tmp_path / "missing.dsss")]) == 1
    # verify --repair is ported (ROADMAP A10, second part): the rebuilt
    # container is byte for byte the JAX package's build of the same text.
    assert t_cli(["verify", str(tmp_path / "t.dsss"), "--repair", "--source", str(text)]) == 0
    assert t_cli(["verify", str(tmp_path / "t.dsss")]) == 0
    assert j_cli(["build", str(text), str(tmp_path / "j16.dsss"), "--P", "4"]) == 0
    _same_file(str(tmp_path / "t.dsss"), str(tmp_path / "j16.dsss"))


def test_store_info_matches(tmp_path):
    jg, tg = _graphs("zipf", True, 8)
    js.write_dsss(jg, str(tmp_path / "j.dsss"))
    ts.write_dsss(tg, str(tmp_path / "t.dsss"))
    a = ts.store_info(str(tmp_path / "t.dsss"))
    b = js.store_info(str(tmp_path / "j.dsss"))
    a.pop("path"), b.pop("path")
    assert a == b
