"""The port's reliability layer against the JAX package's (``tests/test_reliability.py``).

Same seeded graphs (n = 120, m = 700, P = 4, weighted so SSSP has costs)
and the same ``.dsss`` file (written by the JAX package) through both
packages; the port runs with ``device="cpu"``, B1 as its plain version.

* Fault plans: validation (``times=0`` is refused, as the spec says), the
  crc32 coin, budgets and ``merge`` fire the same events in both packages.
* Crash → snapshot → resume: bit-identical attrs and field-identical meters
  (``wall_seconds`` excepted) against the port's uninterrupted run, at
  device, host and disk residency under all three executions; against the
  JAX package's uninterrupted run under ``"packed"`` and ``"per_block"``
  (BFS/SSSP/WCC bitwise, PageRank within ``rtol=1e-5``, model meters
  field-identical). A JAX-written snapshot resumes in the port.
* Transient H2D faults: the same labels fire as in the JAX package, the
  run heals to the clean run's bits and meters, and a fault that escapes
  the retry budget leaves the session sound.
* Self-healing reads and ``verify --repair``: the JAX package's outcomes,
  and a repaired file byte for byte the JAX package's repair.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro.reliability as jr  # noqa: E402
import repro.storage as js  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
import repro_torch.reliability as tr  # noqa: E402
import repro_torch.storage as ts  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.graph.generators import erdos_renyi as t_er  # noqa: E402
from repro_torch.graph.preprocess import degree_and_densify as t_densify  # noqa: E402

RESIDENCIES = ["device", "host", "disk"]
EXECUTIONS = ["per_block", "packed", "packed_kernel"]
BUDGET = 4096  # small enough that host and disk runs stream (fault sites fire)
PR_TOL = dict(rtol=1e-5, atol=1e-8)  # the port's stated PageRank tolerance vs JAX


def _raw(n=120, m=700, seed=11):
    src, dst = j_er(n, m, seed=seed)
    w = np.random.default_rng(seed).uniform(0.1, 2.0, size=len(src)).astype(np.float32)
    return src, dst, w


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """(JAX graph, port graph, path of the JAX package's .dsss file of it)."""
    src, dst, w = _raw()
    jg = jc.build_dsss(j_densify(src, dst, weights=w, drop_self_loops=True), 4)
    tg = rt.build_dsss(t_densify(*t_er(120, 700, seed=11), weights=w, drop_self_loops=True), 4)
    np.testing.assert_array_equal(jg.src, tg.src)
    path = str(tmp_path_factory.mktemp("rel") / "g.dsss")
    js.write_dsss(jg, path)
    return jg, tg, path


def _t_session(graphs, residency, execution, **kw):
    _, tg, path = graphs
    kw.setdefault("memory_budget", BUDGET)
    if residency == "disk":
        return rt.GraphSession.open(path, device="cpu", execution=execution, **kw)
    return rt.GraphSession(tg, device="cpu", residency=residency, execution=execution, **kw)


def _j_session(graphs, residency, execution, **kw):
    jg, _, path = graphs
    kw.setdefault("memory_budget", BUDGET)
    if residency == "disk":
        return jc.GraphSession.open(path, execution=execution, **kw)
    return jc.GraphSession(jg, residency=residency, execution=execution, **kw)


def _meters(m):
    d = dataclasses.asdict(m)
    d.pop("wall_seconds")
    return d


def _model(m):
    return {f: getattr(m, f) for f in tsession.MODEL_METER_FIELDS}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


_J_RUNS: dict = {}


def _j_run(graphs, residency, execution, plan_kw):
    plan = jc.ExecutionPlan(**plan_kw)
    key = (residency, execution, plan)
    if key not in _J_RUNS:
        _J_RUNS[key] = _j_session(graphs, residency, execution).run(plan)
    return _J_RUNS[key]


def _programs(pkg):
    return {"pagerank": pkg.PageRank(), "bfs": pkg.BFS(), "sssp": pkg.SSSP(), "wcc": pkg.WCC()}


def _plan_kw(pkg, name, **extra):
    kw = {"program": _programs(pkg)[name], **extra}
    if name == "pagerank":
        kw.update(max_iters=6, tol=0.0)
    elif name in ("bfs", "sssp"):
        kw.update(program_kwargs={"root": 3})
    return kw


# ---------------------------------------------------------------------------
# FaultPlan / FaultInjector: the same events fire in both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", [tr, jr], ids=["port", "jax"])
def test_fault_spec_validation(pkg):
    for bad, err in [
        (dict(site="nope"), ValueError),
        (dict(site="h2d", kind="meteor"), ValueError),
        (dict(site="h2d", rate=1.5), ValueError),
        (dict(site="h2d", times=0), ValueError),  # the spec refuses an empty budget
        (dict(site="h2d", times=-2), ValueError),
    ]:
        with pytest.raises(err):
            pkg.FaultSpec(**bad)
    with pytest.raises(TypeError):
        pkg.FaultPlan(specs=[1, 2])
    assert pkg.FaultSpec(site="sweep", at=[3, 4]).at == (3, 4)


def _decisions(pkg, plan_of, seed, site="h2d", n=64):
    inj = plan_of(pkg, seed).injector()
    out = []
    for i in range(n):
        try:
            inj.check(site, f"id:{i}" if site == "h2d" else i)
            out.append(0)
        except pkg.SimulatedFailure:
            out.append(1)
    return out, inj.fired(), inj.fired(site)


PLANS = {
    "rate": lambda pkg, seed: pkg.FaultPlan.h2d_transient(rate=0.4, times=None, seed=seed),
    "budget": lambda pkg, seed: pkg.FaultPlan.h2d_transient(rate=1.0, times=3, seed=seed),
    "match": lambda pkg, seed: pkg.FaultPlan.h2d_transient(rate=0.5, times=None, match="id:1", seed=seed),
    "merged": lambda pkg, seed: pkg.FaultPlan.h2d_transient(rate=0.3, times=5, seed=seed).merge(
        pkg.FaultPlan.h2d_stall(0.0, rate=0.5, times=None, seed=seed + 1)),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_coin_and_budgets_match_the_reference(plan):
    for seed in (7, 8):
        assert _decisions(tr, PLANS[plan], seed) == _decisions(jr, PLANS[plan], seed)
    assert _decisions(tr, PLANS[plan], 7)[0] != [0] * 64
    if plan == "rate":
        assert _decisions(tr, PLANS[plan], 7) != _decisions(tr, PLANS[plan], 8)
    if plan == "budget":
        assert _decisions(tr, PLANS[plan], 7)[1:] == (3, 3)


def test_crash_budget_spent_once_and_merge():
    for pkg in (tr, jr):
        inj = pkg.FaultPlan.crash_at_sweep(2).injector()
        inj.check("sweep", 0)
        inj.check("sweep", 1)
        with pytest.raises(pkg.InjectedCrash):
            inj.check("sweep", 2)
        inj.check("sweep", 2)  # spent: a resumed run passes the same boundary
        assert inj.fired("sweep") == 1
        plan = pkg.FaultPlan.crash_at_sweep(1).merge(pkg.FaultPlan.storage_corrupt("p_src"))
        assert len(plan.specs) == 2 and plan.seed == 0
        assert isinstance(plan.injector(), pkg.FaultInjector)
    t = tr.FaultPlan.crash_at_step(3, 5).injector()
    with pytest.raises(tr.SimulatedFailure):
        t.check("step", 3)


@pytest.mark.parametrize("kind", ["corrupt", "short"])
@pytest.mark.parametrize("times", [None, 1, 3])
def test_storage_decisions_match_the_reference(kind, times):
    def run(pkg):
        ctor = pkg.FaultPlan.storage_corrupt if kind == "corrupt" else pkg.FaultPlan.storage_short
        inj = ctor("p_", times=times).injector()
        return [inj.storage_read(seg, a) for seg in ("p_src", "blk_src", "p_dst") for a in range(4)], inj.fired()

    assert run(tr) == run(jr)


def test_legacy_primitives_and_shim_match_the_reference():
    from repro_torch.runtime import fault as shim

    assert shim.FailureInjector is tr.FailureInjector
    assert shim.StragglerWatchdog is tr.StragglerWatchdog and shim.StepTimer is tr.StepTimer
    fi = shim.FailureInjector(fail_at_steps=(2,))
    fi.check(1)
    with pytest.raises(tr.SimulatedFailure):
        fi.check(2)
    fi.check(2)  # each fires once
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 1.0, 5.0, 1.0, 4.0, 1.2]
    flags = {}
    for pkg in (tr, jr):
        w = pkg.StragglerWatchdog(warmup=3)
        flags[pkg] = [w.update(i, t) for i, t in enumerate(times)]
    assert flags[tr] == flags[jr] and any(flags[tr])
    assert tr.elastic_device_count(7, model_parallel=2) == jr.elastic_device_count(7, model_parallel=2) == 6
    with pytest.raises(RuntimeError):
        tr.elastic_device_count(1, model_parallel=2)
    assert tr.StepTimer().tick() == 0.0


# ---------------------------------------------------------------------------
# Snapshot files
# ---------------------------------------------------------------------------
def test_save_snapshot_is_atomic_and_pruned(tmp_path):
    d = str(tmp_path / "s")
    arrays = {"attrs": np.arange(6, dtype=np.float32).reshape(1, 2, 3)}
    for sweep in (1, 2, 3, 4):
        tr.save_snapshot(d, sweep, arrays, {"sweeps": sweep}, keep=2)
    names = [os.path.basename(p) for p in tr.list_snapshots(d)]
    assert names == ["sweep_00000003.npz", "sweep_00000004.npz"]
    open(os.path.join(d, "sweep_00000009.npz.tmp"), "wb").close()  # crash debris
    tr.save_snapshot(d, 5, arrays, {"sweeps": 5}, keep=2)
    assert sorted(os.listdir(d)) == ["sweep_00000004.npz", "sweep_00000005.npz"]
    got, meta = tr.load_snapshot(tr.latest_snapshot(d))
    np.testing.assert_array_equal(got["attrs"], arrays["attrs"])
    assert meta == {"sweeps": 5}
    # Each package reads the other's file.
    j_arrays, j_meta = jr.load_snapshot(tr.latest_snapshot(d))
    np.testing.assert_array_equal(j_arrays["attrs"], arrays["attrs"]) and j_meta == meta
    with pytest.raises(ValueError):
        tr.save_snapshot(d, 6, {"__meta_json__": np.zeros(1)}, {})
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    with pytest.raises(tr.SnapshotError):
        tr.load_snapshot(str(bad))
    assert tr.list_snapshots(str(tmp_path / "missing")) == [] and tr.latest_snapshot(str(tmp_path)) is None
    for bad_spec in (dict(directory=""), dict(directory="x", every=0), dict(directory="x", keep=0)):
        with pytest.raises(ValueError):
            tr.CheckpointSpec(**bad_spec)


def test_snapshot_format_matches_the_reference(graphs, tmp_path):
    """The same run snapshots the same names, arrays, dtypes, shapes and metadata keys."""
    out = {}
    for pkg, sess in ((jc, _j_session(graphs, "device", "packed")),
                      (rt, _t_session(graphs, "device", "packed"))):
        d = str(tmp_path / pkg.__name__)
        plan = pkg.ExecutionPlan(pkg.BFS(), program_kwargs={"root": 3},
                                 checkpoint=pkg.CheckpointSpec(d, every=1, keep=3))
        sess.run(plan)
        snaps = tr.list_snapshots(d)
        out[pkg] = [os.path.basename(p) for p in snaps], tr.load_snapshot(snaps[-1])
    (t_names, (t_arr, t_meta)), (j_names, (j_arr, j_meta)) = out[rt], out[jc]
    assert t_names == j_names
    assert sorted(t_arr) == sorted(j_arr) == ["active", "activity_log", "attrs", "converged_at"]
    for k in t_arr:
        assert t_arr[k].dtype == j_arr[k].dtype and t_arr[k].shape == j_arr[k].shape, k
        np.testing.assert_array_equal(t_arr[k], j_arr[k])
    assert sorted(t_meta) == sorted(j_meta)
    assert sorted(t_meta["meters"]) == sorted(j_meta["meters"])
    t_meta["meters"].pop("wall_seconds"), j_meta["meters"].pop("wall_seconds")
    assert t_meta == j_meta


# ---------------------------------------------------------------------------
# Crash → snapshot → resume
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("residency", RESIDENCIES)
@pytest.mark.parametrize("execution", EXECUTIONS)
def test_pagerank_resume_bit_identical(graphs, tmp_path, residency, execution):
    d = str(tmp_path / "snaps")
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=6, tol=0.0,
                            checkpoint=tr.CheckpointSpec(d, every=2, keep=2))
    ref = _t_session(graphs, residency, execution).run(dataclasses.replace(plan, checkpoint=None))
    sess = _t_session(graphs, residency, execution, fault_plan=tr.FaultPlan.crash_at_sweep(5))
    with pytest.raises(tr.InjectedCrash):
        sess.run(plan)
    assert [os.path.basename(s) for s in tr.list_snapshots(d)] == [
        "sweep_00000002.npz", "sweep_00000004.npz"]
    resumed = sess.run(plan, resume_from=d)
    np.testing.assert_array_equal(_bits(resumed.attrs), _bits(ref.attrs))
    assert _meters(resumed.meters) == _meters(ref.meters)
    if residency != "device":
        assert ref.meters.bytes_h2d > 0
    if execution != "packed_kernel":
        j = _j_run(graphs, residency, execution, _plan_kw(jc, "pagerank"))
        np.testing.assert_allclose(resumed.attrs, j.attrs, **PR_TOL)
        assert _model(resumed.meters) == _model(j.meters)
        if residency == "disk":
            assert resumed.meters.bytes_disk_read == j.meters.bytes_disk_read
        if execution == "per_block" or residency == "device":
            assert resumed.meters.bytes_h2d == j.meters.bytes_h2d


@pytest.mark.parametrize("residency", RESIDENCIES)
@pytest.mark.parametrize("execution", ["per_block", "packed"])
@pytest.mark.parametrize("program", ["bfs", "sssp", "wcc"])
def test_monotone_resume_bitwise_vs_reference(graphs, tmp_path, residency, execution, program):
    d = str(tmp_path / "s")
    plan = rt.ExecutionPlan(**_plan_kw(rt, program, checkpoint=tr.CheckpointSpec(d, every=1, keep=2)))
    sess = _t_session(graphs, residency, execution, fault_plan=tr.FaultPlan.crash_at_sweep(2))
    with pytest.raises(tr.InjectedCrash):
        sess.run(plan)
    resumed = sess.run(plan, resume_from=True)  # True: the plan's own directory
    j = _j_run(graphs, residency, execution, _plan_kw(jc, program))
    np.testing.assert_array_equal(resumed.attrs, j.attrs)
    assert resumed.iterations == j.iterations and resumed.converged == j.converged
    assert _model(resumed.meters) == _model(j.meters)
    assert resumed.activity_log and len(resumed.activity_log) == len(j.activity_log)


def test_bfs_batch_resume_and_cancel(graphs, tmp_path):
    """A fused batch resumes as one unit; a cancelled batch leaves the session sound."""
    d = str(tmp_path / "b")
    plans = [rt.ExecutionPlan(rt.BFS(), program_kwargs={"root": r},
                              checkpoint=tr.CheckpointSpec(d, every=1)) for r in (0, 3, 17, 42)]
    sess = _t_session(graphs, "host", "packed_kernel")
    ref = sess.run_batch([dataclasses.replace(p, checkpoint=None) for p in plans])
    sess.inject_faults(tr.FaultPlan.crash_at_sweep(2))
    with pytest.raises(tr.InjectedCrash):
        sess.run_batch(plans)
    got = sess.run_batch(plans, resume_from=d)
    assert got.fused and got.iterations == ref.iterations
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.attrs, b.attrs)
        assert a.iterations == b.iterations
    assert _meters(got.meters) == _meters(ref.meters)

    def stop(sweep):
        if sweep == 1:
            raise tr.DeadlineExceeded("deadline")

    with pytest.raises(tr.DeadlineExceeded):
        sess.run_batch([dataclasses.replace(p, checkpoint=None) for p in plans], cancel=stop)
    again = sess.run_batch([dataclasses.replace(p, checkpoint=None) for p in plans])
    for a, b in zip(again, ref):
        np.testing.assert_array_equal(a.attrs, b.attrs)
    # Only a fusable batch resumes, in both packages.
    mixed = [plans[0], rt.ExecutionPlan(rt.PageRank(), max_iters=3)]
    with pytest.raises(ValueError, match="fusable"):
        sess.run_batch(mixed, resume_from=d)
    j_mixed = [jc.ExecutionPlan(jc.BFS(), program_kwargs={"root": 0}), jc.ExecutionPlan(jc.PageRank(), max_iters=3)]
    with pytest.raises(ValueError, match="fusable"):
        _j_session(graphs, "device", "packed").run_batch(j_mixed, resume_from=d)


@pytest.mark.parametrize("execution", ["packed", "per_block"])
@pytest.mark.parametrize("program", ["bfs", "pagerank"])
def test_jax_snapshot_resumes_in_the_port(graphs, tmp_path, execution, program):
    d = str(tmp_path / "j")
    extra = dict(checkpoint=jc.CheckpointSpec(d, every=2, keep=2))
    j_sess = _j_session(graphs, "device", execution)
    j_sess.inject_faults(jr.FaultPlan.crash_at_sweep(3 if program == "bfs" else 5))
    with pytest.raises(jr.InjectedCrash):
        j_sess.run(jc.ExecutionPlan(**_plan_kw(jc, program, **extra)))
    t_kw = _plan_kw(rt, program, checkpoint=tr.CheckpointSpec(d, every=2, keep=2))
    resumed = _t_session(graphs, "device", execution).run(rt.ExecutionPlan(**t_kw), resume_from=d)
    t_kw.pop("checkpoint")
    want = _t_session(graphs, "device", execution).run(rt.ExecutionPlan(**t_kw))
    if program == "bfs":
        np.testing.assert_array_equal(resumed.attrs, want.attrs)
    else:  # four sweeps came from the JAX package: its last bits, then the port's
        np.testing.assert_allclose(resumed.attrs, want.attrs, **PR_TOL)
    assert resumed.iterations == want.iterations
    assert _meters(resumed.meters) == _meters(want.meters)


def test_resume_rejects_mismatched_plan_and_starts_fresh(graphs, tmp_path):
    ck = tr.CheckpointSpec(str(tmp_path / "c"), every=1)
    sess = _t_session(graphs, "device", "packed_kernel")
    sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0, checkpoint=ck))
    with pytest.raises(tr.SnapshotError):
        sess.run(rt.ExecutionPlan(rt.BFS(), program_kwargs={"root": 0}),
                 resume_from=tr.latest_snapshot(ck.directory))
    with pytest.raises(tr.SnapshotError):
        sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2), resume_from=str(tmp_path / "nope.npz"))
    with pytest.raises(ValueError, match="resume_from=True"):
        sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2), resume_from=True)
    empty = tmp_path / "empty"
    empty.mkdir()
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=3, tol=0.0)
    ref = sess.run(plan)
    got = sess.run(plan, resume_from=str(empty))  # holds no snapshot: a fresh start
    np.testing.assert_array_equal(_bits(got.attrs), _bits(ref.attrs))


def test_checkpoint_in_plan_key(tmp_path):
    a = rt.ExecutionPlan(rt.PageRank())
    b = rt.ExecutionPlan(rt.PageRank(), checkpoint=tr.CheckpointSpec(directory=str(tmp_path)))
    assert a.batch_key() != b.batch_key()
    j = jc.ExecutionPlan(jc.PageRank(), checkpoint=jr.CheckpointSpec(directory=str(tmp_path)))
    assert dataclasses.astuple(b.batch_key()[-1]) == dataclasses.astuple(j.batch_key()[-1])
    with pytest.raises(TypeError):
        rt.ExecutionPlan(rt.PageRank(), checkpoint=str(tmp_path))
    assert rt.core.CheckpointSpec is tr.CheckpointSpec is rt.core.plan.CheckpointSpec


def test_engine_crash_and_resume(graphs, tmp_path):
    """NXGraphEngine.run passes checkpoint=/resume_from= to its session."""
    _, tg, _ = graphs
    ck = tr.CheckpointSpec(str(tmp_path / "e"), every=2)
    ref = rt.NXGraphEngine(tg, rt.PageRank(), device="cpu").run(6, tol=0.0)
    eng = rt.NXGraphEngine(tg, rt.PageRank(), device="cpu")
    eng.session.inject_faults(tr.FaultPlan.crash_at_sweep(3))
    with pytest.raises(tr.InjectedCrash):
        eng.run(6, tol=0.0, checkpoint=ck)
    got = eng.run(6, tol=0.0, checkpoint=ck, resume_from=True)
    np.testing.assert_array_equal(_bits(got.attrs), _bits(ref.attrs))
    assert _meters(got.meters) == _meters(ref.meters)


# ---------------------------------------------------------------------------
# Transient H2D faults
# ---------------------------------------------------------------------------
def _record_fires(sess, pkg):
    """Wrap the session's injector so each label that raised is recorded."""
    inj = sess.fault_injector
    fired, check = [], inj.check

    def recording(site, identity):
        try:
            check(site, identity)
        except pkg.TransientFault:
            fired.append(identity)
            raise

    inj.check = recording
    return fired


H2D = dict(rate=0.2, times=None, seed=5)


@pytest.mark.parametrize("residency", ["host", "disk"])
@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("program", ["pagerank", "bfs"])
def test_h2d_transient_plans_heal(graphs, residency, execution, program):
    plan = rt.ExecutionPlan(**_plan_kw(rt, program))
    clean = _t_session(graphs, residency, execution).run(plan)
    sess = _t_session(graphs, residency, execution, fault_plan=tr.FaultPlan.h2d_transient(**H2D))
    fired = _record_fires(sess, tr)
    got = sess.run(plan)
    np.testing.assert_array_equal(_bits(got.attrs), _bits(clean.attrs))
    assert _meters(got.meters) == _meters(clean.meters)
    assert sess.fault_injector.fired("h2d") == len(fired) > 0
    assert all(f.startswith("block:" if execution == "per_block" else "chunk:") for f in fired)
    # The JAX package fires at the same labels, the same number of times
    # (its "packed" stream has the chunk grid of both packed executions).
    j_sess = _j_session(graphs, residency, "per_block" if execution == "per_block" else "packed",
                        fault_plan=jr.FaultPlan.h2d_transient(**H2D))
    j_fired = _record_fires(j_sess, jr)
    j_sess.run(jc.ExecutionPlan(**_plan_kw(jc, program)))
    assert fired == j_fired
    assert j_sess.fault_injector.fired("h2d") == sess.fault_injector.fired("h2d")


@pytest.mark.parametrize("residency", ["host", "disk"])
@pytest.mark.parametrize("execution", EXECUTIONS)
def test_escaped_h2d_fault_leaves_the_session_sound(graphs, residency, execution):
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=4, tol=0.0)
    fresh = _t_session(graphs, residency, execution).run(plan)
    # Four fires in a row: the first copy and its three retries.
    sess = _t_session(graphs, residency, execution,
                      fault_plan=tr.FaultPlan.h2d_transient(rate=1.0, times=4))
    with pytest.raises(tr.TransientFault):
        sess.run(plan)
    assert sess.fault_injector.fired("h2d") == 4
    again = sess.run(plan)  # the budget is spent: the same session runs clean
    np.testing.assert_array_equal(_bits(again.attrs), _bits(fresh.attrs))
    assert _meters(again.meters) == _meters(fresh.meters)
    sess.inject_faults(None)
    assert sess.fault_injector is None
    np.testing.assert_array_equal(_bits(sess.run(plan).attrs), _bits(fresh.attrs))


def test_device_residency_has_no_h2d_site(graphs):
    sess = _t_session(graphs, "device", "packed_kernel",
                      fault_plan=tr.FaultPlan.h2d_transient(rate=1.0, times=None))
    sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0))
    assert sess.fault_injector.fired("h2d") == 0


# ---------------------------------------------------------------------------
# Self-healing storage reads and repair
# ---------------------------------------------------------------------------
def test_transient_corruption_heals(graphs):
    _, _, path = graphs
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=4, tol=0.0)
    ref = rt.GraphSession.open(path, device="cpu").run(plan)
    out = {}
    for pkg, ses in ((rt, rt.GraphSession.open), (jc, jc.GraphSession.open)):
        policy = (ts if pkg is rt else js).ReadPolicy(max_retries=3, backoff_s=0.0)
        fault = (tr if pkg is rt else jr).FaultPlan.storage_corrupt("p_dst", times=2)
        kw = {"device": "cpu"} if pkg is rt else {}
        sess = ses(path, verify=False, read_policy=policy, fault_plan=fault, **kw)
        got = sess.run(pkg.ExecutionPlan(pkg.PageRank(), max_iters=4, tol=0.0))
        out[pkg] = (sess.store.healed_reads, sorted(sess.store.quarantined), got.attrs)
    assert out[rt][0] == out[jc][0] >= 1 and out[rt][1] == out[jc][1] == []
    np.testing.assert_array_equal(_bits(out[rt][2]), _bits(ref.attrs))


@pytest.mark.parametrize("kind,segment,execution", [
    ("corrupt", "p_dst", None), ("short", "blk_", "per_block"), ("short", "p_src", "packed")])
def test_persistent_damage_quarantines(graphs, kind, segment, execution):
    _, _, path = graphs
    errs = {}
    for pkg in (rt, jc):
        fpkg, spkg = (tr, ts) if pkg is rt else (jr, js)
        ctor = fpkg.FaultPlan.storage_corrupt if kind == "corrupt" else fpkg.FaultPlan.storage_short
        kw = {"device": "cpu"} if pkg is rt else {}
        sess = pkg.GraphSession.open(path, verify=False, read_policy=spkg.ReadPolicy(max_retries=2, backoff_s=0.0),
                                     fault_plan=ctor(segment, times=None), **kw)
        plan = pkg.ExecutionPlan(pkg.PageRank(), max_iters=3, execution=execution)
        with pytest.raises(spkg.DegradedReadError) as ei:
            sess.run(plan)
        with pytest.raises(spkg.DegradedReadError):  # quarantined: the same error, at once
            sess.run(plan)
        err = ei.value
        errs[pkg] = (err.segment, err.attempts, err.tile_range, err.offset, err.nbytes, sorted(sess.store.quarantined))
    assert errs[rt] == errs[jc]
    assert errs[rt][1] == 3  # 1 + max_retries


def test_no_policy_keeps_failfast_contract(graphs):
    _, _, path = graphs
    sess = rt.GraphSession.open(path, device="cpu", verify=False,
                                fault_plan=tr.FaultPlan.storage_corrupt("p_dst", times=None))
    with pytest.raises(ts.ChecksumError):
        sess.store.verify()
    j_sess = jc.GraphSession.open(path, verify=False,
                                  fault_plan=jr.FaultPlan.storage_corrupt("p_dst", times=None))
    assert sess.store.scan() == j_sess.store.scan() == ["p_dst", "p_dst_interval"]


def _flip_first_segment(path):
    seg = next(iter(ts.open_dsss(path, verify=False).segments.values()))
    with open(path, "r+b") as f:  # real media damage, not an injector
        f.seek(seg.offset + 1)
        byte = f.read(1)
        f.seek(seg.offset + 1)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_cli_repair_rebuilds_flipped_container(tmp_path):
    from repro.storage.__main__ import main as j_cli

    from repro_torch.storage.__main__ import main as t_cli

    edges = tmp_path / "edges.txt"
    rng = np.random.default_rng(5)
    edges.write_text("\n".join(f"{a} {b}" for a, b in zip(rng.integers(0, 60, 400), rng.integers(0, 60, 400))) + "\n")
    t_out, j_out = str(tmp_path / "t.dsss"), str(tmp_path / "j.dsss")
    assert t_cli(["build", str(edges), t_out, "--P", "4"]) == 0
    shutil.copyfile(t_out, j_out)
    for out in (t_out, j_out):
        _flip_first_segment(out)
    assert t_cli(["verify", t_out]) == 1
    assert t_cli(["verify", t_out, "--repair"]) == 1  # no --source
    assert t_cli(["verify", t_out, "--repair", "--source", str(edges)]) == 0
    assert j_cli(["verify", j_out, "--repair", "--source", str(edges)]) == 0
    assert t_cli(["verify", t_out]) == 0  # clean after the swap
    with open(t_out, "rb") as a, open(j_out, "rb") as b:
        assert a.read() == b.read()  # byte for byte the reference's repair
    assert not os.path.exists(t_out + ".repair.tmp")


def test_repair_noop_on_clean_container(graphs, tmp_path):
    from repro_torch.reliability.repair import repair_dsss

    _, _, path = graphs
    copy = str(tmp_path / "g.dsss")
    shutil.copyfile(path, copy)
    report = repair_dsss(copy)
    assert report == {"path": copy, "damaged": [], "repaired": False, "source": None}
    _flip_first_segment(copy)
    with pytest.raises(ValueError, match="no --source"):
        repair_dsss(copy)
