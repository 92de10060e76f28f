"""The port's resilience layer: bitwise kill and resume, the fault
harness, self-healing sweeps, and the JAX package's chaos campaign.

The fixture is tests/test_resilience.py's (4 agents, 60 samples each,
d_in 8, hidden 8, 3 classes, ER(0.5) Laplacian, ``cg`` at 8 trips, 12
steps recording every 3, a snapshot every 5, a kill at 7), built by the
JAX package and carried over as numpy; the eq.-11 metric takes
``INNER_STEPS`` = 10 inner steps (40 there), for time: the comparisons
are bit for bit, or against the JAX package's metric at the same count.

The bitwise contract holds within the port: a run killed at a step and
resumed from its newest valid snapshot in a fresh solver gives the
uninterrupted ``run_traced`` trace and final state bit for bit, for the
four algorithms on the ``dense`` and ``cuda`` backends (on the CPU the
``cuda`` backend runs the kernels' plain versions), and so does a chaos
campaign.  On the card ``chip_smoke.py`` holds the captured runs to it.

Against the JAX package (INTERACT, which draws nothing): the same
``FaultPlan`` gives equal ``ChaosReport`` counters and the same events,
and the two final traces agree within ``TRACE_RTOL`` = 2e-5 (10 steps of
the 2e-6 one-step bound of tests/test_torch_interact.py, as
tests/test_torch_solve.py holds traces), at 32 CG trips: the trip count
the bound was measured at.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.resilience as jres  # noqa: E402
import repro.solvers as jsolvers  # noqa: E402
from repro.hypergrad import HypergradConfig as JHypergrad  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.byzantine import ByzantineConfig, GuardConfig  # noqa: E402
from repro_torch.consensus import CompressionConfig  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 tree_from_numpy)
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    FaultPlan,
    NonFiniteStateError,
    SimulatedKill,
    available_faults,
    chaos_run,
    make_fault,
    register_fault,
    resume,
    resume_run,
    run_resumable,
    snapshot,
)
from repro_torch.solvers import (SolverConfig, available_solvers,  # noqa: E402
                                 make_solver, sweep)

M, N, BATCH, Q, SEED = 4, 60, 6, 5, 7
ITERS, REC = 12, 3
CKPT_EVERY = 5          # co-prime with REC: boundaries never align
KILL_AT = 7             # mid-chunk
TRACE_RTOL = 10 * 2e-6
CHAOS_TRIPS = 32
INNER_STEPS = 10
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    jdata = jcore.make_synthetic_agents(jax.random.PRNGKey(0), num_agents=M,
                                        n_per_agent=N, d_in=8, num_classes=3)
    jx0 = jcore.init_mlp_backbone(jax.random.PRNGKey(1), 8, hidden=8)
    jy0 = jcore.init_head(jax.random.PRNGKey(2), 8, 3)
    prob = core.MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0)
    data = agent_data_from_numpy(np_tree(jdata), "cpu")
    adj = core.erdos_renyi_adjacency(M, 0.5, seed=3)
    hg = HypergradConfig(method="cg", cg_iters=8)
    return dict(
        j=dict(data=jdata, x0=jx0, y0=jy0,
               problem=jcore.MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
               spec=jcore.laplacian_mixing(adj)),
        problem=prob, data=data, spec=core.laplacian_mixing(adj), hg=hg,
        x0=tree_from_numpy(np_tree(jx0), "cpu"),
        y0=tree_from_numpy(np_tree(jy0), "cpu"),
        metric=core.convergence_metric_fn(prob, hg, data,
                                          inner_steps=INNER_STEPS),
        refs={})


def _config(setup, algo, **overrides):
    kw = dict(algo=algo, alpha=0.3, beta=0.3, batch_size=BATCH, q=Q,
              mixing=setup["spec"], hypergrad=setup["hg"], seed=SEED)
    kw.update(overrides)
    return SolverConfig(**kw)


def _where(setup) -> dict:
    return dict(problem=setup["problem"], x0=setup["x0"], y0=setup["y0"],
                data=setup["data"], device="cpu")


def _fresh(setup, cfg):
    solver = make_solver(cfg)
    return solver, solver.init(setup["problem"], None, setup["x0"],
                               setup["y0"], setup["data"])


def _reference(setup, cfg, metric=None):
    """The uninterrupted ``run_traced``: (trace as numpy, final state),
    kept for the module."""
    metric = setup["metric"] if metric is None else metric
    key = (repr(cfg), id(metric))
    if key not in setup["refs"]:
        solver, state = _fresh(setup, cfg)
        state, trace = solver.run_traced(state, setup["data"], ITERS, REC,
                                         metric)
        setup["refs"][key] = trace.numpy(), state
    return setup["refs"][key]


def _bits(tree) -> list:
    return [leaf.numpy().tobytes() if isinstance(leaf, torch.Tensor)
            else leaf for leaf in torch.utils._pytree.tree_leaves(tree)]


def _kill_then_resume(setup, cfg, ckpt):
    """Kill at KILL_AT, resume in a fresh solver from disk: (trace,
    final state)."""
    plan = FaultPlan([make_fault("kill", step=KILL_AT)], seed=0)
    solver, state = _fresh(setup, cfg)
    with pytest.raises(SimulatedKill):
        run_resumable(solver, state, setup["data"], ITERS, REC,
                      setup["metric"], checkpoint_every=CKPT_EVERY,
                      ckpt_dir=ckpt, hooks=plan)
    # the kill landed at boundary 10, before its snapshot: only step 5's
    # snapshot exists, so steps 5..12 are replayed
    rs = resume(cfg, ckpt, **_where(setup))
    assert rs is not None and rs.step == CKPT_EVERY and rs.state.t == 5
    _, state, trace = resume_run(cfg, ckpt, ITERS, REC, setup["metric"],
                                 checkpoint_every=CKPT_EVERY,
                                 **_where(setup))
    return trace, state


@pytest.mark.parametrize("algo", sorted(available_solvers()))
@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_kill_resume_bitwise(setup, tmp_path, algo, backend):
    cfg = _config(setup, algo, backend=backend)
    ref, ref_state = _reference(setup, cfg)
    trace, state = _kill_then_resume(setup, cfg, tmp_path)
    assert trace.dtype == ref.dtype and trace.shape == ref.shape == (5,)
    assert trace.tobytes() == ref.tobytes()
    assert state.t == ITERS and _bits(state) == _bits(ref_state)


def test_kill_resume_bitwise_compressed_ef(setup, tmp_path):
    """The EF wire state {e, ref} rides in the state: resume restores it
    or the compressed trajectory forks."""
    cfg = _config(setup, "interact", compression=CompressionConfig(
        kind="sign1bit", error_feedback=True))
    ref, ref_state = _reference(setup, cfg)
    trace, state = _kill_then_resume(setup, cfg, tmp_path)
    assert state.ef is not None and list(state.ef) == ["u", "x"]
    assert trace.tobytes() == ref.tobytes()
    assert _bits(state) == _bits(ref_state)


def test_run_traced_checkpointed_equals_unchunked(setup, tmp_path):
    """``run_traced(checkpoint_every=...)``: the same trace (a tensor)
    and state; its snapshots land on the global multiples and the run's
    end, the generator's state with each."""
    cfg = _config(setup, "svr-interact")
    ref, ref_state = _reference(setup, cfg)
    solver, state = _fresh(setup, cfg)
    state, trace = solver.run_traced(state, setup["data"], ITERS, REC,
                                     setup["metric"],
                                     checkpoint_every=CKPT_EVERY,
                                     ckpt_dir=tmp_path)
    assert isinstance(trace, torch.Tensor)
    assert trace.numpy().tobytes() == ref.tobytes()
    assert _bits(state) == _bits(ref_state)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) == [
        "step_00000005.npz", "step_00000010.npz", "step_00000012.npz"]


def test_run_checkpointed_equals_run(setup, tmp_path):
    cfg = _config(setup, "gt-dsgd")
    solver, state = _fresh(setup, cfg)
    want = solver.run(state, setup["data"], ITERS)
    solver, state = _fresh(setup, cfg)
    got = solver.run(state, setup["data"], ITERS,
                     checkpoint_every=CKPT_EVERY, ckpt_dir=tmp_path)
    assert got.t == ITERS and _bits(got) == _bits(want)
    rs = resume(cfg, tmp_path, **_where(setup))
    assert rs.step == ITERS and rs.padded is None
    assert _bits(rs.state) == _bits(want)


def test_guarded_row_rolls_back_then_accepts(setup, tmp_path):
    """One sign-flip attacker (scale 25) under the weighted rule with a
    NaN and norm guard: the guard trips in a chunk, ``chaos_run`` rolls
    back to the checkpoint, the replay trips again and the guard's
    containment is accepted.  The counters and the trace are the
    unchunked run's."""
    cfg = _config(setup, "interact", byzantine=ByzantineConfig(
        kind="sign-flip", num_byzantine=1, scale=25.0),
        guard=GuardConfig(nan=True, max_norm=1e3))
    ref, ref_state = _reference(setup, cfg)
    tripped = int(ref_state.guard["tripped"])
    assert tripped > 0
    rep = chaos_run(cfg, FaultPlan(seed=0), ITERS, REC,
                    checkpoint_every=CKPT_EVERY, ckpt_dir=tmp_path,
                    metric_fn=setup["metric"], **_where(setup))
    assert rep.completed and rep.guard_rollbacks >= 2
    assert rep.guard_accepted >= 1
    assert rep.guard_rollbacks == rep.restarts == 2 * rep.guard_accepted
    assert rep.tripped_steps == tripped
    assert rep.last_good_step == int(ref_state.guard["last_good"])
    assert rep.trace.tobytes() == ref.tobytes()
    assert _bits(rep.state) == _bits(ref_state)


# -- snapshot and resume edge cases ------------------------------------------

def test_resume_skips_corrupt_newest_snapshot(setup, tmp_path):
    cfg = _config(setup, "interact")
    solver, state = _fresh(setup, cfg)
    run_resumable(solver, state, setup["data"], ITERS, REC, setup["metric"],
                  checkpoint_every=CKPT_EVERY, ckpt_dir=tmp_path)
    newest = tmp_path / f"step_{ITERS:08d}.npz"   # snapshots at 5, 10, 12
    with open(newest, "r+b") as fh:
        fh.truncate(os.path.getsize(newest) // 3)
    rs = resume(cfg, tmp_path, **_where(setup))
    assert rs is not None and rs.step == 10 and rs.state.t == 10


def test_resume_refuses_wrong_config(setup, tmp_path):
    cfg = _config(setup, "interact")
    solver, state = _fresh(setup, cfg)
    run_resumable(solver, state, setup["data"], CKPT_EVERY,
                  checkpoint_every=CKPT_EVERY, ckpt_dir=tmp_path)
    other = _config(setup, "interact", alpha=0.11)
    with pytest.raises(ValueError, match="different config"):
        resume(other, tmp_path, **_where(setup))
    assert resume(other, tmp_path, strict=False, **_where(setup)) is None


def test_resume_empty_dir(setup, tmp_path):
    cfg = _config(setup, "interact")
    assert resume(cfg, tmp_path, **_where(setup)) is None
    with pytest.raises(ValueError, match="num_steps"):
        resume_run(cfg, tmp_path, checkpoint_every=CKPT_EVERY,
                   **_where(setup))


def test_nan_payload_detected_before_snapshot(setup, tmp_path):
    """A poisoned chunk raises and does not land on disk; the poison
    reached the stepper (the runner loads the changed state back), so
    the check caught what the next chunk would have stepped from."""
    cfg = _config(setup, "interact")
    solver, state = _fresh(setup, cfg)
    plan = FaultPlan([make_fault("nan-payload", step=2)], seed=0)
    with pytest.raises(NonFiniteStateError) as info:
        run_resumable(solver, state, setup["data"], ITERS, REC,
                      setup["metric"], checkpoint_every=CKPT_EVERY,
                      ckpt_dir=tmp_path, hooks=plan)
    assert info.value.step == CKPT_EVERY
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    first = solver.stepper.state().x[0][0]   # the backbone's first weight
    assert torch.isnan(first.reshape(-1)[:3]).all()
    assert torch.isfinite(first.reshape(-1)[3:]).all()
    assert plan.events == [dict(kind="nan-payload", at=CKPT_EVERY,
                                field="x", value=plan.faults[0].value)]


def test_write_failure_absorbed_by_snapshot_retry(setup, tmp_path):
    cfg = _config(setup, "interact")
    solver, state = _fresh(setup, cfg)
    plan = FaultPlan([make_fault("write-failure", step=0, count=2)], seed=0)
    run_resumable(solver, state, setup["data"], CKPT_EVERY, REC,
                  setup["metric"], checkpoint_every=CKPT_EVERY,
                  ckpt_dir=tmp_path, hooks=plan, backoff=0.001)
    assert plan.count("write-failure") == 2   # retried, then landed
    assert (tmp_path / f"step_{CKPT_EVERY:08d}.npz").exists()


def test_write_failure_beyond_retry_budget_raises(setup, tmp_path):
    cfg = _config(setup, "interact")
    solver, state = _fresh(setup, cfg)
    plan = FaultPlan([make_fault("write-failure", step=0, count=10)], seed=0)
    with pytest.raises(OSError, match="injected"):
        run_resumable(solver, state, setup["data"], CKPT_EVERY, REC,
                      setup["metric"], checkpoint_every=CKPT_EVERY,
                      ckpt_dir=tmp_path, hooks=plan, retries=2,
                      backoff=0.001)
    assert plan.count("write-failure") == 3
    assert not list(tmp_path.glob("*.npz"))


def test_fault_registry():
    kinds = available_faults()
    assert kinds == jres.available_faults() == (
        "corrupt-checkpoint", "kill", "nan-payload", "stale-checkpoint",
        "write-failure")
    with pytest.raises(ValueError, match="unknown fault"):
        make_fault("fsck")
    with pytest.raises(ValueError, match="already registered"):
        register_fault("kill")(type("Impostor", (), {}))
    with pytest.raises(ValueError, match="corruption mode"):
        make_fault("corrupt-checkpoint", mode="shred")


def test_fault_plan_reset_rearms():
    plan = FaultPlan([make_fault("kill", step=3),
                      make_fault("write-failure", step=0, count=2)], seed=0)
    with pytest.raises(SimulatedKill):
        plan.on_chunk_end(0, 5, None, 10)
    assert plan.on_chunk_end(5, 10, None, 10) is None   # one-shot
    with pytest.raises(OSError):
        plan.on_write_attempt(5, 0)
    plan.reset()
    assert plan.events == [] and plan.faults[1].remaining == 2
    with pytest.raises(SimulatedKill):
        plan.on_chunk_end(0, 5, None, 10)


# -- the chaos campaign, in the port and in the JAX package -------------------

CAMPAIGN = [("kill", dict(step=3)), ("kill", dict(step=6)),
            ("kill", dict(step=9)), ("nan-payload", dict(step=4)),
            ("corrupt-checkpoint", dict(step=6, mode="garbage")),
            ("stale-checkpoint", dict(step=8)),
            ("write-failure", dict(step=3, count=2))]
COUNTERS = ("completed", "restarts", "kills", "nonfinite_faults",
            "write_retries", "wasted_steps", "guard_rollbacks",
            "guard_accepted")


@pytest.fixture(scope="module")
def campaign(setup, tmp_path_factory):
    """INTERACT at 32 CG trips: the port's chaos report and its
    uninterrupted trace, and the JAX package's chaos report, all under
    the same plan (seed 1) on the same data and initial points."""
    hg = HypergradConfig(method="cg", cg_iters=CHAOS_TRIPS)
    cfg = _config(setup, "interact", hypergrad=hg)
    metric = core.convergence_metric_fn(setup["problem"], hg, setup["data"],
                                        inner_steps=INNER_STEPS)
    ref, _ = _reference(setup, cfg, metric)
    port = chaos_run(cfg, FaultPlan([make_fault(k, **kw)
                                     for k, kw in CAMPAIGN], seed=1),
                     ITERS, REC, checkpoint_every=CKPT_EVERY,
                     ckpt_dir=tmp_path_factory.mktemp("port"),
                     metric_fn=metric, backoff=0.001, **_where(setup))
    j = setup["j"]
    jhg = JHypergrad(method="cg", cg_iters=CHAOS_TRIPS)
    jcfg = jsolvers.SolverConfig(algo="interact", alpha=0.3, beta=0.3,
                                 batch_size=BATCH, q=Q, mixing=j["spec"],
                                 hypergrad=jhg, seed=SEED)
    want = jres.chaos_run(
        jcfg, jres.FaultPlan([jres.make_fault(k, **kw)
                              for k, kw in CAMPAIGN], seed=1),
        ITERS, REC, checkpoint_every=CKPT_EVERY,
        ckpt_dir=tmp_path_factory.mktemp("jax"),
        metric_fn=jcore.convergence_metric_fn(j["problem"], jhg, j["data"],
                                              inner_steps=INNER_STEPS),
        problem=j["problem"], x0=j["x0"], y0=j["y0"], data=j["data"],
        backoff=0.001)
    return dict(ref=ref, port=port, jax=want)


def test_chaos_campaign_completes_bitwise(campaign):
    rep, ref = campaign["port"], campaign["ref"]
    assert rep.completed
    assert rep.kills >= 3 and rep.restarts >= 3
    assert rep.nonfinite_faults >= 1
    assert rep.write_retries >= 2
    assert rep.wasted_steps > 0
    assert rep.trace is not None and rep.trace.tobytes() == ref.tobytes()
    assert rep.final_metric == float(ref[-1])
    assert {e["kind"] for e in rep.events} == {
        "kill", "nan-payload", "corrupt-checkpoint", "stale-checkpoint",
        "write-failure", "recover"}


def test_chaos_campaign_matches_jax(campaign):
    """The same plan does the same to both packages: counters and events
    equal (``repr``: the NaN payload's value is NaN in both), final
    traces within ``TRACE_RTOL``."""
    rep, want = campaign["port"], campaign["jax"]
    for name in COUNTERS:
        assert getattr(rep, name) == getattr(want, name), name
    assert repr(rep.events) == repr(want.events)
    gap = float(np.max(np.abs(rep.trace - np.asarray(want.trace))
                       / np.abs(np.asarray(want.trace))))
    print(f"chaos campaign at {CHAOS_TRIPS} CG trips: trace against the JAX "
          f"package's, largest relative gap {gap:.3e} (bound {TRACE_RTOL})")
    assert gap <= TRACE_RTOL


# -- self-healing sweeps ---------------------------------------------------

def _sweep_grid(setup):
    return [_config(setup, "interact", alpha=0.2),
            _config(setup, "interact", alpha=0.3),
            _config(setup, "gt-dsgd")]


def _sweep_kw(setup) -> dict:
    return dict(_where(setup), metric_fn=setup["metric"])


def test_sweep_resume_recomputes_only_missing_groups(setup, tmp_path):
    """A sweep that failed mid-grid, run again: the finished group loads
    bit for bit, the missing one computes; a third call loads both."""
    grid = _sweep_grid(setup)
    kw = _sweep_kw(setup)
    # a failure mid-grid: only the INTERACT group ever finished
    partial = sweep(grid[:2], ITERS, REC, resume_dir=tmp_path, **kw)
    assert [g.loaded for g in partial.groups] == [False]
    assert (tmp_path / "manifest.json").exists()
    full = sweep(grid, ITERS, REC, resume_dir=tmp_path, **kw)
    assert [g.loaded for g in full.groups] == [True, False]
    assert full.groups[0].stepper is None
    clean = sweep(grid[2:], ITERS, REC, **kw)
    assert full.traces.tobytes() == np.concatenate(
        [partial.traces, clean.traces]).tobytes()
    again = sweep(grid, ITERS, REC, resume_dir=tmp_path,
                  compare_sequential=True, **kw)
    assert [g.loaded for g in again.groups] == [True, True]
    assert again.traces.tobytes() == full.traces.tobytes()
    assert again.groups[0].seconds == full.groups[0].seconds
    assert again.seconds_sequential == 0.0
    assert np.isnan(again.traces_sequential).all()


def test_sweep_resume_ignores_foreign_geometry_and_damage(setup, tmp_path):
    """A manifest written for other sweep geometry is not loaded: every
    group computes under the new fingerprint; a damaged group file is
    computed again."""
    grid = _sweep_grid(setup)[2:]
    kw = _sweep_kw(setup)
    steps = 2 * REC
    first = sweep(grid, steps, REC, resume_dir=tmp_path, **kw)
    other = sweep(grid, steps + REC, REC, resume_dir=tmp_path, **kw)
    assert [g.loaded for g in other.groups] == [False]
    for f in tmp_path.glob("group_*.npz"):
        with open(f, "r+b") as fh:
            fh.truncate(os.path.getsize(f) // 2)
    again = sweep(grid, steps, REC, resume_dir=tmp_path, **kw)
    assert [g.loaded for g in again.groups] == [False]
    assert again.traces.tobytes() == first.traces.tobytes()


def test_sweep_resume_rejects_return_states(setup, tmp_path):
    with pytest.raises(ValueError, match="return_states"):
        sweep(_sweep_grid(setup)[:1], ITERS, 0, return_states=True,
              resume_dir=tmp_path, **_where(setup))


# -- snapshot internals ----------------------------------------------------

@pytest.mark.parametrize("algo", ["interact", "svr-interact"])
def test_snapshot_meta_padded_and_generator_roundtrip(setup, tmp_path, algo):
    """The sidecar, the metric column and (a stochastic solver) the host
    generator come back; ``resume`` restores the generator after
    ``init``'s own first draw."""
    cfg = _config(setup, algo)
    solver, state = _fresh(setup, cfg)
    state = solver.run(state, setup["data"], 2)
    padded = np.full((ITERS,), np.nan, np.float32)
    padded[:4] = np.arange(4, dtype=np.float32)
    snapshot(solver, state, 2, tmp_path, padded=padded, total_steps=ITERS,
             record_every=REC)
    rs = resume(cfg, tmp_path, **_where(setup))
    assert rs.total_steps == ITERS and rs.record_every == REC
    assert rs.padded.tobytes() == padded.tobytes()
    assert rs.meta["algo"] == algo and rs.meta["has_rng"] == (
        algo == "svr-interact")
    assert rs.state.t == 2 and _bits(rs.state) == _bits(state)
    if algo == "svr-interact":
        assert torch.equal(rs.solver._sampler.generator.get_state(),
                           solver._sampler.generator.get_state())
        nxt = [s.draw(1, "cpu") for s in (rs.solver, solver)]
        assert all(torch.equal(a, b) for a, b in zip(*nxt))
