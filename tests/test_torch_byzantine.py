"""The port's Byzantine layer against the JAX package's.

Attacks: the port's ``apply_attack`` on the reference's own mask
(``byzantine_mask(PRNGKey(seed), ...)``) and round noise (the per-leaf,
per-slot ``jax.random.normal`` of ``repro.byzantine.attacks``,
concatenated in leaf order), handed over as tensors, against the
reference's ``apply_attack``: honest rows bit for bit, corrupted rows
within ``ATTACK_RTOL`` = 1e-6 of the row's scale.  The port's own draws
(numpy, on the host) are checked for what the scheme promises: a fixed
subset of the asked size, row i of a round's noise independent of m,
and a new draw every step and stream.

Combine rules: each rule against ``robust_combine`` on the same
payload, within ``COMBINE_TOL`` = 1e-6 of the payload's scale, on the
main path's ER(0.5) Laplacian (supports of 4, 2, 3, 4 and 2 agents: the
median's even supports, and trimmed-mean's fallback for a support of 2
under f = 1), the complete graph and a ring.

Guards: ``guard_param_step`` on one candidate state, clean, NaN and
over the norm bound, against the reference's: fields and counters
exactly.

One step from the reference's state: the JAX solver runs each row of
``chip_smoke.py``'s ``byzantine`` phase (and int8 error feedback under
trimmed-mean) on the Section-6 instance at a small size (m = 5, n = 40
per agent, hidden 8, ``cg`` at 8 trips, q = 4, |S| = 5) for 5 steps; at
the steps held the port takes the reference's state (guard counters
included), its draws and its attack mask and noise, and must land on the
reference's next state within ``ONE_STEP_TOL`` = 2e-6 of each field's
scale (the bound of tests/test_torch_wire.py), on both backends.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.byzantine import ByzantineConfig as JByzantine  # noqa: E402
from repro.byzantine import GuardConfig as JGuard  # noqa: E402
from repro.byzantine import apply_attack as j_apply_attack  # noqa: E402
from repro.byzantine import attack_names as j_attack_names  # noqa: E402
from repro.byzantine import byzantine_mask as j_byzantine_mask  # noqa: E402
from repro.byzantine import combine_rule_names as j_rule_names  # noqa: E402
from repro.byzantine import guard_param_step as j_guard_step  # noqa: E402
from repro.byzantine import make_attack as j_make_attack  # noqa: E402
from repro.byzantine import robust_combine as j_robust_combine  # noqa: E402
from repro.consensus import CompressionConfig as JCompression  # noqa: E402
from repro.consensus import init_ef as j_init_ef  # noqa: E402
from repro.consensus import make_engine as j_make_engine  # noqa: E402
from repro.core import erdos_renyi_adjacency as j_er  # noqa: E402
from repro.core import laplacian_mixing as j_laplacian  # noqa: E402
from repro.core import ring_mixing as j_ring_mixing  # noqa: E402
from repro.core.svr_interact import per_agent_keys  # noqa: E402
from repro.hypergrad import HypergradConfig as JHypergradConfig  # noqa: E402
from repro.solvers import SolverConfig as JConfig  # noqa: E402
from repro.solvers import default_setup as j_default_setup  # noqa: E402
from repro.solvers import make_solver as j_make_solver  # noqa: E402
from repro.solvers.config import TopologyConfig as JTopology  # noqa: E402
from repro_torch.byzantine import (ByzantineConfig,  # noqa: E402
                                   GuardConfig, apply_attack, attack_names,
                                   byzantine_mask, combine_rule_names,
                                   guard_param_step, init_guard, make_attack,
                                   robust_combine, round_noise)
from repro_torch.consensus import (CompressionConfig, init_ef,  # noqa: E402
                                   make_engine)
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 state_from_numpy, tree_from_numpy)
from repro_torch.core import (Draws, DsgdState, GtDsgdState,  # noqa: E402
                              InteractState, MLPMetaProblem, SvrState,
                              ring_mixing)
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.solvers import (SolverConfig, make_solver,  # noqa: E402
                                 solve)
from repro_torch.solvers.config import TopologyConfig  # noqa: E402

ATTACK_RTOL = 1e-6
COMBINE_TOL = 1e-6
ONE_STEP_TOL = 2e-6
M, N, Q, BS, K = 5, 40, 4, 5, 8
CG_TRIPS = 8
NUM_STEPS = 5
SCALE = 25.0
STATES = {"interact": InteractState, "svr-interact": SvrState,
          "gt-dsgd": GtDsgdState, "d-sgd": DsgdState}
STREAM_IDS = {"x": 0, "u": 1}
RULES = ("weighted", "coordinate-median", "trimmed-mean", "krum-like")
KINDS = ("sign-flip", "gaussian", "same-value", "inner-outer-split")
# chip_smoke.py's byzantine rows and int8 EF under trimmed-mean: (algo,
# ER edge probability, attack (kind, num_byzantine), combine, trim,
# guard, compression, the steps held).  The guarded row trips at step 2
# and from the rolled-back state at step 3 (the reference's run).  The
# attacked weighted rows diverge (||x|| 4.3, 23, 282, 3238, 37270 at
# steps 0-4): from step 1 on, their hypergradients are held only in
# ``test_diverging_steps_hold_the_consensus_fields``.
ROWS = {
    "signflip1-weighted": ("interact", 1.0, ("sign-flip", 1), "weighted",
                           None, None, None, (0,)),
    "signflip0-weighted": ("interact", 1.0, ("sign-flip", 0), "weighted",
                           None, None, None, (0, 3)),
    "signflip1-trimmed1": ("interact", 1.0, ("sign-flip", 1),
                           "trimmed-mean", 1, None, None, (0, 3)),
    "signflip1-median-gt-dsgd": ("gt-dsgd", 0.5, ("sign-flip", 1),
                                 "coordinate-median", None, None, None,
                                 (0, 3)),
    "gaussian2-krum-svr": ("svr-interact", 1.0, ("gaussian", 2),
                           "krum-like", None, None, None, (2, 3)),
    "signflip1-weighted-guard": ("interact", 1.0, ("sign-flip", 1),
                                 "weighted", None, dict(nan=True,
                                                        max_norm=1e3),
                                 None, (0, 2, 3)),
    "int8-ef-trimmed1": ("interact", 1.0, ("sign-flip", 1), "trimmed-mean",
                         1, None, "int8", (0, 3)),
}
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


def er_matrix(p: float = 0.5) -> np.ndarray:
    """The main path's ER(p) Laplacian for m = M (seed 0)."""
    return np.asarray(j_laplacian(j_er(M, p, seed=0)).matrix, np.float32)


def reference_noise(kind: str, key, stream: str, t: int, shapes) -> \
        np.ndarray | None:
    """The reference's round noise for ``stream`` at step ``t``: per leaf
    (per-agent ``shapes``) and per slot, concatenated in leaf order, as
    (M, D) (``gaussian``) or (D,) (``same-value``)."""
    if kind not in ("gaussian", "same-value"):
        return None
    key_t = jax.random.fold_in(jax.random.fold_in(key, STREAM_IDS[stream]),
                               t)
    parts = []
    for li, shape in enumerate(shapes):
        leaf_key = jax.random.fold_in(key_t, li)
        if kind == "gaussian":
            parts.append(np.stack([np.asarray(jax.random.normal(
                jax.random.fold_in(leaf_key, i), shape, jnp.float32)
            ).reshape(-1) for i in range(M)]))
        else:
            parts.append(np.asarray(jax.random.normal(
                leaf_key, shape, jnp.float32)).reshape(-1))
    return np.concatenate(parts, axis=-1)


def hand_over(engine, kind: str, seed: int, num_byzantine: int, shapes):
    """Make ``engine``'s attack draw the reference's mask and noise (for
    payloads of per-agent leaf ``shapes``)."""
    key = jax.random.PRNGKey(seed)
    sched = engine.attack_schedule
    sched.mask = torch.tensor(np.asarray(j_byzantine_mask(
        key, M, num_byzantine)))
    sched.draw = lambda stream, t, size: reference_noise(kind, key, stream,
                                                         t, shapes)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((M, 7, 6)).astype(np.float32),
            {"w": rng.standard_normal((M, 88)).astype(np.float32)}]


# -- attacks ----------------------------------------------------------------

def test_registries_match_reference():
    assert attack_names() == j_attack_names()
    assert combine_rule_names() == j_rule_names()
    for kind in KINDS:
        assert make_attack(kind).streams == j_make_attack(kind).streams


@pytest.mark.parametrize("num_byzantine", [0, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_attack_matches_reference(kind, num_byzantine):
    tree, key, t = _tree(1), jax.random.PRNGKey(11), 3
    mask = j_byzantine_mask(key, M, num_byzantine)
    key_t = jax.random.fold_in(jax.random.fold_in(key, 1), t)
    want = np_tree(j_apply_attack(j_make_attack(kind), tree, mask, key_t,
                                  SCALE))
    noise = reference_noise(kind, key, "u", t, [(7, 6), (88,)])
    got = apply_attack(make_attack(kind), tree_from_numpy(tree, "cpu"),
                       torch.tensor(np.asarray(mask)),
                       None if noise is None else torch.tensor(noise),
                       SCALE)
    honest = ~np.asarray(mask)
    for g, w, clean in zip(torch.utils._pytree.tree_leaves(got),
                           jax.tree_util.tree_leaves(want),
                           jax.tree_util.tree_leaves(tree)):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g[honest], w[honest])
        np.testing.assert_array_equal(g[honest], clean[honest])
        np.testing.assert_allclose(g[~honest], w[~honest], rtol=0,
                                   atol=ATTACK_RTOL * np.abs(w).max())


def test_port_draws_keep_the_scheme():
    """The port's mask is a fixed subset of the asked size; a slot's
    score and a round's noise rows do not depend on m; every step and
    stream draws anew."""
    for nb in range(M):
        mask = byzantine_mask(7, M, nb)
        assert mask.sum() == nb
        assert np.array_equal(mask, byzantine_mask(7, M, nb))
    # the subset grows by adding slots: the ranking is one order
    assert all(np.all(byzantine_mask(7, M, nb) <= byzantine_mask(7, M,
                                                                nb + 1))
               for nb in range(M - 1))
    gauss, same = make_attack("gaussian"), make_attack("same-value")
    small = round_noise(gauss, 7, "x", 4, 3, 50)
    np.testing.assert_array_equal(round_noise(gauss, 7, "x", 4, 8, 50)[:3],
                                  small)
    assert small.dtype == np.float32 and small.shape == (3, 50)
    assert round_noise(same, 7, "u", 4, 8, 50).shape == (50,)
    assert round_noise(make_attack("sign-flip"), 7, "x", 4, 3, 50) is None
    draws = [round_noise(gauss, 7, s, t, 3, 50).tobytes()
             for s in ("x", "u") for t in range(4)]
    assert len(set(draws)) == len(draws)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_engine_refills_noise_for_each_round(backend):
    """``load_round(t)`` refills the buffer in place (the address a graph
    holds), with step t's draw."""
    engine = make_engine(backend, ring_mixing(M), "cpu",
                         byzantine=ByzantineConfig("gaussian", 2, SCALE,
                                                   seed=3))
    tree = tree_from_numpy(_tree(2), "cpu")
    engine.mix_ef(tree, None, 0, stream="u")
    buf = engine.attack_schedule.buffers["u"]
    attack = make_attack("gaussian")
    for t in (1, 5):
        engine.load_round(t)
        assert engine.attack_schedule.buffers["u"] is buf
        np.testing.assert_array_equal(
            buf.numpy(), round_noise(attack, 3, "u", t, M, 42 + 88))
    # drawn ahead for steps 2..6: the same numbers, from the device copy
    engine.prefetch_rounds(2, 5)
    for t in (6, 3, 9):
        engine.load_round(t)
        assert engine.attack_schedule.buffers["u"] is buf
        np.testing.assert_array_equal(
            buf.numpy(), round_noise(attack, 3, "u", t, M, 42 + 88))


# -- combine rules ------------------------------------------------------------

MATRICES = {"er0.5": lambda: er_matrix(0.5), "complete": lambda: er_matrix(1.0),
            "ring": lambda: np.asarray(j_ring_mixing(M).matrix, np.float32)}


@pytest.mark.parametrize("graph", sorted(MATRICES))
@pytest.mark.parametrize("rule,trim", [(rule, 1) for rule in RULES]
                         + [("trimmed-mean", 2)])
def test_combine_matches_reference(rule, trim, graph):
    mat = MATRICES[graph]()
    tree = _tree(5)
    want = np_tree(j_robust_combine(jnp.asarray(mat), tree, rule, trim))
    got = robust_combine(torch.tensor(mat), tree_from_numpy(tree, "cpu"),
                         rule, trim)
    scale = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(tree))
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=COMBINE_TOL * scale)


def test_er_supports_and_the_median_trap():
    """The main path's ER(0.5) graph has even supports; the median there
    averages the two middle values (torch.nanmedian would not)."""
    mat = er_matrix(0.5)
    support = (np.abs(mat) > 1e-12) | np.eye(M, dtype=bool)
    assert support.sum(axis=1).tolist() == [4, 2, 3, 4, 2]
    vals = np.arange(M, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                             np.float32)
    want = np.asarray(j_robust_combine(jnp.asarray(mat), jnp.asarray(vals),
                                       "coordinate-median"))
    got = robust_combine(torch.tensor(mat), torch.tensor(vals),
                         "coordinate-median").numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.5            # median of {0, 1, 2, 3}
    # trimmed-mean with f = 1 on a support of 2 falls back to its mean
    got = robust_combine(torch.tensor(mat), torch.tensor(vals),
                         "trimmed-mean", 1).numpy()
    assert got[1, 0] == 0.5 and got[4, 0] == 3.5


def test_trimmed_mean_screens_one_outlier():
    mat = torch.full((M, M), 1.0 / M)
    vals = torch.arange(4.0).expand(M, 4).clone()
    vals[2] = 1e6
    out = robust_combine(mat, vals, "trimmed-mean", 1)
    torch.testing.assert_close(out, torch.arange(4.0).expand(M, 4),
                               atol=1e-5, rtol=0)


def test_krum_ties_pick_the_first_row():
    """Two identical candidate rows: both frameworks adopt the first."""
    mat = er_matrix(1.0)
    vals = np.zeros((M, 2), np.float32)
    vals[:, 0] = [1.0, -1.0, 1.0, -1.0, 5.0]
    want = np.asarray(j_robust_combine(jnp.asarray(mat), jnp.asarray(vals),
                                       "krum-like"))
    got = robust_combine(torch.tensor(mat), torch.tensor(vals),
                         "krum-like").numpy()
    np.testing.assert_array_equal(got, want)


# -- guards ---------------------------------------------------------------

@pytest.mark.parametrize("candidate", ["clean", "nan", "norm"])
def test_guard_matches_reference(candidate):
    """One guarded step from a state with counters (3, 1), onto a
    candidate that is clean, holds a NaN in y, or exceeds the norm."""
    cfg = dict(nan=True, max_norm=50.0)
    rng = np.random.default_rng(4)
    x = [rng.standard_normal((M, 4, 3)).astype(np.float32),
         rng.standard_normal((M, 3)).astype(np.float32)]
    y = rng.standard_normal((M, 6)).astype(np.float32)
    ef = {"x": {"e": np.zeros_like(y), "ref": y + 1}}
    factor = {"clean": 1.5, "nan": 1.5, "norm": 40.0}[candidate]

    def move(xx, yy, efx, lib):
        yy = yy + 1.0
        if candidate == "nan":
            yy = lib.where(lib.arange(6) == 2, float("nan"), yy)
        return [a * factor for a in xx], yy, {"e": efx["e"] + 1,
                                              "ref": efx["ref"] * 2}

    jstate = InteractState(x=x, y=y, u=x, v=y, p_prev=x, t=4, ef=ef,
                           guard={"last_good": np.int32(3),
                                  "tripped": np.int32(1)})
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)

    def jstep(st, data, alpha, beta):
        xx, yy, ee = move(st.x, st.y, st.ef["x"], jnp)
        return st._replace(x=xx, y=yy, ef={"x": ee}, t=st.t + 1)

    want = np_tree(j_guard_step(jstep, JGuard(**cfg))(jstate, None, 0, 0))
    tstate = state_from_numpy(np_tree(jstate), "cpu", InteractState)

    def tstep(st, data, draws):
        xx, yy, ee = move(st.x, st.y, st.ef["x"], torch)
        return st._replace(x=xx, y=yy, ef={"x": ee}, t=st.t + 1)

    got = guard_param_step(tstep, GuardConfig(**cfg),
                           torch.tensor(4, dtype=torch.int32))(
        tstate, None, None)
    assert got.t == int(want.t) == 5
    assert list(got.guard) == ["last_good", "tripped"]
    assert {k: int(v) for k, v in got.guard.items()} == {
        "last_good": 3 if candidate != "clean" else 5,
        "tripped": 1 if candidate == "clean" else 2}
    fields = [f for f in InteractState._fields if f != "t"]
    for g, w in zip(torch.utils._pytree.tree_leaves(
            [getattr(got, f) for f in fields]),
            jax.tree_util.tree_leaves([getattr(want, f) for f in fields])):
        np.testing.assert_array_equal(g.numpy(), w)


def test_init_guard_layout():
    assert init_guard(GuardConfig()) is None and init_guard(None) is None
    guard = init_guard(GuardConfig(max_norm=1.0))
    assert list(guard) == ["last_good", "tripped"]
    assert all(v.dtype == torch.int32 and v.dim() == 0 and int(v) == 0
               for v in guard.values())


# -- one algorithm step from the reference's state --------------------------

def agent_draws(agent_keys, how: str, n_inner: int, n_outer: int) -> Draws:
    """The draws the reference makes from per-agent keys (see
    tests/test_torch_svr_baselines.py): ``full``, ``minibatch`` or
    ``recursive``."""
    def one(key):
        if how == "full":
            zero = jnp.zeros((BS,), jnp.int32)
            return zero, zero, jax.random.randint(key, (), 0, K)
        if how == "recursive":
            key = jax.random.split(key)[0]
        k_in, k_out, k_neu = jax.random.split(key, 3)
        return (jax.random.randint(k_in, (BS,), 0, n_inner),
                jax.random.randint(k_out, (BS,), 0, n_outer),
                jax.random.randint(k_neu, (), 0, K))

    inner, outer, k = jax.vmap(one)(agent_keys)
    return Draws(*(torch.tensor(np.asarray(a), dtype=torch.int64)
                   for a in (inner, outer, k)))


def step_draws_of(algo: str, state, t: int, n_inner: int, n_outer: int):
    """The draws of the reference's step from ``state`` (None for
    INTERACT, which draws nothing)."""
    if algo == "interact":
        return None
    agent_keys = per_agent_keys(jax.random.split(state.key)[1], M)
    if algo != "svr-interact":
        return agent_draws(agent_keys, "minibatch", n_inner, n_outer)
    how = "full" if (t + 1) % Q == 0 else "recursive"
    return agent_draws(agent_keys, how, n_inner, n_outer)


def row_configs(name: str, backend: str = "dense"):
    """The JAX package's and the port's ``SolverConfig`` of a row."""
    algo, p, (kind, nb), rule, trim, guard, comp, _ = ROWS[name]
    common = dict(algo=algo, q=Q, batch_size=BS, seed=0)
    byz = dict(kind=kind, num_byzantine=nb, scale=SCALE, combine=rule,
               trim=trim)
    j = JConfig(**common, topology=JTopology(p_connect=p),
                byzantine=JByzantine(**byz),
                guard=JGuard(**(guard or {})),
                compression=JCompression(comp or "none"),
                hypergrad=JHypergradConfig(cg_iters=CG_TRIPS))
    t = SolverConfig(**common, backend=backend,
                     topology=TopologyConfig(p_connect=p),
                     byzantine=ByzantineConfig(**byz),
                     guard=GuardConfig(**(guard or {})),
                     compression=CompressionConfig(comp or "none"),
                     hypergrad=HypergradConfig(cg_iters=CG_TRIPS))
    return j, t


@pytest.fixture(scope="module")
def instance():
    problem, x0, y0, data = j_default_setup(0, num_agents=M, n_per_agent=N,
                                            hidden=8)
    return dict(problem=problem, x0=x0, y0=y0, data=data,
                n_inner=data.inner_x.shape[1], n_outer=data.outer_x.shape[1],
                tproblem=MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
                tx0=tree_from_numpy(np_tree(x0), "cpu"),
                ty0=tree_from_numpy(np_tree(y0), "cpu"),
                tdata=agent_data_from_numpy(np_tree(data), "cpu"))


@pytest.fixture(scope="module")
def runs():
    """The reference's runs, made on first use and kept for the module."""
    return {}


def reference_run(instance, runs, name: str):
    """The reference's states 0..NUM_STEPS (numpy) and each step's draws."""
    if name not in runs:
        jconfig, _ = row_configs(name)
        solver = j_make_solver(jconfig)
        state = solver.init(None, instance["problem"], None, instance["x0"],
                            instance["y0"], instance["data"])
        states, draws = [np_tree(state)], []
        for t in range(NUM_STEPS):
            draws.append(step_draws_of(jconfig.algo, states[-1], t,
                                       instance["n_inner"],
                                       instance["n_outer"]))
            state = solver.step(jax.tree_util.tree_map(jnp.asarray,
                                                       states[-1]),
                                instance["data"])
            states.append(np_tree(state))
        runs[name] = states, draws
    return runs[name]


def gaps(port_state, ref_state, kind) -> dict:
    """Largest |port - ref| of each field over that field's largest |ref|;
    a field the reference leaves ``None`` must be ``None`` in the port."""
    out = {}
    for f in kind._fields:
        if f == "t":
            continue
        want = getattr(ref_state, f)
        if want is None:
            assert getattr(port_state, f) is None, f
            continue
        got = [l.numpy() for l in
               torch.utils._pytree.tree_leaves(getattr(port_state, f))]
        want = jax.tree_util.tree_leaves(want)
        assert [g.shape for g in got] == [w.shape for w in want], f
        scale = max(float(np.max(np.abs(w))) for w in want) or 1.0
        out[f] = max(float(np.max(np.abs(g - w)))
                     for g, w in zip(got, want)) / scale
    return out


STEP_CASES = [(name, t) for name, row in ROWS.items() for t in row[-1]]


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("name,t", STEP_CASES)
def test_one_step_from_reference_state(instance, runs, name, t, backend):
    algo, _, (kind, nb), *_ = ROWS[name]
    states, draws = reference_run(instance, runs, name)
    state_kind = STATES[algo]
    _, config = row_configs(name, backend)
    solver = make_solver(config).build(instance["tproblem"], device="cpu",
                                       m=M, n=N)
    shapes = [leaf.shape[1:] for leaf in
              jax.tree_util.tree_leaves(states[t].x)]
    hand_over(solver._engine, kind, config.seed, nb, shapes)
    state = solver.step(state_from_numpy(states[t], "cpu", state_kind),
                        instance["tdata"], draws[t])
    assert state.t == t + 1
    g = gaps(state, states[t + 1], state_kind)
    assert max(g.values()) < ONE_STEP_TOL, g
    if config.guard.active:
        assert {k: int(v) for k, v in state.guard.items()} == {
            k: int(v) for k, v in states[t + 1].guard.items()}


# (row, step): steps from an iterate the attack has blown up
DIVERGING = [("signflip1-weighted", t) for t in (1, 2, 3, 4)] + [
    ("signflip1-weighted-guard", 1)]


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("name,t", DIVERGING)
def test_diverging_steps_hold_the_consensus_fields(instance, runs, name, t,
                                                   backend):
    """Steps from an iterate the weighted rule let the attack blow up:
    x and y (what the attack, the combine and the descent produce) and
    the guard's counters stay within ``ONE_STEP_TOL``.  The gradient
    fields are not held here: at these iterates the tanh units
    saturate, and 1 - tanh^2 in float32 turns a rounding difference
    into gaps of up to 1.4e-4 of p's scale between the two packages
    (measured at steps 1-3; x stays within 1.4e-8)."""
    algo, _, (kind, nb), *_ = ROWS[name]
    states, draws = reference_run(instance, runs, name)
    _, config = row_configs(name, backend)
    solver = make_solver(config).build(instance["tproblem"], device="cpu",
                                       m=M, n=N)
    shapes = [leaf.shape[1:] for leaf in
              jax.tree_util.tree_leaves(states[t].x)]
    hand_over(solver._engine, kind, config.seed, nb, shapes)
    state = solver.step(state_from_numpy(states[t], "cpu", STATES[algo]),
                        instance["tdata"], draws[t])
    g = gaps(state, states[t + 1], STATES[algo])
    assert max(g["x"], g["y"], g.get("guard", 0.0)) < ONE_STEP_TOL, g


def test_guarded_row_trips_in_the_reference_run(instance, runs):
    """The steps held for the guarded row cover a clean step and trips."""
    states, _ = reference_run(instance, runs, "signflip1-weighted-guard")
    trips = [int(s.guard["tripped"]) for s in states]
    assert trips[:4] == [0, 0, 0, 1] and trips[4] == 2
    assert int(states[4].guard["last_good"]) == 2


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_ef_ref_tracks_the_attacked_payload(backend):
    """int8 with error feedback under trimmed-mean: the public copy
    advances by what was shipped (attacked), as in the reference; the
    combine sees the reconstructed payload, against the reference's."""
    comp = dict(kind="int8")
    bcfg = dict(kind="sign-flip", num_byzantine=1, scale=2.0, seed=5,
                combine="trimmed-mean", trim=1)
    mat = er_matrix(1.0)
    jeng = j_make_engine("dense", mat, compression=JCompression(**comp),
                         byzantine=JByzantine(**bcfg))
    teng = make_engine(backend, mat, "cpu",
                       compression=CompressionConfig(**comp),
                       byzantine=ByzantineConfig(**bcfg))
    hand_over(teng, "sign-flip", 5, 1, [(7, 6), (88,)])
    tree = _tree(6)
    ef = j_init_ef(JCompression(**comp), x=tree)["x"]
    want, want_ef = np_tree(jeng.mix_ef(tree, ef, 0, stream="x"))
    got, got_ef = teng.mix_ef(tree_from_numpy(tree, "cpu"),
                              tree_from_numpy(np_tree(ef), "cpu"), 0,
                              stream="x")
    for g, w in zip(torch.utils._pytree.tree_leaves((got, got_ef)),
                    jax.tree_util.tree_leaves((want, want_ef))):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=ONE_STEP_TOL * np.abs(w).max())
    attacked = teng._attack_payload(tree_from_numpy(tree, "cpu"), 0, "x")
    plain = make_engine(backend, mat, "cpu",
                        compression=CompressionConfig(**comp))
    _, plain_ef = plain.mix_ef(
        attacked, init_ef(CompressionConfig(**comp), x=attacked)["x"], 0)
    for a, b in zip(torch.utils._pytree.tree_leaves(got_ef["ref"]),
                    torch.utils._pytree.tree_leaves(plain_ef["ref"])):
        assert torch.equal(a, b)


# -- end to end on the CPU ----------------------------------------------------

def _solve(instance, algo, **opts):
    config = SolverConfig(algo=algo, q=Q, batch_size=BS,
                          hypergrad=HypergradConfig(cg_iters=CG_TRIPS),
                          **opts)
    return solve(config, 3, 1, problem=instance["tproblem"],
                 x0=instance["tx0"], y0=instance["ty0"],
                 data=instance["tdata"], measure_hypergrad=False,
                 metric_fn=lambda st: float(sum(
                     l.abs().sum() for l in torch.utils._pytree.tree_leaves(
                         st.x))), device="cpu")


def _same(a, b) -> bool:
    return a.trace == b.trace and all(
        torch.equal(x, y) for x, y in zip(
            torch.utils._pytree.tree_leaves(a.state.x),
            torch.utils._pytree.tree_leaves(b.state.x)))


@pytest.mark.parametrize("algo", sorted(STATES))
def test_weighted_zero_attackers_is_bitwise_and_config_runs(instance, algo):
    """Zero attackers under ``weighted`` is the clean run bit for bit; the
    acceptance config (sign-flip, trimmed-mean f = 1, a guard) runs
    through ``solve`` with every algorithm, its counters read back."""
    clean = _solve(instance, algo)
    zero = _solve(instance, algo, byzantine=ByzantineConfig(
        kind="sign-flip", num_byzantine=0))
    assert _same(clean, zero)
    assert clean.tripped_steps == 0 and clean.last_good_step == -1
    res = _solve(instance, algo, byzantine=ByzantineConfig(
        kind="sign-flip", num_byzantine=1, scale=25, combine="trimmed-mean",
        trim=1), guard=GuardConfig(nan=True, max_norm=1e3))
    assert res.state.guard is not None and len(res.trace) == 4
    assert 0 <= res.tripped_steps <= 3 and res.last_good_step <= 3
    assert all(torch.isfinite(l).all() for l in
               torch.utils._pytree.tree_leaves(res.state.x))


def test_inner_outer_split_spares_dsgd_and_hits_gt_dsgd(instance):
    byz = ByzantineConfig(kind="inner-outer-split", num_byzantine=1,
                          scale=5.0)
    assert _same(_solve(instance, "d-sgd"),
                 _solve(instance, "d-sgd", byzantine=byz))
    assert not _same(_solve(instance, "gt-dsgd"),
                     _solve(instance, "gt-dsgd", byzantine=byz))


def test_guard_clean_run_never_trips(instance):
    res = _solve(instance, "interact", guard=GuardConfig(nan=True,
                                                         max_norm=1e6))
    assert res.tripped_steps == 0 and res.last_good_step == 3


# -- validation ---------------------------------------------------------------

BAD_CONFIGS = {
    "unknown-attack": lambda B, G: B(kind="nope"),
    "unknown-rule": lambda B, G: B(combine="nope"),
    "negative-count": lambda B, G: B(num_byzantine=-1),
    "infinite-scale": lambda B, G: B(scale=float("inf")),
    "zero-trim": lambda B, G: B(trim=0),
    "negative-norm": lambda B, G: G(max_norm=-1.0),
    "infinite-norm": lambda B, G: G(max_norm=float("inf")),
}
BAD_FOR_M = {
    "trimmed-breakdown": dict(combine="trimmed-mean", trim=3),
    "no-honest-agent": dict(kind="sign-flip", num_byzantine=5),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_config_validation_matches_reference(case):
    with pytest.raises(ValueError) as want:
        BAD_CONFIGS[case](JByzantine, JGuard)
    with pytest.raises(ValueError) as got:
        BAD_CONFIGS[case](ByzantineConfig, GuardConfig)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("case", sorted(BAD_FOR_M))
def test_engine_validation_matches_reference(case, backend):
    mat = er_matrix(1.0)
    with pytest.raises(ValueError) as want:
        j_make_engine("dense", mat, byzantine=JByzantine(**BAD_FOR_M[case]))
    with pytest.raises(ValueError) as got:
        make_engine(backend, mat, "cpu",
                    byzantine=ByzantineConfig(**BAD_FOR_M[case]))
    assert str(got.value) == str(want.value)


def test_resolution_and_keys_match_reference():
    for kw in (dict(), dict(num_byzantine=3), dict(trim=2, seed=9),
               dict(combine="trimmed-mean", num_byzantine=2)):
        j, t = JByzantine(**kw), ByzantineConfig(**kw)
        assert t.resolve_trim() == j.resolve_trim()
        assert t.resolve_seed(4) == j.resolve_seed(4)
        assert t.structural_key() == j.structural_key()
        assert (t.active, t.attack_active) == (j.active, j.attack_active)
    assert dataclasses.asdict(ByzantineConfig()) == dataclasses.asdict(
        JByzantine())
    assert GuardConfig(nan=True).active and not GuardConfig().active
