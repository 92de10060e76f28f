"""The port's ``neumann``, ``cholesky``, ``neumann-linearized`` and
``cg-linearized`` backends and ``cg_solve`` against the JAX package's.

Inputs come from the JAX package's Section-6 instance at a small size
(3 agents, n = 40, hidden 8; one agent's split for the single calls).
The stochastic Neumann k is drawn by ``jax.random`` exactly as the
reference's backend draws it from its key, and handed to the port.

Tolerances, from the measured gaps (CPU, float32), each relative to the
largest |value| of the JAX result:
- ``HG_TOL`` = 2e-6 for one hypergradient call: measured at most 2.6e-7
  over the neumann and cholesky cases, a margin of about 8.
- ``CG_TOL`` = 1e-6 for ``cg_solve`` on a 12 x 12 SPD system with
  condition number 4: measured at most 1.2e-7, margin about 8.  (At
  condition number 100 both packages' float32 CG drift 1e-4 to 1e-2
  from a float64 CG in mid-run, so their gap measures rounding.)
- ``LIN_TOL`` = 1e-6 for the linearized backends' z (the engine's solve
  alone): measured at most 2.2e-7 (my CPU runs).
Counts (HVPs, gradients, Hessians, iterations, matvecs) match exactly;
the port's early-exit CG runs every trip with the late ones frozen, so
its ``matvecs`` is the trip count where the reference's is the trips it
ran (its ``iterations``, which the port's equals).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.hypergrad import HypergradConfig as JHypergradConfig  # noqa: E402
from repro.hypergrad import cg_solve as j_cg_solve  # noqa: E402
from repro.hypergrad import (  # noqa: E402
    hypergradient_with_stats as j_hypergradient_with_stats)
from repro.solvers import default_setup as j_default_setup  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 tree_from_numpy)
from repro_torch.core import MLPMetaProblem  # noqa: E402
from repro_torch.hypergrad import (HypergradConfig, cg_solve,  # noqa: E402
                                   hypergradient_with_stats,
                                   measure_counts)

HG_TOL = 2e-6
CG_TOL = 1e-6
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def inst():
    problem, x0, y0, data = j_default_setup(0, num_agents=3, n_per_agent=40,
                                            hidden=8)
    # a head away from its init, so that the softmax is not uniform
    y = jax.tree_util.tree_map(
        lambda a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(7), a.shape),
        y0)
    tdata = agent_data_from_numpy(np_tree(data), "cpu")
    return dict(problem=problem, x=x0, y=y, data=data,
                tproblem=MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
                tx=tree_from_numpy(np_tree(x0), "cpu"),
                ty=tree_from_numpy(np_tree(y), "cpu"), tdata=tdata)


def _rel_gap(got_tree, want_tree) -> float:
    got = [np.asarray(l) for l in torch.utils._pytree.tree_leaves(got_tree)]
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(want_tree)]
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(float(np.max(np.abs(w))) for w in want)
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want)) / scale


def _one_call(inst, agent, jcfg, cfg, key=None, draw=None, closed=True):
    """The JAX and the port's hypergradient call on one agent's batch."""
    d, td = inst["data"], inst["tdata"]
    jp, js = j_hypergradient_with_stats(
        inst["problem"].outer, inst["problem"].inner, inst["x"], inst["y"],
        jcfg, f_args=((d.outer_x[agent], d.outer_y[agent]),),
        g_args=((d.inner_x[agent], d.inner_y[agent]),), key=key,
        inner_hess_yy=inst["problem"].inner_hess_yy if closed else None)
    tp, ts = hypergradient_with_stats(
        inst["tproblem"].outer, inst["tproblem"].inner, inst["tx"],
        inst["ty"], cfg, f_args=((td.outer_x[agent], td.outer_y[agent]),),
        g_args=((td.inner_x[agent], td.inner_y[agent]),), draw=draw,
        inner_hess_yy=inst["tproblem"].inner_hess_yy if closed else None)
    return (jp, tuple(int(c) for c in js)), (tp, tuple(int(c) for c in ts))


@pytest.mark.parametrize("k_terms", [0, 1, 8])
def test_neumann_truncated_matches_jax(inst, k_terms):
    kw = dict(method="neumann", neumann_k=k_terms, lipschitz_g=4.0)
    (jp, jc), (tp, tc) = _one_call(inst, 1, JHypergradConfig(**kw),
                                   HypergradConfig(**kw))
    assert _rel_gap(tp, jp) < HG_TOL
    assert tc == jc == (k_terms + 1, 1, 0)


@pytest.mark.parametrize("seed", range(6))
def test_neumann_stochastic_same_k_matches_jax(inst, seed):
    kw = dict(method="neumann", neumann_k=6, lipschitz_g=4.0,
              stochastic_k=True)
    key = jax.random.PRNGKey(seed)
    k = int(jax.random.randint(key, (), 0, 6))   # the reference's own draw
    (jp, jc), (tp, tc) = _one_call(inst, 0, JHypergradConfig(**kw),
                                   HypergradConfig(**kw), key=key,
                                   draw=torch.tensor(k))
    assert _rel_gap(tp, jp) < HG_TOL
    assert tc == jc == (k + 1, 1, 0)


def test_neumann_stochastic_masks_each_agent_at_its_own_k(inst):
    """Under vmap over agents the port's fixed-length loop freezes each
    agent at its k, as the reference's batched loop does."""
    kw = dict(method="neumann", neumann_k=8, lipschitz_g=4.0,
              stochastic_k=True)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (3, 11, 5)])
    ks = jax.vmap(lambda kk: jax.random.randint(kk, (), 0, 8))(keys)
    assert len(set(np.asarray(ks).tolist())) > 1
    p, d, td = inst["problem"], inst["data"], inst["tdata"]
    want = jax.vmap(lambda ib, ob, kk: j_hypergradient_with_stats(
        p.outer, p.inner, inst["x"], inst["y"], JHypergradConfig(**kw),
        f_args=(ob,), g_args=(ib,), key=kk)[0])(
        (d.inner_x, d.inner_y), (d.outer_x, d.outer_y), keys)
    tp = inst["tproblem"]
    got = torch.func.vmap(lambda ib, ob, kk: hypergradient_with_stats(
        tp.outer, tp.inner, inst["tx"], inst["ty"], HypergradConfig(**kw),
        f_args=(ob,), g_args=(ib,), draw=kk)[0])(
        (td.inner_x, td.inner_y), (td.outer_x, td.outer_y),
        torch.tensor(np.asarray(ks)))
    assert _rel_gap(got, want) < HG_TOL


@pytest.mark.parametrize("closed", [True, False],
                         ids=["closed_form", "hvp_basis"])
@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_cholesky_matches_jax(inst, closed, jitter):
    kw = dict(backend="cholesky", cholesky_jitter=jitter)
    (jp, jc), (tp, tc) = _one_call(inst, 2, JHypergradConfig(**kw),
                                   HypergradConfig(**kw), closed=closed)
    assert _rel_gap(tp, jp) < HG_TOL
    d_y = 8 * 5 + 5
    assert tc == jc == ((1, 1, 1) if closed else (d_y + 1, 2, 0))


def test_stochastic_counts_without_draw_average_sixteen_draws(inst):
    cfg = HypergradConfig(method="neumann", neumann_k=8, lipschitz_g=4.0,
                          stochastic_k=True)
    td = inst["tdata"]
    stats = measure_counts(inst["tproblem"].outer, inst["tproblem"].inner,
                           inst["tx"], inst["ty"], cfg,
                           f_args=((td.outer_x[0], td.outer_y[0]),),
                           g_args=((td.inner_x[0], td.inner_y[0]),))
    ks = torch.randint(0, 8, (16,), generator=torch.Generator().manual_seed(0))
    assert stats.hvp_count == round(float(ks.float().mean()) + 1)
    assert (stats.grad_count, stats.hess_count) == (1, 0)
    with pytest.raises(ValueError, match="drawn k"):
        hypergradient_with_stats(
            inst["tproblem"].outer, inst["tproblem"].inner, inst["tx"],
            inst["ty"], cfg, f_args=((td.outer_x[0], td.outer_y[0]),),
            g_args=((td.inner_x[0], td.inner_y[0]),))


def _spd_system(seed: int):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    a = (q * np.geomspace(1.0, 4.0, 12)) @ q.T
    return a.astype(np.float32), rng.standard_normal(12).astype(np.float32)


@pytest.mark.parametrize("rel_tol", [True, False])
# tolerances well above float32's residual floor (about 2e-8 here), where
# the trip at which the iterate freezes is decided by rounding
@pytest.mark.parametrize("iters,tol", [(6, 1e-8), (40, 1e-4), (40, 1e-2)],
                         ids=["short", "converged", "frozen_early"])
def test_cg_solve_and_info_match_jax(rel_tol, iters, tol):
    a, b = _spd_system(0)
    # a pytree right-hand side: the 12 unknowns as (8,) and (2, 2)
    split = lambda v: (v[:8], v[8:].reshape(2, 2))
    join_j = lambda t: jnp.concatenate([t[0], t[1].reshape(-1)])
    join_t = lambda t: torch.cat([t[0], t[1].reshape(-1)])
    ja, ta = jnp.asarray(a), torch.tensor(a)
    jx, jinfo = j_cg_solve(lambda v: split(ja @ join_j(v)),
                           split(jnp.asarray(b)), iters, tol,
                           rel_tol=rel_tol, return_info=True)
    tx, tinfo = cg_solve(lambda v: split(ta @ join_t(v)),
                         split(torch.tensor(b)), iters, tol,
                         rel_tol=rel_tol, return_info=True)
    assert _rel_gap(tx, jx) < CG_TOL
    assert int(tinfo.iterations) == int(jinfo.iterations)
    assert tinfo.matvecs == int(jinfo.matvecs) == iters
    assert float(tinfo.residual_norm) == pytest.approx(
        float(jinfo.residual_norm), rel=1e-3, abs=1e-6)
    assert cg_solve(lambda v: split(ta @ join_t(v)), split(torch.tensor(b)),
                    iters, tol, rel_tol=rel_tol)[0].shape == (8,)


# ---------------------------------------------------------------------------
# the linearize-once backends
# ---------------------------------------------------------------------------

LIN_TOL = 1e-6
LINEARIZED = {
    "neumann-K1": dict(backend="neumann-linearized", neumann_k=1,
                       lipschitz_g=4.0),
    "neumann-K8": dict(backend="neumann-linearized", neumann_k=8,
                       lipschitz_g=4.0),
    "cg-rel": dict(backend="cg-linearized", cg_iters=32, cg_tol=1e-4,
                   cg_rel_tol=True),
    "cg-short": dict(backend="cg-linearized", cg_iters=6),
    "cg-frozen-early": dict(backend="cg-linearized", cg_iters=40,
                            cg_tol=1e-2, cg_rel_tol=True),
}


def _solve_z(inst, agent, kw, key=None, draw=None):
    """z = [H_yy g]^{-1} grad_y f from each package's engine, and its
    stats."""
    from repro.hypergrad import get_backend as j_get_backend
    from repro_torch.hypergrad import get_backend
    d, td = inst["data"], inst["tdata"]
    jb = jax.grad(inst["problem"].outer, argnums=1)(
        inst["x"], inst["y"], (d.outer_x[agent], d.outer_y[agent]))
    jz, js = j_get_backend(kw["backend"]).solve(
        inst["problem"].inner, inst["x"], inst["y"], jb,
        JHypergradConfig(**kw), ((d.inner_x[agent], d.inner_y[agent]),),
        key)
    tb = torch.func.grad(inst["tproblem"].outer, argnums=1)(
        inst["tx"], inst["ty"], (td.outer_x[agent], td.outer_y[agent]))
    tz, ts = get_backend(kw["backend"]).solve(
        inst["tproblem"].inner, inst["tx"], inst["ty"], tb,
        HypergradConfig(**kw), ((td.inner_x[agent], td.inner_y[agent]),),
        draw)
    return (jz, tuple(int(c) for c in js)), (tz, tuple(int(c) for c in ts))


@pytest.mark.parametrize("name", sorted(LINEARIZED))
def test_linearized_backends_match_jax(inst, name):
    kw = LINEARIZED[name]
    (jz, jc), (tz, tc) = _solve_z(inst, 1, kw)
    gap = _rel_gap(tz, jz)
    print(f"{name}: z gap {gap:.2e} (bound {LIN_TOL}), counts {tc}")
    assert gap < LIN_TOL
    assert tc == jc
    (jp, jc), (tp, tc) = _one_call(inst, 1, JHypergradConfig(**kw),
                                   HypergradConfig(**kw))
    assert _rel_gap(tp, jp) < HG_TOL
    assert tc == jc


def test_neumann_linearized_stochastic_matches_jax(inst):
    kw = dict(backend="neumann-linearized", neumann_k=6, lipschitz_g=4.0,
              stochastic_k=True)
    key = jax.random.PRNGKey(4)
    k = int(jax.random.randint(key, (), 0, 6))
    (jz, jc), (tz, tc) = _solve_z(inst, 0, kw, key=key, draw=torch.tensor(k))
    assert _rel_gap(tz, jz) < LIN_TOL
    assert tc == jc == (k, 1, 0)
    with pytest.raises(ValueError, match="drawn k"):
        _solve_z(inst, 0, kw, key=key)


@pytest.mark.parametrize("backend", ["cg-linearized", "neumann-linearized"])
def test_linearized_under_vmap_takes_the_same_value(inst, backend):
    """Under vmap over agents the tangent map is a fresh jvp each
    application (linearize has no batching rule): the same z."""
    from repro_torch.hypergrad import get_backend
    cfg = HypergradConfig(backend=backend, neumann_k=4, lipschitz_g=4.0,
                          cg_iters=12)
    tp, td = inst["tproblem"], inst["tdata"]

    def z_of(ib, ob):
        b = torch.func.grad(tp.outer, argnums=1)(inst["tx"], inst["ty"], ob)
        return get_backend(backend).solve(tp.inner, inst["tx"], inst["ty"],
                                          b, cfg, (ib,))[0]

    batched = torch.func.vmap(z_of)((td.inner_x, td.inner_y),
                                    (td.outer_x, td.outer_y))
    for agent in range(3):
        one = z_of((td.inner_x[agent], td.inner_y[agent]),
                   (td.outer_x[agent], td.outer_y[agent]))
        for a, b in zip(one, batched):
            torch.testing.assert_close(a, b[agent], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("rel_tol", [True, False])
@pytest.mark.parametrize("iters,tol", [(6, 1e-8), (40, 1e-4), (40, 1e-2)],
                         ids=["short", "converged", "frozen_early"])
def test_cg_solve_early_exit_matches_jax(rel_tol, iters, tol):
    a, b = _spd_system(1)
    ja, ta = jnp.asarray(a), torch.tensor(a)
    jx, jinfo = j_cg_solve(lambda v: ja @ v, jnp.asarray(b), iters, tol,
                           rel_tol=rel_tol, early_exit=True,
                           return_info=True)
    tx, tinfo = cg_solve(lambda v: ta @ v, torch.tensor(b), iters, tol,
                         rel_tol=rel_tol, early_exit=True, return_info=True)
    assert _rel_gap(tx, jx) < CG_TOL
    assert int(tinfo.iterations) == int(jinfo.iterations) == int(
        jinfo.matvecs)
    assert tinfo.matvecs == iters     # every trip runs; the late ones frozen
    assert float(tinfo.residual_norm) == pytest.approx(
        float(jinfo.residual_norm), rel=1e-3, abs=1e-6)
