"""The port's problem, mixing matrices and hypergradient against JAX.

Section-6 widths (d_in 16, a 2x20 tanh backbone, a 5-class head, 5
agents, Erdos-Renyi(0.5) Laplacian mixing) with a small n.  Inputs come
from the JAX package's own ``default_setup`` and cross as numpy arrays.

Tolerances, all float32: losses and first derivatives 1e-5 of their
scale (reductions in another order); HVPs and the closed-form Hessian
1e-5; the 32-trip CG hypergradient 1e-4 of its scale (32 dependent
iterations, each adding rounding of order 1e-7, frozen past convergence).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.hypergrad as jhg  # noqa: E402
from repro.solvers import TopologyConfig as JTopologyConfig  # noqa: E402
from repro.solvers import default_setup as j_default_setup  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.hypergrad as thg  # noqa: E402
from repro_torch.solvers import TopologyConfig  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 tree_from_numpy)

leaves = torch.utils._pytree.tree_leaves
DERIV_TOL = 1e-5
CG_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    problem, x0, y0, data = j_default_setup(0, num_agents=5, n_per_agent=60)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    # move off the initial point so the head's softmax is not uniform
    rng = np.random.default_rng(0)
    y0 = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.standard_normal(a.shape).astype(np.float32),
        np_tree(y0))
    v = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), y0)
    tdata = agent_data_from_numpy(np_tree(data), "cpu")
    agent = lambda d, i: ((d.inner_x[i], d.inner_y[i]),
                          (d.outer_x[i], d.outer_y[i]))
    return dict(
        j=dict(problem=problem, x=np_tree(x0), y=y0, v=v,
               batches=[agent(data, i) for i in range(5)]),
        t=dict(problem=tcore.MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
               x=tree_from_numpy(np_tree(x0), "cpu"),
               y=tree_from_numpy(y0, "cpu"), v=tree_from_numpy(v, "cpu"),
               batches=[agent(tdata, i) for i in range(5)]))


def _close(got, want, tol):
    got = [np.asarray(g) for g in leaves(got)]
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    scale = max(float(np.max(np.abs(w))) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("kind,args", [
    ("er", (5, 0.5, 0)), ("er", (5, 0.5, 7)), ("er", (12, 0.3, 1)),
    ("er", (6, 0.01, 2)), ("ring", (1,)), ("ring", (2,)), ("ring", (5,)),
    ("torus", (2, 3)), ("torus", (4, 4)),
])
def test_mixing_matrices_bit_equal(kind, args):
    if kind == "er":
        j_adj, t_adj = jcore.erdos_renyi_adjacency(*args), \
            tcore.erdos_renyi_adjacency(*args)
        np.testing.assert_array_equal(t_adj, j_adj)
        pairs = [(jcore.laplacian_mixing(j_adj), tcore.laplacian_mixing(t_adj)),
                 (jcore.metropolis_mixing(j_adj),
                  tcore.metropolis_mixing(t_adj))]
    elif kind == "ring":
        pairs = [(jcore.ring_mixing(*args), tcore.ring_mixing(*args))]
    else:
        pairs = [(jcore.torus_mixing(*args), tcore.torus_mixing(*args))]
    for j_spec, t_spec in pairs:
        np.testing.assert_array_equal(t_spec.matrix, j_spec.matrix)
        assert t_spec.lam == j_spec.lam
        assert t_spec.neighbors == j_spec.neighbors
        assert t_spec.weights == j_spec.weights
        assert t_spec.lam == tcore.second_eigenvalue(t_spec.matrix)


@pytest.mark.parametrize("kind,m", [("erdos-renyi", 5), ("erdos-renyi", 9),
                                    ("ring", 6), ("torus", 12)])
def test_topology_config_matrix_bit_equal(kind, m):
    want = JTopologyConfig(kind=kind, seed=3).mixing_spec(m)
    got = TopologyConfig(kind=kind, seed=3).mixing_spec(m)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert got.lam == want.lam and got.num_agents == m


@pytest.mark.parametrize("args", [(0.5, 4.0, 0.6, 5), (0.1, 2.0, 0.95, 8),
                                  (1.0, 1.0, 0.0, 2)])
def test_theorem1_step_sizes_match(args):
    assert tcore.theorem1_step_sizes(*args, safety=0.7) == \
        jcore.theorem1_step_sizes(*args, safety=0.7)


@pytest.mark.parametrize("agent", [0, 3])
def test_losses_and_inner_gradient_match(setup, agent):
    j, t = setup["j"], setup["t"]
    (ji, jo), (ti, to) = j["batches"][agent], t["batches"][agent]
    for name, jb, tb in (("outer", jo, to), ("inner", ji, ti)):
        want = float(getattr(j["problem"], name)(j["x"], j["y"], jb))
        got = float(getattr(t["problem"], name)(t["x"], t["y"], tb))
        assert got == pytest.approx(want, rel=DERIV_TOL)
    want = jax.grad(j["problem"].inner, argnums=1)(j["x"], j["y"], ji)
    got = torch.func.grad(t["problem"].inner, argnums=1)(t["x"], t["y"], ti)
    _close(got, want, DERIV_TOL)
    want = jax.grad(j["problem"].outer, argnums=0)(j["x"], j["y"], jo)
    got = torch.func.grad(t["problem"].outer, argnums=0)(t["x"], t["y"], to)
    _close(got, want, DERIV_TOL)


def test_inner_hess_yy_matches_and_agrees_with_hvp(setup):
    j, t = setup["j"], setup["t"]
    ji, ti = j["batches"][1][0], t["batches"][1][0]
    want = np.asarray(j["problem"].inner_hess_yy(j["x"], j["y"], ji))
    got = t["problem"].inner_hess_yy(t["x"], t["y"], ti)
    assert got.shape == (105, 105)
    np.testing.assert_allclose(got.numpy(), want, atol=DERIV_TOL, rtol=0)
    # the closed form is the Hessian the HVPs apply
    flat_v = torch.cat([l.reshape(-1) for l in leaves(t["v"])])
    hv = thg.hvp_yy(t["problem"].inner, t["x"], t["y"], t["v"], ti)
    torch.testing.assert_close(torch.cat([l.reshape(-1) for l in leaves(hv)]),
                               got @ flat_v, atol=1e-5, rtol=1e-5)


def test_hvps_match(setup):
    j, t = setup["j"], setup["t"]
    ji, ti = j["batches"][2][0], t["batches"][2][0]
    _close(thg.hvp_yy(t["problem"].inner, t["x"], t["y"], t["v"], ti),
           jhg.hvp_yy(j["problem"].inner, j["x"], j["y"], j["v"], ji),
           DERIV_TOL)
    _close(thg.hvp_xy(t["problem"].inner, t["x"], t["y"], t["v"], ti),
           jhg.hvp_xy(j["problem"].inner, j["x"], j["y"], j["v"], ji),
           DERIV_TOL)


@pytest.mark.parametrize("cg_rel_tol", [False, True])
def test_cg_hypergradient_and_counts_match(setup, cg_rel_tol):
    j, t = setup["j"], setup["t"]
    (ji, jo), (ti, to) = j["batches"][4], t["batches"][4]
    j_cfg = jhg.HypergradConfig(cg_rel_tol=cg_rel_tol)
    t_cfg = thg.HypergradConfig(cg_rel_tol=cg_rel_tol)
    want, j_stats = jhg.hypergradient_with_stats(
        j["problem"].outer, j["problem"].inner, j["x"], j["y"], j_cfg,
        f_args=(jo,), g_args=(ji,))
    got, t_stats = thg.hypergradient_with_stats(
        t["problem"].outer, t["problem"].inner, t["x"], t["y"], t_cfg,
        f_args=(to,), g_args=(ti,))
    _close(got, want, CG_TOL)
    assert (t_stats.hvp_count, t_stats.grad_count, t_stats.hess_count) == (
        int(j_stats.hvp_count), int(j_stats.grad_count),
        int(j_stats.hess_count)) == (33, 1, 0)


def test_measure_problem_counts_match_jax():
    problem, x0, y0, data = j_default_setup(0, num_agents=5, n_per_agent=40)
    np_tree = lambda tr: jax.tree_util.tree_map(np.asarray, tr)
    want = jhg.measure_problem_counts(problem, jhg.HypergradConfig(), x0, y0,
                                      data)
    got = thg.measure_problem_counts(
        tcore.MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
        thg.HypergradConfig(), tree_from_numpy(np_tree(x0), "cpu"),
        tree_from_numpy(np_tree(y0), "cpu"),
        agent_data_from_numpy(np_tree(data), "cpu"))
    assert tuple(got) == tuple(int(c) for c in want) == (33, 1, 0)


@pytest.mark.parametrize("name", ["cg-linearized", "neumann-linearized",
                                  "no-such"])
def test_unported_hypergrad_backends_raise(name):
    """A name the port does not register raises; the linearize-once
    backends, once unported, now resolve to themselves."""
    cfg = thg.HypergradConfig(backend=name)
    if name.endswith("-linearized"):
        assert cfg.resolve_backend() == name
    else:
        with pytest.raises(ValueError):
            cfg.resolve_backend()
    assert thg.available_backends() == ("cg", "cg-linearized", "cholesky",
                                        "neumann", "neumann-linearized")
