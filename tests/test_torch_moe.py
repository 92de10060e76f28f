"""The port's MoE ffn against the JAX package's.

Reduced mixtral-8x7b (4 experts, top 2) and a dbrx-like reduced config
(8 experts, top 4), float32.  The JAX ``init_moe`` draws the weights,
which carry over as numpy; the same numpy tokens (2 x 48, from a seed)
go through both packages; a direction shared by every token skews the
router, so that tokens drop at the default factor.

- ``moe_ffn`` at the default capacity factor 1.25, where tokens drop, and
  at ``num_experts / top_k``, where the capacity is the token count and
  nothing can drop; its kept set of (token, slot, expert, position)
  entries equals the JAX package's exactly (read off the JAX dispatch
  tensor as it is contracted);
- ``token_chunk`` (3 chunks, each with its own capacity, the aux
  averaged over them);
- ``moe_ffn_exact``; the aux of both routes.

Outputs and aux within ``TOL`` = 1e-5 of the JAX values' max-abs scale.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import moe as JMoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.models import moe as Moe  # noqa: E402

TOL = 1e-5
BATCH, SEQ = 2, 48
CONFIGS = {"mixtral-8x7b": {},
           "dbrx-like": dict(num_experts=8, experts_per_token=4)}


def _cfg(name):
    arch = "dbrx-132b" if name == "dbrx-like" else name
    cfg = j_get_config(arch).reduced(**CONFIGS[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        get_config(arch).reduced(**CONFIGS[name]))
    return cfg


@pytest.fixture(scope="module", params=list(CONFIGS))
def setup(request):
    cfg = _cfg(request.param)
    jparams = JMoe.init_moe(jax.random.PRNGKey(0), cfg.d_model, cfg.d_ff,
                            cfg.num_experts, jnp.float32)
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    # a direction shared by every token skews the router, so that the
    # popular experts overflow at the default capacity factor
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((BATCH, SEQ, cfg.d_model))
         + 2.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    return cfg, jparams, params, x


def _close(got, want):
    want = np.asarray(want)
    gap = float(np.abs(got.numpy() - want).max())
    assert gap <= TOL * float(np.abs(want).max()), (gap, TOL)


class _DispatchRecorder:
    """Stands in for ``jax.numpy`` inside ``repro.models.moe``: records
    the dispatch tensor (n, k, E, C) of each ``moe_ffn`` call."""

    def __init__(self):
        self.dispatch = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kw):
        if spec == "nkec,nd->ecd":
            self.dispatch.append(np.asarray(operands[0]))
        return jnp.einsum(spec, *operands, **kw)


def _kept_set(routing: Moe.Routing) -> set:
    keep = routing.keep.numpy()
    tokens, slots = np.nonzero(keep)
    return set(zip(tokens.tolist(), slots.tolist(),
                   routing.experts.numpy()[keep].tolist(),
                   routing.positions.numpy()[keep].tolist()))


@pytest.mark.parametrize("factor", ["default", "no-drop"])
def test_moe_ffn_matches_jax_with_the_same_kept_set(setup, factor,
                                                    monkeypatch):
    cfg, jparams, params, x = setup
    capacity_factor = (1.25 if factor == "default"
                       else cfg.num_experts / cfg.experts_per_token)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
              capacity_factor=capacity_factor)
    recorder = _DispatchRecorder()
    monkeypatch.setattr(JMoe, "jnp", recorder)
    jout, jaux = JMoe.moe_ffn(jparams, jnp.asarray(x), **kw)
    out, aux = Moe.moe_ffn(params, torch.tensor(x), **kw)
    _close(out, jout)
    _close(aux, jaux)

    (dispatch,) = recorder.dispatch
    want = set(map(tuple, np.argwhere(dispatch != 0).tolist()))
    routing = Moe.capacity_routing(
        params, torch.tensor(x).reshape(-1, cfg.d_model), **kw)
    got = _kept_set(routing)
    assert got == want
    n_slots = BATCH * SEQ * cfg.experts_per_token
    if factor == "default":
        assert routing.capacity == int(1.25 * n_slots / cfg.num_experts)
        assert len(got) < n_slots        # tokens drop here
    else:
        assert routing.capacity == BATCH * SEQ
        assert len(got) == n_slots       # and none here


def test_token_chunk_matches_jax(setup):
    cfg, jparams, params, x = setup
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
              token_chunk=BATCH * SEQ // 3)
    jout, jaux = JMoe.moe_ffn(jparams, jnp.asarray(x), **kw)
    out, aux = Moe.moe_ffn(params, torch.tensor(x), **kw)
    _close(out, jout)
    _close(aux, jaux)
    whole, _ = Moe.moe_ffn(params, torch.tensor(x), num_experts=kw[
        "num_experts"], top_k=kw["top_k"])
    assert not torch.equal(out, whole)   # each chunk has its own capacity


def test_moe_ffn_exact_matches_jax(setup):
    cfg, jparams, params, x = setup
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token)
    jout, jaux = JMoe.moe_ffn_exact(jparams, jnp.asarray(x), **kw)
    out, aux = Moe.moe_ffn_exact(params, torch.tensor(x), **kw)
    _close(out, jout)
    _close(aux, jaux)


def test_routes_agree_where_nothing_drops(setup):
    cfg, _, params, x = setup
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token)
    capacity, aux_c = Moe.moe_ffn(
        params, torch.tensor(x),
        capacity_factor=cfg.num_experts / cfg.experts_per_token, **kw)
    exact, aux_e = Moe.moe_ffn_exact(params, torch.tensor(x), **kw)
    torch.testing.assert_close(capacity, exact, atol=1e-5, rtol=1e-5)
    assert float(aux_c) == float(aux_e)


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(6), size=40).astype(np.float32)
    mask = (rng.random((40, 6)) < 0.3).astype(np.float32)
    want = JMoe.router_load_balance_loss(jnp.asarray(probs),
                                         jnp.asarray(mask))
    got = Moe.router_load_balance_loss(torch.tensor(probs),
                                       torch.tensor(mask))
    _close(got, want)
