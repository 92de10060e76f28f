"""The vision and audio frontends' prefix tokens against the JAX package.

Reduced paligemma-3b (8 query heads over one kv head in the full model;
here 4 over 1) and musicgen-medium (multi-head), as ``reduced()`` makes
them, the prefix kept: 8 prefix embeddings of width 1152 and 768, drawn
as ``0.1 * N(0, 1)`` from a numpy seed (the JAX frontends are stubs, as
tests/test_arch_smoke.py feeds them), projected by ``frontend_proj`` and
put before 24 tokens.  The JAX ``init_params`` draws the weights and
``lm_params_from_numpy`` carries them over, ``frontend_proj`` among them.

Held, float32:
- ``forward`` with the prefix and ``make_prefill_step``'s prefill with
  it, under ``impl`` reference, blockwise and cuda (its plain version on
  CPU tensors), against the JAX ``forward`` and prefill, within ``TOL``
  = 1e-4 (tests/test_torch_lm.py's);
- the cached prefill and decode steps, which take no prefix in either
  package, against the JAX ``prefill`` and ``decode_step``;
- ``local_grads`` with an inner and an outer prefix, paligemma under
  ``attn_impl="reference"`` and musicgen under ``"blockwise"``, within
  ``LG_TOL`` = 1e-5 of each leaf's scale (tests/test_torch_substrate.py's);
- two INTERACT train steps with ``with_prefix=True`` on a mesh of one
  agent in this process (``AgentMesh.local``: the fewest processes the
  train tests' harness allows), against tests/test_torch_train.py's
  composed reference (the JAX ``local_grads`` and the mix, here of one
  agent) at its settings and bounds.
The largest gaps are printed beside their bounds.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_worker as W  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.serving import make_prefill_step as j_prefill_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import bilevel_lm as JB  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch.serving import (make_prefill_step,  # noqa: E402
                                        make_serve_step)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding.collectives import AgentMesh  # noqa: E402
from repro_torch.train.bilevel_lm import BilevelHyper, local_grads  # noqa: E402
from repro_torch.train.step import (InteractConfig, TrainState,  # noqa: E402
                                    make_train_step)

ARCHS = ["paligemma-3b", "musicgen-medium"]
TOL, LG_TOL = 1e-4, 1e-5
XY_TOL, UV_TOL = 1e-5, 1e-4
BATCH, SEQ, DECODE = 2, 24, 3
LG_IMPL = {"paligemma-3b": "reference", "musicgen-medium": "blockwise"}
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
leaves = torch.utils._pytree.tree_leaves


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key, with_head=True))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + DECODE))
    prefix = (0.1 * rng.standard_normal(
        (BATCH, cfg.num_prefix_tokens, cfg.frontend_dim))).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=lm_params_from_numpy(np_tree(jparams), cfg, "cpu"),
                tokens=tokens, prefix=prefix)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


@functools.lru_cache(maxsize=None)
def _jax_forward(arch):
    """The JAX ``forward``'s logits and its prefill step's, both with the
    prefix (each one compile)."""
    s = _setup(arch)
    args = (s["jparams"], jnp.asarray(s["tokens"][:, :SEQ]),
            jnp.asarray(s["prefix"]))
    logits = jax.jit(lambda p, t, x: JM.forward(
        s["jcfg"], p, t, prefix_embed=x, remat=False)[0])(*args)
    return np.asarray(logits), np.asarray(jax.jit(j_prefill_step(
        s["jcfg"]))(*args))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _gap(got, want) -> float:
    """Largest gap over leaves, relative to each leaf's max-abs scale."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(leaves(got), leaves(want)))


def test_frontend_proj_carries_over(setup):
    s = setup
    cfg = s["cfg"]
    assert M.param_count(s["params"]) == JM.param_count(s["jparams"])
    np.testing.assert_array_equal(s["params"]["frontend_proj"].numpy(),
                                  np.asarray(s["jparams"]["frontend_proj"]))
    # the port's own draw: the JAX package's shape and scale
    proj = M.init_params(cfg, seed=0, device="cpu")["frontend_proj"]
    assert tuple(proj.shape) == (cfg.frontend_dim, cfg.d_model)
    assert float(proj.std()) == pytest.approx(cfg.frontend_dim ** -0.5,
                                              rel=0.05)


@pytest.mark.parametrize("impl", ["reference", "blockwise", "cuda"])
def test_forward_with_prefix_matches_jax(setup, impl):
    s = setup
    cfg = s["cfg"]
    tokens = torch.tensor(s["tokens"][:, :SEQ])
    logits, aux = M.forward(cfg, s["params"], tokens,
                            prefix_embed=torch.tensor(s["prefix"]),
                            impl=impl)
    assert tuple(logits.shape) == (BATCH, cfg.num_prefix_tokens + SEQ,
                                   cfg.vocab_size)
    want = _jax_forward(cfg.name)[0]
    print(f"{cfg.name} {impl}: largest logit gap "
          f"{float(np.abs(logits.numpy() - want).max()):.2e} (bound {TOL})")
    _close(logits, want)
    # lm_loss drops the prefix's logits
    assert float(M.lm_loss(cfg, logits, tokens)) == pytest.approx(
        float(JM.lm_loss(s["jcfg"], jnp.asarray(want),
                         jnp.asarray(s["tokens"][:, :SEQ]))), rel=1e-5)


@pytest.mark.parametrize("impl", ["reference", "blockwise", "cuda"])
def test_prefill_step_with_prefix_matches_jax(setup, impl):
    s = setup
    got = make_prefill_step(s["cfg"], attn_impl=impl, device="cpu")(
        s["params"], torch.tensor(s["tokens"][:, :SEQ]),
        torch.tensor(s["prefix"]))
    assert tuple(got.shape) == (BATCH, s["cfg"].vocab_size)
    _close(got, _jax_forward(s["cfg"].name)[1])


def test_prefill_then_decode_without_prefix_matches_jax(setup):
    s = setup
    jcfg, cfg = s["jcfg"], s["cfg"]
    tokens, size = s["tokens"], SEQ + DECODE
    jcache = JM.init_cache(jcfg, BATCH, size)
    jlogits, jcache = jax.jit(lambda p, t, c: JM.prefill(
        jcfg, p, p["head"], t, c))(s["jparams"], jnp.asarray(tokens[:, :SEQ]),
                                   jcache)
    cache = M.init_cache(cfg, BATCH, size, device="cpu")
    logits, cache = M.prefill(cfg, s["params"], s["params"]["head"],
                              torch.tensor(tokens[:, :SEQ]), cache)
    _close(logits, jlogits)
    jdecode = jax.jit(lambda p, tok, c, t: JM.decode_step(
        jcfg, p, p["head"], tok, c, t))
    step = make_serve_step(cfg, attn_impl="blockwise", device="cpu")
    for t in range(SEQ, size):
        tok = tokens[:, t:t + 1]
        jl, jcache = jdecode(s["jparams"], jnp.asarray(tok), jcache,
                             jnp.asarray(t, jnp.int32))
        logits, cache = step(s["params"], torch.tensor(tok), cache, t)
        _close(logits, jl[:, 0])


HYPER = W.hyper_kwargs()


@functools.lru_cache(maxsize=None)
def _jax_local_grads(arch, impl):
    s = _setup(arch)
    hyper = JB.BilevelHyper(**HYPER, attn_impl=impl)
    return jax.jit(lambda x, y, a, b, pa, pb: JB.local_grads(
        s["jcfg"], hyper, x, y, a, b, prefix_inner=pa, prefix_outer=pb))


def _splits(s):
    """The inner and outer halves of the batch: tokens and prefixes."""
    tokens, prefix = s["tokens"][:, :SEQ], s["prefix"]
    return (tokens[:1], tokens[1:], prefix[:1], prefix[1:])


def _backbone(tree):
    return {k: v for k, v in tree.items() if k != "head"}


@pytest.mark.parametrize("arch", ARCHS)
def test_local_grads_with_prefix_match_jax(arch):
    s = _setup(arch)
    impl = LG_IMPL[arch]
    jp, jv, jce = _jax_local_grads(arch, impl)(
        _backbone(s["jparams"]), s["jparams"]["head"],
        *(jnp.asarray(a) for a in _splits(s)))
    p, v, ce = local_grads(
        s["cfg"], BilevelHyper(**HYPER, attn_impl=impl),
        _backbone(s["params"]), s["params"]["head"],
        *(torch.tensor(a) for a in _splits(s)))
    gaps = {"p": _gap(p, lm_params_from_numpy(np_tree(jp), s["cfg"], "cpu")),
            "v": _gap(v, torch.tensor(np.asarray(jv))),
            "outer_ce": abs(float(ce) - float(jce)) / abs(float(jce))}
    print(f"{arch} {impl}: largest gaps {gaps} (bound {LG_TOL})")
    assert max(gaps.values()) < LG_TOL, gaps
    assert set(p) == set(_backbone(s["params"]))   # frontend_proj's too
    assert float(p["frontend_proj"].abs().max()) > 0


def test_train_step_with_prefix_matches_composed_reference():
    arch = "paligemma-3b"
    s = _setup(arch)
    cfg = s["cfg"]
    lg = _jax_local_grads(arch, "reference")
    alpha, beta = W.SETTINGS["alpha"], W.SETTINGS["beta"]
    # the composed reference of Algorithm 1 on one agent: the mix is the
    # identity, so x <- x - alpha u, y <- y - beta v, u <- u + p - p_prev
    # (in numpy, float32, on the JAX local_grads' values)
    tmap = jax.tree_util.tree_map
    jx = np_tree(_backbone(s["jparams"]))
    jy = np.asarray(s["jparams"]["head"])
    ref = dict(x=jx, y=jy, u=tmap(np.zeros_like, jx), v=np.zeros_like(jy),
               p_prev=tmap(np.zeros_like, jx))
    ref_ce = []
    for _ in range(2):
        x = tmap(lambda a, u: a - np.float32(alpha) * u, ref["x"], ref["u"])
        y = ref["y"] - np.float32(beta) * ref["v"]
        p, v, ce = np_tree(lg(x, y, *(jnp.asarray(a) for a in _splits(s))))
        u = tmap(lambda a, b, c: a + b - c, ref["u"], p, ref["p_prev"])
        ref = dict(x=x, y=y, u=u, v=v, p_prev=p)
        ref_ce.append(float(ce))

    un = lambda t: torch.utils._pytree.tree_map(lambda l: l[None], t)
    x0 = un(_backbone(s["params"]))
    state = TrainState(
        x=x0, y=s["params"]["head"][None],
        u=torch.utils._pytree.tree_map(torch.zeros_like, x0),
        v=torch.zeros_like(s["params"]["head"][None]),
        p_prev=torch.utils._pytree.tree_map(torch.zeros_like, x0), t=0)
    icfg = InteractConfig(alpha=alpha, beta=beta,
                          hyper=BilevelHyper(**HYPER))
    step = make_train_step(cfg, AgentMesh.local(1, "cpu"), icfg,
                           with_prefix=True)
    tokens = torch.tensor(s["tokens"][None, :, :SEQ])
    prefix = torch.tensor(s["prefix"][None])
    ces = []
    for _ in range(2):
        state, metrics = step(state, tokens, prefix)
        ces.append(float(metrics["outer_ce"]))
    assert state.t == 2
    gaps = {}
    for field in ("x", "y", "u", "v", "p_prev"):
        want = ref[field]
        want = (lm_params_from_numpy(want, cfg, "cpu")
                if isinstance(want, dict) else torch.tensor(want))
        got = getattr(state, field)
        gaps[field] = _gap(torch.utils._pytree.tree_map(lambda l: l[0], got),
                           want)
    print(f"train step with prefix: largest gaps {gaps} (x, y bound {XY_TOL};"
          f" u, v bound {UV_TOL})")
    assert gaps["x"] < XY_TOL and gaps["y"] < XY_TOL, gaps
    assert gaps["u"] < UV_TOL and gaps["v"] < UV_TOL, gaps
    assert ces == pytest.approx(ref_ce, rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_published_configs_reach_every_entry_point(arch):
    """The published configs are no longer refused: the serving factories
    take them, and at their published model and frontend widths (one
    layer, a small vocabulary and ffn, to keep the draw small) the
    parameters, ``frontend_proj`` among them, have the JAX package's
    shapes."""
    cfg = get_config(arch)
    make_prefill_step(cfg, attn_impl="cuda", device="cpu")
    make_serve_step(cfg, attn_impl="blockwise", device="cpu")
    cut = dict(num_layers=1, vocab_size=256, d_ff=256)
    params = M.init_params(dataclasses.replace(cfg, **cut), device="cpu")
    shapes = jax.eval_shape(lambda k: JM.init_params(
        dataclasses.replace(j_get_config(arch), **cut), k),
        jax.random.PRNGKey(0))
    assert tuple(params["frontend_proj"].shape) == (
        shapes["frontend_proj"].shape)
    assert M.param_count(params) == sum(
        int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes))
