"""The port's training substrate against the JAX package's: the token
stream, the optimizers, the chunked LM cross entropy, ``lm_loss`` and
the bilevel ``local_grads``.

``local_grads`` runs at tests/test_distributed.py's size: reduced
smollm-360m, gemma2-2b (both softcaps, local/global attention),
rwkv6-3b (WKV6), mixtral-8x7b (the moe ffn's capacity route and its aux
in the outer loss) and jamba-1.5-large (an attention layer, then a mamba
layer with a moe ffn), vocab 128, 2 layers, float32,
``BilevelHyper(mu_g=0.5, neumann_k=2, lipschitz_g=4.0, ce_chunk=16,
remat=False)``, tokens (4, 32) split 2 / 2, with ``microbatch`` 1 and 2.
The JAX ``init_params`` / ``init_head`` draw the weights and
``lm_params_from_numpy`` carries them over.  p, v and the outer CE must
lie within ``LG_TOL`` = 1e-5 of each leaf's max-abs scale; the largest
gap of each case is printed beside it.

The token stream draws from numpy, not ``jax.random`` (ROADMAP Queue C):
its tests are the JAX package's (deterministic, heterogeneous, within
bounds) plus the chain's statistics against the JAX stream's.  The
optimizers take the same gradients as the JAX ones and must give the
same updates within 1e-7, step after step.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.synthetic import TokenTaskStream as JTokenTaskStream  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.train import bilevel_lm as JB  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data.synthetic import TokenTaskStream  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.train.bilevel_lm import (BilevelHyper,  # noqa: E402
                                          chunked_ce, local_grads,
                                          outer_loss)

LG_TOL = 1e-5
OPT_TOL = 1e-7
ARCHS = ["smollm-360m", "gemma2-2b", "rwkv6-3b", "mixtral-8x7b",
         "jamba-1.5-large-398b"]
HYPER = dict(mu_g=0.5, neumann_k=2, lipschitz_g=4.0, ce_chunk=16,
             remat=False)
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
leaves = torch.utils._pytree.tree_leaves


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_token_stream_deterministic():
    s = TokenTaskStream(vocab_size=512, num_agents=4, seed=3)
    a = s.agent_batch(1, 7, batch=2, seq_len=32, device="cpu")
    b = s.agent_batch(1, 7, batch=2, seq_len=32, device="cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, s.agent_batch(1, 8, 2, 32, device="cpu"))
    assert torch.equal(s.global_batch(7, 2, 32, device="cpu")[1], a)


def test_token_stream_heterogeneous_across_agents():
    s = TokenTaskStream(vocab_size=4096, num_agents=4, seed=3)
    batches = [s.agent_batch(i, 0, 8, 128, device="cpu").numpy()
               for i in range(4)]
    means = [b.mean() for b in batches]
    assert np.std(means) > 10  # distinct vocab bands per agent


def test_token_stream_bounds():
    s = TokenTaskStream(vocab_size=100, num_agents=2, seed=0)
    b = s.global_batch(0, 4, 64, device="cpu")
    assert tuple(b.shape) == (2, 4, 64) and b.dtype == torch.int64
    assert int(b.min()) >= 0 and int(b.max()) < 100


def _chain_stats(batches, vocab: int, sub: int):
    """Repeat rate and the band's width (mod vocab) over agents' batches."""
    repeats, widths = [], []
    for b in batches:
        repeats.append(float(np.mean(b[:, 1:] == b[:, :-1])))
        lo = b.min()
        widths.append(int(((b - lo) % vocab).max()) + 1)
    return float(np.mean(repeats)), max(widths)


def test_token_stream_statistics_match_jax():
    vocab, m = 1000, 4
    s, js = TokenTaskStream(vocab, m, seed=5), JTokenTaskStream(vocab, m,
                                                                 seed=5)
    sub = s.band_size
    ours = [s.agent_tokens(i, 0, 32, 128) for i in range(m)]
    theirs = [np.asarray(js.agent_batch(i, 0, 32, 128)) for i in range(m)]
    rep, width = _chain_stats(ours, vocab, sub)
    jrep, jwidth = _chain_stats(theirs, vocab, sub)
    expected = s.stickiness + (1 - s.stickiness) / sub
    assert abs(rep - expected) < 0.02 and abs(jrep - expected) < 0.02
    assert width <= sub and jwidth <= sub


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.1),
    "momentum": lambda o: o.momentum(0.05),
    "nesterov": lambda o: o.momentum(0.05, nesterov=True),
    "adam": lambda o: o.adam(0.1),
    "adamw": lambda o: o.adamw(0.1, weight_decay=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    jopt, opt = OPTIMIZERS[name](JO), OPTIMIZERS[name](O)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = torch.utils._pytree.tree_map(torch.tensor, params)
    jstate, state = jopt.init(jp), opt.init(tp)
    gap = 0.0
    for _ in range(6):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        jupd, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        upd, state = opt.update(
            torch.utils._pytree.tree_map(torch.tensor, grads), state, tp)
        for key in params:
            gap = max(gap, float(np.max(np.abs(upd[key].numpy()
                                               - np.asarray(jupd[key])))))
        jp = jax.tree_util.tree_map(jnp.add, jp, jupd)
        tp = torch.utils._pytree.tree_map(torch.add, tp, upd)
    print(f"{name}: largest update gap {gap:.2e} (bound {OPT_TOL})")
    assert gap < OPT_TOL


def _quad_min(opt, steps=300):
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    state = opt.init(params)
    loss = lambda p: torch.sum(p["w"] ** 2) + p["b"] ** 2
    for _ in range(steps):
        g = torch.func.grad(loss)(params)
        upd, state = opt.update(g, state, params)
        params = torch.utils._pytree.tree_map(torch.add, params, upd)
    return float(loss(params))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_minimize_quadratic(name):
    opt = (O.adamw(0.1, weight_decay=0.0) if name == "adamw"
           else OPTIMIZERS[name](O))
    assert _quad_min(opt) < 1e-3


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 10.0)}
    clipped, norm = O.clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(20.0)
    total = torch.sqrt(sum(torch.sum(l ** 2) for l in leaves(clipped)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)
    small, _ = O.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))


def test_schedules():
    cos = O.cosine_schedule(1.0, 100)
    assert float(cos(0)) == pytest.approx(1.0)
    assert float(cos(100)) == pytest.approx(0.1)
    jcos = JO.cosine_schedule(1.0, 100)
    for step in (0, 13, 50, 99, 150):
        assert float(cos(step)) == pytest.approx(float(jcos(step)), abs=1e-7)
    wu = O.warmup_linear(2.0, 10)
    assert float(wu(0)) == pytest.approx(0.2)
    assert float(wu(9)) == pytest.approx(2.0)
    assert float(wu(30)) == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# the bilevel LM problem
# ---------------------------------------------------------------------------

def _configs(arch):
    kw = dict(vocab_size=128, num_layers=2, dtype="float32")
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = _configs(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), with_head=False)
    jhead = JM.init_head(jcfg, jax.random.PRNGKey(1))
    jtokens = jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0,
                                 jcfg.vocab_size)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jhead=jhead,
                jtokens=jtokens,
                params=lm_params_from_numpy(np_tree(jparams), cfg, "cpu"),
                head=torch.tensor(np.asarray(jhead)),
                tokens=torch.tensor(np.asarray(jtokens), dtype=torch.int64))


@pytest.fixture(scope="module", params=ARCHS)
def lm_setup(request):
    return _setup(request.param)


def _gap(got, want) -> float:
    """Largest gap over leaves, relative to each leaf's max-abs scale."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(leaves(got), leaves(want)))


@pytest.mark.parametrize("microbatch", [1, 2])
def test_local_grads_match_jax(lm_setup, microbatch):
    s = lm_setup
    kw = dict(HYPER, microbatch=microbatch)
    jp, jv, jce = jax.jit(lambda x, y, a, b: JB.local_grads(
        s["jcfg"], JB.BilevelHyper(**kw), x, y, a, b))(
        s["jparams"], s["jhead"], s["jtokens"][:2], s["jtokens"][2:])
    p, v, ce = local_grads(s["cfg"], BilevelHyper(**kw), s["params"],
                           s["head"], s["tokens"][:2], s["tokens"][2:])
    want_p = lm_params_from_numpy(np_tree(jp), s["cfg"], "cpu")
    gaps = {"p": _gap(p, want_p),
            "v": _gap(v, torch.tensor(np.asarray(jv))),
            "outer_ce": abs(float(ce) - float(jce)) / abs(float(jce))}
    print(f"{s['cfg'].name} microbatch {microbatch}: largest gaps {gaps} "
          f"(bound {LG_TOL})")
    assert max(gaps.values()) < LG_TOL, gaps


def test_remat_changes_nothing():
    s = _setup("smollm-360m")
    out = [local_grads(s["cfg"], BilevelHyper(**dict(HYPER, remat=remat)),
                       s["params"], s["head"], s["tokens"][:2],
                       s["tokens"][2:]) for remat in (False, True)]
    for a, b in zip(leaves(out[0]), leaves(out[1])):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_hypergradient_reduces_to_plain_grad_when_decoupled():
    """With mu -> infinity the inner solution ~0 is x-independent, so the
    correction term vanishes and p == grad_x f."""
    s = _setup("smollm-360m")
    hyper = BilevelHyper(mu_g=1e6, neumann_k=8, lipschitz_g=1e6 * 1.5,
                         ce_chunk=16, remat=False)
    zero = torch.zeros_like(s["head"])
    p, _, _ = local_grads(s["cfg"], hyper, s["params"], zero,
                          s["tokens"][:2], s["tokens"][2:])
    gx = torch.func.grad(lambda x: outer_loss(
        s["cfg"], hyper, x, zero, s["tokens"][2:]))(s["params"])
    for a, b in zip(leaves(p), leaves(gx)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_chunked_ce_matches_dense_and_jax(lm_setup):
    s = lm_setup
    feats, _ = M.features(s["cfg"], s["params"], s["tokens"])
    ce = chunked_ce(s["cfg"], s["head"], feats, s["tokens"], chunk=7)
    logits = M.head_logits(s["cfg"], s["head"], feats)
    assert float(ce) == pytest.approx(
        float(M.lm_loss(s["cfg"], logits, s["tokens"])), rel=1e-5)
    jfeats, _ = JM.features(s["jcfg"], s["jparams"], s["jtokens"],
                            remat=False)
    jce = JB.chunked_ce(s["jcfg"], s["jhead"], jfeats, s["jtokens"], chunk=7)
    assert float(ce) == pytest.approx(float(jce), rel=1e-5)
    vals = [float(chunked_ce(s["cfg"], s["head"], feats, s["tokens"],
                             chunk=c)) for c in (1, 8, 31, 124)]
    np.testing.assert_allclose(vals, vals[0], rtol=1e-5)


def test_lm_loss_matches_jax():
    jcfg, cfg = _configs("gemma2-2b")
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 128)).astype(np.float32)
    labels = rng.integers(0, 128, (2, 6))      # a 3-position prefix
    aux = np.float32(0.7)
    for a in (None, aux):
        want = JM.lm_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels),
                          None if a is None else jnp.asarray(a))
        got = M.lm_loss(cfg, torch.tensor(logits), torch.tensor(labels),
                        None if a is None else torch.tensor(a))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
