"""The port's LM serving path against the JAX package's.

Reduced gemma2-2b (local/global attention, GQA, both softcaps),
rwkv6-3b (WKV6 time mixing, token-shift channel mixing), llama3.2-3b,
qwen3-14b (q/k RMSNorm), smollm-360m (the training driver's default),
mixtral-8x7b (moe ffn, sliding window), jamba-1.5-large (attention and
mamba layers, moe every other layer) and dbrx-132b (moe), four layers
each, in float32.  The
JAX ``init_params`` draws the weights; ``lm_params_from_numpy`` carries
them into the port, and the same numpy tokens go through both packages.
On CPU tensors the port's ``impl="cuda"`` runs the kernels' plain
versions, so every impl is checked here; the kernels themselves are held
against those versions on the card by chip_smoke.py.

Tolerance 1e-4 on the logits (measured gaps are a few 1e-6 at these
sizes: float32 rounding through four layers and a head).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.serving import make_prefill_step as j_prefill_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serving import (make_prefill_step,  # noqa: E402
                                        make_serve_step)
from repro_torch.models import model as M  # noqa: E402

ARCHS = ["gemma2-2b", "rwkv6-3b", "llama3.2-3b", "qwen3-14b",
         "smollm-360m", "mixtral-8x7b", "jamba-1.5-large-398b", "dbrx-132b"]
TOL = 1e-4
BATCH, PROMPT, DECODE = 2, 72, 4   # 72 > the reduced 64-token window


def _configs(arch):
    # four layers: two periods of gemma2's local/global pair, so the
    # period-stacked JAX parameters must unstack in layer order
    kw = dict(num_prefix_tokens=0, frontend="none", num_layers=4)
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, cfg = _configs(request.param)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), with_head=True)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  cfg, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + DECODE))
    return jcfg, cfg, jparams, params, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_configs_match_the_jax_registry():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS + ("interact-meta-mlp",):
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(j_get_config(arch)))
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_params_carry_over_per_layer(setup):
    jcfg, cfg, jparams, params, _ = setup
    assert len(params["layers"]) == cfg.num_layers
    assert M.param_count(params) == JM.param_count(jparams)
    pattern = len(cfg.layer_pattern())
    last = cfg.num_layers - 1
    jlast = jax.tree_util.tree_map(lambda a: np.asarray(a)[last // pattern],
                                   jparams["layers"][last % pattern])
    flat, _ = jax.tree_util.tree_flatten_with_path(jlast)
    for path, want in flat:
        got = params["layers"][last]
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_features_and_forward_match_jax(setup, impl):
    jcfg, cfg, jparams, params, tokens = setup
    feats, aux = M.features(cfg, params, torch.tensor(tokens), impl=impl)
    jfeats, jaux = JM.features(jcfg, jparams, jnp.asarray(tokens))
    _close(feats, jfeats)
    _close(aux, jaux)     # the moe ffns' aux loss; zero without one
    assert (float(aux) == 0.0) == (cfg.num_experts == 0)
    logits, _ = M.forward(cfg, params, torch.tensor(tokens), impl=impl)
    jlogits, _ = JM.forward(jcfg, jparams, jnp.asarray(tokens))
    assert tuple(logits.shape) == (BATCH, PROMPT + DECODE, cfg.vocab_size)
    _close(logits, jlogits)


def test_prefill_step_matches_jax(setup):
    jcfg, cfg, jparams, params, tokens = setup
    got = make_prefill_step(cfg, attn_impl="cuda", device="cpu")(
        params, torch.tensor(tokens))
    want = j_prefill_step(jcfg)(jparams, jnp.asarray(tokens))
    assert tuple(got.shape) == (BATCH, cfg.vocab_size)
    _close(got, want)


def test_prefill_then_decode_matches_jax(setup):
    jcfg, cfg, jparams, params, tokens = setup
    size = PROMPT + DECODE
    jcache = JM.init_cache(jcfg, BATCH, size)
    jlogits, jcache = JM.prefill(jcfg, jparams, jparams["head"],
                                 jnp.asarray(tokens[:, :PROMPT]), jcache)
    cache = M.init_cache(cfg, BATCH, size, device="cpu")
    logits, cache = M.prefill(cfg, params, params["head"],
                              torch.tensor(tokens[:, :PROMPT]), cache)
    _close(logits, jlogits)
    step = make_serve_step(cfg, device="cpu")
    for t in range(PROMPT, size):
        tok = tokens[:, t:t + 1]
        jl, jcache = JM.decode_step(jcfg, jparams, jparams["head"],
                                    jnp.asarray(tok), jcache,
                                    jnp.asarray(t, jnp.int32))
        logits, cache = step(params, torch.tensor(tok), cache, t)
        _close(logits, jl[:, 0])


@pytest.mark.parametrize("arch,prompt", [
    ("gemma2-2b", 12), ("gemma2-2b", 72), ("rwkv6-3b", 12),
    ("mixtral-8x7b", 72), ("jamba-1.5-large-398b", 12),
])
def test_prefill_matches_stepwise_decode(arch, prompt):
    """The port's own counterpart of tests/test_prefill_cache.py: a prefill
    leaves the caches as token-by-token decoding does (gemma2's local
    layers and mixtral's wrap their 64-slot ring at prompt 72; jamba's
    mamba layers carry h and the conv tail)."""
    _, cfg = _configs(arch)
    params = M.init_params(cfg, seed=3, with_head=True, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, prompt + DECODE),
                           generator=torch.Generator().manual_seed(4))
    size = prompt + DECODE
    cache_a = M.init_cache(cfg, BATCH, size, device="cpu")
    logits, cache_a = M.prefill(cfg, params, params["head"],
                                tokens[:, :prompt], cache_a)
    outs_a = [logits]
    for t in range(prompt, size):
        lg, cache_a = M.decode_step(cfg, params, params["head"],
                                    tokens[:, t:t + 1], cache_a, t)
        outs_a.append(lg[:, 0])
    cache_b = M.init_cache(cfg, BATCH, size, device="cpu")
    outs_b = []
    for t in range(size):
        lg, cache_b = M.decode_step(cfg, params, params["head"],
                                    tokens[:, t:t + 1], cache_b, t)
        outs_b.append(lg[:, 0])
    for a, b in zip(outs_a, outs_b[prompt - 1:]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    # and the kernel route's prefill of every token gives the last one.
    # The kernel prefill routes a moe ffn by capacity, the cached path
    # exactly; at a capacity factor of num_experts / top_k each expert
    # has a slot for every token, nothing drops, and the two routes
    # compute the same function
    if cfg.num_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    last = make_prefill_step(cfg, attn_impl="cuda", device="cpu")(
        params, tokens)
    torch.testing.assert_close(last, outs_b[-1], atol=1e-3, rtol=1e-3)


def test_unknown_impl_raises(setup):
    _, cfg, _, params, tokens = setup
    with pytest.raises(ValueError, match="unknown"):
        M.features(cfg, params, torch.tensor(tokens), impl="pallas")
    with pytest.raises(ValueError, match="unknown"):
        make_serve_step(cfg, attn_impl="pallas", device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(reduced) on cpu" in out
    assert "decoded 4 x 2" in out
