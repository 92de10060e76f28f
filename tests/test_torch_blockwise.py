"""The port's ``attention_blockwise`` against the JAX package's.

The streaming-softmax attention over kv blocks (the JAX package's
XLA-side path, plain PyTorch in the port) at the four (window, softcap)
cases of tests/test_perf_variants.py, at kv blocks of 16, 32 and 64
over a length of 100 (a multiple of none: the last block is padded with
keys the causal mask hides), on the same numpy inputs: the outputs
within 2e-5, and the gradients with respect to q, k and v of one fixed
random cotangent within 1e-4 of ``jax.grad`` of the JAX function.  The
route through ``attention(impl="blockwise")`` is held at model level by
tests/test_torch_frontends.py; an rwkv model, which has no attention,
runs its plain WKV6 under that impl.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
CASES = [(None, None), (64, None), (None, 30.0), (64, 50.0)]
B, S, NH, NKV, HD = 2, 100, 4, 2, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, NH, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, NKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, NKV, HD)).astype(np.float32)
    cot = rng.standard_normal((B, S, NH, HD)).astype(np.float32)
    return q, k, v, cot


@pytest.mark.parametrize("block_k", [16, 32, 64])
@pytest.mark.parametrize("win,cap", CASES)
def test_blockwise_matches_jax(win, cap, block_k):
    q, k, v, _ = _inputs(0)
    pos = np.arange(S)
    want = JL.attention_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos, jnp.int32), jnp.asarray(pos, jnp.int32), win, cap,
        block_k=block_k)
    got = L.attention_blockwise(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(pos), torch.tensor(pos), win, cap, block_k=block_k)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)
    # and the port's own plain attention
    ref = L.attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(pos), torch.tensor(pos), win, cap)
    torch.testing.assert_close(got, ref, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("win,cap", [(None, None), (64, 50.0)])
def test_blockwise_gradients_match_jax(win, cap):
    q, k, v, cot = _inputs(1)
    pos = np.arange(S)

    def jloss(q_, k_, v_):
        out = JL.attention_blockwise(q_, k_, v_, jnp.asarray(pos, jnp.int32),
                                     jnp.asarray(pos, jnp.int32), win, cap,
                                     block_k=32)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = L.attention_blockwise(qt, kt, vt, torch.tensor(pos),
                                torch.tensor(pos), win, cap, block_k=32)
    got = torch.autograd.grad(torch.sum(out * torch.tensor(cot)),
                              (qt, kt, vt))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_rwkv_runs_its_plain_recurrence_under_blockwise():
    cfg = get_config("rwkv6-3b").reduced(num_layers=2)
    params = M.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = M.features(cfg, params, tokens, impl="blockwise")
        want, _ = M.features(cfg, params, tokens, impl="reference")
    assert torch.equal(got, want)
