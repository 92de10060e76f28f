"""The port's flash attention against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode, as tests/test_kernels.py runs it), the JAX oracle
``ref.attention_ref``, and the port's wrapper ``ops.flash_attention``,
which on CPU tensors runs its plain version (``ref.py``).  The CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py and by tests/test_torch_kernels_cuda.py.

Tolerances, as in tests/test_kernels.py: float32 2e-5 (one softmax and
two products summed in another order), bfloat16 2e-2 (the output rounded
to 8 bits of mantissa).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# tests/test_kernels.py's FLASH_CASES:
# (batch, seq, heads, kv_heads, head_dim, causal, window, softcap, dtype)
FLASH_CASES = [
    (2, 256, 4, 2, 64, True, None, None, "float32"),
    (1, 256, 8, 1, 128, True, None, None, "float32"),     # MQA
    (1, 256, 4, 4, 64, True, 128, None, "float32"),       # SWA
    (1, 192, 4, 2, 64, True, None, 50.0, "float32"),      # softcap
    (1, 256, 4, 2, 64, True, 64, 30.0, "float32"),        # SWA+softcap
    (2, 128, 4, 2, 64, False, None, None, "float32"),     # bidirectional
    (1, 200, 4, 2, 64, True, None, None, "float32"),      # padded seq
    (1, 256, 2, 2, 256, True, None, None, "bfloat16"),    # bf16, hd=256
    (1, 128, 4, 2, 32, True, None, None, "bfloat16"),
]


def _inputs(b, sq, skv, nh, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,nh,nkv,hd,causal,win,cap,dtype", FLASH_CASES)
def test_flash_attention_matches_jax_kernel_and_ref(b, s, nh, nkv, hd, causal,
                                                     win, cap, dtype):
    arrays = _inputs(b, s, s, nh, nkv, hd)
    kw = dict(causal=causal, window=win, logit_softcap=cap)
    got = ops.flash_attention(*_torch(arrays, dtype), **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (b, s, nh, hd)
    _close(got, j_ops.flash_attention(*_jax(arrays, dtype), **kw),
           TOL[dtype])
    _close(got, j_ref.attention_ref(*_jax(arrays, dtype), **kw), TOL[dtype])


@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (1, 256, 255, None),     # one decode query against its prefix
    (7, 300, 293, 64),       # a suffix of queries, sliding window
])
def test_flash_attention_q_offset_matches_jax_kernel_and_ref(sq, skv,
                                                             q_offset, window):
    arrays = _inputs(1, sq, skv, 4, 2, 64, seed=1)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.flash_attention(*_torch(arrays, "float32"), **kw)
    _close(got, j_ops.flash_attention(*_jax(arrays, "float32"), **kw), 2e-5)
    _close(got, j_ref.attention_ref(*_jax(arrays, "float32"), **kw), 2e-5)


@pytest.mark.parametrize("causal,q_offset", [
    (False, 0),      # bidirectional over a ragged length
    (True, 110),     # queries past the last key
])
def test_flash_attention_edge_cases_match_jax_ref(causal, q_offset):
    # Held against the JAX oracle only: the JAX wrapper pads k and v with
    # zero rows up to a block multiple and relies on the causal mask to
    # hide them, which neither case gives, so where it pads (s = 100 with
    # blocks of 64 -> 128, off by 0.10 here) its output differs from
    # ref.py.  The port masks columns past the keys itself.
    arrays = _inputs(1, 100, 100, 4, 2, 64, seed=2)
    kw = dict(causal=causal, q_offset=q_offset)
    got = ops.flash_attention(*_torch(arrays, "float32"), **kw)
    _close(got, j_ref.attention_ref(*_jax(arrays, "float32"), **kw), 2e-5)


@pytest.mark.parametrize("window,q_offset", [(2, 40), (6, 16)])
def test_flash_attention_row_without_visible_key_is_zero(window, q_offset):
    # 16 keys; with window 2 and q_offset 40 no row sees a key, with window
    # 6 and q_offset 16 rows 5-7 (positions 21-23) see none.  Held against
    # the JAX oracle only: the JAX kernel gives such rows, in a tile it
    # visits, the mean of that tile's values.
    arrays = _inputs(1, 8, 16, 2, 1, 32, seed=3)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.flash_attention(*_torch(arrays, "float32"), **kw)
    _close(got, j_ref.attention_ref(*_jax(arrays, "float32"), **kw), 2e-5)
    blind = [i for i in range(8) if i + q_offset - window + 1 >= 16]
    assert blind and torch.count_nonzero(got[:, blind]) == 0


def test_cpu_tensors_run_the_plain_version_and_launch_nothing(monkeypatch):
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return ref.attention_ref(*args, **kwargs)

    monkeypatch.setattr(ops, "attention_ref", spy)
    monkeypatch.setitem(ops.LAUNCHES, "flash_attention", 0)
    q, k, v = _torch(_inputs(1, 64, 64, 4, 2, 32), "float32")
    out = ops.flash_attention(q, k, v, window=16, logit_softcap=30.0)
    assert calls == [dict(causal=True, window=16, logit_softcap=30.0,
                          q_offset=0)]
    assert ops.LAUNCHES == {"flash_attention": 0}
    torch.testing.assert_close(
        out, ref.attention_ref(q, k, v, window=16, logit_softcap=30.0),
        atol=0, rtol=0)


@pytest.mark.parametrize("shapes,kw,error", [
    (((1, 8, 3, 32), (1, 8, 2, 32)), {}, ValueError),          # 3 over 2
    (((1, 8, 4, 32), (2, 8, 2, 32)), {}, ValueError),          # batch
    (((1, 8, 4, 32), (1, 8, 2, 16)), {}, ValueError),          # head size
    (((1, 8, 4, 32), (1, 8, 2, 32)), {"window": 0}, ValueError),
    (((1, 8, 4, 32), (1, 8, 2, 32)), {"q_offset": -1}, ValueError),
    (((1, 8, 4, 32), (1, 8, 2, 32)), {"logit_softcap": 0.0}, ValueError),
])
def test_flash_attention_rejects_bad_arguments(shapes, kw, error):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(error):
        ops.flash_attention(q, k, k.clone(), **kw)


def test_flash_attention_rejects_mixed_dtypes():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention(q, k, k)
