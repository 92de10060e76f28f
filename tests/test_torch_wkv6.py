"""The port's WKV6 recurrence against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode, as tests/test_kernels.py runs it, with its closed-form
fold of an incoming state), the JAX oracle ``ref.wkv6_ref``, and the
port's wrapper ``ops.wkv6``, which on CPU tensors runs its plain version
(``ref.py``).  The CUDA kernel starts from the incoming state instead of
folding it in afterwards; it is held against the plain version on the
card by chip_smoke.py and by tests/test_torch_kernels_cuda.py.

Tolerances, as in tests/test_kernels.py: float32 2e-3 (the chunked JAX
kernel sums the recurrence in another order, through log-space decay
products), bfloat16 5e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6 import ops as j_ops  # noqa: E402
from repro.kernels.rwkv6 import ref as j_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops, ref  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 5e-2}

# tests/test_kernels.py's WKV_CASES:
# (batch, seq, heads, N, chunk of the JAX kernel, with_state, dtype)
WKV_CASES = [
    (2, 128, 2, 16, 32, False, "float32"),
    (1, 96, 4, 32, 32, False, "float32"),
    (2, 64, 2, 16, 16, True, "float32"),
    (1, 100, 2, 16, 32, False, "float32"),   # padding
    (1, 1, 2, 16, 32, True, "float32"),      # decode-like
    (1, 128, 2, 64, 64, False, "float32"),   # full head size
    (1, 64, 2, 16, 32, False, "bfloat16"),
]


def _inputs(b, s, h, n, seed=0, with_state=False):
    """r, k, v, w, u (and state) drawn as tests/test_kernels.py draws
    them, with numpy."""
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, k, v = normal(b, s, h, n), normal(b, s, h, n), normal(b, s, h, n)
    w = (1.0 / (1.0 + np.exp(-(normal(b, s, h, n) * 2.0 - 1.0))) * 0.6
         + 0.35).astype(np.float32)
    u = (0.3 * normal(h, n)).astype(np.float32)
    state = (0.5 * normal(b, h, n, n)) if with_state else None
    return [r, k, v, w, u], state


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,n,chunk,with_state,dtype", WKV_CASES)
def test_wkv6_matches_jax_kernel_and_ref(b, s, h, n, chunk, with_state,
                                         dtype):
    arrays, state = _inputs(b, s, h, n, with_state=with_state)
    t_state = None if state is None else torch.tensor(state)
    j_state = None if state is None else jnp.asarray(state)
    out, final = ops.wkv6(*_torch(arrays, dtype), state=t_state)
    assert out.dtype == getattr(torch, dtype)
    assert final.dtype == torch.float32
    assert tuple(final.shape) == (b, h, n, n)
    want, want_final = j_ops.wkv6(*_jax(arrays, dtype), state=j_state,
                                  chunk=chunk)
    _close(out, want, TOL[dtype])
    _close(final, want_final, TOL[dtype])
    want, want_final = j_ref.wkv6_ref(*_jax(arrays, dtype), state=j_state)
    _close(out, want, TOL[dtype])
    _close(final, want_final, TOL[dtype])


def test_wkv6_chained_halves_equal_one_call():
    """Two halves with the state carried equal one call (the prefill
    chunking invariant of tests/test_kernels.py), and match JAX."""
    arrays, _ = _inputs(1, 128, 2, 16, seed=6)
    r, k, v, w, u = _torch(arrays, "float32")
    full, s_full = ops.wkv6(r, k, v, w, u)
    h1, s1 = ops.wkv6(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u)
    h2, s2 = ops.wkv6(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u,
                      state=s1)
    torch.testing.assert_close(torch.cat([h1, h2], dim=1), full, atol=2e-4,
                               rtol=2e-4)
    torch.testing.assert_close(s2, s_full, atol=2e-4, rtol=2e-4)
    want, want_final = j_ops.wkv6(*_jax(arrays, "float32"))
    _close(full, want, 2e-3)
    _close(s_full, want_final, 2e-3)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(len(args))
        return ref.wkv6_ref(*args)

    monkeypatch.setattr(ops, "wkv6_ref", spy)
    monkeypatch.setitem(ops.LAUNCHES, "wkv6", 0)
    arrays, state = _inputs(1, 16, 2, 16, with_state=True)
    tensors = _torch(arrays, "float32")
    out, final = ops.wkv6(*tensors, state=torch.tensor(state))
    assert calls == [6]
    assert ops.LAUNCHES == {"wkv6": 0}
    want, want_final = ref.wkv6_ref(*tensors, torch.tensor(state))
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    torch.testing.assert_close(final, want_final, atol=0, rtol=0)


@pytest.mark.parametrize("what", ["shape", "u", "state", "state_dtype",
                                  "dtype"])
def test_wkv6_rejects_bad_arguments(what):
    arrays, state = _inputs(1, 8, 2, 16, with_state=True)
    r, k, v, w, u = _torch(arrays, "float32")
    state = torch.tensor(state)
    if what == "shape":
        k = k[:, :4]
    elif what == "u":
        u = u[:1]
    elif what == "state":
        state = state[:, :1]
    elif what == "state_dtype":
        state = state.double()
    else:
        w = w.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        ops.wkv6(r, k, v, w, u, state=state)


def _strong_decay_inputs(b, s, h, n, seed, with_state):
    """``_inputs`` with a quarter of w each exactly 0, in (0, 1e-4) and in
    (0.999, 1): decays that forget at once, nearly at once, and hardly."""
    arrays, state = _inputs(b, s, h, n, seed=seed, with_state=with_state)
    rng = np.random.default_rng(seed + 100)
    w = arrays[3]
    pick = rng.integers(0, 4, w.shape)
    w = np.where(pick == 0, 0.0, w)
    w = np.where(pick == 1, rng.uniform(0.0, 1e-4, w.shape), w)
    w = np.where(pick == 2, rng.uniform(0.999, 1.0, w.shape), w)
    arrays[3] = w.astype(np.float32)
    return arrays, state


# (batch, seq, heads, N, chunk of the JAX kernel, with_state, dtype):
# every head size, lengths that are not a multiple of the CUDA kernel's
# 16-token chunk
STRONG_CASES = [
    (1, 37, 2, 8, 16, False, "float32"),
    (2, 37, 2, 16, 16, True, "float32"),
    (1, 45, 2, 32, 16, False, "float32"),
    (1, 37, 2, 64, 16, True, "float32"),
    (1, 37, 2, 16, 16, False, "bfloat16"),
    (1, 37, 2, 64, 16, True, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,n,chunk,with_state,dtype", STRONG_CASES)
def test_wkv6_strong_decay_matches_jax_kernel_and_ref(b, s, h, n, chunk,
                                                      with_state, dtype):
    """w exactly 0, below 1e-4 and above 0.999: the port's plain version
    agrees with the JAX oracle ref.py on the draw, and with the JAX kernel
    on the draw with its zeros lifted to 1e-30.  The JAX kernel cannot
    take w = 0: it clamps w at 1e-38, a subnormal that XLA flushes to 0,
    so its log is -inf and its output NaN (ROADMAP, Queue C)."""
    arrays, state = _strong_decay_inputs(b, s, h, n, seed=9,
                                         with_state=with_state)
    w = arrays[3]
    assert (w == 0).any() and (w > 0.999).any() and ((w > 0) & (w < 1e-4)).any()
    t_state = None if state is None else torch.tensor(state)
    j_state = None if state is None else jnp.asarray(state)
    out, final = ops.wkv6(*_torch(arrays, dtype), state=t_state)
    assert torch.isfinite(out.float()).all() and torch.isfinite(final).all()
    want, want_final = j_ref.wkv6_ref(*_jax(arrays, dtype), state=j_state)
    _close(out, want, TOL[dtype])
    _close(final, want_final, TOL[dtype])
    arrays[3] = np.where(w == 0, np.float32(1e-30), w)
    out, final = ops.wkv6(*_torch(arrays, dtype), state=t_state)
    want, want_final = j_ops.wkv6(*_jax(arrays, dtype), state=j_state,
                                  chunk=chunk)
    _close(out, want, TOL[dtype])
    _close(final, want_final, TOL[dtype])


def test_wkv6_zero_decay_forgets_the_state_exactly():
    """w = 0 at a token: the state after it is k v^T of that token alone,
    exactly (the CUDA kernel computes w S + kv as one FMA, 0 * S + kv)."""
    arrays, state = _inputs(1, 3, 2, 16, seed=4, with_state=True)
    r, k, v, w, u = _torch(arrays, "float32")
    w[:, -1] = 0.0
    _, final = ops.wkv6(r, k, v, w, u, state=torch.tensor(state))
    kv = k[:, -1, :, :, None] * v[:, -1, :, None, :]
    torch.testing.assert_close(final, kv, atol=0, rtol=0)


def test_aligned16_copies_only_a_misaligned_view():
    base = torch.arange(65, dtype=torch.float32)
    aligned = base[:64].view(4, 16)
    assert ops.aligned16(aligned) is aligned
    view = base[1:].view(4, 16)               # 4 bytes into its storage
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    copy = ops.aligned16(view)
    assert copy is not view and copy.data_ptr() % 16 == 0
    torch.testing.assert_close(copy, view, atol=0, rtol=0)
    bf = torch.zeros(72, dtype=torch.bfloat16)[8:].view(4, 16)  # 16 bytes in
    assert ops.aligned16(bf) is bf
