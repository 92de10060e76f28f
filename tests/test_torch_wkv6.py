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
