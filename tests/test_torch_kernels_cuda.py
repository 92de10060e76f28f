"""The port's flash attention and WKV6 kernels against their plain
versions, on the card.

Every test here needs an NVIDIA Hopper card and skips elsewhere.  The
file imports neither JAX nor the JAX package, so it runs on a machine
with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py imports JAX).  The cases are the JAX
package's kernel test cases (tests/test_kernels.py), with the same
tolerances: flash attention float32 2e-5, bfloat16 2e-2; WKV6 float32
2e-3, bfloat16 5e-2.  chip_smoke.py runs these and the serving shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WKV_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}

# (batch, seq, heads, kv_heads, head_dim, causal, window, softcap, dtype)
FLASH_CASES = [
    (2, 256, 4, 2, 64, True, None, None, torch.float32),
    (1, 256, 8, 1, 128, True, None, None, torch.float32),     # MQA
    (1, 256, 4, 4, 64, True, 128, None, torch.float32),       # SWA
    (1, 192, 4, 2, 64, True, None, 50.0, torch.float32),      # softcap
    (1, 256, 4, 2, 64, True, 64, 30.0, torch.float32),        # SWA+softcap
    (2, 128, 4, 2, 64, False, None, None, torch.float32),     # bidirectional
    (1, 200, 4, 2, 64, True, None, None, torch.float32),      # ragged
    (1, 256, 2, 2, 256, True, None, None, torch.bfloat16),    # bf16, hd=256
    (1, 128, 4, 2, 32, True, None, None, torch.bfloat16),
]

# (batch, seq, heads, N, with_state, dtype)
WKV_CASES = [
    (2, 128, 2, 16, False, torch.float32),
    (1, 96, 4, 32, False, torch.float32),
    (2, 64, 2, 16, True, torch.float32),
    (1, 100, 2, 16, False, torch.float32),
    (1, 1, 2, 16, True, torch.float32),
    (1, 128, 2, 64, False, torch.float32),
    (1, 64, 2, 16, False, torch.bfloat16),
]


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels only run on the "
                    "card (chip_smoke.py runs these cases there)")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,nkv,hd,causal,win,cap,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_version(hopper, b, s, nh, nkv, hd,
                                            causal, win, cap, dtype):
    gen = torch.Generator(device=hopper).manual_seed(0)
    q = torch.randn(b, s, nh, hd, generator=gen, device=hopper).to(dtype)
    k = torch.randn(b, s, nkv, hd, generator=gen, device=hopper).to(dtype)
    v = torch.randn(b, s, nkv, hd, generator=gen, device=hopper).to(dtype)
    kw = dict(causal=causal, window=win, logit_softcap=cap)
    before = fa_ops.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(
        got.float(), fa_ref.attention_ref(q, k, v, **kw).float(),
        atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,n,with_state,dtype", WKV_CASES)
def test_wkv6_kernel_matches_plain_version(hopper, b, s, h, n, with_state,
                                           dtype):
    gen = torch.Generator(device=hopper).manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=hopper)
    r, k, v = (randn(b, s, h, n).to(dtype) for _ in range(3))
    w = (torch.sigmoid(randn(b, s, h, n) * 2.0 - 1.0) * 0.6 + 0.35).to(dtype)
    u = (0.3 * randn(h, n)).to(dtype)
    state = 0.5 * randn(b, h, n, n) if with_state else None
    before = wkv_ops.LAUNCHES["wkv6"]
    out, final = wkv_ops.wkv6(r, k, v, w, u, state)
    assert wkv_ops.LAUNCHES["wkv6"] == before + 1
    want, want_final = wkv_ref.wkv6_ref(r, k, v, w, u, state)
    tol = WKV_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(final, want_final, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernels_reject_cpu_and_cuda_mixes(hopper):
    q = torch.zeros(1, 8, 4, 32, device=hopper)
    with pytest.raises(ValueError, match="one device"):
        fa_ops.flash_attention(q, q[:, :, :2].cpu(), q[:, :, :2].cpu())
    r = torch.zeros(1, 8, 2, 16, device=hopper)
    with pytest.raises(ValueError, match="one device"):
        wkv_ops.wkv6(r, r, r, r, torch.zeros(2, 16))
