"""Wrapper of the flash attention kernels: checks, dispatch, launch counts.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.
Dispatch is on the inputs' device and dtype and on nothing else: a CPU
tensor goes to the plain version in ``ref.py``; a CUDA tensor launches a
kernel of ``csrc/flash_attention.cu`` or raises: float32 the exact FMA
kernel, bfloat16 the tensor-core (wgmma) kernel, which also needs 16-byte
aligned pointers and (batch, seq, head) strides.  The kernels mask key
columns past the sequence themselves, so nothing is padded (the JAX
wrapper pads k and v with zero rows, which a non-causal call or a
``q_offset`` past the keys then attends to; this wrapper follows
``ref.py`` in those cases too).  ``LAUNCHES["flash_attention"]`` counts
the launches of both kernels, ``LAUNCHES["flash_attention_tc"]`` those of
the tensor-core kernel; each adds one per launch and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "SOURCE", "TC_ROW_RTOL",
           "check_tc_alignment", "flash_attention", "launch", "load",
           "row_errors"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# Head sizes the kernel is instantiated for (the repo's configs use 64,
# 128 and 256; the reduced ones 32).
HEAD_DIMS = (32, 64, 128, 256)

LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}

# What the bfloat16 kernel is held to (chip_smoke.py,
# tests/test_torch_kernels_cuda.py; tests/test_torch_flash_attention.py
# sizes it against an emulation of the kernel's rounding): every row's
# ``row_errors`` against the plain version in float32 on the same bf16
# inputs at most TC_ROW_RTOL.
TC_ROW_RTOL = 1e-2

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def load(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (at first use) and load the kernels, with typed launchers;
    ``defines`` (``NAME=VALUE``) build a variant of the source."""
    lib = load_library(SOURCE, defines)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.repro_flash_attention, lib.repro_flash_attention_tc):
        fn.argtypes = ([ptr] * 4 + [i32] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [i32, i32, ctypes.c_float, i32, ptr])
        fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per (batch, query, head) row, ||got - want||_2 / ||want||_2 over
    the head size; a row where ``want`` is 0 (it sees no key) gives 0 if
    ``got`` is exactly 0 there and inf otherwise."""
    want = want.float()
    diff = (got.float() - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    blind = torch.where((got != 0).any(dim=-1), torch.inf, 0.0)
    return torch.where(norm > 0, diff / norm, blind)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, logit_softcap: float | None,
           q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            "q must be (b, sq, nh, hd) and k, v one (b, skv, nkv, hd) shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, nh, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head size")
    if k.shape[2] == 0 or nh % k.shape[2]:
        raise ValueError(f"{nh} query heads do not group over "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must be on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be positive, got "
                         f"{logit_softcap}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def check_tc_alignment(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> None:
    """Raise unless the tensor-core kernel can read q, k and v: it loads
    16-byte pieces, so every data pointer and every (batch, seq, head)
    stride of an axis longer than 1 must be a multiple of 16 bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data pointer is not 16-byte aligned; "
                             "the bfloat16 kernel loads 16 bytes at a time")
        bad = [ax for ax in range(3)
               if t.shape[ax] > 1 and (t.stride(ax) * size) % 16]
        if bad:
            raise ValueError(
                f"{name}'s strides {t.stride()[:3]} (elements) on axes {bad} "
                "are not multiples of 16 bytes; the bfloat16 kernel loads 16 "
                "bytes at a time")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    logit_softcap: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Exact softmax GQA attention; q (b, sq, nh, hd), k and v
    (b, skv, nkv, hd) -> (b, sq, nh, hd) in q's dtype.  Query row i sits
    at position ``i + q_offset``; a row with no visible key gives zeros."""
    _check(q, k, v, window, logit_softcap, q_offset)
    kwargs = dict(causal=causal, window=window, logit_softcap=logit_softcap,
                  q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kwargs)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    b, sq, nh, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} is not one of {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous along the head size")
    tc = q.dtype == torch.bfloat16
    if tc:
        check_tc_alignment(q, k, v)
    out = torch.empty((b, sq, nh, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if k.shape[1] == 0:
        return out.zero_()
    launch(load(), q, k, v, out, **kwargs)
    LAUNCHES["flash_attention"] += 1
    if tc:
        LAUNCHES["flash_attention_tc"] += 1
    return out


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, out: torch.Tensor, *, causal: bool,
           window: int | None, logit_softcap: float | None,
           q_offset: int) -> None:
    """Launch ``lib``'s kernel for q's dtype on arguments that
    ``flash_attention`` has checked, into ``out``; counts nothing."""
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    tc = q.dtype == torch.bfloat16
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                       for s in t.stride()[:3]))
    fn = lib.repro_flash_attention_tc if tc else lib.repro_flash_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 sq, skv, nh, nkv, hd, strides, int(causal),
                 0 if window is None else int(window),
                 0.0 if logit_softcap is None else float(logit_softcap),
                 int(q_offset), stream)
    if err != 0:
        name = "flash_attention_tc" if tc else "flash_attention"
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
