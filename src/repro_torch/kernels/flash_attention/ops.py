"""Wrapper of the flash attention kernel: checks, dispatch, launch count.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.
Dispatch is on the inputs' device and on nothing else: a CPU tensor goes
to the plain version in ``ref.py``, a CUDA tensor launches the kernel of
``csrc/flash_attention.cu`` or raises.  The kernel masks key columns past
the sequence itself, so nothing is padded (the JAX wrapper pads k and v
with zero rows, which a non-causal call or a ``q_offset`` past the keys
then attends to; this wrapper follows ``ref.py`` in those cases too).
``LAUNCHES`` counts kernel launches, one per launch, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "SOURCE", "flash_attention", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# Head sizes the kernel is instantiated for (the repo's configs use 64,
# 128 and 256; the reduced ones 32).
HEAD_DIMS = (32, 64, 128, 256)

LAUNCHES = {"flash_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel, with a typed launcher."""
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = (
        [ptr] * 4 + [i32] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        + [i32, i32, ctypes.c_float, i32, i32, ptr])
    lib.repro_flash_attention.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    skv, nkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} is not one of {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous along the head size")
    out = torch.empty((b, sq, nh, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                       for s in t.stride()[:3]))
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, nh, nkv, hd, strides, int(causal),
            0 if window is None else int(window),
            0.0 if logit_softcap is None else float(logit_softcap),
            int(q_offset), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    LAUNCHES["flash_attention"] += 1
    return out
