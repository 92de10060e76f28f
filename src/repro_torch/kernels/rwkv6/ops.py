"""Wrapper of the WKV6 kernel: checks, dispatch, launch count.

Counterpart of ``repro.kernels.rwkv6.ops.wkv6``.  Dispatch is on the
inputs' device and on nothing else: a CPU tensor goes to the plain
version in ``ref.py``, a CUDA tensor launches the kernel of
``csrc/wkv6.cu`` or raises.  The JAX wrapper runs its kernel from a zero
state and folds an incoming state in afterwards, in closed form; the
kernel here starts from the incoming state, which is the same function,
so there is no fold and no padding.  The kernel stages r, k, v and w
with 16-byte asynchronous copies, so an input that does not start on a
16-byte boundary (a view with a storage offset) is copied to one that
does first (``aligned16``).  ``LAUNCHES`` counts kernel launches, one per
launch, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.rwkv6.ref import wkv6_ref

__all__ = ["HEAD_SIZES", "LAUNCHES", "SOURCE", "aligned16", "load", "wkv6"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"

# Head sizes the kernel is instantiated for (rwkv6-3b uses 64, its
# reduced config 16).
HEAD_SIZES = (8, 16, 32, 64)

LAUNCHES = {"wkv6": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel, with a typed launcher."""
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_wkv6.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.repro_wkv6.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(
            "r, k, v and w must share one (b, s, h, N) shape, got "
            f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, _, h, n = r.shape
    if tuple(u.shape) != (h, n):
        raise ValueError(f"u must be ({h}, {n}), got {tuple(u.shape)}")
    if state is not None:
        if tuple(state.shape) != (b, h, n, n):
            raise ValueError(f"state must be ({b}, {h}, {n}, {n}), got "
                             f"{tuple(state.shape)}")
        if state.dtype != torch.float32:
            raise TypeError(f"state must be float32, got {state.dtype}")
    if r.dtype not in _DTYPE_CODES or any(t.dtype != r.dtype
                                          for t in (k, v, w)):
        raise TypeError("r, k, v and w must share one dtype, float32 or "
                        f"bfloat16, got {[t.dtype for t in (r, k, v, w)]}")
    for t in (k, v, w, u) + (() if state is None else (state,)):
        if t.device != r.device:
            raise ValueError("all operands must be on one device")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data starts on a 16-byte boundary, else a
    contiguous copy (fresh allocations are aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence from ``state`` (zeros when None).

    r, k, v, w (b, s, h, N); u (h, N); state (b, h, N, N) float32.
    Returns (out (b, s, h, N) in r's dtype, final state float32).
    """
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for device {r.device}")
    b, s, h, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} is not one of {HEAD_SIZES}")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("r, k, v and w must be contiguous")
    r, k, v, w = (aligned16(t) for t in (r, k, v, w))
    u32 = u.float().contiguous()
    state_in = None if state is None else state.contiguous()
    out = torch.empty_like(r)
    state_out = torch.empty(b, h, n, n, dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, state_out
    lib = load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), None if state_in is None else state_in.data_ptr(),
            out.data_ptr(), state_out.data_ptr(), b, s, h, n,
            _DTYPE_CODES[r.dtype], stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["wkv6"] += 1
    return out, state_out
