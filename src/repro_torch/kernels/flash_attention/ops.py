"""Wrapper of the flash attention kernels: checks, dispatch, launch counts.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.
Dispatch is on the inputs' device and dtype and on nothing else: a CPU
tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernels of ``csrc/flash_attention.cu`` or raises.  bfloat16 takes the
tensor-core (wgmma) kernel, which needs 16-byte aligned pointers and
(batch, seq, head) strides.  float32 takes two kernels: the split pass,
which reads q, k and v at any strides and writes each as two scaled
float16 terms into scratch allocated here, then the split-operand
tensor-core kernel on that scratch.  The kernels mask key columns past
the sequence themselves, so nothing is padded (the JAX wrapper pads k and
v with zero rows, which a non-causal call or a ``q_offset`` past the keys
then attends to; this wrapper follows ``ref.py`` in those cases too).

``LAUNCHES`` counts, each adding one per launch and nothing else:
``"flash_attention"`` one per call that launches (either dtype),
``"flash_attention_tc"`` the bfloat16 kernel, ``"flash_attention_f32_split"``
the float32 split pass and ``"flash_attention_f32"`` the float32 kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["CPU_F32_TILES", "F32Scratch", "HEAD_DIMS", "LAUNCHES", "SOURCE",
           "TC_ROW_RTOL", "check_tc_alignment", "f32_scratch", "f32_tiles",
           "flash_attention", "launch_f32", "launch_split_f32", "launch_tc",
           "load", "row_errors"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# Head sizes the kernel is instantiated for (the repo's configs use 64,
# 128 and 256; the reduced ones 32).
HEAD_DIMS = (32, 64, 128, 256)

LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_f32_split": 0, "flash_attention_f32": 0}

# What the bfloat16 kernel is held to (chip_smoke.py,
# tests/test_torch_kernels_cuda.py; tests/test_torch_flash_attention.py
# sizes it against an emulation of the kernel's rounding): every row's
# ``row_errors`` against the plain version in float32 on the same bf16
# inputs at most TC_ROW_RTOL.
TC_ROW_RTOL = 1e-2

# The float32 kernel's tiles (query rows a block, keys a kv tile) by head
# size, for the CPU emulation of its rounding, where no library is built:
# 64-key tiles except at 256, where two f16 terms of a 64-key tile do not
# fit beside q's.  On the card the library's own numbers (``f32_tiles``)
# are used; the card test of the split pass holds the two equal.
CPU_F32_TILES = {32: (64, 64), 64: (64, 64), 128: (64, 64), 256: (64, 32)}


class F32Scratch(NamedTuple):
    """What the float32 split pass writes and its kernel reads: float16 hi
    and lo terms of q, k and v, and the exponents of their tiles."""
    halves: torch.Tensor
    exps: torch.Tensor


_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def load(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (at first use) and load the kernels, with typed launchers;
    ``defines`` (``NAME=VALUE``) build a variant of the source."""
    lib = load_library(SOURCE, defines)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.repro_flash_attention_tc.argtypes = (
        [ptr] * 4 + [i32] * 6 + [i64p, i32, i32, f32, i32, ptr])
    lib.repro_flash_split_f32.argtypes = [ptr] * 5 + [i32] * 6 + [i64p, ptr]
    lib.repro_flash_attention_f32.argtypes = (
        [ptr] * 3 + [i32] * 8 + [f32, i32, ptr])
    lib.repro_flash_f32_scratch.argtypes = [i32] * 6 + [i64p]
    for fn in (lib.repro_flash_attention_tc, lib.repro_flash_split_f32,
               lib.repro_flash_attention_f32):
        fn.restype = i32
    lib.repro_flash_f32_scratch.restype = None
    lib.repro_flash_f32_tiles.argtypes = [i32, ctypes.POINTER(i32)]
    lib.repro_flash_f32_tiles.restype = None
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
    lib = load()
    if tc:
        launch_tc(lib, q, k, v, out, **kwargs)
        LAUNCHES["flash_attention_tc"] += 1
    else:
        scratch = f32_scratch(lib, q, k)
        launch_split_f32(lib, q, k, v, scratch)
        LAUNCHES["flash_attention_f32_split"] += 1
        launch_f32(lib, scratch, out, nkv=k.shape[2], skv=k.shape[1],
                   **kwargs)
        LAUNCHES["flash_attention_f32"] += 1
    LAUNCHES["flash_attention"] += 1
    return out


def _raise_on(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def _strides(*tensors: torch.Tensor) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def launch_tc(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, out: torch.Tensor, *, causal: bool,
              window: int | None, logit_softcap: float | None,
              q_offset: int) -> None:
    """Launch ``lib``'s bfloat16 kernel on arguments that
    ``flash_attention`` has checked, into ``out``; counts nothing."""
    b, sq, nh, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], nh, k.shape[2], hd, _strides(q, k, v), int(causal),
            0 if window is None else int(window),
            0.0 if logit_softcap is None else float(logit_softcap),
            int(q_offset), stream)
    _raise_on(lib, err, "flash_attention_tc")


def f32_scratch(lib: ctypes.CDLL, q: torch.Tensor,
                k: torch.Tensor) -> F32Scratch:
    """Empty scratch for the float32 path at q's and k's sizes, on q's
    device, sized by the library."""
    b, sq, nh, hd = q.shape
    counts = (ctypes.c_longlong * 2)()
    lib.repro_flash_f32_scratch(b, sq, k.shape[1], nh, k.shape[2], hd,
                                counts)
    return F32Scratch(
        torch.empty(counts[0], dtype=torch.float16, device=q.device),
        torch.empty(counts[1], dtype=torch.int32, device=q.device))


def f32_tiles(lib: ctypes.CDLL, hd: int) -> tuple[int, int]:
    """Query rows a block and keys a kv tile of ``lib``'s float32 kernel
    at head size ``hd``: the tiles its split pass scales one by one."""
    rows = (ctypes.c_int * 2)()
    lib.repro_flash_f32_tiles(hd, rows)
    return rows[0], rows[1]


def launch_split_f32(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, scratch: F32Scratch) -> None:
    """Launch ``lib``'s float32 split pass on checked q, k, v (any
    strides, head size contiguous) into ``scratch``; counts nothing."""
    b, sq, nh, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_split_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            scratch.halves.data_ptr(), scratch.exps.data_ptr(), b, sq,
            k.shape[1], nh, k.shape[2], hd, _strides(q, k, v), stream)
    _raise_on(lib, err, "flash_attention_f32_split")


def launch_f32(lib: ctypes.CDLL, scratch: F32Scratch, out: torch.Tensor, *,
               skv: int, nkv: int, causal: bool, window: int | None,
               logit_softcap: float | None, q_offset: int) -> None:
    """Launch ``lib``'s float32 kernel on what ``launch_split_f32`` wrote,
    into a contiguous float32 ``out`` (b, sq, nh, hd); counts nothing."""
    b, sq, nh, hd = out.shape
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_f32(
            scratch.halves.data_ptr(), scratch.exps.data_ptr(),
            out.data_ptr(), b, sq, skv, nh, nkv, hd, int(causal),
            0 if window is None else int(window),
            0.0 if logit_softcap is None else float(logit_softcap),
            int(q_offset), stream)
    _raise_on(lib, err, "flash_attention_f32")
