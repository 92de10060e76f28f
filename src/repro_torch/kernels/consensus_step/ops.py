"""Wrappers of the consensus kernels: checks, dispatch, pytrees, counts.

Counterpart of ``repro.kernels.consensus_step.ops`` (pytree level) and
``kernel.py`` (the (m, D) level).  Dispatch is on the inputs' device and
on nothing else: a CPU tensor goes to the plain version in ``ref.py``, a
CUDA tensor launches the kernel of ``csrc/consensus_step.cu`` or raises.
``LAUNCHES`` counts kernel launches, one per launch, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.build import load_library
from repro_torch.kernels.consensus_step.ref import (consensus_mix_ref,
                                                    consensus_step_ref)

__all__ = ["LAUNCHES", "MAX_SHARED_BYTES", "SOURCE", "consensus_mix",
           "consensus_mix_kernel", "consensus_step", "consensus_step_kernel",
           "flatten_agents", "load", "mix_takes_16_byte_path"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "consensus_step.cu"

# Shared memory one block may use on Hopper; M lives there whole.
MAX_SHARED_BYTES = 232448

LAUNCHES = {"consensus_step": 0, "consensus_mix": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels, with typed launchers."""
    lib = load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_consensus_step.argtypes = [ptr] * 7 + [i32, i64, ctypes.c_float,
                                                     i32, ptr]
    lib.repro_consensus_step.restype = i32
    lib.repro_consensus_mix.argtypes = [ptr] * 3 + [i32, i64, i32, i32, ptr]
    lib.repro_consensus_mix.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(M: torch.Tensor, streams: tuple[torch.Tensor, ...]) -> None:
    x = streams[0]
    if M.dim() != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"mixing matrix must be (m, m), got {tuple(M.shape)}")
    if M.dtype != torch.float32:
        raise TypeError(f"mixing matrix must be float32, got {M.dtype}")
    for s in streams:
        if s.dim() != 2 or s.shape != x.shape or s.shape[0] != M.shape[0]:
            raise ValueError(
                f"streams must all be (m, D) with m = {M.shape[0]}, got "
                f"{[tuple(t.shape) for t in streams]}")
        if s.dtype != x.dtype or s.dtype not in _DTYPE_CODES:
            raise TypeError(
                "streams must share one dtype, float32 or bfloat16, got "
                f"{[t.dtype for t in streams]}")
    for t in (M, *streams):
        if t.device != x.device:
            raise ValueError(
                f"all operands must be on one device, got {M.device} for M "
                f"and {[str(s.device) for s in streams]} for the streams")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _launch_checks(M: torch.Tensor, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no consensus kernel for device {x.device}")
    m = M.shape[0]
    if m * m * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"{m} agents: the {m}x{m} float32 mixing matrix ({m * m * 4} "
            f"bytes) exceeds the {MAX_SHARED_BYTES} bytes of shared memory "
            f"a block can use")


def _raise_on_error(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def consensus_step_kernel(M: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
                          p: torch.Tensor, p_prev: torch.Tensor, *,
                          alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(M @ x - alpha * u, M @ u + (p - p_prev))`` on (m, D) rows."""
    _check(M, (x, u, p, p_prev))
    if x.device.type == "cpu":
        return consensus_step_ref(M, x, u, p, p_prev, alpha=alpha)
    _launch_checks(M, x)
    x_out, u_out = torch.empty_like(x), torch.empty_like(u)
    m, d = x.shape
    if d == 0:
        return x_out, u_out
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_consensus_step(
            M.data_ptr(), x.data_ptr(), u.data_ptr(), p.data_ptr(),
            p_prev.data_ptr(), x_out.data_ptr(), u_out.data_ptr(), m, d,
            float(alpha), _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, err, "consensus_step")
    LAUNCHES["consensus_step"] += 1
    return x_out, u_out


def mix_takes_16_byte_path(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether ``consensus_mix``'s kernel may move ``x`` and ``out`` in
    16-byte accesses: every row starts on a 16-byte boundary, i.e. a row
    is a multiple of 16 bytes and both base pointers are 16-byte aligned
    (a view with a storage offset may not be).  Otherwise it takes element
    accesses."""
    row_bytes = x.shape[1] * x.element_size()
    return (row_bytes % 16 == 0 and x.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)


def consensus_mix_kernel(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``M @ x`` on (m, D) rows."""
    _check(M, (x,))
    if x.device.type == "cpu":
        return consensus_mix_ref(M, x)
    _launch_checks(M, x)
    out = torch.empty_like(x)
    m, d = x.shape
    if d == 0:
        return out
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_consensus_mix(
            M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d,
            _DTYPE_CODES[x.dtype], int(mix_takes_16_byte_path(x, out)),
            stream)
    _raise_on_error(lib, err, "consensus_mix")
    LAUNCHES["consensus_mix"] += 1
    return out


def flatten_agents(tree):
    """(m, ...)-leaved pytree -> ((m, D) matrix, unravel).

    Leaves are laid end to end per agent in ``ravel_pytree`` order, in
    the promoted dtype of all leaves; ``unravel((m, D))`` restores the
    tree with every leaf back in its own shape and dtype.
    """
    leaves, spec = pytree.tree_flatten(tree)
    m = leaves[0].shape[0]
    dtype = functools.reduce(torch.promote_types, [l.dtype for l in leaves])
    flat = torch.cat([l.reshape(m, -1).to(dtype) for l in leaves], dim=1)
    shapes = [(l.shape, l.dtype) for l in leaves]
    sizes = [l[0].numel() for l in leaves]

    def unravel(mat: torch.Tensor):
        parts = torch.split(mat, sizes, dim=1)
        return pytree.tree_unflatten(
            [part.reshape(shape).to(dt)
             for part, (shape, dt) in zip(parts, shapes)], spec)

    return flat, unravel


def consensus_mix(M: torch.Tensor, tree):
    """Bare combine ``x_i <- sum_j M_ij x_j`` over a pytree (one launch)."""
    X, unravel = flatten_agents(tree)
    return unravel(consensus_mix_kernel(M, X))


def consensus_step(M: torch.Tensor, x_tree, u_tree, p_tree, pprev_tree, *,
                   alpha: float):
    """``(x_tree', u_tree')`` after one fused eq. (6) + (10) update."""
    X, unravel_x = flatten_agents(x_tree)
    # u gets its own unravel: for mixed-dtype trees, x's unravel would
    # cast the tracker to x's leaf dtypes on the way back.
    U, unravel_u = flatten_agents(u_tree)
    P, _ = flatten_agents(p_tree)
    PP, _ = flatten_agents(pprev_tree)
    dtype = functools.reduce(torch.promote_types,
                             [X.dtype, U.dtype, P.dtype, PP.dtype])
    X_out, U_out = consensus_step_kernel(
        M, X.to(dtype), U.to(dtype), P.to(dtype), PP.to(dtype), alpha=alpha)
    return unravel_x(X_out), unravel_u(U_out)
