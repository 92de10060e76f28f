"""Wrappers of the consensus kernels: checks, dispatch, pytrees, counts.

Counterpart of ``repro.kernels.consensus_step.ops`` (pytree level) and
``kernel.py`` (the (m, D) level).  Dispatch is on the inputs' device and
on nothing else: a CPU tensor goes to the plain version in ``ref.py``, a
CUDA tensor launches the kernel of ``csrc/consensus_step.cu`` or raises.
``LAUNCHES`` counts kernel launches, one per launch, and nothing else.

Row blocks.  ``consensus_step_kernel(..., row0=r)`` and
``consensus_mix_kernel(..., row0=r, rows=k)`` compute only the output
rows ``r .. r + k - 1``: what one process of the multi-process
``allgather`` backend needs, which holds those agents' p and p_prev and
the gathered (m, D) tables of x and u.  M stays (m, m); p, p_prev and
the outputs are (k, D).  A call without ``row0`` is the square one (row0
= 0, rows = m), unchanged.  ``ROW_LAUNCHES`` counts the launches made
with a row block; each is also one of its kernel's ``LAUNCHES``.

Batched forms.  ``consensus_step_batched_kernel`` and
``consensus_mix_batched_kernel`` take B experiments' (B, m, D) streams
and one matrix per experiment, (B, m, m), or one for all, (1, m, m), and
run them in one launch (the kernel's grid y axis is the experiment);
the step reads each experiment's alpha from a (B,) float32 tensor.

Under ``torch.func.vmap``.  The (m, D) wrappers read ``data_ptr()``,
which a batched tensor does not have, so the pytree functions reach the
kernels through two custom operators, ``repro_torch::consensus_mix`` and
``repro_torch::consensus_step`` (the step's alpha a 0-dim tensor).  Their
vmap rules gather the batch onto the leading axis and call the batched
wrapper once, so a sweep group of B experiments launches each kernel
once a step; unbatched, the mix operator calls the (m, D) wrapper and the
step operator the batched kernel with B = 1.  On the CPU both reach the
plain versions.  ``consensus_step`` with a Python float alpha calls the
(m, D) wrapper directly, as it always has.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.build import load_library
from repro_torch.kernels.consensus_step.ref import (
    consensus_mix_batched_ref, consensus_mix_ref, consensus_mix_rows_ref,
    consensus_step_batched_ref, consensus_step_ref, consensus_step_rows_ref)

__all__ = ["LAUNCHES", "MAX_SHARED_BYTES", "ROW_LAUNCHES", "SOURCE",
           "consensus_mix",
           "consensus_mix_batched_kernel", "consensus_mix_kernel",
           "consensus_step", "consensus_step_batched_kernel",
           "consensus_step_kernel", "flatten_agents", "load",
           "mix_takes_16_byte_path"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "consensus_step.cu"

# Shared memory one block may use on Hopper; M lives there whole.
MAX_SHARED_BYTES = 232448

LAUNCHES = {"consensus_step": 0, "consensus_mix": 0}
# the launches of LAUNCHES made with a row block (``row0=``)
ROW_LAUNCHES = {"consensus_step": 0, "consensus_mix": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels, with typed launchers."""
    lib = load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_consensus_step.argtypes = [ptr] * 7 + [i32, i64, ctypes.c_float,
                                                     i32, ptr]
    lib.repro_consensus_step.restype = i32
    lib.repro_consensus_step_rows.argtypes = [ptr] * 7 + [
        i32, i64, i32, i32, ctypes.c_float, i32, ptr]
    lib.repro_consensus_step_rows.restype = i32
    lib.repro_consensus_mix.argtypes = [ptr] * 3 + [i32, i64, i32, i32, ptr]
    lib.repro_consensus_mix.restype = i32
    lib.repro_consensus_mix_rows.argtypes = [ptr] * 3 + [i32, i64, i32, i32,
                                                         i32, i32, ptr]
    lib.repro_consensus_mix_rows.restype = i32
    lib.repro_consensus_step_batched.argtypes = [ptr] * 7 + [
        i32, i64, i32, i64, ptr, i32, ptr]
    lib.repro_consensus_step_batched.restype = i32
    lib.repro_consensus_mix_batched.argtypes = [ptr] * 3 + [
        i32, i64, i32, i64, i32, i32, ptr]
    lib.repro_consensus_mix_batched.restype = i32
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


def _check_block(M: torch.Tensor, tables: tuple[torch.Tensor, ...],
                 blocks: tuple[torch.Tensor, ...], row0: int,
                 rows: int) -> None:
    """A row-block call: (m, D) ``tables``, (rows, D) ``blocks`` (p,
    p_prev), the block inside M's m rows."""
    _check(M, tables)
    m, d = tables[0].shape
    if not (isinstance(row0, int) and isinstance(rows, int)
            and 0 <= row0 and 1 <= rows and row0 + rows <= m):
        raise ValueError(f"row block {row0} .. {row0} + {rows} - 1 is not "
                         f"inside the {m} rows of M")
    for b in blocks:
        if b.dim() != 2 or tuple(b.shape) != (rows, d):
            raise ValueError(f"block operands must be ({rows}, {d}), got "
                             f"{[tuple(t.shape) for t in blocks]}")
        if b.dtype != tables[0].dtype:
            raise TypeError("block operands must share the tables' dtype, "
                            f"{tables[0].dtype}, got {b.dtype}")
        if b.device != tables[0].device:
            raise ValueError("all operands must be on one device")
        if not b.is_contiguous():
            raise ValueError("operands must be contiguous")


def _check_batched(M: torch.Tensor, streams: tuple[torch.Tensor, ...],
                   alpha: torch.Tensor | None = None) -> None:
    x = streams[0]
    if x.dim() != 3:
        raise ValueError(f"batched streams must be (B, m, D), got "
                         f"{tuple(x.shape)}")
    B, m = x.shape[0], x.shape[1]
    if M.dim() != 3 or M.shape[1:] != (m, m) or M.shape[0] not in (1, B):
        raise ValueError(f"batched mixing matrices must be ({B}, {m}, {m}) "
                         f"or (1, {m}, {m}), got {tuple(M.shape)}")
    if not 1 <= B <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 experiments, got {B}")
    _check(M[0], tuple(s[0] for s in streams))
    for s in streams:
        if s.shape != x.shape:
            raise ValueError(
                f"streams must all be {tuple(x.shape)}, got "
                f"{[tuple(t.shape) for t in streams]}")
    for t in (M, *streams):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if alpha is not None:
        if (alpha.shape != (B,) or alpha.dtype != torch.float32
                or alpha.device != x.device or not alpha.is_contiguous()):
            raise ValueError(
                f"alpha must be a contiguous ({B},) float32 tensor on "
                f"{x.device}, got {tuple(alpha.shape)} {alpha.dtype} on "
                f"{alpha.device}")


def _launch_checks(M: torch.Tensor, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no consensus kernel for device {x.device}")
    m = M.shape[-1]
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
                          alpha: float, row0: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(M @ x - alpha * u, M @ u + (p - p_prev))`` on (m, D) rows.

    With ``row0`` the row block from there: x and u the (m, D) tables,
    p and p_prev the block's (rows, D) rows; returns the block's rows of
    both outputs."""
    if row0 is None:
        _check(M, (x, u, p, p_prev))
        if x.device.type == "cpu":
            return consensus_step_ref(M, x, u, p, p_prev, alpha=alpha)
    else:
        _check_block(M, (x, u), (p, p_prev), row0, p.shape[0])
        if x.device.type == "cpu":
            return consensus_step_rows_ref(M, x, u, p, p_prev, row0=row0,
                                           alpha=alpha)
    x_out, u_out = x.new_empty(p.shape), u.new_empty(p.shape)
    _launch_step(M, x, u, p, p_prev, x_out, u_out, alpha, row0)
    return x_out, u_out


def _launch_step(M, x, u, p, p_prev, x_out, u_out, alpha: float,
                 row0: int | None) -> None:
    """One (m, D) ``consensus_step`` launch (checked by the caller) of the
    rows of ``p`` from ``row0`` (``None``: the square kernel) into
    ``x_out`` and ``u_out``.  Raises for tensors off the card."""
    _launch_checks(M, x)
    m, d = x.shape
    if d == 0:
        return
    lib = load()
    ptrs = (M.data_ptr(), x.data_ptr(), u.data_ptr(), p.data_ptr(),
            p_prev.data_ptr(), x_out.data_ptr(), u_out.data_ptr(), m, d)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if row0 is None:
            err = lib.repro_consensus_step(*ptrs, float(alpha),
                                           _DTYPE_CODES[x.dtype], stream)
        else:
            err = lib.repro_consensus_step_rows(
                *ptrs, row0, p.shape[0], float(alpha), _DTYPE_CODES[x.dtype],
                stream)
    _raise_on_error(lib, err, "consensus_step")
    LAUNCHES["consensus_step"] += 1
    if row0 is not None:
        ROW_LAUNCHES["consensus_step"] += 1


def consensus_step_batched_kernel(M: torch.Tensor, x: torch.Tensor,
                                  u: torch.Tensor, p: torch.Tensor,
                                  p_prev: torch.Tensor, alpha: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``consensus_step_kernel`` for B experiments in one launch: streams
    (B, m, D), M (B, m, m) or (1, m, m) shared, alpha (B,) float32."""
    _check_batched(M, (x, u, p, p_prev), alpha)
    if x.device.type == "cpu":
        return consensus_step_batched_ref(M, x, u, p, p_prev, alpha)
    _launch_checks(M, x)
    x_out, u_out = torch.empty_like(x), torch.empty_like(u)
    _launch_step_batched(M, x, u, p, p_prev, alpha, x_out, u_out)
    return x_out, u_out


def _launch_step_batched(M, x, u, p, p_prev, alpha, x_out, u_out) -> None:
    """One ``consensus_step`` launch over ``x``'s leading batch axis
    (checked by the caller), writing ``x_out`` and ``u_out``."""
    B, m, d = x.shape
    if d == 0:
        return
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_consensus_step_batched(
            M.data_ptr(), x.data_ptr(), u.data_ptr(), p.data_ptr(),
            p_prev.data_ptr(), x_out.data_ptr(), u_out.data_ptr(), m, d, B,
            0 if M.shape[0] == 1 else m * m, alpha.data_ptr(),
            _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, err, "consensus_step")
    LAUNCHES["consensus_step"] += 1


def mix_takes_16_byte_path(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether ``consensus_mix``'s kernel may move ``x`` and ``out`` in
    16-byte accesses: every row starts on a 16-byte boundary, i.e. a row
    is a multiple of 16 bytes and both base pointers are 16-byte aligned
    (a view with a storage offset may not be).  Otherwise it takes element
    accesses.  ``x`` is (m, D) or a batch (B, m, D)."""
    row_bytes = x.shape[-1] * x.element_size()
    return (row_bytes % 16 == 0 and x.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)


def consensus_mix_kernel(M: torch.Tensor, x: torch.Tensor, *,
                         row0: int | None = None,
                         rows: int | None = None) -> torch.Tensor:
    """``M @ x`` on (m, D) rows; with ``row0`` and ``rows`` only the
    block's (rows, D) rows of it."""
    if row0 is None:
        _check(M, (x,))
        if x.device.type == "cpu":
            return consensus_mix_ref(M, x)
        out = torch.empty_like(x)
    else:
        _check_block(M, (x,), (), row0, rows)
        if x.device.type == "cpu":
            return consensus_mix_rows_ref(M, x, row0=row0, rows=rows)
        out = x.new_empty((rows, x.shape[1]))
    _launch_checks(M, x)
    m, d = x.shape
    if d == 0:
        return out
    lib = load()
    block = () if row0 is None else (row0, rows)
    launch = (lib.repro_consensus_mix if row0 is None
              else lib.repro_consensus_mix_rows)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d, *block,
                     _DTYPE_CODES[x.dtype],
                     int(mix_takes_16_byte_path(x, out)), stream)
    _raise_on_error(lib, err, "consensus_mix")
    LAUNCHES["consensus_mix"] += 1
    if row0 is not None:
        ROW_LAUNCHES["consensus_mix"] += 1
    return out


def consensus_mix_batched_kernel(M: torch.Tensor, x: torch.Tensor
                                 ) -> torch.Tensor:
    """``consensus_mix_kernel`` for B experiments in one launch: x (B, m,
    D), M (B, m, m) or (1, m, m) shared."""
    _check_batched(M, (x,))
    if x.device.type == "cpu":
        return consensus_mix_batched_ref(M, x)
    _launch_checks(M, x)
    out = torch.empty_like(x)
    B, m, d = x.shape
    if d == 0:
        return out
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_consensus_mix_batched(
            M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d, B,
            0 if M.shape[0] == 1 else m * m, _DTYPE_CODES[x.dtype],
            int(mix_takes_16_byte_path(x, out)), stream)
    _raise_on_error(lib, err, "consensus_mix")
    LAUNCHES["consensus_mix"] += 1
    return out


# -- the custom operators: what the pytree functions call, vmap or not ------

@torch.library.custom_op("repro_torch::consensus_mix", mutates_args=())
def _mix_op(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return consensus_mix_kernel(M, x)


@_mix_op.register_fake
def _(M, x):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::consensus_step", mutates_args=())
def _step_op(M: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
             p: torch.Tensor, p_prev: torch.Tensor, alpha: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    alpha = alpha.reshape(1).to(torch.float32)
    _check_batched(M[None], tuple(t[None] for t in (x, u, p, p_prev)), alpha)
    if x.device.type == "cpu":
        return consensus_step_ref(M, x, u, p, p_prev, alpha=alpha[0])
    _launch_checks(M, x)
    x_out, u_out = torch.empty_like(x), torch.empty_like(u)
    _launch_step_batched(M[None], x[None], u[None], p[None], p_prev[None],
                         alpha, x_out[None], u_out[None])
    return x_out, u_out


@_step_op.register_fake
def _(M, x, u, p, p_prev, alpha):
    return torch.empty_like(x), torch.empty_like(u)


def _batch_first(t: torch.Tensor, dim: int | None, size: int
                 ) -> torch.Tensor:
    """``t`` with its vmap batch axis ``dim`` leading (expanded to ``size``
    when it has none), contiguous."""
    if dim is None:
        t = t.expand(size, *t.shape)
    else:
        t = t.movedim(dim, 0)
    return t.contiguous()


def _matrix_batch(M: torch.Tensor, dim: int | None) -> torch.Tensor:
    """The (B, m, m) matrices of a batched ``M``, or (1, m, m) for one
    matrix shared by the batch."""
    return (M[None] if dim is None else M.movedim(dim, 0)).contiguous()


@torch.library.register_vmap("repro_torch::consensus_mix")
def _mix_vmap(info, in_dims, M, x):
    out = consensus_mix_batched_kernel(
        _matrix_batch(M, in_dims[0]),
        _batch_first(x, in_dims[1], info.batch_size))
    return out, 0


@torch.library.register_vmap("repro_torch::consensus_step")
def _step_vmap(info, in_dims, M, x, u, p, p_prev, alpha):
    size = info.batch_size
    streams = [_batch_first(t, d, size)
               for t, d in zip((x, u, p, p_prev), in_dims[1:5])]
    x_out, u_out = consensus_step_batched_kernel(
        _matrix_batch(M, in_dims[0]), *streams,
        _batch_first(alpha.to(torch.float32), in_dims[5], size))
    return (x_out, u_out), (0, 0)


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
    """Bare combine ``x_i <- sum_j M_ij x_j`` over a pytree (one launch,
    for all experiments under ``vmap``)."""
    X, unravel = flatten_agents(tree)
    return unravel(_mix_op(M, X))


def consensus_step(M: torch.Tensor, x_tree, u_tree, p_tree, pprev_tree, *,
                   alpha: float | torch.Tensor):
    """``(x_tree', u_tree')`` after one fused eq. (6) + (10) update.

    ``alpha`` is a Python float or a 0-dim tensor (one per experiment
    under ``vmap``, read by the kernel from the device)."""
    X, unravel_x = flatten_agents(x_tree)
    # u gets its own unravel: for mixed-dtype trees, x's unravel would
    # cast the tracker to x's leaf dtypes on the way back.
    U, unravel_u = flatten_agents(u_tree)
    P, _ = flatten_agents(p_tree)
    PP, _ = flatten_agents(pprev_tree)
    dtype = functools.reduce(torch.promote_types,
                             [X.dtype, U.dtype, P.dtype, PP.dtype])
    X, U, P, PP = (t.to(dtype) for t in (X, U, P, PP))
    if isinstance(alpha, torch.Tensor):
        X_out, U_out = _step_op(M, X, U, P, PP, alpha)
    else:
        X_out, U_out = consensus_step_kernel(M, X, U, P, PP, alpha=alpha)
    return unravel_x(X_out), unravel_u(U_out)
