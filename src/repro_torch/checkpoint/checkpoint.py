"""Pytree checkpointing: an npz store with no dependency beyond numpy.

Counterpart of ``repro.checkpoint.checkpoint``, with the same file format,
so each package reads the other's files.  A tree (nested dicts, lists,
tuples and NamedTuples) is saved with its leaves as ``leaf_{i}`` arrays
and a JSON manifest of their key paths, and restored into the structure
of a template.

Leaves are torch tensors (copied to the host), numpy arrays and Python
scalars (an ``int`` becomes a 0-dim int64 array).  A leaf comes back as
the template's leaf is: a tensor on the template's device, a Python
scalar, or a numpy array.  A dtype that numpy cannot represent (bfloat16)
raises; nothing is cast.

Leaf order.  ``torch.utils._pytree`` keeps a dict's insertion order;
JAX sorts dict keys.  This module walks trees itself, dict keys sorted,
and writes key paths in JAX's form (``['k']``, ``[i]``, ``.name``), so
the manifest of a tree equals the JAX package's for the same tree.
``None`` holds no leaf, as in JAX.

Crash safety: every save writes to a temp file in the target directory
and lands with an atomic ``os.replace``, so a process killed mid-write
leaves the previous checkpoint intact.  The manifest (version 2) records
each leaf's CRC32 and dtype, so restore detects bit-rot and a dtype read
as another; version-1 files (a bare path list) still restore, without
those checks.  ``latest_step`` and ``restore_step(fallback=True)`` skip
unreadable or CRC-failing files and fall back to the newest valid one.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import warnings
import zlib
from typing import Any

import numpy as np
import torch

__all__ = ["CorruptCheckpointError", "latest_step", "restore_latest",
           "restore_pytree", "restore_step", "save_pytree", "save_step",
           "valid_steps", "verify_checkpoint"]

MANIFEST_VERSION = 2


class CorruptCheckpointError(ValueError):
    """A checkpoint file failed integrity validation (truncated archive,
    unparseable manifest, CRC mismatch, or a leaf count/dtype that
    contradicts its own manifest)."""


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, prefix: tuple, out: list) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], prefix + (f"[{key!r}]",), out)
    elif _is_namedtuple(node):
        for name in node._fields:
            _walk(getattr(node, name), prefix + (f".{name}",), out)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            _walk(child, prefix + (f"[{i}]",), out)
    else:
        out.append(("/".join(prefix), node))


def _flatten_with_paths(tree) -> tuple[list[str], list]:
    """Key paths and leaves in JAX's order (dict keys sorted)."""
    flat: list = []
    _walk(tree, (), flat)
    return [p for p, _ in flat], [leaf for _, leaf in flat]


def _unflatten(like, leaves):
    """``leaves`` (in ``_flatten_with_paths`` order) in the structure of
    ``like``; a dict keeps ``like``'s key order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            values = {key: build(node[key]) for key in sorted(node)}
            out = {key: values[key] for key in node}
            return out if type(node) is dict else type(node)(out)
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    return build(like)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return torch.empty((), dtype=dtype).numpy().dtype
    except TypeError:
        raise TypeError(
            f"a {dtype} leaf has no numpy dtype; the npz store refuses to "
            "cast it (save it as float32 explicitly)") from None


def _host_array(leaf) -> np.ndarray:
    """A leaf as the numpy array the file holds."""
    if isinstance(leaf, torch.Tensor):
        _numpy_dtype(leaf.dtype)
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64)
    return np.asarray(leaf)


def _spec(leaf) -> tuple[tuple, np.dtype]:
    """The shape and numpy dtype a template leaf expects."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), _numpy_dtype(leaf.dtype)
    arr = _host_array(leaf)
    return arr.shape, arr.dtype


def _as_like(arr: np.ndarray, like):
    """``arr`` as the template leaf ``like`` is."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def save_pytree(path: str | pathlib.Path, tree: Any) -> None:
    """Atomically write ``tree`` to ``path`` (temp file + ``os.replace``).

    The version-2 manifest records, per leaf: its key path, its dtype
    (restore refuses a leaf read as another dtype), and the CRC32 of its
    bytes (restore refuses bit-rot).
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    paths, leaves = _flatten_with_paths(tree)
    arrays = {f"leaf_{i}": _host_array(leaf) for i, leaf in enumerate(leaves)}
    manifest = json.dumps({
        "version": MANIFEST_VERSION,
        "paths": paths,
        "dtypes": [str(arrays[f"leaf_{i}"].dtype)
                   for i in range(len(leaves))],
        "crcs": [zlib.crc32(np.ascontiguousarray(
            arrays[f"leaf_{i}"]).tobytes()) for i in range(len(leaves))],
    })
    # the temp file lives in the target directory: os.replace is atomic
    # only within one filesystem
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, __manifest__=np.frombuffer(
                manifest.encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_manifest(data) -> dict:
    """Parse either manifest version into the v2 dict shape."""
    try:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
    except Exception as exc:
        raise CorruptCheckpointError(
            f"unparseable checkpoint manifest: {exc}") from exc
    if isinstance(manifest, list):        # version 1: bare path list
        return {"version": 1, "paths": manifest, "dtypes": None,
                "crcs": None}
    return manifest


def _load_leaves(data, manifest: dict, path) -> list[np.ndarray]:
    """The leaf arrays, CRC- and dtype-validated against the manifest."""
    paths = manifest["paths"]
    try:
        leaves = [data[f"leaf_{i}"] for i in range(len(paths))]
    except Exception as exc:
        raise CorruptCheckpointError(
            f"{path}: leaf array missing or unreadable ({exc})") from exc
    if manifest.get("crcs") is not None:
        for i, (leaf, want) in enumerate(zip(leaves, manifest["crcs"])):
            got = zlib.crc32(np.ascontiguousarray(leaf).tobytes())
            if got != want:
                raise CorruptCheckpointError(
                    f"{path}: CRC mismatch on leaf {i} ({paths[i]}): stored "
                    f"{want}, recomputed {got}")
    if manifest.get("dtypes") is not None:
        for i, (leaf, want) in enumerate(zip(leaves, manifest["dtypes"])):
            if str(leaf.dtype) != want:
                raise CorruptCheckpointError(
                    f"{path}: leaf {i} ({paths[i]}) decoded as {leaf.dtype} "
                    f"but the manifest records {want}")
    return leaves


def restore_pytree(path: str | pathlib.Path, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape/dtype template)."""
    path = pathlib.Path(path)
    try:
        data = np.load(path, allow_pickle=False)
    except OSError:
        raise
    except Exception as exc:   # truncated zip, bad magic, ...
        raise CorruptCheckpointError(
            f"{path}: unreadable archive ({exc})") from exc
    with data:
        manifest = _load_manifest(data)
        paths_like, leaves_like = _flatten_with_paths(like)
        if paths_like != manifest["paths"]:
            raise ValueError(
                "checkpoint structure mismatch:\n"
                f"  saved:    {manifest['paths'][:5]}...\n"
                f"  expected: {paths_like[:5]}...")
        leaves = _load_leaves(data, manifest, path)
    for i, (got, want) in enumerate(zip(leaves, leaves_like)):
        shape, dtype = _spec(want)
        if tuple(got.shape) != shape:
            raise ValueError(f"shape mismatch {got.shape} vs {shape}")
        if got.dtype != dtype:
            raise ValueError(
                f"dtype mismatch on leaf {i} ({manifest['paths'][i]}): "
                f"checkpoint holds {got.dtype}, template expects {dtype} — "
                "refusing silent reinterpretation")
    return _unflatten(like, [_as_like(got, want)
                             for got, want in zip(leaves, leaves_like)])


def verify_checkpoint(path: str | pathlib.Path) -> bool:
    """Can this file be restored?  (A readable archive, a parseable
    manifest, every leaf present with its CRC and dtype; the structure is
    not checked, that needs a template.)"""
    try:
        data = np.load(pathlib.Path(path), allow_pickle=False)
    except Exception:
        return False
    try:
        with data:
            manifest = _load_manifest(data)
            _load_leaves(data, manifest, path)
        return True
    except Exception:
        return False


def save_step(ckpt_dir: str | pathlib.Path, step: int, tree: Any) -> None:
    save_pytree(_step_path(ckpt_dir, step), tree)


def _step_path(ckpt_dir, step: int) -> pathlib.Path:
    return pathlib.Path(ckpt_dir) / f"step_{step:08d}.npz"


def _all_steps(ckpt_dir) -> list[int]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return []
    steps = []
    for p in d.glob("step_*.npz"):
        try:
            steps.append(int(p.stem.split("_")[1]))
        except (IndexError, ValueError):
            continue   # a stray file matching the glob, not a checkpoint
    return sorted(steps)


def valid_steps(ckpt_dir: str | pathlib.Path) -> list[int]:
    """Ascending steps whose checkpoint files pass integrity validation."""
    return [s for s in _all_steps(ckpt_dir)
            if verify_checkpoint(_step_path(ckpt_dir, s))]


def latest_step(ckpt_dir: str | pathlib.Path,
                validate: bool = True) -> int | None:
    """The newest restorable step (``None`` when the directory is empty).

    ``validate=True`` (the default) skips unreadable or CRC-failing files
    and returns the newest checkpoint that verifies; ``validate=False``
    orders by file name alone (no file reads).
    """
    steps = _all_steps(ckpt_dir)
    if not validate:
        return steps[-1] if steps else None
    for s in reversed(steps):
        if verify_checkpoint(_step_path(ckpt_dir, s)):
            return s
    return None


def restore_step(ckpt_dir: str | pathlib.Path, step: int, like: Any,
                 fallback: bool = False) -> Any:
    """Restore the checkpoint at ``step``.

    ``fallback=True``: when that file is corrupt or missing, warn and
    restore the newest older step that validates instead of raising
    (``restore_latest`` also reports which step was used).
    """
    if not fallback:
        return restore_pytree(_step_path(ckpt_dir, step), like)
    out = restore_latest(ckpt_dir, like, max_step=step)
    if out is None:
        raise FileNotFoundError(
            f"no restorable checkpoint at or before step {step} "
            f"in {ckpt_dir}")
    tree, used = out
    if used != step:
        warnings.warn(
            f"checkpoint step {step} in {ckpt_dir} is corrupt or "
            f"missing; fell back to step {used}", stacklevel=2)
    return tree


def restore_latest(ckpt_dir: str | pathlib.Path, like: Any,
                   max_step: int | None = None
                   ) -> tuple[Any, int] | None:
    """``(tree, step)`` of the newest checkpoint <= ``max_step`` that
    restores cleanly, skipping corrupt files; ``None`` if none does.

    A structure or shape mismatch (a valid checkpoint of another
    template) still raises: falling back past it would resume another
    run.
    """
    steps = _all_steps(ckpt_dir)
    if max_step is not None:
        steps = [s for s in steps if s <= max_step]
    for s in reversed(steps):
        try:
            return restore_pytree(_step_path(ckpt_dir, s), like), s
        except (CorruptCheckpointError, OSError):
            continue
    return None
