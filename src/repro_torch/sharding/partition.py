"""How an agent's state splits over its pod (the pods layout).

Counterpart of ``repro.sharding.partition``.  The rule is the JAX
package's: shard the largest dimension divisible by the ``model`` axis
size (later dims win ties), then spread each further axis of
``extra_axes`` over the largest remaining divisible dimension; 1-D
leaves stay whole.  In the pods layout (``agent_mode="pods"``) the
model axis is 1 and the pod's ``("data", k)`` is the extra axis, so an
agent's leaf is split k ways along the dimension ``leaf_spec`` gives
``"data"``, or kept whole where no dimension divides by k.

As ``train_state_specs`` does, only the backbone's ``layers`` and the
head y (and the like-shaped u, p_prev, v and the SVR state's previous
iterate) shard; ``embed``, ``final_norm`` and ``frontend_proj`` stay
whole on every rank of the pod.  The port keeps one parameter dict per
layer (``models/model.py``), so the rule sees per-layer shapes, not the
JAX package's stacked ones.  Leaves here are the state's (1, ...) form:
the leading agent dim is never split.

A pod's rank d holds the d-th of the k equal chunks along the split
dimension.  ``gather_tree`` puts the whole leaves back on every rank of
the pod (one all-gather), ``reduce_scatter_tree`` leaves each rank its
chunk of the pod's mean (one reduce-scatter; whole leaves are
all-reduced); ``shard_tree`` cuts whole leaves into this rank's chunks.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

__all__ = ["DATA_AXIS", "gather_tree", "head_shard_dim", "leaf_paths",
           "leaf_spec",
           "reduce_scatter_tree", "shard_leaf", "shard_tree",
           "state_bytes", "train_state_shards", "tree_shard_dims",
           "x_shard_dims", "x_shapes"]

DATA_AXIS = "data"

# the state's fields that are backbone-shaped and head-shaped
_X_FIELDS = ("x", "u", "p_prev", "x_prev")
_Y_FIELDS = ("y", "v", "y_prev")


def _largest_divisible_dim(shape, size: int, skip: tuple[int, ...] = ()):
    """Index of the largest dim divisible by ``size`` (later dims win
    ties), or None."""
    best, best_dim = None, -1
    for i, d in enumerate(shape):
        if i in skip:
            continue
        if d % size == 0 and d >= size and d >= best_dim:
            best, best_dim = i, d
    return best


def leaf_spec(shape, model_size: int, agent_axes: tuple[str, ...] | None = None,
              agent_leading: bool = False,
              extra_axes: tuple[tuple[str, int], ...] = ()) -> tuple:
    """The JAX package's ``PartitionSpec`` for one weight leaf, as a tuple
    of axis names (or None) a dim."""
    entries: list[Any] = [None] * len(shape)
    start = 0
    if agent_leading:
        entries[0] = agent_axes if len(agent_axes) > 1 else agent_axes[0]
        start = 1
    if len(shape) - start >= 2:  # matrices and higher: shard on model
        skip: tuple[int, ...] = ()
        idx = _largest_divisible_dim(shape[start:], model_size)
        if idx is not None:
            entries[start + idx] = "model"
            skip = (idx,)
        for name, size in extra_axes:
            j = _largest_divisible_dim(shape[start:], size, skip=skip)
            if j is not None:
                entries[start + j] = name
                skip = skip + (j,)
    return tuple(entries)


def _dim(shape, pod_size: int) -> int | None:
    """The dim of a (1, ...) leaf the pod's data axis splits, or None."""
    spec = leaf_spec(tuple(shape), 1, ("pod",), agent_leading=True,
                     extra_axes=((DATA_AXIS, pod_size),))
    return spec.index(DATA_AXIS) if DATA_AXIS in spec else None


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple]:
    """The key path of each leaf of a tree of dicts and lists, in leaf
    order: a backbone's leaves keep their paths whatever the order of its
    dicts' keys (a tree carried from the JAX package has them sorted)."""
    if isinstance(tree, dict):
        return [p for key, sub in tree.items()
                for p in leaf_paths(sub, prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, sub in enumerate(tree)
                for p in leaf_paths(sub, prefix + (i,))]
    return [prefix]


def tree_shard_dims(tree, pod_size: int) -> tuple:
    """Per leaf of ``tree`` ((1, ...) leaves, leaf order), its split dim."""
    return tuple(_dim(l.shape, pod_size) for l in pytree.tree_leaves(tree))


def x_shard_dims(x: dict, pod_size: int) -> tuple:
    """Per leaf of a backbone tree (leaf order), its split dim: the
    ``layers`` by the rule, every other key whole."""
    dims = []
    for key, sub in x.items():
        n = len(pytree.tree_leaves(sub))
        dims += (tree_shard_dims(sub, pod_size) if key == "layers"
                 else (None,) * n)
    return tuple(dims)


def head_shard_dim(y, pod_size: int) -> int | None:
    return _dim(y.shape, pod_size)


def x_shapes(cfg) -> tuple[dict, tuple]:
    """The (1, ...) shapes of ``cfg``'s backbone tree and head, from a
    shape-only init (no storage): ``(x, y)`` with ``x`` a tree of fake
    tensors, for ``x_shard_dims`` and the whole shapes of the leaves."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import model as M
    with FakeTensorMode():
        params = M.init_params(cfg, 0, with_head=True, device="cpu")
        y = params.pop("head")[None]
        x = pytree.tree_map(lambda l: l[None], params)
    return x, y


def shard_leaf(leaf: torch.Tensor, dim: int | None, pod_size: int,
               index: int) -> torch.Tensor:
    """Chunk ``index`` of ``pod_size`` along ``dim`` (a contiguous copy),
    or the leaf itself where ``dim`` is None."""
    if dim is None:
        return leaf
    n = leaf.shape[dim]
    if n % pod_size:
        raise ValueError(f"dim {dim} of a {tuple(leaf.shape)} leaf does not "
                         f"split over a pod of {pod_size}")
    c = n // pod_size
    return leaf.narrow(dim, index * c, c).contiguous()


def shard_tree(tree, dims, pod_size: int, index: int):
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(
        [shard_leaf(l, d, pod_size, index) for l, d in zip(leaves, dims,
                                                             strict=True)],
        spec)


def _wire_dtype(leaves) -> torch.dtype:
    """The leaves' dtype where they share one, else float32."""
    dtypes = {l.dtype for l in leaves}
    return dtypes.pop() if len(dtypes) == 1 else torch.float32


def gather_tree(tree, dims, pod):
    """The whole leaves of a tree of shards, on every rank of ``pod`` (an
    ``AgentMesh`` of the pod's ranks): the shards laid end to end, one
    all-gather (float32 where the leaves' dtypes differ); whole leaves
    pass as they are."""
    leaves, spec = pytree.tree_flatten(tree)
    split = [i for i, d in enumerate(dims) if d is not None]
    if not split:
        return tree
    wire = _wire_dtype([leaves[i] for i in split])
    flat = torch.cat([leaves[i].reshape(-1).to(wire) for i in split])
    table = pod.all_gather(flat[None])              # (k, total)
    out, at = list(leaves), 0
    for i in split:
        shard = leaves[i]
        n = shard.numel()
        parts = [table[r, at:at + n].reshape(shard.shape)
                 for r in range(table.shape[0])]
        out[i] = torch.cat(parts, dim=dims[i]).to(shard.dtype)
        at += n
    return pytree.tree_unflatten(out, spec)


def reduce_scatter_tree(tree, dims, pod):
    """Each rank's chunk of the pod's mean of a tree of whole leaves
    (summed in float32, each leaf back in its dtype): the split leaves'
    chunks in one reduce-scatter, the whole leaves in one all-reduce."""
    leaves, spec = pytree.tree_flatten(tree)
    k = pod.world_size
    out = list(leaves)
    split = [i for i, d in enumerate(dims) if d is not None]
    whole = [i for i, d in enumerate(dims) if d is None]
    if split:
        wire = _wire_dtype([leaves[i] for i in split])
        rows = torch.stack([torch.cat([
            leaves[i].narrow(dims[i], r * (leaves[i].shape[dims[i]] // k),
                             leaves[i].shape[dims[i]] // k).reshape(-1)
            .to(wire) for i in split]) for r in range(k)])
        mine = pod.reduce_scatter_mean(rows)
        del rows
        at = 0
        for i in split:
            shape = list(leaves[i].shape)
            shape[dims[i]] //= k
            n = int(torch.Size(shape).numel())
            out[i] = mine[at:at + n].reshape(shape).to(leaves[i].dtype)
            at += n
    if whole:
        flat = torch.cat([leaves[i].reshape(-1).to(torch.float32)
                          for i in whole])
        flat = pod.all_reduce(flat).div_(k)
        at = 0
        for i in whole:
            n = leaves[i].numel()
            out[i] = flat[at:at + n].reshape(leaves[i].shape).to(
                leaves[i].dtype)
            at += n
    return pytree.tree_unflatten(out, spec)


def train_state_shards(state, pod_size: int, index: int):
    """Rank ``index``'s shards of a whole ``TrainState`` or
    ``SvrTrainState`` of one agent ((1, ...) leaves): the backbone-shaped
    fields by the backbone's rule, the head-shaped ones by the head's,
    ``t`` as it is.  The counterpart of ``train_state_specs``."""
    xd = x_shard_dims(state.x, pod_size)
    yd = (head_shard_dim(state.y, pod_size),)
    fields = {}
    for name in state._fields:
        value = getattr(state, name)
        if name in _X_FIELDS:
            value = shard_tree(value, xd, pod_size, index)
        elif name in _Y_FIELDS:
            value = shard_tree(value, yd, pod_size, index)
        fields[name] = value
    return type(state)(**fields)


def state_bytes(state) -> int:
    """The bytes of a state's tensors."""
    return sum(l.numel() * l.element_size()
               for l in pytree.tree_leaves(state)
               if isinstance(l, torch.Tensor))
