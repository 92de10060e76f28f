"""Process meshes over the ``torch.distributed`` world.

Counterpart of ``repro.launch.mesh``.  There a mesh lays JAX devices out
on named axes; here it lays the ranks of the process group out the same
way, row-major as ``jax.make_mesh`` lays devices: on a ``("pod", "data",
"model")`` mesh of shape (m, k, t) the process at (pod p, data d, model
j) is rank ``(p * k + d) * t + j``.

Single pod:  (16, 16)      axes ("data", "model")
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")

``shape=`` overrides the fixed pod shapes for anything smaller, as in
the JAX package; axis names default by rank.  The shape and axis-name
checks and their messages are the JAX package's; a world with fewer
processes than the shape needs fails hard, as a device shortfall does
there.

The paper's agents are the rows of ``agent_axes`` (``agent_mode="rows"``)
or the pods (``agent_mode="pods"``: each agent is a pod of k processes,
its state sharded over the pod's ``data`` axis, see
``repro_torch.sharding.partition``).  A ``model`` axis larger than 1
(tensor parallelism) is described here but run by nothing: the pods
layout refuses it (``repro_torch.launch.distributed.pods_mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["ProcessMesh", "agent_axes", "agent_count",
           "make_production_mesh", "model_axis"]

_DEFAULT_AXES = {1: ("data",), 2: ("data", "model"),
                 3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """Named axes over ranks ``0 .. size - 1``, laid out row-major.

    ``shape`` maps each axis name to its size, as a JAX mesh's does.
    """

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    def coords(self, rank: int) -> dict[str, int]:
        """The axis indices of ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in the mesh {self.dims}")
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(rank, self.dims))))

    def rank_of(self, **coords: int) -> int:
        """The rank at the given axis indices (every axis named)."""
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names), self.dims))


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Sequence[int] | None = None,
                         axis_names: Sequence[str] | None = None,
                         world_size: int | None = None) -> ProcessMesh:
    """Build the process mesh, hard-failing on a process shortfall.

    Without ``shape`` this is the fixed 256-process pod (512 with
    ``multi_pod``).  ``shape`` overrides it with any validated shape
    (rank 1-3, positive dims); ``axis_names`` must match its rank and
    defaults to the rank's conventional names.  ``world_size`` defaults
    to the initialised group's (1 without one); the mesh takes its first
    ``prod(shape)`` ranks, as the JAX mesh takes the first devices.
    """
    if shape is None:
        if axis_names is not None:
            raise ValueError("axis_names= requires an explicit shape=")
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    else:
        if multi_pod:
            raise ValueError("pass either multi_pod=True or shape=, not both")
        shape = tuple(int(s) for s in shape)
        if not shape or any(s < 1 for s in shape):
            raise ValueError(f"mesh shape must be positive dims, got {shape}")
        if axis_names is None:
            axes = _DEFAULT_AXES.get(len(shape))
            if axes is None:
                raise ValueError(
                    f"no default axis names for a rank-{len(shape)} mesh; "
                    "pass axis_names=")
        else:
            axes = tuple(axis_names)
            if len(axes) != len(shape):
                raise ValueError(
                    f"axis_names {axes} does not match mesh shape {shape}")
    need = int(np.prod(shape))
    world = _world_size() if world_size is None else int(world_size)
    if world < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} processes, found {world}: launch "
            f"{need} processes (repro_torch.launch.launch_local."
            "launch_workers) or pass a smaller shape=")
    return ProcessMesh(tuple(axes), tuple(shape))


def agent_axes(mesh: ProcessMesh) -> tuple[str, ...]:
    """Mesh axes that together form the paper's agent ring."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def agent_count(mesh: ProcessMesh) -> int:
    n = 1
    for ax in agent_axes(mesh):
        n *= mesh.shape[ax]
    return n


def model_axis(mesh: ProcessMesh) -> str:
    return "model"
