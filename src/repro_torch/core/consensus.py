"""Network topologies and consensus (mixing) matrices.

Counterpart of ``repro.core.consensus``.  The constructors are numpy, kept
line for line with the JAX package's, so the port's mixing matrices are
bit-equal to the reference's for the same arguments.  Only
``mix_pytree`` touches torch.

The peer-to-peer network is a graph with a doubly-stochastic, symmetric
mixing matrix M whose sparsity follows the edges (paper Section 4.1).
lambda = max{|lambda_2|, |lambda_m|} governs the admissible step sizes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "MixingSpec",
    "erdos_renyi_adjacency",
    "laplacian_mixing",
    "metropolis_mixing",
    "mix_pytree",
    "pad_mixing",
    "ring_mixing",
    "second_eigenvalue",
    "torus_adjacency",
    "torus_mixing",
    "validate_mixing",
]


@dataclasses.dataclass(frozen=True)
class MixingSpec:
    """A mixing matrix together with the quantities the theory needs.

    Attributes:
      matrix:  (m, m) doubly-stochastic symmetric mixing matrix (numpy).
      lam:     second-largest eigenvalue magnitude (the paper's lambda).
      neighbors: for ring topologies, the neighbour offsets (empty for
        dense matrices).
      weights: per-offset weights aligned with ``neighbors``.
    """

    matrix: np.ndarray
    lam: float
    neighbors: tuple[int, ...] = ()
    weights: tuple[float, ...] = ()

    @property
    def num_agents(self) -> int:
        return int(self.matrix.shape[0])


def erdos_renyi_adjacency(m: int, p_connect: float, seed: int) -> np.ndarray:
    """Sample a connected Erdos-Renyi graph adjacency matrix.

    Re-samples until connected; a ring fallback edge set guarantees
    termination for very small ``p_connect``.
    """
    rng = np.random.default_rng(seed)
    for _ in range(512):
        upper = rng.random((m, m)) < p_connect
        adj = np.triu(upper, k=1)
        adj = (adj | adj.T).astype(np.float64)
        if _is_connected(adj):
            return adj
    adj = np.triu(rng.random((m, m)) < p_connect, k=1)
    adj = (adj | adj.T).astype(np.float64)
    for i in range(m):
        adj[i, (i + 1) % m] = 1.0
        adj[(i + 1) % m, i] = 1.0
    np.fill_diagonal(adj, 0.0)
    return adj


def _is_connected(adj: np.ndarray) -> bool:
    m = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in np.nonzero(adj[i])[0]:
            if j not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == m


def laplacian_mixing(adj: np.ndarray) -> MixingSpec:
    """The paper's Section-6 mixing matrix: W = I - 2L / (3 lambda_max(L))."""
    deg = np.diag(adj.sum(axis=1))
    lap = deg - adj
    lam_max = float(np.linalg.eigvalsh(lap)[-1])
    mat = np.eye(adj.shape[0]) - 2.0 * lap / (3.0 * lam_max)
    return MixingSpec(matrix=mat, lam=second_eigenvalue(mat))


def metropolis_mixing(adj: np.ndarray) -> MixingSpec:
    """Metropolis-Hastings weights: doubly stochastic for any graph."""
    m = adj.shape[0]
    deg = adj.sum(axis=1)
    mat = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if i != j and adj[i, j] > 0:
                mat[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        mat[i, i] = 1.0 - mat[i].sum()
    return MixingSpec(matrix=mat, lam=second_eigenvalue(mat))


def ring_mixing(m: int, self_weight: float = 1.0 / 3.0) -> MixingSpec:
    """Doubly-stochastic symmetric ring (eigenvalues w0 + 2 w1 cos(2 pi k/m))."""
    if m < 1:
        raise ValueError("need at least one agent")
    w1 = (1.0 - self_weight) / 2.0
    mat = np.zeros((m, m))
    for i in range(m):
        mat[i, i] = self_weight
        mat[i, (i - 1) % m] += w1
        mat[i, (i + 1) % m] += w1
    if m == 1:
        mat[:] = 1.0
    return MixingSpec(
        matrix=mat,
        lam=second_eigenvalue(mat),
        neighbors=(-1, 1) if m > 1 else (),
        weights=(w1, w1) if m > 1 else (),
    )


def torus_adjacency(rows: int, cols: int) -> np.ndarray:
    """2-D torus adjacency: each agent links to its 4 grid neighbours."""
    m = rows * cols
    adj = np.zeros((m, m))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if j != i:
                    adj[i, j] = 1.0
    return adj


def torus_mixing(rows: int, cols: int) -> MixingSpec:
    """Doubly-stochastic symmetric torus mixing (Metropolis weights)."""
    return metropolis_mixing(torus_adjacency(rows, cols))


def pad_mixing(mixing, pad_to: int) -> np.ndarray:
    """Pad a mixing matrix to ``pad_to`` agents with ghost self-loops.

    Ghost agents (rows and columns from the original m on) get identity
    rows: they mix only with themselves and no active row puts weight on
    them.  The padded matrix stays doubly stochastic and symmetric, every
    active agent's combine gains only exact ``0.0 * x_ghost`` terms, and
    ghost agents are fixed points of the combine, which is what lets a
    padded sweep group run networks of several sizes as one batch.

    ``mixing`` is a ``MixingSpec`` or a raw (m, m) matrix; returns the
    (pad_to, pad_to) padded matrix (a copy; the input is untouched).
    """
    mat = (mixing.matrix if isinstance(mixing, MixingSpec)
           else np.asarray(mixing))
    m = mat.shape[0]
    if pad_to < m:
        raise ValueError(f"cannot pad {m} agents down to {pad_to}")
    out = np.eye(pad_to, dtype=mat.dtype)
    out[:m, :m] = mat
    return out


def second_eigenvalue(mat: np.ndarray) -> float:
    """lambda = max{|lambda_2|, |lambda_m|} of a symmetric stochastic M."""
    eig = np.sort(np.linalg.eigvalsh(mat))
    if eig.shape[0] == 1:
        return 0.0
    return float(max(abs(eig[0]), abs(eig[-2])))


def validate_mixing(mat: np.ndarray, adj: np.ndarray | None = None,
                    atol: float = 1e-8) -> None:
    """Raise unless ``mat`` has the Section-4.1 properties: (a) doubly
    stochastic, (b) symmetric, (c) weight only on the edges of ``adj``."""
    ones = np.ones(mat.shape[0])
    if not np.allclose(mat @ ones, ones, atol=atol):
        raise ValueError("rows do not sum to 1")
    if not np.allclose(mat.T @ ones, ones, atol=atol):
        raise ValueError("columns do not sum to 1")
    if not np.allclose(mat, mat.T, atol=atol):
        raise ValueError("matrix not symmetric")
    if adj is not None:
        off = ~np.eye(mat.shape[0], dtype=bool)
        if np.any((np.abs(mat) > atol) & off & (adj <= 0)):
            raise ValueError("nonzero weight on a non-edge")


def mix_pytree(matrix: torch.Tensor, tree):
    """The combine ``x_i <- sum_j M_ij x_j`` on every (m, ...) leaf.

    ``matrix`` is float32; each leaf is mixed in float32 and cast back to
    its own dtype, as the JAX reference's f32 matrix promotes it.
    """
    def combine(leaf):
        out = torch.tensordot(matrix, leaf.to(matrix.dtype), dims=([1], [0]))
        return out.to(leaf.dtype)

    return pytree.tree_map(combine, tree)
