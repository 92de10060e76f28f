"""The ConsensusEngine API: one pluggable backend behind Steps 1 and 3.

Counterpart of ``repro.consensus.engine``.  The paper's communication
result rests on the consensus combine ``x_i <- sum_j M_ij x_j`` (eqs.
6/10):

    engine.mix(tree, matrix=None) -> tree
        The bare combine on every (m, ...) leaf; ``matrix`` overrides
        the engine's fixed matrix for this call.

    engine.step1_step3(x, u, p, p_prev, alpha, *, t=None, ef=None,
                       matrix=None) -> (x_new, u_new[, ef_new])
            x_new = mix(x) - alpha * u          (Step 1, eq. 6)
            u_new = mix(u) + (p - p_prev)       (Step 3, eq. 10)
        The base class composes two ``mix`` calls (two ``mix_ef`` calls
        on the wire path, where it also returns the new wire state); the
        ``cuda`` backend runs the full-precision pair in one fused
        kernel launch.

    engine.mix_ef(tree, ef, t) -> (tree, ef)
        The wire-aware combine: each agent sends the compressed
        innovation against its public copy (CHOCO), under the warm-up
        schedule and the communication interval.

    engine.bytes_on_wire(tree) -> int
        Wire bytes ONE agent ships for ONE combine of a per-agent
        payload shaped like ``tree`` (no agent dim).

Wire options (every backend): ``compression``, a ``CompressionConfig``,
and ``communication_interval = k``, which mixes only on steps with ``t %
k == 0``.  The step index t is a host int here, so the port computes
only what the step's schedule selects: a warm-up step sends the raw
innovation without compressing it, a step between rounds mixes nothing
and launches nothing (the reference computes both sides of each
``jnp.where``).  A captured step is captured once for each schedule
(``wire_schedule``).

A time-varying topology (``repro_torch.topology.attach_topology``) sits
on ``engine.topology`` and gives each round its matrix
(``topology_matrix``).  A realized stream is copied into a static round
buffer by ``load_round(t)`` before the step runs (a CUDA graph replays
with the buffer's address; the stepper loads it before each replay);
the adaptive process computes its matrix on the device from the
iterates.  An engine with ``engine.ledger`` set (``attach_ledger``)
records the wire template of every stream it mixes.

Byzantine options (``byzantine``, a ``ByzantineConfig``) ride the wire
path: ``mix_ef`` notes the ledger, corrupts the attacking slots' payload
(``_attack_payload``), compresses it, and combines it with the
configured rule (``_combine``: ``mix`` for ``weighted``, else
``robust_combine`` over the round matrix's support).  A noisy attack's
round noise sits in static buffers that ``load_round(t)`` refills, like
a topology stream's round buffer.

Backends: ``dense`` (the (m, m) matmul reference), ``cuda`` (the
hand-written Hopper kernels) and, across the processes of a
``torch.distributed`` group (an ``AgentMesh``), ``allgather`` (each
process gathers every agent's payload and mixes its own rows with the
row-block kernels) and ``ppermute`` (one agent a process, per-offset
permute rounds).  A mesh backend's leaves carry the process's own k
agents (``local_rows``), and every process calls each combine in
lockstep.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.byzantine import (AttackSchedule, ByzantineConfig,
                                   apply_attack, robust_combine)
from repro_torch.consensus.compress import CompressionConfig, make_compressor
from repro_torch.consensus.ledger import StreamRecord

__all__ = ["BACKENDS", "ConsensusEngine", "MeshBackendMixin",
           "consensus_descent_and_track", "make_engine", "register_backend"]


def _f32(leaf):
    return leaf.to(torch.float32)


class ConsensusEngine:
    """Base class: a consensus combine plus the fused Step-1/3 pair."""

    name = "base"

    # time-varying topology runtime, installed by ``attach_topology``;
    # None is the fixed-matrix path
    topology = None
    # the realized stream behind it, for accounting (``stream_of``)
    topology_stream = None
    # measured-communication ledger, installed by ``attach_ledger``
    ledger = None
    # the attack's mask and noise buffers (None without an attack)
    attack_schedule = None
    # active agents of a ghost-padded network, set on each experiment's
    # engine in a padded sweep group (whose attack masks,
    # ``GroupAttackSchedule``, never pick a slot from here on); None: all m
    num_active = None
    # (row0, k): the agents this process holds on a mesh backend; None:
    # all m (a single-process backend)
    local_rows = None

    def _configure_wire(self, compression: CompressionConfig | None = None,
                        communication_interval: int = 1,
                        byzantine: ByzantineConfig | None = None,
                        attack_seed: int = 0) -> None:
        """Install the wire options (call from ``__init__``, after
        ``self.matrix``): the compressor, the mix cadence and the
        Byzantine configuration, validated against m.  The attack draws
        from ``byzantine.resolve_seed(attack_seed)``."""
        self.compression = compression or CompressionConfig()
        self.compressor = make_compressor(self.compression)
        self.communication_interval = int(communication_interval)
        if self.communication_interval < 1:
            raise ValueError("communication_interval must be >= 1, got "
                             f"{communication_interval}")
        if not 0.0 < self.compression.gamma <= 1.0:
            raise ValueError("compression.gamma must be in (0, 1], got "
                             f"{self.compression.gamma}")
        self.byzantine = byzantine or ByzantineConfig()
        m = int(self.matrix.shape[0])
        self.byzantine.validate_for(m)
        if self.byzantine.attack_active:
            self.attack_schedule = AttackSchedule(
                self.byzantine, m, self.byzantine.resolve_seed(attack_seed),
                self.matrix.device)

    @property
    def wire_active(self) -> bool:
        """Does this engine need the (t, ef) wire path at all?  Attacks
        and robust rules live in ``mix_ef`` too, which also takes the
        ``cuda`` backend off its fused step."""
        return (self.compression.active
                or self.communication_interval != 1
                or self.byzantine.active)

    def wire_schedule(self, t: int) -> tuple[bool, bool]:
        """``(warm-up, mixes)`` of the step from ``t``: whether it sends
        uncompressed and whether it mixes at all (a silent step is never
        a warm-up one).  The step computes only what these select, so a
        captured step is captured once for each value."""
        mixes = t % self.communication_interval == 0
        warm = (mixes and self.compression.active
                and t < self.compression.compress_after)
        return warm, mixes

    def mix(self, tree, *, matrix=None):
        """Apply ``x_i <- sum_j M_ij x_j`` to every leaf of ``tree``."""
        raise NotImplementedError

    # -- the round's matrix -------------------------------------------------

    def load_round(self, t: int) -> None:
        """Make the step from ``t``'s matrix and attack noise current: a
        realized stream copies ``stream[t % T]`` into its round buffer, a
        noisy attack draws step t's noise into its buffers.  Called
        outside any capture, before the step runs or its graph
        replays."""
        if self.topology is not None:
            self.topology.load(t)
        if self.attack_schedule is not None:
            self.attack_schedule.load(t)

    def prefetch_rounds(self, t: int, num_steps: int) -> None:
        """Draw the attack noise of steps ``t .. t + num_steps - 1`` ahead,
        so ``load_round`` copies it on the device without waiting (a
        no-op without a noisy attack)."""
        if self.attack_schedule is not None:
            self.attack_schedule.prefetch(t, num_steps)

    def topology_matrix(self, t, tree=None):
        """The round's mixing-matrix override, or None on the fixed path
        (the adaptive process reads the iterates ``tree``)."""
        if self.topology is None:
            return None
        if t is None:
            raise ValueError(
                "a time-varying topology needs the step index: pass t= "
                "to mix_ef / step1_step3 (or pass matrix=)")
        return self.topology.matrix_at(t, tree)

    # -- measured wire accounting ---------------------------------------

    def _ledger_note(self, stream: str, tree) -> None:
        """Record ``stream``'s per-round wire template on the ledger (a
        no-op without one): one concatenated per-agent buffer a round,
        exactly what ``bytes_on_wire`` prices."""
        led = self.ledger
        if led is None:
            return
        leaves = pytree.tree_leaves(tree)
        m = int(leaves[0].shape[0]) if leaves[0].dim() else 1
        size = sum(int(l.numel()) for l in leaves) // max(1, m)
        led.note(stream, StreamRecord(
            op=self.name, entries=size,
            wire_bytes=int(self.compressor.bytes_on_wire(size)),
            full_bytes=4 * size, collectives=1))

    # -- Byzantine layer: payload corruption, robust aggregation ----------

    def _attack_payload(self, tree, t, stream: str):
        """The payload the agents ship on ``stream`` at step ``t``: the
        Byzantine slots' rows corrupted, honest rows bit for bit (the
        tree itself without an attack on this stream)."""
        sched = self.attack_schedule
        if sched is None or stream not in sched.attack.streams:
            return tree
        leaves = pytree.tree_leaves(tree)
        size = sum(int(l.numel()) for l in leaves) // int(leaves[0].shape[0])
        noise = sched.noise(stream, self._require_t(t), size)
        return apply_attack(sched.attack, tree, sched.mask, noise,
                            sched.scale)

    def _combine(self, tree, *, matrix=None):
        """The configured aggregation: ``mix`` for ``weighted``, else the
        robust rule over the support of the round's matrix."""
        rule = self.byzantine.combine
        if rule == "weighted":
            return self.mix(tree, matrix=matrix)
        return robust_combine(self.matrix if matrix is None else matrix,
                              tree, rule, self.byzantine.resolve_trim())

    # -- the wire path: compression, warm-up, interval ---------------------

    def _self_weights(self, matrix=None) -> torch.Tensor:
        """Per-agent self weights M[i, i]."""
        mat = self.matrix if matrix is None else matrix
        return torch.diagonal(mat).to(torch.float32)

    def _damp(self, mixed, tree):
        """CHOCO consensus step size: ``x + gamma * (mixed - x)``."""
        g = self.compression.gamma
        if g == 1.0:
            return mixed
        return pytree.tree_map(
            lambda mx, xx: (g * _f32(mx) + (1.0 - g) * _f32(xx)
                            ).to(mx.dtype), mixed, tree)

    @staticmethod
    def _require_t(t) -> int:
        if t is None:
            raise ValueError(
                "the warm-up schedule / communication interval need the "
                "step index: pass t= to mix_ef / step1_step3")
        return int(t)

    def _skips(self, t) -> bool:
        """Whether the step from ``t`` mixes nothing (between rounds)."""
        k = self.communication_interval
        return k != 1 and self._require_t(t) % k != 0

    def _compress_payload(self, tree, ef, t):
        """``(payload_tree, ef_new)``: each agent's leaves concatenated
        into one row of an (m, D) float32 buffer and compressed row by
        row.

        With wire state ``ef = {"e", "ref"}`` the agent sends ``c = C(x -
        ref)`` and every receiver reconstructs ``payload = ref + c``;
        ``ef_new`` holds the residual ``(x - ref) - c`` and the advanced
        public copy.  With ``ef=None``, ``payload = C(x)``.  A warm-up
        step sends ``x - ref`` as it is.
        """
        leaves, spec = pytree.tree_flatten(tree)
        m = leaves[0].shape[0]
        sizes = [int(l.numel()) // m for l in leaves]
        concat = lambda tr: torch.cat(
            [_f32(l).reshape(m, -1) for l in pytree.tree_leaves(tr)], dim=1)

        def split(buf, cast: bool):
            parts = torch.split(buf, sizes, dim=1)
            return pytree.tree_unflatten(
                [p.reshape(l.shape).to(l.dtype) if cast
                 else p.reshape(l.shape) for p, l in zip(parts, leaves)],
                spec)

        buf = concat(tree)
        ref = None if ef is None else concat(ef["ref"])
        v = buf if ref is None else buf - ref
        warm, _ = self.wire_schedule(self._require_t(t))
        c = v if warm else self.compressor.encode_decode(v)
        if ref is None:
            return split(c, cast=True), None
        payload = ref + c
        return split(payload, cast=True), {"e": split(v - c, cast=False),
                                           "ref": split(payload, cast=False)}

    def mix_ef(self, tree, ef=None, t=None, *, matrix=None,
               stream: str = "x"):
        """The wire-aware combine: ``(mixed, ef_new)``.

        ``ef`` is this stream's wire state ``{"e", "ref"}`` (``None``
        without error feedback).  In the reference's order: the ledger
        notes the stream, the Byzantine slots corrupt what they ship
        (``stream`` names it for stream-selective attacks), the payload
        is compressed, and receivers combine the reconstructed payload
        under the configured rule.  Under ``weighted`` the agent's own
        term mixes its clean value, ``mix(payload) + M_ii (x -
        payload)``; then ``gamma`` damps.  On a step between rounds
        nothing is sent: the local values stand and the wire state stays
        (the reference attacks there and discards the result).
        ``matrix`` (or the attached topology's round matrix for ``t``)
        overrides the fixed matrix.  With no wire options this is
        ``(mix(tree), ef)``.
        """
        self._ledger_note(stream, tree)
        if self._skips(t):
            return tree, ef
        if matrix is None:
            matrix = self.topology_matrix(t, tree)
        sent = self._attack_payload(tree, t, stream)
        if not self.compression.active:
            return self._combine(sent, matrix=matrix), ef
        payload, ef_new = self._compress_payload(sent, ef, t)
        mixed = self._combine(payload, matrix=matrix)
        if self.byzantine.combine == "weighted":
            d = self._self_weights(matrix)
            mixed = pytree.tree_map(
                lambda mx, xx, cc: (
                    _f32(mx) + d.reshape((-1,) + (1,) * (mx.dim() - 1))
                    * (_f32(xx) - _f32(cc))).to(mx.dtype),
                mixed, tree, payload)
        return self._damp(mixed, tree), ef_new

    def bytes_on_wire(self, tree) -> int:
        """Wire bytes ONE agent ships for ONE combine of the per-agent
        payload ``tree`` (no agent dim), schedule not folded in (see
        ``cumulative_wire_bytes``)."""
        size = sum(int(l.numel()) for l in pytree.tree_leaves(tree))
        return self.compressor.bytes_on_wire(size)

    def step1_step3(self, x, u, p, p_prev, alpha, *, t=None, ef=None,
                    matrix=None):
        """Fused eq. (6) + eq. (10); ``alpha`` a float or a 0-dim tensor.

        Returns ``(x_new, u_new)`` on the full-precision path (``ef is
        None`` and no wire options), ``(x_new, u_new, ef_new)`` on the
        wire path, where ``ef`` is ``{"x": {"e", "ref"}, "u": {...}}`` or
        ``None``.  One matrix serves both mixes; the adaptive topology
        computes it from the pre-mix x.

        Math runs in float32 and is cast back to the leaf dtype.  The
        tracking term is grouped as ``mix(u) + (p - p_prev)``, so calling
        with ``p is p_prev`` yields ``mix(u)`` exactly.
        """
        wire = ef is not None or self.wire_active
        if matrix is None and not self._skips(t):
            matrix = self.topology_matrix(t, x)
        if wire:
            x_mixed, ef_x = self.mix_ef(
                x, None if ef is None else ef.get("x"), t, matrix=matrix,
                stream="x")
            u_mixed, ef_u = self.mix_ef(
                u, None if ef is None else ef.get("u"), t, matrix=matrix,
                stream="u")
        else:
            self._ledger_note("x", x)
            self._ledger_note("u", u)
            x_mixed = self.mix(x, matrix=matrix)
            u_mixed = self.mix(u, matrix=matrix)
        x_new = pytree.tree_map(
            lambda mx, uu: (_f32(mx) - alpha * _f32(uu)).to(mx.dtype),
            x_mixed, u)
        u_new = pytree.tree_map(
            lambda mu, pn, pp: (_f32(mu) + (_f32(pn) - _f32(pp))).to(mu.dtype),
            u_mixed, p, p_prev)
        if not wire:
            return x_new, u_new
        # keys sorted, like ``init_ef``'s
        ef_new = None if ef is None else {"u": ef_u, "x": ef_x}
        return x_new, u_new, ef_new


class MeshBackendMixin:
    """Shared by the backends whose agents are spread over processes.

    Requires ``self.mesh`` (an ``AgentMesh``) and the wire attributes of
    ``_configure_wire``.  A process's leaves carry its own k agents, the
    global slots ``row0 .. row0 + k - 1``: the self weights of the wire
    path and the Byzantine mask and noise are sliced to them, so an
    attacked local slice is bit for bit the dense engine's rows (the
    mask and the noise rows are per slot and do not depend on m).
    """

    mesh = None

    @property
    def local_rows(self) -> tuple[int, int]:
        return self.mesh.row0, self.mesh.local_agents

    def _local_slots(self, full: torch.Tensor) -> torch.Tensor:
        """This process's rows of an (m, ...) tensor."""
        row0, k = self.local_rows
        return full[row0:row0 + k]

    def _self_weights(self, matrix=None) -> torch.Tensor:
        return self._local_slots(super()._self_weights(matrix))

    def _attack_payload(self, tree, t, stream: str):
        return self._attack_local(tree, t, stream)

    def _attack_local(self, tree, t, stream: str):
        """The local-slice form of ``_attack_payload``: the global slots'
        mask rows and noise rows (a shared noise row as it is)."""
        sched = self.attack_schedule
        if sched is None or stream not in sched.attack.streams:
            return tree
        leaves = pytree.tree_leaves(tree)
        size = sum(int(l.numel()) for l in leaves) // int(leaves[0].shape[0])
        noise = sched.noise(stream, self._require_t(t), size)
        if noise is not None and sched.attack.noise == "slot":
            noise = self._local_slots(noise)
        return apply_attack(sched.attack, tree, self._local_slots(sched.mask),
                            noise, sched.scale)


def check_mesh(mesh, num_agents: int, device: torch.device | str):
    """``mesh``, an ``AgentMesh`` of ``num_agents`` agents with its rows on
    ``device``; raises otherwise."""
    if mesh is None:
        raise ValueError(
            "a mesh backend needs the process's AgentMesh: pass mesh= "
            "(backend_opts={'mesh': repro_torch.launch.distributed."
            "agent_mesh(m)})")
    if mesh.num_agents != num_agents:
        raise ValueError(f"the mixing matrix is {num_agents} x {num_agents} "
                         f"but the mesh holds {mesh.num_agents} agents")
    if torch.device(device) != mesh.device:
        raise ValueError(f"the mesh's rows live on {mesh.device}, not on "
                         f"{torch.device(device)}")
    return mesh


def as_matrix(mixing, device: torch.device | str) -> torch.Tensor:
    """A backend's mixing matrix as a float32 tensor on ``device``:
    ``mixing`` is a ``MixingSpec``, a numpy matrix, or a tensor (kept as
    it is when already float32 there, so a batched one stays batched)."""
    mat = getattr(mixing, "matrix", mixing)
    if isinstance(mat, torch.Tensor):
        return mat.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(mat), dtype=torch.float32,
                           device=device)


def consensus_descent_and_track(engine: ConsensusEngine, x, y, u, v, p_prev,
                                alpha, beta, grads_fn: Callable, *, t=None,
                                ef=None):
    """One INTERACT iteration skeleton.

      Step 1: x_new = mix(x) - alpha u ;  y_new = y - beta v
      Step 2: (p_new, v_new, aux) = grads_fn(x_new, y_new)
      Step 3: u_new = mix(u) + p_new - p_prev

    Both mixes go through one ``engine.step1_step3`` call (with
    ``p = p_prev`` its tracking term vanishes and it returns
    ``(x_new, mix(u))``), so the ``cuda`` backend runs them in a single
    kernel launch on the full-precision path; the tracking correction is
    applied once the new local gradients exist.  ``t`` (the step index)
    and ``ef`` (the wire state, or ``None``) drive the engine's wire path.
    Returns ``(x_new, y_new, u_new, v_new, p_new, ef_new, aux)``.
    """
    if ef is not None or engine.wire_active:
        x_new, u_mixed, ef_new = engine.step1_step3(
            x, u, p_prev, p_prev, alpha, t=t, ef=ef)
    else:
        x_new, u_mixed = engine.step1_step3(x, u, p_prev, p_prev, alpha, t=t)
        ef_new = ef
    y_new = pytree.tree_map(
        lambda yy, vv: (_f32(yy) - beta * _f32(vv)).to(yy.dtype), y, v)

    p_new, v_new, aux = grads_fn(x_new, y_new)

    u_new = pytree.tree_map(
        lambda mu, pn, pp: (_f32(mu) + (_f32(pn) - _f32(pp))).to(mu.dtype),
        u_mixed, p_new, p_prev)
    return x_new, y_new, u_new, v_new, p_new, ef_new, aux


# Backend registry: name -> factory(mixing, device, **opts).
BACKENDS: dict[str, Callable] = {}


def register_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a consensus-backend factory under ``name``."""

    def deco(factory: Callable) -> Callable:
        existing = BACKENDS.get(name)
        if existing is not None and existing is not factory:
            raise ValueError(f"consensus backend {name!r} already "
                             f"registered ({existing!r})")
        BACKENDS[name] = factory
        return factory

    return deco


@register_backend("dense")
def _make_dense(mixing, device, **opts):
    from repro_torch.consensus.dense import DenseEngine
    return DenseEngine(mixing, device, **opts)


@register_backend("cuda")
def _make_cuda(mixing, device, **opts):
    from repro_torch.consensus.cuda import CudaEngine
    return CudaEngine(mixing, device, **opts)


# The mesh backends load their modules (and the collectives) only when
# asked for, as the JAX package's do.
@register_backend("allgather")
def _make_allgather(mixing, device, **opts):
    from repro_torch.consensus.allgather import AllGatherEngine
    return AllGatherEngine(mixing, device, **opts)


@register_backend("ppermute")
def _make_ppermute(mixing, device, **opts):
    from repro_torch.consensus.ppermute import PermuteEngine
    return PermuteEngine(mixing, device, **opts)


def make_engine(backend: str, mixing, device: torch.device | str,
                **opts) -> ConsensusEngine:
    """Build a consensus backend by name on ``device``.

    ``mixing`` is a ``MixingSpec``, a raw (m, m) numpy matrix or a float32
    tensor (under ``vmap``, one per experiment); every backend accepts the
    wire options ``compression``, ``communication_interval``,
    ``byzantine`` and ``attack_seed``.  The mesh backends take ``mesh``
    (this process's ``AgentMesh``), and ``ppermute`` also ``compress``,
    ``dp_sigma`` and ``impl``.
    """
    try:
        factory = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown consensus backend {backend!r}; "
            f"choose from {sorted(BACKENDS)}") from None
    return factory(mixing, device, **opts)
