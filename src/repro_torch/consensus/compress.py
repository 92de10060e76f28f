"""Compressed consensus with error feedback: the wire layer.

Counterpart of ``repro.consensus.compress``.  A ``Compressor`` simulates
one wire format by value (the *decoded* payload flows through the math)
and prices it in bytes analytically; ``CompressionConfig`` is what every
consensus backend carries:

    compressor = make_compressor(CompressionConfig(kind="sign1bit"))
    decoded = compressor.encode_decode(v)      # v: (m, D), row by row
    nbytes = compressor.bytes_on_wire(D)       # one agent's payload

Each row of ``v`` is one agent's payload and is compressed on its own,
as the reference's ``vmap`` over agents does:

    none      identity, 4 bytes an entry.
    int8      symmetric int8 with one float32 scale a row (max |v| / 127,
              rounded half to even), 1 byte an entry + 4.
    sign1bit  sign(v) * mean(|v|) a row, 1 bit an entry + 4.
    topk      the k = ceil(frac * D) largest magnitudes of each row (ties
              at the k-th keep a few more), 8 bytes a kept entry.

The error-feedback state (``init_ef``) is CHOCO's: per stream a residual
``e`` and the gossip-tracked public copy ``ref`` (see
``ConsensusEngine.mix_ef``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "COMPRESSORS",
    "CompressionConfig",
    "Compressor",
    "cumulative_wire_bytes",
    "dequantize_int8",
    "init_ef",
    "make_compressor",
    "quantize_int8",
]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Declarative wire-compression spec carried by ``SolverConfig``.

    Attributes:
      kind: "none" | "int8" | "sign1bit" | "topk" (see ``COMPRESSORS``).
      error_feedback: carry the CHOCO wire state ``{"e", "ref"}`` in the
        solver state; False sends ``C(x)`` uncompensated.
      compress_after: warm-up mixes at full precision before compression
        switches on; they are charged full float32 bytes.
      topk_frac: fraction of entries the "topk" compressor keeps.
      gamma: consensus damping of the compressed combine, ``x + gamma *
        (mixed - x)`` (CHOCO-Gossip's step size); 1.0 is undamped.
    """

    kind: str = "none"
    error_feedback: bool = True
    compress_after: int = 0
    topk_frac: float = 0.05
    gamma: float = 1.0

    @property
    def active(self) -> bool:
        """Does any payload ever leave the agent compressed?"""
        return self.kind != "none"

    @property
    def uses_ef(self) -> bool:
        """Does the solver state need to carry the wire state?"""
        return self.active and self.error_feedback


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation of each row of an (m, D) ``x``:
    ``(q, scale)`` with ``scale`` (m, 1) float32.  ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class Compressor:
    """One wire format: the decoded value and its bytes."""

    name = "base"

    def encode_decode(self, v: torch.Tensor) -> torch.Tensor:
        """What the receivers decode from each row of the (m, D) ``v``
        (float32, v-shaped)."""
        raise NotImplementedError

    def bytes_on_wire(self, size: int) -> int:
        """Wire bytes of ONE payload of ``size`` float32 entries."""
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity: full-precision float32 on the wire."""

    name = "none"

    def encode_decode(self, v):
        return v

    def bytes_on_wire(self, size: int) -> int:
        return 4 * size


class Int8Compressor(Compressor):
    """Symmetric int8 with one scale a payload."""

    name = "int8"

    def encode_decode(self, v):
        return dequantize_int8(*quantize_int8(v))

    def bytes_on_wire(self, size: int) -> int:
        return size + 4                      # int8 entries + f32 scale


class Sign1BitCompressor(Compressor):
    """sign(v) * mean(|v|): the 1-bit format of 1-bit Adam / signSGD."""

    name = "sign1bit"

    def encode_decode(self, v):
        v32 = v.to(torch.float32)
        scale = v32.abs().mean(dim=1, keepdim=True)
        return torch.sign(v32) * scale

    def bytes_on_wire(self, size: int) -> int:
        return math.ceil(size / 8) + 4       # bitmap + f32 scale


class TopKCompressor(Compressor):
    """Magnitude top-k sparsification: k = ceil(frac * size) entries."""

    name = "topk"

    def __init__(self, frac: float):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got {frac}")
        self.frac = float(frac)

    def _k(self, size: int) -> int:
        return max(1, int(math.ceil(self.frac * size)))

    def encode_decode(self, v):
        v32 = v.to(torch.float32)
        mag = v32.abs()
        kth = torch.topk(mag, self._k(v32.shape[1]), dim=1).values[:, -1:]
        # ties keep a few extra entries; the bytes charge exactly k
        return torch.where(mag >= kth, v32, torch.zeros_like(v32))

    def bytes_on_wire(self, size: int) -> int:
        return 8 * self._k(size)             # f32 value + int32 index


COMPRESSORS = {
    "none": lambda cfg: NoneCompressor(),
    "int8": lambda cfg: Int8Compressor(),
    "sign1bit": lambda cfg: Sign1BitCompressor(),
    "topk": lambda cfg: TopKCompressor(cfg.topk_frac),
}


def make_compressor(config: CompressionConfig) -> Compressor:
    """Build the registered compressor for ``config.kind``."""
    try:
        factory = COMPRESSORS[config.kind]
    except KeyError:
        raise ValueError(
            f"unknown compressor {config.kind!r}; "
            f"choose from {sorted(COMPRESSORS)}") from None
    return factory(config)


def init_ef(compression: CompressionConfig | None, **streams):
    """Zero wire state for the named consensus streams, or ``None``.

    ``init_ef(cfg, x=x, u=u)`` -> ``{"u": {"e": zeros, "ref": zeros},
    "x": {...}}`` (float32 leaves shaped like the stream's) when the
    config compresses with error feedback; ``None`` otherwise.  Keys come
    sorted, as the JAX package's pytrees order them, so a state carried
    over from it has the same leaf order as the port's own.
    """
    if compression is None or not compression.uses_ef:
        return None
    zeros = lambda tree: pytree.tree_map(
        lambda leaf: torch.zeros(leaf.shape, dtype=torch.float32,
                                 device=leaf.device), tree)
    return {name: {"e": zeros(streams[name]), "ref": zeros(streams[name])}
            for name in sorted(streams)}


def cumulative_wire_bytes(compression: CompressionConfig, size: int,
                          num_steps: int, comms_per_step: int = 2,
                          communication_interval: int = 1) -> list[int]:
    """Per-agent cumulative wire bytes after 0..num_steps solver steps.

    The first ``compress_after`` steps ship full float32, steps with
    ``t % interval != 0`` ship nothing; ``size`` is the per-payload entry
    count and ``comms_per_step`` the algorithm's rounds a step.  Entry t
    is the bytes after t steps.
    """
    compressor = make_compressor(compression)
    full = NoneCompressor().bytes_on_wire(size)
    packed = compressor.bytes_on_wire(size)
    out, total = [0], 0
    for t in range(num_steps):
        if t % communication_interval == 0:
            per_round = full if t < compression.compress_after else packed
            total += comms_per_step * per_round
        out.append(total)
    return out
