"""Attack registry: seeded payload corruption on the wire.

Counterpart of ``repro.byzantine.attacks``.  An attack corrupts the
payload a Byzantine agent *ships*; its local state is untouched.  Which
slots are Byzantine is a fixed seeded subset (:func:`byzantine_mask`):
the same agents attack every round.

Randomness.  ``jax.random`` cannot be reproduced in PyTorch, so the port
draws its own numbers, on the host, from numpy, and hands them to the
device as tensors:

* The mask scores slot i with the first uniform of
  ``default_rng([seed, MASK_TAG, i])`` and ranks the scores exactly as
  the reference does (slot i attacks when fewer than ``num_byzantine``
  scores are below its own), so a slot's score never depends on m.
* A round's noise for stream s (x = 0, u = 1) at step t comes from
  ``default_rng([seed, NOISE_TAG, s, t])``: ``gaussian`` draws one
  (m, D) float32 block row-major (row i depends only on i and D, so
  slots added at the tail cannot change it), ``same-value`` one (D,)
  row shared by every slot.  D is the stream's payload, every leaf of
  one agent concatenated in leaf order.

The tags keep the two families apart: numpy's ``SeedSequence`` drops
trailing zeros, so ``[seed, i]`` and ``[seed, s, 0]`` would name one
stream.  :func:`apply_attack` takes the mask and the round's noise as
tensors, so a caller can hand in other draws (the parity tests pass the
reference's ``byzantine_mask`` and its per-leaf, per-slot
``jax.random.normal``, concatenated in leaf order).

An engine keeps the device side in an :class:`AttackSchedule`: the mask
and one static noise buffer a stream, refilled before each step
(``load``), so a captured CUDA graph replays with fresh noise.  A copy
from the host waits for the device, which would expose each replay's
launch; so a stepper that knows its next steps draws their noise at once
(``prefetch``: one copy to the device), and ``load`` then copies on the
device.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "Attack",
    "AttackSchedule",
    "GroupAttackSchedule",
    "MASK_TAG",
    "NOISE_TAG",
    "STREAM_IDS",
    "apply_attack",
    "attack_names",
    "byzantine_mask",
    "make_attack",
    "register_attack",
    "round_noise",
]

_ATTACKS: dict[str, type] = {}

# entropy tags of the mask and noise generators (ASCII "mask", "nois")
MASK_TAG = 0x6D61736B
NOISE_TAG = 0x6E6F6973
# wire streams an INTERACT-family round ships (y never crosses the wire)
STREAM_IDS = {"x": 0, "u": 1}


def register_attack(name: str):
    """Class decorator: register an :class:`Attack` under ``name``."""

    def wrap(cls):
        if name in _ATTACKS:
            raise ValueError(f"attack {name!r} already registered "
                             f"({_ATTACKS[name].__name__})")
        cls.name = name
        _ATTACKS[name] = cls
        return cls

    return wrap


def attack_names() -> tuple[str, ...]:
    return tuple(sorted(_ATTACKS))


def make_attack(kind: str) -> "Attack":
    try:
        return _ATTACKS[kind]()
    except KeyError:
        raise ValueError(
            f"unknown attack {kind!r}; registered: {attack_names()}"
        ) from None


class Attack:
    """One way a Byzantine slot corrupts the payload it ships.

    Attributes:
      streams: which wire streams the attack touches (``"x"``, the outer
        iterate, eq. 6; ``"u"``, the tracked hypergradient, eq. 10).
      noise: the noise a round draws: ``None``, ``"slot"`` (one row a
        slot) or ``"shared"`` (one row for every slot).
    """

    name = "?"
    streams: tuple[str, ...] = ("x", "u")
    noise: str | None = None

    def corrupt(self, rows: torch.Tensor, noise: torch.Tensor | None,
                scale: float) -> torch.Tensor:
        """Corrupted float32 payload of every row of ``rows`` (m, D);
        ``noise`` is (m, D), (D,) or ``None`` as ``self.noise`` says."""
        raise NotImplementedError


@register_attack("sign-flip")
class SignFlipAttack(Attack):
    """Ship ``-scale * value``: the classic direction-reversal attack."""

    def corrupt(self, rows, noise, scale):
        del noise
        return (-1.0 * scale) * rows


@register_attack("gaussian")
class GaussianAttack(Attack):
    """Add ``scale``-sized gaussian noise, independent per slot
    (``row + scale * N(0, I)``, as the reference's code computes)."""

    noise = "slot"

    def corrupt(self, rows, noise, scale):
        return rows + scale * noise


@register_attack("same-value")
class SameValueAttack(Attack):
    """Collusion: every Byzantine slot ships the *same* random vector,
    ``scale * N(0, I)``."""

    noise = "shared"

    def corrupt(self, rows, noise, scale):
        return (scale * noise).expand_as(rows)


@register_attack("inner-outer-split")
class InnerOuterSplitAttack(SignFlipAttack):
    """Sign-flip the tracking stream ``u`` only (bilevel-specific): x is
    shipped honestly; a no-op on D-SGD, whose wire carries x alone."""

    streams = ("u",)


def byzantine_mask(seed: int, m: int, num_byzantine: int,
                   num_active: int | None = None) -> np.ndarray:
    """(m,) bool: which slots attack, a fixed seeded subset.

    Slot i's score is the first uniform of ``default_rng([seed,
    MASK_TAG, i])``; the ``num_byzantine`` lowest-ranked slots attack
    (rank = how many scores are below the slot's own).  Slots from
    ``num_active`` on (the ghosts of a padded network) score +inf and
    never attack; a slot's score never depends on m, so the active
    slots' mask is the unpadded network's.
    """
    scores = np.array([np.random.default_rng([seed, MASK_TAG, i]).random()
                       for i in range(m)])
    if num_active is not None:
        scores = np.where(np.arange(m) < num_active, scores, np.inf)
    rank = np.sum(scores[None, :] < scores[:, None], axis=1)
    return (rank < num_byzantine) & np.isfinite(scores)


def round_noise(attack: Attack, seed: int, stream: str, t: int, m: int,
                size: int) -> np.ndarray | None:
    """The noise ``attack`` draws for ``stream`` at step ``t``: float32
    (m, size) for ``"slot"``, (size,) for ``"shared"``, else ``None``."""
    if attack.noise is None:
        return None
    rng = np.random.default_rng([seed, NOISE_TAG, STREAM_IDS[stream], t])
    shape = (m, size) if attack.noise == "slot" else (size,)
    return rng.standard_normal(shape, dtype=np.float32)


def apply_attack(attack: Attack, tree, mask: torch.Tensor,
                 noise: torch.Tensor | None, scale: float):
    """Corrupt the masked rows of every leaf; honest rows pass bitwise.

    ``tree`` has a leading agent axis on every leaf; ``mask`` is (m,)
    bool; ``noise`` is the round's draw over the concatenated payload
    (see :func:`round_noise`), split here by leaf.  Every row goes
    through ``torch.where`` against its float32 self, so an all-False
    mask gives back the payload bit for bit.
    """
    leaves, spec = pytree.tree_flatten(tree)
    m = leaves[0].shape[0]
    out, off = [], 0
    for leaf in leaves:
        clean = leaf.to(torch.float32).reshape(m, -1)
        size = clean.shape[1]
        part = None if noise is None else noise[..., off:off + size]
        bad = attack.corrupt(clean, part, scale)
        out.append(torch.where(mask[:, None], bad, clean)
                   .reshape(leaf.shape).to(leaf.dtype))
        off += size
    return pytree.tree_unflatten(out, spec)


class AttackSchedule:
    """An attack's device side: the mask and each stream's noise buffer.

    ``noise(stream, t, size)`` returns the stream's static buffer holding
    step ``t``'s draw; ``load(t)`` refills every buffer for ``t``.  A
    captured graph holds the buffers' addresses, so the stepper loads
    each step's noise before its replay (``ConsensusEngine.load_round``);
    a draw needed inside a capture raises.  ``prefetch(t, n)`` moves the
    draws of steps t .. t + n - 1 to the device at once, so that those
    loads copy on the device and no replay waits for the host.  ``draw``
    makes the host numbers; override it (and ``mask``) to hand in other
    draws.
    """

    def __init__(self, config, m: int, seed: int,
                 device: torch.device | str):
        self.attack = make_attack(config.kind)
        self.scale = float(config.scale)
        self.seed, self.m = int(seed), int(m)
        self.mask = torch.as_tensor(
            byzantine_mask(self.seed, self.m, config.num_byzantine),
            device=device)
        self.buffers: dict[str, torch.Tensor] = {}
        self.loaded: dict[str, int] = {}
        # stream -> (first step, its steps' noise stacked on the device)
        self.ahead: dict[str, tuple[int, torch.Tensor]] = {}

    def draw(self, stream: str, t: int, size: int) -> np.ndarray | None:
        """Step ``t``'s host draw for ``stream`` (see :func:`round_noise`)."""
        return round_noise(self.attack, self.seed, stream, t, self.m, size)

    def _fill(self, stream: str, t: int) -> None:
        buf, ahead = self.buffers[stream], self.ahead.get(stream)
        if (ahead is not None and 0 <= t - ahead[0] < ahead[1].shape[0]
                and ahead[1].shape[1:] == buf.shape):
            buf.copy_(ahead[1][t - ahead[0]])
        else:
            buf.copy_(torch.from_numpy(self.draw(stream, t, buf.shape[-1])))
        self.loaded[stream] = t

    def prefetch(self, t: int, num_steps: int) -> None:
        """Draw steps ``t .. t + num_steps - 1``'s noise for every stream
        in use, stacked, and move it to the device in one copy; ``load``
        takes those steps from there."""
        self.ahead = {
            stream: (int(t), torch.from_numpy(np.stack(
                [self.draw(stream, s, buf.shape[-1])
                 for s in range(int(t), int(t) + num_steps)])).to(
                     buf.device))
            for stream, buf in self.buffers.items()}

    def load(self, t: int) -> None:
        """Refill every stream's buffer with step ``t``'s draw."""
        for stream in self.buffers:
            self._fill(stream, int(t))

    def noise(self, stream: str, t: int, size: int) -> torch.Tensor | None:
        """The buffer holding step ``t``'s noise for ``stream`` (made and
        filled on first use), or ``None`` for an attack without noise."""
        if self.attack.noise is None:
            return None
        t, buf = int(t), self.buffers.get(stream)
        if buf is None or buf.shape[-1] != size:
            self.loaded.pop(stream, None)
        if self.loaded.get(stream) != t:
            if (self.mask.is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"step {t}'s attack noise was not loaded before the "
                    "capture: call engine.load_round(t) outside the graph")
            if buf is None or buf.shape[-1] != size:
                shape = (self.m, size) if self.attack.noise == "slot" \
                    else (size,)
                self.buffers[stream] = torch.empty(
                    shape, dtype=torch.float32, device=self.mask.device)
            self._fill(stream, t)
        return self.buffers[stream]


class _ExperimentAttack:
    """One experiment's view of a ``GroupAttackSchedule`` inside the
    group's vmapped step: its mask, scale and noise buffers (each one
    experiment's slice there), behind ``AttackSchedule``'s interface."""

    def __init__(self, attack: Attack, mask, scale, noises: dict):
        self.attack, self.mask, self.scale = attack, mask, scale
        self.noises = noises

    def noise(self, stream: str, t: int, size: int):
        del t, size    # the group loads every stream before each step
        return self.noises.get(stream)


class GroupAttackSchedule:
    """A padded sweep group's attack: each experiment's own attacker
    count, scale, attack seed and active-agent bound.

    The group shares the attack's kind and combine rule; the values are
    per-experiment operands: ``mask`` (B, m) bool, ``scale`` (B,) float32
    and each stream's noise buffer (B, m, D) or (B, D) float32, refilled
    with step t's draws of every experiment by ``load(t)`` before each
    step (``prefetch`` draws a run's steps ahead, in one copy).
    ``operands()`` hands them to the vmapped step and ``view`` makes one
    experiment's schedule from its slices there.

    ``params`` lists every experiment's ``(seed, num_byzantine, scale,
    num_active)``; the buffers hold the experiments ``rows`` names, all
    of them for the group, one for a sequential replay of a single row
    (``select``), so the same buffers serve every row.
    """

    def __init__(self, kind: str, params: list[tuple[int, int, float, int]],
                 m: int, size: int, device: torch.device | str,
                 rows: list[int] | None = None):
        self.attack = make_attack(kind)
        self.params = [(int(s), int(nb), float(sc), int(na))
                       for s, nb, sc, na in params]
        self.m, self.size = int(m), int(size)
        rows = list(range(len(params))) if rows is None else list(rows)
        b = len(rows)
        self.mask = torch.empty((b, self.m), dtype=torch.bool, device=device)
        self.scale = torch.empty((b,), dtype=torch.float32, device=device)
        shape = None
        if self.attack.noise == "slot":
            shape = (b, self.m, self.size)
        elif self.attack.noise == "shared":
            shape = (b, self.size)
        self.buffers = ({} if shape is None else
                        {stream: torch.empty(shape, dtype=torch.float32,
                                             device=device)
                         for stream in self.attack.streams})
        self.select(rows)

    def select(self, rows: list[int]) -> None:
        """Fill the buffers for the experiments ``rows`` (as many as the
        buffers hold) from the next ``load`` on; masks and scales now."""
        if len(rows) != self.mask.shape[0]:
            raise ValueError(f"the buffers hold {self.mask.shape[0]} "
                             f"experiments, not {len(rows)}")
        self.rows = list(rows)
        picked = [self.params[r] for r in self.rows]
        self.mask.copy_(torch.as_tensor(np.stack([
            byzantine_mask(seed, self.m, nb, na)
            for seed, nb, _, na in picked])))
        self.scale.copy_(torch.tensor([sc for _, _, sc, _ in picked],
                                      dtype=torch.float32))
        self.ahead: dict[str, tuple[int, torch.Tensor]] = {}

    def draw(self, stream: str, t: int) -> np.ndarray:
        """Step ``t``'s draws for ``stream``, stacked over ``rows``."""
        return np.stack([round_noise(self.attack, self.params[r][0], stream,
                                     t, self.m, self.size)
                         for r in self.rows])

    def prefetch(self, t: int, num_steps: int) -> None:
        """Draw steps ``t .. t + num_steps - 1`` ahead; one copy each."""
        self.ahead = {
            stream: (int(t), torch.from_numpy(np.stack(
                [self.draw(stream, s) for s in range(int(t),
                                                     int(t) + num_steps)]
            )).to(buf.device))
            for stream, buf in self.buffers.items()}

    def load(self, t: int) -> None:
        """Refill every stream's buffer with step ``t``'s draws."""
        t = int(t)
        for stream, buf in self.buffers.items():
            ahead = self.ahead.get(stream)
            if ahead is not None and 0 <= t - ahead[0] < ahead[1].shape[0]:
                buf.copy_(ahead[1][t - ahead[0]])
            else:
                buf.copy_(torch.from_numpy(self.draw(stream, t)))

    def operands(self) -> dict:
        """The per-experiment tensors the group's vmapped step takes."""
        ops = {"mask": self.mask, "scale": self.scale}
        ops.update({f"noise_{s}": buf for s, buf in self.buffers.items()})
        return ops

    @staticmethod
    def view(attack: Attack, ops: dict) -> _ExperimentAttack:
        """One experiment's schedule of ``attack`` from its slices of
        ``operands()``."""
        return _ExperimentAttack(
            attack, ops["mask"], ops["scale"],
            {k[len("noise_"):]: v for k, v in ops.items()
             if k.startswith("noise_")})
