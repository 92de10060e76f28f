"""The solver registry, the stepping loop and the end-to-end ``solve``.

Counterpart of ``repro.solvers.api``:

    from repro_torch.solvers import SolverConfig, make_solver

    solver = make_solver(SolverConfig(algo="interact", alpha=0.3, beta=0.3))
    state  = solver.init(problem, hg_cfg, x0, y0, data)
    state  = solver.step(state, data)            # one iteration
    state  = solver.run(state, data, 100)        # 100 iterations

PyTorch runs eagerly, so ``run`` is a Python loop over ``step`` where the
JAX package compiles one ``lax.scan``.  ``solve`` and ``default_setup``
run on the CUDA card unless ``device="cpu"`` is passed, and raise when
no card is present and no device was named.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.consensus.engine import make_engine
from repro_torch.consensus.ledger import time_round_us
from repro_torch.device import resolve_device, synchronize
from repro_torch.solvers.config import SolverConfig

__all__ = [
    "SolveResult",
    "SolverBase",
    "available_solvers",
    "default_setup",
    "make_solver",
    "register_solver",
    "run_recorded",
    "solve",
]

_REGISTRY: dict[str, type] = {}


def register_solver(name: str) -> Callable[[type], type]:
    """Class decorator: register a solver implementation under ``name``."""

    def deco(cls: type) -> type:
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"solver {name!r} already registered "
                             f"({existing.__name__})")
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def available_solvers() -> tuple[str, ...]:
    """Registered algorithm names, sorted."""
    return tuple(sorted(_REGISTRY))


def make_solver(config: SolverConfig) -> "SolverBase":
    """Instantiate the registered solver for ``config.algo``."""
    try:
        cls = _REGISTRY[config.algo]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {config.algo!r}; "
            f"choose from {available_solvers()}") from None
    return cls(config)


def _state_device(state) -> torch.device:
    return pytree.tree_leaves(state.x)[0].device


class SolverBase:
    """Shared plumbing: engine construction, stepping, warmup.

    Subclasses implement ``_init_state`` and ``_make_step`` (the step
    body over a bound ``ConsensusEngine``).
    """

    communications_per_step = 2  # Steps 1 and 3 each mix once

    def __init__(self, config: SolverConfig):
        self.config = config
        self._step_fn = None
        self._engine = None
        self._problem = None
        self._hg_cfg = None

    # -- subclass hooks ---------------------------------------------------
    def _init_state(self, problem, hg_cfg, x0, y0, data):
        raise NotImplementedError

    def _make_step(self, problem, hg_cfg, engine) -> Callable:
        """Return ``step(state, data) -> state``."""
        raise NotImplementedError

    # -- construction -----------------------------------------------------
    def build(self, problem, hg_cfg=None, *, device: torch.device | str,
              m: int | None = None) -> "SolverBase":
        """Bind the problem and the network on ``device``."""
        hg_cfg = hg_cfg if hg_cfg is not None else self.config.hypergrad
        hg_cfg.resolve_backend()   # fail fast on unknown engine names
        spec = self.config.mixing_spec(m)
        if m is not None and spec.num_agents != m:
            raise ValueError(
                f"config declares a {spec.num_agents}-agent network "
                f"(num_agents/mixing) but the data carries m={m} agents")
        self._engine = make_engine(self.config.backend, spec, device)
        self._step_fn = self._make_step(problem, hg_cfg, self._engine)
        self._problem, self._hg_cfg = problem, hg_cfg
        return self

    def init(self, problem, hg_cfg, x0, y0, data):
        """Build the solver on the data's device; return the initial state.

        ``hg_cfg=None`` falls back to ``config.hypergrad``.
        """
        self.build(problem, hg_cfg, device=data.inner_x.device,
                   m=data.inner_x.shape[0])
        return self._init_state(self._problem, self._hg_cfg, x0, y0, data)

    # -- stepping ---------------------------------------------------------
    def step(self, state, data):
        """One iteration."""
        if self._step_fn is None:
            raise RuntimeError("call init()/build() before step()")
        return self._step_fn(state, data)

    def run(self, state, data, num_steps: int):
        """``num_steps`` iterations."""
        for _ in range(num_steps):
            state = self.step(state, data)
        return state

    def warmup(self, state, data) -> None:
        """One step on a copy of ``state``, result discarded, so that
        first-use costs (the kernel build, library set-up) fall outside
        any timed window."""
        copy = pytree.tree_map(
            lambda l: l.clone() if isinstance(l, torch.Tensor) else l, state)
        synchronize(_state_device(self.step(copy, data)))

    def samples_per_step(self, n: int) -> float:
        raise NotImplementedError

    def hypergrad_calls_per_step(self, n: int) -> float:
        """Hypergradient estimator calls per agent per step."""
        return 1.0


def run_recorded(solver: SolverBase, state, data, num_steps: int,
                 record_every: int = 0, metric_fn=None):
    """Step ``num_steps`` times, recording ``metric_fn`` between chunks.

    One warmup step on a copy runs first.  ``metric_fn(state) -> float``
    is evaluated before each ``record_every``-step chunk and after the
    last; it runs outside the timed window, so the returned seconds
    cover stepping only (device synchronised before each clock read).
    Returns ``(state, trace, seconds)``.
    """
    chunk = record_every if record_every else num_steps
    lengths = [chunk] * (num_steps // chunk)
    if num_steps % chunk:
        lengths.append(num_steps % chunk)
    solver.warmup(state, data)
    device = _state_device(state)

    trace, took = [], 0.0
    for length in lengths:
        if metric_fn is not None:
            trace.append(metric_fn(state))
        synchronize(device)
        t0 = time.perf_counter()
        state = solver.run(state, data, length)
        synchronize(device)
        took += time.perf_counter() - t0
    if metric_fn is not None:
        trace.append(metric_fn(state))
    return state, trace, took


@dataclasses.dataclass
class SolveResult:
    """What ``solve`` returns: final state plus the experiment record."""

    state: Any
    trace: list[float]          # convergence metric every record_every steps
    us_per_step: float          # stepping time only (metrics excluded)
    samples_per_step: float     # per-agent IFO cost (Definition 1)
    communications_per_step: int
    # per-agent hypergradient evaluations per step: the counted estimator
    # call at the initial iterate times the calls per step
    hvp_per_step: float = 0.0
    grad_per_step: float = 0.0
    # median wall-clock of one warmed consensus combine of the final x
    round_latency_us: float | None = None


def default_setup(seed: int = 0, num_agents: int = 5, n_per_agent: int = 600,
                  d_in: int = 16, hidden: int = 20, classes: int = 5,
                  device: torch.device | str | None = None):
    """The paper's Section-6 synthetic meta-learning instance.

    Returns ``(problem, x0, y0, data)`` on ``device`` (the CUDA card when
    ``None``).  Same shapes and distributions as the JAX package's
    ``default_setup``; the random numbers differ (see ``repro_torch.core.
    bilevel``).
    """
    from repro_torch.core import (MLPMetaProblem, init_head,
                                  init_mlp_backbone, make_synthetic_agents)
    device = resolve_device(device)
    data = make_synthetic_agents(seed, num_agents=num_agents,
                                 n_per_agent=n_per_agent, d_in=d_in,
                                 num_classes=classes, device=device)
    problem = MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0)
    x0 = init_mlp_backbone(torch.Generator().manual_seed(seed + 1), d_in,
                           hidden=hidden, device=device)
    y0 = init_head(torch.Generator().manual_seed(seed + 2), hidden, classes,
                   device=device)
    return problem, x0, y0, data


def solve(config: SolverConfig, num_steps: int, record_every: int = 0, *,
          problem=None, hg_cfg=None, x0=None, y0=None, data=None,
          num_agents: int = 5, n_per_agent: int = 600, metric_fn=None,
          measure_hypergrad: bool | None = None,
          device: torch.device | str | None = None) -> SolveResult:
    """End-to-end experiment: build, init, step, record.

    With only ``(config, num_steps, record_every)`` this runs the paper's
    Section-6 instance and records the eq.-11 metric; pass ``problem``/
    ``x0``/``y0``/``data`` to run another instance (moved to ``device``),
    and ``metric_fn(state) -> float`` to record another metric.  Runs on
    the CUDA card unless ``device`` names another.

    ``measure_hypergrad`` (default: ``record_every > 0``) attaches the
    per-step HVP / gradient counts of one counted estimator call at the
    initial iterate.
    """
    device = resolve_device(device)
    if measure_hypergrad is None:
        measure_hypergrad = record_every > 0
    if problem is None or data is None or x0 is None or y0 is None:
        problem, x0, y0, data = default_setup(
            config.seed, num_agents=config.resolve_num_agents(num_agents),
            n_per_agent=n_per_agent, device=device)
    else:
        x0, y0, data = pytree.tree_map(lambda t: t.to(device), (x0, y0, data))

    solver = make_solver(config)
    state = solver.init(problem, hg_cfg, x0, y0, data)

    if metric_fn is None and record_every:
        from repro_torch.core.metrics import convergence_metric_fn
        eq11 = convergence_metric_fn(solver._problem, solver._hg_cfg, data)
        metric_fn = lambda st: float(eq11(st))

    state, trace, took = run_recorded(solver, state, data, num_steps,
                                      record_every, metric_fn)

    n = data.inner_x.shape[1] + data.outer_x.shape[1]
    counts = {}
    if measure_hypergrad:
        from repro_torch.hypergrad import measure_problem_counts
        per_call = measure_problem_counts(problem, solver._hg_cfg, x0, y0,
                                          data)
        calls = solver.hypergrad_calls_per_step(n)
        counts = dict(hvp_per_step=per_call.hvp_count * calls,
                      grad_per_step=per_call.grad_count * calls)
    return SolveResult(
        state=state, trace=trace,
        us_per_step=1e6 * took / max(num_steps, 1),
        samples_per_step=solver.samples_per_step(n),
        communications_per_step=solver.communications_per_step,
        round_latency_us=time_round_us(solver._engine.mix, state.x),
        **counts)
