"""The solver registry, the stepping loops and the end-to-end ``solve``.

Counterpart of ``repro.solvers.api``:

    from repro_torch.solvers import SolverConfig, make_solver

    solver = make_solver(SolverConfig(algo="svr-interact"))
    state  = solver.init(problem, hg_cfg, x0, y0, data)
    state  = solver.step(state, data)            # one iteration
    state  = solver.run(state, data, 100)        # 100 iterations, eager
    state, trace = solver.run_traced(state, data, 100, 10, metric_fn)

Stepping.  The JAX package compiles a chunk of steps into one XLA
program (``lax.scan``).  The port's counterpart is the CUDA graph:
``run_traced`` and ``run_recorded(scan=True)`` capture one step over
static state and draw buffers (one graph for each branch a step can
take: SVR-INTERACT's refresh and recursive steps, and the wire's warm-up,
compressed and silent rounds) and replay it every step, and
``run_traced`` captures the metric too.  On a CUDA device a
capture that fails raises; nothing falls back to eager stepping.  On the
CPU, where graphs do not exist, they run the eager loop, which is what
``run`` and ``run_recorded(scan=False)`` always run.

Randomness.  The stochastic solvers draw each step's minibatch indices
and Neumann k on the host (``repro_torch.core.svr_interact.Sampler``,
seeded from ``SolverConfig.seed`` unless ``init`` is given a
generator); a step takes them as a ``Draws`` tuple, which callers may
also hand over themselves.  An attack's noise is drawn on the host too
(``repro_torch.byzantine.attacks``).

Host state a step reads from the device.  Before each eager step and
each replay ``load_step(t)`` copies what the host's t decides into
static device buffers: the round's topology matrix and attack noise
(``engine.load_round``) and, with a guard, the step counter.

``solve`` and ``default_setup`` run on the CUDA card unless
``device="cpu"`` is passed, and raise when no card is present and no
device was named.

Across processes.  With a mesh backend (``backend="allgather"`` or
``"ppermute"``, ``backend_opts={"mesh": AgentMesh}``) a solver is built
and stepped on one process's rows of the state and the data: ``init``
takes the process's (k, ...) data; a stochastic solver's ``Sampler``
draws the whole (m, ...) block each step and keeps the process's rows,
so every agent draws what the single-process run draws for its slot.
Every process steps in lockstep (each combine is a collective), eagerly:
a ``GraphStepper`` refuses a mesh engine.  ``repro_torch.launch.
distributed.run_section6`` drives this end to end.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.byzantine import guard_param_step
from repro_torch.consensus.engine import make_engine
from repro_torch.consensus.ledger import attach_ledger, time_round_us
from repro_torch.core.svr_interact import Draws, Sampler, step_draws
from repro_torch.device import resolve_device, synchronize
from repro_torch.solvers.config import SolverConfig

__all__ = [
    "EagerStepper",
    "GraphStepper",
    "SolveResult",
    "SolverBase",
    "available_solvers",
    "default_setup",
    "make_solver",
    "register_solver",
    "run_recorded",
    "setup_for",
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


def _tensors(tree) -> list[torch.Tensor]:
    return [leaf for leaf in pytree.tree_leaves(tree)
            if isinstance(leaf, torch.Tensor)]


def _clone(tree):
    return pytree.tree_map(
        lambda l: l.clone() if isinstance(l, torch.Tensor) else l, tree)


def _chunks(num_steps: int, record_every: int) -> list[int]:
    """Chunk lengths between records: ``record_every`` each, then the
    remainder (the whole run when ``record_every`` is 0)."""
    chunk = record_every if record_every else num_steps
    lengths = [chunk] * (num_steps // chunk) if chunk else []
    if chunk and num_steps % chunk:
        lengths.append(num_steps % chunk)
    return lengths


class SolverBase:
    """Shared plumbing: engine construction, sampling, stepping, warmup.

    Subclasses implement ``_init_state`` and ``_make_param_step`` (the
    step body over a bound ``ConsensusEngine``, alpha and beta its
    arguments); stochastic ones set ``uses_draws`` and SVR-INTERACT
    overrides ``branch``.
    """

    communications_per_step = 2  # Steps 1 and 3 each mix once
    uses_draws = False           # whether a step takes a ``Draws`` tuple

    def __init__(self, config: SolverConfig):
        self.config = config
        self._step_fn = None
        self._param_step = None
        self._engine = None
        self._problem = None
        self._hg_cfg = None
        self._sampler = None
        self._stepper = None
        self._counter = None

    # -- subclass hooks ---------------------------------------------------
    def _init_state(self, problem, hg_cfg, x0, y0, data):
        raise NotImplementedError

    def _make_param_step(self, problem, hg_cfg, engine,
                         n: int | None) -> Callable:
        """Return ``step(state, data, draws, alpha, beta) -> state``.

        alpha and beta enter as arguments (floats, or 0-dim tensors: one
        per experiment of a sweep group under ``vmap``), not as constants
        closed over, so a sweep runs one step over a batch of step sizes.
        """
        raise NotImplementedError

    def _make_step(self) -> Callable:
        """Return ``step(state, data, draws) -> state``: the parameterised
        step ``build`` made (``_param_step``) with ``config.alpha`` and
        ``config.beta`` bound."""
        param = self._param_step
        alpha, beta = self.config.alpha, self.config.beta

        def step(state, data, draws=None):
            return param(state, data, draws, alpha, beta)

        return step

    def branch(self, t: int):
        """Which branch of the algorithm the step from iteration ``t``
        takes, where it branches on the host's t; ``None`` for a step
        that does not branch."""
        return None

    def step_variant(self, t: int) -> tuple:
        """Everything the host's t decides about the step from ``t``: the
        algorithm's ``branch`` and the engine's ``wire_schedule`` (warm-up
        and mixing rounds).  One CUDA graph is captured per value."""
        return (self.branch(t), *self._engine.wire_schedule(t))

    # -- construction -----------------------------------------------------
    def build(self, problem, hg_cfg=None, *, device: torch.device | str,
              m: int | None = None, n: int | None = None) -> "SolverBase":
        """Bind the problem and the network on ``device``; ``n`` is the
        per-agent sample count the q and batch defaults are taken from."""
        hg_cfg = hg_cfg if hg_cfg is not None else self.config.hypergrad
        hg_cfg.resolve_backend()   # fail fast on unknown engine names
        mesh = self.config.backend_opts.get("mesh")
        spec = self.config.mixing_spec(m if mesh is None else
                                       mesh.num_agents)
        if mesh is None and m is not None and spec.num_agents != m:
            raise ValueError(
                f"config declares a {spec.num_agents}-agent network "
                f"(num_agents/mixing) but the data carries m={m} agents")
        engine = make_engine(
            self.config.backend, spec, device,
            compression=self.config.compression,
            communication_interval=self.config.communication_interval,
            byzantine=self.config.byzantine, attack_seed=self.config.seed,
            **dict(self.config.backend_opts))
        if engine.local_rows is not None and m is not None \
                and engine.local_rows[1] != m:
            raise ValueError(
                f"the mesh gives this process {engine.local_rows[1]} of the "
                f"{spec.num_agents} agents, but its data carries m={m}")
        if not self.config.topology_process.is_static:
            from repro_torch.topology import attach_topology
            attach_topology(engine, self.config.topology_process, spec,
                            seed=self.config.seed)
        self._engine = engine
        self._param_step = self._make_param_step(problem, hg_cfg, engine, n)
        self._step_fn = self._make_step()
        self._counter = None
        if self.config.guard.active:
            # the incoming t on the device, for the guard's last_good
            self._counter = torch.zeros((), dtype=torch.int32,
                                        device=device)
            self._step_fn = guard_param_step(self._step_fn,
                                             self.config.guard,
                                             self._counter)
        self._problem, self._hg_cfg = problem, hg_cfg
        self._stepper = None
        return self

    def init(self, problem, hg_cfg, x0, y0, data,
             generator: torch.Generator | None = None):
        """Build the solver on the data's device; return the initial state.

        ``hg_cfg=None`` falls back to ``config.hypergrad``.  A stochastic
        solver draws from ``generator``, by default a CPU generator seeded
        with ``config.seed``; its initial state takes the first draw.
        """
        m = data.inner_x.shape[0]    # this process's agents on a mesh
        n_inner, n_outer = data.inner_x.shape[1], data.outer_x.shape[1]
        # n is the full per-agent dataset: the paper's q = |S| =
        # ceil(sqrt(n)) defaults are taken against it
        n = n_inner + n_outer
        self.build(problem, hg_cfg, device=data.inner_x.device, m=m, n=n)
        if self.uses_draws:
            if generator is None:
                generator = torch.Generator().manual_seed(self.config.seed)
            rows = self._engine.local_rows
            self._sampler = Sampler(
                generator, m if rows is None else self._network_size(),
                n_inner, n_outer, self.config.resolve_batch(n),
                self._hg_cfg.neumann_k, local=rows)
        return self._init_state(self._problem, self._hg_cfg, x0, y0, data)

    def _network_size(self) -> int:
        """m, the agents of the whole network (of every process)."""
        return int(self._engine.matrix.shape[-1])

    # -- sampling ---------------------------------------------------------
    def draw(self, num_steps: int, device: torch.device | str
             ) -> Draws | None:
        """The next ``num_steps`` steps' draws, stacked, on ``device``
        (``None`` for a solver that draws nothing)."""
        if not self.uses_draws:
            return None
        if self._sampler is None:
            raise RuntimeError("call init() before stepping a stochastic "
                               "solver without draws")
        return self._sampler.draw(num_steps, device)

    # -- stepping ---------------------------------------------------------
    def load_step(self, t: int) -> None:
        """Fill the device buffers the step from ``t`` reads: the round's
        matrix and attack noise (``engine.load_round``) and the guard's
        step counter.  Called outside any capture, before the step runs
        or its graph replays."""
        self._engine.load_round(t)
        if self._counter is not None:
            self._counter.fill_(int(t))

    def prefetch_rounds(self, t: int, num_steps: int) -> None:
        """Draw what ``load_step`` copies for steps ``t .. t + num_steps -
        1`` ahead (``engine.prefetch_rounds``), so no replay waits for the
        host."""
        self._engine.prefetch_rounds(t, num_steps)

    def step(self, state, data, draws: Draws | None = None):
        """One iteration; a stochastic solver draws when ``draws`` is
        ``None``."""
        if self._step_fn is None:
            raise RuntimeError("call init()/build() before step()")
        if draws is None and self.uses_draws:
            draws = step_draws(self.draw(1, _state_device(state)), 0)
        self.load_step(state.t)
        return self._step_fn(state, data, draws)

    def run(self, state, data, num_steps: int, *,
            checkpoint_every: int | None = None, ckpt_dir=None):
        """``num_steps`` eager iterations.

        ``checkpoint_every`` cuts the run at global multiples of it and
        snapshots the complete state into ``ckpt_dir`` after each chunk
        (atomic, CRC-checked: ``repro_torch.resilience``), so a killed run
        resumes from its last boundary through ``resume_run``; the final
        state equals the unchunked run's bit for bit.
        """
        if checkpoint_every:
            from repro_torch.resilience import run_resumable
            state, _, _ = run_resumable(
                self, state, data, num_steps,
                checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir,
                scan=False)
            return state
        draws = self.draw(num_steps, _state_device(state))
        for i in range(num_steps):
            state = self.step(state, data,
                              None if draws is None else step_draws(draws, i))
        return state

    def run_traced(self, state, data, num_steps: int, record_every: int = 0,
                   metric_fn=None, *, checkpoint_every: int | None = None,
                   ckpt_dir=None):
        """``num_steps`` iterations with ``metric_fn(state) -> 0-dim
        tensor`` recorded on the device.

        Returns ``(state, trace)``: ``trace`` is a tensor laid out like
        ``run_recorded``'s list (the metric before steps 0, r, 2r, ...,
        then after the last step), empty without a ``metric_fn``.  On a
        CUDA device the steps and the metric replay captured graphs with
        no host read between them, so ``metric_fn`` must not read a
        tensor on the host either: its capture raises if it does.

        ``checkpoint_every`` routes the run through the resilience runner
        (``run_resumable``): the same stepper advanced one chunk at a time
        between global multiples of it, the complete state and the partial
        metric column snapshotted into ``ckpt_dir`` after each chunk; the
        state and trace equal the unchunked run's bit for bit.  Meant for
        a fresh state (the global step is ``state.t``); an interrupted run
        resumes through ``repro_torch.resilience.resume_run``.
        """
        if checkpoint_every:
            from repro_torch.resilience import run_resumable
            state, trace, _ = run_resumable(
                self, state, data, num_steps, record_every, metric_fn,
                checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir)
            return state, torch.from_numpy(trace).to(_state_device(state))
        stepper = self.stepper_for(state, data, scan=True)
        stepper.prepare(num_steps)
        record = stepper.record(metric_fn) if metric_fn is not None else None
        records = []
        for length in _chunks(num_steps, record_every):
            if record is not None:
                records.append(record())
            stepper.advance(length)
        if record is not None:
            records.append(record())
        trace = (torch.stack(records) if records
                 else torch.zeros(0, device=stepper.device))
        return stepper.state(), trace

    def warmup(self, state, data) -> None:
        """One step on a copy of ``state``, result discarded, so that
        first-use costs (the kernel build, library set-up) fall outside
        any timed window.  Takes all-zero draws; the generator does not
        move."""
        device = _state_device(state)
        draws = self._sampler.zeros(device) if self.uses_draws else None
        synchronize(_state_device(self.step(_clone(state), data, draws)))

    def stepper_for(self, state, data, scan: bool = True):
        """The stepper ``run_traced`` and ``run_recorded`` step with,
        holding ``state``: a ``GraphStepper`` with ``scan`` on a CUDA
        device, else an ``EagerStepper``.  It is kept across calls with
        the same ``data`` and kind, so graphs and warm-up are paid once."""
        graphs = scan and _state_device(state).type == "cuda"
        kind = GraphStepper if graphs else EagerStepper
        if type(self._stepper) is not kind or self._stepper.data is not data:
            self._stepper = kind(self, state, data)
        else:
            self._stepper.load(state)
        return self._stepper

    @property
    def stepper(self):
        """The stepper of the last ``stepper_for`` call (``None`` before
        one), for its accounting."""
        return self._stepper

    def samples_per_step(self, n: int) -> float:
        raise NotImplementedError

    def hypergrad_calls_per_step(self, n: int) -> float:
        """Hypergradient estimator calls per agent per step."""
        return 1.0


def _copy_state(dst, src) -> None:
    """Copy every tensor of ``src`` into the one of ``dst`` in its place.

    An ``src`` tensor that shares memory with a ``dst`` one (SVR-INTERACT
    returns the incoming x as x_prev) is cloned first, so no copy reads
    a buffer another copy has overwritten.  Both must have one structure
    (wire-state dicts with their keys in one order), else it raises.
    """
    if pytree.tree_structure(dst) != pytree.tree_structure(src):
        raise ValueError("state structures differ: "
                         f"{pytree.tree_structure(dst)} against "
                         f"{pytree.tree_structure(src)}")
    dst, src = _tensors(dst), _tensors(src)
    held = {t.untyped_storage().data_ptr() for t in dst}
    src = [t.clone() if t.untyped_storage().data_ptr() in held else t
           for t in src]
    for d, s in zip(dst, src, strict=True):
        d.copy_(s)


class EagerStepper:
    """Steps a built solver with eager calls, behind ``GraphStepper``'s
    interface (``load``, ``state``, ``prepare``, ``record``,
    ``advance``), so that ``run_traced`` and ``run_recorded`` keep one
    loop for both."""

    def __init__(self, solver: SolverBase, state, data):
        self.solver, self.data = solver, data
        self.device = _state_device(state)
        self.warmed = False
        self.load(state)

    def load(self, state) -> None:
        self._state = state

    def state(self):
        return self._state

    def prepare(self, num_steps: int) -> None:
        """One warm-up step on a copy (``SolverBase.warmup``), once."""
        if not self.warmed:
            self.solver.warmup(self._state, self.data)
            self.warmed = True

    def record(self, metric_fn) -> Callable[[], Any]:
        return lambda: metric_fn(self._state)

    def advance(self, num_steps: int) -> None:
        self._state = self.solver.run(self._state, self.data, num_steps)


class GraphStepper:
    """Steps a built solver on a CUDA device by replaying CUDA graphs of
    its step.

    The state lives in static buffers: ``load`` copies a state in and
    ``state()`` copies it out.  Each graph runs one step from the buffers
    and writes the new state back into them, so a replay needs no host
    work beyond copying that step's draws into the draw buffers and what
    the host's t decides into the solver's static buffers
    (``solver.load_step``: the round's matrix and attack noise, the
    guard's step counter), all from the device (``advance`` moves a
    run's draws and attack noise there first, in one copy each, so no
    replay waits for the host); t is kept on the host and picks the graph
    (``solver.step_variant``).  A
    graph is captured the first time a step needs it (``prepare``
    captures every one a run needs before it starts), after
    ``WARMUP_STEPS`` eager steps on a copy on a side stream.  A capture
    that fails raises.  Each capture starts with a garbage collection: a
    dead reference cycle that holds a CUDA graph (a solver and its
    stepper) would otherwise be collected during the capture, whose
    graph reset is not allowed there and invalidates it.

    ``graphs``, ``replays`` and ``eager_steps`` (the warm-up steps) are
    kept for accounting: a kernel launched c times in the eager step is
    launched c times by each replay, and its wrapper counts only the
    warm-up's and the capture's launches.
    """

    WARMUP_STEPS = 2

    def __init__(self, solver: SolverBase, state, data):
        device = _state_device(state)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        if solver._engine.local_rows is not None:
            raise ValueError(
                f"the {solver._engine.name!r} backend's collectives step "
                "eagerly: run it with scan=False (run, or run_recorded(..., "
                "scan=False))")
        self.solver, self.data, self.device = solver, data, device
        self.static = _clone(state)
        self.t = state.t
        self.draws = (solver._sampler.zeros(device) if solver.uses_draws
                      else None)
        self.graphs: dict[Any, torch.cuda.CUDAGraph] = {}
        self.metrics: dict[int, tuple[Callable, Callable]] = {}
        self.replays = 0
        self.eager_steps = 0

    def load(self, state) -> None:
        """Copy ``state`` into the static buffers."""
        _copy_state(self.static, state)
        self.t = state.t

    def state(self):
        """A copy of the current state."""
        return _clone(self.static)._replace(t=self.t)

    def _warm(self, fn, times: int) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(times):
                fn()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def capture(self, t: int) -> torch.cuda.CUDAGraph:
        """The graph of the step from iteration ``t``, captured if new."""
        variant = self.solver.step_variant(t)
        graph = self.graphs.get(variant)
        if graph is not None:
            return graph
        step, at_t = self.solver._step_fn, self.static._replace(t=t)
        self.solver.load_step(t)
        self._warm(lambda: step(_clone(at_t), self.data, self.draws),
                   self.WARMUP_STEPS)
        self.eager_steps += self.WARMUP_STEPS
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _copy_state(self.static, step(at_t, self.data, self.draws))
        self.graphs[variant] = graph
        return graph

    def prepare(self, num_steps: int) -> None:
        """Capture every graph the next ``num_steps`` steps replay."""
        for t in range(self.t, self.t + num_steps):
            self.capture(t)

    def record(self, metric_fn) -> Callable[[], torch.Tensor]:
        """A graph of ``metric_fn`` on the static state (captured once per
        ``metric_fn``, after one eager warm-up: the step's captures have
        set up what its kernels need); returns a call that replays it and
        returns a copy of its value."""
        held = self.metrics.get(id(metric_fn))
        if held is not None:
            return held[1]
        self._warm(lambda: metric_fn(self.static), 1)
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            value = torch.as_tensor(metric_fn(self.static))

        def replay() -> torch.Tensor:
            graph.replay()
            return value.clone()

        # the function is held beside its graph, so its id is not reused
        self.metrics[id(metric_fn)] = (metric_fn, replay)
        return replay

    def advance(self, num_steps: int) -> None:
        """``num_steps`` steps, on the solver's next draws."""
        draws = self.solver.draw(num_steps, self.device)
        self.prepare(num_steps)
        self.solver.prefetch_rounds(self.t, num_steps)
        for i in range(num_steps):
            graph = self.capture(self.t)
            if draws is not None:
                for buf, d in zip(self.draws, draws):
                    buf.copy_(d[i])
            self.solver.load_step(self.t)
            graph.replay()
            self.t += 1
            self.replays += 1


def run_recorded(solver: SolverBase, state, data, num_steps: int,
                 record_every: int = 0, metric_fn=None, scan: bool = True):
    """Step ``num_steps`` times, recording ``metric_fn`` between chunks.

    ``scan=True`` replays captured CUDA graphs on a CUDA device (the
    reference's compiled scan); on the CPU, and with ``scan=False``, the
    eager loop runs.  Capture, or a warmup step on a copy, happens first,
    and ``metric_fn(state) -> float`` is evaluated before each
    ``record_every``-step chunk and after the last, outside the timed
    window, so the returned seconds cover stepping only (device
    synchronised before each clock read).  Returns
    ``(state, trace, seconds)``.
    """
    device = _state_device(state)
    stepper = solver.stepper_for(state, data, scan)
    stepper.prepare(num_steps)
    trace, took = [], 0.0
    for length in _chunks(num_steps, record_every):
        if metric_fn is not None:
            trace.append(metric_fn(stepper.state()))
        synchronize(device)
        t0 = time.perf_counter()
        stepper.advance(length)
        synchronize(device)
        took += time.perf_counter() - t0
    state = stepper.state()
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
    hess_per_step: float = 0.0
    # wire bytes one agent ships a consensus round under the engine's
    # compressor (``engine.bytes_on_wire`` of one agent's x), schedule
    # not folded in (see ``cumulative_wire_bytes``)
    bytes_per_round: float = 0.0
    # measured per-agent bytes over the run, from the ``CommsLedger``
    # attached before stepping (stream templates noted where a combine is
    # called, the warm-up/interval schedule replayed on the host)
    measured_wire_bytes: float | None = None
    # median wall-clock of one warmed consensus combine of the final x
    round_latency_us: float | None = None
    # divergence-guard counters (SolverConfig.guard): steps that tripped
    # a wire and were rolled back, and the step counter of the last
    # accepted state; 0 / -1 without a guard
    tripped_steps: int = 0
    last_good_step: int = -1


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


def setup_for(config: SolverConfig, problem=None, x0=None, y0=None,
              data=None, *, num_agents: int = 5, n_per_agent: int = 600,
              device: torch.device | str | None = None):
    """``(problem, x0, y0, data)`` on ``device`` (the card when ``None``):
    the Section-6 instance (``default_setup``, seeded by ``config.seed``)
    when any is missing, else the given ones, moved there (trees already
    there are returned as they are)."""
    device = resolve_device(device)
    if problem is None or data is None or x0 is None or y0 is None:
        return default_setup(
            config.seed, num_agents=config.resolve_num_agents(num_agents),
            n_per_agent=n_per_agent, device=device)
    trees = (x0, y0, data)
    if any(t.device != device for t in pytree.tree_leaves(trees)):
        trees = pytree.tree_map(lambda t: t.to(device), trees)
    return (problem, *trees)


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
    the CUDA card unless ``device`` names another, stepping through
    ``run_recorded(scan=True)``: captured CUDA graphs on the card, the
    eager loop on the CPU.

    ``measure_hypergrad`` (default: ``record_every > 0``) attaches the
    per-step HVP / gradient / Hessian counts of one counted estimator
    call at the initial iterate.  A ``CommsLedger`` on the engine
    measures the bytes the run shipped (``measured_wire_bytes``), beside
    the priced ``bytes_per_round``.
    """
    if measure_hypergrad is None:
        measure_hypergrad = record_every > 0
    problem, x0, y0, data = setup_for(config, problem, x0, y0, data,
                                      num_agents=num_agents,
                                      n_per_agent=n_per_agent, device=device)

    solver = make_solver(config)
    state = solver.init(problem, hg_cfg, x0, y0, data)
    ledger = attach_ledger(solver._engine)

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
                      grad_per_step=per_call.grad_count * calls,
                      hess_per_step=per_call.hess_count * calls)
    guard = getattr(state, "guard", None)
    if guard is not None:
        counts.update(tripped_steps=int(guard["tripped"]),
                      last_good_step=int(guard["last_good"]))
    ledger.commit_steps(num_steps)
    engine = solver._engine
    ledger.observe_latency(time_round_us(engine.mix, state.x))
    # one agent's consensus payload: its slice of the outer iterate tree
    payload = pytree.tree_map(lambda leaf: leaf[0], state.x)
    return SolveResult(
        state=state, trace=trace,
        us_per_step=1e6 * took / max(num_steps, 1),
        samples_per_step=solver.samples_per_step(n),
        communications_per_step=solver.communications_per_step,
        bytes_per_round=float(engine.bytes_on_wire(payload)),
        measured_wire_bytes=ledger.measured_wire_bytes,
        round_latency_us=ledger.round_latency_us,
        **counts)
