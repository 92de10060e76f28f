"""The batched sweep engine: ``vmap`` over experiments, ghost-padded networks.

Counterpart of ``repro.solvers.sweep``.  Every Section-6 figure is a grid
of algorithms x network sizes x topologies x seeds x step sizes.  Run one
config at a time, a grid pays a Python loop and a captured graph per
cell; here it runs as a few batched groups:

1.  Configs are grouped by ``SolverConfig.static_key()``: everything the
    step's structure depends on.  Within a group only the
    ``BATCH_FIELDS`` (seed, alpha, beta) differ, and they enter as
    values: each experiment's draws come from its own seeded generator,
    and alpha and beta are 0-dim tensors, one per experiment.

2.  Each group steps all of its experiments at once: the solver's
    parameterised step (``_make_param_step``) under ``torch.func.vmap``
    over the experiments, around the ``vmap`` over agents inside it.  On
    a CUDA device the group steps by replaying CUDA graphs of that
    batched step, one per step variant (``GraphStepper``: SVR-INTERACT's
    two branches, the wire's schedule), and the recorded metric replays
    a graph of its own.  On the ``cuda`` backend the consensus kernels
    launch once a step for the whole group (the wrappers' vmap rules
    call the batched kernels).  An 8-seed x 4-algorithm Figure-2 grid is
    4 groups.

3.  ``pad_agents=True`` also batches configs that differ only in network
    size or topology: every mixing matrix is ghost-padded to a common
    ``pad_to`` (identity rows: still doubly stochastic, active combines
    unchanged but for exact zero terms), states and data are padded
    along the agent axis, and the padded matrix and the active-agent
    count become per-experiment operands.  An m x topology grid of one
    algorithm is then one group.  The engine of each experiment is
    built inside the vmapped step from its padded matrix, as the
    reference builds it inside its traced function, so padding needs
    the ``dense`` backend.

Usage::

    from repro_torch.solvers import SolverConfig, expand_grid, sweep

    configs = expand_grid(SolverConfig(algo="interact"),
                          seed=range(8), alpha=(0.3, 0.1))
    result = sweep(configs, num_steps=40, record_every=5)
    result.traces          # (16, 9) metric traces
    result.num_dispatches  # 1: one group

Host work per step.  The port draws on the host (see
``repro_torch.core.svr_interact``): a group draws every experiment's
minibatches for the whole run before it starts, from each experiment's
own generator, and moves them to the device in one copy; before each
step and replay the group loads what the host's t decides into static
buffers: its experiments' round matrices (a stream group: their
realized streams differ), their attack noise (a padded Byzantine group:
attacker count, scale and attack seed differ) and the guard's step
counter, which the group's experiments share, as they share t.

Not ported: ``resume_dir`` (the reference keeps finished groups' traces
through ``repro.checkpoint`` and ``repro.resilience``, which the port
does not have yet); it raises ``NotImplementedError``.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import time
from collections.abc import Mapping
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from repro_torch.byzantine import (GroupAttackSchedule, guard_param_step,
                                   make_attack)
from repro_torch.consensus.dense import DenseEngine
from repro_torch.core.bilevel import AgentData, pad_agent_data
from repro_torch.core.consensus import pad_mixing
from repro_torch.core.svr_interact import Draws, Sampler
from repro_torch.device import resolve_device, synchronize
from repro_torch.solvers.api import SolverBase, default_setup, make_solver
from repro_torch.solvers.config import SolverConfig
from repro_torch.topology.runtime import (AdaptiveTopology,
                                          GroupStreamTopology,
                                          RoundTopology)

__all__ = ["SweepGroup", "SweepResult", "expand_grid", "sweep"]


def expand_grid(base: SolverConfig = SolverConfig(),
                **axes: Sequence) -> list[SolverConfig]:
    """The cartesian grid of ``dataclasses.replace(base, ...)`` configs.

    ``expand_grid(base, seed=range(8), alpha=(0.3, 0.1))`` yields 16
    configs in row-major order (later axes vary fastest).  Any
    ``SolverConfig`` field is a valid axis; the ``BATCH_FIELDS`` keep a
    grid in one group, other axes split it by ``static_key()``, except
    ``num_agents`` / ``topology`` / ``mixing`` under ``sweep(...,
    pad_agents=True)``, which batch too.
    """
    names = list(axes)
    return [dataclasses.replace(base, **dict(zip(names, values)))
            for values in itertools.product(*(axes[k] for k in names))]


@dataclasses.dataclass
class SweepGroup:
    """One group: the configs that stepped as one batch.

    ``seconds`` is the batched wall-clock (after warm-up when measured,
    else the first run with its captures and initial states);
    ``seconds_sequential`` the same experiments one at a time through
    the group's single-experiment step (``compare_sequential``).
    ``graphs``, ``replays`` and ``eager_steps`` are the batched
    stepper's accounting (``GraphStepper``; 0 graphs and replays off
    the card), and ``stepper`` the stepper itself: its ``solver`` steps
    the group from ``solver.initial_state()`` again after
    ``solver.rewind()`` (the same draws), replaying the same graphs.
    """

    indices: list[int]          # positions into the sweep's config list
    config: SolverConfig        # the group's representative
    seconds: float
    pad_to: int | None = None   # padded agent count (padded groups only)
    num_active: tuple[int, ...] | None = None   # per-config active m
    seconds_sequential: float | None = None
    graphs: int = 0
    replays: int = 0
    eager_steps: int = 0
    stepper: Any = None


@dataclasses.dataclass
class SweepResult:
    """What ``sweep`` returns.

    ``traces[i]`` is config ``i``'s metric trace in ``run_traced``'s
    layout (the metric before steps 0, record_every, ..., then after the
    last step), rows in the input order whatever the grouping.
    ``traces_sequential`` holds the same rows from the sequential run
    (``compare_sequential``), else None.  ``states[i]`` is config i's
    final state when ``return_states=True``; in a padded sweep its agent
    axis is ``pad_to`` wide and rows from its ``num_active`` on are ghost
    agents.
    """

    configs: list[SolverConfig]
    traces: np.ndarray                   # (num_configs, num_records)
    groups: list[SweepGroup]
    seconds: float                       # batched wall-clock (see measure)
    seconds_sequential: float | None     # same grid, one config at a time
    measured: bool = False               # True: seconds exclude set-up
    states: list[Any] | None = None
    pad_to: int | None = None            # set when pad_agents batched
    traces_sequential: np.ndarray | None = None

    @property
    def num_dispatches(self) -> int:
        return len(self.groups)

    @property
    def vmap_speedup(self) -> float | None:
        """Sequential over batched wall-clock (None unless both ran)."""
        if self.seconds_sequential is None:
            return None
        return self.seconds_sequential / max(self.seconds, 1e-12)

    def trace_of(self, config: SolverConfig) -> np.ndarray:
        """The trace row of the first config matching ``config`` by
        ``(static_key, batch_values, topology_process)``: an explicit
        ``MixingSpec`` holds a numpy matrix, for which ``==`` is
        elementwise, and the process's p and seed are not in the key."""
        want = (config.static_key(), config.batch_values(),
                config.topology_process)
        for i, c in enumerate(self.configs):
            if c is config or (c.static_key(), c.batch_values(),
                               c.topology_process) == want:
                return self.traces[i]
        raise KeyError(config)

    def group_traces(self, group: SweepGroup) -> np.ndarray:
        return self.traces[np.asarray(group.indices)]


def _group_by_static_key(configs: Sequence[SolverConfig],
                         pad_to: int | None = None) -> list[list[int]]:
    """Order-preserving grouping: static_key -> list of config indices."""
    groups: dict[tuple, list[int]] = {}
    for i, cfg in enumerate(configs):
        groups.setdefault(cfg.static_key(pad_to=pad_to), []).append(i)
    return list(groups.values())


def _mixed_m_error(configs, indices, need_m: int, have: str) -> ValueError:
    """The network-size mismatch diagnostic, naming the offending keys."""
    lines = [f"  configs[{i}]: static_key={configs[i].static_key()!r}"
             for i in indices]
    all_ms = sorted({c.resolve_num_agents(need_m) or need_m
                     for c in configs})
    return ValueError(
        f"sweep group needs m={need_m} agents but {have}; the grid spans "
        f"network sizes {all_ms}, which compile one program per size. "
        "Pass pad_agents=True to ghost-pad them into one batched program "
        "per algorithm (dense backend), or supply `data` as a "
        "{num_agents: AgentData} mapping to run one group per size. "
        "Offending configs:\n" + "\n".join(lines))


def _mixed_process_error(configs, indices, why: str) -> ValueError:
    """The topology-process batching diagnostic, naming offending configs:
    a group whose experiments realize different streams needs the stream
    as a per-experiment operand, which only the dense backend takes."""
    lines = []
    for i in indices:
        proc = configs[i].topology_process
        lines.append(
            f"  configs[{i}]: topology_process=(kind={proc.kind!r}, "
            f"p={proc.p}, seed={proc.resolve_seed(configs[i].seed)}), "
            f"backend={configs[i].backend!r}")
    return ValueError(
        f"sweep group mixes topology-process realizations but {why}; "
        "the matrix stream must be a traced vmap operand, which needs "
        "the dense consensus backend and a solver implementing "
        "_make_param_step. Use backend='dense', or split the grid so "
        "each group shares one (p, seed) stream. Offending configs:\n"
        + "\n".join(lines))


class _Layout:
    """A solver state's tensors as a flat list, and back: what goes
    through ``vmap`` (its step counter t is a host int, and the state's
    ``None`` fields are no tensors)."""

    _TENSOR = object()    # a tensor's place among the leaves

    def __init__(self, state):
        leaves, self.spec = pytree.tree_flatten(state)
        self.held = [self._TENSOR if isinstance(l, torch.Tensor) else l
                     for l in leaves]

    @staticmethod
    def tensors(state) -> list[torch.Tensor]:
        return [l for l in pytree.tree_leaves(state)
                if isinstance(l, torch.Tensor)]

    def build(self, tensors, t: int):
        it = iter(tensors)
        leaves = [next(it) if h is self._TENSOR else h for h in self.held]
        return pytree.tree_unflatten(leaves, self.spec)._replace(t=t)

    def stack(self, states) -> Any:
        """One state whose tensors stack ``states``' on a leading axis."""
        cols = zip(*(self.tensors(s) for s in states))
        return self.build([torch.stack(c) for c in cols], states[0].t)

    def row(self, state, r: int):
        return self.build([l[r] for l in self.tensors(state)], state.t)


class _DrawQueue:
    """A group's draws for the whole run, (steps, B, ...) on the device,
    handed out in order (``SolverBase.draw``) to all experiments or to
    one row (``select``); ``rewind`` starts over for a timed re-run."""

    def __init__(self, draws: Draws):
        self.all, self.pos, self.at = draws, 0, None

    def select(self, row: int | None) -> None:
        self.at = row
        self.pos = 0

    def rewind(self) -> None:
        self.pos = 0

    def _pick(self, f: torch.Tensor, steps) -> torch.Tensor:
        return f[steps] if self.at is None else f[steps, self.at]

    def draw(self, num_steps: int, device) -> Draws:
        if self.pos + num_steps > self.all.inner.shape[0]:
            raise RuntimeError(f"the group drew {self.all.inner.shape[0]} "
                               f"steps; step {self.pos + num_steps} asked")
        steps = slice(self.pos, self.pos + num_steps)
        self.pos += num_steps
        return Draws(*(self._pick(f, steps) for f in self.all))

    def zeros(self, device) -> Draws:
        return Draws(*(torch.zeros_like(self._pick(f, 0)) for f in self.all))


class _EngineRounds:
    """The shared engine's per-step buffers (one topology stream, one
    attack schedule for the whole group) as a group loader."""

    def __init__(self, engine):
        self.engine = engine

    def load(self, t: int) -> None:
        self.engine.load_round(t)

    def prefetch(self, t: int, num_steps: int) -> None:
        self.engine.prefetch_rounds(t, num_steps)


@dataclasses.dataclass
class _Parts:
    """What a group's experiments run: ``one_step(state, draws, ops)``
    and ``one_metric(state, ops)`` for one experiment, ``ops`` its
    operands (``consts`` and the loaders' buffers, one slice each)."""

    rep: SolverBase
    one_step: Callable
    one_metric: Callable | None
    consts: dict[str, torch.Tensor]       # (B, ...) per experiment
    layout: _Layout
    states: list[Any]                     # initial state per experiment
    draws: Draws | None                   # (steps, B, ...) or None
    shared: Any = None                    # engine whose rounds all share
    streams: list | None = None           # per-experiment (T, m, m)
    attack: tuple | None = None           # GroupAttackSchedule arguments


class _GroupSolver(SolverBase):
    """The experiments of one sweep group behind the solver interface
    ``GraphStepper`` and ``EagerStepper`` step: its state is every
    experiment's, stacked on a leading axis, and its step is
    ``one_step`` under ``vmap`` (``row=None``); with a ``row`` it is the
    single-experiment step of that row, over static operand buffers that
    ``select`` reloads, so one set of graphs replays every row."""

    def __init__(self, parts: _Parts, row: int | None, device):
        super().__init__(parts.rep.config)
        self.parts, self.row = parts, row
        rep = parts.rep
        self.uses_draws = rep.uses_draws
        self._engine = rep._engine
        self._problem, self._hg_cfg = rep._problem, rep._hg_cfg
        self._counter = rep._counter
        rows = None if row is None else [row]
        self.loaders = []
        if parts.shared is not None:
            self.loaders.append(_EngineRounds(parts.shared))
        self.stream = (None if parts.streams is None else
                       GroupStreamTopology(parts.streams, device, rows))
        self.attack = (None if parts.attack is None else
                       GroupAttackSchedule(*parts.attack, device, rows))
        self.loaders += [x for x in (self.stream, self.attack)
                         if x is not None]
        if row is None:
            self.consts = parts.consts
        else:
            self.consts = {k: v[row].clone() for k, v in parts.consts.items()}
        self.ops = dict(self.consts)
        if self.stream is not None:
            self.ops["round"] = self.stream.round
        if self.attack is not None:
            self.ops.update(self.attack.operands())
        if row is not None:   # one experiment: the loaders' single slice
            self.ops.update({k: v[0] for k, v in self.ops.items()
                             if k not in self.consts})
        self._sampler = (None if parts.draws is None
                         else _DrawQueue(parts.draws))
        if self._sampler is not None:
            self._sampler.select(row)
        self._step_fn = self._one if row is not None else self._batched

    def select(self, row: int) -> None:
        """Run experiment ``row`` next (sequential solvers only)."""
        for k, buf in self.consts.items():
            buf.copy_(self.parts.consts[k][row])
        for loader in (self.stream, self.attack):
            if loader is not None:
                loader.select([row])
        if self._sampler is not None:
            self._sampler.select(row)
        self.row = row

    def initial_state(self):
        parts = self.parts
        if self.row is not None:
            return parts.states[self.row]
        return parts.layout.stack(parts.states)

    def rewind(self) -> None:
        if self._sampler is not None:
            self._sampler.rewind()

    def branch(self, t: int):
        return self.parts.rep.branch(t)

    def load_step(self, t: int) -> None:
        for loader in self.loaders:
            loader.load(t)
        if self._counter is not None:
            self._counter.fill_(int(t))

    def prefetch_rounds(self, t: int, num_steps: int) -> None:
        for loader in self.loaders:
            if hasattr(loader, "prefetch"):
                loader.prefetch(t, num_steps)

    def _one(self, state, data, draws=None):
        return self.parts.one_step(state, draws, self.ops)

    def _batched(self, state, data, draws=None):
        layout, t = self.parts.layout, state.t

        def one(tensors, draws, ops):
            new = self.parts.one_step(layout.build(tensors, t), draws, ops)
            return layout.tensors(new)

        out = vmap(one, in_dims=(0, None if draws is None else 0, 0))(
            layout.tensors(state), draws, self.ops)
        return layout.build(out, t + 1)

    def metric(self, state):
        """The recorded metric: a (B,) tensor batched, 0-dim for a row."""
        one_metric, layout = self.parts.one_metric, self.parts.layout
        if self.row is not None:
            return one_metric(state, self.ops)
        return vmap(lambda tensors, ops: one_metric(
            layout.build(tensors, state.t), ops))(layout.tensors(state),
                                                  self.ops)


def _timed(device, fn):
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def _run(solver: _GroupSolver, data, num_steps: int, record_every: int,
         metric):
    """``run_traced`` of the group from its initial states, on the same
    draws every time: ``(final state, trace)``."""
    solver.rewind()
    return solver.run_traced(solver.initial_state(), data, num_steps,
                             record_every, metric)


def sweep(configs: Sequence[SolverConfig], num_steps: int,
          record_every: int = 0, *, problem=None, x0=None, y0=None,
          data=None, num_agents: int = 5, n_per_agent: int = 600,
          metric_fn=None, x0_stack=None, y0_stack=None,
          measure: bool = False, compare_sequential: bool = False,
          return_states: bool = False, pad_agents: bool = False,
          pad_to: int | None = None, resume_dir=None,
          device: torch.device | str | None = None) -> SweepResult:
    """Run a grid of experiments, one batched group per static key.

    Args:
      configs: the grid (see ``expand_grid``), grouped by
        ``SolverConfig.static_key()``; seed, alpha and beta batch inside
        a group.
      num_steps / record_every: shared by every experiment;
        ``record_every=0`` records nothing.
      problem / x0 / y0 / data: the problem instance, moved to
        ``device``; by default the paper's Section-6 instance
        (``default_setup``, seeded by the first config).  ``data`` may be
        a ``{num_agents: AgentData}`` mapping for network-size sweeps.
      metric_fn: ``state -> 0-dim tensor`` recorded on the device, run
        under ``vmap`` over a group's experiments; by default the eq.-11
        metric (``convergence_metric_fn``) when ``record_every > 0``.
        Under ``pad_agents=True`` it is ``(state, data, num_active) ->
        0-dim tensor`` (default ``masked_convergence_metric_fn``).
      x0_stack / y0_stack: optional per-experiment initial points,
        pytrees with a leading axis of ``len(configs)`` in config order;
        by default every experiment starts from ``x0`` / ``y0``.
      measure: run each warmed group again and report that wall-clock in
        ``seconds`` (captures and initial states excluded).  Otherwise
        ``seconds`` is the first run's, with them.
      compare_sequential: also run each group's experiments one at a time
        through the group's single-experiment step, captured once and
        replayed with each row's operands loaded into its buffers (the
        counterpart of the reference's jitted single-experiment function
        over row operands), for ``vmap_speedup`` and
        ``traces_sequential``.  Implies ``measure``.
      return_states: keep each config's final state.
      pad_agents: ghost-pad every network to a common agent count, so
        configs that differ only in network size or topology share a
        group (``dense`` backend only).
      pad_to: the padded agent count; defaults to the grid's largest
        network.
      resume_dir: not ported (it needs the checkpoint and resilience
        modules); raises ``NotImplementedError``.
      device: where the sweep runs: the CUDA card when ``None`` (raises
        without one), as ``solve``.

    Returns a ``SweepResult`` with traces aligned to the input order.
    """
    configs = list(configs)
    measure = measure or compare_sequential
    if not configs:
        raise ValueError("sweep needs at least one config")
    if resume_dir is not None:
        raise NotImplementedError(
            "sweep(resume_dir=...) is not ported yet: it keeps finished "
            "groups through the checkpoint and resilience modules (ROADMAP "
            "Queue A 8)")
    device = resolve_device(device)

    data_map = None
    if isinstance(data, Mapping):
        data_map = {int(k): v for k, v in data.items()}
        data = None
    built_default = problem is None or x0 is None or y0 is None or (
        data is None and data_map is None)
    if built_default:
        problem, x0, y0, built = default_setup(
            configs[0].seed, num_agents=num_agents, n_per_agent=n_per_agent,
            device=device)
        if data is None and data_map is None:
            data = built
    to_device = lambda tree: pytree.tree_map(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)
    x0, y0, data, x0_stack, y0_stack = to_device(
        (x0, y0, data, x0_stack, y0_stack))
    if data_map is not None:
        data_map = {k: to_device(v) for k, v in data_map.items()}

    default_m = data.inner_x.shape[0] if data is not None else num_agents
    data_cache: dict[int, AgentData] = {}

    def data_for(m: int, indices) -> AgentData:
        if data_map is not None:
            try:
                return data_map[m]
            except KeyError:
                raise _mixed_m_error(
                    configs, indices, m,
                    f"the data mapping only covers {sorted(data_map)}"
                ) from None
        if data.inner_x.shape[0] == m:
            return data
        if built_default:     # the default Section-6 setup: one per size
            if m not in data_cache:
                data_cache[m] = default_setup(
                    configs[0].seed, num_agents=m, n_per_agent=n_per_agent,
                    device=device)[3]
            return data_cache[m]
        raise _mixed_m_error(configs, indices, m,
                             f"the supplied data has {data.inner_x.shape[0]}")

    if pad_agents:
        bad = [i for i, c in enumerate(configs) if c.backend != "dense"]
        if bad:
            raise ValueError(
                "pad_agents=True needs the dense consensus backend (the "
                "padded mixing matrix is a traced vmap operand); configs "
                f"{bad} use {sorted({configs[i].backend for i in bad})}")
        ms = [c.resolve_num_agents(default_m) or default_m for c in configs]
        m_pad = pad_to if pad_to is not None else max(ms)
        if m_pad < max(ms):
            raise ValueError(
                f"pad_to={m_pad} is smaller than the grid's largest "
                f"network ({max(ms)} agents)")
        group_indices = _group_by_static_key(configs, pad_to=m_pad)
    else:
        m_pad, ms = None, None
        group_indices = _group_by_static_key(configs)

    pick = lambda stack, i: pytree.tree_map(lambda l: l[i], stack)
    start = lambda i: (x0 if x0_stack is None else pick(x0_stack, i),
                       y0 if y0_stack is None else pick(y0_stack, i))

    traces: list = [None] * len(configs)
    traces_seq: list | None = [None] * len(configs) \
        if compare_sequential else None
    states: list | None = [None] * len(configs) if return_states else None
    groups: list[SweepGroup] = []
    seconds = 0.0
    seconds_seq: float | None = 0.0 if compare_sequential else None

    for indices in group_indices:
        t0 = time.perf_counter()
        if pad_agents:
            parts, g_data = _padded_parts(
                configs, indices, ms, m_pad, problem, data_for, start,
                metric_fn, record_every, num_steps, device)
        else:
            parts, g_data = _plain_parts(
                configs, indices, default_m, problem, data_for, start,
                metric_fn, record_every, num_steps, device)
        metric = None
        solver = _GroupSolver(parts, None, device)
        if parts.one_metric is not None:
            metric = solver.metric
        g_state, g_trace = _timed(
            device, lambda: _run(solver, g_data, num_steps, record_every,
                                 metric))[0]
        took = time.perf_counter() - t0    # set-up, captures and the run
        if measure:
            (g_state, g_trace), took = _timed(
                device, lambda: _run(solver, g_data, num_steps,
                                     record_every, metric))
        seconds += took
        g_trace = g_trace.detach().cpu().numpy()
        g_trace = (g_trace.T if g_trace.ndim == 2
                   else np.zeros((len(indices), 0), np.float32))
        for row, i in enumerate(indices):
            traces[i] = g_trace[row]
            if return_states:
                states[i] = parts.layout.row(g_state, row)
        stepper = solver.stepper
        group = SweepGroup(
            indices=indices, config=configs[indices[0]], seconds=took,
            pad_to=m_pad,
            num_active=tuple(ms[i] for i in indices) if pad_agents else None,
            graphs=len(getattr(stepper, "graphs", ())),
            replays=getattr(stepper, "replays", 0),
            eager_steps=getattr(stepper, "eager_steps", 0), stepper=stepper)
        groups.append(group)

        if compare_sequential:
            single = _GroupSolver(parts, 0, device)
            row_metric = single.metric if metric is not None else None
            _run(single, g_data, num_steps, record_every, row_metric)

            def rows():
                out = []
                for r in range(len(indices)):
                    single.select(r)
                    out.append(_run(single, g_data, num_steps, record_every,
                                    row_metric)[1])
                return out

            seq, took_seq = _timed(device, rows)
            group.seconds_sequential = took_seq
            seconds_seq += took_seq
            for r, i in enumerate(indices):
                traces_seq[i] = seq[r].detach().cpu().numpy()

    return SweepResult(
        configs=configs, traces=np.stack(traces), groups=groups,
        seconds=seconds, seconds_sequential=seconds_seq, measured=measure,
        states=states, pad_to=m_pad,
        traces_sequential=(None if traces_seq is None
                           else np.stack(traces_seq)))


# -- the experiment functions of the three kinds of group ----------------------

def _samples_of(d: AgentData) -> int:
    return d.inner_x.shape[1] + d.outer_x.shape[1]


def _guarded(rep: SolverBase, param: Callable) -> Callable:
    """``param`` under the group's guard, if its config has one; the
    guard reads the representative's step counter, which the group
    fills before each step (``_GroupSolver.load_step``)."""
    if not rep.config.guard.active:
        return param
    return guard_param_step(param, rep.config.guard, rep._counter)


def _initial(rep: SolverBase, configs, indices, start, datas,
             active: list[int], num_steps: int, pad_to: int | None):
    """Every experiment's initial state (each from its own generator,
    as ``SolverBase.init`` makes it) and its run's draws, stacked as
    (steps, B, ...) on the device (``None`` for a solver without).
    ``datas[b]`` is experiment b's data, ``active[b]`` its agent count;
    a padded experiment's draws are padded to ``pad_to``."""
    states, draws = [], []
    device = datas[0].inner_x.device
    for b, i in enumerate(indices):
        d, m = datas[b], active[b]
        if rep.uses_draws:
            n_in, n_out = d.inner_x.shape[1], d.outer_x.shape[1]
            rep._sampler = Sampler(
                torch.Generator().manual_seed(configs[i].seed), m, n_in,
                n_out, rep.config.resolve_batch(n_in + n_out),
                rep._hg_cfg.neumann_k, pad_to=pad_to)
        x0, y0 = start(i)
        states.append(rep._init_state(rep._problem, rep._hg_cfg, x0, y0, d))
        if rep.uses_draws:
            draws.append(rep._sampler.draw(num_steps, "cpu"))
    rep._sampler = None
    stacked = None
    if draws:
        stacked = Draws(*(torch.stack(f, dim=1).to(device)
                          for f in zip(*draws)))
    return states, stacked


def _values(configs, indices, device) -> dict[str, torch.Tensor]:
    as_t = lambda vals: torch.tensor(vals, dtype=torch.float32,
                                     device=device)
    return {"alpha": as_t([configs[i].alpha for i in indices]),
            "beta": as_t([configs[i].beta for i in indices])}


def _plain_parts(configs, indices, default_m, problem, data_for, start,
                 metric_fn, record_every, num_steps, device):
    """An unpadded group: one network, one engine; a topology process
    whose realizations differ per experiment batches its streams (dense
    backend only)."""
    rep_cfg = configs[indices[0]]
    g_m = rep_cfg.resolve_num_agents(default_m) or default_m
    g_data = data_for(g_m, indices)
    m = g_data.inner_x.shape[0]
    n = _samples_of(g_data)
    spec = rep_cfg.mixing_spec(m)
    if spec.num_agents != m:
        raise _mixed_m_error(configs, indices, spec.num_agents,
                             f"its data has {m}")
    rep = make_solver(rep_cfg).build(problem, None, device=device, m=m, n=n)
    proc = rep_cfg.topology_process
    streams = None
    if not proc.is_static and not proc.state_dependent:
        ids = {(configs[i].topology_process.p,
                configs[i].topology_process.resolve_seed(configs[i].seed))
               for i in indices}
        if len(ids) > 1:
            if rep_cfg.backend != "dense":
                raise _mixed_process_error(
                    configs, indices, f"backend {rep_cfg.backend!r} cannot "
                    "take it as a traced operand")
            from repro_torch.topology.process import realize_stream
            streams = [realize_stream(
                configs[i].topology_process, spec,
                configs[i].topology_process.resolve_seed(configs[i].seed)
            ).matrices for i in indices]
    # else one realization: the engine built above carries it

    hg_cfg = rep._hg_cfg
    if streams is None:
        param = _guarded(rep, rep._param_step)
        shared = rep._engine

        def one_step(state, draws, ops):
            return param(state, g_data, draws, ops["alpha"], ops["beta"])
    else:
        shared = copy.copy(rep._engine)   # its attack noise, not its stream
        shared.topology = None

        def one_step(state, draws, ops):
            engine = copy.copy(shared)
            engine.topology = RoundTopology(ops["round"])
            param = _guarded(rep, rep._make_param_step(problem, hg_cfg,
                                                       engine, n))
            return param(state, g_data, draws, ops["alpha"], ops["beta"])

    group_metric = metric_fn
    if group_metric is None and record_every:
        from repro_torch.core.metrics import convergence_metric_fn
        group_metric = convergence_metric_fn(rep._problem, hg_cfg, g_data)
    one_metric = (None if group_metric is None
                  else lambda state, ops: group_metric(state))
    states, draws = _initial(rep, configs, indices, start,
                             [g_data] * len(indices), [m] * len(indices),
                             num_steps, None)
    return _Parts(rep=rep, one_step=one_step, one_metric=one_metric,
                  consts=_values(configs, indices, device),
                  layout=_Layout(states[0]), states=states, draws=draws,
                  shared=shared, streams=streams), g_data


def _padded_parts(configs, indices, ms, m_pad, problem, data_for, start,
                  metric_fn, record_every, num_steps, device):
    """A padded group: each experiment's network ghost-padded to
    ``m_pad``, its engine built inside the vmapped step from its padded
    matrix, active count, stream round and attack operands."""
    uniq: dict[int, int] = {}
    padded: list[AgentData] = []
    rows = []
    for i in indices:
        d = data_for(ms[i], [i])
        if id(d) not in uniq:
            uniq[id(d)] = len(padded)
            padded.append(pad_agent_data(d, m_pad))
        rows.append(uniq[id(d)])
    n = _samples_of(padded[0])
    if any(_samples_of(d) != n for d in padded):
        raise ValueError(
            "padded group mixes per-agent sample counts "
            f"{sorted({_samples_of(d) for d in padded})}; only "
            "the agent axis may differ under pad_agents")
    rep_cfg = configs[indices[0]]
    rep = make_solver(rep_cfg).build(problem, None, device=device,
                                     m=ms[indices[0]], n=n)
    hg_cfg = rep._hg_cfg
    mats = [pad_mixing(configs[i].mixing_spec(ms[i]), m_pad)
            for i in indices]
    consts = _values(configs, indices, device)
    consts["matrix"] = torch.as_tensor(np.stack(mats), dtype=torch.float32,
                                       device=device)
    consts["num_active"] = torch.tensor([ms[i] for i in indices],
                                        device=device)
    g_data = AgentData(*(torch.stack([padded[r][f] for r in rows])
                         for f in range(len(AgentData._fields))))
    consts.update({f"data_{k}": v for k, v in zip(AgentData._fields,
                                                  g_data)})
    base = DenseEngine(consts["matrix"][0], device,
                       compression=rep_cfg.compression,
                       communication_interval=rep_cfg.communication_interval,
                       byzantine=rep_cfg.byzantine)
    byz = rep_cfg.byzantine
    attack = None
    if byz.attack_active:
        d_x = sum(int(l.numel()) for l in pytree.tree_leaves(start(0)[0]))
        attack = (byz.kind, [
            (configs[i].byzantine.resolve_seed(configs[i].seed),
             configs[i].byzantine.num_byzantine, configs[i].byzantine.scale,
             ms[i]) for i in indices], m_pad, d_x)
        base.attack_schedule = None
    proc = rep_cfg.topology_process
    streams = None
    if not proc.is_static and not proc.state_dependent:
        from repro_torch.topology.process import realize_stream
        streams = [realize_stream(
            configs[i].topology_process, configs[i].mixing_spec(ms[i]),
            configs[i].topology_process.resolve_seed(configs[i].seed)
        ).padded(m_pad).matrices for i in indices]
    adaptive_tau = proc.tau if proc.state_dependent else None
    eye = torch.eye(m_pad, dtype=torch.bool, device=device)
    attack_kind = None if attack is None else make_attack(byz.kind)

    def data_of(ops) -> AgentData:
        return AgentData(*(ops[f"data_{k}"] for k in AgentData._fields))

    def one_step(state, draws, ops):
        engine = copy.copy(base)
        engine.matrix = ops["matrix"]
        engine.num_active = ops["num_active"]
        if attack_kind is not None:
            engine.attack_schedule = GroupAttackSchedule.view(attack_kind,
                                                              ops)
        if streams is not None:
            engine.topology = RoundTopology(ops["round"])
        elif adaptive_tau is not None:
            # ghost rows are identity: no edges, an identity row again
            adjacency = ((ops["matrix"].abs() > 1e-12) & ~eye).float()
            engine.topology = AdaptiveTopology(adjacency, adaptive_tau,
                                               device)
        param = _guarded(rep, rep._make_param_step(problem, hg_cfg, engine,
                                                   n))
        return param(state, data_of(ops), draws, ops["alpha"], ops["beta"])

    group_metric = metric_fn
    if group_metric is None and record_every:
        from repro_torch.core.metrics import masked_convergence_metric_fn
        group_metric = masked_convergence_metric_fn(rep._problem, hg_cfg)
    one_metric = (None if group_metric is None else
                  lambda state, ops: group_metric(state, data_of(ops),
                                                  ops["num_active"]))
    states, draws = _initial(rep, configs, indices, start,
                             [padded[r] for r in rows],
                             [ms[i] for i in indices], num_steps, m_pad)
    return _Parts(rep=rep, one_step=one_step, one_metric=one_metric,
                  consts=consts, layout=_Layout(states[0]), states=states,
                  draws=draws, streams=streams, attack=attack), g_data
