"""Time the linearize-once hypergradient backends on the card, in each
of the forms a solve takes.

On the Section-6 instance at full width (``default_setup(0)``: 5 agents,
600 samples each, D_y = 105), for ``cg`` and ``neumann`` and their
linearized counterparts (32 CG trips, K = 8, L_g = 4), one inverse
application ``engine.solve`` on agent 0's inner batch is timed:

* ``eager``: outside any transform, the linearized backends trace
  ``grad_y g`` once with ``torch.func.linearize`` and replay its tangent;
* ``captured``: the same call captured once in a CUDA graph and replayed
  (the trace runs at capture time; a replay runs the tangent kernels);
* ``vmapped``: under ``torch.func.vmap`` over the 5 agents, as the
  solvers call it, where the linearized backends apply a fresh jvp of
  the y-gradient each time (linearize has no batching rule).

Host clock around synchronised calls for the eager and vmapped forms
(median of ``REPS`` after a warm call), CUDA events over ``INNER``
replays for the captured one.  Needs an NVIDIA card:

    PYTHONPATH=src python -m repro_torch.hypergrad.bench_linearized

Prints one JSON line a backend, then the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from repro_torch.hypergrad import HypergradConfig, get_backend
from repro_torch.solvers import default_setup

BACKENDS = ("cg", "cg-linearized", "neumann", "neumann-linearized")
REPS, INNER = 7, 20


def _wall_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(runs)


def _replay_ms(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(INNER):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / INNER


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    problem, x0, y0, data = default_setup(0)
    outer = lambda i: (data.outer_x[i], data.outer_y[i])
    inner = lambda i: (data.inner_x[i], data.inner_y[i])
    b = torch.func.grad(problem.outer, argnums=1)(x0, y0, outer(0))
    m = data.inner_x.shape[0]
    bs = torch.func.vmap(
        lambda ob: torch.func.grad(problem.outer, argnums=1)(x0, y0, ob))(
        (data.outer_x, data.outer_y))
    for name in BACKENDS:
        cfg = HypergradConfig(backend=name, neumann_k=8, lipschitz_g=4.0)
        engine = get_backend(name)
        one = lambda: engine.solve(problem.inner, x0, y0, b, cfg,
                                   (inner(0),))
        batched = lambda: torch.func.vmap(
            lambda bb, ib: engine.solve(problem.inner, x0, y0, bb, cfg,
                                        (ib,))[0])(
            bs, (data.inner_x, data.inner_y))
        _, stats = one()
        print(json.dumps(dict(
            backend=name, hvp_count=int(stats.hvp_count),
            grad_count=int(stats.grad_count), eager_ms=_wall_ms(one),
            captured_ms=_replay_ms(one),
            vmapped_ms=_wall_ms(batched), vmapped_agents=m)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
