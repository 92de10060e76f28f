#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: full float32 matmuls (no TF32), versions, the card's
   name and power limit.  Exits non-zero at once without a CUDA device.
2. Build: compiles the consensus kernels from the repository's CUDA
   source with nvcc (first use) and prints the build time.
3. Kernels: each kernel against its plain PyTorch version on the card,
   over the test shapes, the main-path shape and one large shape, each
   with a symmetric and a random non-symmetric mixing matrix; times
   (median of warmed CUDA-event timings; at the main-path shape of CUDA
   graph replays, which leave out Python's issue cost, and also eager),
   bounds and library yardsticks.
4. Main path: ``solve`` of INTERACT on the Section-6 instance at full
   size, 40 steps, with the ``cuda`` backend and then ``dense``; checks
   that both eq.-11 traces fall and agree and that the ``cuda`` run went
   through both kernels (launch counts set to 0 just before it).  Then
   profiles 3 ``cuda`` steps: device time and kernel launches per step.
5. Prints a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
   script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.  Both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

ALPHA = 0.3
F32_TOL, BF16_TOL = 1e-5, 3e-2
MAIN_SHAPE = (5, 760)          # m agents x D = 760 backbone parameters
LARGE_SHAPE = (16, 4194304)    # large enough that the kernel, not the launch, sets the time
NUM_STEPS, RECORD_EVERY = 40, 5
# The cuda and dense runs differ only in how the mix is summed (the
# kernel's sequential FMAs vs cuBLAS), a float32 rounding difference.
# The port's one-step state gap against the JAX package is below 2e-6
# of each field's scale (tests/test_torch_interact.py); over 40 steps
# that allows 40 * 2e-6 = 8e-5 relative between the two traces.
TRACE_RTOL = NUM_STEPS * 2e-6

SOURCE = "src/repro_torch/kernels/consensus_step/csrc/consensus_step.cu"
REPLACES = {
    "consensus_step": "src/repro/kernels/consensus_step/kernel.py:83",
    "consensus_mix": "src/repro/kernels/consensus_step/kernel.py:52",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, inner: int, reps: int = 7, graph: bool = False
            ) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call, after a warm run.

    Eager calls are issued from Python, so for a small kernel the events
    measure the host's issue rate.  ``graph=True`` captures the ``inner``
    calls in a CUDA graph once and times its replays: the device's own
    time per call, launch gaps inside the graph included.
    """
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    run()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound_ms(kernel: str, m: int, d: int, itemsize: int) -> tuple[float, str]:
    """Least time for the work: each input read once, each output written
    once, over HBM bandwidth; the flops over the float32 peak."""
    if kernel == "consensus_step":
        nbytes = 6 * m * d * itemsize + m * m * 4
        flops = 4 * m * m * d + 4 * m * d
    else:
        nbytes = 2 * m * d * itemsize + m * m * 4
        flops = 2 * m * m * d
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, ops, ref, main_matrix):
    """Every kernel against its plain version; times at two shapes."""
    from repro_torch.core import ring_mixing
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = ([(m, d, f32) for m in (4, 5, 8, 16)
              for d in (123, 512, 700, 2048)]
             + [(8, 512, bf16), MAIN_SHAPE + (f32,), LARGE_SHAPE + (f32,)])
    err = {k: {"float32": 0.0, "bfloat16": 0.0} for k in REPLACES}
    timings = {k: {} for k in REPLACES}
    for m, d, dtype in cases:
        # the path's own (symmetric) matrix, and a random row-normalised
        # one that is not symmetric: a kernel reading M transposed or with
        # the wrong stride agrees on the first and fails on the second
        if (m, d) == MAIN_SHAPE:
            sym = main_matrix
        else:
            sym = torch.tensor(ring_mixing(m).matrix, dtype=f32, device=dev)
        skew = torch.rand(m, m, generator=gen, device=dev) + 0.05
        skew = (skew / skew.sum(dim=1, keepdim=True)).contiguous()
        check(not torch.allclose(skew, skew.T), "random matrix is symmetric")
        X, U, P, PP = (torch.randn(m, d, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        tol = F32_TOL if dtype == f32 else BF16_TOL
        kind = "float32" if dtype == f32 else "bfloat16"
        case_err = {name: 0.0 for name in REPLACES}
        for M in (sym, skew):
            got = {"consensus_step": ops.consensus_step_kernel(
                       M, X, U, P, PP, alpha=ALPHA),
                   "consensus_mix": (ops.consensus_mix_kernel(M, X),)}
            want = {"consensus_step": ref.consensus_step_ref(
                        M, X, U, P, PP, alpha=ALPHA),
                    "consensus_mix": (ref.consensus_mix_ref(M, X),)}
            torch.cuda.synchronize()
            for name in REPLACES:
                for g, w in zip(got[name], want[name]):
                    check(g.dtype == dtype and g.shape == w.shape,
                          f"{name} {m}x{d}: dtype/shape")
                    check(torch.allclose(g.float(), w.float(), atol=tol,
                                         rtol=tol),
                          f"{name} {m}x{d} {kind} disagrees with its plain "
                          f"version beyond {tol}")
                    case_err[name] = max(
                        case_err[name],
                        float((g.float() - w.float()).abs().max()))
        for name in REPLACES:
            err[name][kind] = max(err[name][kind], case_err[name])
        print(f"case m={m} D={d} {kind} (symmetric and random M): max abs "
              f"err step {case_err['consensus_step']:.3e} mix "
              f"{case_err['consensus_mix']:.3e} (tol {tol})", flush=True)
        if (m, d) not in (MAIN_SHAPE, LARGE_SHAPE):
            continue
        M = sym
        step = lambda: ops.consensus_step_kernel(M, X, U, P, PP, alpha=ALPHA)
        mix = lambda: ops.consensus_mix_kernel(M, X)
        plain_step = lambda: ref.consensus_step_ref(M, X, U, P, PP,
                                                    alpha=ALPHA)
        plain_mix = lambda: ref.consensus_mix_ref(M, X)
        lib_step = lambda: (torch.addmm(U, M, X, beta=-ALPHA),
                            torch.addmm(P - PP, M, U))
        lib_mix = lambda: torch.matmul(M, X)
        for name, fn, plain, lib in (
                ("consensus_step", step, plain_step, lib_step),
                ("consensus_mix", mix, plain_mix, lib_mix)):
            b, by = bound_ms(name, m, d, X.element_size())
            if (m, d) == MAIN_SHAPE:
                # device time from graph replays, and the eager issue rate
                timings[name]["main"] = dict(
                    shape=[m, d], ms=time_ms(torch, fn, 200, graph=True),
                    plain_ms=time_ms(torch, plain, 200, graph=True),
                    library_ms=time_ms(torch, lib, 200, graph=True),
                    eager_ms=time_ms(torch, fn, 200),
                    eager_plain_ms=time_ms(torch, plain, 200),
                    eager_library_ms=time_ms(torch, lib, 200),
                    bound_ms=b, bound_by=by)
            else:
                timings[name]["large"] = dict(
                    shape=[m, d], ms=time_ms(torch, fn, 5),
                    plain_ms=time_ms(torch, plain, 5),
                    library_ms=time_ms(torch, lib, 5),
                    bound_ms=b, bound_by=by)
    return err, timings


def profile_steps(torch, solver, state, data, steps: int = 3) -> dict:
    """Device time and kernel launches per main-path step under
    ``torch.profiler`` (kernel events only: their durations summed)."""
    solver.warmup(state, data)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        solver.run(state, data, steps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        steps=steps,
        device_us_per_step=sum(e.self_device_time_total
                               for e in kernels) / steps,
        device_kernels_per_step=sum(e.count for e in kernels) / steps,
        top=[dict(name=e.key[:80], us_per_step=e.self_device_time_total
                  / steps, count_per_step=e.count / steps) for e in top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power_limit()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import build
    from repro_torch.kernels.consensus_step import ops, ref
    from repro_torch.solvers import (SolverConfig, default_setup,
                                     make_solver, solve)
    from repro_torch.solvers.config import TopologyConfig

    t0 = time.perf_counter()
    ops.load()
    lib = build.library_path(ops.SOURCE)
    print(f"built {lib.relative_to(ROOT)} from {SOURCE} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    main_matrix = torch.tensor(TopologyConfig().mixing_spec(5).matrix,
                               dtype=torch.float32, device=dev)
    err, timings = check_kernels(torch, ops, ref, main_matrix)

    # -- the main path: counts to 0 just before, read just after ----------
    cfg = dict(algo="interact", alpha=0.3, beta=0.3)
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    res_cuda = solve(SolverConfig(backend="cuda", **cfg), NUM_STEPS,
                     RECORD_EVERY)
    launches = dict(ops.LAUNCHES)
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_dense = solve(SolverConfig(backend="dense", **cfg), NUM_STEPS,
                      RECORD_EVERY)
    t_dense = time.perf_counter() - t0
    check(ops.LAUNCHES == launches, "the dense run launched a kernel")

    for name, res, took in (("cuda", res_cuda, t_cuda),
                            ("dense", res_dense, t_dense)):
        print(f"main path {name}: eq.-11 trace {res.trace}", flush=True)
        print(f"main path {name}: us_per_step {res.us_per_step:.1f} "
              f"round_latency_us {res.round_latency_us:.1f} "
              f"hvp/step {res.hvp_per_step} grad/step {res.grad_per_step} "
              f"wall {took:.1f} s", flush=True)
        check(len(res.trace) == NUM_STEPS // RECORD_EVERY + 1,
              f"{name}: trace length")
        check(all(math.isfinite(v) for v in res.trace),
              f"{name}: non-finite eq.-11 trace")
        check(res.trace[-1] < res.trace[0],
              f"{name}: M_40 = {res.trace[-1]} is not below M_0 = "
              f"{res.trace[0]}")
        check((res.hvp_per_step, res.grad_per_step) == (33, 1),
              f"{name}: hypergradient counts")
    # -- where a main-path step's time goes (after the counts were read) --
    problem, x0, y0, data = default_setup(0)
    solver = make_solver(SolverConfig(backend="cuda", **cfg))
    profile = profile_steps(torch, solver,
                            solver.init(problem, None, x0, y0, data), data)
    if profile["device_us_per_step"] > 0:
        profile["device_busy_share"] = (profile["device_us_per_step"]
                                        / res_cuda.us_per_step)
    else:
        profile["device_busy_share"] = "not measured: no device events"
    print(json.dumps({"profile": profile}), flush=True)

    rel = max(abs(a - b) / abs(b)
              for a, b in zip(res_cuda.trace, res_dense.trace))
    print(f"main path: launches {launches}; cuda vs dense trace max "
          f"relative gap {rel:.3e} (tolerance {TRACE_RTOL:.1e})", flush=True)
    check(rel <= TRACE_RTOL, "cuda and dense traces disagree")
    check(launches["consensus_step"] >= NUM_STEPS,
          f"consensus_step launched {launches['consensus_step']} times")
    check(launches["consensus_mix"] >= 1, "consensus_mix never launched")

    kernels = []
    for name in REPLACES:
        main = timings[name]["main"]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name],
            max_abs_err=err[name]["float32"],
            max_abs_err_bf16=err[name]["bfloat16"],
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], eager_ms=main["eager_ms"],
            eager_plain_ms=main["eager_plain_ms"],
            eager_library_ms=main["eager_library_ms"],
            library_call=("addmm(u, M, x, beta=-alpha) + addmm(p - p_prev, "
                          "M, u)" if name == "consensus_step"
                          else "matmul(M, x)"),
            shape=main["shape"], large=timings[name]["large"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
