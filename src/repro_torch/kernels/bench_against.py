"""Time this tree's consensus kernels and WKV6 against another
checkout's, in turns on one card.

    git archive <commit> | tar -x -C build/other     # any git-ignored dir
    PYTHONPATH=src python -m repro_torch.kernels.bench_against build/other

Builds both trees' ``consensus_step.cu`` and ``wkv6.cu`` (nvcc, in
parallel), prints each redesigned kernel's registers and spills, then
times both trees' kernels at the shapes below in the order other, this,
this, other (medians of warmed CUDA-event timings; the Section-6 shape
by CUDA-graph replay): consensus_mix beside ``torch.matmul``,
consensus_step (unbatched, alpha by value) beside the ``addmm`` pair,
both batched forms at chip_smoke.py's sweep shape (where the other tree
has them), and WKV6, each with the least time the card could take.
Consensus ``this`` goes through the wrapper, which allocates its
outputs; ``this_raw`` calls this tree's launcher on the preallocated
buffers ``other`` writes, so that the two compare kernel to kernel.  The
row-block forms (``row0=``) of this tree are timed at
chip_smoke.py's ``ROW_SHAPES`` beside their plain versions and the
library calls on the block's rows.  Each line is one JSON object; the
last is the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.consensus_step import ops as mix_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref

ROOT = Path(__file__).resolve().parents[3]

# (m, D, dtype, by graph replay, calls a timing)
MIX_SHAPES = [(16, 4194304, torch.float32, False, 5),
              (16, 4194304, torch.bfloat16, False, 5),
              (5, 760, torch.float32, True, 200)]
# (m, D, by graph replay, calls a timing), float32
STEP_SHAPES = [(16, 4194304, False, 5), (5, 760, True, 200)]
# (b, s, h, N, dtype): rwkv6-3b's prefill in both dtypes
WKV_SHAPES = [(4, 1024, 40, 64, torch.bfloat16),
              (4, 1024, 40, 64, torch.float32)]
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _chip_smoke():
    """The repository's chip_smoke.py: its timing, bounds, nvcc report and
    card name, so that both scripts measure alike."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _load_other(other: Path) -> tuple[ctypes.CDLL, bool, ctypes.CDLL]:
    """The other tree's two libraries, and whether its consensus_mix takes
    the 16-byte flag (this tree's signature) or not (before it).  Its
    batched launchers, where it has them, get their argument types."""
    rel_mix = mix_ops.SOURCE.relative_to(ROOT)
    rel_wkv = wkv_ops.SOURCE.relative_to(ROOT)
    sources = [other / rel_mix, other / rel_wkv, mix_ops.SOURCE,
               wkv_ops.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build.build, sources))
    for src, lib in zip(sources, libs):
        report = _chip_smoke().ptxas_report(lib.with_suffix(".log").read_text())
        print(json.dumps({"source": str(src), "ptxas": report}), flush=True)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    mix = ctypes.CDLL(str(libs[0]))
    has_vec = "int dtype, int vec" in sources[0].read_text()
    mix.repro_consensus_mix.argtypes = (
        [ptr] * 3 + [i32, i64, i32] + ([i32] if has_vec else []) + [ptr])
    mix.repro_consensus_step.argtypes = [ptr] * 7 + [i32, i64,
                                                     ctypes.c_float, i32,
                                                     ptr]
    if hasattr(mix, "repro_consensus_step_batched"):
        mix.repro_consensus_step_batched.argtypes = [ptr] * 7 + [
            i32, i64, i32, i64, ptr, i32, ptr]
        mix.repro_consensus_mix_batched.argtypes = [ptr] * 3 + [
            i32, i64, i32, i64, i32, i32, ptr]
    wkv = ctypes.CDLL(str(libs[1]))
    wkv.repro_wkv6.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    return mix, has_vec, wkv


def _turns(fns: dict, **kw) -> dict:
    """Each function timed in the order given, then again in reverse."""
    names = list(fns)
    time_ms = _chip_smoke().time_ms
    first = {n: time_ms(torch, fns[n], **kw) for n in names}
    second = {n: time_ms(torch, fns[n], **kw)
              for n in reversed(names)}
    return {n: [first[n], second[n]] for n in names}


def _batched(chip_smoke, other_mix, gen, dev, stream) -> None:
    """Both batched kernels of both trees at the sweep shape, one shared
    M, by graph replay, beside ``baddbmm`` / ``bmm``."""
    b, m, d = chip_smoke.SWEEP_SHAPE
    M = torch.rand(1, m, m, generator=gen, device=dev) + 0.05
    M = (M / M.sum(dim=-1, keepdim=True)).contiguous()
    Mb = M.expand(b, m, m)
    x, u, p, pp = (torch.randn(b, m, d, generator=gen, device=dev)
                   for _ in range(4))
    alpha = torch.full((b,), chip_smoke.ALPHA, device=dev)
    this_mix = mix_ops.load()
    xo, uo = torch.empty_like(x), torch.empty_like(u)
    vec = int(mix_ops.mix_takes_16_byte_path(x, xo))
    step_args = (M.data_ptr(), x.data_ptr(), u.data_ptr(), p.data_ptr(),
                 pp.data_ptr(), xo.data_ptr(), uo.data_ptr(), m, d, b, 0,
                 alpha.data_ptr(), 0)
    mix_args = (M.data_ptr(), x.data_ptr(), xo.data_ptr(), m, d, b, 0, 0,
                vec)
    cases = {
        "consensus_step_batched": {
            "other": lambda: other_mix.repro_consensus_step_batched(
                *step_args, stream()),
            "this": lambda: mix_ops.consensus_step_batched_kernel(
                M, x, u, p, pp, alpha),
            "this_raw": lambda: this_mix.repro_consensus_step_batched(
                *step_args, stream()),
            "baddbmm": lambda: (
                torch.baddbmm(u, Mb, x, beta=-chip_smoke.ALPHA),
                torch.baddbmm(p - pp, Mb, u))},
        "consensus_mix_batched": {
            "other": lambda: other_mix.repro_consensus_mix_batched(
                *mix_args, stream()),
            "this": lambda: mix_ops.consensus_mix_batched_kernel(M, x),
            "this_raw": lambda: this_mix.repro_consensus_mix_batched(
                *mix_args, stream()),
            "bmm": lambda: torch.bmm(Mb, x)}}
    for kernel, fns in cases.items():
        fns["other"]()
        got = fns["this"]()
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        diff = max(float((g - w).abs().max()) for g, w in zip(got, (xo, uo)))
        ms = _turns(fns, inner=200, graph=True)
        name = kernel.removesuffix("_batched")
        print(json.dumps(dict(
            kernel=kernel, shape=[b, m, d], dtype="float32", ms=ms,
            bound_ms=chip_smoke.batched_bound_ms(name, b, 1, m, d, 4)[0],
            max_abs_diff=diff)), flush=True)


def _row_blocks(chip_smoke, gen, dev) -> None:
    """This tree's row-block kernels at chip_smoke.py's ``ROW_SHAPES``,
    float32, beside their plain versions and the library calls on the
    block's rows (the Section-6 shape by graph replay)."""
    from repro_torch.kernels.consensus_step import ref
    alpha = chip_smoke.ALPHA
    for where, (rows, m, d, row0) in chip_smoke.ROW_SHAPES.items():
        M = torch.rand(m, m, generator=gen, device=dev) + 0.05
        M = (M / M.sum(dim=1, keepdim=True)).contiguous()
        x, u = (torch.randn(m, d, generator=gen, device=dev)
                for _ in range(2))
        p, pp = (torch.randn(rows, d, generator=gen, device=dev)
                 for _ in range(2))
        Mr = M[row0:row0 + rows].contiguous()
        ur = u[row0:row0 + rows].contiguous()
        cases = {
            "consensus_step_rows": {
                "this": lambda: mix_ops.consensus_step_kernel(
                    M, x, u, p, pp, alpha=alpha, row0=row0),
                "plain": lambda: ref.consensus_step_rows_ref(
                    M, x, u, p, pp, row0=row0, alpha=alpha),
                "addmm": lambda: (torch.addmm(ur, Mr, x, beta=-alpha),
                                  torch.addmm(p - pp, Mr, u))},
            "consensus_mix_rows": {
                "this": lambda: mix_ops.consensus_mix_kernel(
                    M, x, row0=row0, rows=rows),
                "plain": lambda: ref.consensus_mix_rows_ref(
                    M, x, row0=row0, rows=rows),
                "matmul": lambda: torch.matmul(Mr, x)}}
        graph, inner = (True, 200) if where == "main" else (False, 5)
        for kernel, fns in cases.items():
            got, want = fns["this"](), fns["plain"]()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            ms = _turns(fns, inner=inner, graph=graph)
            name = kernel.removesuffix("_rows")
            print(json.dumps(dict(
                kernel=kernel, shape=[rows, m, d], row0=row0,
                dtype="float32", ms=ms,
                bound_ms=chip_smoke.row_bound_ms(name, rows, m, d, 4)[0],
                max_abs_err=err)), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke = _chip_smoke()
    other_mix, has_vec, other_wkv = _load_other(Path(argv[0]).resolve())
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    this_mix = mix_ops.load()
    for m, d, dtype, graph, inner in MIX_SHAPES:
        x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
        M = torch.rand(m, m, generator=gen, device=dev) + 0.05
        M = (M / M.sum(dim=1, keepdim=True)).contiguous()
        out = torch.empty_like(x)
        vec = ((int(mix_ops.mix_takes_16_byte_path(x, out)),)
               if has_vec else ())
        args = (M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d,
                _CODES[dtype], *vec)
        raw = (M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d,
               _CODES[dtype], int(mix_ops.mix_takes_16_byte_path(x, out)))
        fns = {"other": lambda: other_mix.repro_consensus_mix(*args,
                                                              stream()),
               "this": lambda: mix_ops.consensus_mix_kernel(M, x),
               "this_raw": lambda: this_mix.repro_consensus_mix(*raw,
                                                                stream())}
        if dtype == torch.float32:
            fns["matmul"] = lambda: torch.matmul(M, x)
        fns["other"]()
        got = fns["this"]()
        torch.cuda.synchronize()
        ms = _turns(fns, inner=inner, graph=graph)
        print(json.dumps(dict(
            kernel="consensus_mix", shape=[m, d], dtype=str(dtype)[6:],
            ms=ms, bound_ms=chip_smoke.bound_ms("consensus_mix", m, d,
                                                x.element_size())[0],
            max_abs_diff=float((got.float() - out.float()).abs().max()))),
            flush=True)
    for m, d, graph, inner in STEP_SHAPES:
        M = torch.rand(m, m, generator=gen, device=dev) + 0.05
        M = (M / M.sum(dim=1, keepdim=True)).contiguous()
        x, u, p, pp = (torch.randn(m, d, generator=gen, device=dev)
                       for _ in range(4))
        xo, uo = torch.empty_like(x), torch.empty_like(u)
        alpha = chip_smoke.ALPHA
        args = (M.data_ptr(), x.data_ptr(), u.data_ptr(), p.data_ptr(),
                pp.data_ptr(), xo.data_ptr(), uo.data_ptr(), m, d, alpha, 0)
        fns = {"other": lambda: other_mix.repro_consensus_step(*args,
                                                               stream()),
               "this": lambda: mix_ops.consensus_step_kernel(
                   M, x, u, p, pp, alpha=alpha),
               "this_raw": lambda: this_mix.repro_consensus_step(*args,
                                                                 stream()),
               "addmm": lambda: (torch.addmm(u, M, x, beta=-alpha),
                                 torch.addmm(p - pp, M, u))}
        fns["other"]()
        got = fns["this"]()
        torch.cuda.synchronize()
        ms = _turns(fns, inner=inner, graph=graph)
        print(json.dumps(dict(
            kernel="consensus_step", shape=[m, d], dtype="float32", ms=ms,
            bound_ms=chip_smoke.bound_ms("consensus_step", m, d, 4)[0],
            max_abs_diff=max(float((got[0] - xo).abs().max()),
                             float((got[1] - uo).abs().max())))), flush=True)
    if hasattr(other_mix, "repro_consensus_step_batched"):
        _batched(chip_smoke, other_mix, gen, dev, stream)
    _row_blocks(chip_smoke, gen, dev)
    for b, s, h, n, dtype in WKV_SHAPES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        r, k, v = (randn(b, s, h, n).to(dtype) for _ in range(3))
        w = (torch.sigmoid(randn(b, s, h, n) * 2.0 - 1.0) * 0.6
             + 0.35).to(dtype)
        u = 0.3 * randn(h, n)
        out = torch.empty_like(r)
        state = torch.empty(b, h, n, n, device=dev)
        args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None, out.data_ptr(), state.data_ptr(), b, s,
                h, n, _CODES[dtype])
        fns = {"other": lambda: other_wkv.repro_wkv6(*args, stream()),
               "this": lambda: wkv_ops.wkv6(r, k, v, w, u)}
        fns["other"]()
        got, _ = fns["this"]()
        want, _ = wkv_ref.wkv6_ref(r, k, v, w, u)
        torch.cuda.synchronize()
        ms = _turns(fns, inner=10, reps=5)
        print(json.dumps(dict(
            kernel="wkv6", shape=[b, s, h, n], dtype=str(dtype)[6:], ms=ms,
            bound_ms=chip_smoke.wkv_bound_ms(b, s, h, n, False,
                                             r.element_size())[0],
            max_abs_err_this=float((got.float() - want.float()).abs().max()),
            max_abs_err_other=float((out.float() - want.float()).abs().max()
                                    ))), flush=True)
    print(chip_smoke.gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
