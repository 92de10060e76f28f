"""Time this tree's consensus kernels and WKV6 against another
checkout's, in turns on one card, and compare consensus_step's bits.

    git archive <commit> | tar -x -C build/other     # any git-ignored dir
    PYTHONPATH=src python -m repro_torch.kernels.bench_against build/other

Builds both trees' ``consensus_step.cu`` and ``wkv6.cu`` (nvcc, in
parallel), prints every consensus and WKV6 kernel's registers and
spills, then times both trees' kernels in the order other, this, this,
other (medians of warmed CUDA-event timings; the Section-6 shapes by
CUDA-graph replay): consensus_mix beside ``torch.matmul`` and WKV6,
each with the least time the card could take, and ``consensus_step`` at
chip_smoke.py's five timed shapes: 5x760 and (16, 4M) square, the sweep
groups' (4, 5, 760) batched with one shared M, and the row blocks of
``ROW_SHAPES`` (where the other tree has the form), beside the
``addmm`` / ``baddbmm`` pair and the plain version.  At each of those
shapes, in float32 and bfloat16, both trees' launchers run on the same
inputs and ``bitwise_equal`` says whether their outputs agree bit for
bit (float32 is timed, bfloat16 only compared).  ``this`` goes through
the wrapper, which allocates its outputs; ``this_raw`` calls this
tree's launcher on the preallocated buffers ``other`` writes, so that
the two compare kernel to kernel.  The batched mix is timed as the
batched step.  Each line is one JSON object; the last is the card's
name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.consensus_step import ops as mix_ops
from repro_torch.kernels.consensus_step import ref as mix_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref

ROOT = Path(__file__).resolve().parents[3]

# (m, D, dtype, by graph replay, calls a timing)
MIX_SHAPES = [(16, 4194304, torch.float32, False, 5),
              (16, 4194304, torch.bfloat16, False, 5),
              (5, 760, torch.float32, True, 200)]
# (b, s, h, N, dtype): rwkv6-3b's prefill in both dtypes
WKV_SHAPES = [(4, 1024, 40, 64, torch.bfloat16),
              (4, 1024, 40, 64, torch.float32)]
_CODES = {torch.float32: 0, torch.bfloat16: 1}
# consensus_step's launchers: the arguments between the seven pointers
# and the 16-byte flag (or the stream, where a tree has no flag)
_STEP_LAUNCHERS = ("repro_consensus_step", "repro_consensus_step_rows",
                   "repro_consensus_step_batched")


def _chip_smoke():
    """The repository's chip_smoke.py: its timing, bounds, nvcc report and
    card name, so that both scripts measure alike."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _takes_vec(source: str, name: str) -> bool:
    """Whether the launcher ``name`` of ``source`` takes the 16-byte flag."""
    found = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    return found is not None and "int vec" in found.group(1)


def _load_other(other: Path):
    """The other tree's two libraries, and which of its consensus launchers
    it has and take the 16-byte flag (``_bind_consensus``)."""
    rel_mix = mix_ops.SOURCE.relative_to(ROOT)
    rel_wkv = wkv_ops.SOURCE.relative_to(ROOT)
    sources = [other / rel_mix, other / rel_wkv, mix_ops.SOURCE,
               wkv_ops.SOURCE]
    # a source both trees share builds once
    unique = {build.library_path(src): src for src in sources}
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(build.build, unique.values())))
    libs = [built[build.library_path(src)] for src in sources]
    for src, lib in zip(sources, libs):
        report = _chip_smoke().ptxas_report(lib.with_suffix(".log").read_text())
        print(json.dumps({"source": str(src), "ptxas": report}), flush=True)
    mix = ctypes.CDLL(str(libs[0]))
    vec = _bind_consensus(mix, sources[0].read_text())
    wkv = ctypes.CDLL(str(libs[1]))
    wkv.repro_wkv6.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return mix, vec, wkv


def _bind_consensus(lib: ctypes.CDLL, source: str) -> dict:
    """Argument types for the consensus launchers ``lib`` has; returns
    {launcher: whether it takes the 16-byte flag} for those."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    middle = {"repro_consensus_mix": [i32, i64, i32],
              "repro_consensus_mix_batched": [i32, i64, i32, i64, i32],
              "repro_consensus_step": [i32, i64, f32, i32],
              "repro_consensus_step_rows": [i32, i64, i32, i32, f32, i32],
              "repro_consensus_step_batched": [i32, i64, i32, i64, ptr, i32]}
    vec = {}
    for name, args in middle.items():
        if hasattr(lib, name):
            vec[name] = _takes_vec(source, name)
            pointers = 3 if "_mix" in name else 7
            getattr(lib, name).argtypes = ([ptr] * pointers + args
                                           + [i32] * vec[name] + [ptr])
    return vec


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _turns(fns: dict, **kw) -> dict:
    """Each function timed in the order given, then again in reverse."""
    names = list(fns)
    time_ms = _chip_smoke().time_ms
    first = {n: time_ms(torch, fns[n], **kw) for n in names}
    second = {n: time_ms(torch, fns[n], **kw)
              for n in reversed(names)}
    return {n: [first[n], second[n]] for n in names}


def _step_cases(chip_smoke) -> list:
    """chip_smoke.py's five timed consensus_step shapes: (form, launcher,
    m, D, rows of the block or None, row0, experiments or None, by graph
    replay, calls a timing)."""
    main, large = chip_smoke.MAIN_SHAPE, chip_smoke.LARGE_SHAPE
    b, m, d = chip_smoke.SWEEP_SHAPE
    cases = [("square", _STEP_LAUNCHERS[0], *main, None, 0, None, True, 200),
             ("square", _STEP_LAUNCHERS[0], *large, None, 0, None, False, 5),
             ("batched", _STEP_LAUNCHERS[2], m, d, None, 0, b, True, 200)]
    for where, (rows, m, d, row0) in chip_smoke.ROW_SHAPES.items():
        main_shape = where == "main"
        cases.append(("rows", _STEP_LAUNCHERS[1], m, d, rows, row0, None,
                      main_shape, 200 if main_shape else 5))
    return cases


def _steps(chip_smoke, other, other_vec, gen, dev) -> None:
    """Both trees' consensus_step launchers at ``_step_cases`` in both
    dtypes: their outputs bit for bit, each against the plain version,
    and in float32 their times beside this tree's wrapper, the plain
    version and the PyTorch calls for the same function."""
    this = mix_ops.load()
    alpha = chip_smoke.ALPHA
    for form, name, m, d, rows, row0, b, graph, inner in _step_cases(
            chip_smoke):
        for dtype in (torch.float32, torch.bfloat16):
            table = (b, m, d) if b else (m, d)
            block = table if rows is None else (rows, d)
            M = torch.rand(*((1,) if b else ()), m, m, generator=gen,
                           device=dev) + 0.05
            M = (M / M.sum(dim=-1, keepdim=True)).contiguous()
            x, u = (torch.randn(*table, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            p, pp = (torch.randn(*block, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            alphas = torch.full((b or 1,), alpha, device=dev)
            outs = {tree: (torch.empty_like(p), torch.empty_like(p))
                    for tree in ("other", "this")}

            def args(tree):
                xo, uo = outs[tree]
                head = [t.data_ptr() for t in (M, x, u, p, pp, xo, uo)]
                head += [m, d]
                if form == "square":
                    head += [alpha]
                elif form == "rows":
                    head += [row0, rows, alpha]
                else:
                    head += [b, 0, alphas.data_ptr()]
                head.append(_CODES[dtype])
                if tree == "this" or other_vec[name]:
                    head.append(int(mix_ops.takes_16_byte_path(
                        x, u, p, pp, xo, uo)))
                return head

            launch = {"this_raw": (lambda a=args("this"):
                                   getattr(this, name)(*a, _stream()))}
            if name in other_vec:
                launch["other"] = (lambda a=args("other"):
                                   getattr(other, name)(*a, _stream()))
            for tree, fn in launch.items():
                err = fn()
                if err:
                    raise RuntimeError(f"{tree} {name}: CUDA error {err}")
            if form == "square":
                plain = lambda: mix_ref.consensus_step_ref(
                    M, x, u, p, pp, alpha=alpha)
            elif form == "rows":
                plain = lambda: mix_ref.consensus_step_rows_ref(
                    M, x, u, p, pp, row0=row0, alpha=alpha)
            else:
                plain = lambda: mix_ref.consensus_step_batched_ref(
                    M, x, u, p, pp, alphas)
            want = plain()
            torch.cuda.synchronize()

            def err_of(got):
                return max(float((g.float() - w.float()).abs().max())
                           for g, w in zip(got, want))
            rec = dict(kernel="consensus_step", form=form,
                       shape=list(table) if rows is None else [rows, m, d],
                       row0=row0,
                       dtype=str(dtype)[6:],
                       max_abs_err_this=err_of(outs["this"]))
            if "other" in launch:
                rec["bitwise_equal"] = all(torch.equal(a, c) for a, c in
                                           zip(outs["this"], outs["other"]))
                rec["max_abs_err_other"] = err_of(outs["other"])
            if dtype == torch.float32:
                if form == "square":
                    fns = dict(this=lambda: mix_ops.consensus_step_kernel(
                        M, x, u, p, pp, alpha=alpha),
                        addmm=lambda: (torch.addmm(u, M, x, beta=-alpha),
                                       torch.addmm(p - pp, M, u)))
                    bound = chip_smoke.bound_ms("consensus_step", m, d, 4)
                elif form == "rows":
                    Mr = M[row0:row0 + rows].contiguous()
                    ur = u[row0:row0 + rows].contiguous()
                    fns = dict(this=lambda: mix_ops.consensus_step_kernel(
                        M, x, u, p, pp, alpha=alpha, row0=row0),
                        addmm=lambda: (torch.addmm(ur, Mr, x, beta=-alpha),
                                       torch.addmm(p - pp, Mr, u)))
                    bound = chip_smoke.row_bound_ms("consensus_step", rows,
                                                    m, d, 4)
                else:
                    Mb = M.expand(b, m, m)
                    fns = dict(this=lambda: mix_ops.consensus_step_batched_kernel(
                        M, x, u, p, pp, alphas),
                        baddbmm=lambda: (
                            torch.baddbmm(u, Mb, x, beta=-alpha),
                            torch.baddbmm(p - pp, Mb, u)))
                    bound = chip_smoke.batched_bound_ms("consensus_step", b,
                                                        1, m, d, 4)
                fns = {**{k: launch[k] for k in ("other",) if k in launch},
                       **fns, "this_raw": launch["this_raw"],
                       "plain": plain}
                rec["ms"] = _turns(fns, inner=inner, graph=graph)
                rec["bound_ms"] = bound[0]
            print(json.dumps(rec), flush=True)


def _batched_mix(chip_smoke, other_mix, other_vec, gen, dev) -> None:
    """Both trees' batched mix at the sweep shape, one shared M, by graph
    replay, beside ``bmm``."""
    b, m, d = chip_smoke.SWEEP_SHAPE
    M = torch.rand(1, m, m, generator=gen, device=dev) + 0.05
    M = (M / M.sum(dim=-1, keepdim=True)).contiguous()
    Mb = M.expand(b, m, m)
    x = torch.randn(b, m, d, generator=gen, device=dev)
    out = torch.empty_like(x)
    this_mix = mix_ops.load()
    args = (M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d, b, 0, 0,
            int(mix_ops.mix_takes_16_byte_path(x, out)))
    fns = {"other": lambda: other_mix.repro_consensus_mix_batched(*args,
                                                                  _stream()),
           "this": lambda: mix_ops.consensus_mix_batched_kernel(M, x),
           "this_raw": lambda: this_mix.repro_consensus_mix_batched(
               *args, _stream()),
           "bmm": lambda: torch.bmm(Mb, x)}
    fns["other"]()
    got = fns["this"]()
    torch.cuda.synchronize()
    print(json.dumps(dict(
        kernel="consensus_mix_batched", shape=[b, m, d], dtype="float32",
        ms=_turns(fns, inner=200, graph=True),
        bound_ms=chip_smoke.batched_bound_ms("consensus_mix", b, 1, m, d,
                                             4)[0],
        max_abs_diff=float((got - out).abs().max()))), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke = _chip_smoke()
    other_mix, other_vec, other_wkv = _load_other(Path(argv[0]).resolve())
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    this_mix = mix_ops.load()
    for m, d, dtype, graph, inner in MIX_SHAPES:
        x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
        M = torch.rand(m, m, generator=gen, device=dev) + 0.05
        M = (M / M.sum(dim=1, keepdim=True)).contiguous()
        out = torch.empty_like(x)
        flag = int(mix_ops.mix_takes_16_byte_path(x, out))
        args = (M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d,
                _CODES[dtype], *((flag,) if other_vec["repro_consensus_mix"]
                                 else ()))
        raw = (M.data_ptr(), x.data_ptr(), out.data_ptr(), m, d,
               _CODES[dtype], flag)
        fns = {"other": lambda: other_mix.repro_consensus_mix(*args,
                                                              _stream()),
               "this": lambda: mix_ops.consensus_mix_kernel(M, x),
               "this_raw": lambda: this_mix.repro_consensus_mix(*raw,
                                                                _stream())}
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
    _steps(chip_smoke, other_mix, other_vec, gen, dev)
    if "repro_consensus_mix_batched" in other_vec:
        _batched_mix(chip_smoke, other_mix, other_vec, gen, dev)
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
        fns = {"other": lambda: other_wkv.repro_wkv6(*args, _stream()),
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
