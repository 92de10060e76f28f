"""Time the bfloat16 tensor-core flash kernel with P as one bf16 term
against the two it carries.

``csrc/flash_attention.cu`` feeds P . V with P = bf16(p) + bf16(p -
bf16(p)) (``REPRO_FLASH_P_TERMS`` = 2, the default): the second term
takes the rounding of P out of the output's error and adds half again to
the tensor-core work.  This builds the source also with one term and, at
gemma2-2b's two attention shapes, times both variants interleaved in one
process (CUDA events, one, two, two, one, per round) and holds each
against the plain version in float32 on the same bf16 inputs by
``ops.row_errors``, the kernel's per-row gate.  Needs an NVIDIA Hopper
card and nvcc:

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench_p_terms

Prints one JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

from repro_torch.kernels.flash_attention import ops, ref

# gemma2-2b at the serving shape: (b, s, heads, kv heads, hd), softcap 50;
# global layers see every earlier key, local ones a 4096-token window
SHAPE = (4, 4608, 8, 4, 256)
WINDOWS = {"global": None, "local": 4096}
ROUNDS = 5      # of one, two, two, one
INNER = 10      # calls between two events


def time_pair(fns: dict) -> dict:
    """Median ms a call of each of ``fns`` ({1: fn, 2: fn}), timed in
    rounds of 1, 2, 2, 1 after a warm call of each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    samples = {t: [] for t in fns}
    for _ in range(ROUNDS):
        for t in (1, 2, 2, 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(INNER):
                fns[t]()
            end.record()
            end.synchronize()
            samples[t].append(start.elapsed_time(end) / INNER)
    return {t: (statistics.median(s), s) for t, s in samples.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU")
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = {1: ops.load(("REPRO_FLASH_P_TERMS=1",)), 2: ops.load()}
    b, s, nh, nkv, hd = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, window in WINDOWS.items():
        q = torch.randn(b, s, nh, hd, generator=gen, device=dev)
        k = torch.randn(b, s, nkv, hd, generator=gen, device=dev)
        v = torch.randn(b, s, nkv, hd, generator=gen, device=dev)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        kw = dict(causal=True, window=window, logit_softcap=50.0, q_offset=0)
        want = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
        outs = {t: torch.empty_like(q) for t in libs}
        fns = {t: (lambda t=t: ops.launch_tc(libs[t], q, k, v, outs[t],
                                             **kw))
               for t in libs}
        result = dict(shape=[b, s, s, nh, nkv, hd], window=window,
                      softcap=50.0)
        for t, fn in fns.items():
            fn()
            err = ops.row_errors(outs[t], want)
            result[f"row_err_{t}"] = float(err.max())
        del want
        for t, (ms, runs) in time_pair(fns).items():
            result[f"ms_{t}"] = ms
            result[f"ms_{t}_runs"] = runs
        print(f"p_terms {name}: {json.dumps(result)}", flush=True)
        del q, k, v, outs
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
