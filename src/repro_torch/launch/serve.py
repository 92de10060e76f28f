"""Serving CLI: decode a prompt batch token by token, then generate.

Counterpart of ``repro.launch.serve``, with the same options and a
``--device`` one (the CUDA card by default; ``--device cpu`` runs on the
CPU).  As in the JAX CLI, ``--reduced`` is on whatever is passed, so
this CLI always runs the reduced float32 config; full-size serving goes
through ``repro_torch.launch.serving`` (``chip_smoke.py`` does).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --batch 4 --prompt-len 64 --new-tokens 32 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serving import make_serve_step
from repro_torch.models import model as M


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_prefix_tokens=0, frontend="none",
                          dtype="float32")
    params = M.init_params(cfg, args.seed, with_head=True, device=device)
    print(f"{cfg.name}: {M.param_count(params):,} params "
          f"({'reduced' if args.reduced else 'full'}) on {device}")

    max_len = args.prompt_len + args.new_tokens
    cache = M.init_cache(cfg, batch=args.batch, max_len=max_len,
                         device=device)
    serve = make_serve_step(cfg, device=device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    t0 = time.time()
    logits = None
    with torch.inference_mode():
        for t in range(args.prompt_len):
            logits, cache = serve(params, prompts[:, t:t + 1], cache, t)
        synchronize(device)
        print(f"prefill {args.prompt_len} tokens x {args.batch}: "
              f"{time.time() - t0:.2f}s")

        def pick(logits):
            if args.temperature > 0:
                probs = torch.softmax(logits.float() / args.temperature, -1)
                return torch.multinomial(probs, 1, generator=gen)
            return torch.argmax(logits, dim=-1, keepdim=True)

        tok = pick(logits)
        out = [tok]
        t0 = time.time()
        for t in range(args.prompt_len, max_len - 1):
            logits, cache = serve(params, tok, cache, t)
            tok = pick(logits)
            out.append(tok)
        gen_tokens = torch.cat(out, dim=1).cpu()
    dt = time.time() - t0
    print(f"decoded {gen_tokens.shape[1]} x {args.batch} in {dt:.2f}s "
          f"({args.batch * gen_tokens.shape[1] / max(dt, 1e-9):.0f} tok/s)")
    for i in range(min(args.batch, 4)):
        print(f"  req {i}: {gen_tokens[i][:16].tolist()}")


if __name__ == "__main__":
    main()
