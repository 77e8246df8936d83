"""Batched serving driver: greedy decode with KV/SSM caches. Counterpart of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --batch 4 --prompt-len 16 --gen 32 --reduced [--device cpu]

As in the reference, ``--reduced`` is a store_true flag whose default is
True, so the driver always serves the reduced config; `greedy_decode` is
the loop, callable at any width. Serving is DP-free: the trained model is
the eps-DP artifact (post-processing invariance). An audio arch runs its
encoder once over frames drawn from the seed (the stubbed frontend) to
prime the cross-attention cache. The decode path reaches no kernel, as in
the reference.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.model import LM, Params
from repro_torch.sharding import spmd


def greedy_decode(model: LM, params: Params, cache: Any, prompt: torch.Tensor, gen: int,
                  window: Optional[int] = None, *, step=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feed `prompt` (B, P) one token at a time, then `gen` greedy tokens.

    Returns (tokens (B, P + gen), logits (B, P + gen - 1, V) of every
    step, f32). Step t decodes the token at position t and the prompt
    overrides the argmax while t + 1 < P, as the reference's loop does.

    `step` (default `model.decode_step` at `window`) is called as
    step(params, cache, tokens, t): a meshed bundle's step
    (``launch.steps.build_serve_step(..., mesh)``), with `params` and
    `cache` placed by its `in_shardings`, places each step's tokens
    itself; its logits are gathered whole on every rank for the argmax,
    so the tokens and logits returned are plain tensors."""
    if step is None:
        def step(params, cache, toks, t):
            return model.decode_step(params, cache, toks, t, window=window)
    plen = prompt.shape[1]
    total = plen + gen
    toks = prompt[:, :1]
    out, logits = [toks], []
    for t in range(total - 1):
        lg, cache = step(params, cache, toks, t)
        if spmd.is_dtensor(lg):
            lg = lg.full_tensor()
        logits.append(lg[:, -1].to(torch.float32))
        if t + 1 < plen:
            toks = prompt[:, t + 1:t + 2]
        else:
            toks = torch.argmax(lg[:, -1:], dim=-1).to(prompt.dtype)
        out.append(toks)
    return torch.cat(out, dim=1), torch.stack(logits, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, remat=False)      # as the reference's launcher
    params = model.init(seed=args.seed, device=dev)

    B = args.batch
    total = args.prompt_len + args.gen
    cache = model.init_cache(B, total, window=args.window, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(args.seed + 1)
    if cfg.family == "audio":
        frames = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen).to(dev)
        cache = model.prime_cross_cache(params, cache, frames)
    prompt = torch.randint(0, cfg.vocab, (B, args.prompt_len), generator=gen,
                           dtype=torch.int32).to(dev)
    t0 = time.time()
    seqs, _ = greedy_decode(model, params, cache, prompt, args.gen, args.window)
    seqs = seqs.cpu().numpy()
    dt = time.time() - t0
    print(f"arch={cfg.name} decoded {B}x{total} tokens in {dt:.2f}s "
          f"({B*total/dt:.1f} tok/s)")
    print("first sequence:", np.asarray(seqs[0][:40]), "...")
    return seqs


if __name__ == "__main__":
    main()
