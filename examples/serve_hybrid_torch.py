"""Serving example on the PyTorch port: batched greedy decoding from the
Zamba2 hybrid (Mamba2 recurrent state + shared-attention ring cache), the
twin of examples/serve_hybrid.py.

    PYTHONPATH=src python examples/serve_hybrid_torch.py               # on CUDA
    PYTHONPATH=src python examples/serve_hybrid_torch.py --device cpu

The weights are drawn from seed 0 (the reference draws its own from a key;
`main(params=...)` takes any others, e.g. the reference's through
`repro_torch.convert`); the prompt is the reference's, drawn with the
port's bit-compatible `random.randint`.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs import get_config
from repro_torch.models import LM


def main(device=None, params=None, gen=48):
    cfg = get_config("zamba2-2.7b").reduced()
    window = 16                                # SWA on the shared attn block
    model = LM(cfg, remat=False)
    k_init, k_prompt = random.split(random.PRNGKey(0, device=device))
    dev = k_prompt.device
    if params is None:
        params = model.init(seed=0, device=dev)

    B, prompt_len = 4, 8
    total = prompt_len + gen
    cache = model.init_cache(B, total, window=window, dtype=torch.float32, device=dev)
    prompt = random.randint(k_prompt, (B, prompt_len), 0, cfg.vocab)

    toks = prompt[:, :1]
    out = [toks]
    t0 = time.time()
    with torch.no_grad():
        for t in range(total - 1):
            logits, cache = model.decode_step(params, cache, toks, t, window=window)
            toks = (prompt[:, t + 1:t + 2] if t + 1 < prompt_len
                    else torch.argmax(logits[:, -1:], -1).to(torch.int32))
            out.append(toks)
    seqs = torch.cat(out, dim=1).cpu().numpy()
    dt = time.time() - t0
    print(f"zamba2 hybrid decode: {B} seqs x {total} tokens "
          f"in {dt:.2f}s ({B*total/dt:.0f} tok/s on {dev.type.upper()})")
    print(f"SSM state: {cfg.n_layers} layers x "
          f"(H={cfg.ssm.expand*cfg.d_model//cfg.ssm.head_dim}, "
          f"N={cfg.ssm.d_state}, P={cfg.ssm.head_dim}) fp32; "
          f"shared-attn ring cache: {tuple(cache['shared'][0].k.shape)} (W={window})")
    print("sample:", np.asarray(seqs[0][:24]), "...")
    return seqs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run without a card)")
    ap.add_argument("--gen", type=int, default=48, help="tokens generated after the prompt")
    args = ap.parse_args()
    main(args.device, gen=args.gen)
