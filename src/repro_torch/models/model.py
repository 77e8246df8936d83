"""The dense LM family, training path. Counterpart of ``repro/models/model.py``.

    lm = build_model(cfg)                         # cfg: ModelConfig, family 'dense'
    params = lm.init(seed=0)                      # on CUDA; device="cpu" for the CPU
    loss, metrics = lm.loss(params, batch)        # batch: tokens/labels (B, S)

Params are a plain nested dict with the reference's structure and names:
block params stay stacked with a leading (L,) layer axis, as the
reference's `lax.scan` layout has them, so the flat buffer of one package
is the flat buffer of the other (see `repro_torch.convert`). `init` draws
from its own torch generator, not from jax's key stream.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import embed_init, rms_norm

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def chunked_lm_loss(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over positions with label >= 0, without holding
    (B, S, V) logits for more than `chunk` positions at a time.

    x: (B, S, d) final hiddens; unembed: (d, V); labels: (B, S) int."""
    S = x.shape[1]
    chunk = min(chunk, S)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for start in range(0, S, chunk):
        xi = x[:, start:start + chunk]
        li = labels[:, start:start + chunk].to(torch.int64)
        logits = torch.einsum("bsd,dv->bsv", xi, unembed).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.clamp(min=0)[..., None])[..., 0]
        mask = (li >= 0).to(torch.float32)
        tot = tot + torch.sum((logz - gold) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0)


def _layers(blocks: Params, n_layers: int) -> List[Params]:
    """Every layer's params as views of the stacked (L, ...) leaves.

    One `unbind` per stacked leaf: its backward stacks the L layer
    gradients in one pass. Indexing layer i instead would give each layer
    a backward that writes a zero-filled (L, ...) gradient and adds it in,
    L times the traffic and launches."""
    def split(nt):
        cols = [(None,) * n_layers if t is None else torch.unbind(t) for t in nt]
        return [type(nt)(*layer) for layer in zip(*cols)]

    ln1, ln2 = torch.unbind(blocks["ln1"]), torch.unbind(blocks["ln2"])
    return [{"ln1": a, "ln2": b, "attn": at, "ffn": f}
            for a, b, at, f in zip(ln1, ln2, split(blocks["attn"]), split(blocks["ffn"]))]


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} waits for a later slice of the port")
        self.cfg = cfg

    def init(self, seed: int = 0, device=None, dtype=torch.float32) -> Params:
        """Random weights from `seed` on `device` (CUDA when None). They are
        drawn from a CPU generator and then moved, so a seed gives the same
        weights on every device."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        L, d = cfg.n_layers, cfg.d_model
        layers = [(attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim, cfg.qkv_bias, dtype),
                   mlp_mod.init_swiglu(gen, d, cfg.d_ff, dtype))
                  for _ in range(L)]

        def stack(nts):
            return type(nts[0])(*(None if leaves[0] is None else torch.stack(leaves).to(dev)
                                  for leaves in zip(*nts)))

        p: Params = {
            "embed": embed_init((cfg.vocab, d), gen, dtype).to(dev),
            "ln_f": torch.ones(d, dtype=dtype, device=dev),
            "blocks": {"ln1": torch.ones(L, d, dtype=dtype, device=dev),
                       "ln2": torch.ones(L, d, dtype=dtype, device=dev),
                       "attn": stack([a for a, _ in layers]),
                       "ffn": stack([f for _, f in layers])},
        }
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init((d, cfg.vocab), gen, dtype).to(dev)
        return p

    def _unembed(self, params: Params) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["unembed"]

    def forward(self, params: Params, batch: Batch) -> torch.Tensor:
        """Final hiddens (B, S, d)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(torch.int64)
        x = F.embedding(tokens, params["embed"])
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for blk in _layers(params["blocks"], cfg.n_layers):
            x = x + attn.attention_forward(blk["attn"],
                                           rms_norm(x, blk["ln1"], cfg.norm_eps),
                                           positions=positions,
                                           rope_theta=cfg.rope_theta)
            x = x + mlp_mod.mlp_forward(blk["ffn"], rms_norm(x, blk["ln2"], cfg.norm_eps))
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def loss(self, params: Params, batch: Batch) -> Tuple[torch.Tensor, Dict]:
        ce = chunked_lm_loss(self.forward(params, batch), self._unembed(params),
                             batch["labels"])
        return ce, {"ce": ce}


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
