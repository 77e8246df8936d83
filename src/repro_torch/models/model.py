"""The dense and hybrid LM families. Counterpart of ``repro/models/model.py``.

    lm = build_model(cfg)                           # family 'dense' or 'hybrid'
    params = lm.init(seed=0)                        # on CUDA; device="cpu" for the CPU
    loss, metrics = lm.loss(params, batch)          # train / prefill
    cache = lm.init_cache(batch_size, max_seq, window=...)
    logits, cache = lm.decode_step(params, cache, tokens, pos, window=...)

Params are a plain nested dict with the reference's structure and names:
block params stay stacked with a leading (L,) layer axis, as the
reference's `lax.scan` layout has them, so the flat buffer of one package
is the flat buffer of the other (see `repro_torch.convert`). The forward
walks the layers on per-layer views. `init` draws from its own torch
generator, not from jax's key stream.

`attn_backend` is the reference's: "jnp" runs the blockwise attention of
plain torch ops, "pallas" the flash kernel's entry point; every Mamba2
layer's SSD scan goes through the ssm_scan kernel's entry point. Both
entry points run their plain versions on CPU tensors and the Hopper
kernels on CUDA tensors. The moe, vlm, audio and ssm (xLSTM) families
wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PORTED_FAMILIES, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
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


def _unbind(tree: Any, n_layers: int) -> List[Any]:
    """The n_layers per-layer views of a tree of stacked (L, ...) leaves.

    One `unbind` per stacked leaf: its backward stacks the L layer
    gradients in one pass. Indexing layer i instead would give each layer
    a backward that writes a zero-filled (L, ...) gradient and adds it in,
    L times the traffic and launches."""
    if isinstance(tree, dict):
        cols = {k: _unbind(v, n_layers) for k, v in tree.items()}
        return [{k: cols[k][i] for k in tree} for i in range(n_layers)]
    if isinstance(tree, tuple):                     # a NamedTuple of leaves
        cols = [(None,) * n_layers if t is None else torch.unbind(t) for t in tree]
        return [type(tree)(*layer) for layer in zip(*cols)]
    return list(torch.unbind(tree))


def _stack(items: List[Any], dev: torch.device) -> Any:
    """Stack per-layer trees (dicts and NamedTuples of tensors) into one
    tree of (L, ...) leaves on `dev`."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items], dev) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(None if leaves[0] is None else torch.stack(leaves).to(dev)
                             for leaves in zip(*items)))
    return torch.stack(items).to(dev)


class LM:
    def __init__(self, cfg: ModelConfig, *, attn_backend: str = "jnp"):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} waits for a later slice of the port "
                f"(the port runs {', '.join(PORTED_FAMILIES)})")
        if attn_backend not in ("jnp", "pallas"):
            raise ValueError(f"unknown attention backend {attn_backend!r}")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                             f"attn_every {cfg.attn_every}")
        self.cfg = cfg
        self.attn_backend = attn_backend

    # ---------------- init -------------------------------------------
    def init(self, seed: int = 0, device=None, dtype=torch.float32) -> Params:
        """Random weights from `seed` on `device` (CUDA when None). They are
        drawn from a CPU generator and then moved, so a seed gives the same
        weights on every device."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        L, d = cfg.n_layers, cfg.d_model

        def attention():
            return attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                       cfg.qkv_bias, dtype)

        if cfg.family == "dense":
            layers = [{"ln1": torch.ones(d, dtype=dtype), "ln2": torch.ones(d, dtype=dtype),
                       "attn": attention(),
                       "ffn": mlp_mod.init_swiglu(gen, d, cfg.d_ff, dtype)} for _ in range(L)]
        else:
            layers = [{"ln": torch.ones(d, dtype=dtype),
                       "mamba": ssm_mod.init_mamba2(gen, d, cfg.ssm, dtype)} for _ in range(L)]
        p: Params = {
            "embed": embed_init((cfg.vocab, d), gen, dtype).to(dev),
            "ln_f": torch.ones(d, dtype=dtype, device=dev),
            "blocks": _stack(layers, dev),
        }
        del layers
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init((d, cfg.vocab), gen, dtype).to(dev)
        if cfg.family == "hybrid":
            p["shared_ln"] = torch.ones(d, dtype=dtype, device=dev)
            p["shared_attn"] = attn.AttnParams(*(None if t is None else t.to(dev)
                                                 for t in attention()))
        return p

    def _unembed(self, params: Params) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["unembed"]

    # ---------------- forward (train / prefill) ----------------------
    def forward(self, params: Params, batch: Batch, *,
                window: Optional[int] = None) -> torch.Tensor:
        """Final hiddens (B, S, d)."""
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        tokens = batch["tokens"].to(torch.int64)
        x = F.embedding(tokens, params["embed"])
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        if cfg.family == "dense":
            x = self._dense_stack(params["blocks"], x, positions, window)
        else:
            x = self._hybrid_stack(params, x, positions, window)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def _attention(self, p, x, positions, window):
        return attn.attention_forward(p, x, positions=positions, rope_theta=self.cfg.rope_theta,
                                      window=window, backend=self.attn_backend)

    def _dense_stack(self, blocks, x, positions, window):
        eps = self.cfg.norm_eps
        for blk in _unbind(blocks, self.cfg.n_layers):
            x = x + self._attention(blk["attn"], rms_norm(x, blk["ln1"], eps), positions, window)
            x = x + mlp_mod.mlp_forward(blk["ffn"], rms_norm(x, blk["ln2"], eps))
        return x

    def _hybrid_stack(self, params, x, positions, window):
        """Zamba2: the Mamba2 layers in order; the SHARED attention block
        (one set of weights) follows every `attn_every` of them."""
        cfg = self.cfg
        eps = cfg.norm_eps
        for i, blk in enumerate(_unbind(params["blocks"], cfg.n_layers)):
            x = x + ssm_mod.mamba2_forward(blk["mamba"], rms_norm(x, blk["ln"], eps), cfg.ssm)
            if (i + 1) % cfg.attn_every == 0:
                x = x + self._attention(params["shared_attn"],
                                        rms_norm(x, params["shared_ln"], eps), positions,
                                        window)
        return x

    # ---------------- loss -------------------------------------------
    def loss(self, params: Params, batch: Batch, *,
             window: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        ce = chunked_lm_loss(self.forward(params, batch, window=window), self._unembed(params),
                             batch["labels"])
        return ce, {"ce": ce}

    # ---------------- decode -----------------------------------------
    def init_cache(self, batch: int, max_seq: int, *, window: Optional[int] = None,
                   dtype=torch.bfloat16, device=None) -> Any:
        """Zeroed caches on `device` (CUDA when None): the dense family's
        {"kv": KVCache of (L, B, C, Kv, hd)}, the hybrid's {"mamba": L
        Mamba2States, "shared": one KVCache (B, C, Kv, hd) per application
        of the shared block}; C = min(max_seq, window) under a window."""
        cfg = self.cfg
        dev = resolve_device(device)
        window = window if window is not None else cfg.sliding_window
        cap = min(max_seq, window) if window else max_seq
        if cfg.family == "dense":
            shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
            return {"kv": attn.KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                                       torch.zeros(shape, dtype=dtype, device=dev))}
        return {
            "mamba": [ssm_mod.init_mamba2_state(batch, cfg.d_model, cfg.ssm, dtype, dev)
                      for _ in range(cfg.n_layers)],
            "shared": [attn.init_kv_cache(batch, cap, cfg.n_kv_heads, cfg.head_dim, dtype, dev)
                       for _ in range(cfg.n_layers // cfg.attn_every)],
        }

    def decode_step(self, params: Params, cache: Any, tokens: torch.Tensor, pos: int, *,
                    window: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """tokens: (B, 1) int; pos: the position (an int). Returns (logits
        (B, 1, V), cache). KV caches are written in place; the Mamba2
        states of the returned cache are new tensors."""
        cfg = self.cfg
        eps = cfg.norm_eps
        window = window if window is not None else cfg.sliding_window
        ring = window is not None
        x = F.embedding(tokens.to(torch.int64), params["embed"])

        def attend(p, h, kv):
            return attn.attention_decode(p, h, kv, pos, rope_theta=cfg.rope_theta, ring=ring,
                                         window=window)

        if cfg.family == "dense":
            kv = cache["kv"]
            for i, blk in enumerate(_unbind(params["blocks"], cfg.n_layers)):
                a, _ = attend(blk["attn"], rms_norm(x, blk["ln1"], eps),
                              attn.KVCache(kv.k[i], kv.v[i]))
                x = x + a
                x = x + mlp_mod.mlp_forward(blk["ffn"], rms_norm(x, blk["ln2"], eps))
            new_cache = {"kv": kv}
        else:
            new_m, shared = [], cache["shared"]
            for i, blk in enumerate(_unbind(params["blocks"], cfg.n_layers)):
                o, st = ssm_mod.mamba2_decode(blk["mamba"], rms_norm(x, blk["ln"], eps),
                                              cache["mamba"][i], cfg.ssm)
                x = x + o
                new_m.append(st)
                if (i + 1) % cfg.attn_every == 0:
                    j = (i + 1) // cfg.attn_every - 1
                    a, _ = attend(params["shared_attn"], rms_norm(x, params["shared_ln"], eps),
                                  shared[j])
                    x = x + a
            new_cache = {"mamba": new_m, "shared": shared}
        x = rms_norm(x, params["ln_f"], eps)
        return torch.einsum("bsd,dv->bsv", x, self._unembed(params)), new_cache


def build_model(cfg: ModelConfig, **kw) -> LM:
    return LM(cfg, **kw)
