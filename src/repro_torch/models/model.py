"""Every LM family of the reference: dense, moe, hybrid, ssm (xLSTM), vlm
and audio. Counterpart of ``repro/models/model.py``.

    lm = build_model(cfg)
    params = lm.init(seed=0)                        # on CUDA; device="cpu" for the CPU
    loss, metrics = lm.loss(params, batch)          # train / prefill
    x = lm.forward(params, batch)                   # final hiddens
    x, aux = lm.forward_aux(params, batch)          # and the MoE load-balance loss
    cache = lm.init_cache(batch_size, max_seq, window=...)
    cache = lm.prime_cross_cache(params, cache, frames)   # audio: the encoder, once
    logits, cache = lm.decode_step(params, cache, tokens, pos, window=...)

Batch dict: tokens (B, S) int, labels (B, S) int, + patches (B, n_patches,
d) for the vlm, + frames (B, enc_seq, d) for audio (the stubbed frontends'
outputs).

Params are a plain nested dict with the reference's structure and names:
the dense, moe and vlm families' block params, the audio's decoder and
encoder blocks and the hybrid's Mamba2 blocks stay stacked with a leading
layer axis, as the reference's `lax.scan` layout has them; the xLSTM's
blocks are a list of per-layer dicts
({"mlstm": MLSTMParams} or {"slstm": SLSTMParams}), as the reference's.
So the flat buffer of one package is the flat buffer of the other (see
`repro_torch.convert`). The forward walks the layers on per-layer views.
`init` draws from its own torch generator, not from jax's key stream;
`init(device="meta")` draws and allocates nothing.

The reference's `forward` returns (hiddens, aux); here `forward` returns
the hiddens (what `prefill_logits` and decode checks read) and
`forward_aux` the pair, which `loss` takes to add `load_balance_coef *
aux` for the moe family (aux is 0 for the others).

`remat` and `remat_groups` are the reference's activation checkpointing
(on by default, as there): each layer of the dense, moe and vlm stacks,
of the audio encoder and decoder, and each group of `attn_every` Mamba2
layers with the shared attention that closes it runs under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
one unit at a time from its input instead of holding every layer's
activations. With `remat_groups` G (G divides n_layers, G < n_layers) the
dense stack checkpoints both levels as the reference does: each group of
n_layers / G layers from its input, and inside the recompute each layer
again (a plain inner loop would hold the whole group's internals during
the recompute). The xLSTM has none, as in the reference. The recompute
runs the same ops on the same inputs, so remat changes no value: the
gradients equal those without it bit for bit. It applies only where
autograd records: under ``torch.no_grad`` (prefill, decode) and inside
``torch.func`` transforms (per-example clipping, which refuse the
saved-tensor hooks checkpointing uses) the units run as they stand.

`attn_backend` is the reference's: "jnp" runs the blockwise attention of
plain torch ops (over kv chunks of `kv_chunk` positions), "pallas" the
flash kernel's entry point; every Mamba2 and mLSTM layer's SSD scan goes
through the ssm_scan kernel's entry point.
Both entry points run their plain versions on CPU tensors and the Hopper
kernels on CUDA tensors. `moe_mode` and `moe_group_tokens` are the
reference's ("onehot" capacity dispatch or the "ragged" sort). The vlm
prepends its projected patches to the text and strips them before the LM
head; its decode, as the reference's, sees no patches. The audio
(whisper) family runs the encoder (bidirectional `encoder_attention`,
learned positions) and a decoder of self-attention (RoPE, causal: flash
under "pallas"), cross-attention and a GELU MLP; the encoder and
cross-attention reach no kernel, as in the reference.

Every entry point also runs with its parameters, cache and inputs as
DTensors on a device mesh (placed by `sharding.rules`; `launch.steps`
builds such steps): the products shard by their letters, the kernels and
loops run on each rank's pieces (`sharding.spmd`), and a tensor the step
makes itself (positions, masks, zero states) stands for the same values on
every rank, as a replicated DTensor (`spmd.replicating`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import PORTED_FAMILIES, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import MetaGenerator, embed_init, rms_norm
from repro_torch.sharding import spmd
from repro_torch.sharding.spmd import einsum

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def chunked_lm_loss(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over positions with label >= 0, without holding
    (B, S, V) logits for more than `chunk` positions at a time.

    x: (B, S, d) final hiddens; unembed: (d, V); labels: (B, S) int. On
    a mesh the logits stay sharded over the vocabulary: the logsumexp and
    the gold logit are reduced over its group (`spmd.cross_entropy`)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for start in range(0, S, chunk):
        xi = x[:, start:start + chunk]
        li = labels[:, start:start + chunk].to(torch.int64)
        logits = einsum("bsd,dv->bsv", xi, unembed).to(torch.float32)
        logz, gold = spmd.cross_entropy(logits, li)
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


def _to(tree: Any, dev: torch.device) -> Any:
    """A tree of dicts and NamedTuples of tensors, moved to `dev`."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(None if t is None else t.to(dev) for t in tree))
    return tree.to(dev)


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


def _checkpointing() -> bool:
    """Whether a checkpointed unit would save anything for a backward:
    autograd records, and no torch.func transform is active."""
    return torch.is_grad_enabled() and not torch._C._are_functorch_transforms_active()


class LM:
    def __init__(self, cfg: ModelConfig, *, remat: bool = True, attn_backend: str = "jnp",
                 moe_mode: str = "onehot", moe_group_tokens: int = 512, kv_chunk: int = 1024,
                 remat_groups: int = 0):
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} (expected one of "
                             f"{', '.join(PORTED_FAMILIES)})")
        if attn_backend not in ("jnp", "pallas"):
            raise ValueError(f"unknown attention backend {attn_backend!r}")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                             f"attn_every {cfg.attn_every}")
        if moe_mode not in ("onehot", "ragged"):
            raise ValueError(f"unknown MoE mode {moe_mode!r}")
        self.cfg = cfg
        self.remat = remat
        self.remat_groups = remat_groups
        self.attn_backend = attn_backend
        self.moe_mode = moe_mode
        self.moe_group_tokens = moe_group_tokens
        self.kv_chunk = kv_chunk

    # ---------------- init -------------------------------------------
    def init(self, seed: int = 0, device=None, dtype=torch.float32,
             generator_device=None) -> Params:
        """Random weights from `seed` on `device` (CUDA when None). They are
        drawn from a CPU generator and then moved, so a seed gives the same
        weights on every device; `generator_device` (a CUDA device) draws
        them on the card instead, in a fraction of the time at full width,
        with other values. On the meta device nothing is drawn or allocated:
        every leaf has its shape and dtype, no storage."""
        cfg = self.cfg
        dev = resolve_device(device)
        if dev.type == "meta":
            gen = MetaGenerator()
        else:
            gen = torch.Generator(device=resolve_device(generator_device or "cpu"))
            gen.manual_seed(int(seed))
        L, d = cfg.n_layers, cfg.d_model

        def ones(n):
            return torch.ones(n, dtype=dtype, device=gen.device)

        def attention(bias=cfg.qkv_bias):
            return attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                       bias, dtype)

        def gelu():
            return mlp_mod.init_gelu(gen, d, cfg.d_ff, dtype)

        def ffn():
            if cfg.moe is not None:
                return moe_mod.init_moe(gen, d, cfg.moe, dtype)
            return mlp_mod.init_swiglu(gen, d, cfg.d_ff, dtype)

        extra: Params = {}
        if cfg.family in ("dense", "moe", "vlm"):
            blocks = _stack([{"ln1": ones(d), "ln2": ones(d), "attn": attention(), "ffn": ffn()}
                             for _ in range(L)], dev)
        elif cfg.family == "audio":             # whisper's attention has no bias
            blocks = _stack([{"ln1": ones(d), "ln2": ones(d), "ln3": ones(d),
                              "self": attention(False), "cross": attention(False),
                              "mlp": gelu()} for _ in range(L)], dev)
            extra["enc_blocks"] = _stack([{"ln1": ones(d), "ln2": ones(d),
                                           "attn": attention(False), "mlp": gelu()}
                                          for _ in range(cfg.enc_layers)], dev)
            extra["enc_pos"] = embed_init((cfg.enc_seq, d), gen, dtype).to(dev)
            extra["enc_ln_f"] = torch.ones(d, dtype=dtype, device=dev)
        elif cfg.family == "hybrid":
            blocks = _stack([{"ln": ones(d), "mamba": ssm_mod.init_mamba2(gen, d, cfg.ssm, dtype)}
                             for _ in range(L)], dev)
        else:                                       # ssm: the xLSTM's per-layer list
            blocks = [_to({"slstm": xlstm_mod.init_slstm(gen, cfg, dtype)}
                          if i in cfg.xlstm.slstm_indices
                          else {"mlstm": xlstm_mod.init_mlstm(gen, cfg, dtype)}, dev)
                      for i in range(L)]
        p: Params = {
            "embed": embed_init((cfg.vocab, d), gen, dtype).to(dev),
            "ln_f": torch.ones(d, dtype=dtype, device=dev),
            "blocks": blocks,
            **extra,
        }
        del blocks, extra
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init((d, cfg.vocab), gen, dtype).to(dev)
        if cfg.family == "vlm":
            p["patch_proj"] = embed_init((d, d), gen, dtype).to(dev)
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
        """Final hiddens (B, S, d) of the text positions."""
        return self.forward_aux(params, batch, window=window)[0]

    def forward_aux(self, params: Params, batch: Batch, *,
                    window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(final hiddens (B, S, d), the MoE load-balance loss: the mean over
        the layers of each router's aux, a 0-d f32 tensor; 0 outside the
        moe family), the reference's `forward`."""
        with spmd.replicating(params["embed"]):
            return self._forward_aux(params, batch, window)

    def _forward_aux(self, params, batch, window):
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        tokens = batch["tokens"].to(torch.int64)
        x = spmd.embedding(tokens, params["embed"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "vlm":
            patches = einsum("bpd,de->bpe", batch["patches"].to(x.dtype),
                                   params["patch_proj"])
            x = torch.cat([patches, x], dim=1)
        positions = torch.arange(x.shape[1], device=tokens.device)
        if cfg.family in ("dense", "moe", "vlm"):
            x, aux = self._dense_stack(params["blocks"], x, positions, window)
        elif cfg.family == "audio":
            x = self._audio_dec_stack(params["blocks"], x, self._encode(params, batch["frames"]),
                                      positions, window)
        elif cfg.family == "hybrid":
            x = self._hybrid_stack(params, x, positions, window)
        else:
            x = self._xlstm_stack(params["blocks"], x)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if cfg.family == "vlm":                     # strip the patch positions for the LM head
            x = x[:, batch["patches"].shape[1]:]
        return x, aux

    def _attention(self, p, x, positions, window):
        return attn.attention_forward(p, x, positions=positions, rope_theta=self.cfg.rope_theta,
                                      window=window, backend=self.attn_backend,
                                      kv_chunk=self.kv_chunk)

    def _ffn(self, p, x, group_tokens):
        """The block's feed-forward: (out, the router's aux or None)."""
        m = self.cfg.moe
        if m is None:
            return mlp_mod.mlp_forward(p, x), None
        return moe_mod.moe_forward(p, x, m, mode=self.moe_mode, group_tokens=group_tokens)

    def _maybe_remat(self, fn, *args):
        """fn(*args), under activation checkpointing when remat is on and
        autograd records (the module docstring)."""
        if not (self.remat and _checkpointing()):
            return fn(*args)
        from torch.utils.checkpoint import checkpoint

        def run(*a):
            # the recompute runs inside the backward, outside forward_aux's
            # context: the model's own constants meet DTensors there too
            with spmd.replicating(*(t for t in a if isinstance(t, torch.Tensor))):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)

    def _dense_layer(self, blk, x, positions, window):
        """One dense/moe/vlm block -> (x, the router's aux or None)."""
        eps = self.cfg.norm_eps
        x = x + self._attention(blk["attn"], rms_norm(x, blk["ln1"], eps), positions, window)
        f, a = self._ffn(blk["ffn"], rms_norm(x, blk["ln2"], eps), self.moe_group_tokens)
        return x + f, a

    def _dense_layers(self, blks, x, aux, positions, window):
        """The blocks `blks` in order, each checkpointed -> (x, aux)."""
        for blk in blks:
            x, a = self._maybe_remat(self._dense_layer, blk, x, positions, window)
            if a is not None:
                aux = aux + a
        return x, aux

    def _dense_stack(self, blocks, x, positions, window):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = _unbind(blocks, cfg.n_layers)
        G = self.remat_groups
        if self.remat and G and cfg.n_layers % G == 0 and G < cfg.n_layers:
            # nested remat: the group's input outside, each layer inside
            n = cfg.n_layers // G
            for g in range(G):
                x, aux = self._maybe_remat(self._dense_layers, layers[g * n:(g + 1) * n], x,
                                           aux, positions, window)
        else:
            x, aux = self._dense_layers(layers, x, aux, positions, window)
        return x, aux / cfg.n_layers

    def _encode(self, params, frames):
        """Whisper's encoder over the stub frontend's frames (B, enc_seq, d):
        learned positions, then pre-norm bidirectional attention and a GELU
        MLP per layer, then its final norm."""
        cfg = self.cfg
        eps = cfg.norm_eps
        x = frames.to(params["enc_pos"].dtype) + params["enc_pos"][None]
        for blk in _unbind(params["enc_blocks"], cfg.enc_layers):
            x = self._maybe_remat(self._enc_layer, blk, x)
        return rms_norm(x, params["enc_ln_f"], eps)

    def _enc_layer(self, blk, x):
        eps = self.cfg.norm_eps
        x = x + attn.encoder_attention(blk["attn"], rms_norm(x, blk["ln1"], eps))
        return x + mlp_mod.mlp_forward(blk["mlp"], rms_norm(x, blk["ln2"], eps))

    def _audio_dec_stack(self, blocks, x, enc, positions, window):
        """Whisper's decoder: causal self-attention, cross-attention against
        the encoder's output `enc`, a GELU MLP, each pre-norm."""
        for blk in _unbind(blocks, self.cfg.n_layers):
            x = self._maybe_remat(self._audio_dec_layer, blk, x, enc, positions, window)
        return x

    def _audio_dec_layer(self, blk, x, enc, positions, window):
        eps = self.cfg.norm_eps
        x = x + self._attention(blk["self"], rms_norm(x, blk["ln1"], eps), positions, window)
        x = x + attn.cross_attention(blk["cross"], rms_norm(x, blk["ln2"], eps),
                                     *attn.cross_kv(blk["cross"], enc))
        return x + mlp_mod.mlp_forward(blk["mlp"], rms_norm(x, blk["ln3"], eps))

    def _hybrid_stack(self, params, x, positions, window):
        """Zamba2: the Mamba2 layers in order; the SHARED attention block
        (one set of weights) follows every `attn_every` of them. Each group
        of `attn_every` layers and the shared block is one checkpointed
        unit, as the reference's scan over groups."""
        cfg = self.cfg
        layers = _unbind(params["blocks"], cfg.n_layers)
        ae = cfg.attn_every
        for g in range(cfg.n_layers // ae):
            x = self._maybe_remat(self._hybrid_group, layers[g * ae:(g + 1) * ae],
                                  params["shared_attn"], params["shared_ln"], x, positions,
                                  window)
        return x

    def _hybrid_group(self, blks, shared, shared_ln, x, positions, window):
        cfg = self.cfg
        eps = cfg.norm_eps
        for blk in blks:
            x = x + ssm_mod.mamba2_forward(blk["mamba"], rms_norm(x, blk["ln"], eps), cfg.ssm)
        return x + self._attention(shared, rms_norm(x, shared_ln, eps), positions, window)

    def _xlstm_stack(self, blocks, x):
        """The xLSTM: each block's residual in order (no pre-norm, as the
        reference's)."""
        cfg = self.cfg
        for blk in blocks:
            if "slstm" in blk:
                x = x + xlstm_mod.slstm_forward(blk["slstm"], x, cfg)
            else:
                x = x + xlstm_mod.mlstm_forward(blk["mlstm"], x, cfg)
        return x

    # ---------------- loss -------------------------------------------
    def loss(self, params: Params, batch: Batch, *,
             window: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        x, aux = self.forward_aux(params, batch, window=window)
        ce = chunked_lm_loss(x, self._unembed(params), batch["labels"])
        lb = self.cfg.moe.load_balance_coef if self.cfg.moe else 0.0
        return ce + lb * aux, {"ce": ce, "moe_aux": aux}

    # ---------------- decode -----------------------------------------
    def init_cache(self, batch: int, max_seq: int, *, window: Optional[int] = None,
                   dtype=torch.bfloat16, device=None) -> Any:
        """Zeroed caches on `device` (CUDA when None): the dense, moe and
        vlm families' {"kv": KVCache of (L, B, C, Kv, hd)}, the audio's
        also "cross": KVCache of (L, B, enc_seq, Kv, hd) (filled by
        `prime_cross_cache`), the hybrid's
        {"mamba": L Mamba2States, "shared": one KVCache (B, C, Kv, hd) per
        application of the shared block}, the xLSTM's {"states": one
        MLSTMState (conv in `dtype`) or SLSTMState (f32) per layer}; C =
        min(max_seq, window) under a window."""
        cfg = self.cfg
        dev = resolve_device(device)
        window = window if window is not None else cfg.sliding_window
        cap = min(max_seq, window) if window else max_seq

        def kv(n):
            shape = (cfg.n_layers, batch, n, cfg.n_kv_heads, cfg.head_dim)
            return attn.KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                                torch.zeros(shape, dtype=dtype, device=dev))

        if cfg.family in ("dense", "moe", "vlm"):
            return {"kv": kv(cap)}
        if cfg.family == "audio":
            return {"kv": kv(cap), "cross": kv(cfg.enc_seq)}
        if cfg.family == "ssm":
            return {"states": [xlstm_mod.init_slstm_state(batch, cfg, dev)
                               if i in cfg.xlstm.slstm_indices
                               else xlstm_mod.init_mlstm_state(batch, cfg, dtype, dev)
                               for i in range(cfg.n_layers)]}
        return {
            "mamba": [ssm_mod.init_mamba2_state(batch, cfg.d_model, cfg.ssm, dtype, dev)
                      for _ in range(cfg.n_layers)],
            "shared": [attn.init_kv_cache(batch, cap, cfg.n_kv_heads, cfg.head_dim, dtype, dev)
                       for _ in range(cfg.n_layers // cfg.attn_every)],
        }

    def prime_cross_cache(self, params: Params, cache: Any, frames: torch.Tensor) -> Any:
        """Whisper: run the encoder once over `frames` (B, enc_seq, d) and
        write every layer's cross-attention K/V, cast to the cache's dtype,
        into `cache["cross"]` IN PLACE (as decode writes its KV); returns
        the cache."""
        with spmd.replicating(params["embed"]):
            enc = self._encode(params, frames)
            cross = cache["cross"]
            for i, blk in enumerate(_unbind(params["blocks"], self.cfg.n_layers)):
                k, v = attn.cross_kv(blk["cross"], enc)
                spmd.write_slot(cross.k, 0, i, k.to(cross.k.dtype))
                spmd.write_slot(cross.v, 0, i, v.to(cross.v.dtype))
        return cache

    def decode_step(self, params: Params, cache: Any, tokens: torch.Tensor, pos: int, *,
                    window: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """tokens: (B, 1) int; pos: the position (an int). Returns (logits
        (B, 1, V), cache). KV caches are written in place; the Mamba2 and
        xLSTM states of the returned cache are new tensors."""
        with spmd.replicating(params["embed"]):
            return self._decode_step(params, cache, tokens, pos, window)

    def _decode_step(self, params, cache, tokens, pos, window):
        cfg = self.cfg
        eps = cfg.norm_eps
        window = window if window is not None else cfg.sliding_window
        ring = window is not None
        x = spmd.embedding(tokens.to(torch.int64), params["embed"])

        def attend(p, h, kv):
            return attn.attention_decode(p, h, kv, pos, rope_theta=cfg.rope_theta, ring=ring,
                                         window=window)

        if cfg.family in ("dense", "moe", "vlm"):
            kv = cache["kv"]
            for i, blk in enumerate(_unbind(params["blocks"], cfg.n_layers)):
                a, _ = attend(blk["attn"], rms_norm(x, blk["ln1"], eps),
                              attn.KVCache(kv.k[i], kv.v[i]))
                x = x + a
                # one token a row: the batch is one group, as the reference's
                x = x + self._ffn(blk["ffn"], rms_norm(x, blk["ln2"], eps), tokens.shape[0])[0]
            new_cache = {"kv": kv}
        elif cfg.family == "audio":
            kv, cross = cache["kv"], cache["cross"]
            for i, blk in enumerate(_unbind(params["blocks"], cfg.n_layers)):
                a, _ = attend(blk["self"], rms_norm(x, blk["ln1"], eps),
                              attn.KVCache(kv.k[i], kv.v[i]))
                x = x + a
                x = x + attn.cross_attention(blk["cross"], rms_norm(x, blk["ln2"], eps),
                                             cross.k[i], cross.v[i])
                x = x + mlp_mod.mlp_forward(blk["mlp"], rms_norm(x, blk["ln3"], eps))
            new_cache = {"kv": kv, "cross": cross}
        elif cfg.family == "ssm":
            states = []
            for blk, st in zip(params["blocks"], cache["states"]):
                if "slstm" in blk:
                    o, st = xlstm_mod.slstm_decode(blk["slstm"], x, st, cfg)
                else:
                    o, st = xlstm_mod.mlstm_decode(blk["mlstm"], x, st, cfg)
                x = x + o
                states.append(st)
            new_cache = {"states": states}
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
        return einsum("bsd,dv->bsv", x, self._unembed(params)), new_cache


def build_model(cfg: ModelConfig, **kw) -> LM:
    """LM(cfg, **kw): remat on unless kw says remat=False, as the
    reference's."""
    return LM(cfg, **kw)
