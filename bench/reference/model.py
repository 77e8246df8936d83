"""Plain PyTorch language models of the benchmark's two families, and the
weights the benchmark draws for both sides.

Written from the architecture as the program runs it, in float32 with
plain torch ops only (no kernel, no cache, no batching tricks):

  dense  -- pre-norm GQA attention (RoPE on the two halves of each head,
            optional q/k/v bias, causal softmax) and a SwiGLU MLP per
            layer, RMSNorm, tied or separate LM head (Qwen1.5).
  hybrid -- Mamba2 layers (in-projections of z, x, B, C and dt, a causal
            depthwise conv over x|B|C, softplus dt, the SSD recurrence
            S_t = exp(dt A) S_{t-1} + B_t (dt v_t)^T, y_t = C_t^T S_t + D v_t,
            a gated RMSNorm and the out-projection), with ONE shared
            attention block after every `attn_every` layers (Zamba2 as the
            program builds it: no shared MLP, no LoRA adapters, no
            concatenated embedding).

Parameters are a flat dict of named tensors, per-layer leaves stacked on a
leading layer axis, in `layout(cfg)`'s order: dict keys sorted, each
block's fields in their declared order. `make_params` draws them from a
seed on the given device in one normal draw; `loss` is the mean
next-token cross-entropy. The gradient is autograd's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ModelSpec:
    family: str                  # "dense" or "hybrid"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    attn_every: int = 0
    d_state: int = 0
    d_conv: int = 0
    expand: int = 0
    ssm_head_dim: int = 0
    chunk: int = 0

    @classmethod
    def from_config(cls, c: dict) -> "ModelSpec":
        """From a benchmark configuration file's dict."""
        s = c.get("ssm") or {}
        return cls(family=c["family"], n_layers=c["n_layers"], d_model=c["d_model"],
                   n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
                   head_dim=c.get("head_dim") or c["d_model"] // c["n_heads"],
                   d_ff=c["d_ff"], vocab=c["vocab"], qkv_bias=c.get("qkv_bias", False),
                   tie_embeddings=c.get("tie_embeddings", False),
                   rope_theta=c.get("rope_theta", 10000.0), norm_eps=c.get("norm_eps", 1e-5),
                   attn_every=c.get("attn_every") or 0, d_state=s.get("d_state", 0),
                   d_conv=s.get("d_conv", 0), expand=s.get("expand", 0),
                   ssm_head_dim=s.get("head_dim", 0), chunk=s.get("chunk", 0))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


# init kinds: ("normal", std) | ("ones",) | ("zeros",) | ("A_log",) | ("dt_bias",)
def _fan_in(shape) -> tuple:
    return ("normal", 1.0 / math.sqrt(max(math.prod(shape[:-1]) if len(shape) > 1 else shape[0],
                                          1)))


def layout(cfg: ModelSpec) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    """[(name, shape, init kind)] of every leaf, in the packing order."""
    L, d, H, Kv, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def attn(prefix, lead=()):
        out = []
        for name, shape in (("wq", (d, H, hd)), ("wk", (d, Kv, hd)), ("wv", (d, Kv, hd)),
                            ("wo", (H, hd, d))):
            out.append((f"{prefix}.{name}", lead + shape, _fan_in(shape)))
        if cfg.qkv_bias:
            for name, shape in (("bq", (H, hd)), ("bk", (Kv, hd)), ("bv", (Kv, hd))):
                out.append((f"{prefix}.{name}", lead + shape, ("zeros",)))
        return out

    head = [] if cfg.tie_embeddings else [("unembed", (d, cfg.vocab), ("normal", 0.02))]
    if cfg.family == "dense":
        f = cfg.d_ff
        blocks = attn("blocks.attn", (L,)) + [
            ("blocks.ffn.w_gate", (L, d, f), _fan_in((d, f))),
            ("blocks.ffn.w_up", (L, d, f), _fan_in((d, f))),
            ("blocks.ffn.w_down", (L, f, d), _fan_in((f, d))),
            ("blocks.ln1", (L, d), ("ones",)), ("blocks.ln2", (L, d), ("ones",))]
        return blocks + [("embed", (cfg.vocab, d), ("normal", 0.02)),
                         ("ln_f", (d,), ("ones",))] + head
    if cfg.family != "hybrid":
        raise ValueError(f"the reference runs the dense and hybrid families, not {cfg.family}")
    di, N, Hs = cfg.d_inner, cfg.d_state, cfg.ssm_heads
    m = "blocks.mamba"
    blocks = [("blocks.ln", (L, d), ("ones",)),
              (f"{m}.w_z", (L, d, di), _fan_in((d, di))),
              (f"{m}.w_x", (L, d, di), _fan_in((d, di))),
              (f"{m}.w_B", (L, d, N), _fan_in((d, N))),
              (f"{m}.w_C", (L, d, N), _fan_in((d, N))),
              (f"{m}.w_dt", (L, d, Hs), _fan_in((d, Hs))),
              (f"{m}.conv", (L, cfg.d_conv, di + 2 * N), ("normal", 0.5)),
              (f"{m}.A_log", (L, Hs), ("A_log",)),
              (f"{m}.D", (L, Hs), ("ones",)),
              (f"{m}.dt_bias", (L, Hs), ("dt_bias",)),
              (f"{m}.norm", (L, di), ("ones",)),
              (f"{m}.w_out", (L, di, d), _fan_in((di, d)))]
    return (blocks + [("embed", (cfg.vocab, d), ("normal", 0.02)), ("ln_f", (d,), ("ones",))]
            + attn("shared_attn") + [("shared_ln", (d,), ("ones",))] + head)


def n_params(cfg: ModelSpec) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


def make_params(cfg: ModelSpec, seed: int, device) -> Params:
    """The initial weights from `seed` on `device`: every normal leaf from
    ONE standard-normal draw (clipped to +-2, scaled per leaf) of a torch
    generator on that device, the rest constants (ones, zeros, A =
    -linspace(1, 16), dt_bias = softplus^-1(linspace(1e-3, 0.1))). All
    leaves are views of one (P,) f32 buffer, `flat(params)`."""
    lay = layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(2 * int(seed))
    buf = torch.randn(sum(math.prod(s) for _, s, _ in lay), generator=gen, device=device,
                      dtype=torch.float32)
    buf.clamp_(-2.0, 2.0)
    out: Params = {}
    off = 0
    for name, shape, kind in lay:
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape)
        off += n
        if kind[0] == "normal":
            leaf.mul_(kind[1])
        elif kind[0] == "ones":
            leaf.fill_(1.0)
        elif kind[0] == "zeros":
            leaf.zero_()
        else:
            H = shape[-1]
            if kind[0] == "A_log":
                row = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
            else:
                lin = torch.linspace(1e-3, 1e-1, H, dtype=torch.float64)
                row = torch.log(torch.expm1(lin)).to(torch.float32)
            leaf.copy_(row.to(device).expand(shape))
        out[name] = leaf
    return out


def flat(params: Params) -> torch.Tensor:
    """The (P,) buffer whose views `make_params` returned: every leaf in
    the packing order."""
    buf = next(iter(params.values()))._base
    assert buf is not None and buf.numel() == sum(p.numel() for p in params.values())
    return buf


# ----------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): rotate the two halves of each head by position."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / (float(theta) ** (torch.arange(half, dtype=torch.float32, device=x.device)
                                  / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(w: Params, x: torch.Tensor, cfg: ModelSpec) -> torch.Tensor:
    """Causal GQA attention with RoPE; `w` holds wq, wk, wv, wo (and bq, bk,
    bv) of one block."""
    S = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, w["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, w["wv"])
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k = _rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta)
    rep = cfg.n_heads // cfg.n_kv_heads
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhk,bchk->bhqc", q, k) / math.sqrt(cfg.head_dim)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqc,bchk->bqhk", torch.softmax(s, dim=-1), v)
    return torch.einsum("bshk,hkd->bsd", o, w["wo"])


def _block_attention(p: Params, prefix: str, i: Optional[int]) -> Params:
    """The attention weights under `prefix` (layer i of stacked ones)."""
    return {k[len(prefix) + 1:]: (v if i is None else v[i])
            for k, v in p.items() if k.startswith(prefix + ".")}


def swiglu(p: Params, i: int, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["blocks.ffn.w_gate"][i]
    u = x @ p["blocks.ffn.w_up"][i]
    return (F.silu(g) * u) @ p["blocks.ffn.w_down"][i]


def ssd_scan(v, a, Bm, Cm, dt, chunk: int) -> torch.Tensor:
    """y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} a_r) dt_s v_s.

    v (B, S, H, P); a = dt * A and dt (B, S, H); Bm, Cm (B, S, N) shared by
    the heads. Chunk by chunk: the masked quadratic form inside the chunk,
    and the (B, H, N, P) state carried across chunks."""
    Bsz, S, H, P = v.shape
    N = Bm.shape[-1]
    x = v * dt[..., None]
    state = v.new_zeros(Bsz, H, N, P)
    ys = []
    for c0 in range(0, S, chunk):
        xc, ac = x[:, c0:c0 + chunk], a[:, c0:c0 + chunk]
        bc, cc = Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk]
        Q = xc.shape[1]
        cum = torch.cumsum(ac, dim=1)                                    # (B, Q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]                    # (B, t, s, H)
        keep = torch.ones(Q, Q, dtype=torch.bool, device=v.device).tril()
        decay = torch.exp(seg.masked_fill(~keep[None, :, :, None], float("-inf")))
        scores = torch.einsum("btn,bsn->bts", cc, bc)[..., None] * decay
        y = torch.einsum("btsh,bshp->bthp", scores, xc)
        y = y + torch.einsum("bthn,bhnp->bthp", cc[:, :, None, :] * torch.exp(cum)[..., None],
                             state)
        last = cum[:, -1:, :]                                            # (B, 1, H)
        state = (torch.exp(last[:, 0])[:, :, None, None] * state
                 + torch.einsum("bshn,bshp->bhnp",
                                bc[:, :, None, :] * torch.exp(last - cum)[..., None], xc))
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba2(p: Params, i: int, x: torch.Tensor, cfg: ModelSpec) -> torch.Tensor:
    Bsz, S, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.ssm_heads, cfg.ssm_head_dim
    m = "blocks.mamba"
    z = x @ p[f"{m}.w_z"][i]
    xbc = torch.cat([x @ p[f"{m}.w_x"][i], x @ p[f"{m}.w_B"][i], x @ p[f"{m}.w_C"][i]], dim=-1)
    dt_raw = x @ p[f"{m}.w_dt"][i]
    w = p[f"{m}.conv"][i]                                                # (K, C)
    K = w.shape[0]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, j:j + S] * w[j] for j in range(K))
    xbc = F.silu(conv)
    xc, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    dt = F.softplus(dt_raw + p[f"{m}.dt_bias"][i])
    a = dt * -torch.exp(p[f"{m}.A_log"][i])
    v = xc.reshape(Bsz, S, H, P)
    y = ssd_scan(v, a, Bm, Cm, dt, cfg.chunk) + p[f"{m}.D"][i][None, None, :, None] * v
    y = rms_norm(y.reshape(Bsz, S, di) * F.silu(z), p[f"{m}.norm"][i], 1e-5)
    return y @ p[f"{m}.w_out"][i]


def hiddens(p: Params, tokens: torch.Tensor, cfg: ModelSpec) -> torch.Tensor:
    x = p["embed"][tokens.long()]
    eps = cfg.norm_eps
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            x = x + attention(_block_attention(p, "blocks.attn", i),
                              rms_norm(x, p["blocks.ln1"][i], eps), cfg)
            x = x + swiglu(p, i, rms_norm(x, p["blocks.ln2"][i], eps))
    else:
        shared = _block_attention(p, "shared_attn", None)
        for i in range(cfg.n_layers):
            x = x + mamba2(p, i, rms_norm(x, p["blocks.ln"][i], eps), cfg)
            if (i + 1) % cfg.attn_every == 0:
                x = x + attention(shared, rms_norm(x, p["shared_ln"], eps), cfg)
    return rms_norm(x, p["ln_f"], eps)


def loss(p: Params, tokens: torch.Tensor, labels: torch.Tensor, cfg: ModelSpec,
         chunk: Optional[int] = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over the positions with a label >= 0,
    the logits f32 and `chunk` positions at a time."""
    x = hiddens(p, tokens, cfg)
    head = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    labels = labels.long()
    tot = x.new_zeros(())
    cnt = x.new_zeros(())
    S = x.shape[1]
    step = S if chunk is None else min(chunk, S)
    for s0 in range(0, S, step):
        logits = x[:, s0:s0 + step] @ head
        lab = labels[:, s0:s0 + step]
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        mask = (lab >= 0).to(torch.float32)
        tot = tot + torch.sum(nll * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0)
