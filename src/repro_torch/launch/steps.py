"""Step builders: (arch x shape) -> a step function and stand-ins of its
arguments. Counterpart of ``repro/launch/steps.py``.

train   -> the paper's async-DP step (`federation.deep.make_train_step`,
           the owner bank in the state)
prefill -> full-sequence forward, last-position logits (`prefill_logits`)
decode  -> one-token serve step against the KV/SSM cache

A `StepBundle` carries the step and its arguments as meta-device tensors
(`launch.specs`). With `mesh=None` the step runs on one device and
`in_shardings` is None. With a DeviceMesh (`launch.mesh`), prefill and
decode follow the reference's `build_prefill_step` / `build_serve_step`:
the params, batch and cache are placed by `sharding.rules` (`param_specs`,
`batch_specs`, `cache_specs`; decode tokens over the data axes when the
batch divides them, else replicated), `in_shardings` is the port's
NamedSharding tree (`rules.named`), the stand-ins are meta DTensors (each
rank's meta shard), and the step places any plain tensor it is given
where its sharding says (`place`) and runs the model on DTensors. Train
follows the reference's `build_train_step`: theta_L by `param_specs`, the
owner bank by `param_specs(..., bank_axis=True)` (the owner axis
replicated), `step` and the ledger replicated, the batch by
`batch_specs(..., microbatches=)`, the owner index and the key
replicated; the round runs on the meshed pytree state
(`federation.deep`), drawing each leaf's noise block by block.

The decode stand-in's `pos` is a 0-d tensor, as the reference's; the step
takes the position as an int (``launch.dryrun`` passes the last one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.federation.deep import AsyncDPConfig, init_state, make_train_step
from repro_torch.federation.dp_sgd import PrivatizerConfig
from repro_torch.launch import specs as specs_mod
from repro_torch.models.model import LM, Batch, Params, build_model
from repro_torch.sharding import rules, spmd


@dataclasses.dataclass
class StepBundle:
    step: Callable                 # the step function
    args: Tuple[Any, ...]          # meta-device stand-ins of its arguments, in order
    in_shardings: Optional[Tuple[Any, ...]]   # NamedSharding trees; None off a mesh
    donate_argnums: Tuple[int, ...]
    kind: str


def default_async_cfg(n_owners: int = 4, horizon: int = 1000, n_microbatches: int = 8,
                      xi: float = 1.0, pre_grouped: bool = True) -> AsyncDPConfig:
    return AsyncDPConfig(
        n_owners=n_owners, horizon=horizon, rho=1.0, sigma=1e-4,
        epsilons=tuple([1.0] * n_owners),
        owner_sizes=tuple([1_000_000] * n_owners), xi=xi, theta_max=100.0,
        privatizer=PrivatizerConfig(xi=xi, granularity="microbatch",
                                    n_microbatches=n_microbatches,
                                    pre_grouped=pre_grouped))


def place(in_shardings, *args) -> Tuple[Any, ...]:
    """Each argument placed by its NamedSharding tree (`rules.distribute`;
    a DTensor or a non-tensor stays as it is)."""
    return tuple(rules.distribute(a, s) for a, s in zip(args, in_shardings))


def _meshed(fn: Callable, mesh, specs: Tuple[Any, ...], args: Tuple[Any, ...], kind: str,
            donate: Tuple[int, ...], n_placed: Optional[int] = None) -> StepBundle:
    """The bundle of `fn` on `mesh`: shardings from `specs`, the stand-ins
    `args` placed as meta DTensors, and a step that places the plain
    tensors among its first `n_placed` arguments (all when None); the
    others reach `fn` as they are."""
    shardings = tuple(rules.named(mesh, s) for s in specs)
    n = len(shardings) if n_placed is None else n_placed

    def step(*a):
        return fn(*place(shardings[:n], *a[:n]), *a[n:])
    return StepBundle(step, place(shardings, *args), shardings, donate, kind)


def prefill_logits(model: LM, params: Params, batch: Batch,
                   window: Optional[int] = None) -> torch.Tensor:
    """Logits (B, V) of the last position of `batch["tokens"]` (B, S)."""
    x = model.forward(params, batch, window=window)
    return spmd.einsum("bd,dv->bv", x[:, -1], model._unembed(params))


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                     model: Optional[LM] = None, async_cfg: Optional[AsyncDPConfig] = None,
                     dtype=torch.bfloat16, device=None) -> StepBundle:
    """step(state, batch, owner_idx, noise_key) -> (state, metrics): one
    host-authorized round of `make_train_step` on `device` (CUDA when
    None), the loss at the shape's effective window. `owner_idx` is a
    one-element int tensor and `noise_key` a (2,) uint32 key of
    ``repro_torch.random``; under a pre-grouped microbatch privatizer the
    batch is microbatch-major (G, B/G, S). On a mesh the state's theta_L
    and bank are DTensors (`deep.init_state(..., mesh=, specs=)` builds
    them; a plain state is placed, which builds the whole bank on every
    rank first), the owner index and the key plain or replicated, and
    `in_shardings` is the reference's: (state, batch, owner, key)."""
    model = model or build_model(cfg)
    acfg = async_cfg or default_async_cfg()
    w = specs_mod.effective_window(cfg, shape)

    def loss_fn(params, batch):
        return model.loss(params, batch, window=w)[0]

    step = make_train_step(loss_fn, acfg, device=device)
    pcfg = acfg.privatizer
    mb = pcfg.n_microbatches if pcfg.pre_grouped and pcfg.granularity == "microbatch" else 0
    p_sds = specs_mod.params_specs(model, dtype)
    state_sds = init_state(p_sds, acfg, device=specs_mod.META)
    batch_sds = specs_mod.train_batch_specs(cfg, shape, microbatches=mb)
    args = (state_sds, batch_sds, specs_mod.meta((1,), torch.int32),
            specs_mod.meta((2,), torch.uint32))
    if mesh is None:
        return StepBundle(step=step, args=args, in_shardings=None, donate_argnums=(0,),
                          kind="train")
    specs = (_train_state_specs(state_sds, cfg, mesh),
             rules.batch_specs(batch_sds, shape, mesh, microbatches=mb), rules.P(), rules.P())

    def meshed(state, batch, owner_idx, noise_key):
        # the owner and the key are the same on every rank: the round reads
        # them as plain tensors (a uint32 key cannot be broadcast)
        return step(state, batch, spmd.plain(owner_idx), spmd.plain(noise_key))
    return _meshed(meshed, mesh, specs, args, "train", (0,), n_placed=2)


def _train_state_specs(state, cfg: ModelConfig, mesh):
    """The PartitionSpec tree of a pytree AsyncDPState (the reference's
    `state_spec`): theta_L by `rules.param_specs`, the bank by
    `param_specs(..., bank_axis=True)`, `step` and the ledger P()."""
    return type(state)(theta_L=rules.param_specs(state.theta_L, cfg, mesh),
                       bank=rules.param_specs(state.bank, cfg, mesh, bank_axis=True),
                       step=rules.P(), ledger=None if state.ledger is None else rules.P())


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                       model: Optional[LM] = None, dtype=torch.bfloat16) -> StepBundle:
    """step(params, batch) -> the last position's logits (B, V); on a mesh a
    DTensor, its inputs placed as `in_shardings` says."""
    model = model or build_model(cfg)
    w = specs_mod.effective_window(cfg, shape)

    def step(params, batch):
        return prefill_logits(model, params, batch, window=w)

    args = (specs_mod.params_specs(model, dtype),
            specs_mod.train_batch_specs(cfg, shape, with_labels=False))
    if mesh is None:
        return StepBundle(step, args, None, (), "prefill")
    specs = (rules.param_specs(args[0], cfg, mesh), rules.batch_specs(args[1], shape, mesh))
    return _meshed(step, mesh, specs, args, "prefill", ())


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                     model: Optional[LM] = None, dtype=torch.bfloat16) -> StepBundle:
    """step(params, cache, tokens (B, 1), pos) -> (logits (B, 1, V), cache);
    on a mesh the logits and cache are DTensors, the cache written in
    place where it lies."""
    model = model or build_model(cfg)
    w = specs_mod.effective_window(cfg, shape)

    def step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, window=w)

    tok_sds, pos_sds = specs_mod.decode_input_specs(cfg, shape)
    args = (specs_mod.params_specs(model, dtype),
            specs_mod.cache_specs_struct(model, shape, dtype), tok_sds, pos_sds)
    if mesh is None:
        return StepBundle(step, args, None, (1,), "decode")
    B = shape.global_batch
    da = rules.data_axes(mesh)
    tok_spec = rules.P(da, None) if B % rules.axis_size(mesh, da) == 0 else rules.P(None, None)
    specs = (rules.param_specs(args[0], cfg, mesh),
             rules.cache_specs(args[1], cfg, mesh, B), tok_spec, rules.P())
    return _meshed(step, mesh, specs, args, "decode", (1,))


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *, n_microbatches: int = 8,
               model_kw: Optional[dict] = None, **kw) -> StepBundle:
    """model_kw: LM construction knobs (remat, remat_groups, attn_backend,
    moe_mode, moe_group_tokens, kv_chunk); remat is on unless it says
    otherwise, as in the reference."""
    model = build_model(cfg, **(model_kw or {}))
    if shape.kind == "train":
        return build_train_step(
            cfg, shape, mesh, model=model,
            async_cfg=kw.pop("async_cfg", None)
            or default_async_cfg(n_microbatches=n_microbatches), **kw)
    kw.pop("device", None)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, model=model, **kw)
    return build_serve_step(cfg, shape, mesh, model=model, **kw)
