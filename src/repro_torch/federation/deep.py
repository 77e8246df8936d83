"""Deep-model federation engine: Algorithm 1 as a training strategy.

Counterpart of ``repro/federation/deep.py``. The state is the central
model theta_L and an owner bank holding one copy of the model per owner,
in one of two representations, and both drivers serve both:

  pytree (`init_state`, the reference's default) -- theta_L is the model
      tree and every bank leaf gains a leading (N_owners,) axis. The round
      is `_round_math`: the privatizer `dp_sgd.private_grad` per leaf,
      then eqs. (5)-(7) and the theta_max projection per leaf. With
      `PrivatizerConfig(fused_kernel=True)` the clip norms run through the
      `sqnorm` kernel and the mean + Laplace add through one `scale_noise`
      pass per leaf; without it the noise is `random.laplace`, as the
      reference draws it.
  flat (`init_state_flat`) -- theta_L is a `ParamFlat`, one (P,) f32
      buffer, and the bank one (N_owners, P) matrix (or a quantized
      `QuantBank`). The round is `_round_math_flat`. Fused: the packed
      gradient per microbatch, clipped by the `sqnorm` kernel, then ONE
      `dp_round` pass for the group mean, Theorem-1 Laplace noise (eq. 4),
      eqs. (5)/(7) and the projection. Reference mode (fused_kernel=False):
      the row is gathered, theta_L and the row unpacked into views, and
      the SAME `_round_math.inner` as the pytree path runs on them; so
      `spec.pack` of the pytree path's result equals the flat reference
      mode bit for bit on f32 banks under the same keys.

One round: gather the owner's copy theta_i, form theta_bar = (theta_L +
theta_i) / 2 (eq. 6), take the privatized gradient at theta_bar, update
the owner copy (eq. 5) and the central model (eq. 7), write the copy back.

The flat bank's storage is chosen by `init_state_flat(..., bank_dtype=)`:
f32 rows; bf16 or f16 rows (upcast on gather, narrowed on write); or a
`QuantBank` of int8 / fp8 codes, whose row is decoded on gather (the
`decode` kernel) and, on a granted write, re-encoded with stochastic
rounding after the shared error-feedback residual is added (the `absmax`
and `encode` kernels). The rounding seed is the round key folded with the
codec's salt (`bank_codec.ref.CODEC_SALT`), so an int8 run draws the same
Laplace noise as an f32 run under the same keys. A refused round leaves
codes, scales and residual bit-exact. Pytree banks are dense only.

Three drivers share the round (`_round_compute`, which dispatches on the
state's representation):

  make_train_step   — one host-authorized round per call (the session's
                      mechanism has already decided refusal).
  make_fused_rounds — K rounds per call with authorization on the device:
                      round k is granted iff ledger.spent[i_k] < cap[i_k]
                      at that point, a refused round is masked with
                      torch.where into a bit-exact no-op, and nothing in
                      the K-round loop reads a value back to the host.
                      Equal bit for bit to the per-round loop under the
                      same per-round keys.
  make_group_rounds — owner-parallel: the K rounds split into groups of
                      consecutive rounds with DISTINCT owners
                      (`schedules.partition_conflict_free`), each group
                      computed from the group-entry state as one batch.
                      On the fused flat engine a group is one vmapped
                      gradient per microbatch, one batched `sqnorm` per
                      microbatch and one batched `dp_round` (or, under the
                      tree, one batched `tree_delta`); the other states
                      run the members one after another through the
                      round. The ledger spend is the sequential driver's
                      exactly; theta_L takes one inertia reduction per
                      group (see make_group_rounds).

The bank rows, the noise trees and the device ledger are updated IN PLACE
(the reference's jitted drivers donate the state for the same reason: the
bank is N copies of the model), so a state passed to a driver is consumed
by it. The bank is materialized: every owner's copy is its own memory.

The tree mechanism (`AsyncDPConfig.tree_depth` = d >= 1, DP-FTRL) gives
every owner a depth-d binary noise tree, `AsyncDPState.tree` (a
`TreeNoise`: the node values, (N, d, P) f32 on a flat state and a tree of
(N, d, *leaf.shape) f32 leaves on a pytree state, and the (N,) int32 leaf
counts). Each response adds the fresh draw minus the retired nodes. On the
fused flat path the `tree_delta` kernel advances the owner's node row in
place (masked by the grant) and the updates (5), (7) and the projection
follow as torch ops in the reference's op order; depth 0 keeps
`dp_round`, bit for bit the paper mechanism. In the reference mode (flat
or pytree) the privatizer returns its Laplace draw, which becomes the
fresh node; the fused pytree privatizer adds its noise in-kernel, so the
tree with fused_kernel needs the flat engine, as in the reference.

The fault layer (`AsyncDPConfig.fault_policy`, `federation.faults`) and
the asynchronous runtime (`AsyncDPConfig.staleness`,
`federation.staleness`) arm every driver on every state: the state gains
`faults` (per-owner row checksums, fault windows, quarantine flags) and
`stale` (the round clock, ages, backoff cooldowns, retry budgets), and
each driver takes per-round fault codes. A fault-armed round
(`_guarded_round`) runs the round's kernels whatever its outcome, then
applies it only if the owner answered (authorized, not quarantined, not in
backoff, not dropped), its resident row matches its checksum, the update
is finite, the answer is not a stale replay and came before the deadline;
otherwise it is a bit-exact no-op on theta_L, the bank and the noise tree,
and the ledger's fault columns say why. Under the staleness decay the
round runs against theta_L + decay**age * (theta_i - theta_L). On a tree
state the fused flat engine launches `tree_delta` twice: with grant 0 for
the round's delta, then with the round's `apply` to advance the node row,
which is known only after the guards have seen the result.

A paged owner bank (`flatten.PagedBank`, built by
`paging.init_paged_state`) keeps n_hot of the N rows on the device. Every
driver resolves owner -> hot slot on the device (`_bank_slot`, a
searchsorted over the sorted page table) and gathers and writes the row,
the codes and scales, and the tree's node row at the slot, while the
ledger, the leaf counts and the fault and runtime columns stay per owner.
A round whose owner is not resident is folded into the grant: a bit-exact
masked no-op that spends nothing and lands in `refused` (the host pager
makes every dispatched owner resident first, so this never happens in a
session driven through `Federation`). With n_hot >= N the paged engine
equals the flat one bit for bit on all three drivers.

A flat state on a device mesh (`init_state_flat(..., mesh=)`, the
`sharding.rules.flat_shardings` layout) holds only this rank's block of
theta_L, the bank, the residual and the tree nodes (`ParamFlat.layout`, a
`sharding.flat.FlatLayout`): owner rows over the data axes, P over
'model'. The drivers run it unchanged: the owner's row is gathered over
the row group, theta_bar over the column group for the loss, every rank
takes the whole gradient of the round's owner and keeps its own columns,
the kernels draw the bits of those columns (col0), and only the rank
holding a row writes it. The ledger, the leaf counts and the fault and
runtime columns are replicated, computed on every rank from replicated
inputs with no collective. A 1x1 mesh equals the unmeshed engine bit for
bit; a larger one equals it block for block.

A pytree state on a device mesh (`init_state(..., mesh=, specs=)`, or
params that are already DTensors; `launch.steps.build_train_step(mesh=)`)
holds theta_L as DTensors in the params' placements and every bank leaf
as a DTensor of (N, *leaf) laid out as `rules.param_specs(...,
bank_axis=True)` says: the owner axis replicated, the rest sharded like
the leaf. Each rank builds, reads and writes only its (N, *block) piece of
the bank, and under the tree its (N, d, *block) piece of the nodes
(`rules.param_specs(..., node_axes=True)`). `step`, the ledger, the leaf
counts and the fault and runtime columns are plain and the same on every
rank. All three drivers run it, under every mechanism and layer a pytree
state takes: the owner's row (and node row) is taken from each rank's own
piece (`spmd.take_row`), the privatizer runs on each rank's blocks
(`dp_sgd`: per example, B backward passes of a batch of one), the retired
nodes, the fresh draw (the privatizer's own block draw), the staleness
decay, eqs. (5)-(7) and the projection are elementwise on the blocks, and
the masked writes land in each rank's piece (`spmd.put_rows_`). The fault
layer's row checksums sum each rank's int64 partials exactly over the
mesh and its finite guard ands the ranks' flags (`federation.faults`).
The round's own plain tensors (grants, masks, scalars) meet the DTensors
as replicated ones (`spmd.replicating`). A 1x1 mesh equals the unmeshed
pytree state bit for bit but at example granularity, whose per-example
gradients are not vmap's bits; a larger one equals it block for block. A
pytree bank is dense by design (no codec, no pager), and `Federation`
keeps a mesh for the flat engine, as the reference's does.

`make_sync_dp_step` is the synchronous baseline: every owner answers
every round and the learner averages the privatized gradients.

The fused flat engine clips per microbatch group or per example
(`PrivatizerConfig.granularity`, as in the reference): per example, the B
gradients of a round (g*B under the grouped driver) come from one batched
backward and their norms from one `sqnorm` row-axis launch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import random
from repro_torch.device import resolve_device
from repro_torch.federation.config import paper_rates
from repro_torch.federation import faults as _faults
from repro_torch.federation.dp_sgd import PrivatizerConfig, _group_batch, private_grad
from repro_torch.federation.faults import FaultPolicy, FaultState, init_fault_state
from repro_torch.federation.flatten import (PagedBank, ParamFlat, QuantBank, flatten_spec,
                                            init_flat_bank, pack_params, sliced_scales)
from repro_torch.federation.privacy import (DeviceLedger, laplace_scale_theorem1,
                                            make_device_ledger)
from repro_torch.federation.staleness import (StalenessPolicy, StalenessState, deadline_guard,
                                              init_staleness_state, staleness_tick,
                                              staleness_weight)
from repro_torch.kernels.bank_codec.ops import decode_row, encode_row
from repro_torch.kernels.dp_clip_noise.ops import (dp_round_flat, dp_round_rows, fused_sqnorm,
                                                   fused_sqnorm_rows)
from repro_torch.kernels.tree_noise.ops import tree_delta_, tree_delta_rows_
from repro_torch.kernels.tree_noise.ref import tree_masks_ref
from repro_torch.sharding import spmd
from repro_torch.sharding.flat import FlatLayout, layout_for
from repro_torch.telemetry import span
from repro_torch.tree_util import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AsyncDPConfig:
    n_owners: int
    horizon: int                       # T
    rho: float = 1.0
    sigma: float = 1e-4                # strong-convexity of g = (sigma/2)||.||^2
    epsilons: Sequence[float] = ()     # per-owner budgets
    owner_sizes: Sequence[int] = ()    # n_i (records per owner)
    xi: float = 1.0                    # clip norm / Assumption-2 bound
    theta_max: float = 100.0           # Theta projection radius (l_inf)
    privatizer: PrivatizerConfig = PrivatizerConfig(xi=1.0)
    lr_scale: float = 1.0              # 1.0 == paper-faithful
    caps: Optional[Sequence[int]] = None  # per-owner response caps (None = T)
    # DP-FTRL tree noise: None = independent per-round noise; d >= 1 = a
    # depth-d noise tree per owner (AsyncDPState.tree), each response adds
    # the active-node-sum delta at per-node scale d * b(R), R = min(cap,
    # 2^d - 1); d = 0 is the degenerate tree, bit for bit the paper's.
    tree_depth: Optional[int] = None
    # the fault layer (federation.faults): None = off, and every driver
    # runs the fault-free round; a FaultPolicy arms the guards (payload
    # checksums, non-finite detection, stale rejection) and the quarantine
    # windows, and the state gains a FaultState (AsyncDPState.faults)
    fault_policy: Optional[FaultPolicy] = None
    # the asynchronous runtime (federation.staleness): None = off; a
    # StalenessPolicy adds the TIMEOUT outcome, per-owner retry backoff and
    # the decay**age weight, and the state gains a StalenessState
    # (AsyncDPState.stale). Needs fault_policy (TIMEOUT is a fault code).
    staleness: Optional[StalenessPolicy] = None

    @property
    def n_total(self) -> int:
        return sum(self.owner_sizes)

    @property
    def effective_caps(self) -> Tuple[int, ...]:
        if self.caps is None:
            return (self.horizon,) * self.n_owners
        return tuple(self.caps)


# a dense (N, P) matrix or a QuantBank (flat states); a model tree with
# (N, *leaf.shape) leaves (pytree states)
Bank = Union[torch.Tensor, QuantBank, Any]


class TreeNoise:
    """Every owner's DP-FTRL noise tree, on the device.

    `nodes` holds the live node values, always f32 whatever the bank
    stores: one (N_owners, depth, P) tensor beside a flat state, the model
    tree with (N_owners, depth, *leaf.shape) leaves beside a pytree state.
    `counts` (N_owners,) int32 counts the leaves released so far, the
    binary counter whose bits say which nodes retire at the next leaf. The
    drivers update both IN PLACE: a row of nodes is depth * P * 4 bytes
    per owner (2.44 GB at depth 4 and DENSE_124M)."""

    def __init__(self, nodes: torch.Tensor, counts: torch.Tensor, depth: int):
        self.nodes = nodes
        self.counts = counts
        self.depth = depth


class AsyncDPState(NamedTuple):
    theta_L: Any                       # central model: a ParamFlat, or the model tree
    bank: Bank                         # the owner copies (see Bank)
    step: torch.Tensor                 # () int32 granted rounds
    ledger: Optional[DeviceLedger] = None
    tree: Optional[TreeNoise] = None   # the noise trees when cfg.tree_depth is set
    faults: Optional[FaultState] = None        # when cfg.fault_policy is set
    stale: Optional[StalenessState] = None     # when cfg.staleness is set


def init_tree_noise(cfg: AsyncDPConfig, theta_L) -> Optional[TreeNoise]:
    """All-zero noise trees matching theta_L's representation (a ParamFlat
    or a model tree), on its device; None when cfg.tree_depth is None."""
    if cfg.tree_depth is None:
        return None
    d, n = cfg.tree_depth, cfg.n_owners
    if isinstance(theta_L, ParamFlat):
        dev = theta_L.buf.device
        rows = n if theta_L.layout is None else theta_L.layout.n_local
        nodes = torch.zeros((rows, d, theta_L.buf.shape[0]), dtype=torch.float32, device=dev)
    else:
        dev = tree_flatten(theta_L)[0][0].device
        nodes = tree_map(lambda leaf: _node_leaf(leaf, n, d), theta_L)
    return TreeNoise(nodes, torch.zeros(n, dtype=torch.int32, device=dev), d)


def _node_leaf(leaf: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """All-zero (n, d, *leaf.shape) f32 nodes of one leaf; a DTensor leaf
    gives DTensor nodes laid out as `rules.param_specs(..., node_axes=True)`
    says (the owner and level axes replicated, the rest as the leaf), each
    rank allocating only (n, d, *its block)."""
    if not spmd.is_dtensor(leaf):
        return torch.zeros((n, d) + tuple(leaf.shape), dtype=torch.float32, device=leaf.device)
    local = leaf.to_local()
    return spmd.with_owner_axis(leaf, torch.zeros((n, d) + tuple(local.shape),
                                                  dtype=torch.float32, device=local.device),
                                n, d)


def _require_tree(cfg: AsyncDPConfig, state: AsyncDPState) -> Optional[TreeNoise]:
    """The state's TreeNoise when cfg asks for one (raising on a state
    built without it, or with another depth); None otherwise."""
    if cfg.tree_depth is not None:
        if state.tree is None:
            raise ValueError(
                "cfg.tree_depth is set but the state carries no noise tree; "
                "build the state with init_state_flat / Federation.init_state "
                "under the same config")
        if state.tree.depth != cfg.tree_depth:
            raise ValueError(f"the state's tree has depth {state.tree.depth}, "
                             f"the config {cfg.tree_depth}")
    return state.tree


def _check_tree_config(cfg: AsyncDPConfig) -> None:
    """Refuse, when the round functions are built, a depth outside [0, 30]
    or caps the tree cannot hold: past 2^d - 1 leaves the binary counter
    has no level left for the fresh node."""
    if cfg.tree_depth is None:
        return
    if not 0 <= cfg.tree_depth <= 30:
        raise ValueError(f"tree_depth must be in [0, 30], got {cfg.tree_depth}")
    if cfg.tree_depth:
        cap_max = (1 << cfg.tree_depth) - 1
        if max(cfg.effective_caps) > cap_max:
            raise ValueError(
                f"depth-{cfg.tree_depth} tree holds {cap_max} leaves but effective caps "
                f"reach {max(cfg.effective_caps)}; lower cfg.caps or deepen the tree")


def _init_staleness(cfg: AsyncDPConfig, device) -> Optional[StalenessState]:
    """Fresh runtime counters when cfg.staleness is armed; refuses a
    staleness config without the fault layer (TIMEOUT is a fault code, and
    the drivers' staleness algebra lives in their fault-armed rounds)."""
    if cfg.staleness is None:
        return None
    if cfg.fault_policy is None:
        raise ValueError(
            "cfg.staleness rides on the fault algebra (TIMEOUT is a fault "
            "code); arm cfg.fault_policy too — a never-quarantine "
            "FaultPolicy(max_faults=2**30, window=2**30) changes nothing")
    return init_staleness_state(cfg.n_owners, cfg.staleness, device)


def _armed(cfg: AsyncDPConfig, bank, device, layout: Optional[FlatLayout] = None
           ) -> Tuple[Optional[FaultState], Optional[StalenessState]]:
    """The fault and staleness states a fresh state carries under cfg
    (replicated (N,) columns on a mesh; `layout` reads the bank's block)."""
    stale = _init_staleness(cfg, device)
    faults = (None if cfg.fault_policy is None
              else init_fault_state(bank, cfg.n_owners, layout=layout))
    return faults, stale


def _bank_leaf(leaf: torch.Tensor, n_owners: int) -> torch.Tensor:
    """(N, *leaf.shape) with each owner's row a copy of the leaf
    (materialized: an in-place row write must not land in a broadcast
    view). A DTensor leaf gives a DTensor bank leaf whose owner axis is
    replicated and whose other dims are laid out as the leaf's: each rank
    allocates only (N, *its block)."""
    if not spmd.is_dtensor(leaf):
        return torch.empty((n_owners,) + tuple(leaf.shape), dtype=leaf.dtype,
                           device=leaf.device).copy_(leaf)
    local = leaf.to_local()
    rows = torch.empty((n_owners,) + tuple(local.shape), dtype=local.dtype,
                       device=local.device).copy_(local)
    return spmd.with_owner_axis(leaf, rows, n_owners)


def _copy_leaf(leaf: torch.Tensor, device) -> torch.Tensor:
    """A copy of a leaf on `device`; a DTensor's own block copied where it
    lies."""
    if spmd.is_dtensor(leaf):
        return spmd.like(leaf, leaf.to_local().detach().clone())
    return leaf.detach().to(device=device, copy=True)


def init_state(params, cfg: AsyncDPConfig, device=None, mesh=None, specs=None) -> AsyncDPState:
    """Pytree state on `device` (CUDA when None): theta_L a copy of the
    model tree, every bank leaf (N_owners, *leaf.shape) with each owner's
    row a copy of the leaf (materialized: an in-place row write must not
    land in a broadcast view), a fresh device ledger (every owner capped
    at its effective cap), under the tree mechanism all-zero noise trees,
    and under cfg.fault_policy / cfg.staleness fresh fault and runtime
    counters (the checksums of the bank's rows).

    On a device mesh: `params` already DTensors, or plain with `mesh` and
    `specs` (a `rules.param_specs` tree) to place them. theta_L keeps the
    params' placements and the bank is laid out as
    `rules.param_specs(..., bank_axis=True)`: each rank allocates only its
    (N, *block) piece. `step` and the ledger are plain and the same on
    every rank. Under the tree mechanism the nodes are laid out as
    `rules.param_specs(..., node_axes=True)` ((N, d, *block) on each rank),
    and the counts, the fault and the runtime columns are replicated."""
    if mesh is not None:
        if specs is None:
            raise ValueError("init_state(mesh=) needs the params' specs "
                             "(sharding.rules.param_specs)")
        from repro_torch.sharding import rules
        params = rules.distribute(params, specs, mesh)
    device = resolve_device(device)
    theta = tree_map(lambda leaf: _copy_leaf(leaf, device), params)
    bank = tree_map(lambda leaf: _bank_leaf(leaf, cfg.n_owners), theta)
    return AsyncDPState(theta, bank, torch.zeros((), dtype=torch.int32, device=device),
                        make_device_ledger(cfg.effective_caps, device=device),
                        init_tree_noise(cfg, theta), *_armed(cfg, bank, device))


def init_state_flat(params, cfg: AsyncDPConfig, device=None, bank_dtype=None,
                    mesh=None) -> AsyncDPState:
    """Flat state on `device` (CUDA when None): theta_L packed into one
    (P,) buffer, every bank row a copy of it, a fresh device ledger (every
    owner capped at its effective cap), under the tree mechanism all-zero
    noise trees, and the fault and runtime counters when cfg arms them.

    `bank_dtype` (None = float32) is the bank's storage only: torch.bfloat16
    or torch.float16 halves it (also by name: "bfloat16", "float16");
    "int8"/"fp8" (or a flatten.BankCodec) build the quantized bank, about
    4x below f32 (see flatten.QuantBank). Only f32 keeps the
    bit parity with the f32 reference; the others round the owner copies.

    `mesh` (a named ("data", "model") DeviceMesh from launch.mesh; None =
    one device) lays the state out under `sharding.rules.flat_shardings`:
    this rank keeps only its block (`theta_L.layout`) of theta_L, the bank
    (codes and scales), the residual and the tree nodes, owner rows over the
    data axes and P over 'model'; the ledger, the leaf counts and the fault
    and runtime columns are replicated. Every rank calls it, in the same
    order (it creates the layout's process groups)."""
    device = resolve_device(device)
    layout = None if mesh is None else layout_for(mesh, cfg.n_owners, flatten_spec(params).size)
    flat = pack_params(params, device=device, layout=layout)
    bank = init_flat_bank(flat, cfg.n_owners, bank_dtype)
    return AsyncDPState(flat, bank, torch.zeros((), dtype=torch.int32, device=device),
                        make_device_ledger(cfg.effective_caps, device=device),
                        init_tree_noise(cfg, flat), *_armed(cfg, bank, device, layout))


def _decode_bank_row(bank: QuantBank, owner_idx: torch.Tensor, col0: int = 0) -> torch.Tensor:
    """Gather one owner row of a quantized bank and decode it to (P,) f32
    (on a mesh this rank's columns, from `col0`, with the row's scales)."""
    return decode_row(bank.codes.index_select(0, owner_idx).reshape(-1),
                      bank.scales.index_select(0, owner_idx).reshape(-1),
                      bank.codec.fmt, block_elems=bank.codec.block_elems, col0=col0)


def _encode_bank_row(bank: QuantBank, value: torch.Tensor, key: torch.Tensor,
                     lay: Optional[FlatLayout] = None):
    """Encode one f32 row (the EF residual already added to `value`) under
    the round key -> (codes (P,), scales (nb,), err (P,)). The codec folds
    its own salt into the key (bank_codec.ref.CODEC_SALT). On a mesh
    `value` is this rank's columns: the scales are the whole row's (the
    partial absmaxes reduced over the column group, NaN kept; per block
    under per-block scales, `flatten.sliced_scales`) and each column rounds
    with its own counter."""
    codec = bank.codec
    if lay is None:
        return encode_row(value, key, codec.fmt, block_elems=codec.block_elems)
    return encode_row(value, key, codec.fmt, block_elems=codec.block_elems, col0=lay.c0,
                      scale=sliced_scales(value, codec, lay))


def _write_rows_(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                 lay: Optional[FlatLayout] = None, mask: Optional[torch.Tensor] = None
                 ) -> None:
    """buf[idx[m]] = rows[m] IN PLACE (narrowed to buf's dtype) where
    mask[m] (None: every member), the row as it stands elsewhere. `idx` (g,)
    are global rows; on a mesh only the rank that holds a row writes it, at
    its local index, one member at a time (a member this rank does not hold
    clamps onto a local row and writes it back as it stands, so the writes
    never collide). A pytree state's DTensor leaf (a bank or node leaf
    whose leading axis is replicated) is read and written in each rank's
    own piece (`spmd.take_row`, `spmd.put_rows_`)."""
    if lay is None and mask is None:
        spmd.put_rows_(buf, idx, rows.to(buf.dtype))
        return
    if lay is None:
        lidx, keep = idx, mask
    else:
        lidx, keep = lay.local(idx)
        if mask is not None:
            keep = keep & mask
    shape = (1,) * (rows.dim() - 1)
    for m in range(idx.numel()):
        i = lidx[m:m + 1]
        new = torch.where(keep[m].reshape(shape), rows[m].to(buf.dtype), spmd.take_row(buf, i))
        spmd.put_rows_(buf, i, new.unsqueeze(0))


def _quant_write(bank: QuantBank, new_i: torch.Tensor, owner_idx: torch.Tensor,
                 key: torch.Tensor, ok: Optional[torch.Tensor] = None,
                 lay: Optional[FlatLayout] = None) -> QuantBank:
    """Write an owner update into a quantized bank, IN PLACE.

    The shared residual is added to the value BEFORE encoding (error
    feedback) and the fresh quantization error becomes the next residual.
    `ok` (the fused driver's grant) selects between the new row and the
    owner's stored codes and scales, and keeps the old residual on refusal,
    so a refused round is a bit-exact no-op on the whole bank. On a mesh
    every rank of a column block encodes its columns and advances its
    residual (replicated over the owner axis); only the rank holding the
    owner's row writes its codes and scale."""
    codes_n, scales_n, err = _encode_bank_row(bank, new_i + bank.residual, key, lay)
    if ok is None:
        bank.residual.copy_(err)
    else:
        torch.where(ok, err, bank.residual, out=bank.residual)
    mask = None if ok is None else ok.reshape(1)
    _write_rows_(bank.codes, owner_idx, codes_n.reshape(1, -1), lay, mask)
    _write_rows_(bank.scales, owner_idx, scales_n.reshape(1, -1), lay, mask)
    return bank


def _hot(bank):
    """The rows a driver indexes: a PagedBank's hot tier, any other bank
    itself."""
    return bank.hot if isinstance(bank, PagedBank) else bank


def _bank_slot(bank, owner_idx: torch.Tensor):
    """(row_idx, hit) of owner contacts: a PagedBank resolves owner -> hot
    slot on the device (`PagedBank.lookup`), and the drivers fold `hit`
    into their grant, so a non-resident owner's round is a bit-exact masked
    no-op; any other bank indexes rows by owner: (None, None), and every
    path runs as it does without paging."""
    if isinstance(bank, PagedBank):
        return bank.lookup(owner_idx)
    return None, None


def _take_rows(buf: torch.Tensor, idx: torch.Tensor,
               lay: Optional[FlatLayout] = None) -> torch.Tensor:
    """Copies of rows `idx` ((g,) global rows) of a row-leading buffer (a
    bank, the codes, scales or tree nodes): index_select, or on a mesh each
    rank's candidates gathered over the row group (`FlatLayout.pick`)."""
    if lay is None:
        return buf.index_select(0, idx)
    lidx, _ = lay.local(idx)
    return lay.pick(buf.index_select(0, lidx), idx)


def _gather_row(bank: Bank, owner_idx: torch.Tensor,
                lay: Optional[FlatLayout] = None) -> torch.Tensor:
    """The owner's (P,) f32 copy: a decoded QuantBank row, or a dense row
    (a bf16 or f16 row upcast, which is exact). On a mesh, this rank's columns of
    it."""
    return _gather_rows(bank, owner_idx, lay)[0]


def _gather_rows(bank: Bank, owners: torch.Tensor,
                 lay: Optional[FlatLayout] = None) -> torch.Tensor:
    """The (g, P) f32 copies of g owners: quantized rows decoded one member
    after another, dense rows gathered at once (on a mesh, this rank's
    columns: each rank decodes or upcasts its candidates, which are then
    gathered over the row group)."""
    idx = owners if lay is None else lay.local(owners)[0]
    if isinstance(bank, QuantBank):
        col0 = 0 if lay is None else lay.c0
        local = torch.stack([_decode_bank_row(bank, idx[m:m + 1], col0)
                             for m in range(owners.numel())])
    else:
        local = bank.index_select(0, idx).to(torch.float32)
    return local if lay is None else lay.pick(local, owners)


def _tree_row_of(tree: TreeNoise, owner_idx: torch.Tensor,
                 row_idx: Optional[torch.Tensor] = None, lay: Optional[FlatLayout] = None):
    """(a copy of the owner's node row: (depth, P) flat or a tree of
    (depth, *leaf.shape) leaves, its (1,) int32 leaf count). `row_idx` (a
    paged bank's hot slot) is the node row when it is not the owner's; the
    count is the owner's. On a mesh the row is this rank's columns (a flat
    state's) or blocks (a pytree state's, each rank reading its own piece)."""
    ridx = owner_idx if row_idx is None else row_idx
    row = tree_map(lambda nodes: (spmd.take_row(nodes, ridx) if lay is None
                                  else _take_rows(nodes, ridx, lay)[0]), tree.nodes)
    return row, tree.counts.index_select(0, owner_idx)


def _tree_write(tree: TreeNoise, new_row, row_idx: torch.Tensor,
                grant: Optional[torch.Tensor] = None, lay: Optional[FlatLayout] = None
                ) -> None:
    """Write a node row IN PLACE at `row_idx` ((1,) int64: the owner, or
    its hot slot), leaf by leaf; with `grant` (a one-element int32 tensor)
    0 the row as it stands now is written back, so a refused round is a
    bit-exact no-op on the nodes (also when an earlier member of a group
    wrote the slot its missed owner clamped to). On a mesh only the rank
    holding the row writes it. The caller bumps the leaf count."""
    mask = None if grant is None else grant.reshape(1) != 0
    for nodes, new in zip(tree_flatten(tree.nodes)[0], tree_flatten(new_row)[0]):
        _write_rows_(nodes, row_idx, new.unsqueeze(0), lay, mask)


def _write_or_defer(tree: TreeNoise, new_row, row_idx: torch.Tensor, grant,
                    lay: Optional[FlatLayout] = None):
    """Write the new node row now (masked by `grant`, as _tree_write), or,
    with grant=_DEFER, return commit(grant) that writes it later."""
    if grant is _DEFER:
        return lambda g: _tree_write(tree, new_row, row_idx, g, lay)
    _tree_write(tree, new_row, row_idx, grant, lay)
    return None


def _tree_delta_at(tree: TreeNoise, owners: torch.Tensor, keys: torch.Tensor,
                   ns: torch.Tensor, grant, row_idx: Optional[torch.Tensor],
                   lay: FlatLayout, rows: bool):
    """`tree_delta_` (or `tree_delta_rows_`) of the owners' node rows on a
    mesh -> (delta (g, P_local), commit(grant) or None). Every rank of a
    column block needs the delta, which reads the retired nodes of the
    owner's row, so the rows are gathered over the row group into a work
    buffer, the kernel advances the work rows (its bits drawn at this rank's
    columns, col0), and the rank holding a row writes it back. With
    grant=_DEFER the first launch has grant 0 and commit launches again."""
    ridx = owners if row_idx is None else row_idx
    work = _take_rows(tree.nodes, ridx, lay)                           # (g, d, Pl)
    at = torch.arange(owners.numel(), dtype=torch.int64, device=owners.device)
    op = tree_delta_rows_ if rows else tree_delta_

    def launch(g):
        return op(work, tree.counts, owners, keys, ns, g, at, col0=lay.c0)

    def land(g):
        with random.replay():                   # the first launch's draw again
            launch(g)
        _write_rows_(tree.nodes, ridx, work, lay, g != 0)

    if grant is _DEFER:
        return launch(torch.zeros(owners.numel(), dtype=torch.int32,
                                  device=owners.device)).reshape(owners.numel(), -1), land
    delta = launch(grant)
    _write_rows_(tree.nodes, ridx, work, lay, None if grant is None else grant.reshape(-1) != 0)
    return delta.reshape(owners.numel(), -1), None


def _retired_sum(row: torch.Tensor, retired: torch.Tensor) -> torch.Tensor:
    """Sum of the retired levels of a (depth, ...) node row, one level at a
    time in increasing order (elementwise, so a flat row and the leaves of
    a pytree row give the same bits)."""
    total = torch.zeros_like(row[0])
    for lvl in range(row.shape[0]):
        total = total + torch.where(retired[lvl], row[lvl], 0.0)
    return total


def _advance_row(row: torch.Tensor, zeta: torch.Tensor, retired: torch.Tensor,
                 fresh: torch.Tensor) -> torch.Tensor:
    """The node row after one leaf: the fresh level takes the draw, the
    retired levels become 0, the rest stay."""
    shape = (row.shape[0],) + (1,) * (row.dim() - 1)
    return torch.where(fresh.reshape(shape), zeta.to(torch.float32).unsqueeze(0),
                       torch.where(retired.reshape(shape), 0.0, row))


def _noise_scales(cfg: AsyncDPConfig, device=None) -> torch.Tensor:
    """Theorem-1 scale per owner (for the averaged clipped gradient).

    Under the tree mechanism (cfg.tree_depth = d >= 1) this is the
    per-node scale d * b(R) over the effective cap R: each response enters
    d node queries. Depth 0 is the paper scale exactly."""
    levels = cfg.tree_depth if cfg.tree_depth else 1
    horizons = cfg.effective_caps if cfg.tree_depth else (cfg.horizon,) * cfg.n_owners
    return torch.tensor([levels * laplace_scale_theorem1(cfg.xi, h, n_i, e)
                         for h, n_i, e in zip(horizons, cfg.owner_sizes, cfg.epsilons)],
                        dtype=torch.float32, device=device)


def _clip_scale(xi: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """min(1, xi / max(norm, 1e-12)), a true f32 division."""
    return torch.clamp(xi / torch.clamp(norm, min=1e-12), max=1.0)


def _example_clipped_rows(loss_fn, spec, xi: torch.Tensor, tb: torch.Tensor,
                          batch: Dict[str, torch.Tensor]):
    """Per-example clipping for g members: tb (g, P), batch leaves (g, B,
    ...) -> (acc (g, P), norms (g, B)).

    As the reference's example granularity: each example's gradient is taken
    at the member's theta_bar with the example as a batch of one, clipped
    by its own L2 norm, and the clipped rows are summed (the 1/B mean is the
    caller's gain). theta_bar is expanded into a (g*B, P) autograd leaf,
    the loss is `torch.func.vmap`ped over its rows and the examples, and
    autograd takes ONE backward of the sum: row r's loss reads only row r,
    so row r of the gradient is example r's own. The g*B norms come from
    ONE `sqnorm` row-axis launch; the rows are then scaled in place and
    summed. Peak: two (g*B, P) f32 tensors (the leaf and its gradient),
    which `example_group_cap` bounds under max_group="auto"."""
    g, B = next(iter(batch.values())).shape[:2]
    p = tb.shape[-1]
    with span("privatizer.grad"):
        leaf = tb.detach().repeat_interleave(B, dim=0).requires_grad_(True)  # (g*B, P)
        exs = {k: a.reshape((g * B, 1) + tuple(a.shape[2:])) for k, a in batch.items()}
        losses = torch.func.vmap(lambda t, ex: loss_fn(spec.unpack(t), ex))
        with span("model.forward"):
            loss = losses(leaf, exs).sum()
        with span("model.backward"):
            loss.backward()
        grads = leaf.grad
        leaf.grad = None
        del leaf
        with span("privatizer.clip"):
            norms = torch.sqrt(fused_sqnorm_rows(grads))                       # (g*B,)
            grads.mul_(_clip_scale(xi, norms)[:, None])
            acc = grads.reshape(g, B, p).sum(dim=1)
    return acc, norms.reshape(g, B)


# the share of the free device memory that example_group_cap plans to fill
EXAMPLE_MEMORY_SHARE = 0.85


def example_group_cap(batch: int, p: int, free_bytes: int) -> int:
    """The most members a grouped round at example granularity fits in
    `free_bytes` of device memory (>= 1). A member holds 2 * batch rows of
    P f32 (its share of `_example_clipped_rows`' leaf and gradient) and
    about six (P,) f32 rows more (theta_bar, the gathered and new bank
    rows, the clipped sum, the noise and `dp_round`'s output); the plan
    fills EXAMPLE_MEMORY_SHARE of the free bytes, leaving the rest to the
    activations."""
    per_member = (2 * int(batch) + 6) * int(p) * 4
    return max(1, int(free_bytes * EXAMPLE_MEMORY_SHARE) // per_member)


def device_free_bytes(device) -> Optional[int]:
    """Bytes a CUDA device can still give this process (the free memory
    CUDA reports and what the caching allocator holds unused); None for
    the CPU, whose memory no cap plans for."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device))


def _flat_clipped_grad_acc(loss_fn, spec, pcfg: PrivatizerConfig,
                           tb: torch.Tensor, batch: Dict[str, torch.Tensor]):
    """Sum of per-group (or per-example) clipped (P,) gradients at
    theta_bar, the group gain, and the clip metrics, all on tb's device.

    Microbatch granularity: theta_bar becomes an autograd leaf; the loss
    sees views of it, so after backward() its .grad IS the packed (P,)
    gradient. Each group's clip norm runs through the `sqnorm` kernel; the
    group-mean divide is deferred into `gain` so `dp_round` fuses it with
    the noise add. Example granularity (`_example_clipped_rows` for one
    member): the B per-example gradients, their norms in one `sqnorm`
    row-axis launch, gain 1/B; `pre_grouped` is ignored there, as in the
    reference."""
    B = next(iter(batch.values())).shape[0]
    xi = torch.full((), pcfg.xi, dtype=torch.float32, device=tb.device)
    if pcfg.granularity == "example":
        acc, norms = _example_clipped_rows(loss_fn, spec, xi, tb.unsqueeze(0),
                                           {k: a.unsqueeze(0) for k, a in batch.items()})
        norms = norms[0]
        gain = torch.full((), 1.0 / B, dtype=torch.float32, device=tb.device)
        return acc[0], gain, {"clip_frac": torch.mean((norms > xi).to(torch.float32)),
                              "max_grad_norm": torch.amax(norms)}
    if pcfg.granularity != "microbatch":
        raise ValueError(pcfg.granularity)
    G = pcfg.n_microbatches
    if not pcfg.pre_grouped and B % G:
        raise ValueError(f"batch of {B} does not split into {G} microbatches")
    leaf = tb.detach().requires_grad_(True)

    def flat_grad(mb) -> torch.Tensor:
        leaf.grad = None
        with span("model.forward"):
            loss = loss_fn(spec.unpack(leaf), mb)
        with span("model.backward"):
            loss.backward()
        return leaf.grad

    xs = batch if pcfg.pre_grouped else _group_batch(batch, G)
    acc = torch.zeros_like(tb)
    nclip = torch.zeros((), dtype=torch.float32, device=tb.device)
    mx = torch.zeros((), dtype=torch.float32, device=tb.device)
    for gi in range(G):
        with span("privatizer.grad"):
            g = flat_grad({k: a[gi] for k, a in xs.items()})
            with span("privatizer.clip"):
                norm = torch.sqrt(fused_sqnorm(g))
                acc = acc + g * _clip_scale(xi, norm)
                nclip = nclip + (norm > xi)
                mx = torch.maximum(mx, norm)
    gain = torch.full((), 1.0 / G, dtype=torch.float32, device=tb.device)
    return acc, gain, {"clip_frac": nclip / G, "max_grad_norm": mx}


def _flat_clipped_grad_acc_rows(loss_fn, spec, pcfg: PrivatizerConfig,
                                tb: torch.Tensor, batch: Dict[str, torch.Tensor]):
    """`_flat_clipped_grad_acc` for g members at once: tb (g, P), batch
    leaves (g, B, ...). Returns acc (g, P), gain (g,) and the (g,) clip
    metrics.

    Microbatch granularity: per microbatch the loss is `torch.func.vmap`ped
    over the members and autograd takes ONE backward of their sum (a
    batched backward, not g of them): member m's loss reads only row m, so
    row m of the gradient is its own. Then one batched `sqnorm`; the clip
    scale is applied per row. Example granularity: `_example_clipped_rows`
    over the g*B (member, example) rows, one `sqnorm` launch for the group.

    vmap of the loss with autograd's backward, rather than vmap of
    `torch.func.grad`: the same batched kernels, without the functorch
    transform wrapping every op of the backward, whose host time is what
    limits a round on the card (PERF.md)."""
    g, B = next(iter(batch.values())).shape[:2]
    dev = tb.device
    xi = torch.full((), pcfg.xi, dtype=torch.float32, device=dev)
    if pcfg.granularity == "example":
        acc, norms = _example_clipped_rows(loss_fn, spec, xi, tb, batch)
        gain = torch.full((g,), 1.0 / B, dtype=torch.float32, device=dev)
        return acc, gain, {"clip_frac": torch.mean((norms > xi).to(torch.float32), dim=1),
                           "max_grad_norm": torch.amax(norms, dim=1)}
    if pcfg.granularity != "microbatch":
        raise ValueError(pcfg.granularity)
    G = pcfg.n_microbatches
    if not pcfg.pre_grouped and B % G:
        raise ValueError(f"batch of {B} does not split into {G} microbatches")
    losses = torch.func.vmap(lambda t, mb: loss_fn(spec.unpack(t), mb))
    leaf = tb.detach().requires_grad_(True)
    xs = batch if pcfg.pre_grouped else {
        k: a.reshape((g, G, B // G) + tuple(a.shape[2:])) for k, a in batch.items()}
    acc = torch.zeros_like(tb)
    nclip = torch.zeros(g, dtype=torch.float32, device=dev)
    mx = torch.zeros(g, dtype=torch.float32, device=dev)
    for gi in range(G):
        with span("privatizer.grad"):
            leaf.grad = None
            with span("model.forward"):
                loss = losses(leaf, {k: a[:, gi] for k, a in xs.items()}).sum()
            with span("model.backward"):
                loss.backward()
            gm = leaf.grad
            with span("privatizer.clip"):
                norm = torch.sqrt(fused_sqnorm_rows(gm))
                acc = acc + gm * _clip_scale(xi, norm)[:, None]
                leaf.grad = gm = None
                nclip = nclip + (norm > xi)
                mx = torch.maximum(mx, norm)
    gain = torch.full((g,), 1.0 / G, dtype=torch.float32, device=dev)
    return acc, gain, {"clip_frac": nclip / G, "max_grad_norm": mx}


class _RoundConsts:
    """The per-owner scalars of a round on the device, built once per
    driver: the noise scales, the owner weights w_i = n_i / n (a true f32
    division; a python-scalar divisor would be a reciprocal multiply on
    CUDA) and 2N as a divisor, with the paper's learning rates."""

    def __init__(self, cfg: AsyncDPConfig, scales: Optional[torch.Tensor], device):
        self.scales = (_noise_scales(cfg, device) if scales is None
                       else scales.to(device=device, dtype=torch.float32))
        n_i = torch.tensor(list(cfg.owner_sizes), dtype=torch.float32, device=device)
        self.w = n_i / torch.full_like(n_i, float(cfg.n_total))
        self.two_n = torch.full((), 2 * cfg.n_owners, dtype=torch.float32, device=device)
        self.lr_own, self.lr_L = paper_rates(cfg.n_owners, cfg.horizon, cfg.rho, cfg.sigma,
                                             cfg.lr_scale)
        self._zeros = torch.zeros(cfg.n_owners, dtype=torch.int32, device=device)

    def no_grant(self, g: int) -> torch.Tensor:
        """(g,) int32 zeros: the grant of a tree launch that only computes
        delta (a deferred write)."""
        return self._zeros[:g]

    def of(self, owner_idx: torch.Tensor):
        """(noise scale, w_i) of the (1,) int64 owner index, as 0-d tensors."""
        return (self.scales.index_select(0, owner_idx).reshape(()),
                self.w.index_select(0, owner_idx).reshape(()))

    def of_rows(self, owners: torch.Tensor):
        """(noise scales, w) of the (g,) int64 owners, each (g,)."""
        return self.scales.index_select(0, owners), self.w.index_select(0, owners)


# `grant` of a round compute that leaves the noise tree as it was and hands
# the write back to the caller: a fault-armed round knows whether it
# applies only after its guards have seen the round's result
_DEFER = object()


def _decayed(theta_L: torch.Tensor, theta_i: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """theta_L + w * (theta_i - theta_L) in f32, in the reference's op order
    (not torch.lerp, which switches formulas at w >= 0.5), cast to the
    row's dtype: the staleness-decayed inertia target. `w` broadcasts (one
    round's 0-d weight, or a group's (g, 1) column)."""
    lf = theta_L.to(torch.float32)
    return (lf + w * (theta_i.to(torch.float32) - lf)).to(theta_i.dtype)


def _round_math(loss_fn, cfg: AsyncDPConfig, consts: _RoundConsts):
    """The paper's inertia round (eqs. 5-7) on pytree states.

    Returns compute(theta_L, bank, batch, owner_idx, key, tree=None,
    grant=None, stale_w=None, row_idx=None) -> (new_L, new_i, theta_i,
    metrics, commit), `owner_idx` a (1,) int64 device index and `key` the
    round's (2,) uint32 key. A pytree bank cannot page, so `row_idx` must
    be None (a PagedBank raises). `stale_w` (the staleness decay, a 0-d f32 weight) makes the round
    run against theta_L + w * (theta_i - theta_L); the RAW theta_i comes
    back, for the masked write-backs. The core
    without the bank gather is `compute.inner(theta_L, theta_i, batch,
    owner_idx, key, noise_extra=None) -> (new_L, new_i, metrics, zeta)`:
    the flat engine's reference mode runs that SAME function on views of
    its buffers, which is what makes flat-versus-pytree bit parity hold.
    `noise_extra` (the tree mechanism) is the negated sum of the retired
    nodes, added to the response; inner then also returns the fresh draw
    zeta, which becomes the new node without a second use of the key.

    With a `tree` (cfg.tree_depth >= 1) compute advances the owner's node
    row in place, unless the one-element int32 `grant` is 0; the caller
    bumps the leaf count. With grant=_DEFER the row stays as it was and
    `commit(grant)` writes it (a fault-armed round calls it once its guards
    have decided); commit is None otherwise."""
    pcfg = cfg.privatizer

    def project(tree):
        return tree_map(lambda leaf: torch.clamp(leaf, -cfg.theta_max, cfg.theta_max), tree)

    def inner(theta_L, theta_i, batch, owner_idx, key, noise_extra=None):
        theta_bar = tree_map(lambda a, b: 0.5 * (a + b), theta_L, theta_i)     # (6)
        ns, w_i = consts.of(owner_idx)
        if noise_extra is None:
            qbar, pm = private_grad(loss_fn, theta_bar, batch, key, cfg=pcfg,
                                    noise_scale=ns)                              # (3)+(4)
            zeta = None
        else:
            qbar, pm, zeta = private_grad(loss_fn, theta_bar, batch, key, cfg=pcfg,
                                          noise_scale=ns, return_noise=True)
            qbar = tree_map(lambda q, e: (q.to(torch.float32) + e).to(q.dtype),
                            qbar, noise_extra)
        g_reg = tree_map(lambda leaf: cfg.sigma * leaf.to(torch.float32), theta_bar)
        new_i = project(tree_map(
            lambda tb, gg, q: tb - (consts.lr_own * (gg / consts.two_n
                                                     + w_i * q.to(torch.float32))
                                    ).to(tb.dtype),
            theta_bar, g_reg, qbar))                                             # (5)
        new_L = project(tree_map(lambda tb, gg: tb - (consts.lr_L * gg).to(tb.dtype),
                                 theta_bar, g_reg))                              # (7)
        metrics = {"clip_frac": pm["clip_frac"], "max_grad_norm": pm["max_grad_norm"],
                   "grad_noise_scale": ns}
        return new_L, new_i, metrics, zeta

    def compute(theta_L, bank, batch, owner_idx, key, tree: Optional[TreeNoise] = None,
                grant=None, stale_w: Optional[torch.Tensor] = None, row_idx=None):
        if isinstance(bank, PagedBank) or row_idx is not None:
            raise TypeError("PagedBank needs the flat engine (paging.init_paged_state "
                            "builds ParamFlat states); the pytree path cannot page")
        theta_i = tree_map(lambda leaf: spmd.take_row(leaf, owner_idx), bank)
        theta_eff = theta_i if stale_w is None else tree_map(
            lambda l, i: _decayed(l, i, stale_w), theta_L, theta_i)
        d = cfg.tree_depth
        if tree is None or not d:
            # no tree, or the degenerate depth-0 tree: the independent round
            new_L, new_i, metrics, _ = inner(theta_L, theta_eff, batch, owner_idx, key)
            return new_L, new_i, theta_i, metrics, None
        if pcfg.fused_kernel:
            raise ValueError(
                "tree mechanism with fused_kernel needs the flat engine "
                "(init_state_flat) — the pytree path's fused privatizer "
                "adds its noise in-kernel and cannot split out the draw")
        row, count = _tree_row_of(tree, owner_idx)
        retired, fresh = tree_masks_ref(count, d)                 # (d,) bool
        extra = tree_map(lambda nd: -_retired_sum(nd, retired), row)
        new_L, new_i, metrics, zeta = inner(theta_L, theta_eff, batch, owner_idx, key,
                                            noise_extra=extra)
        new_row = tree_map(lambda nd, z: _advance_row(nd, z, retired, fresh), row, zeta)
        return new_L, new_i, theta_i, metrics, _write_or_defer(tree, new_row, owner_idx, grant)

    compute.inner = inner
    return compute


def _tree_epilogue(cfg: AsyncDPConfig, consts: _RoundConsts, tb, acc, gain, delta, w):
    """(new_L, new_i) of the fused flat round under the tree: q = acc * gain
    + delta (eq. 4), then eqs. (5) and (7) and the projection in
    `dp_round`'s op order; gain and w broadcast against tb (one round's
    scalars, or a group's (g, 1) columns)."""
    q = acc * gain + delta                                               # (4)
    g_reg = cfg.sigma * tb
    new_i = torch.clamp(tb - consts.lr_own * (g_reg * (1.0 / (2 * cfg.n_owners)) + w * q),
                        -cfg.theta_max, cfg.theta_max)                   # (5)
    new_L = torch.clamp(tb - consts.lr_L * g_reg, -cfg.theta_max, cfg.theta_max)  # (7)
    return new_L, new_i


def _round_math_flat(loss_fn, cfg: AsyncDPConfig, consts: _RoundConsts, tree_inner):
    """The inertia round on the flat representation.

    Returns compute(theta_L, bank, batch, owner_idx, key, tree=None,
    grant=None, stale_w=None, row_idx=None) -> (new_L, new_i, theta_i,
    metrics, commit), as `_round_math` (stale_w and grant=_DEFER included).
    On a PagedBank `row_idx` is the owner's hot slot ((1,) int64): the row
    and the node row are read (and the node row written) there, while the
    noise scale, the weight and the leaf count are the owner's.
    The per-round scalars (group gain, the owner's noise scale and weight)
    stay on the device and reach the kernels as pointers.

    fused_kernel=True: the packed gradient, clipped through `sqnorm`, then
    one `dp_round` pass. With a `tree` (cfg.tree_depth >= 1) the round key
    feeds only the tree op instead: `tree_delta` advances the owner's node
    row in place, unless `grant` is 0, the response adds its delta, and the
    epilogue repeats dp_round's op order as torch ops. Deferred, the kernel
    runs with grant 0 (delta only, the row untouched) and commit(grant)
    launches it again with the real grant: its draw depends only on the
    key, the count and the row, so the second launch writes what a masked
    single launch would, and the (depth, P) row is never copied.

    fused_kernel=False, the REFERENCE mode: the row is gathered (decoded on
    a quantized bank), theta_L and the row are unpacked into views, and
    `tree_inner` (the pytree path's `inner`) runs on them; its results are
    packed back. Under the tree the retired nodes and the fresh draw take
    the pytree path's elementwise ops on the flat row. So on f32 banks the
    result is bit for bit `spec.pack` of the pytree path's.

    On a mesh (`theta_L.layout` set) theta_L, the gathered row and the
    round's outputs are this rank's columns. theta_bar (or, in the
    reference mode, theta_L and the row) is gathered over the column group
    and every rank computes the whole gradient of the round's owner, clips
    it with `sqnorm` on the full vector (the clip norm of the unmeshed
    run, bit for bit) and keeps its own columns; the kernels then draw the
    bits of those columns (col0)."""
    pcfg = cfg.privatizer
    N = cfg.n_owners

    def compute(theta_L: ParamFlat, bank, batch, owner_idx, key,
                tree: Optional[TreeNoise] = None, grant=None,
                stale_w: Optional[torch.Tensor] = None, row_idx=None):
        spec, lay = theta_L.spec, theta_L.layout
        ridx = owner_idx if row_idx is None else row_idx
        theta_i = _gather_row(_hot(bank), ridx, lay)                 # (P,) f32 copy
        theta_eff = theta_i if stale_w is None else _decayed(theta_L.buf, theta_i, stale_w)
        tree_on = tree is not None and bool(cfg.tree_depth)
        full = (lambda x: x) if lay is None else lay.gather_cols
        mine = (lambda x: x) if lay is None else lay.col_slice
        commit = None
        if not pcfg.fused_kernel:
            extra = None
            if tree_on:
                row, count = _tree_row_of(tree, owner_idx, ridx, lay)  # (d, P)
                retired, fresh = tree_masks_ref(count, cfg.tree_depth)
                extra = spec.unpack_f32(-_retired_sum(full(row), retired))
            new_L_t, new_i_t, metrics, zeta = tree_inner(
                spec.unpack(full(theta_L.buf)), spec.unpack(full(theta_eff)), batch, owner_idx,
                key, noise_extra=extra)
            if tree_on:
                commit = _write_or_defer(
                    tree, _advance_row(row, mine(spec.pack_f32(zeta)), retired, fresh), ridx,
                    grant, lay)
            return (theta_L.replace_buf(mine(spec.pack(new_L_t))), mine(spec.pack(new_i_t)),
                    theta_i, metrics, commit)
        if pcfg.mechanism != "laplace":
            raise ValueError("fused_kernel implements the laplace mechanism")
        tb = 0.5 * (theta_L.buf + theta_eff)                         # (6)
        ns, w_i = consts.of(owner_idx)
        acc, gain, pm = _flat_clipped_grad_acc(loss_fn, spec, pcfg, full(tb), batch)
        acc = mine(acc)
        col0 = 0 if lay is None else lay.c0
        with span("privatizer.noise"):
            if tree_on:
                ns1 = ns.reshape(1)
                if lay is not None:
                    delta, commit = _tree_delta_at(tree, owner_idx, key, ns1, grant, row_idx,
                                                   lay, rows=False)
                    delta = delta[0]
                else:
                    delta = tree_delta_(tree.nodes, tree.counts, owner_idx, key, ns1,
                                        consts.no_grant(1) if grant is _DEFER else grant,
                                        row_idx)
                    if grant is _DEFER:
                        def commit(g):
                            with random.replay():       # the first launch's draw again
                                tree_delta_(tree.nodes, tree.counts, owner_idx, key, ns1, g,
                                            row_idx)
                new_L, new_i = _tree_epilogue(cfg, consts, tb, acc, gain, delta, w_i)
            else:
                new_L, new_i = dp_round_flat(                       # (4)+(5)+(7)+Pi
                    tb, acc, key, gain, ns.reshape(1), w_i.reshape(1), sigma=cfg.sigma,
                    lr_own=consts.lr_own, lr_l=consts.lr_L, n_owners=N,
                    theta_max=cfg.theta_max, col0=col0)
        metrics = {"clip_frac": pm["clip_frac"], "max_grad_norm": pm["max_grad_norm"],
                   "grad_noise_scale": ns}
        return theta_L.replace_buf(new_L), new_i, theta_i, metrics, commit

    return compute


def _round_math_flat_rows(loss_fn, cfg: AsyncDPConfig, consts: _RoundConsts):
    """The fused flat round for the g members of a group, all from the
    group-entry theta_L and bank.

    Returns compute_rows(theta_L, bank, batch_g, owners, keys_g, tree=None,
    grant=None, stale_w=None, row_idx=None) -> (new_L, new_i, theta_i,
    metrics, commit), each stacked on a leading (g,) axis; owners (g,)
    int64 distinct, keys_g (g, 2), grant (g,) int32 or _DEFER, stale_w (g,)
    f32, row_idx (g,) the hot slots on a PagedBank. The gradient is
    vmapped over the members and clipped by one batched `sqnorm` per
    microbatch; then one batched `dp_round`, or under the tree one batched
    `tree_delta` (nodes advanced in place, masked by each grant; deferred,
    a second batched launch in commit) and `_round_math_flat`'s epilogue
    per row."""
    N = cfg.n_owners

    def compute_rows(theta_L: ParamFlat, bank, batch_g, owners, keys_g,
                     tree: Optional[TreeNoise] = None, grant=None,
                     stale_w: Optional[torch.Tensor] = None, row_idx=None):
        if cfg.privatizer.mechanism != "laplace":
            raise ValueError("fused_kernel implements the laplace mechanism")
        lay = theta_L.layout
        theta_i = _gather_rows(_hot(bank), owners if row_idx is None else row_idx,
                               lay)                                      # (g, P)
        theta_eff = (theta_i if stale_w is None
                     else _decayed(theta_L.buf, theta_i, stale_w[:, None]))
        tb = 0.5 * (theta_L.buf + theta_eff)                             # (6)
        ns, w = consts.of_rows(owners)
        acc, gain, pm = _flat_clipped_grad_acc_rows(
            loss_fn, theta_L.spec, cfg.privatizer, tb if lay is None else lay.gather_cols(tb),
            batch_g)
        if lay is not None:
            acc = lay.col_slice(acc)
        commit = None
        with span("privatizer.noise"):
            if tree is not None and cfg.tree_depth:
                if lay is not None:
                    delta, commit = _tree_delta_at(tree, owners, keys_g, ns, grant, row_idx,
                                                   lay, rows=True)
                else:
                    delta = tree_delta_rows_(tree.nodes, tree.counts, owners, keys_g, ns,
                                             consts.no_grant(owners.numel())
                                             if grant is _DEFER else grant, row_idx)
                    if grant is _DEFER:
                        def commit(g):
                            with random.replay():       # the first launch's draws again
                                tree_delta_rows_(tree.nodes, tree.counts, owners, keys_g, ns,
                                                 g, row_idx)
                new_L, new_i = _tree_epilogue(cfg, consts, tb, acc, gain[:, None], delta,
                                              w[:, None])
            else:
                new_L, new_i = dp_round_rows(                                # (4)+(5)+(7)+Pi
                    tb, acc, keys_g, gain, ns, w, sigma=cfg.sigma, lr_own=consts.lr_own,
                    lr_l=consts.lr_L, n_owners=N, theta_max=cfg.theta_max,
                    col0=0 if lay is None else lay.c0)
        metrics = {"clip_frac": pm["clip_frac"], "max_grad_norm": pm["max_grad_norm"],
                   "grad_noise_scale": ns}
        return new_L, new_i, theta_i, metrics, commit

    return compute_rows


def _stack_members(values):
    """Per-member results -> one leading (g,) axis: ParamFlats by their
    buffers, trees leaf by leaf, tensors as they are."""
    if isinstance(values[0], ParamFlat):
        return torch.stack([v.buf for v in values])
    return tree_map(lambda *xs: torch.stack(xs), *values)


def _round_compute(loss_fn, cfg: AsyncDPConfig, scales: Optional[torch.Tensor],
                   device=None):
    """The round shared VERBATIM by the drivers (which is what makes the
    sequential ones equal bit for bit), dispatching on the state: a
    ParamFlat theta_L runs the flat engine, a model tree the pytree path;
    `compute.rows` runs a group's members. Checks the tree config when the
    drivers are built."""
    _check_tree_config(cfg)
    consts = _RoundConsts(cfg, scales, resolve_device(device))
    tree_c = _round_math(loss_fn, cfg, consts)
    flat_c = _round_math_flat(loss_fn, cfg, consts, tree_c.inner)
    flat_rows = _round_math_flat_rows(loss_fn, cfg, consts)

    def compute(theta_L, bank, batch, owner_idx, key, tree=None, grant=None, stale_w=None,
                row_idx=None):
        run = flat_c if isinstance(theta_L, ParamFlat) else tree_c
        return run(theta_L, bank, batch, owner_idx, key, tree=tree, grant=grant,
                   stale_w=stale_w, row_idx=row_idx)

    def rows(theta_L, bank, batch_g, owners, keys_g, tree=None, grant=None, stale_w=None,
             row_idx=None):
        """The g members of a group from the group-entry state (owners
        distinct) -> (new_L, new_i, theta_i, metrics, commit) stacked on a
        leading (g,) axis ((g, P) on flat states, (g, *leaf.shape) leaves on
        pytree states); `stale_w` (g,), `row_idx` (g,) and grant=_DEFER as
        in compute, the commit taking a (g,) grant. The fused flat engine
        batches the members; every other state runs them one after another
        through `compute`."""
        if isinstance(theta_L, ParamFlat) and cfg.privatizer.fused_kernel:
            return flat_rows(theta_L, bank, batch_g, owners, keys_g, tree=tree, grant=grant,
                             stale_w=stale_w, row_idx=row_idx)
        outs = [compute(theta_L, bank, {k: v[m] for k, v in batch_g.items()},
                        owners[m:m + 1], keys_g[m], tree=tree,
                        grant=grant if grant is None or grant is _DEFER else grant[m:m + 1],
                        stale_w=None if stale_w is None else stale_w[m],
                        row_idx=None if row_idx is None else row_idx[m:m + 1])
                for m in range(owners.numel())]
        commits = [o[4] for o in outs]
        commit = None
        if any(c is not None for c in commits):
            def commit(g):
                for m, c in enumerate(commits):
                    c(g[m:m + 1])
        return (_stack_members([o[0] for o in outs]), _stack_members([o[1] for o in outs]),
                _stack_members([o[2] for o in outs]),
                {name: torch.stack([o[3][name] for o in outs]) for name in outs[0][3]},
                commit)

    compute.rows = rows
    return compute


def _write_bank_rows(bank, rows, owner_idx: torch.Tensor):
    """Write g owners' copies IN PLACE, narrowed to the bank's dtype: rows
    of a dense (N, P) bank, or rows of every leaf of a pytree bank
    (owner_idx: (g,) int64 device indices, distinct; `rows` (g, ...))."""
    for leaf, v in zip(tree_flatten(bank)[0], tree_flatten(rows)[0]):
        spmd.put_rows_(leaf, owner_idx, v.to(leaf.dtype))
    return bank


def _write_bank(bank, value, owner_idx: torch.Tensor):
    """Write one owner's copy IN PLACE (owner_idx: (1,) int64)."""
    return _write_bank_rows(bank, tree_map(lambda v: v.unsqueeze(0), value), owner_idx)


def _member_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(g,) bool -> broadcastable against a (g, ...) stacked leaf."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _select(ok: torch.Tensor, new, old):
    """torch.where(ok, new, old) over a ParamFlat's buffer or every leaf of
    a tree."""
    if isinstance(new, ParamFlat):
        return new.replace_buf(torch.where(ok, new.buf, old.buf))
    return tree_map(lambda a, b: torch.where(ok, a, b), new, old)


def _require_fault_policy(cfg: AsyncDPConfig, state: AsyncDPState) -> Optional[FaultPolicy]:
    """cfg.fault_policy, checked against the state: a state with fault
    counters needs the policy it was built under."""
    if state.faults is not None and cfg.fault_policy is None:
        raise ValueError("the state carries fault counters but cfg.fault_policy is None; "
                         "build the driver and the state from the same config")
    return cfg.fault_policy


def _require_staleness(cfg: AsyncDPConfig, state: AsyncDPState) -> Optional[StalenessPolicy]:
    """cfg.staleness, checked against the state: both armed or both absent,
    and the runtime only on a fault-armed state."""
    if (state.stale is None) != (cfg.staleness is None):
        raise ValueError("cfg.staleness and the state's runtime counters must be armed "
                         "together; build the driver and the state from the same config")
    if state.stale is not None and state.faults is None:
        raise ValueError("the staleness runtime rides on the fault algebra; the state "
                         "must carry a FaultState (arm cfg.fault_policy)")
    return cfg.staleness


def _decay_weight(state: AsyncDPState, spolicy: Optional[StalenessPolicy], owners, t):
    """The rounds' decay**age weights, or None when no decay is armed (the
    undecayed round is then computed as it is without staleness)."""
    if state.stale is None or spolicy.decay == 1.0:
        return None
    return staleness_weight(state.stale, owners, t, spolicy)


def _no_faults_armed(fault_codes) -> None:
    if fault_codes is not None:
        raise ValueError("fault codes need a fault-armed state; build the config with "
                         "fault_policy=FaultPolicy(...)")


def _layout_of(theta_L) -> Optional[FlatLayout]:
    """The mesh layout of a flat state's theta_L (None: unmeshed, or a
    pytree state)."""
    return theta_L.layout if isinstance(theta_L, ParamFlat) else None


def _masked_write(state: AsyncDPState, owner_idx: torch.Tensor, key: torch.Tensor,
                  row_idx: Optional[torch.Tensor] = None):
    """write(new_L, new_i, theta_i, ok) -> (theta_L, bank) for one round of
    `owner_idx`: where `ok` (0-d bool) the round's theta_L and the owner's
    new row land, else theta_L stays and the owner's own copy is written
    back (a quantized bank keeps its codes, scales and residual). On a
    PagedBank the row is written at the hot slot `row_idx`."""
    widx = owner_idx if row_idx is None else row_idx
    lay = _layout_of(state.theta_L)

    def write(new_L, new_i, theta_i, ok):
        theta_L = _select(ok, new_L, state.theta_L)
        hot = _hot(state.bank)
        if isinstance(hot, QuantBank):
            # same key as compute() by contract (see make_train_step)
            _quant_write(hot, new_i, widx, key, ok=ok, lay=lay)
        elif lay is not None:
            _write_rows_(hot, widx, new_i.unsqueeze(0), lay, ok.reshape(1))
        else:
            _write_bank(hot, _select(ok, new_i, theta_i), widx)
        return theta_L, state.bank
    return write


def _guarded_round(round_fn, write, state: AsyncDPState, batch, owners: torch.Tensor,
                   keys: torch.Tensor, fcodes: torch.Tensor, answered: torch.Tensor,
                   stale_w: Optional[torch.Tensor] = None,
                   row_idx: Optional[torch.Tensor] = None):
    """One fault-guarded round of one owner, or of a group of distinct
    owners on a member axis (reference: deep._guarded_round, and the
    guards of its make_group_rounds).

    `fcodes` is 0-d for one round (`owners` (1,), `keys` (2,)) and (g,) for
    a group (`owners` (g,), `keys` (g, 2)); `round_fn` is the matching
    `_round_compute` entry (compute, or compute.rows) and `write` lands the
    members whose mask is set (`_masked_write`, or the grouped driver's
    write_members). `answered` (same shape as `fcodes`) is the caller's
    grant: authorized, not quarantined, not in backoff, not dropped. The
    guards verify each owner's resident row against its stored checksum
    (on the PRE-round bank: what the round consumed), NaN-poison the update
    on NONFINITE_GRAD, reject STALE replays, and the deadline guard rejects
    TIMEOUT. The round's kernels run whatever the outcome; a rejected round
    is then a bit-exact no-op on theta_L, the bank (codes, scales,
    residual) and the noise tree (nodes and count), and its stored checksum
    stays. The noise tree and the fault state are written in place.
    `row_idx` (a PagedBank's hot slots, shaped as `owners`) is where the
    rows are read and written; the checksum column stays per owner.

    Returns (theta_L, bank, metrics, apply, guard_rej, timed), bools shaped
    as `fcodes`: `guard_rej` answered on time and rejected
    (metrics["faulted"]), `timed` answered late (metrics["timed_out"]):
    epsilon spent either way."""
    fs, tree, bank = state.faults, state.tree, state.bank
    lay = _layout_of(state.theta_L)
    corrupt = fcodes == _faults.CORRUPT_PAYLOAD
    if fcodes.dim() == 0:
        payload_ok = _faults.verify_row(fs.checksum, bank, owners, corrupt, row_idx, lay)
        finite = _faults.finite_guard
    else:
        payload_ok = torch.stack([_faults.verify_row(
            fs.checksum, bank, owners[m:m + 1], corrupt[m],
            None if row_idx is None else row_idx[m:m + 1], lay)
            for m in range(owners.numel())])
        finite = _faults.finite_guard_rows
    new_L, new_i, theta_i, metrics, commit = round_fn(
        state.theta_L, bank, batch, owners, keys, tree=tree, grant=_DEFER, stale_w=stale_w,
        row_idx=row_idx)
    new_i = _faults.inject_nonfinite(new_i, fcodes == _faults.NONFINITE_GRAD)
    guard_ok = payload_ok & finite((new_i, new_L), lay) & (fcodes != _faults.STALE)
    on_time = deadline_guard(fcodes)
    apply = answered & guard_ok & on_time
    timed = answered & ~on_time
    guard_rej = answered & on_time & ~guard_ok
    with span("engine.write"):
        theta_L, bank = write(new_L, new_i, theta_i, apply)
        del new_L, new_i, theta_i
        applied = apply.to(torch.int32).reshape(-1)
        if tree is not None:
            if commit is not None:
                commit(applied)
            tree.counts.index_add_(0, owners, applied)
    # the stored checksum follows the POST-write row; a masked round keeps it
    _faults.update_checksum(fs, bank, owners, apply, row_idx, lay)
    metrics = dict(metrics, faulted=guard_rej, timed_out=timed)
    return theta_L, bank, metrics, apply, guard_rej, timed


def _faulted_round(cfg: AsyncDPConfig, round_fn, write, state: AsyncDPState, batch,
                   owners: torch.Tensor, keys: torch.Tensor, fcodes: torch.Tensor,
                   led_auth: torch.Tensor, t, active: torch.Tensor,
                   row_idx: Optional[torch.Tensor] = None):
    """A device-authorized fault-armed round (or group, as in
    `_guarded_round`) of the K-round drivers: the outcome algebra with the
    precedence quarantine > backoff > budget > drop, then the guarded round,
    the ledger's columns, the fault window and the runtime counters, all
    IN PLACE. `led_auth` is the ledger's grant (on a PagedBank with the page
    table's hit folded in: a miss is refused), `t` the round clock (a
    group's per-member clocks), `active` all-true of `fcodes`' shape,
    `row_idx` the hot slots of a PagedBank.

    Returns (theta_L, bank, metrics, apply)."""
    led, fs, ss = state.ledger, state.faults, state.stale
    quar = fs.quarantined.index_select(0, owners).reshape(fcodes.shape)
    is_retry = None
    if ss is not None:
        in_backoff = (ss.cooldown.index_select(0, owners) > 0).reshape(fcodes.shape)
        is_retry = ~quar & in_backoff
        avail = ~quar & ~in_backoff
    else:
        avail = ~quar
    auth = led_auth & avail
    dropped = auth & (fcodes == _faults.DROP)
    answered = auth & ~dropped
    stale_w = _decay_weight(state, cfg.staleness, owners, t)
    theta_L, bank, metrics, apply, guard_rej, timed = _guarded_round(
        round_fn, write, state, batch, owners, keys, fcodes, answered, stale_w, row_idx)
    refused = avail & ~led_auth
    cols = dict(spent=answered, refused=refused, dropped=dropped, faulted=guard_rej,
                quarantined=quar, timed_out=timed)
    if ss is not None:
        cols["retried"] = is_retry
    _add_columns(led, owners, cols)
    # timeouts and retries are not quarantine events (slowness has its
    # own escalation, the backoff), and a backed-off round is no contact
    _faults.fault_tick(fs, owners, guard_rej | dropped, cfg.fault_policy, active=avail)
    metrics.update(refused=refused, dropped=dropped, quarantined=quar,
                   owner=owners.reshape(fcodes.shape).to(torch.int32))
    if ss is not None:
        metrics["retried"] = is_retry
        staleness_tick(ss, owners, t, is_retry=is_retry, apply=apply, timed=timed,
                       policy=cfg.staleness, active=active, ticks=fcodes.numel())
    return theta_L, bank, metrics, apply


def _check_mesh(mesh, state: AsyncDPState) -> None:
    """A driver built with `mesh` runs flat states laid out on that mesh
    (a pytree state ignores it, as in the reference); a meshed state, flat
    or pytree, runs on its own layout under any driver."""
    if mesh is None or not isinstance(state.theta_L, ParamFlat):
        return
    lay = state.theta_L.layout
    if lay is None or lay.mesh is not mesh:
        raise ValueError("the driver was built for a device mesh but the state is not "
                         "laid out on it; build the state with init_state(..., mesh=) "
                         "on the same mesh")


def _replicating(state: AsyncDPState):
    """On a pytree state on a mesh, a context in which the round's own
    plain tensors (the owner's weight and scale, the rates, the grant and
    fault masks, the staleness weight) stand for the same values on every
    rank; elsewhere a no-op."""
    return spmd.replicating(*tree_flatten(state.theta_L)[0])


def make_train_step(loss_fn, cfg: AsyncDPConfig,
                    scales: Optional[torch.Tensor] = None, device=None, mesh=None):
    """Returns step(state, batch, owner_idx, key, fault_code=None) ->
    (state, metrics).

    One host-authorized round: the caller (the session's mechanism) has
    already granted it, so the update lands unmasked, the device ledger
    passes through untouched and a noise tree takes its leaf. `owner_idx`
    is a one-element int device tensor; the bank row and the tree are
    written in place. Flat and pytree states both run.

    On a fault-armed state (cfg.fault_policy) the session has already
    handled quarantine, backoff, refusal and DROP on the host, so the round
    is answered and only the guards decide (`_guarded_round`): `fault_code`
    (an int, or a 0-d int8 device tensor; None = OK) injects one fault, the
    fault window ticks, and under cfg.staleness the runtime counters tick.
    metrics then also carry "faulted" and "timed_out".

    On a PagedBank the round works on the owner's hot slot, and residency
    is the round's grant: a miss (an owner the pager did not make resident)
    is a bit-exact masked no-op that takes no leaf and no step.

    `mesh` (as init_state_flat's) checks that a flat state is laid out on
    it; the round runs on the state's own layout. A pytree state on a mesh
    (module docstring) runs its round on DTensors."""
    dev = resolve_device(device)
    compute = _round_compute(loss_fn, cfg, scales, device)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)

    def step(state: AsyncDPState, batch, owner_idx: torch.Tensor, key: torch.Tensor,
             fault_code=None) -> Tuple[AsyncDPState, Dict[str, Any]]:
        _check_mesh(mesh, state)
        with _replicating(state):
            return one_round(state, batch, owner_idx, key, fault_code)

    def one_round(state: AsyncDPState, batch, owner_idx: torch.Tensor, key: torch.Tensor,
                  fault_code) -> Tuple[AsyncDPState, Dict[str, Any]]:
        tree = _require_tree(cfg, state)
        o = owner_idx.reshape(1).to(torch.int64)
        slot, hit = _bank_slot(state.bank, o)
        if state.faults is not None:
            policy = _require_fault_policy(cfg, state)
            spolicy = _require_staleness(cfg, state)
            ss = state.stale
            # the session has handled quarantine, backoff and DROP; on a
            # PagedBank residency also gates the answer
            answered = true if hit is None else hit.reshape(())
            fcode = torch.as_tensor(_faults.OK if fault_code is None else fault_code,
                                    device=dev).to(torch.int8).reshape(())
            stale_w = _decay_weight(state, spolicy, o, None if ss is None else ss.clock)
            # the write keys the codec with the round's key by contract
            # (see the fault-off branch below)
            theta_L, bank, metrics, apply, guard_rej, timed = _guarded_round(
                compute, _masked_write(state, o, key, slot),  # dpcheck: ignore[DPC105]
                state, batch, o, key, fcode, answered, stale_w, slot)
            _faults.fault_tick(state.faults, o, guard_rej, policy, active=answered)
            if ss is not None:
                # a dispatched round is never a retry: the session masks the
                # rounds of an owner in backoff before calling the step
                staleness_tick(ss, o, ss.clock, is_retry=~true, apply=apply, timed=timed,
                               policy=spolicy, active=true, ticks=1)
            return AsyncDPState(theta_L, bank, state.step + apply.to(torch.int32),
                                state.ledger, tree, state.faults, ss), metrics
        _no_faults_armed(fault_code)
        if hit is not None:
            # paged: residency is the only grant of a host-authorized round
            grant = hit.to(torch.int32)
            new_L, new_i, theta_i, metrics, _ = compute(state.theta_L, state.bank, batch, o,
                                                        key, tree=tree, grant=grant,
                                                        row_idx=slot)
            # same key as compute() by contract (see below)
            theta_L, bank = _masked_write(state, o, key, slot)(  # dpcheck: ignore[DPC105]
                new_L, new_i, theta_i, hit.reshape(()))
            if tree is not None:
                tree.counts.scatter_add_(0, o, grant)
            return AsyncDPState(theta_L, bank, state.step + grant.reshape(()), state.ledger,
                                tree, state.faults, state.stale), metrics
        new_L, new_i, _, metrics, _ = compute(state.theta_L, state.bank, batch, o, key,
                                              tree=tree)
        lay = _layout_of(state.theta_L)
        if isinstance(state.bank, QuantBank):
            # same key as compute() by contract: the codec folds in its
            # CODEC_SALT, so its rounding bits never touch the privacy stream
            bank = _quant_write(state.bank, new_i, o, key, lay=lay)  # dpcheck: ignore[DPC105]
        elif lay is not None:
            _write_rows_(state.bank, o, new_i.unsqueeze(0), lay)
            bank = state.bank
        else:
            bank = _write_bank(state.bank, new_i, o)
        if tree is not None:
            tree.counts.scatter_add_(0, o, one)
        return AsyncDPState(new_L, bank, state.step + 1, state.ledger, tree, state.faults,
                            state.stale), metrics

    return step


def _add_columns(led: DeviceLedger, owners: torch.Tensor, cols: Dict[str, torch.Tensor]):
    """led.<name>[owners] += cols[name] (bools counted as 0/1), in place."""
    for name, v in cols.items():
        getattr(led, name).index_add_(0, owners, v.to(torch.int32).reshape(-1))


def make_fused_rounds(loss_fn, cfg: AsyncDPConfig,
                      scales: Optional[torch.Tensor] = None, device=None, mesh=None):
    """Device-authorized multi-round driver: K rounds in one call.

    Returns run(state, batches, owner_seq, keys, fault_codes=None) ->
    (state, metrics): every batch leaf carries a leading (K,) round axis,
    owner_seq is (K,) int on the device, keys is (K, 2) uint32, and
    metrics are stacked (K,) device tensors. A refused round runs the same
    round math, then keeps theta_L, writes the owner's own copy back (every
    leaf of a pytree bank), leaves its noise tree (nodes and count) as it
    was and lands in `ledger.refused` for `Federation.reconcile()`; no
    value is read back to the host.

    On a fault-armed state, `fault_codes` ((K,) int8 on the device; None =
    all OK) drive the reference's outcome algebra in each round, with the
    precedence quarantine > backoff > budget > drop: a quarantined owner's
    round is masked and ledgered in `quarantined` (no epsilon, no refusal);
    under cfg.staleness an owner in backoff gives a masked re-dispatch
    (`retried`, no epsilon); a DROP of an authorized owner spends nothing
    (`dropped`); every answered round is charged (`spent`) even when a
    guard rejects it (`faulted`) or it came late (`timed_out`). A masked
    round still runs the round's kernels.

    On a PagedBank each round looks its owner up in the page table; a miss
    is folded into the grant before the ledger counts it: it spends
    nothing and lands in `refused` (a session's pager prefetches every
    dispatched owner, so a refusal there under an authorized schedule
    would flag a pager fault, not a privacy event). `mesh` as in
    make_train_step."""
    dev = resolve_device(device)
    compute = _round_compute(loss_fn, cfg, scales, device)
    true = torch.ones((), dtype=torch.bool, device=dev)

    def body(state: AsyncDPState, batch, owner_idx: torch.Tensor, key: torch.Tensor):
        led, tree = state.ledger, state.tree
        slot, hit = _bank_slot(state.bank, owner_idx)
        ok = led.authorized(owner_idx)
        if hit is not None:
            ok = ok & hit.reshape(())
        oki = ok.to(torch.int32)
        new_L, new_i, theta_i, metrics, _ = compute(state.theta_L, state.bank, batch,
                                                    owner_idx, key, tree=tree, grant=oki,
                                                    row_idx=slot)
        with span("engine.write"):
            # same key as compute() by contract (see make_train_step)
            theta_L, bank = _masked_write(state, owner_idx, key, slot)(  # dpcheck: ignore[DPC105]
                new_L, new_i, theta_i, ok)
            del new_L, new_i, theta_i
            if tree is not None:
                tree.counts.scatter_add_(0, owner_idx, oki.reshape(1))
        led.spent.scatter_add_(0, owner_idx, oki.reshape(1))
        led.refused.scatter_add_(0, owner_idx, (1 - oki).reshape(1))
        metrics = dict(metrics, refused=~ok, owner=owner_idx.reshape(()).to(torch.int32))
        return AsyncDPState(theta_L, bank, state.step + oki, led, tree, state.faults,
                            state.stale), metrics

    def body_faulted(state: AsyncDPState, batch, owner_idx: torch.Tensor, key: torch.Tensor,
                     fcode: torch.Tensor):
        ss = state.stale
        slot, hit = _bank_slot(state.bank, owner_idx)
        led_auth = state.ledger.authorized(owner_idx)
        if hit is not None:
            # a page miss refuses like an exhausted budget
            led_auth = led_auth & hit.reshape(())
        # same key as compute() by contract (see make_train_step)
        theta_L, bank, metrics, apply = _faulted_round(
            cfg, compute, _masked_write(state, owner_idx, key, slot),  # dpcheck: ignore[DPC105]
            state, batch, owner_idx, key, fcode, led_auth,
            None if ss is None else ss.clock, true, slot)
        return AsyncDPState(theta_L, bank, state.step + apply.to(torch.int32), state.ledger,
                            state.tree, state.faults, ss), metrics

    def run(state: AsyncDPState, batches: Dict[str, torch.Tensor],
            owner_seq: torch.Tensor, keys: torch.Tensor, fault_codes=None):
        if state.ledger is None:
            raise ValueError("fused rounds need a device ledger on the state; "
                             "build it with Federation.init_state")
        _check_mesh(mesh, state)
        _require_tree(cfg, state)
        owners = owner_seq.to(torch.int64)
        if state.faults is None:
            _no_faults_armed(fault_codes)
        else:
            _require_fault_policy(cfg, state)
            _require_staleness(cfg, state)
            if fault_codes is None:
                fault_codes = torch.zeros(owners.shape, dtype=torch.int8, device=owners.device)
            fault_codes = fault_codes.to(device=owners.device, dtype=torch.int8)
        with _replicating(state):
            return loop(state, batches, owners, keys, fault_codes)

    def loop(state: AsyncDPState, batches, owners, keys, fault_codes):
        per_round = []
        for k in range(owners.shape[0]):
            with span("engine.round"):
                args = (state, {name: v[k] for name, v in batches.items()}, owners[k:k + 1],
                        keys[k])
                if fault_codes is None:
                    state, m = body(*args)
                else:
                    state, m = body_faulted(*args, fault_codes[k])
            per_round.append(m)
        if not per_round:
            return state, {}
        return state, {name: torch.stack([m[name] for m in per_round])
                       for name in per_round[0]}

    return run


def make_group_rounds(loss_fn, cfg: AsyncDPConfig,
                      scales: Optional[torch.Tensor] = None, device=None, mesh=None):
    """Owner-parallel multi-round driver: conflict-free groups of rounds,
    each computed as one batch of its members.

    Returns run(state, batches, owner_seq, keys, group_idx, group_valid,
    fault_codes=None) -> (state, metrics): batches, owner_seq, keys and
    fault_codes are `make_fused_rounds`' (K,)-leading inputs, and
    (group_idx, group_valid) the host (n_groups, G_max) arrays of
    `schedules.pack_groups`: row g lists the round indices of group g, a
    consecutive run of rounds with distinct owners, then padding. Each
    group runs at its own length (no padding executes; torch has no
    compile cache to keep shapes stable for), from views of the (K,)
    inputs, so nothing is copied to or from the host. Metrics come back
    group after group, each (K,); the groups are consecutive and in order,
    so that is round order.

    Semantics against the sequential driver, for groups of distinct owners
    (the reference's `make_group_rounds`):

      * The ledger spend is EXACTLY sequential: authorization depends only
        on the owner's prior grants, and an owner appears at most once per
        group. `spent`, `refused` and the tree's leaf counts land by a
        disjoint scatter. The tree nodes do not depend on theta, so they
        equal the sequential driver's bit for bit.
      * Bank rows are disjoint: each granted member writes its eq. (5) copy,
        computed from the group-entry theta_L; a refused member writes its
        own row back. A quantized bank encodes the members in round order
        against the carried error-feedback residual, advancing it only on
        a grant, as the sequential driver does.
      * theta_L takes ONE inertia reduction per group: the mean of the
        granted members' eq. (7) targets (kept when none was granted). For
        one granted member that is its sequential update; for more, every
        member reads the group-entry theta_L: a bounded deviation of the
        kind of the paper's own asynchrony (stale reads), not a change to
        the noise or the accounting.

    On a fault-armed state each member goes through the fused driver's
    outcome algebra, vectorized over the group: the quarantine flags,
    cooldowns, checksums and windows are group-entry reads (exact, the
    owners being distinct), member m's round clock is `clock + m`, the
    guards run per member, a quantized member writes with its `apply`
    (so a poisoned member never advances the residual), and theta_L
    averages the applied members' targets.

    On a PagedBank the members look their owners up in the page table at
    once; a member that misses is refused (its grant is 0) and its row
    write is a no-op, which the per-member writes keep bit-exact also when
    its clamped slot is a resident member's (each write reads the row as
    it stands). A bf16 bank gathers its rows with the exact upcast and
    writes them back narrowed, as the sequential driver does. On a mesh
    the members' rows are written one member at a time by the ranks that
    hold them; `mesh` as in make_train_step."""
    compute = _round_compute(loss_fn, cfg, scales, device)

    def reduce_theta(ok: torch.Tensor, stacked: torch.Tensor, base: torch.Tensor):
        n_ok = torch.sum(ok, dtype=torch.float32)
        s = torch.sum(torch.where(_member_mask(ok, stacked), stacked, 0.0), dim=0)
        s = s / torch.clamp(n_ok, min=1.0)
        return torch.where(n_ok > 0, s.to(base.dtype), base)

    def write_members(state: AsyncDPState, new_L, new_i, theta_i, owners, keys_g, ok,
                      slots=None):
        """Write the members' rows (those with `ok`; the others write their
        own row back) and reduce theta_L over the `ok` members. `slots` (a
        PagedBank's hot slots) are where the rows go: there a member that
        missed can share its clamped slot with a resident member, so the
        rows are written one member at a time, a masked one writing back
        the row as it stands."""
        hot = _hot(state.bank)
        widx = owners if slots is None else slots
        lay = _layout_of(state.theta_L)
        if isinstance(hot, QuantBank):
            # the error-feedback chain in round order; same key as the
            # round's by contract (the codec folds in its CODEC_SALT)
            for m in range(owners.numel()):
                _quant_write(hot, new_i[m], widx[m:m + 1], keys_g[m],
                             ok=ok[m], lay=lay)
        elif lay is not None or slots is not None:
            # one member at a time (a missed owner's clamped slot, or a row
            # another rank holds, is written back as it stands)
            _write_rows_(hot, widx, new_i, lay, ok)
        else:
            _write_bank_rows(hot, tree_map(
                lambda a, b: torch.where(_member_mask(ok, a), a, b), new_i, theta_i), owners)
        if isinstance(state.theta_L, ParamFlat):
            return (state.theta_L.replace_buf(reduce_theta(ok, new_L, state.theta_L.buf)),
                    state.bank)
        return tree_map(lambda a, b: reduce_theta(ok, a, b), new_L, state.theta_L), state.bank

    def body(state: AsyncDPState, batch_g, owners: torch.Tensor, keys_g: torch.Tensor):
        led, tree = state.ledger, state.tree
        slots, hit = _bank_slot(state.bank, owners)
        ok = led.spent.index_select(0, owners) < led.cap.index_select(0, owners)     # (g,)
        if hit is not None:
            ok = ok & hit
        oki = ok.to(torch.int32)
        new_L, new_i, theta_i, metrics, _ = compute.rows(state.theta_L, state.bank, batch_g,
                                                         owners, keys_g, tree=tree, grant=oki,
                                                         row_idx=slots)
        with span("engine.write"):
            # the round keys again by contract: a quantized bank's codec folds
            # in its CODEC_SALT (see make_train_step)
            theta_L, bank = write_members(  # dpcheck: ignore[DPC105]
                state, new_L, new_i, theta_i, owners, keys_g, ok, slots)
            del new_i, theta_i
            if tree is not None:
                tree.counts.index_add_(0, owners, oki)
        led.spent.index_add_(0, owners, oki)
        led.refused.index_add_(0, owners, 1 - oki)
        metrics = dict(metrics, refused=~ok, owner=owners.to(torch.int32))
        return AsyncDPState(theta_L, bank, state.step + torch.sum(oki, dtype=torch.int32),
                            led, tree, state.faults, state.stale), metrics

    def body_faulted(state: AsyncDPState, batch_g, owners: torch.Tensor,
                     keys_g: torch.Tensor, fcodes: torch.Tensor):
        led, ss = state.ledger, state.stale
        g = owners.numel()
        # member m is the group's m-th round: its clock is clock + m
        t_g = (None if ss is None
               else ss.clock + torch.arange(g, dtype=torch.int32, device=owners.device))

        slots, hit = _bank_slot(state.bank, owners)
        led_auth = led.spent.index_select(0, owners) < led.cap.index_select(0, owners)
        if hit is not None:
            led_auth = led_auth & hit

        def write(new_L, new_i, theta_i, ok):
            return write_members(state, new_L, new_i, theta_i, owners, keys_g, ok, slots)

        theta_L, bank, metrics, apply = _faulted_round(
            cfg, compute.rows, write, state, batch_g, owners, keys_g, fcodes, led_auth, t_g,
            torch.ones(g, dtype=torch.bool, device=owners.device), slots)
        return AsyncDPState(theta_L, bank, state.step + torch.sum(apply, dtype=torch.int32),
                            led, state.tree, state.faults, ss), metrics

    def run(state: AsyncDPState, batches: Dict[str, torch.Tensor], owner_seq: torch.Tensor,
            keys: torch.Tensor, group_idx, group_valid, fault_codes=None):
        if state.ledger is None:
            raise ValueError("grouped rounds need a device ledger on the state; "
                             "build it with Federation.init_state")
        _check_mesh(mesh, state)
        _require_tree(cfg, state)
        owners = owner_seq.to(torch.int64)
        if state.faults is None:
            _no_faults_armed(fault_codes)
        else:
            _require_fault_policy(cfg, state)
            _require_staleness(cfg, state)
            if fault_codes is None:
                fault_codes = torch.zeros(owners.shape, dtype=torch.int8, device=owners.device)
            fault_codes = fault_codes.to(device=owners.device, dtype=torch.int8)
        with _replicating(state):
            return loop(state, batches, owners, keys, group_idx, group_valid, fault_codes)

    def loop(state: AsyncDPState, batches, owners, keys, group_idx, group_valid, fault_codes):
        idx, valid = np.asarray(group_idx), np.asarray(group_valid, bool)
        per_group = []
        for row, ok in zip(idx, valid):
            n, start = int(ok.sum()), int(row[0])
            if not (n and ok[:n].all() and np.array_equal(row[:n], np.arange(start, start + n))):
                raise ValueError("each group must be a consecutive run of rounds followed "
                                 "by padding, as schedules.pack_groups builds it")
            sl = slice(start, start + n)
            with span("engine.group", members=n):
                args = (state, {k: v[sl] for k, v in batches.items()}, owners[sl], keys[sl])
                if fault_codes is None:
                    state, m = body(*args)
                else:
                    state, m = body_faulted(*args, fault_codes[sl])
            per_group.append(m)
        if not per_group:
            return state, {}
        return state, {name: torch.cat([m[name] for m in per_group])
                       for name in per_group[0]}

    return run


def make_sync_dp_step(loss_fn, cfg: AsyncDPConfig, lr: float,
                      scales: Optional[torch.Tensor] = None, device=None):
    """Synchronous DP-SGD baseline (the paper's related-work comparator,
    [12]/[14]-style): every owner contributes a privatized gradient each
    round; the learner averages them.

    Returns step(params, batches, key, weights=None) -> params: `batches`
    leaves carry a leading (N,) owner axis, `key` is the round's (2,) key
    (owner i privatizes with row i of split(key, N)), and `weights` (N,)
    rescales each owner's contribution (the session passes 0/1 liveness
    there, so budget-exhausted owners drop out of the round). The owners'
    `private_grad`s, weighted by w_i n_i / n, are accumulated in owner
    order in f32, as the reference's scan does; then come the sigma * theta
    regularizer, the step and the theta_max clip. With
    `PrivatizerConfig(fused_kernel=True)` each owner's clip norms run
    through the `sqnorm` kernel and its noise through one `scale_noise`
    pass per leaf."""
    if cfg.tree_depth is not None:
        raise ValueError(
            "the synchronous baseline draws independent per-round noise; "
            "the tree mechanism (cfg.tree_depth) has no sync counterpart")
    device = resolve_device(device)
    scales = (_noise_scales(cfg, device) if scales is None
              else scales.to(device=device, dtype=torch.float32))
    n_i = torch.tensor(list(cfg.owner_sizes), dtype=torch.float32, device=device)
    n = torch.full_like(n_i, float(cfg.n_total))

    def step(params, batches: Dict[str, torch.Tensor], key: torch.Tensor,
             weights: Optional[torch.Tensor] = None):
        keys = random.split(key, cfg.n_owners)
        w_all = n_i / n if weights is None else weights * n_i / n          # (N,)
        acc = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=torch.float32,
                                                device=leaf.device), params)
        for i in range(cfg.n_owners):
            q, _ = private_grad(loss_fn, params, {k: v[i] for k, v in batches.items()},
                                keys[i], cfg=cfg.privatizer, noise_scale=scales[i])
            w_i = w_all[i]
            acc = tree_map(lambda a, g: a + w_i * g.to(torch.float32), acc, q)
        new = tree_map(
            lambda p, g: (p - lr * (g + cfg.sigma * p.to(torch.float32)).to(p.dtype)
                          ).to(p.dtype), params, acc)
        return tree_map(lambda leaf: torch.clamp(leaf, -cfg.theta_max, cfg.theta_max), new)

    return step
