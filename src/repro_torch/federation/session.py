"""Federation: the one session surface over the convex and deep engines.

Counterpart of ``repro/federation/session.py``:

    fed = Federation(owners, FederationConfig(horizon=1000, sigma=2e-5))

    # convex (a LinearProblem; Algorithm 1 on the device; Figs. 2/6/8)
    trace = fed.run(key, prob)                  # one ledgered session
    traces = fed.run(key, prob, n_runs=100)     # replicas for percentiles

    # the synchronous baseline: every owner answers every round
    fed = Federation(owners, config, strategy="sync")
    trace = fed.run_sync(key, prob, lr=0.4)     # convex
    fed.make_step(loss_fn, lr=1e-3)             # deep
    params = fed.sync_round(params, batches, key)

    # deep models, asynchronous
    fed.make_step(loss_fn, privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2))
    state = fed.init_state(params)         # a pytree state (the default)
    state, metrics = fed.step(state, batch, owner_idx, key)      # one round
    state, metrics = fed.run_rounds(state, batches, owner_seq, key)  # K rounds
    state, metrics = fed.run_rounds(state, batches, owner_seq, key,
                                    owner_parallel=True)  # conflict-free groups
    fed.reconcile(state)                   # fold the device ledger -> host
    fed.ledger()                           # per-owner spend + refusals

    # the flat engine: the model packed into one (P,) buffer, the bank one
    # (N, P) matrix, and with fused_kernel=True one dp_round pass per round
    fed.make_step(loss_fn, pack_params=True,
                  privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2,
                                              fused_kernel=True),
                  bank_dtype=None)      # or torch.bfloat16, torch.float16, "int8", "fp8"

    # the flat engine on a device mesh (launch.mesh): each rank keeps its
    # block of the state, a 1x1 mesh equals the unmeshed engine bit for bit
    fed.make_step(loss_fn, pack_params=True, mesh=make_host_mesh(model=1))

    # DP-FTRL tree noise: every owner keeps a depth-4 noise tree on the
    # device, capped at its capacity 2^4 - 1 = 15 responses
    fed = Federation(owners, config, mechanism="tree", tree_depth=4)

    # faults and the asynchronous runtime, on every driver and state
    fed = Federation(owners, config, fault_policy=FaultPolicy(max_faults=3),
                     staleness=StalenessPolicy(deadline=1.0, max_retries=2,
                                               decay=0.9))
    state, metrics = fed.run_rounds(state, batches, owner_seq, key,
                                    faults=FaultPlan(drop=0.05, corrupt=0.05),
                                    latency=LatencyPlan(base=0.5, jitter=0.3))
    state, metrics = fed.step(state, batch, owner_idx, key, fault_code=DROP)

    # a paged owner bank: n_hot rows on the device over a host cold tier;
    # step() and run_rounds() prefetch each dispatch's owners
    state = fed.init_paged_state(params, n_hot=16)
    ring = AvailabilityTraceSchedule(windows, trace=trace).trace_ring(chunk=4096)
    state, metrics = fed.run_rounds(state, batches, ring, key)

    # crash-resume: the device state and the host journal together (on a
    # mesh every rank calls both; the files hold the global arrays)
    fed.save_session(directory, state)
    state = fed.restore_session(directory, fed.init_state(params))

As in the reference, `make_step` defaults to the pytree path
(`pack_params=False`) and to the jnp-equivalent privatizer
(`PrivatizerConfig(xi=xi)`, fused_kernel=False); the round functions serve
both state kinds, and `init_state` builds the kind make_step chose.

The session runs on CUDA: with no `device` it takes "cuda" and raises
where there is none (it never carries on on the CPU); tests pass
``device="cpu"``. On CUDA it turns TF32 off for matmuls and cuDNN, so f32
products are full f32 like the reference's einsums.

The mechanism (noise calibration + PrivacyAccountant) is pluggable;
budget-exhausted owners are refused at this layer by `step`, and on the
device by `run_rounds`, whose refusals `reconcile` folds back bit-exactly,
with the fault and staleness outcomes (dropped, faulted, quarantined,
timed_out, retried).
A state passed to `step` or `run_rounds` is consumed (its bank rows,
device ledger and noise trees are updated in place).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import random
from repro_torch.checkpoint.store import from_storage
from repro_torch.device import resolve_device
from repro_torch.federation.config import FederationConfig
from repro_torch.federation.convex import (Algo1Trace, SyncTrace, scan_engine, stack_gram,
                                           sync_scan_engine)
from repro_torch.federation.deep import (AsyncDPConfig, AsyncDPState, _layout_of,
                                         device_free_bytes, example_group_cap, init_state,
                                         init_state_flat, make_fused_rounds,
                                         make_group_rounds, make_sync_dp_step,
                                         make_train_step)
from repro_torch.federation.dp_sgd import PrivatizerConfig
from repro_torch.federation.faults import (DROP, OK, FaultPlan, FaultPolicy, as_fault_codes,
                                           fault_tick)
from repro_torch.federation.flatten import ParamFlat, as_bank_codec
from repro_torch.federation.linear import LinearProblem
from repro_torch.federation.mechanisms import make_mechanism
from repro_torch.federation.owners import DataOwner
from repro_torch.federation.schedules import (TraceRing, UniformSchedule, as_owner_seq,
                                              auto_max_group, pack_groups,
                                              partition_conflict_free)
from repro_torch.federation.staleness import (LatencyPlan, StalenessPolicy, as_tick_times,
                                              merge_timeout_codes, staleness_tick)
from repro_torch.telemetry import span

_STRATEGIES = ("async", "sync")


class Federation:
    def __init__(self, owners: Sequence[DataOwner], config: FederationConfig, *,
                 mechanism="paper", schedule=None, strategy: str = "async",
                 cap_slack: Optional[float] = None, tree_depth: Optional[int] = None,
                 fault_policy: Optional[FaultPolicy] = None,
                 staleness: Optional[StalenessPolicy] = None, device=None):
        if strategy not in _STRATEGIES:
            raise ValueError(f"strategy must be one of {_STRATEGIES}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full f32 products, as the reference's einsums
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.owners = list(owners)
        self.config = config
        self.schedule = schedule if schedule is not None else UniformSchedule()
        self.strategy = strategy
        # fault_policy arms the fault layer (deep path): states carry
        # FaultState counters, the drivers take fault codes, and owners past
        # the policy's fault budget are quarantined. staleness arms the
        # runtime (deadlines -> TIMEOUT, retry backoff, decayed inertia); it
        # rides on the fault algebra, so a staleness-only federation arms a
        # never-quarantine fault policy, which changes nothing until codes
        # are injected
        self.fault_policy = fault_policy
        self.staleness = staleness
        if staleness is not None and fault_policy is None:
            self.fault_policy = FaultPolicy(max_faults=2**30, window=2**30)
        self.mechanism = make_mechanism(mechanism, self.owners, config,
                                        cap_slack=cap_slack, tree_depth=tree_depth)
        self._step_fn = None
        self._fused_fn = None
        self._group_fn = None
        self._pack_params = False
        self._bank_dtype = None
        self._mesh = None
        self._pager = None
        self._ran = False

    def _claim_session(self):
        # the engines start from fresh per-owner counters, so a second
        # ledgered run would emit responses the cumulative ledger refuses:
        # budget spend and accounting would drift apart
        if self._ran:
            raise RuntimeError(
                "this Federation already ran its ledgered session; use n_runs for "
                "statistical replicas or build a new Federation to renegotiate budgets")
        self._ran = True

    @property
    def n_owners(self) -> int:
        return len(self.owners)

    def ledger(self) -> Dict[int, Dict]:
        return self.mechanism.ledger()

    def _reject_tree(self, engine: str):
        # the convex and sync engines draw independent per-round noise and
        # carry no noise tree: under the tree mechanism they would emit the
        # wrong mechanism
        if getattr(self.mechanism, "tree_depth", None) is not None:
            raise ValueError(f"{engine} draws independent per-round noise; the tree "
                             "mechanism needs the deep path (make_step/run_rounds)")

    # ------------------------------ convex --------------------------------
    def _gram(self):
        if any(o.gram is None for o in self.owners):
            raise ValueError("convex path needs Gram payloads on every owner "
                             "(DataOwner.from_arrays/from_gram)")
        return tuple(t.to(self.device) for t in stack_gram([o.gram for o in self.owners]))

    def _run_keys(self, key: torch.Tensor, n_runs: Optional[int]) -> torch.Tensor:
        """The engines' key on the session's device: the key itself for one
        run, split(key, n_runs) for replicas."""
        key = key.to(self.device)
        return key if n_runs is None else random.split(key, n_runs)

    def run(self, key: torch.Tensor, problem: LinearProblem,
            n_runs: Optional[int] = None) -> Algo1Trace:
        """Run the asynchronous session on a LinearProblem, on the session's
        device.

        n_runs=None runs ONE ledgered session: every response and refusal
        lands in .ledger(), from one read of the owner counts after the
        run. n_runs=k runs k statistical replicas on keys split(key, k),
        with a leading (k,) axis on every field of the trace; replicas model
        hypothetical re-runs, so they are NOT ledgered."""
        if self.strategy != "async":
            raise ValueError("run() is the async path; use run_sync()")
        self._reject_tree("the convex scan engine")
        A, b, n_i = self._gram()
        problem = problem.to(self.device)
        scales = self.mechanism.scales(p=problem.G.shape[0], device=self.device)
        cfg = self.config
        if n_runs is None:
            self._claim_session()
        trace = scan_engine(self._run_keys(key, n_runs), problem, A, b, n_i, scales,
                            horizon=cfg.horizon, rho=cfg.rho, sigma=cfg.sigma,
                            lr_scale=cfg.lr_scale, draw=self.schedule.draw,
                            cap=self.mechanism.cap)
        if n_runs is None:
            counts = np.bincount(trace.owners_seq.cpu().numpy(), minlength=self.n_owners)
            for i, c in enumerate(counts):
                self.mechanism.authorize_many(i, int(c))
        return trace

    def run_sync(self, key: torch.Tensor, problem: LinearProblem, lr: float,
                 n_runs: Optional[int] = None) -> SyncTrace:
        """The synchronous all-owners-per-round baseline on the same surface
        (strategy='sync' federations only). A ledgered run charges every
        owner T responses; n_runs as in run()."""
        if self.strategy != "sync":
            raise ValueError("run_sync() needs strategy='sync'")
        self._reject_tree("the synchronous scan engine")
        if self.mechanism.cap is not None:
            raise ValueError(
                "per_owner_rounds is an asynchronous composition: the sync engine "
                "queries every owner all T rounds, so a capped noise scale would "
                "violate the owners' budgets; use 'paper' or 'strict'")
        A, b, n_i = self._gram()
        problem = problem.to(self.device)
        scales = self.mechanism.scales(p=problem.G.shape[0], device=self.device)
        cfg = self.config
        if n_runs is None:
            self._claim_session()
        trace = sync_scan_engine(self._run_keys(key, n_runs), problem, A, b, n_i, scales,
                                 horizon=cfg.horizon, lr=lr)
        if n_runs is None:
            for i in range(self.n_owners):
                self.mechanism.authorize_many(i, cfg.horizon)
        return trace

    # ------------------------------- deep ---------------------------------

    def as_async_config(self, privatizer: Optional[PrivatizerConfig] = None
                        ) -> AsyncDPConfig:
        """The low-level engine config this session implies."""
        xi = max(o.xi for o in self.owners)
        cfg = self.config
        cap = self.mechanism.cap
        return AsyncDPConfig(
            n_owners=self.n_owners, horizon=cfg.horizon, rho=cfg.rho, sigma=cfg.sigma,
            epsilons=tuple(o.epsilon for o in self.owners),
            owner_sizes=tuple(o.n for o in self.owners), xi=xi,
            theta_max=cfg.theta_max,
            privatizer=privatizer or PrivatizerConfig(xi=xi),
            lr_scale=cfg.lr_scale,
            caps=None if cap is None else (cap,) * self.n_owners,
            tree_depth=getattr(self.mechanism, "tree_depth", None),
            fault_policy=self.fault_policy, staleness=self.staleness)

    def make_step(self, loss_fn, *, privatizer: Optional[PrivatizerConfig] = None,
                  lr: Optional[float] = None, n_params: Optional[int] = None,
                  pack_params: bool = False, bank_dtype=None, mesh=None):
        """Build (and keep for .step()/.run_rounds()/.sync_round()) the round
        functions.

        async: step(state, batch, owner_idx, key) -> (state, metrics)
        sync:  step(params, batches, key[, weights]) -> params (needs lr)
        `n_params` feeds dimension-aware mechanisms ('strict').

        loss_fn(params, batch) -> scalar tensor, params the model tree. The
        built functions serve BOTH state representations (they dispatch on
        the state), so `pack_params` only selects what `init_state` builds:
        False (the default, the reference's) a pytree state, True the flat
        engine's packed (P,) buffer and (N, P) bank. `privatizer` None is
        PrivatizerConfig(xi=max owner xi), the jnp-equivalent mechanism;
        the sensitivity is the privatizer's ENFORCED clip norm.

        `bank_dtype` (flat states only) is the owner bank's storage that
        `init_state` builds: None (f32), torch.bfloat16 or torch.float16 (or
        the names "float32", "bfloat16", "float16"), or "int8"/"fp8" (or a
        flatten.BankCodec) for the error-feedback quantized bank, about 4x
        below f32.

        `mesh` (flat engine only: a named ("data", "model") DeviceMesh from
        `launch.mesh`, e.g. `make_host_mesh()`) makes `init_state` and
        `init_paged_state` lay the state out on it under
        `sharding.rules.flat_shardings` (each rank keeps its block: owner
        rows over the data axes, P over 'model'), and the drivers check
        that their flat states are laid out on it. Every rank of the mesh
        runs the same session calls. A 1x1 mesh equals the unmeshed engine
        bit for bit."""
        as_bank_codec(bank_dtype)                       # validate early
        if mesh is not None and not pack_params:
            raise ValueError("mesh sharding is a flat-engine option; pass pack_params=True")
        self._pack_params = pack_params
        self._bank_dtype = bank_dtype
        self._mesh = mesh
        acfg = self.as_async_config(privatizer)
        self._privatizer = acfg.privatizer
        scales = self.mechanism.scales(p=n_params, clip_norm=acfg.privatizer.xi,
                                       device=self.device)
        if self.strategy == "sync":
            if lr is None:
                raise ValueError("sync strategy needs an explicit lr")
            self._step_fn = make_sync_dp_step(loss_fn, acfg, lr, scales=scales,
                                              device=self.device)
            return self._step_fn
        self._step_fn = make_train_step(loss_fn, acfg, scales=scales, device=self.device,
                                        mesh=mesh)
        self._fused_fn = make_fused_rounds(loss_fn, acfg, scales=scales,
                                           device=self.device, mesh=mesh)
        self._group_fn = make_group_rounds(loss_fn, acfg, scales=scales,
                                           device=self.device, mesh=mesh)
        return self._step_fn

    def _require_step(self):
        if self._step_fn is None:
            raise RuntimeError("call make_step(loss_fn) first")

    def init_state(self, params, pack_params: Optional[bool] = None,
                   bank_dtype=None, mesh=None) -> AsyncDPState:
        """The training state on the session's device, its device ledger
        seeded from the live accountant (in-graph authorization then
        refuses exactly where the host would) and, under the tree
        mechanism, all-zero noise trees. `pack_params` None follows
        make_step (default a pytree state); True builds the flat state.
        `bank_dtype` (flat states only; None follows make_step) is the
        bank's storage, as in make_step; given explicitly for a pytree
        state it raises, as in the reference. `mesh` (flat states only; None
        follows make_step) lays the state out on a device mesh, as in
        make_step; the ledger is replicated on every rank."""
        pack = self._pack_params if pack_params is None else pack_params
        acfg = self.as_async_config()
        if pack:
            if bank_dtype is None:
                bank_dtype = self._bank_dtype
            if mesh is None:
                mesh = self._mesh
            state = init_state_flat(params, acfg, device=self.device, bank_dtype=bank_dtype,
                                    mesh=mesh)
        else:
            # make_step's bank_dtype and mesh do not apply to a pytree
            # state; only an explicit request here is an error
            if bank_dtype is not None:
                raise ValueError("bank_dtype is a flat-engine option; "
                                 "pass pack_params=True")
            if mesh is not None:
                raise ValueError("mesh sharding is a flat-engine option; "
                                 "pass pack_params=True")
            state = init_state(params, acfg, device=self.device)
        return state._replace(ledger=self.mechanism.device_ledger(self.device))

    def init_paged_state(self, params, n_hot: int, bank_dtype=None, mesh=None,
                         cold_dir=None) -> AsyncDPState:
        """A flat-engine state whose owner bank is PAGED: n_hot rows on the
        device over a host cold tier, so device bytes are O(n_hot * P)
        whatever N is (see federation.paging). The pager is attached to
        this session: `step()` and `run_rounds()` prefetch the rows each
        dispatch touches, and every driver resolves owner -> hot slot on the
        device. With n_hot >= n_owners the paged engine equals the flat one
        bit for bit. Needs a flat make_step (pack_params=True). `cold_dir`
        puts the cold tier on disk (a memmap created at the first
        eviction); None keeps it in host memory. `mesh` (None follows
        make_step) lays the hot tier out like bank rows with n_hot for N
        (`sharding.rules.paged_shardings`)."""
        if not self._pack_params:
            raise ValueError("the paged bank is a flat-engine option; "
                             "call make_step(..., pack_params=True) first")
        if bank_dtype is None:
            bank_dtype = self._bank_dtype
        if mesh is None:
            mesh = self._mesh
        from repro_torch.federation.paging import init_paged_state
        state, self._pager = init_paged_state(params, self.as_async_config(), n_hot,
                                              bank_dtype=bank_dtype, device=self.device,
                                              mesh=mesh, cold_dir=cold_dir)
        return state._replace(ledger=self.mechanism.device_ledger(self.device))

    @property
    def pager(self):
        """The OwnerPager that init_paged_state attached (None for a session
        that does not page): resident_ids, stats, io, flush()."""
        return self._pager

    def params_of(self, state: AsyncDPState):
        """The central model as a tree, whichever representation the state
        carries (a flat buffer is unpacked into views)."""
        theta = state.theta_L
        return theta.unpack() if isinstance(theta, ParamFlat) else theta

    def _on_device(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def step(self, state: AsyncDPState, batch, owner_idx: int, key: torch.Tensor,
             fault_code: Optional[int] = None) -> Tuple[AsyncDPState, Dict[str, Any]]:
        """One ledgered round. A budget-exhausted owner is refused: the
        state comes back untouched and the refusal lands in the ledger.

        On a fault-armed state `fault_code` injects one of faults.OK, DROP,
        STALE, NONFINITE_GRAD, CORRUPT_PAYLOAD or TIMEOUT, and the host
        decides in the fused driver's order (it reads the owner's
        quarantine flag and cooldown back, one round at a time): a
        quarantined owner is masked first (no epsilon, no refusal, no
        window tick); under staleness an owner in backoff next (a retried
        round: never dispatched, no epsilon, no window contact); a DROP of
        an exhausted owner is a refusal (the budget check comes before the
        contact); a DROP costs no epsilon; every answered round is charged
        even when a guard then rejects it (metrics["faulted"]) or it came
        late (metrics["timed_out"]). Masked rounds still tick the fault
        window and the staleness clock as the fused driver's would."""
        if self.strategy != "async":
            raise ValueError("step() is the async path; use sync_round()")
        self._require_step()
        i = int(owner_idx)
        owner = torch.full((), i, dtype=torch.int32, device=self.device)
        if self._pager is not None:
            # the round's row is made resident first; a refused or masked
            # round leaves the extra residency behind, bit-exactly
            state = self._pager.prefetch(state, np.asarray([i]))
        if state.faults is None:
            if fault_code is not None:
                raise ValueError("fault injection needs a fault-armed state; build the "
                                 "Federation with fault_policy=FaultPolicy(...)")
            if not self.mechanism.authorize(i):
                return state, {"refused": True, "owner": i}
            new_state, metrics = self._step_fn(state, self._on_device(batch), owner,
                                               key.to(self.device))
            metrics = dict(metrics)
            metrics.update(refused=False, owner=i)
            return new_state, metrics

        fc = OK if fault_code is None else int(fault_code)
        flags = {"refused": False, "dropped": False, "faulted": False,
                 "quarantined": False, "timed_out": False, "owner": i}
        stale_armed = state.stale is not None and self.staleness is not None
        if stale_armed:
            flags["retried"] = False
        o = owner.reshape(1).to(torch.int64)

        def ticked(st, retry=False):
            # a masked round still advances the staleness clock, as the
            # fused driver's tick does
            if stale_armed:
                no = torch.zeros((), dtype=torch.bool, device=self.device)
                staleness_tick(st.stale, o, st.stale.clock, is_retry=no | retry, apply=no,
                               timed=no, policy=self.staleness, active=~no, ticks=1)
            return st

        def window(st, faulted):
            fault_tick(st.faults, o, faulted, self.fault_policy, active=True)
            return st

        if bool(state.faults.quarantined[i]):
            self.mechanism.record_quarantined(i)
            return ticked(state), dict(flags, quarantined=True)
        if stale_armed and int(state.stale.cooldown[i]) > 0:
            self.mechanism.record_retried(i)
            return ticked(state, retry=True), dict(flags, retried=True)
        if fc == DROP:
            if self.mechanism.exhausted(i):
                self.mechanism.authorize(i)           # records the refusal
                return ticked(window(state, False)), dict(flags, refused=True)
            self.mechanism.record_dropped(i)          # no answer, no epsilon
            return ticked(window(state, True)), dict(flags, dropped=True)
        if not self.mechanism.authorize(i):
            return ticked(window(state, False)), dict(flags, refused=True)
        new_state, metrics = self._step_fn(state, self._on_device(batch), owner,
                                           key.to(self.device), fc)
        metrics = dict(metrics)
        faulted, timed = bool(metrics["faulted"]), bool(metrics["timed_out"])
        if faulted:
            self.mechanism.record_faulted(i)          # epsilon already charged
        if timed:
            self.mechanism.record_timed_out(i)        # answered late: epsilon spent
        metrics.update(flags, faulted=faulted, timed_out=timed)
        return new_state, metrics

    def run_rounds(self, state: AsyncDPState, batches, owner_seq=None,
                   key: Optional[torch.Tensor] = None, *, faults=None, latency=None,
                   times=None, owner_parallel: bool = False,
                   max_group: Union[int, str, None] = "auto"
                   ) -> Tuple[AsyncDPState, Dict[str, torch.Tensor]]:
        """K rounds in one call with authorization on the device.

        `batches` leaves carry a leading (K,) round axis. `owner_seq` is a
        (K,) int sequence; None draws it from the schedule (on the device).
        Per-round keys are `random.split(key, K)`: a `step()` loop driven
        with the same split reproduces the sequential call bit for bit.
        Refusals stay on the device until `reconcile(state)`. Metrics are
        stacked (K,) device tensors in round order (refused mask, owner,
        clip_frac, max_grad_norm, grad_noise_scale; on a fault-armed state
        also dropped, faulted, quarantined, timed_out and, under staleness,
        retried).

        `owner_seq` may also be a `TraceRing` (a recorded trace streamed
        through a device chunk buffer): its host `window(K)` feeds the pager
        and the partition, then `next(K)` gives the device sequence.

        On a paged session (`init_paged_state`) the pager first makes every
        owner of the dispatch resident, evicting rows to the cold tier.

        `owner_parallel=True` runs the owner-parallel grouped driver
        (`deep.make_group_rounds`): the sequence is partitioned on the host
        into maximal runs of consecutive rounds with DISTINCT owners
        (`schedules.partition_conflict_free`), each run one batch with one
        theta_L inertia reduction. `max_group` caps the group length:
        "auto" (the default) picks the cap from the sequence's own repeats
        (`schedules.auto_max_group`) and, at example granularity on the
        card, no more members than the free device memory holds
        (`deep.example_group_cap`); None leaves groups unbounded, an int
        is a hard cap. The ledger spend equals the sequential driver's
        exactly; theta_L deviates boundedly for groups of more than one.
        When every group has length 1 the sequential driver runs: bit for
        bit the same. The dispatch then costs one copy of the owner
        sequence to the host (none when the caller passed it from the host
        or a TraceRing), shared by the pager, the cap and the partition;
        without owner_parallel or paging a drawn sequence never leaves the
        device.

        `faults` (fault-armed federations) injects per-round faults: a
        `FaultPlan` draws one int8 code per round from this call's key
        (its FAULT_SALT stream is disjoint from the round keys, so every
        driver sees the same faults), or a (K,) code trace replays. The
        outcomes land in the device ledger's dropped / faulted /
        quarantined columns and fold back on `reconcile(state)`.

        `latency` (staleness-armed federations) models response time: a
        `LatencyPlan` draws one latency per round from this call's key
        (the STALE_SALT stream), or a (K,) array replays. Rounds later than
        the policy's deadline become TIMEOUT (`merge_timeout_codes`):
        epsilon spent, update masked, ledgered in `timed_out`. `times`
        ((K,) arrival instants) tightens each round's deadline to the gap
        before the next; with latency armed, owner_seq=None and a schedule
        that has `draw_with_times`, the schedule's own times are used.

        As in the reference, a schedule-drawn sequence takes its key from
        split(key) first, and the fault codes, the latencies and the round
        keys all come from the remaining key."""
        with span("session.run_rounds"):
            if self.strategy != "async":
                raise ValueError("run_rounds() is the async path")
            self._require_step()
            if key is None:
                raise ValueError("run_rounds needs an explicit key")
            batches = self._on_device(batches)
            k_rounds = next(iter(batches.values())).shape[0]
            key = key.to(self.device)
            # the one host copy of the owner sequence a dispatch makes, shared by
            # the pager's prefetch, auto_max_group and the partition
            seq_host = None
            user_times = times is not None
            with span("session.owner_seq"):
                if isinstance(owner_seq, TraceRing):
                    seq_host = np.asarray(owner_seq.window(k_rounds), np.int32)
                    if seq_host.size and (seq_host.min() < 0
                                          or seq_host.max() >= self.n_owners):
                        raise ValueError(f"trace names owners outside this federation "
                                         f"(n_owners={self.n_owners})")
                    owner_seq = owner_seq.next(k_rounds).to(self.device)
                elif owner_seq is None:
                    k_sched, key = random.split(key)
                    draw_wt = getattr(self.schedule, "draw_with_times", None)
                    if latency is not None and times is None and draw_wt is not None:
                        # the schedule's own clock feeds the deadline model
                        sched = draw_wt(k_sched, self.n_owners, k_rounds)
                        owner_seq, times = sched.owners.to(torch.int32), sched.times
                    else:
                        owner_seq = self.schedule.draw(k_sched, self.n_owners, k_rounds)
                else:
                    if owner_parallel or self._pager is not None:
                        # the one host copy, validated and uploaded by as_owner_seq
                        seq_host = np.asarray(owner_seq.cpu()
                                              if isinstance(owner_seq, torch.Tensor)
                                              else owner_seq)
                        owner_seq = seq_host
                    owner_seq = as_owner_seq(owner_seq, self.n_owners, self.device)
                if seq_host is None and (owner_parallel or self._pager is not None):
                    seq_host = owner_seq.cpu().numpy()
            if any(v.shape[0] != owner_seq.shape[0] for v in batches.values()):
                raise ValueError(f"batches carry {k_rounds} rounds, the owner sequence "
                                 f"{owner_seq.shape[0]}")
            if user_times:
                times = as_tick_times(times, k_rounds, device=self.device)
            if self._pager is not None:
                # page in every row this dispatch touches before it launches
                state = self._pager.prefetch(state, seq_host)
            fault_codes = None
            if faults is not None:
                if state.faults is None:
                    raise ValueError("fault injection needs a fault-armed state; build the "
                                     "Federation with fault_policy=FaultPolicy(...)")
                fault_codes = (faults.draw(key, k_rounds) if isinstance(faults, FaultPlan)
                               else as_fault_codes(faults, k_rounds, device=self.device))
            if latency is not None:
                if self.staleness is None:
                    raise ValueError("latency modeling needs a staleness-armed Federation; "
                                     "pass staleness=StalenessPolicy(...) at construction")
                if state.faults is None:
                    raise ValueError("latency injection needs a fault-armed state (TIMEOUT "
                                     "is a fault code); rebuild the state from this "
                                     "staleness-armed federation")
                # the STALE_SALT stream of the same key as the fault codes
                lat = (latency.draw(key, owner_seq)  # dpcheck: ignore[DPC105]
                       if isinstance(latency, LatencyPlan)
                       else torch.as_tensor(latency, dtype=torch.float32).to(self.device))
                if fault_codes is None:
                    fault_codes = torch.full((k_rounds,), OK, dtype=torch.int8, device=self.device)
                fault_codes = merge_timeout_codes(fault_codes, lat, self.staleness.deadline,
                                                  times=times)
            # the same key as the fault draw by contract: it folds in FAULT_SALT
            keys = random.split(key, k_rounds)  # dpcheck: ignore[DPC105]
            codes = () if fault_codes is None else (fault_codes,)
            if not owner_parallel:
                return self._fused_fn(state, batches, owner_seq, keys, *codes)
            with span("schedules.partition"):
                if max_group == "auto":
                    max_group = auto_max_group(seq_host)
                    free = device_free_bytes(self.device)
                    if (self._privatizer.granularity == "example" and free is not None
                            and isinstance(state.theta_L, ParamFlat)):
                        # the g*B per-example gradient rows must fit the card
                        max_group = min(max_group, example_group_cap(
                            next(iter(batches.values())).shape[1], state.theta_L.size, free))
                groups = partition_conflict_free(seq_host, max_group)
                packed = (None if all(length <= 1 for _, length in groups)
                          else pack_groups(groups))
            if packed is None:
                # single-round groups: the sequential driver IS the grouped run
                return self._fused_fn(state, batches, owner_seq, keys, *codes)
            return self._group_fn(state, batches, owner_seq, keys, *packed, *codes)

    def reconcile(self, state: AsyncDPState) -> Dict[int, Dict]:
        """Fold the state's device ledger into the host accountant
        (bit-exact; drift raises) and return the updated ledger()."""
        if state.ledger is None:
            raise ValueError("state carries no device ledger")
        return self.mechanism.reconcile(state.ledger)

    # ----------------------------- crash-resume ------------------------------
    def _paging_manifest(self) -> Dict[str, Any]:
        return {"stores": sorted(self._pager.stores),
                "dtypes": {n: str(s.dtype) for n, s in self._pager.stores.items()}}

    def save_session(self, directory, state: AsyncDPState, step: Optional[int] = None) -> int:
        """Checkpoint the device state AND the host accountant together.

        Atomically writes the whole AsyncDPState (params, bank, ledger, tree,
        fault and runtime counters) and the mechanism's journal, everything
        `reconcile` depends on, so a process killed at any time after this
        call resumes through `restore_session` with exactly the accounting
        it had. A PAGED state checkpoints both tiers: the resident rows are
        flushed, so the cold tier is authoritative, and its written rows
        ride in the same atomic shard as the hot state (never-written rows
        are the default row). Returns the step the checkpoint was filed
        under (state.step when not given).

        On a device mesh every rank calls it, and the mesh's lowest rank
        writes the GLOBAL arrays: each block reaches it a few rows at a time
        (`sharding.flat.stream_leaves`; a paged state's cold rows likewise,
        each rank's store holding its columns), so no rank builds a global
        array on the device or the host. The ranks meet before returning.
        The files are the unmeshed twin's, so the checkpoint loads unmeshed,
        on another mesh and into the reference."""
        from repro_torch.checkpoint.store import (Streamed, flatten_with_paths, save_leaves,
                                                  stream_rows)
        from repro_torch.sharding.flat import stream_leaves
        lay = _layout_of(state.theta_L)
        if step is None:
            step = int(state.step)
        extra: Dict[str, Any] = {}
        aux: Dict[str, Any] = {}
        if self._pager is not None:
            # after the flush the cold tier holds the exact bits of every
            # resident row
            self._pager.flush(state, only_dirty=False)
            for name, store in self._pager.stores.items():
                ids = store.written_ids
                dtype = from_storage(np.empty(0, store.storage_dtype), store.dtype).dtype

                def read(a, b, store=store, ids=ids):
                    return from_storage(store.read_rows(ids[a:b]), store.dtype)
                aux[f"cold/{name}/ids"] = ids
                if lay is None:
                    aux[f"cold/{name}/rows"] = stream_rows(read, ids.size, store.row_shape,
                                                           dtype)
                    continue
                cols = name != "scales"
                shape = (ids.size,) + store.row_shape[:-1] + (lay.p,) if cols else \
                    (ids.size,) + store.row_shape
                aux[f"cold/{name}/rows"] = Streamed(shape, dtype, lay.stream(
                    read, ids.size, store.row_shape, dtype, False, cols,
                    state.theta_L.buf.device))
            extra["paging"] = dict(self._paging_manifest(), n_hot=self._pager.n_hot)
        exp = getattr(self.mechanism, "export_journal", None)
        if exp is not None:
            extra["journal"] = exp()
        leaves = flatten_with_paths(state) if lay is None else stream_leaves(state)
        if lay is None or lay.writer:
            save_leaves(directory, step, leaves, extra or None, aux or None)
        else:
            # this rank's pieces go to the writer, in the order it writes
            for v in list(leaves.values()) + list(aux.values()):
                if isinstance(v, Streamed):
                    for _ in v.pieces:
                        pass
        if lay is not None:
            lay.barrier()
        return int(step)

    def restore_session(self, directory, like: AsyncDPState,
                        step: Optional[int] = None) -> AsyncDPState:
        """Restore a save_session checkpoint into THIS federation.

        `like` is a template state (e.g. a fresh `init_state(params)`) that
        gives the structure, dtypes, device and static fields. The
        mechanism's journal is replayed first, rewinding the host
        accountant to the saved baselines, and the restored ledger adopts
        the journaled snapshot generation, so `reconcile` after the resume
        folds exactly the deltas the crashed process had not folded, never
        charging epsilon twice. The federation must be built from the same
        owners and config as the one that saved. Restoring into a PAGED
        session (init_paged_state before this call, so `like` and the cold
        stores exist) wipes the stores, writes the checkpoint's cold rows
        and re-syncs the pager to the restored page table. A meshed `like`
        (every rank calls this) keeps its own block of each global array
        (`FlatLayout.to_local`) and its own columns of the cold rows, and
        reads only those from the file; cold rows go into the stores a few
        at a time."""
        from repro_torch.checkpoint.store import (aux_views, latest_step, load_checkpoint,
                                                  load_manifest, rows_per_piece)
        from repro_torch.sharding.flat import state_blocks
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {directory!r}")
        manifest = load_manifest(directory, step)
        paging = (manifest.get("extra") or {}).get("paging")
        if self._pager is None and paging is not None:
            raise ValueError("checkpoint holds a paged bank; call init_paged_state first so "
                             "this session has a pager and cold stores to restore into")
        if self._pager is not None and paging is None:
            raise ValueError("checkpoint carries no cold-tier snapshot (saved from a "
                             "non-paged session); restore it into a non-paged state instead")
        lay = _layout_of(like.theta_L)
        block = None
        if lay is not None:
            blocks = state_blocks(like)

            def block(key, full):
                return lay.to_local(full, *blocks[key]) if key in blocks else full
        state = load_checkpoint(directory, step, like, block=block)
        if self._pager is not None:
            mine = self._paging_manifest()
            theirs = {"stores": paging["stores"], "dtypes": paging.get("dtypes", mine["dtypes"])}
            if mine != theirs:
                raise ValueError(f"checkpoint cold tier has stores {theirs} but this session "
                                 f"pages {mine} — codec/tree configuration mismatch")
            views = aux_views(directory, step)
            for name, store in self._pager.stores.items():
                # wipe first: rows written after the save read as the default
                # row again, as they did at save time
                store.clear()
                ids = np.array(views[f"cold/{name}/ids"][0])
                rows, logical = views[f"cold/{name}/rows"]
                if lay is not None and name != "scales":
                    rows = lay.to_local(rows, False, True)
                k = rows_per_piece(store.row_shape,
                                   from_storage(np.empty(0, rows.dtype), logical).dtype)
                for a in range(0, ids.size, k):
                    store.write_rows(ids[a:a + k], np.array(rows[a:a + k]))
            self._pager.adopt(state)
        journal = (manifest.get("extra") or {}).get("journal")
        if journal is not None:
            rest = getattr(self.mechanism, "restore_journal", None)
            if rest is None:
                raise NotImplementedError(f"mechanism {self.mechanism.name!r} cannot replay "
                                          "the checkpoint's dispatch journal")
            rest(journal)
            if state.ledger is not None:
                # the snapshot id is static: it came from `like`; adopt the
                # journaled generation
                state = state._replace(ledger=state.ledger.replace(sid=int(journal["sid"])))
        return state

    def sync_round(self, params, batches, key: torch.Tensor):
        """One ledgered synchronous round: every live owner contributes and
        exhausted owners are zero-weighted out. A fully refused round is a
        no-op that returns `params` itself (the regularizer must not keep
        shrinking a model nobody is training). `batches` leaves carry a
        leading (N,) owner axis."""
        if self.strategy != "sync":
            raise ValueError("sync_round() needs strategy='sync'")
        self._require_step()
        live = [self.mechanism.authorize(i) for i in range(self.n_owners)]
        if not any(live):
            return params
        return self._step_fn(params, self._on_device(batches), key.to(self.device),
                             torch.tensor(live, dtype=torch.float32, device=self.device))
