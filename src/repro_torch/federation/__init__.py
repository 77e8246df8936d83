"""The federation API of the port: DataOwners + FederationConfig + a
mechanism (paper, strict, per_owner_rounds, tree) + a schedule (uniform,
Poisson, availability trace) -> one Federation session over the convex
Algorithm-1 engine and the deep engine (pytree or flat states), with the
asynchronous and the synchronous strategy, and on the deep engine the fault
layer (FaultPlan, FaultPolicy) and the asynchronous runtime (LatencyPlan,
StalenessPolicy) on all three drivers, the paged owner bank (PagedBank,
OwnerPager, TraceRing) and crash-resume checkpoints (save_session,
restore_session) (counterpart of `repro.federation`)."""
from repro_torch.federation.clocks import (Schedule, owner_counts, poisson_schedule,
                                           uniform_schedule)
from repro_torch.federation.config import FederationConfig, paper_rates
from repro_torch.federation.convex import (Algo1Config, Algo1Trace, SyncTrace,
                                           run_algorithm1, run_many, scan_engine,
                                           stack_gram, sync_scan_engine)
from repro_torch.federation.deep import (AsyncDPConfig, AsyncDPState, TreeNoise, init_state,
                                         init_state_flat, init_tree_noise,
                                         make_fused_rounds, make_group_rounds,
                                         make_sync_dp_step, make_train_step)
from repro_torch.federation.dp_sgd import PrivatizerConfig, clip_tree, private_grad
from repro_torch.federation.faults import (CORRUPT_PAYLOAD, DROP, NONFINITE_GRAD, OK, STALE,
                                           TIMEOUT, FaultPlan, FaultPolicy, FaultState,
                                           as_fault_codes, bank_checksums, init_fault_state)
from repro_torch.federation.flatten import (BankCodec, FlatSpec, PagedBank, ParamFlat,
                                            QuantBank, as_bank_codec, flatten_spec,
                                            init_flat_bank, pack_params)
from repro_torch.federation.linear import (LinearProblem, Owner, fitness, make_problem,
                                           owner_grad, record_grad_bound, relative_fitness)
from repro_torch.federation.mechanisms import (CappedRoundsMechanism, LedgerDriftError,
                                               Mechanism, PaperMechanism, StrictMechanism,
                                               TreeMechanism, make_mechanism)
from repro_torch.federation.owners import DataOwner, federate_problem, with_budgets
from repro_torch.federation.paging import OwnerPager, init_paged_state
from repro_torch.federation.privacy import (DeviceLedger, PrivacyAccountant,
                                            capped_rounds, laplace_noise, laplace_noise_tree,
                                            laplace_scale_theorem1, make_device_ledger)
from repro_torch.federation.schedules import (AvailabilityTraceSchedule, PoissonSchedule,
                                              ScheduleProtocol, TraceRing, UniformSchedule,
                                              as_owner_seq, auto_max_group, pack_groups,
                                              partition_conflict_free)
from repro_torch.federation.session import Federation
from repro_torch.federation.staleness import (STALE_SALT, LatencyPlan, StalenessPolicy,
                                              StalenessState, as_tick_times, deadline_guard,
                                              init_staleness_state, merge_timeout_codes,
                                              staleness_tick, staleness_weight)

__all__ = [
    "CORRUPT_PAYLOAD", "DROP", "NONFINITE_GRAD", "OK", "STALE", "STALE_SALT", "TIMEOUT",
    "FaultPlan", "FaultPolicy", "FaultState", "LatencyPlan", "StalenessPolicy",
    "StalenessState", "as_fault_codes", "as_tick_times", "bank_checksums", "deadline_guard",
    "init_fault_state", "init_staleness_state", "merge_timeout_codes", "staleness_tick",
    "staleness_weight",
    "Algo1Config", "Algo1Trace", "AsyncDPConfig", "AsyncDPState", "AvailabilityTraceSchedule",
    "BankCodec", "CappedRoundsMechanism", "DataOwner", "DeviceLedger", "Federation",
    "FederationConfig", "FlatSpec", "LedgerDriftError", "LinearProblem", "Mechanism", "Owner",
    "OwnerPager", "PagedBank", "PaperMechanism", "ParamFlat", "PoissonSchedule",
    "PrivacyAccountant", "PrivatizerConfig", "QuantBank", "Schedule", "ScheduleProtocol",
    "StrictMechanism", "SyncTrace", "TraceRing", "TreeMechanism", "TreeNoise",
    "UniformSchedule", "as_bank_codec", "as_owner_seq", "auto_max_group", "capped_rounds",
    "clip_tree", "federate_problem", "fitness", "flatten_spec", "init_flat_bank",
    "init_paged_state", "init_state", "init_state_flat", "init_tree_noise",
    "laplace_noise", "laplace_noise_tree", "laplace_scale_theorem1", "make_device_ledger",
    "make_fused_rounds", "make_group_rounds", "make_mechanism", "make_problem",
    "make_sync_dp_step", "make_train_step", "owner_counts", "owner_grad", "pack_groups",
    "pack_params", "paper_rates", "partition_conflict_free", "poisson_schedule",
    "private_grad", "record_grad_bound", "relative_fitness", "run_algorithm1", "run_many",
    "scan_engine", "stack_gram", "sync_scan_engine", "uniform_schedule", "with_budgets",
]
