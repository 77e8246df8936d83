"""The federation API of the port: DataOwners + FederationConfig + a
mechanism (paper, per_owner_rounds, tree) + the uniform schedule -> one
Federation session over the deep engine, on pytree or flat states
(counterpart of `repro.federation`)."""
from repro_torch.federation.config import FederationConfig, paper_rates
from repro_torch.federation.deep import (AsyncDPConfig, AsyncDPState, TreeNoise, init_state,
                                         init_state_flat, init_tree_noise,
                                         make_fused_rounds, make_train_step)
from repro_torch.federation.dp_sgd import PrivatizerConfig, clip_tree, private_grad
from repro_torch.federation.flatten import (BankCodec, FlatSpec, ParamFlat, QuantBank,
                                            as_bank_codec, flatten_spec, init_flat_bank,
                                            pack_params)
from repro_torch.federation.mechanisms import (CappedRoundsMechanism, LedgerDriftError,
                                               PaperMechanism, TreeMechanism,
                                               make_mechanism)
from repro_torch.federation.owners import DataOwner
from repro_torch.federation.privacy import (DeviceLedger, PrivacyAccountant,
                                            capped_rounds, laplace_noise, laplace_noise_tree,
                                            laplace_scale_theorem1, make_device_ledger)
from repro_torch.federation.schedules import UniformSchedule, as_owner_seq
from repro_torch.federation.session import Federation

__all__ = [
    "AsyncDPConfig", "AsyncDPState", "BankCodec", "CappedRoundsMechanism", "DataOwner",
    "DeviceLedger", "Federation", "FederationConfig", "FlatSpec", "LedgerDriftError",
    "PaperMechanism", "ParamFlat", "PrivacyAccountant", "PrivatizerConfig", "QuantBank",
    "TreeMechanism", "TreeNoise", "UniformSchedule", "as_bank_codec", "as_owner_seq",
    "capped_rounds", "clip_tree", "flatten_spec", "init_flat_bank", "init_state",
    "init_state_flat", "init_tree_noise", "laplace_noise", "laplace_noise_tree",
    "laplace_scale_theorem1", "make_device_ledger", "make_fused_rounds",
    "make_mechanism", "make_train_step", "pack_params", "paper_rates", "private_grad",
]
