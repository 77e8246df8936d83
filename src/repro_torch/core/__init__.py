"""The Theorem-2 forecasts of the port (numpy only). The reference's other
`repro.core` names are deprecated aliases of `repro.federation`; the port
has them in `repro_torch.federation` only."""
from repro_torch.core.cop import (bound_asymptotic, bound_theorem2, budget_sum,
                                  fit_constants, min_owners_for_benefit)

__all__ = ["bound_asymptotic", "bound_theorem2", "budget_sum", "fit_constants",
           "min_owners_for_benefit"]
