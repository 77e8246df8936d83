"""FederationConfig: the session-level hyperparameters of Algorithm 1
(an own copy of repro/federation/config.py).

Owner-local quantities (n_i, eps_i, Xi_i) live on DataOwner; mechanism- and
schedule-specific knobs live on those objects. What remains here is exactly
the learner's contract: horizon T, step-size knob rho, strong-convexity
modulus sigma of the regularizer g, the projection radius Theta, and the
recorded-deviation lr_scale for deep models.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def paper_rates(n_owners: int, horizon: int, rho: float, sigma: float,
                lr_scale: float = 1.0) -> Tuple[float, float]:
    """The paper's per-round rates (eqs. 5 and 7): (lr_own, lr_L).

    Single home for the formula — the convex and deep engines and
    `FederationConfig.effective_lr`/`from_target_lr` all read it from here
    so they cannot silently diverge."""
    lr_own = lr_scale * n_owners * rho / (horizon ** 2 * sigma)
    lr_L = (lr_scale * (n_owners - 1) * rho
            / (n_owners * horizon ** 2 * sigma))
    return lr_own, lr_L


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    horizon: int                 # T
    rho: float = 1.0             # step-size knob; alpha = rho / T^2
    sigma: float = 1e-4          # strong-convexity modulus of g
    theta_max: float = 100.0     # Theta projection radius (l_inf), deep path
    lr_scale: float = 1.0        # 1.0 == paper-faithful
    noiseless: bool = False      # eps -> inf (for cost-of-privacy deltas)

    @classmethod
    def from_target_lr(cls, target_lr: float, *, n_owners: int, horizon: int,
                       sigma: float, rho: float = 1.0, **kw
                       ) -> "FederationConfig":
        """Solve lr_scale so the effective owner-update rate
        lr_scale * N * rho / (T^2 * sigma) equals `target_lr`.

        The paper's exact rho/T^2 rate is ~0 for deep nets; pinning the
        effective rate instead is the recorded deviation the practical
        examples use (previously an inline conversion in async_dp_llm.py).
        """
        lr_scale = target_lr * horizon ** 2 * sigma / (n_owners * rho)
        return cls(horizon=horizon, rho=rho, sigma=sigma,
                   lr_scale=lr_scale, **kw)

    def effective_lr(self, n_owners: int) -> float:
        """The owner-update rate lr_own implied by this config."""
        return paper_rates(n_owners, self.horizon, self.rho, self.sigma,
                           self.lr_scale)[0]
