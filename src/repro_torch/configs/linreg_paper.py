"""The paper's own experimental models (Section 5). A copy of
``repro/configs/linreg_paper.py``.

Linear regression y = theta^T x with
  g(theta)  = 1e-5 * ||theta||^2          (strongly convex regulariser)
  loss      = ||y - theta^T x||^2
on ~10 PCA features. Two dataset stand-ins (synthetic generators matching
the published dimensions and statistics, `repro_torch.data.synthetic`):
  - 'lending': Lending Club interest-rate regression (Fig. 2-6)
  - 'health' : NY SPARCS length-of-stay regression  (Fig. 7-10)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    name: str = "linreg-paper"
    n_features: int = 10           # top-10 PCA features (Sec. 5.1.1)
    reg_coef: float = 1e-5         # g(theta) = reg_coef * theta^T theta
    theta_max: float = 10.0        # Theta = {||theta||_inf <= theta_max}
    horizon: int = 1000            # T
    rho: float = 1.0               # Algorithm 1 step-size knob (alpha = rho/T^2)
    dataset: str = "lending"       # 'lending' | 'health'

    @property
    def sigma(self) -> float:
        """Strong-convexity modulus of g (g = c*||theta||^2 -> sigma=2c)."""
        return 2.0 * self.reg_coef


LENDING = PaperConfig(dataset="lending")
HEALTH = PaperConfig(dataset="health")
CONFIG = LENDING
