"""Quickstart on the PyTorch port: the federation API on synthetic lending
data (Fig. 2), the twin of examples/quickstart.py.

    PYTHONPATH=src python examples/quickstart_torch.py               # on CUDA
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Three banks, 10k records each, three privacy budgets. One `Federation`
session of 30 replicas per budget runs Algorithm 1 on the device; then the
Theorem-2 forecast, everything the paper's Section 5.1 does.
"""
import argparse

import numpy as np

from repro_torch import random
from repro_torch.core import bound_asymptotic, budget_sum, fit_constants
from repro_torch.data import owner_shards
from repro_torch.federation import (Federation, FederationConfig, federate_problem,
                                    with_budgets)


def main(device=None):
    N, n_i, T = 3, 10_000, 1000
    shards = owner_shards("lending", [n_i] * N, seed=0, heterogeneity=0.0)
    prob, owners = federate_problem(shards, 1.0, reg=1e-5, theta_max=2.0, device=device)
    print(f"{N} owners x {n_i} records on {prob.G.device}; Xi = "
          f"{max(o.xi for o in owners):.1f}; theta* within "
          f"[{float(prob.theta_star.min()):.2f}, {float(prob.theta_star.max()):.2f}]")

    cfg = FederationConfig(horizon=T, rho=1.0, sigma=2 * prob.reg)
    obs = {}
    for eps in (3.0, 7.0, 10.0):
        fed = Federation(with_budgets(owners, eps), cfg, device=device)
        tr = fed.run(random.PRNGKey(0, device=fed.device), prob, n_runs=30)
        psi = tr.psi.cpu().numpy()
        med = np.median(psi, axis=0)
        obs[eps] = float(np.mean(psi[:, -1]))
        print(f"eps={eps:5.1f}:  psi median k=10 {med[9]:8.4f}  "
              f"k=500 {med[499]:8.5f}  k=1000 {med[-1]:8.5f}  "
              f"(25-75%: {np.percentile(psi[:, -1], 25):.5f}"
              f"-{np.percentile(psi[:, -1], 75):.5f})")

    # Theorem-2 forecast (eq. 11): fit the two constants, predict
    ss = np.array([budget_sum([e] * N) for e in obs])
    c1, c2 = fit_constants(np.array([N * n_i] * len(obs)), ss, np.array(list(obs.values())))
    print(f"\nfitted eq.(11) constants: c1bar={c1:.3g}, c2bar={c2:.3g}")
    for eps in obs:
        b = bound_asymptotic(N * n_i, [eps] * N, c1, c2)
        print(f"  eps={eps:5.1f}: observed CoP {obs[eps]:.5f}  fitted bound {b:.5f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run without a card)")
    main(ap.parse_args().device)
