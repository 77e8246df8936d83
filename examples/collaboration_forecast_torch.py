"""Value-of-collaboration forecasting on the PyTorch port (the paper's Fig.
6 + Section 6 data-market story), the twin of
examples/collaboration_forecast.py: given pilot measurements, fit the
Theorem-2 constants and PREDICT how many owners at which privacy budget
make collaboration beat training alone — without anyone revealing their
data. Every pilot measurement is one `Federation` session of Algorithm 1
on the device.

    PYTHONPATH=src python examples/collaboration_forecast_torch.py               # on CUDA
    PYTHONPATH=src python examples/collaboration_forecast_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import budget_sum, fit_constants, min_owners_for_benefit
from repro_torch.data import owner_shards
from repro_torch.federation import (Federation, FederationConfig, federate_problem,
                                    relative_fitness)

N_PILOT, N_I, T = 5, 10_000, 1000


def measure(N, eps, seed=3, runs=8, device=None):
    shards = owner_shards("lending", [N_I] * N, seed=seed)
    prob, owners = federate_problem(shards, eps, reg=1e-5, theta_max=2.0, device=device)
    fed = Federation(owners, FederationConfig(horizon=T, rho=1.0, sigma=2e-5), device=device)
    tr = fed.run(random.PRNGKey(0, device=fed.device), prob, n_runs=runs)
    return prob, shards, float(torch.mean(tr.psi[:, -1]))


def main(device=None):
    # 1) pilot: a small consortium measures CoP at a few budgets
    pilot = {}
    for eps in (2.0, 5.0, 10.0):
        _, _, cop = measure(N_PILOT, eps, device=device)
        pilot[eps] = cop
        print(f"pilot N={N_PILOT}, eps={eps:4.1f}: CoP = {cop:.4f}")
    ss = np.array([budget_sum([e] * N_PILOT) for e in pilot])
    c1, c2 = fit_constants(np.array([N_PILOT * N_I] * len(pilot)), ss,
                           np.array(list(pilot.values())))
    print(f"fitted constants: c1bar={c1:.3g} c2bar={c2:.3g}\n")

    # 2) the isolated baseline an owner would otherwise use
    prob, shards, _ = measure(N_PILOT, 10.0, device=device)
    X0, y0 = shards[0]
    th = np.linalg.solve(X0.T @ X0 / N_I + 1e-5 * np.eye(10),
                         X0.T @ y0 / N_I)
    theta = torch.tensor(np.clip(th, -2, 2), dtype=torch.float32, device=prob.G.device)
    psi_iso = float(relative_fitness(prob, theta))
    print(f"isolated owner-0 model: psi = {psi_iso:.4f}")

    # 3) forecast: how many owners needed at each budget?
    print("\nforecast (eq. 11): min owners for collaboration to win")
    for eps in (0.5, 1.0, 2.5, 5.0, 10.0):
        n_min = min_owners_for_benefit(psi_iso, N_I, eps, c1, c2)
        print(f"  eps={eps:5.1f}: N >= {n_min}")

    # 4) verify one forecast point empirically
    eps = 2.5
    n_min = min_owners_for_benefit(psi_iso, N_I, eps, c1, c2)
    if 0 < n_min <= 64:
        _, _, cop = measure(n_min, eps, device=device)
        print(f"\nverify: N={n_min}, eps={eps} -> measured CoP {cop:.4f} "
              f"vs isolated {psi_iso:.4f} "
              f"({'WINS' if cop < psi_iso else 'loses'})")
    return pilot, (c1, c2), psi_iso


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run without a card)")
    main(ap.parse_args().device)
