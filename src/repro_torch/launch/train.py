"""Runnable async-DP training driver. Counterpart of
``repro/launch/train.py``, flag for flag, plus --device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 20 --owners 4 --eps 1.0 [--device cpu]

Runs Algorithm 1 over owner-sharded synthetic token data: uniform owner
schedule (== rate-1 Poisson clocks), per-owner Theorem-1 Laplace noise,
inertia updates, owner-copy bank, checkpointing. As in the reference,
``--reduced`` is a store_true flag whose default is True, so the launcher
always trains the reduced config, and the MoE family runs the ragged
dispatch, which (like the reference's) has no vmap rule: the default
per-example granularity raises there, ``--granularity microbatch`` runs.
The state is the pytree state (`federation.deep.init_state`) on --device
(CUDA by default); `main` returns it.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import random
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
from repro_torch.device import resolve_device
from repro_torch.federation.deep import AsyncDPConfig, init_state, make_train_step
from repro_torch.federation.dp_sgd import PrivatizerConfig
from repro_torch.federation.privacy import PrivacyAccountant
from repro_torch.models import build_model
from repro_torch.tree_util import tree_flatten


def main(argv=None, params=None):
    """Parse `argv` and train. `params`: the initial weights (a params tree
    of the built model, e.g. the reference's init carried over with
    `convert.params_from_numpy`); None draws them from --seed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--owners", type=int, default=4)
    ap.add_argument("--records", type=int, default=1024,
                    help="records per owner")
    ap.add_argument("--eps", type=float, default=1.0)
    ap.add_argument("--xi", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=1000)
    ap.add_argument("--lr-scale", type=float, default=100.0,
                    help="practical-rate override (1.0 = paper-faithful)")
    ap.add_argument("--sigma", type=float, default=1e-2)
    ap.add_argument("--granularity", default="example",
                    choices=["example", "microbatch"])
    ap.add_argument("--composition", default="paper",
                    choices=["paper", "per_owner_rounds"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # as the reference's launcher: no activation checkpointing
    model = build_model(cfg, remat=False, moe_mode="ragged")
    key = random.split(random.PRNGKey(args.seed, device=dev))[0]
    if params is None:
        params = model.init(seed=args.seed, device=dev)
    n_params = sum(leaf.numel() for leaf in tree_flatten(params)[0])
    print(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M "
          f"owners={args.owners}")

    shards = synthetic_owner_shards(args.owners, args.records, args.seq,
                                    cfg.vocab, seed=args.seed)
    pipe = OwnerDataPipeline(shards, args.batch, seed=args.seed)
    acct = PrivacyAccountant({i: args.eps for i in range(args.owners)},
                             args.horizon, composition=args.composition,
                             n_owners=args.owners)

    acfg = AsyncDPConfig(
        n_owners=args.owners, horizon=args.horizon, rho=1.0, sigma=args.sigma,
        epsilons=tuple([args.eps] * args.owners),
        owner_sizes=tuple(pipe.owner_sizes), xi=args.xi, theta_max=100.0,
        privatizer=PrivatizerConfig(xi=args.xi,
                                    granularity=args.granularity,
                                    n_microbatches=min(4, args.batch)),
        lr_scale=args.lr_scale)

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    step_fn = make_train_step(loss_fn, acfg, device=dev)
    state = init_state(params, acfg, device=dev)

    it = iter(pipe)
    t0 = time.time()
    for k in range(1, args.steps + 1):
        owner, batch = next(it)
        if not acct.record_response(owner):
            print(f"step {k}: owner {owner} budget exhausted — skipping")
            continue
        batch = {k2: torch.from_numpy(v).to(dev) for k2, v in batch.items()}
        key, sub = random.split(key)
        state, metrics = step_fn(state, batch,
                                 torch.tensor([owner], dtype=torch.int32, device=dev), sub)
        if k % max(1, args.steps // 10) == 0 or k == 1:
            with torch.no_grad():
                loss = float(loss_fn(state.theta_L, batch))
            print(f"step {k:4d} owner={owner} loss={loss:.4f} "
                  f"clip_frac={float(metrics['clip_frac']):.2f} "
                  f"noise_scale={float(metrics['grad_noise_scale']):.2e} "
                  f"({time.time()-t0:.1f}s)")
    print("privacy ledger:", acct.summary())
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps, state)
        print("checkpoint:", path)
    return state


if __name__ == "__main__":
    main()
