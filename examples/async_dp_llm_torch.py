"""End-to-end deep-model driver on the PyTorch port: asynchronously DP-train
a ~120M-param LM across 4 private data owners, the twin of
examples/async_dp_llm.py, driven through `repro_torch.federation.Federation`.

    PYTHONPATH=src python examples/async_dp_llm_torch.py [--steps 300]      # on CUDA
    PYTHONPATH=src python examples/async_dp_llm_torch.py --tiny --steps 5 --device cpu
    PYTHONPATH=src python examples/async_dp_llm_torch.py --arch xlstm-125m

Default model is the 12-layer dense 124M GQA transformer (`DENSE_124M`).

Each step: uniform owner draw, Theorem-1 Laplace noise on the clipped owner
gradient, the paper's inertia update (eqs. 5-7), owner bank write-back.
Privacy accounting lives INSIDE the session's mechanism — budget-exhausted
owners are refused by `fed.step` itself.

By default the loop drives the fused multi-round path: chunks of
`--rounds-per-dispatch` rounds run as one `fed.run_rounds` dispatch with
the privacy ledger resident on the device, and `fed.reconcile` folds the
device counters back into the host accountant. `--rounds-per-dispatch 1`
falls back to the host-authorized per-round `fed.step` loop. As in the
reference, the state is the model tree and the privatizer the plain one;
`--fused` runs the port's main path instead: the packed flat engine with
the fused privatizer (the `sqnorm` and `dp_round` kernels on CUDA).
"""
import argparse
import time

import torch

from repro_torch import random
from repro_torch.configs import DENSE_124M, get_config
from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
from repro_torch.federation import DataOwner, Federation, FederationConfig, PrivatizerConfig
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="dense-124m")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CI-speed)")
    ap.add_argument("--owners", type=int, default=4)
    ap.add_argument("--eps", type=float, default=2.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05,
                    help="target effective owner-update rate; converted to "
                         "the paper's lr_scale by FederationConfig."
                         "from_target_lr (recorded deviation — the paper's "
                         "exact rho/T^2 rate is ~0 for deep nets)")
    ap.add_argument("--rounds-per-dispatch", type=int, default=25,
                    help="rounds fused into one run_rounds dispatch "
                         "(1 = legacy per-round step loop)")
    ap.add_argument("--fused", action="store_true",
                    help="the flat engine with the fused privatizer (the kernels on CUDA)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run without a card)")
    args = ap.parse_args(argv)

    cfg = DENSE_124M if args.arch == "dense-124m" else get_config(args.arch)
    if args.tiny:
        cfg = cfg.reduced()
    model = LM(cfg, remat=False)
    # the reference splits PRNGKey(0) into the round key and the init key;
    # the port draws its weights from a seed
    key, _ = random.split(random.PRNGKey(0, device=args.device))
    dev = key.device
    params = model.init(seed=0, device=dev)
    n_params = sum(leaf.numel() for leaf in tree_flatten(params)[0])
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params, "
          f"{cfg.n_layers} layers)")

    N = args.owners
    shards = synthetic_owner_shards(N, 2048, args.seq, cfg.vocab, seed=0)
    pipe = OwnerDataPipeline(shards, args.batch, seed=0)
    horizon = max(args.steps, 100)
    fcfg = FederationConfig.from_target_lr(
        args.lr, n_owners=N, horizon=horizon, sigma=1e-2, theta_max=100.0)
    owners = [DataOwner(n=sz, epsilon=args.eps, xi=1.0)
              for sz in pipe.owner_sizes]
    fed = Federation(owners, fcfg, device=dev)

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    def central_loss(state, batch):
        with torch.no_grad():
            return float(loss_fn(fed.params_of(state),
                                 {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}))

    fed.make_step(loss_fn,
                  privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch",
                                              n_microbatches=2, fused_kernel=args.fused),
                  pack_params=args.fused)
    state = fed.init_state(params)

    losses = []
    t0 = time.time()
    R = max(1, args.rounds_per_dispatch)
    if R == 1:
        it = iter(pipe)
        for k in range(1, args.steps + 1):
            owner, batch = next(it)
            batch = {k2: torch.as_tensor(v) for k2, v in batch.items()}
            key, sub = random.split(key)
            state, m = fed.step(state, batch, owner, sub)
            if m["refused"]:
                continue
            if k % 25 == 0 or k == 1:
                loss = central_loss(state, batch)
                losses.append(loss)
                print(f"step {k:4d} owner={owner} central-loss={loss:.4f} "
                      f"clip={float(m['clip_frac']):.2f} "
                      f"[{(time.time()-t0)/k:.2f}s/step]")
    else:
        done = 0
        while done < args.steps:
            k = min(R, args.steps - done)
            owner_seq = pipe.schedule(k)
            batches = {k2: torch.as_tensor(v)
                       for k2, v in pipe.batches_for(owner_seq).items()}
            key, sub = random.split(key)
            state, ms = fed.run_rounds(
                state, batches, torch.as_tensor(owner_seq, dtype=torch.int32), key=sub)
            done += k
            refused = ms["refused"].cpu().numpy()
            granted = int((~refused).sum())
            last = {k2: v[-1] for k2, v in batches.items()}
            loss = central_loss(state, last)
            losses.append(loss)
            print(f"step {done:4d} ({k} rounds/dispatch, {granted} granted) "
                  f"central-loss={loss:.4f} "
                  f"clip={float(ms['clip_frac'].mean()):.2f} "
                  f"[{(time.time()-t0)/done:.3f}s/step]")
        fed.reconcile(state)     # fold the device ledger into the host one
    print("\nprivacy ledger:")
    for i, s in fed.ledger().items():
        print(f"  owner {i}: eps={s['epsilon']} responses={s['responses']} "
              f"spent={s['spent']:.3f} refused={s['refused']}")
    if len(losses) >= 2:
        print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'flat'})")
    return losses


if __name__ == "__main__":
    main()
