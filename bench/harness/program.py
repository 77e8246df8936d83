"""The system under test, as a user drives it: the port's model and its
`Federation` session, built from a configuration and a traffic file, and
one dispatch of K rounds through `Federation.run_rounds`.

Everything the harness takes from the program goes through here: the
model's parameter tree (to hand it the benchmark's weights), the session,
the state it returns, the schedule's draw and the kernels' launch
counters. The port is imported when a function is called, never when the
module is imported."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


def model_config(config: dict):
    """The port's ModelConfig of a benchmark configuration file."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in config.items() if k in fields and k not in ("ssm", "source")}
    if config.get("ssm"):
        kw["ssm"] = SSMConfig(**config["ssm"])
    return ModelConfig(**kw)


def leaf_paths(tree, prefix: str = "") -> List[str]:
    """Dotted names of a parameter tree's leaves in its packing order
    (dict keys sorted, NamedTuple fields in order, None fields dropped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f, v in zip(tree._fields, tree) for p in leaf_paths(v, f"{prefix}{f}.")]
    return [prefix[:-1]]


def param_tree(lm, params: Dict[str, torch.Tensor]):
    """The port's parameter tree holding the named tensors `params`."""
    from repro_torch.tree_util import tree_flatten, tree_unflatten
    meta = lm.init(device="meta")
    names = leaf_paths(meta)
    leaves, treedef = tree_flatten(meta)
    if names != list(params):
        raise ValueError(f"the model's leaves {names} are not the benchmark's {list(params)} "
                         "in their packing order")
    for name, leaf in zip(names, leaves):
        if tuple(leaf.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: the model wants {tuple(leaf.shape)}, the benchmark "
                             f"made {tuple(params[name].shape)}")
    return tree_unflatten(treedef, [params[n] for n in names])


def build(config: dict, traffic: dict, params: Dict[str, torch.Tensor], device):
    """(session, state): the model with the benchmark's weights, the
    federation of the traffic file, `make_step` on the flat engine with the
    fused microbatch privatizer, and the session's initial state."""
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    from repro_torch.models import LM
    lm = LM(model_config(config), remat=False)
    tree = param_tree(lm, params)
    owners = [DataOwner(n=traffic["records_per_owner"], epsilon=traffic["epsilon"],
                        xi=traffic["xi"]) for _ in range(traffic["owners"])]
    fed = Federation(owners, FederationConfig.from_target_lr(
        traffic["target_lr"], n_owners=traffic["owners"], horizon=traffic["horizon"],
        sigma=traffic["sigma"], theta_max=traffic["theta_max"]), device=device)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                  privatizer=PrivatizerConfig(xi=traffic["xi"], granularity="microbatch",
                                              n_microbatches=traffic["microbatches"],
                                              fused_kernel=True))
    state = fed.init_state(tree)
    return fed, state


def schedule_draw(fed):
    """The session's schedule as draw(key, n) -> (n,) owners."""
    return lambda key, n: fed.schedule.draw(key, fed.n_owners, n)


def dispatch(fed, state, batch, seq: np.ndarray, key: torch.Tensor, traffic: dict):
    """One call of `run_rounds`: (state, metrics)."""
    if traffic["driver"] == "grouped":
        return fed.run_rounds(state, batch, seq, key=key, owner_parallel=True,
                              max_group=traffic["max_group"])
    return fed.run_rounds(state, batch, seq, key=key)


def flat(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """(theta_L, bank) of a flat state: the (P,) buffer and the (N, P) rows."""
    return state.theta_L.buf, state.bank


def ledger(state) -> Tuple[List[int], List[int]]:
    """(spent, refused) per owner of the device ledger."""
    return state.ledger.spent.tolist(), state.ledger.refused.tolist()


def state_bytes(state) -> int:
    """Bytes of the state's tensors: theta_L, the bank and the ledger."""
    led = state.ledger
    parts = [state.theta_L.buf, state.bank, led.spent, led.cap, led.refused]
    return sum(t.numel() * t.element_size() for t in parts)


def launch_counters() -> Dict[str, int]:
    """The kernels' launch counters (each entry point adds one per launch)."""
    from repro_torch.kernels.dp_clip_noise import kernel as dp
    from repro_torch.kernels.ssm_scan import kernel as ssm
    return {**dp.launches, **{f"ssm.{k}": v for k, v in ssm.launches.items()}}
