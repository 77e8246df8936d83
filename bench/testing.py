"""Tiny versions of the benchmark's cells for the CPU tests: the same
families, drivers and checks at widths a test run holds (the real cells'
limits, BENCHMARK.json's metrics)."""
from __future__ import annotations

import dataclasses

from bench.harness import spec

CELLS = ("qwen1.5-0.5b.seq-s1024", "qwen1.5-0.5b.grouped-s128")
# a seed per tiny cell, above 2**31, and a schedule key under which, of 4
# owners, the sequential cell's checked dispatch (K 4) answers two owners
# twice each and the grouped cell's runs a group of three and then the
# first of its owners again
SEEDS = {"qwen1.5-0.5b.seq-s1024": 2**31 + 1, "qwen1.5-0.5b.grouped-s128": 2**31 + 3}
SCHEDULE_KEYS = {"qwen1.5-0.5b.seq-s1024": 0, "qwen1.5-0.5b.grouped-s128": 2}


def tiny(name: str) -> spec.Cell:
    """The cell `name` at a CPU test's size: 2 layers of width 64, vocab
    256, 4 owners of 20 records, S 12, K 4."""
    c = spec.cell(name)
    cfg = dict(c.config, n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128, vocab=256,
               n_kv_heads=4 if c.config["n_kv_heads"] == c.config["n_heads"] else 2)
    traffic = dict(c.traffic, owners=4, records_per_owner=20, seq=12, rounds_per_dispatch=4,
                   dispatch_pool=3, profiled_dispatches=1, schedule_key=SCHEDULE_KEYS[name])
    return dataclasses.replace(c, config=cfg, traffic=traffic)
