"""The port's cost analysis (``repro_torch.analysis``) on the CPU.

  * `roofline.model_flops` equals the reference's 6ND / 2ND;
  * `op_cost.OpCost` counts 2 M N K for mm, bmm, addmm, baddbmm and an
    einsum, nothing for element-wise ops and views, and the bytes of each
    op's inputs and outputs;
  * the kernels' registered flop formulas equal PERF.md rows 8 to 10 at
    the shapes those rows name (counted on meta tensors through the custom
    ops' fakes);
  * the collective bytes of a 2-rank gloo all-gather equal its operand
    bytes, through the functional collectives and through
    `dist.all_gather_into_tensor`, and are 0 on a group of one rank;
  * `report` prints the reference's tables from the same records;
  * `reanalyze` recomputes a record from its saved trace to the same values.
"""
import datetime
import json
import os
import pickle
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.analysis import op_cost, report, roofline
from repro_torch.analysis.op_cost import OpCost
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.ssm_scan import kernel as skernel


@pytest.mark.parametrize("n, tokens, kind", [(6_061_035_520, 1_048_576, "infer"),
                                             (3_300_000_000, 4096 * 256, "train"),
                                             (1, 1, "infer")])
def test_model_flops_equals_the_reference(n, tokens, kind):
    from repro.analysis.roofline import model_flops
    assert roofline.model_flops(n, tokens, kind) == model_flops(n, tokens, kind)


def test_roofline_terms_take_each_dtype_at_its_peak():
    t = roofline.roofline_terms(67e12 + 989e12, 3.35e12, 450e9,
                                {"float32": 67e12, "bfloat16": 989e12})
    assert t["compute_s"] == pytest.approx(2.0) and t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0) and t["dominant"] == "compute"
    assert roofline.roofline_terms(67e12, 0.0, 0.0)["compute_s"] == pytest.approx(1.0)


@pytest.mark.parametrize("op", ["mm", "bmm", "addmm", "baddbmm", "einsum"])
def test_counter_counts_products(op):
    g = torch.Generator().manual_seed(0)
    M, N, K, B = 5, 7, 11, 3

    def r(*s):
        return torch.randn(s, generator=g)
    calls = {"mm": (lambda: torch.mm(r(M, K), r(K, N)), 2 * M * N * K),
             "bmm": (lambda: torch.bmm(r(B, M, K), r(B, K, N)), 2 * B * M * N * K),
             "addmm": (lambda: torch.addmm(r(M, N), r(M, K), r(K, N)), 2 * M * N * K),
             "baddbmm": (lambda: torch.baddbmm(r(B, M, N), r(B, M, K), r(B, K, N)),
                         2 * B * M * N * K),
             "einsum": (lambda: torch.einsum("bmk,kn->bmn", r(B, M, K), r(K, N)),
                        2 * B * M * N * K)}
    fn, want = calls[op]
    with OpCost() as c:
        fn()
        x = r(M, N)
        (x * 2.0 + 1.0).reshape(N, M).T.sum()          # element-wise, views, a reduction
    s = c.summary()
    assert s["flops"] == want and s["collective_bytes_total"] == 0.0
    assert s["flops_float32"] == want and s["traffic_bytes"] > 0


def test_counter_counts_traffic_and_skips_views():
    x = torch.ones(64, 32)
    with OpCost() as c:
        x.reshape(32, 64).T
    assert c.summary()["traffic_bytes"] == 0.0
    with OpCost() as c:
        torch.add(x, x)
    assert c.summary()["traffic_bytes"] == 3 * 64 * 32 * 4
    with OpCost() as c:
        x.add_(1.0)                                    # its output aliases x: once
    assert c.summary()["traffic_bytes"] == 64 * 32 * 4


def _meta(*shape):
    return torch.empty(shape, device="meta")


# PERF.md section 6: (row, shape, GFLOP as the row prints it)
FORMULA_ROWS = [
    ("8 zamba2", dict(B=2, S=4096, H=32, Kv=32, hd=80), 171.8),
    ("8 internvl2-2b", dict(B=2, S=4096, H=16, Kv=8, hd=128), 137.5),
    ("9", dict(B=2, S=4096, H=80, N=64, P=64, Q=256), 26.93),
    ("9 wide", dict(B=2, S=4096, H=4, N=384, P=385, Q=256), 16.16),
    ("10", dict(B=2, S=1024, H=80, N=64, P=64, Q=256), 16.16),
    ("10 wide", dict(B=2, S=1024, H=4, N=384, P=385, Q=256), 8.89),
]


@pytest.mark.parametrize("row, d, gflop", FORMULA_ROWS, ids=[r[0] for r in FORMULA_ROWS])
def test_registered_formulas_equal_perf_rows(row, d, gflop):
    with OpCost() as c:
        if row.startswith("8"):
            fkernel.flash_attention_cuda(_meta(d["B"], d["S"], d["H"], d["hd"]),
                                         _meta(d["B"], d["S"], d["Kv"], d["hd"]),
                                         _meta(d["B"], d["S"], d["Kv"], d["hd"]), causal=True)
            want = 4 * d["B"] * d["H"] * d["hd"] * d["S"] * (d["S"] + 1) // 2
        else:
            B, S, H, N, P, Q = (d[k] for k in "BSHNPQ")
            v, ld, k = _meta(B, S, H, P), _meta(B, S, H), _meta(B, S, H, N)
            rows = [Q] * (S // Q)
            if row.startswith("9"):
                skernel.ssd_chunk_scan_cuda(v, ld, k, k, ld, Q)
                want = B * H * sum(r * (r + 1) // 2 * (N + P) * 2 + r * N * P * 2 for r in rows)
            else:
                nc = S // Q
                skernel.ssd_chunk_scan_bwd_cuda(v, _meta(B, nc, H, N, P), ld, _meta(B, nc, H),
                                                v, ld, k, k, ld, Q)
                want = B * H * sum(r * (r + 1) // 2 * (3 * N + 2 * P) * 2 + 2 * r * N * P * 2
                                   for r in rows)
    s = c.summary()
    assert s["flops"] == want and s["flops_float32"] == want
    assert round(s["flops"] / 1e9, 2 if gflop < 100 else 1) == gflop


def test_flash_formula_counts_the_pairs_the_mask_keeps():
    assert fkernel.attended_pairs(10, 10, True, None) == 55
    assert fkernel.attended_pairs(10, 10, False, None) == 100
    assert fkernel.attended_pairs(10, 10, True, 3) == 1 + 2 + 3 * 8
    assert fkernel.attended_pairs(6, 4, True, None) == 1 + 2 + 3 + 4 + 4 + 4
    assert skernel.chunk_rows(70, 32) == [32, 32, 6]


# --------------------------------------------------------------- collectives
def _coll_worker(rank, world, store_path, out_dir):
    from torch.distributed import _functional_collectives as funcol
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        alone = [dist.new_group([r]) for r in range(world)][rank]
        x = torch.full((3, 5), float(rank))
        out = {}
        with OpCost() as c:
            y = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
            y = funcol.wait_tensor(y) if hasattr(funcol, "wait_tensor") else y
        out["funcol"] = (c.summary(), y.tolist())
        with OpCost() as c:
            buf = torch.empty((world * 3, 5))
            dist.all_gather_into_tensor(buf, x)
        out["c10d"] = (c.summary(), buf.tolist())
        with OpCost() as c:
            funcol.all_reduce(x, "sum", alone)
        out["alone"] = (c.summary(), None)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_collective_bytes_on_a_two_rank_gloo_world(tmp_path):
    ctx = mp.start_processes(_coll_worker, args=(2, str(tmp_path / "store"), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=2):
        assert time.monotonic() < deadline, "the gloo world did not finish in 300 s"
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out = pickle.load(f)
        for how in ("funcol", "c10d"):
            s, y = out[how]
            assert s["collective_all-gather"] == 3 * 5 * 4 == s["collective_bytes_total"]
            assert y == [[0.0] * 5] * 3 + [[1.0] * 5] * 3
        assert out["alone"][0]["collective_bytes_total"] == 0.0


# ---------------------------------------------------------------- report
def _records():
    recs = []
    for i, (arch, shape) in enumerate([("yi-6b", "prefill_32k"), ("yi-6b", "decode_32k"),
                                       ("zamba2-2.7b", "train_4k"), ("granite-20b",
                                                                     "long_500k")]):
        for mesh in ("pod16x16", "pod2x16x16"):
            ok = shape != "train_4k"
            r = {"arch": arch, "shape": shape, "mesh": mesh, "ok": ok, "variant": ""}
            if ok:
                r.update(lower_s=1.5 + i, compile_s=2.25 * i,
                         memory_analysis={"argument_size_in_bytes": 3 * 1024 ** 3 + i,
                                          "temp_size_in_bytes": 5 * 1024 ** 2 * (i + 1)},
                         hlo_walker={"collective_bytes_total": 7.5e9 * i},
                         roofline={"compute_s": 0.1 * i, "memory_s": 0.2, "collective_s": 0.05,
                                   "dominant": ["memory", "compute", "collective"][i % 3],
                                   "model_flops_total": 1.27e16 / (i + 1),
                                   "useful_flops_ratio": 0.43 * i})
            recs.append(r)
    return recs


def test_report_prints_the_reference_tables():
    from repro.analysis import report as jreport
    recs = _records()
    for mesh in ("pod16x16", "pod2x16x16"):
        assert report.dryrun_table(recs, mesh) == jreport.dryrun_table(recs, mesh)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert [report.fmt_bytes(b) for b in (0, 1023, 5e6, 3e12)] == \
        [jreport.fmt_bytes(b) for b in (0, 1023, 5e6, 3e12)]


# ---------------------------------------------------------------- reanalyze
def test_reanalyze_round_trip(tmp_path):
    from repro_torch.analysis.reanalyze import reanalyze_one
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.dryrun import record_roofline
    from repro_torch.launch.steps import build_step

    cfg = get_config("zamba2-2.7b").reduced()
    shape = INPUT_SHAPES["decode_32k"]
    bundle = build_step(cfg, shape, None)
    with OpCost() as c:
        bundle.step(*bundle.args[:3], shape.seq_len - 1)
    os.makedirs(tmp_path / "trace")
    tag = "zamba2-2.7b__decode_32k__pod16x16"
    c.save(str(tmp_path / "trace" / f"{tag}.trace.json.zst"))
    walked = c.summary()
    rec = {"arch": "zamba2-2.7b", "shape": "decode_32k", "mesh": "pod16x16", "ok": True,
           "reduced": True, "chips": 1, "op_cost": walked,
           "roofline": record_roofline(cfg, shape, walked, 1)}
    with open(tmp_path / f"{tag}.json", "w") as f:
        json.dump(rec, f)
    assert reanalyze_one(str(tmp_path / f"{tag}.json"))
    with open(tmp_path / f"{tag}.json") as f:
        again = json.load(f)
    assert again["op_cost"] == walked and again["roofline"] == rec["roofline"]
    assert walked["flops"] > 0
    doc = op_cost.load_trace(str(tmp_path / "trace" / f"{tag}.trace.json.zst"))
    assert doc["peak_live_bytes"] == c.peak_live_bytes > 0
    assert sum(n for _, n in doc["events"]) == sum(c.events.values())
