"""The harness is driven by data: in a copy of the benchmark, a new
configuration, traffic mix, cell and per-layer metric are added as files
and BENCHMARK.json entries, and the harness finds them by name while no
file that was there changes."""
import hashlib
import json
import shutil

from bench.harness import spec


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    old_cells = {w["name"] for w in bench["workloads"]}

    cfg = json.loads((tmp_path / "bench/configs/qwen1.5-0.5b.json").read_text())
    (tmp_path / "bench/configs/qwen1.5-0.5b-copy.json").write_text(
        json.dumps(dict(cfg, name="qwen1.5-0.5b-copy")))
    traffic = json.loads((tmp_path / "bench/traffic/grouped-s128.json").read_text())
    (tmp_path / "bench/traffic/seq-s64.json").write_text(
        json.dumps(dict(traffic, driver="sequential", max_group=None, seq=64)))
    (tmp_path / "bench/limits/qwen-copy.seq-s64.json").write_text(json.dumps(
        {"limits": {"owner_mismatch": 0, "ledger_mismatch": 0, "grad_norm_gap": 1e-3,
                    "grad_leaf_gap": 0.1, "update_leaves_off": 0}, "update_tolerance": 1e-6}))
    (tmp_path / "bench/metrics/rounds_per_s.py").write_text(
        "def read(ctx):\n    return ctx.window_rounds / ctx.window_s if ctx.window_s else None\n")
    bench["configs"].append({"name": "qwen1.5-0.5b-copy", "source": cfg["source"],
                             "file": "bench/configs/qwen1.5-0.5b-copy.json", "reduced": [],
                             "why": "a copy"})
    bench["workloads"].append({"name": "qwen-copy.seq-s64", "config": "qwen1.5-0.5b-copy",
                               "traffic": "seq-s64", "chips": 1, "why": "a copy"})
    next(m for m in bench["end_to_end"] if m["name"] == "tokens_per_s")["workloads"].append(
        "qwen-copy.seq-s64")
    bench["per_layer"].append({"name": "rounds_per_s", "unit": "rounds/s", "better": "higher",
                               "source": "host_clock", "layer": "session",
                               "moves": "tokens_per_s", "workloads": ["qwen-copy.seq-s64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.cell("qwen-copy.seq-s64", tmp_path)
    assert c.traffic["seq"] == 64 and c.config["name"] == "qwen1.5-0.5b-copy"
    assert [m["name"] for m in c.end_to_end] == ["tokens_per_s", "peak_mem_gb", "setup_s"]
    assert "rounds_per_s" in [m["name"] for m in c.per_layer]
    assert "mfu" in [m["name"] for m in c.per_layer]
    assert "mean_group_size" not in [m["name"] for m in c.per_layer]

    class Ctx:
        window_rounds, window_s = 30, 2.0
    assert spec.read_metric("rounds_per_s", Ctx(), tmp_path) == 15.0
    for name in old_cells:
        assert "rounds_per_s" not in [m["name"] for m in spec.cell(name, tmp_path).per_layer]
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {tmp_path.joinpath("BENCHMARK.json").relative_to(tmp_path)}
