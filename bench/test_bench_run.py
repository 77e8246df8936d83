"""A whole run of each tiny cell on the CPU (the harness's look for a chip
skipped): the check comes out correct, the result line has its fixed keys
in order, and a traced run reports per-layer metrics that exist on the CPU."""
import json
import time

import pytest

from bench import testing
from bench.harness import cell, check


@pytest.mark.parametrize("name", testing.CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_correct(name, trace):
    c = testing.tiny(name)
    out = cell.run(c, testing.SEEDS[name], 0.2, trace, "cpu", time.time())
    lines = out.pop("_lines")
    json.dumps(out)
    assert out["correct"], lines
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(check.NAMES)
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        # on the CPU only the host clock's and the state's readers find something
        assert {n.split(".")[0] for n in out["metrics"]} == {"host_enqueue_ms",
                                                             "state_resident_gb"}
        assert set(out["metrics"]) <= {m["name"] for m in c.per_layer}
        assert "breakdown" in out and "busy_s" in out["device"]
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
        rate = [v for n, v in out["metrics"].items() if n.startswith("tokens_per_s")]
        assert len(rate) == 1 and rate[0]["value"] > 0
