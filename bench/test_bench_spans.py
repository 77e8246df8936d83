"""The traced set (`harness.spans`) and its five readers.

On synthetic spans, device ops and runtime calls: each op goes to the
span open at its launch call (the earliest call of its correlation id),
layers by span name, host and self times, idle gaps by the span over
their midpoint, the clock check's counts; the readers read that per round
or per dispatch, and give None off the card. On the CPU the set itself
runs on a tiny cell (spans, no device ops). On the card (marked `cuda`),
the host syncs the program counts inside `session.run_rounds` equal the
synchronising calls the device trace shows there, and every device op's
launch lies inside a span of `run_rounds`."""
import dataclasses

import pytest
import torch

from bench import testing
from bench.harness import cell, spans, spec
from bench.reference import model as RM
from repro_torch.telemetry import Span

US = 1000                         # ns
METRICS = ("host_syncs", "model_host_ms", "privatizer_host_ms", "model_device_ms",
           "privatizer_device_ms")


def _spans():
    """One dispatch: run_rounds 0..1000 us holding owner_seq and one round
    (a microbatch's forward and backward, then noise and the write)."""
    return [Span("session.run_rounds", 0, 1000 * US, -1, 1, syncs=0),
            Span("session.owner_seq", 10 * US, 50 * US, 0, 1, syncs=1),
            Span("engine.round", 100 * US, 900 * US, 0, 1),
            Span("privatizer.grad", 110 * US, 600 * US, 2, 1),
            Span("model.forward", 120 * US, 300 * US, 3, 1),
            Span("model.backward", 300 * US, 550 * US, 3, 1),
            Span("privatizer.noise", 650 * US, 700 * US, 2, 1),
            Span("engine.write", 700 * US, 880 * US, 2, 1)]


def _trace():
    """(device ops, runtime calls): (name, start_ns, end_ns, correlation)."""
    launches = [("cudaMemcpyAsync", 20 * US, 21 * US, 1),
                ("cudaStreamSynchronize", 22 * US, 40 * US, 2),
                ("cudaLaunchKernel", 150 * US, 151 * US, 3),
                ("Lazy Function Loading", 150 * US + 500, 150 * US + 900, 3),
                ("cudaLaunchKernel", 310 * US, 311 * US, 4),
                ("cudaLaunchKernel", 660 * US, 661 * US, 5),
                ("cudaLaunchKernel", 710 * US, 711 * US, 6),
                ("cudaLaunchKernel", 950 * US, 951 * US, 7),
                ("cudaLaunchKernel", 2000 * US, 2001 * US, 8)]
    ops = [("Memcpy HtoD", 21 * US, 22 * US, 1),
           ("gemm", 160 * US, 360 * US, 3),          # model.forward
           ("gemm", 360 * US, 560 * US, 4),          # model.backward
           ("dp_round", 680 * US, 690 * US, 5),      # privatizer.noise, after a 120 us gap
           ("where", 720 * US, 740 * US, 6),         # engine.write
           ("stack", 960 * US, 965 * US, 7),         # session.run_rounds itself
           ("copy", 2010 * US, 2020 * US, 8),        # launched outside any span
           ("orphan", 3000 * US, 3001 * US, 99),     # no launch call in the trace
           ("early", 3010 * US, 3011 * US, 9)]     # 1 us before its launch call
    return ops, launches + [("cudaLaunchKernel", 3011 * US, 3012 * US, 9)]


def test_reduce_puts_each_op_and_gap_under_its_span():
    ops, launches = _trace()
    t = spans.reduce(_spans(), ops, launches, rounds=2, dispatches=1, wall_s=0.5)
    assert t.model_device_s == pytest.approx(400e-6)
    assert t.privatizer_device_s == pytest.approx(30e-6)
    assert t.device_s == pytest.approx((1 + 400 + 10 + 20 + 5 + 10 + 1 + 1) * 1e-6)
    assert t.in_run_rounds_s == pytest.approx((1 + 400 + 10 + 20 + 5) * 1e-6)
    assert (t.unmatched, t.before_launch, t.lead_s) == (1, 1, pytest.approx(1e-6))
    assert t.model_host_s == pytest.approx(430e-6)
    # engine.round's self (800 - 490 - 50 - 180) + privatizer.grad's (490 - 430) + noise + write
    assert t.privatizer_host_s == pytest.approx((80 + 60 + 50 + 180) * 1e-6)
    assert (t.syncs, t.syncs_outside) == (1, 0)
    rows = t.by_span
    assert rows["session.run_rounds"].device_s == pytest.approx(5e-6)
    assert rows["session.owner_seq"].device_s == pytest.approx(1e-6)
    assert rows["privatizer.grad"].self_s == pytest.approx(60e-6)
    # gaps of at least 50 us, on the device clock moved 1 us later: 22..160 (mid 92 us:
    # owner_seq closed, round not open), 560..680 (mid 621: privatizer.grad has closed,
    # engine.round holds it), 740..960 (mid 851: engine.write), 965..2010 (mid 1488.5:
    # outside), 2020..3000
    assert rows["session.run_rounds"].idle_s == pytest.approx(138e-6)
    assert rows["engine.round"].idle_s == pytest.approx(120e-6)
    assert rows["engine.write"].idle_s == pytest.approx(220e-6)
    assert rows[spans.OUTSIDE].idle_s == pytest.approx((1045 + 980) * 1e-6)
    assert t.busy_s == pytest.approx(t.device_s)
    text = "\n".join(spans.lines(t, 0.4, 2))
    assert "tracing overhead: 250.000000 ms a round traced against 200.000000 untraced" in text


def test_gaps_are_taken_on_the_device_clock_moved_by_the_lead():
    """Ops that start 10 us before their launch calls: the device clock is
    moved 10 us later, and the gap 40..150 us (midpoint 95, in "a") is
    the gap 50..160 (midpoint 105, in "b")."""
    two = [Span("a", 0, 100 * US, -1, 1), Span("b", 100 * US, 200 * US, -1, 2)]
    ops = [("x", 0, 40 * US, 1), ("y", 150 * US, 160 * US, 2)]
    launches = [("cudaLaunchKernel", 10 * US, 11 * US, 1),
                ("cudaLaunchKernel", 160 * US, 161 * US, 2)]
    t = spans.reduce(two, ops, launches, rounds=1, dispatches=2)
    assert (t.before_launch, t.lead_s) == (2, pytest.approx(10e-6))
    assert t.by_span["b"].idle_s == pytest.approx(110e-6) and t.by_span["a"].idle_s == 0


def _ctx(device="cuda"):
    c = testing.tiny(testing.CELLS[0])
    return cell.Context(c, RM.ModelSpec.from_config(c.config), torch.device(device))


def test_readers_read_the_traced_set_per_round_and_dispatch():
    ops, launches = _trace()
    ctx = _ctx()
    ctx.traced_set = spans.reduce(_spans(), ops, launches, rounds=2, dispatches=1)
    got = {m: spec.read_metric(m, ctx) for m in METRICS}
    assert got == pytest.approx({"host_syncs": 1.0, "model_host_ms": 0.215,
                                 "privatizer_host_ms": 0.185, "model_device_ms": 0.2,
                                 "privatizer_device_ms": 0.015})
    for m in METRICS:
        assert spec.read_metric(m + ".host_paced", ctx) == got[m]


def test_readers_give_none_off_the_card():
    ctx = _ctx("cpu")
    assert all(spec.read_metric(m, ctx) is None for m in METRICS)
    assert ctx.traced_set is None
    ctx = _ctx()                     # a card but no profile: not a traced run
    assert all(spec.read_metric(m, ctx) is None for m in METRICS)


@pytest.mark.parametrize("name", testing.CELLS)
def test_the_set_runs_on_the_cpu(name):
    rec, ops, launches, wall, n, rounds = spans.record(testing.tiny(name), 2**31 + 5,
                                                      torch.device("cpu"))
    assert (n, rounds, ops) == (1, 4, []) and wall > 0
    t = spans.reduce(rec.spans, ops, launches, rounds, n, wall_s=wall)
    assert t.model_host_s > 0 and t.privatizer_host_s > 0 and t.device_s == 0
    assert t.by_span["session.run_rounds"].count == 1 and t.syncs == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("a device trace exists only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", testing.CELLS)
def test_host_syncs_match_the_trace_on_the_card(card, name):
    c = testing.tiny(name)
    c = dataclasses.replace(c, traffic=dict(c.traffic, profiled_dispatches=2))
    rec, ops, launches, wall, n, rounds = spans.record(c, 2**31 + 7, card)
    runs = [s for s in rec.spans if s.name == spans.ROOT_SPAN]
    assert len(runs) == n == 2
    waits = [a for a in launches if a[0] in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                             "cudaEventSynchronize")
             and any(s.start_ns <= a[1] <= s.end_ns for s in runs)]
    assert rec.host_syncs == len(waits) >= n
    t = spans.reduce(rec.spans, ops, launches, rounds, n, wall_s=wall)
    assert ops and t.unmatched == 0
    print(f"{name}: {rec.host_syncs} syncs, {len(ops)} device ops, {t.before_launch} start "
          f"before their launch call by at most {t.lead_s * 1e6:.3f} us")
    assert t.in_run_rounds_s == pytest.approx(t.device_s)
    assert sum(r.device_s for r in t.by_span.values()) == pytest.approx(t.device_s)
