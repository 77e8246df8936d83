"""repro_torch.telemetry: spans and counters of the port, on the CPU.

Off, `span` is one shared no-op that reads no clock, allocates nothing,
records nothing and never touches the sync debug mode. On, spans nest
with parents, dispatch ids and self times; host syncs (the warnings of
torch's sync debug mode, faked here) are counted under the innermost
span, every one of them; `counters()` reads the kernels' `launches` and
the pager's `stats` and `io` in place. A `run_rounds` call of both K-round
drivers opens the spans of the round's layers, and its state and metrics
are bit for bit those of the same call with recording off. The card's
own count, against the synchronising calls of a device trace, is
`bench/test_bench_spans.py`'s test marked `cuda`."""
import collections
import contextlib
import importlib
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from repro_torch import random as trandom
from repro_torch import telemetry
from repro_torch.federation import DataOwner, Federation, FederationConfig, PrivatizerConfig
from repro_torch.federation.paging import OwnerPager

N, B, D, G = 4, 4, 16, 2
# K 6: the grouped driver runs two groups of three distinct owners
SEQ = np.array([0, 1, 2, 0, 3, 1])


def _loss(p, batch):
    return torch.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)


def _run(owner_parallel: bool, record: bool):
    """One `run_rounds` call of a toy regression federation on the CPU from
    fixed weights, batches and key: (state, metrics, recording or None)."""
    owners = [DataOwner(n=50, epsilon=1.0, xi=1.0) for _ in range(N)]
    fed = Federation(owners, FederationConfig.from_target_lr(
        0.05, n_owners=N, horizon=100, sigma=0.01, theta_max=10.0), device="cpu")
    fed.make_step(_loss, pack_params=True, privatizer=PrivatizerConfig(
        xi=1.0, granularity="microbatch", n_microbatches=G, fused_kernel=True))
    gen = torch.Generator().manual_seed(0)
    state = fed.init_state({"w": torch.randn(D, generator=gen), "b": torch.zeros(())})
    k = SEQ.size
    batches = {"x": torch.randn(k, B, D, generator=gen), "y": torch.randn(k, B, generator=gen)}
    key = trandom.PRNGKey(3, device="cpu")
    kw = dict(owner_parallel=True, max_group=None) if owner_parallel else {}
    if not record:
        return (*fed.run_rounds(state, batches, SEQ, key, **kw), None)
    with telemetry.recording() as rec:
        state, m = fed.run_rounds(state, batches, SEQ, key, **kw)
    return state, m, rec


def test_off_is_one_shared_no_op(monkeypatch):
    assert not telemetry._on

    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    sets = []
    monkeypatch.setattr(telemetry.time, "time_ns", no_clock)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", sets.append)
    a, b = telemetry.span("engine.round"), telemetry.span("engine.group", members=3)
    assert a is b
    syncs = dict(telemetry.host_syncs)

    def peak(make):
        """Peak traced bytes of 1000 `with make():` blocks."""
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            for _ in range(1000):
                with make():
                    pass
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()

    shared = contextlib.nullcontext()
    assert peak(lambda: telemetry.span("engine.group", members=3)) <= peak(lambda: shared)
    assert telemetry._recording is None and telemetry.host_syncs == syncs and sets == []


def test_spans_nest_with_parents_dispatches_and_self_time(monkeypatch):
    clock = iter(range(0, 10_000, 10))          # each read 10 ns after the last
    monkeypatch.setattr(telemetry.time, "time_ns", lambda: next(clock))
    with telemetry.recording() as rec:
        for _ in range(2):
            with telemetry.span("session.run_rounds"):             # t .. t+70
                with telemetry.span("engine.group", members=2):   # t+10 .. t+40
                    with telemetry.span("model.forward"):         # t+20 .. t+30
                        pass
                with telemetry.span("engine.write"):              # t+50 .. t+60
                    pass
        with pytest.raises(ValueError):
            with telemetry.span("engine.round"):
                raise ValueError("a span closes on the way out")
    got = [(s.name, s.parent, s.dispatch, s.attrs) for s in rec.spans]
    assert got == [("session.run_rounds", -1, 1, {}), ("engine.group", 0, 1, {"members": 2}),
                   ("model.forward", 1, 1, {}), ("engine.write", 0, 1, {}),
                   ("session.run_rounds", -1, 2, {}), ("engine.group", 4, 2, {"members": 2}),
                   ("model.forward", 5, 2, {}), ("engine.write", 4, 2, {}),
                   ("engine.round", -1, 3, {})]
    assert [s.duration_ns for s in rec.spans] == [70, 30, 10, 10] * 2 + [10]
    assert rec.self_ns() == [30, 20, 10, 10] * 2 + [10]
    assert not telemetry._on and telemetry.span("x") is telemetry.span("y")


def test_recording_does_not_nest():
    with telemetry.recording():
        with pytest.raises(RuntimeError):
            with telemetry.recording():
                pass
    assert not telemetry._on


def test_host_syncs_counted_under_the_innermost_span(monkeypatch):
    """On a CUDA machine (faked): the sync debug mode is set to "warn" and
    put back, every one of its warnings is counted where it was raised
    (the same line three times counts three), and other warnings still
    reach their handler."""
    mode, sets = [0], []

    def set_mode(m):
        sets.append(m)
        mode[0] = m

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    before = collections.Counter(telemetry.host_syncs)
    with pytest.warns(UserWarning, match="not a sync"):
        with telemetry.recording() as rec:
            with telemetry.span("session.owner_seq"):
                for _ in range(3):
                    warnings.warn(telemetry.SYNC_MESSAGE + " (function copy_)")
                with telemetry.span("model.forward"):
                    warnings.warn(telemetry.SYNC_MESSAGE)
                    warnings.warn("not a sync")
            warnings.warn(telemetry.SYNC_MESSAGE)
    assert sets == ["warn", 0]
    assert [s.syncs for s in rec.spans] == [3, 1]
    assert rec.counters["host_syncs"] == {"session.owner_seq": 3, "model.forward": 1, "": 1}
    assert rec.host_syncs == 5
    assert collections.Counter(telemetry.host_syncs) - before == collections.Counter(
        {"session.owner_seq": 3, "model.forward": 1, "": 1})


def test_cpu_recording_leaves_the_sync_mode_alone(monkeypatch):
    sets = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", sets.append)
    with telemetry.recording() as rec:
        with telemetry.span("a"):
            pass
    assert sets == [] and rec.host_syncs == 0 and len(rec.spans) == 1


def test_counters_read_the_programs_counters_in_place():
    c = telemetry.counters()
    for name in telemetry.KERNELS:
        assert c[name] is importlib.import_module(f"repro_torch.kernels.{name}.kernel").launches
    assert c["host_syncs"] is telemetry.host_syncs
    pager = OwnerPager(N, 2, np.array([0, 1], np.int32), {})
    c = telemetry.counters()
    tag = next(k for k, v in c.items() if v is pager.stats)
    assert tag.endswith(".stats") and c[tag[:-len("stats")] + "io"] is pager.io
    dp = c["dp_clip_noise"]
    with telemetry.recording() as rec:
        dp["sqnorm"] += 2
        pager.stats["loads"] += 3
        pager.io["h2d_bytes"] += 64
    dp["sqnorm"] -= 2
    assert rec.counters == {"dp_clip_noise": {"sqnorm": 2}, tag: {"loads": 3},
                            tag[:-len("stats")] + "io": {"h2d_bytes": 64}}


@pytest.mark.parametrize("owner_parallel", [False, True], ids=["sequential", "grouped"])
def test_run_rounds_span_tree_and_bits(owner_parallel):
    state, m, rec = _run(owner_parallel, record=True)
    names = collections.Counter(s.name for s in rec.spans)
    rounds = 2 if owner_parallel else SEQ.size          # groups of three, or rounds
    unit = "engine.group" if owner_parallel else "engine.round"
    assert names == collections.Counter({
        "session.run_rounds": 1, "session.owner_seq": 1, unit: rounds,
        "privatizer.grad": G * rounds, "model.forward": G * rounds,
        "model.backward": G * rounds, "privatizer.clip": G * rounds,
        "privatizer.noise": rounds, "engine.write": rounds,
        **({"schedules.partition": 1} if owner_parallel else {})})
    spans = rec.spans
    assert spans[0].name == "session.run_rounds" and spans[0].parent == -1
    assert {s.dispatch for s in spans} == {1}
    for s in spans:
        parent = spans[s.parent].name if s.parent >= 0 else None
        want = {"session.owner_seq": "session.run_rounds",
                "schedules.partition": "session.run_rounds", unit: "session.run_rounds",
                "privatizer.grad": unit, "privatizer.noise": unit, "engine.write": unit,
                "model.forward": "privatizer.grad", "model.backward": "privatizer.grad",
                "privatizer.clip": "privatizer.grad"}.get(s.name)
        assert parent == want, s.name
        assert s.end_ns >= s.start_ns
    if owner_parallel:
        assert [s.attrs for s in spans if s.name == unit] == [{"members": 3}] * 2
    assert rec.host_syncs == 0
    off_state, off_m, _ = _run(owner_parallel, record=False)
    assert torch.equal(state.theta_L.buf, off_state.theta_L.buf)
    assert torch.equal(state.bank, off_state.bank)
    assert torch.equal(state.ledger.spent, off_state.ledger.spent)
    assert m.keys() == off_m.keys() and all(torch.equal(m[k], off_m[k]) for k in m)
