"""Spans and counters of the port: which layer of a round the host is in,
and how often it waits for the card.

    from repro_torch import telemetry

    with telemetry.recording() as rec:
        state, metrics = fed.run_rounds(state, batches, owner_seq, key)
    rec.spans        # [Span]: name, start_ns, end_ns, parent, dispatch, attrs, syncs
    rec.self_ns()    # each span's duration less what its children cover
    rec.counters     # what every program counter moved by inside the recording
    telemetry.counters()   # every program counter of the process, by reference

The program opens a span at each layer boundary of a round (`span(name,
**attrs)` as a context manager): `session.run_rounds` around a whole call,
`session.owner_seq`, `schedules.partition`, `engine.round` /
`engine.group` (attr `members`) around one iteration of a K-round
driver, `privatizer.grad` per microbatch with `model.forward`,
`model.backward` and `privatizer.clip` inside it, `privatizer.noise` and
`engine.write`. A span opened with no span open is a root, and starts a
dispatch: every span under it carries its dispatch id. Nothing opens a
span inside the model's layers or per kernel: the device trace names
kernels.

Off (the default), `span` reads one module flag and returns one shared
no-op object: no clock read, no allocation, nothing recorded, no sync.
On, it appends a `Span` to the recording's list at entry and stamps its
end at exit. Timestamps are `time.time_ns()`, the time base of the
profiler's `KinetoEvent.start_ns()`, so a kernel's launch call in a
device trace can be put down to the span open when it ran. Spans stay in
memory; nothing is written out.

On a CUDA machine `recording()` also counts host syncs: it sets
`torch.cuda.set_sync_debug_mode("warn")`, keeps every warning that mode
raises (none deduplicated, none shown) and counts each under the
innermost open span, in the module's `host_syncs` (span name -> count,
"" outside any span) and on the span itself; the previous mode and
warning filters come back at exit. On the CPU nothing waits for a
device and the count stays 0. Recording is for one thread: the spans of
a round all open on the thread that calls `run_rounds`.

`counters()` is the one namespace of the program's counters: the
kernels' `launches` dicts, each live pager's `stats` and `io`, and
`host_syncs`, all the objects themselves, not copies.

Importing this module imports nothing but the standard library."""
from __future__ import annotations

import contextlib
import itertools
import time
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

# the message of every warning of torch's sync debug mode
SYNC_MESSAGE = "called a synchronizing CUDA operation"
OUTSIDE = ""                     # host_syncs' key of a sync outside any span

# the kernels whose `launches` dicts counters() reads (repro_torch.kernels.<name>.kernel)
KERNELS = ("dp_clip_noise", "ssm_scan", "flash_attention", "tree_noise", "bank_codec")

host_syncs: Dict[str, int] = {}   # every counted sync of the process, by innermost span
_pagers: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()   # pager -> its order
_pager_seq = itertools.count()
_on = False
_recording: Optional["Recording"] = None


class _NoSpan:
    """The shared span of tracing off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = -1              # -1 while open
    parent: int = -1              # index in Recording.spans, -1 for a root
    dispatch: int = 0             # shared by every span under one root
    attrs: Dict[str, Any] = field(default_factory=dict)
    syncs: int = 0                # host syncs while this was the innermost span

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class Recording:
    """The spans and counters of one `recording()`."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.counters: Dict[str, Dict[str, float]] = {}
        self._stack: List[int] = []
        self._dispatches = 0

    def _open(self, name: str, attrs: Dict[str, Any]) -> None:
        parent = self._stack[-1] if self._stack else -1
        if parent < 0:
            self._dispatches += 1
            dispatch = self._dispatches
        else:
            dispatch = self.spans[parent].dispatch
        self._stack.append(len(self.spans))
        self.spans.append(Span(name, time.time_ns(), parent=parent, dispatch=dispatch,
                               attrs=attrs))

    def _close(self) -> None:
        self.spans[self._stack.pop()].end_ns = time.time_ns()

    def _sync(self) -> None:
        if self._stack:
            top = self.spans[self._stack[-1]]
            top.syncs += 1
            name = top.name
        else:
            name = OUTSIDE
        host_syncs[name] = host_syncs.get(name, 0) + 1

    @property
    def host_syncs(self) -> int:
        """Syncs counted in this recording, inside a span or not."""
        return int(sum(self.counters.get("host_syncs", {}).values()))

    def self_ns(self) -> List[int]:
        """Each span's duration less the durations of its children (which
        nest inside it), in the order of `spans`."""
        out = [s.duration_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.duration_ns
        return out


class _Opening:
    __slots__ = ("_rec", "_name", "_attrs")

    def __init__(self, rec: Recording, name: str, attrs: Dict[str, Any]) -> None:
        self._rec, self._name, self._attrs = rec, name, attrs

    def __enter__(self):
        self._rec._open(self._name, self._attrs)
        return None

    def __exit__(self, *exc) -> bool:
        self._rec._close()
        return False


def span(name: str, **attrs):
    """A context manager around one layer's work: the shared no-op when
    tracing is off, else one recorded `Span`."""
    if not _on:
        return _NO_SPAN
    return _Opening(_recording, name, attrs)


def register_pager(pager) -> None:
    """Make a pager's `stats` and `io` part of `counters()` while it lives."""
    _pagers[pager] = next(_pager_seq)


def counters() -> Dict[str, Dict[str, float]]:
    """Every program counter, by reference: `<kernel>` -> that kernel
    module's `launches`, `pager.stats` / `pager.io` (`pager<i>.` for the
    i-th live pager after the first), `host_syncs`."""
    import importlib
    out: Dict[str, Dict[str, float]] = {}
    for name in KERNELS:
        out[name] = importlib.import_module(f"repro_torch.kernels.{name}.kernel").launches
    for i, p in enumerate(sorted(_pagers, key=_pagers.__getitem__)):
        tag = "pager" if i == 0 else f"pager{i}"
        out[f"{tag}.stats"], out[f"{tag}.io"] = p.stats, p.io
    out["host_syncs"] = host_syncs
    return out


def _numbers(snapshot: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    return {g: dict(d) for g, d in snapshot.items()}


def _moved(before, after) -> Dict[str, Dict[str, float]]:
    out = {}
    for g, d in after.items():
        was = before.get(g, {})
        diff = {k: v - was.get(k, 0) for k, v in d.items() if v != was.get(k, 0)}
        if diff:
            out[g] = diff
    return out


@contextlib.contextmanager
def _counting_syncs(rec: Recording) -> Iterator[None]:
    import torch
    if not torch.cuda.is_available():
        yield
        return
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_MESSAGE):
                rec._sync()
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Tracing on for the body: spans recorded, host syncs counted; yields
    the `Recording`, whose `counters` are filled at exit."""
    global _on, _recording
    if _on:
        raise RuntimeError("telemetry.recording() is already on")
    rec = Recording()
    before = _numbers(counters())
    _recording, _on = rec, True
    try:
        with _counting_syncs(rec):
            yield rec
    finally:
        _on, _recording = False, None
        rec.counters = _moved(before, _numbers(counters()))
