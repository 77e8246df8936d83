"""Runtime half of dpcheck on the port: a key-reuse sanitizer.

    with dpcheck.sanitize() as rec:
        fed.run_rounds(...)
    assert rec.draws > 0 and rec.skipped == 0

The context manager patches the ``repro_torch.random`` samplers and
``split`` as the reference's patches ``jax.random``, and installs the hook
that the kernel entry points call on their CUDA branch
(``random.report_draw``): there the kernel hashes its key in-kernel and no
sampler runs, so without the hook the sanitizer would not see the draw. On
the CPU the entry points run their plain versions, whose own sampler call
records the draw, so one draw is one record on either device.

The unit is one key, a ``(2,)`` row of a (batched) ``(..., 2)`` key
tensor, and what a draw consumes is a set of the key's threefry counters:

  * a sampler over shape S consumes [0, prod S);
  * ``bits_range(key, a, b)`` consumes [a, b);
  * ``bits_block`` (and a ``block=`` draw, and a kernel launch on a block
    of a leaf) consumes the block's global flat indices.

``KeyReuseError`` is raised when

  * a draw takes a counter of a key that an earlier draw already took,
  * a sampler draws from a key that was already split,
  * the same key is split twice, or split after being drawn from.

Disjoint ranges of one key are lawful: that is how the ranks of a device
mesh draw the columns of one row. A draw inside ``random.replay()`` (the
tree's deferred commit, which launches ``tree_delta_`` again to write the
node row with the noise of the first launch) must redraw counters already
drawn; it is counted in ``rec.replays`` and records nothing more.
``fold_in`` is untouched — deriving is how fresh streams are made (the
codec salt and the fault salts depend on it). The samplers call one another (``laplace`` draws through
``uniform``, ``randint`` splits): only the outermost call is recorded.

Keys whose values cannot be read (meta and fake tensors, as the dry-run
builds) are counted in ``rec.skipped`` (one per key row) instead of
checked. Reading a CUDA key copies it to the host: under ``sanitize()``
every draw on the card syncs. That is the price of the debugging mode;
with no sanitizer active the hook is one Python call a launch.

Coverage caveat, as in the reference: only calls through the module
attribute (``random.laplace(...)``) are seen; a sampler bound before the
context (``from repro_torch.random import laplace``) calls the original.
The port calls its samplers as ``random.*`` throughout.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import inspect
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random

SAMPLER_NAMES = ("bits", "bits_range", "bits_block", "randint", "uniform", "laplace",
                 "normal", "exponential", "gumbel")

Interval = Tuple[int, int]


class KeyReuseError(RuntimeError):
    """A key's counters were drawn twice under dpcheck.sanitize()."""


def block_intervals(shape: Sequence[int], offsets: Sequence[int],
                    local_shape: Sequence[int]) -> List[Interval]:
    """The global flat indices of the block of `local_shape` at `offsets`
    of a row-major leaf of `shape`, as sorted disjoint [start, stop)
    runs (trailing dims the block holds whole merge into one run)."""
    shape, offsets = random._shape(shape), random._shape(offsets)
    local = random._shape(local_shape)
    if math.prod(local) == 0:
        return []
    strides, st = [0] * len(shape), 1
    for j in reversed(range(len(shape))):
        strides[j] = st
        st *= shape[j]
    # the innermost dims the block holds whole join the run
    j = len(shape) - 1
    run = 1
    while j >= 0 and local[j] == shape[j]:
        run *= shape[j]
        j -= 1
    if j < 0:
        return [(0, run)]
    run *= local[j]
    starts = np.zeros((1,), dtype=np.int64) + offsets[j] * strides[j]
    for d in reversed(range(j)):
        axis = (offsets[d] + np.arange(local[d], dtype=np.int64)) * strides[d]
        starts = (axis[:, None] + starts[None, :]).reshape(-1)
    base = sum(o * s for o, s in zip(offsets[j + 1:], strides[j + 1:]))
    starts = np.sort(starts + base)
    return [(int(a), int(a) + run) for a in starts]


class _Counters:
    """The counters of one key drawn so far: sorted disjoint intervals,
    each with the draw that took it."""

    def __init__(self) -> None:
        self.starts: List[int] = []
        self.stops: List[int] = []
        self.who: List[str] = []

    def take(self, a: int, b: int, what: str) -> None:
        if a >= b:
            return
        i = bisect.bisect_right(self.starts, a)
        for j in (i - 1, i):
            if 0 <= j < len(self.starts) and self.starts[j] < b and a < self.stops[j]:
                raise KeyReuseError(
                    f"key reuse: {what} drew counters [{a}, {b}) of a key whose counters "
                    f"[{self.starts[j]}, {self.stops[j]}) were already consumed by "
                    f"{self.who[j]}")
        self.starts.insert(i, a)
        self.stops.insert(i, b)
        self.who.insert(i, what)

    def covers(self, a: int, b: int) -> bool:
        """Whether [a, b) lies within counters drawn before."""
        i = bisect.bisect_right(self.starts, a) - 1
        while a < b:
            if i < 0 or i >= len(self.starts) or not self.starts[i] <= a < self.stops[i]:
                return False
            a, i = self.stops[i], i + 1
        return True


def _key_rows(key) -> Tuple[Optional[List[bytes]], int]:
    """(the bytes of each (2,) row of a key tensor, the number of rows);
    the bytes are None when the values cannot be read (meta or fake
    tensors, an abstract trace)."""
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(np.asarray(key))
    n = max(1, math.prod(tuple(key.shape)[:-1]))
    if key.device.type == "meta" or type(key).__name__ in ("FakeTensor", "FunctionalTensor"):
        return None, n
    try:
        arr = key.detach().to("cpu").to(torch.int64).numpy().astype(np.uint32)
    except (RuntimeError, TypeError, ValueError, NotImplementedError):
        return None, n          # no values to read (a fake or abstract tensor)
    return [r.tobytes() for r in arr.reshape(-1, 2)], n


class Recorder:
    """Consumed counters and split keys plus coverage counters: `draws`
    and `splits` count key rows, `skipped` the rows that could not be
    read, `replays` the rows a `random.replay()` block redrew; `by_what`
    counts the draws by their drawer (a sampler, ``random.bits_range``, or
    a kernel entry point that reported its launch, ``dp_round_flat``)."""

    def __init__(self) -> None:
        self.consumed: Dict[bytes, _Counters] = {}
        self.split: Dict[bytes, str] = {}
        self.draws = 0
        self.splits = 0
        self.skipped = 0
        self.replays = 0
        self.by_what: Dict[str, int] = collections.Counter()
        self._depth = 0

    def _draw(self, key, intervals: Sequence[Interval], what: str) -> None:
        rows, n = _key_rows(key)
        if rows is None:
            self.skipped += n
            return
        for h in rows:
            if h in self.split:
                raise KeyReuseError(
                    f"key reuse: {what} drew from a key already split by {self.split[h]}")
            counters = self.consumed.setdefault(h, _Counters())
            if random._replaying and all(counters.covers(a, b) for a, b in intervals):
                self.replays += 1
                continue
            for a, b in intervals:
                counters.take(a, b, what)
            self.draws += 1
            self.by_what[what] += 1

    def _split(self, key, what: str) -> None:
        rows, n = _key_rows(key)
        if rows is None:
            self.skipped += n
            return
        for h in rows:
            if h in self.consumed and self.consumed[h].starts:
                raise KeyReuseError(
                    f"key reuse: {what} split a key already consumed by "
                    f"{self.consumed[h].who[0]}")
            if h in self.split:
                raise KeyReuseError(
                    f"key reuse: {what} split a key already split by {self.split[h]}")
            self.split[h] = what
            self.splits += 1

    def report(self, what, key, start, stop, block, fold) -> None:
        """`random.report_draw`'s hook: a kernel launch's in-kernel draw."""
        if self._depth:
            return
        if fold is not None:
            key = random.fold_in(key, fold)
        intervals = ([(int(start), int(stop))] if block is None
                     else block_intervals(*block))
        self._draw(key, intervals, what)


def _counters(name: str, bound: inspect.BoundArguments) -> List[Interval]:
    """The counters a sampler call consumes of each of its keys."""
    bound.apply_defaults()
    a = bound.arguments
    if name == "bits_range":
        return [(int(a["start"]), int(a["stop"]))]
    if name == "bits_block":
        return block_intervals(a["shape"], a["offsets"], a["local_shape"])
    block = a.get("block")
    if block is not None:
        return block_intervals(a["shape"], block[0], block[1])
    return [(0, math.prod(random._shape(a.get("shape", ()))))]


@contextlib.contextmanager
def sanitize() -> Iterator[Recorder]:
    """Patch repro_torch.random and hear the kernels' draws; raise on any
    key reuse."""
    if random._draw_hook is not None:
        raise RuntimeError("dpcheck.sanitize() is already active")
    rec = Recorder()
    saved = {}

    def wrap(name: str, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(key, *args, **kwargs):
            if rec._depth:
                # a sampler inside a sampler (laplace -> uniform): recorded once
                return fn(key, *args, **kwargs)
            if name == "split":
                rec._split(key, "random.split")
            else:
                # the counters follow from the other arguments alone
                rec._draw(key, _counters(name, sig.bind(None, *args, **kwargs)),
                          f"random.{name}")
            rec._depth += 1
            try:
                # forwarding wrapper: records the use, then delegates
                return fn(key, *args, **kwargs)  # dpcheck: ignore[DPC105]
            finally:
                rec._depth -= 1
        return wrapper

    try:
        for name in SAMPLER_NAMES + ("split",):
            saved[name] = getattr(random, name)
            setattr(random, name, wrap(name, saved[name]))
        random._draw_hook = rec.report
        yield rec
    finally:
        random._draw_hook = None
        for name, fn in saved.items():
            setattr(random, name, fn)
