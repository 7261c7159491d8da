"""The program's one record of spans, stage times and counters, and progress.

  * `span(name)` times a region. Each ends as one record (id, name, the
    id of the span open around it, start and end on `time.perf_counter_ns`)
    in a ring of RING_CAPACITY records (`spans()`); where it is full the
    oldest record goes, counted by `dropped()`. While a `torch.profiler`
    records, the span also opens a `record_function` range of its name, so
    the profiler's trace shows it on the clock it shares with the card's
    kernels; `trace_us` maps a span's times onto that trace's timestamps.
  * `stage_timer(name)` is a span that also adds its time to the stage
    table (`summary()`: the pipeline's four stages, streaming's and the
    training step's parts), which `reset_stages` restarts at every run.
  * `kernel(name)` is a kernel launch: while a profiler records it opens
    a range "kernel.<name>", and a launch whose block ends without an
    error counts one under `name`; it keeps no clock and no ring record
    and never synchronises.
  * `count(name, n)` adds to a program counter (`counters()`).

Two timing modes, for spans and stage timers:

  * default: the clock stops when the host has enqueued the region's
    work, which may still run on the card; no overhead.
  * blocking (``set_blocking(True)`` or ``PROPAINTER_TPU_BLOCKING_TIMERS=1``,
    the JAX package's variable): the card is synchronised before the
    clock starts and before it stops, so the regions add up to the wall
    time. This serialises host and card; keep it off for throughput.

Spans nest on the thread that opens them (the node's).

Progress: a pipeline reports (stage, done, total) through
`progress_report`, whose callback's errors never end a run;
`NodeProgress` is the nodes' sink.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import time
from collections import defaultdict
from typing import NamedTuple

import torch

RING_CAPACITY = 1 << 16
KERNEL_RANGE = "kernel."  # prefix of a kernel launch's profiler range


class SpanRecord(NamedTuple):
    id: int
    name: str
    parent: int | None  # id of the span open around this one
    start_ns: int
    end_ns: int


_TIMES: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_COUNTERS: dict[str, int] = defaultdict(int)
_RING: collections.deque = collections.deque(maxlen=RING_CAPACITY)
_DROPPED = [0, 0]  # records dropped, the newest dropped record's end_ns
_OPEN: list[int] = []  # ids of the open spans, innermost last
_IDS = itertools.count()
_BLOCKING = os.environ.get("PROPAINTER_TPU_BLOCKING_TIMERS", "0") == "1"
# one (perf_counter_ns, time_ns) pair: the spans' clock against Unix time
_ANCHOR = (time.perf_counter_ns(), time.time_ns())
_profiler_on = torch._C._autograd._profiler_enabled


def set_blocking(on: bool) -> None:
    global _BLOCKING
    _BLOCKING = bool(on)


def blocking() -> bool:
    return _BLOCKING


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _open_range(name: str):
    """A `record_function` range's handle while a profiler records, else None."""
    if not _profiler_on():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class span:
    """Times its block into the ring (see the module's docstring);
    `seconds` holds the time once the block has ended."""

    __slots__ = ("name", "seconds", "_id", "_parent", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        if _BLOCKING:
            _sync()
        self._id = next(_IDS)
        self._parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(self._id)
        self._t0 = time.perf_counter_ns()
        self._range = _open_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if _BLOCKING and exc_type is None:
                _sync()
        finally:
            if self._range is not None:
                self._range.__exit__(exc_type, exc, tb)
            t1 = time.perf_counter_ns()
            _OPEN.pop()
            if len(_RING) == RING_CAPACITY:
                _DROPPED[0] += 1
                _DROPPED[1] = _RING[0].end_ns
            _RING.append(SpanRecord(self._id, self.name, self._parent, self._t0, t1))
            self.seconds = (t1 - self._t0) * 1e-9
        return False


class stage_timer(span):
    """A span that also adds its time to the stage table when its block
    ends without an error."""

    __slots__ = ()

    def __exit__(self, exc_type, exc, tb):
        super().__exit__(exc_type, exc, tb)
        if exc_type is None:
            _TIMES[self.name] += self.seconds
            _COUNTS[self.name] += 1
        return False


class kernel:
    """One launch of the kernel `name`: a profiler range "kernel.<name>"
    while a profiler records, counted when the block ends without an
    error."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _open_range(KERNEL_RANGE + self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            _COUNTERS[self.name] += 1
        return False


def count(name: str, n: int = 1) -> None:
    _COUNTERS[name] += n


def counters() -> dict[str, int]:
    return dict(_COUNTERS)


def spans() -> list[SpanRecord]:
    """The ring's records, oldest first (in the order their spans ended)."""
    return list(_RING)


def dropped() -> tuple[int, int]:
    """(records the ring dropped, the newest dropped record's end_ns)."""
    return _DROPPED[0], _DROPPED[1]


def trace_us(ns: int) -> float:
    """A span's time (perf_counter_ns) as a `torch.profiler` Chrome trace
    stamps it: an event's `ts` plus the trace's `baseTimeNanoseconds` /
    1000, i.e. Unix microseconds."""
    return (ns - _ANCHOR[0] + _ANCHOR[1]) / 1e3


def progress_report(callback, stage: str, done: int, total: int) -> None:
    """Call a user progress callback, swallowing its errors: observability
    must not end a run."""
    if callback is None:
        return
    try:
        callback(stage, done, total)
    except Exception:  # noqa: BLE001 - any error of the user's callback
        pass


class NodeProgress:
    """Progress sink for node runs (the reference's tqdm bar over the
    window loop, propainter_inference.py:7,254).

    Routes (stage, done, total) to, in order of availability: ComfyUI's
    `comfy.utils.ProgressBar` (drives the web UI), tqdm on stderr, or
    plain stderr lines (at most one a second, and each stage's last).
    Progress stays monotonic per stage."""

    def __init__(self, video_length: int | None = None):
        self._done: dict[str, int] = {}
        self._last_print = 0.0
        self._comfy_bar = None
        self._bars = {}
        try:  # inside a ComfyUI runtime only
            from comfy.utils import ProgressBar  # type: ignore
        except ImportError:
            ProgressBar = None
        if ProgressBar is not None and video_length:
            self._comfy_bar = ProgressBar(video_length)
        try:
            from tqdm import tqdm
        except ImportError:
            tqdm = None
        self._tqdm = tqdm

    def __call__(self, stage: str, done: int, total: int) -> None:
        done = max(done, self._done.get(stage, 0))
        self._done[stage] = done
        if self._comfy_bar is not None and total:
            self._comfy_bar.update_absolute(int(self._comfy_bar.total * done / total))
            return
        if self._tqdm is not None:
            bar = self._bars.get(stage)
            if bar is None:
                bar = self._bars[stage] = self._tqdm(total=total, desc=stage, leave=False)
            bar.update(done - bar.n)
            if done >= total:
                bar.close()
                del self._bars[stage]
            return
        now = time.perf_counter()
        if done >= total or now - self._last_print >= 1.0:
            self._last_print = now
            print(f"[propainter] {stage}: {done}/{total}", file=sys.stderr)


def reset_stages() -> None:
    """Restart the stage table only (a run record's `stages`)."""
    _TIMES.clear()
    _COUNTS.clear()


def reset() -> None:
    """Clear the stage table, the counters and the ring."""
    reset_stages()
    _COUNTERS.clear()
    _RING.clear()
    _DROPPED[:] = [0, 0]


def summary() -> dict[str, dict[str, float]]:
    """The stage table: {stage: {"seconds", "calls"}}, stage timers only."""
    return {k: {"seconds": _TIMES[k], "calls": _COUNTS[k]} for k in sorted(_TIMES)}
