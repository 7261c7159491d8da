"""Stage timing and progress.

Every timed region records its wall time into a process-local registry
(`summary()`) and opens a `torch.profiler.record_function` range, so a
profiler trace shows the stages by name.

Two timing modes:

  * default: the clock stops when the host has enqueued the region's
    work, which may still run on the card; no overhead.
  * blocking (``set_blocking(True)`` or ``PROPAINTER_TPU_BLOCKING_TIMERS=1``,
    the JAX package's variable): the card is synchronised before the
    clock starts and before it stops, so the stages add up to the wall
    time. This serialises host and card; keep it off for throughput.

Progress: a pipeline reports (stage, done, total) through
`progress_report`, whose callback's errors never end a run;
`NodeProgress` is the nodes' sink.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

import torch

_TIMES: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_BLOCKING = os.environ.get("PROPAINTER_TPU_BLOCKING_TIMERS", "0") == "1"


def set_blocking(on: bool) -> None:
    global _BLOCKING
    _BLOCKING = bool(on)


def blocking() -> bool:
    return _BLOCKING


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTime:
    """What a `stage_timer` block measured: `seconds`, set when it ends."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


@contextlib.contextmanager
def stage_timer(name: str):
    tm = StageTime()
    if _BLOCKING:
        _sync()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield tm
        if _BLOCKING:
            _sync()
    tm.seconds = time.perf_counter() - t0
    _TIMES[name] += tm.seconds
    _COUNTS[name] += 1


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


def reset() -> None:
    _TIMES.clear()
    _COUNTS.clear()


def summary() -> dict[str, dict[str, float]]:
    return {k: {"seconds": _TIMES[k], "calls": _COUNTS[k]} for k in sorted(_TIMES)}


def log_summary(printer=print) -> None:
    mode = "blocking" if _BLOCKING else "enqueue-only"
    printer(f"  stage timers ({mode}):")
    for name, row in summary().items():
        printer(f"    {name}: {row['seconds']:.3f}s over {row['calls']} call(s)")
