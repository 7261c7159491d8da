"""Reduce a `torch.profiler` Chrome trace to device intervals and host ranges.

Device operations are the trace's events of category `kernel`,
`gpu_memcpy` and `gpu_memset`; host ranges are its `user_annotation`
events (the `record_function` ranges: the benchmark's own clip range
and the program's stage timers). Times are in microseconds on the
trace's clock, which the profiler shares between host and device.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_us, dur_us, cat)
    ranges: list = field(default_factory=list)  # (name, start_us, end_us)

    @classmethod
    def from_chrome(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        tr = cls()
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                tr.device.append((e.get("name", ""), float(e["ts"]), float(e["dur"]), cat))
            elif cat == "user_annotation":
                tr.ranges.append((e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        tr.device.sort(key=lambda r: r[1])
        tr.ranges.sort(key=lambda r: r[1])
        return tr

    def span(self, range_name: str) -> tuple[float, float] | None:
        """First start and last end of the host ranges named range_name."""
        rs = [r for r in self.ranges if r[0] == range_name]
        return (rs[0][1], max(r[2] for r in rs)) if rs else None

    def intervals(self, lo: float, hi: float, names=None) -> list:
        """Device intervals clipped to [lo, hi], merged; `names` a predicate
        on the operation's name (all operations by default)."""
        iv = sorted((max(s, lo), min(s + d, hi)) for n, s, d, _ in self.device
                    if s + d > lo and s < hi and (names is None or names(n)))
        merged = []
        for s, e in iv:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_us(self, lo: float, hi: float) -> float:
        return self.device_us(lo, hi, None)

    def device_us(self, lo: float, hi: float, names) -> float:
        """Time in [lo, hi] in which an operation whose name passes
        `names` runs (the union: cuDNN may run kernels side by side)."""
        return sum(e - s for s, e in self.intervals(lo, hi, names))

    def top_ops(self, lo: float, hi: float, k: int = 10) -> list:
        tot = defaultdict(float)
        for n, s, d, _ in self.device:
            if lo <= s < hi:
                tot[n] += d
        return sorted(([n, v / 1e6] for n, v in tot.items()), key=lambda r: -r[1])[:k]

    def host_label(self, t: float) -> str:
        """The innermost host range open at time t, or "no range"."""
        best = None
        for name, s, e in self.ranges:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "no range"

    def idle_gaps(self, lo: float, hi: float, k: int = 10) -> list:
        """The k longest stretches of [lo, hi] with no device operation,
        each named by the host range open where it starts."""
        gaps, t = [], lo
        for s, e in self.intervals(lo, hi):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_label(s), (e - s) / 1e6] for s, e in gaps[:k]]
