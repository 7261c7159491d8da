"""One JSON record per node run: kind, clip length, config, wall time,
frames/s, the stage timers and whether it ended without an error. The
nodes open the recorder around their whole call, the host's work before
and after the pipeline included.

The record is kept in-process (`last_run()`) and, when
PROPAINTER_TPU_METRICS names a file, appended to it as one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from . import profiling

_LAST: dict | None = None


class RunRecorder:
    """Context manager around one run; restarts the stage table on entry
    (the spans and counters stay: `profiling.reset` clears them)."""

    def __init__(self, kind: str, config, video_length: int):
        self.record = {
            "kind": kind,
            "video_length": video_length,
            "config": dataclasses.asdict(config),
            "started_unix": time.time(),
        }

    def __enter__(self):
        profiling.reset_stages()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _LAST
        dt = time.perf_counter() - self._t0
        self.record["seconds"] = round(dt, 4)
        if dt > 0:
            self.record["frames_per_sec"] = round(self.record["video_length"] / dt, 3)
        self.record["stages"] = profiling.summary()
        self.record["ok"] = exc_type is None
        _LAST = self.record
        path = os.environ.get("PROPAINTER_TPU_METRICS")
        if path:
            with open(path, "a") as f:
                f.write(json.dumps(self.record) + "\n")
        return False


def last_run() -> dict | None:
    return _LAST
