"""Structured logging + per-stage timing (a copy of
``orb_slam2_tpu/utils/logging.py`` under the port's logger namespace).

The reference's observability is glog INFO lines (per-frame match
counts src/Tracking.cc:654-656, triangulation counts
src/LocalMapping.cc:101-103, relocalization/loop events
src/Tracking.cc:1188-1192, src/LoopClosing.cc:473, 677) plus the
Pangolin GUI counters.  Equivalent here:

- ``log = get_logger(__name__)`` — stdlib logging, enabled by the
  ``ORB_SLAM2_TPU_LOG`` env var (level name, e.g. ``INFO``) or
  :func:`enable`.
- :class:`StageTimer` — named wall-clock accumulators for pipeline
  stages (the reference has NO timing at all; BASELINE's metric is
  frames/s so we measure ourselves).  ``timer.report()`` returns
  {stage: (calls, total_s, mean_s)}.
"""
from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Tuple

_CONFIGURED = False
_ROOT = "orb_slam2_tpu_torch"


def enable(level: str = "INFO"):
    global _CONFIGURED
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter(
        "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s] %(message)s",
        datefmt="%H:%M:%S"))
    root = logging.getLogger(_ROOT)
    root.handlers[:] = [h]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    # keep propagate=True so pytest caplog (a root-logger handler) and
    # host applications can observe the records too
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        env = os.environ.get("ORB_SLAM2_TPU_LOG")
        if env:
            enable(env)
        else:
            logging.getLogger(_ROOT).addHandler(
                logging.NullHandler())
            _CONFIGURED = True
    if not name.startswith(_ROOT):
        name = _ROOT + "." + name
    return logging.getLogger(name)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.maxv: Dict[str, float] = defaultdict(float)

    @contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[stage] += dt
            self.calls[stage] += 1
            if dt > self.maxv[stage]:
                self.maxv[stage] = dt

    def report(self) -> Dict[str, Tuple[int, float, float]]:
        return {k: (self.calls[k], self.total[k],
                    self.total[k] / max(self.calls[k], 1))
                for k in sorted(self.total)}

    def reset(self):
        self.total.clear()
        self.calls.clear()
        self.maxv.clear()

    def summary(self) -> str:
        # max/call splits one-off costs (first-call compiles through the
        # remote relay) from the steady-state mean the budget cares about
        lines = []
        for k, (n, tot, mean) in self.report().items():
            lines.append(f"{k:32s} {n:6d} calls  {tot:8.3f}s total  "
                         f"{mean * 1e3:8.2f} ms/call  "
                         f"max {self.maxv[k] * 1e3:8.2f} ms")
        return "\n".join(lines)
