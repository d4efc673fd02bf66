"""A watch over the measured window's steps: a thread that ticks while the
window runs and, where a step has not ended a second after the last one,
takes the stack of the thread that runs the window, so that a stall says
where it waits: in a call into the card (the card or its driver) or in
Python (the host).  The longest gap between its own ticks says whether the
whole process stood still (the host took the CPU away).

    watch = StallWatch()
    with watch:
        for k in range(n):
            step()
            watch.beat(k + 1)
    watch.report()

It reads only its own process; the ticks cost a few microseconds each."""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List


class StallWatch:
    def __init__(self, threshold_s: float = 1.0, tick_s: float = 0.1, keep: int = 3):
        self.threshold_s, self.tick_s, self.keep = threshold_s, tick_s, keep
        self.stalls: List[Dict] = []
        self.tick_gap_max_s = 0.0
        self._step, self._last = 0, time.perf_counter()
        self._seen = -1
        self._stop = threading.Event()
        self._watched = threading.get_ident()
        self._thread = threading.Thread(target=self._run, name="stallwatch", daemon=True)

    def __enter__(self) -> "StallWatch":
        self._watched = threading.get_ident()
        self._last = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def beat(self, step: int) -> None:
        """Step ``step`` has begun: the one before it ended now."""
        self._step, self._last = step, time.perf_counter()

    def _run(self) -> None:
        prev = time.perf_counter()
        while not self._stop.wait(self.tick_s):
            now = time.perf_counter()
            self.tick_gap_max_s = max(self.tick_gap_max_s, now - prev)
            prev = now
            step, waited = self._step, now - self._last
            if waited > self.threshold_s and step != self._seen and len(self.stalls) < self.keep:
                self._seen = step
                frame = sys._current_frames().get(self._watched)
                where = traceback.extract_stack(frame)[-8:] if frame is not None else []
                self.stalls.append({
                    "step": step, "after_s": round(waited, 3),
                    "loadavg_1m": os.getloadavg()[0],
                    "stack": [f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                              for f in where]})

    def report(self) -> Dict:
        return {"tick_gap_max_ms": round(1e3 * self.tick_gap_max_s, 3), "stalls": self.stalls}
