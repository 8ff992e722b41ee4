"""The traced run's device trace: `torch.profiler` (CUPTI) over a part of
the window, summarised in memory.

The profiler is started once in set-up to pay its start-up there, and
over the window it starts and stops only while no thread of the port
runs and the card is idle (`Tracer.switch`, called by swbench/drive.py
between two submitters). It records device activity only, and is
reduced to the device time of each kernel name, the union of the
device's busy intervals and the longest idle gaps, each named by the
kernel that ended it. The device-profile idea is chip_smoke.py
`device_profile` / `profile_engine`, with busy time taken as the union
of intervals instead of a sum.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

TOP = 10


class Tracer:
    """Profiles about [t0 + lead, t0 + lead + length) of the window.
    `prime`, called before anything of the port is built, starts and
    stops a profiler over one small operation and throws its trace away,
    so that the profiler's own start-up is paid in set-up and not inside
    the window. Counts the steps materialized while the profiler ran, and
    the time the switches took outside the profiled part, to set the
    traced rate beside the rest of the window's."""

    def __init__(self, seconds: float, length: float):
        self.length = min(length, seconds / 2)
        self.lead = max(0.0, (seconds - self.length) / 2)
        self.start_at: Optional[float] = None
        self.prof = None
        self.started = self.stopped = None
        self.traced_steps = 0
        self.switch_s = 0.0

    @staticmethod
    def _profiler():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def prime(self, device) -> None:
        import torch

        prof = self._profiler()
        prof.start()
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        prof.stop()

    def on_open(self, t0: float) -> None:
        self.start_at = t0 + self.lead

    def due(self, now: float) -> bool:
        """Whether the profiler should start, or stop, at `now`."""
        if self.start_at is None or self.stopped is not None:
            return False
        if self.prof is None:
            return now >= self.start_at
        return now >= self.started + self.length

    def running(self) -> bool:
        return self.prof is not None and self.stopped is None

    def tick(self) -> None:
        """A step was materialized."""
        if self.running():
            self.traced_steps += 1

    def switch(self, stop_threads: Callable[[], None]) -> None:
        """Starts or stops the profiler. Called with every step
        materialized; `stop_threads` stops the port's threads, so the
        profiler is switched on or off with the card idle and only the
        caller's thread alive. The profiled part runs from the start to
        the moment the card is idle before the stop."""
        import torch

        t = time.perf_counter()
        torch.cuda.synchronize()
        if self.prof is None:
            stop_threads()
            self.prof = self._profiler()
            self.prof.start()
            self.started = time.perf_counter()
            self.switch_s += self.started - t
        else:
            self.stopped = time.perf_counter()
            stop_threads()
            self.prof.stop()
            self.switch_s += time.perf_counter() - self.stopped

    def summary(self) -> Optional[Dict]:
        """Kernel name -> [device seconds, count]; busy_s (union of the
        device intervals), window_s (host wall of the profiled part),
        the longest idle gaps; None when nothing was profiled."""
        if self.prof is None or self.stopped is None:
            return None
        from torch.autograd import DeviceType

        spans = []
        kernels: Dict[str, List[float]] = {}
        for e in self.prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            t0, t1 = e.time_range.start, e.time_range.end   # us
            if t1 <= t0:
                continue
            spans.append((t0, t1, e.name))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (t1 - t0) * 1e-6
            k[1] += 1
        if not spans:
            return None
        spans.sort()
        busy, gaps = 0.0, []
        cur0, cur1 = spans[0][0], spans[0][1]
        for t0, t1, name in spans[1:]:
            if t0 > cur1:
                busy += cur1 - cur0
                gaps.append(((t0 - cur1) * 1e-6, name))
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        busy += cur1 - cur0
        gaps.sort(key=lambda g: -g[0])
        named: Dict[str, float] = {}
        for secs, name in gaps:
            key = f"before {name[:80]}"
            named[key] = max(named.get(key, 0.0), secs)
        return {
            "kernels": kernels,
            "busy_s": busy * 1e-6,
            "window_s": self.stopped - self.started,
            "traced_steps": self.traced_steps,
            "switch_s": self.switch_s,
            "idle_gaps": sorted(named.items(), key=lambda g: -g[1])[:TOP],
            "device_ops": sorted(((n, v[0]) for n, v in kernels.items()),
                                 key=lambda g: -g[1])[:TOP],
        }


def kernel_stats(trace: Dict, needle: str):
    """(total device seconds, launches) of kernels whose name holds
    `needle`."""
    total, count = 0.0, 0
    for name, (secs, n) in trace["kernels"].items():
        if needle in name:
            total += secs
            count += n
    return total, count
