"""The timed window: the port's PipelinedSubmitter, each step's alerts
materialized in order on the caller's thread (the pattern of
chip_smoke.py `run_pipelined`), in a closed loop: the caller keeps
`depth` steps submitted and not yet materialized, and the window counts
the events of every step whose alerts were materialized inside it.

Each step's counts of materialized and dropped alerts are kept; the steps
the answer sample selects (k % every == offset, drawn from the seed) also
keep their alert and command lanes, alerts and command fires for the
check.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List

from swbench.traffic import batch_for_step


@dataclasses.dataclass
class Record:
    """What the port answered."""

    n_steps: int = 0                      # steps materialized
    n_submitted: int = 0                  # steps the engine ran
    n_alerts: List[int] = dataclasses.field(default_factory=list)
    n_dropped: List[int] = dataclasses.field(default_factory=list)
    kept: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    t0: float = 0.0                       # window opens
    close: float = 0.0                    # window closes
    warmup: int = 0
    window_steps: int = 0                 # materialized inside the window
    alerts_dropped: int = 0               # the engine's counters after it
    batches_processed: int = 0


def alert_key(a) -> tuple:
    return (a.device_id, int(a.source), int(a.level), a.type, a.message,
            int(a.event_date))


class _Stepper:
    """Consumes steps in order: materializes each, keeps its answers."""

    def __init__(self, engine, stateful: bool, every: int, offset: int,
                 rec: Record):
        self.engine, self.stateful = engine, stateful
        self.every, self.offset, self.rec = every, offset, rec

    def consume(self, k: int, batch, fut, timeout: float) -> float:
        out = fut.result(timeout=timeout)
        dropped = self.engine.alerts_dropped
        alerts = self.engine.materialize_alerts(batch, out)
        fires = self.engine.take_command_fires() if self.stateful else None
        t = time.perf_counter()
        self.rec.n_alerts.append(len(alerts))
        self.rec.n_dropped.append(self.engine.alerts_dropped - dropped)
        if k % self.every == self.offset:
            self.rec.kept[k] = {
                "lanes": out.alert_lanes.cpu().numpy(),
                "cmd_lanes": out.command_lanes.cpu().numpy(),
                "alerts": [alert_key(a) for a in alerts],
                "fires": fires}
        return t


def run_closed(engine, traffic, pool, batches, seconds: float, stateful,
               every: int, offset: int, tracer=None) -> Record:
    """Warm-up steps, then a closed-loop window of `seconds`. At most
    `depth` steps are submitted and not yet materialized: step k + depth
    is submitted once step k is materialized, so the loop runs at the pace
    of its slowest stage and nothing piles up behind it. The steps still
    in flight when the window closes are finished by the submitter's
    flush (they are in the device state) and not materialized.

    With a `tracer` (swbench/trace.py), the profiler starts and stops
    only while no thread of the port runs: the steps in flight are
    materialized (inside the window, counted as usual), the submitter's
    threads are stopped, the profiler is switched, and a new submitter
    fills the loop again. CUPTI switched on or off while other threads
    launch work or wait on the card can hang the process."""
    from sitewhere_tpu_torch.pipeline.feed import PipelinedSubmitter

    rec = Record(warmup=traffic["warmup_steps"])
    stepper = _Stepper(engine, stateful, every, offset, rec)
    inflight: deque = deque()
    sub = None

    def submit() -> None:
        k = rec.n_submitted
        b = batch_for_step(k, traffic, pool, batches)
        inflight.append((k, b, sub.submit(b)))
        rec.n_submitted = k + 1

    def open_submitter() -> None:
        nonlocal sub
        sub = PipelinedSubmitter(engine, depth=traffic["depth"],
                                 stagers=traffic["stagers"])
        for _ in range(traffic["depth"]):
            submit()

    def close_submitter() -> None:
        nonlocal sub
        try:
            sub.flush(timeout=120)
        finally:
            sub.close()
            sub = None

    def step() -> bool:
        """Materializes the next step; False once the window has closed."""
        t = stepper.consume(*inflight.popleft(), timeout=120)
        if t > rec.close:
            return False
        rec.window_steps += 1
        if tracer is not None:
            tracer.tick()
        return True

    try:
        open_submitter()
        for _ in range(rec.warmup):
            stepper.consume(*inflight.popleft(), timeout=600)
            submit()
        rec.t0 = time.perf_counter()
        rec.close = rec.t0 + seconds
        if tracer is not None:
            tracer.on_open(rec.t0)
        while step():
            if tracer is None or not tracer.due(time.perf_counter()):
                submit()
                continue
            open_ = True
            while inflight and open_:
                open_ = step()
            if not open_:
                break
            tracer.switch(close_submitter)
            open_submitter()
    finally:
        if sub is not None:
            close_submitter()
        if tracer is not None and tracer.running():
            # the window closed inside the profiled part
            tracer.switch(lambda: None)
    rec.n_steps = len(rec.n_alerts)
    return rec
