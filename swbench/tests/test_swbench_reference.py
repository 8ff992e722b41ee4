"""The reference agrees with the port on the CPU at a tiny size of each
configuration, through the whole run (world, pool, warm-up, window, the
comparison); the same run on the card when there is one."""

import pytest

from swbench.tests.conftest import CELLS, tiny_spec


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_port_on_cpu(workload, cpu):
    from swbench.run import run_cell

    spec = tiny_spec(workload)
    result = run_cell(spec, 2 ** 31 + 977, 0.6, False, cpu)
    n = result["_checks"]
    assert result["correct"], n
    assert n == {"lanes": 0, "alerts": 0, "counts": 0, "state": 0,
                 "groups": 0}
    facts = result["reference"]
    assert facts["steps"] > spec["traffic"]["warmup_steps"]
    # the closed loop left at most `depth` steps run and not materialized
    assert 0 < facts["steps"] - facts["materialized"] \
        <= spec["traffic"]["depth"]
    assert facts["alerts_compared"] > 0
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert set(result["metrics"]) == e2e


def test_traced_run_reads_host_spans_on_cpu(cpu):
    from swbench.run import run_cell

    spec = tiny_spec("fleet-100k.closed")
    result = run_cell(spec, 31, 0.6, True, cpu)
    assert result["correct"]
    # no device trace on the CPU: only the host spans' readers answer
    assert set(result["metrics"]) == {"stage_wait_ms", "host_pack_ms",
                                      "materialize_ms"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from swbench.run import ROOT, load_cell, run_cell

    result = run_cell(load_cell(workload, ROOT), 12345, 2.0, False, "cuda:0")
    assert result["correct"], result["_checks"]


class _CpuTracer:
    """Stands in for swbench/trace.py's Tracer on the CPU: switches at
    its due times with no profiler, and notes which of the submitter's
    threads were alive at each switch."""

    def __init__(self, seconds: float):
        from swbench.trace import Tracer

        self.inner = Tracer(seconds, seconds / 8)
        self.alive = []

    def prime(self, device):
        pass

    def on_open(self, t0):
        self.inner.on_open(t0)

    def due(self, now):
        return self.inner.due(now)

    def running(self):
        return self.inner.running()

    def tick(self):
        self.inner.tick()

    def switch(self, stop_threads):
        import threading
        import time

        inner = self.inner
        if inner.prof is None:
            stop_threads()
            inner.prof, inner.started = object(), time.perf_counter()
        else:
            inner.stopped = time.perf_counter()
            stop_threads()
        self.alive.append([t.name for t in threading.enumerate()
                           if t.name.startswith("feed-")])

    def summary(self):
        return None


@pytest.mark.parametrize("workload", CELLS)
def test_trace_switches_with_no_thread_of_the_port_alive(workload, cpu):
    """The traced part starts and stops between two submitters, with
    every step in flight materialized first, and the run stays correct."""
    from swbench.run import run_cell

    spec = tiny_spec(workload)
    tracer = _CpuTracer(2.0)
    result = run_cell(spec, 2 ** 31 + 4099, 2.0, True, cpu, tracer=tracer)
    assert result["correct"], result["_checks"]
    assert tracer.alive == [[], []]
    assert tracer.inner.traced_steps > 0
    facts = result["reference"]
    assert 0 < facts["steps"] - facts["materialized"] \
        <= spec["traffic"]["depth"]
