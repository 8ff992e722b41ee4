"""Gang-restart supervision for cluster serve processes.

Counterpart of `sitewhere_tpu/runtime/supervisor.py`. The reference
recovers a lost microservice process with zero operator action: Kafka
consumer-group rebalance hands its partitions to the survivors
(sitewhere-microservice kafka/MicroserviceKafkaConsumer.java:88) and
topology-reactive gRPC channels re-route (sitewhere-grpc-client
ApiDemux.java:183-227). Here a per-host supervisor restarts its serve child
after any abnormal exit, and the child rebuilds from durable state
(checkpoint + committed-offset replay); in the control-plane cluster
(parallel/cluster.py ControlPlaneCluster) the survivors keep serving
meanwhile.

`python -m sitewhere_tpu_torch serve --supervise ...` wraps the serve
process in this loop (tests/test_torch_supervisor.py;
tests/test_torch_provisioning_cluster.py drills kill-1-of-3).

Restart policy: restart on ANY abnormal exit (peer-loss code, crash,
signal); exit 0 is a graceful shutdown and ends supervision. A child
that keeps dying faster than `min_uptime_s` is broken (bad flags,
unbindable port), not failed — after `max_fast_fails` consecutive fast
deaths the supervisor gives up with the child's exit code.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

_PREFIX = "supervisor:"


class Supervisor:
    """Restart-on-abnormal-exit loop around one child command."""

    def __init__(self, child_argv: List[str], backoff_s: float = 1.0,
                 min_uptime_s: float = 5.0, max_fast_fails: int = 10):
        self.child_argv = list(child_argv)
        self.backoff_s = backoff_s
        self.min_uptime_s = min_uptime_s
        self.max_fast_fails = max_fast_fails
        self._stopping = threading.Event()
        self._stop_signum = signal.SIGTERM
        self._child: Optional[subprocess.Popen] = None

    def _log(self, msg: str) -> None:
        print(f"{_PREFIX} {msg}", flush=True)

    def _forward(self, signum, _frame) -> None:
        """First signal: graceful — forward to the child and stop
        supervising once it exits. Second signal: restore the default
        disposition so the operator can force-kill a hung shutdown
        (mirrors __main__._install_stop_handlers)."""
        self._stop_signum = signum
        self._stopping.set()
        signal.signal(signum, signal.SIG_DFL)
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signum)
            except OSError:
                pass

    def run(self) -> int:
        signal.signal(signal.SIGTERM, self._forward)
        signal.signal(signal.SIGINT, self._forward)
        fast_fails = 0
        attempt = 0
        while True:
            # a stop signal that landed between children (child is None
            # or already reaped) must not spawn another one
            if self._stopping.is_set():
                return 0
            attempt += 1
            started = time.monotonic()
            # child inherits stdout/stderr: the serve banner (REST/bus
            # ports) stays visible to operators and drill tests
            self._child = subprocess.Popen(self.child_argv)
            self._log(f"child pid={self._child.pid} started "
                      f"(attempt {attempt})")
            if self._stopping.is_set():
                # stop signal raced the spawn: the handler saw the old
                # child (or None) — forward to the fresh one ourselves
                try:
                    self._child.send_signal(self._stop_signum)
                except OSError:
                    pass
            rc = self._child.wait()
            uptime = time.monotonic() - started
            if self._stopping.is_set():
                self._log(f"child exited rc={rc} during shutdown")
                return rc if rc is not None else 0
            if rc == 0:
                self._log("child exited cleanly; supervision complete")
                return 0
            if uptime < self.min_uptime_s:
                fast_fails += 1
                if fast_fails >= self.max_fast_fails:
                    self._log(
                        f"child died {fast_fails}x within "
                        f"{self.min_uptime_s:.0f}s (last rc={rc}); "
                        f"giving up")
                    return rc
            else:
                fast_fails = 0
            self._log(f"child exited rc={rc} after {uptime:.1f}s; "
                      f"restarting in {self.backoff_s:.1f}s")
            # interruptible backoff: a SIGTERM during the wait must not
            # spawn another child
            if self._stopping.wait(self.backoff_s):
                return 0


def supervise_serve(argv: List[str], backoff_s: float = 1.0,
                    min_uptime_s: float = 5.0,
                    max_fast_fails: int = 10) -> int:
    """Re-exec this interpreter's serve command (argv WITHOUT
    --supervise) under a Supervisor."""
    child_argv = [sys.executable, "-m", "sitewhere_tpu_torch"] + list(argv)
    return Supervisor(child_argv, backoff_s=backoff_s,
                      min_uptime_s=min_uptime_s,
                      max_fast_fails=max_fast_fails).run()
