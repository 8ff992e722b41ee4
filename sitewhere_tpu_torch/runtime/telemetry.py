"""Opt-in instance usage telemetry — the MicroserviceAnalytics role.

Counterpart of `sitewhere_tpu/runtime/telemetry.py`.

Reference: every microservice reports lifecycle analytics — Started /
Uptime / Stopped events carrying the service identifier and version
(sitewhere-microservice MicroserviceAnalytics.java:39-77, wired to a
hard-coded Google Analytics tracking id and always on). The rebuild
keeps the capability but inverts the defaults the privacy-correct way:
OFF unless configured, and events post to the OPERATOR'S OWN endpoint
(`telemetry.endpoint`), never a third party. Payloads are lifecycle
metadata only (instance id, version, event, uptime seconds) — no device
data, no tenant data.

Config (runtime/config.py `telemetry.*`): `enabled` (default false),
`endpoint` (required when enabled), `interval_s` (uptime heartbeat
cadence, default 3600). Failures are logged at debug and never affect
the instance — telemetry is strictly best-effort, like the reference's
catch-all `warn` swallow.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.request
from typing import Optional

LOGGER = logging.getLogger("sitewhere.telemetry")


class UsageTelemetry:
    """Posts Started/Uptime/Stopped lifecycle events to a configured
    HTTP endpoint as JSON (one POST per event).

    Every POST happens on a single background worker thread — a slow or
    blackholed endpoint never sits on the boot thread (start() only
    enqueues) or the SIGTERM path (stop() enqueues the final event and
    bounds its wait; the daemon worker is abandoned past the bound)."""

    _STOP = object()

    def __init__(self, endpoint: str, instance_id: str, version: str,
                 interval_s: float = 3600.0, timeout_s: float = 5.0):
        self.endpoint = endpoint
        self.instance_id = instance_id
        self.version = version
        self.interval_s = float(interval_s)
        self.timeout_s = timeout_s
        self._started_at: Optional[float] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._started_at = time.monotonic()
        self._thread = threading.Thread(target=self._run,
                                        name="usage-telemetry", daemon=True)
        self._thread.start()
        self._queue.put("started")

    def stop(self) -> None:
        if self._thread is None:
            return
        self._queue.put("stopped")
        self._queue.put(self._STOP)
        # bounded: at worst one in-flight POST + the stopped POST; a
        # wedged endpoint abandons the daemon worker rather than holding
        # shutdown hostage
        self._thread.join(timeout=2 * self.timeout_s + 1)
        self._thread = None

    def _run(self) -> None:
        # Explicit next-heartbeat deadline: `get(timeout=interval_s)`
        # alone restarts the countdown on every enqueued event, so a
        # steady event stream silences the uptime heartbeat entirely.
        deadline = time.monotonic() + self.interval_s
        while True:
            wait = deadline - time.monotonic()
            if wait <= 0.0:
                self._send("uptime")
                deadline = time.monotonic() + self.interval_s
                continue
            try:
                item = self._queue.get(timeout=wait)
            except queue.Empty:
                self._send("uptime")
                deadline = time.monotonic() + self.interval_s
                continue
            if item is self._STOP:
                return
            self._send(item)

    # -- transport ---------------------------------------------------------
    def _send(self, event: str) -> None:
        uptime = (time.monotonic() - self._started_at
                  if self._started_at is not None else 0.0)
        payload = json.dumps({
            "instance": self.instance_id,
            "version": self.version,
            "event": event,
            "uptime_s": round(uptime, 1),
        }).encode("utf-8")
        request = urllib.request.Request(
            self.endpoint, data=payload,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(request,
                                        timeout=self.timeout_s) as rsp:
                rsp.read()
        except Exception as err:  # noqa: BLE001 — strictly best-effort:
            # nothing an endpoint does (URLError, BadStatusLine, bad
            # content) may ever affect the instance or kill this worker
            # (MicroserviceAnalytics swallows Throwable the same way)
            LOGGER.debug("usage telemetry %s not delivered: %s", event, err)


def build_from_config(cfg, instance_id: str) -> Optional[UsageTelemetry]:
    """UsageTelemetry when `telemetry.enabled` AND an endpoint is set;
    None otherwise (the default: no phone-home of any kind)."""
    if not cfg.get("telemetry.enabled"):
        return None
    endpoint = cfg.get("telemetry.endpoint")
    if not endpoint:
        LOGGER.warning("telemetry.enabled set without telemetry.endpoint; "
                       "usage telemetry stays off")
        return None
    import sitewhere_tpu_torch

    return UsageTelemetry(
        endpoint=endpoint, instance_id=instance_id,
        version=sitewhere_tpu_torch.__version__,
        interval_s=float(cfg.get("telemetry.interval_s") or 3600.0))
