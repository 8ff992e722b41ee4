"""Device presence management: background sweep marking missing devices.

Reference: service-device-state presence/DevicePresenceManager.java:47 — a
PresenceChecker thread (:110-135) periodically scans device state for devices
whose last interaction exceeds the missing interval and fires a
PresenceState.NOT_PRESENT state change through PresenceNotificationStrategies
(send-once semantics).

Counterpart of `sitewhere_tpu/pipeline/presence.py`. The scan is not a
datastore query: it is the engine's `presence_sweep` — `check_presence` over
the device-state tensors on the card (pipeline/state_tensors.py), copied
into the resident state in place — which returns only newly-missing rows,
giving send-once for free. This component is just the cadence + the
state-change event fan-out.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

from sitewhere_tpu_torch.model.event import DeviceStateChange
from sitewhere_tpu_torch.model.state import PresenceState
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

LOGGER = logging.getLogger("sitewhere.presence")


class DevicePresenceManager(LifecycleComponent):
    """Periodic presence sweep over a PipelineEngine's state tensors.

    `events` (DeviceEventManagement, optional) persists NOT_PRESENT state
    changes; `registry` resolves assignments for them. Additional callbacks
    registered with `add_listener` receive the newly-missing token list —
    the PresenceNotificationStrategy extension point.
    """

    def __init__(self, engine, registry=None, events=None,
                 check_interval_s: float = 60.0,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__("presence-manager")
        self.engine = engine
        self.registry = registry
        self.events = events
        self.check_interval_s = check_interval_s
        self._listeners: List[Callable[[List[str]], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        m = (metrics or MetricsRegistry()).scoped("presence")
        self.missing_counter = m.counter("marked_missing")

    def add_listener(self, callback: Callable[[List[str]], None]) -> None:
        self._listeners.append(callback)

    def on_start(self, monitor) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="presence-checker", daemon=True)
        self._thread.start()

    def on_stop(self, monitor) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.sweep()
            except Exception:
                LOGGER.exception("presence sweep failed")

    def sweep(self) -> List[str]:
        """One pass; returns tokens newly marked missing. Public so tests and
        schedulers can drive it synchronously."""
        missing = self.engine.presence_sweep()
        if not missing:
            return missing
        self.missing_counter.inc(len(missing))
        if self.events is not None and self.registry is not None:
            for token in missing:
                device = self.registry.get_device_by_token(token)
                if device is None:
                    continue
                assignment = self.registry.get_active_assignment(device.id)
                if assignment is None:
                    continue
                self.events.add_state_changes(assignment.token, DeviceStateChange(
                    device_id=token, attribute="presence", type="presence",
                    previous_state=PresenceState.PRESENT.name,
                    new_state=PresenceState.NOT_PRESENT.name))
        for callback in self._listeners:
            callback(missing)
        return missing
