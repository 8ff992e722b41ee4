"""Delivery fan-out: lane-resolved command fires -> destinations.

Closes the sense->decide->act loop off device: the engine's materialize
pass resolves the step's command lane into fire records
(pipeline/engine.py `_materialize_commands`) and hands them here in the
SAME pass, so the `detection_to_actuation` age edge the flight recorder
closes after fan-out measures real delivery work — not a queue handoff.

Delivery discipline mirrors the bus consumers (commands/delivery.py):
bounded in-line retries per fire (the `command_delivery_error` fault
point arms each attempt), then the fire parks on the bounded dead-letter
list instead of blocking the step loop. Conservation is the drill-tested
invariant: ``delivered + parked + suppressed == fires handed in`` —
nothing is silently lost (tests/test_actuation.py).

Exactly-once across failover rides the replay barrier
(runtime/recovery.py): while a restored engine replays inbound rows that
were already durable before the checkpoint, the replayed steps re-fire
their policies bit-identically — rebuilding the debounce state — but the
re-resolved fires are suppressed here instead of re-delivered.

Counterpart of `sitewhere_tpu/actuation/dispatcher.py`; it attaches to the
port's engine the same way (``engine.command_dispatcher``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.runtime.bus import jittered
from sitewhere_tpu_torch.runtime.faults import fault_point
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS
from sitewhere_tpu_torch.runtime.recovery import GLOBAL_REPLAY_BARRIER

LOGGER = logging.getLogger("sitewhere.actuation")

DEFAULT_DELIVERY_RETRIES = 2
DEFAULT_MAX_PARKED = 1024


class CommandFanout:
    """Bounded-retry fan-out for actuation command fires.

    `deliver` is the transport: a callable taking one fire dict and
    raising on failure. The default is the in-memory sink (`self.sent`)
    used by tests and the bench; `deliver_via_service` adapts the full
    tenant command-delivery stack (resolve + route + encode).
    Attach an instance as ``engine.command_dispatcher`` — the engine
    calls ``dispatch(engine, fires)`` from its materialize pass.
    """

    def __init__(self, deliver: Optional[Callable[[Dict], None]] = None,
                 *, max_retries: int = DEFAULT_DELIVERY_RETRIES,
                 max_parked: int = DEFAULT_MAX_PARKED,
                 metrics=GLOBAL_METRICS, barrier=GLOBAL_REPLAY_BARRIER):
        self.deliver = deliver if deliver is not None else self._sink
        self.max_retries = int(max_retries)
        self.max_parked = int(max_parked)
        self.sent: List[Dict] = []        # default in-memory sink
        self.parked: List[Dict] = []      # dead-letter list (bounded)
        self.delivered_count = 0
        self.parked_count = 0
        self.suppressed_count = 0
        self.parked_overflow = 0
        self.retry_count = 0
        self.barrier = barrier
        self._delivered = metrics.counter("commands.delivered")
        self._parked = metrics.counter("commands.parked")
        self._suppressed = metrics.counter("commands.suppressed")

    # -- engine-facing protocol -------------------------------------------

    def dispatch(self, engine, fires: List[Dict]) -> None:
        for fire in fires:
            if (self.barrier is not None
                    and self.barrier.active(fire.get("tenant") or None)):
                # replayed step: the command already went out before the
                # checkpoint this engine restored from
                self.suppressed_count += 1
                self._suppressed.inc()
                continue
            self._deliver_one(fire)

    # -- delivery ----------------------------------------------------------

    def _deliver_one(self, fire: Dict) -> None:
        attempt = 0
        while True:
            try:
                fault_point("command_delivery_error")
                self.deliver(fire)
                self.delivered_count += 1
                self._delivered.inc()
                return
            except Exception as exc:
                attempt += 1
                if attempt > self.max_retries:
                    self._park(fire, exc)
                    return
                self.retry_count += 1
                time.sleep(jittered(0.005 * (2 ** (attempt - 1))))

    def _park(self, fire: Dict, exc: Exception) -> None:
        self.parked_count += 1
        self._parked.inc()
        LOGGER.warning(
            "command fire parked after %d attempts: policy=%s device=%s "
            "command=%s (%s); parked=%d total",
            self.max_retries + 1, fire.get("policy"), fire.get("device"),
            fire.get("command"), exc, self.parked_count)
        if len(self.parked) < self.max_parked:
            self.parked.append(dict(fire, error=str(exc)))
        else:
            # counts stay exact (parked_count above) even when the
            # dead-letter LIST is full — the overflow is loud, not silent
            self.parked_overflow += 1
            LOGGER.error(
                "dead-letter list full (%d); parked fire record dropped "
                "(parked_overflow=%d)", self.max_parked,
                self.parked_overflow)

    def _sink(self, fire: Dict) -> None:
        self.sent.append(fire)

    # -- dead-letter drain -------------------------------------------------

    def redeliver_parked(self) -> int:
        """One redelivery sweep over the dead-letter list (operator- or
        scheduler-driven). Fires that fail again re-park; returns how
        many went out."""
        parked, self.parked = self.parked, []
        ok = 0
        for fire in parked:
            fire = {k: v for k, v in fire.items() if k != "error"}
            before = self.parked_count
            self._deliver_one(fire)
            if self.parked_count == before:
                ok += 1
        return ok

    def stats(self) -> Dict[str, int]:
        return {"delivered": self.delivered_count,
                "parked": self.parked_count,
                "suppressed": self.suppressed_count,
                "retries": self.retry_count,
                "parked_overflow": self.parked_overflow,
                "dead_letter_depth": len(self.parked)}


def deliver_via_service(service) -> Callable[[Dict], None]:
    """Adapt the tenant command-delivery stack (commands/delivery.py) as
    a CommandFanout transport: fire -> DeviceCommandInvocation against
    the device's ACTIVE assignment -> resolve / route / encode / deliver.
    Raises (-> bounded retry, then dead-letter) when the device has no
    active assignment or the command token is unknown to the registry."""
    from sitewhere_tpu_torch.errors import SiteWhereError
    from sitewhere_tpu_torch.model.event import (
        CommandInitiator, DeviceCommandInvocation)

    def deliver(fire: Dict) -> None:
        device = service.registry.get_device_by_token(fire["device"])
        if device is None:
            raise SiteWhereError(f"unknown device '{fire['device']}'")
        assignment = service.registry.get_active_assignment(device.id)
        if assignment is None:
            raise SiteWhereError(
                f"device '{fire['device']}' has no active assignment")
        params = {f"p{i}": str(v)
                  for i, v in enumerate(fire.get("params", []))}
        service.deliver(DeviceCommandInvocation(
            device_id=device.id,
            initiator=CommandInitiator.SCRIPT,
            initiator_id=f"actuation:{fire['policy']}",
            target_id=assignment.token,
            command_token=fire["command"],
            parameter_values=params))

    return deliver
