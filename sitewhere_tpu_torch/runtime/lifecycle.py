"""Hierarchical component lifecycle state machine.

The port's copy of `sitewhere_tpu/runtime/lifecycle.py` (reference:
sitewhere-core-lifecycle LifecycleComponent.java:40) — components move
Initializing -> Starting -> Started -> Stopping -> Stopped (plus error/paused
states), own nested child components that are initialized/started with them and
stopped in reverse, and report progress through a monitor. CompositeLifecycleStep
mirrors CompositeLifecycleStep.java; TenantEngineLifecycleComponent's tenant
scoping is the `tenant_id` attribute here.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.errors import LifecycleError

LOGGER = logging.getLogger("sitewhere.lifecycle")


class LifecycleStatus(enum.Enum):
    INITIALIZING = "Initializing"
    INITIALIZATION_ERROR = "InitializationError"
    STOPPED = "Stopped"
    STOPPED_WITH_ERRORS = "StoppedWithErrors"
    STARTING = "Starting"
    STARTED = "Started"
    STARTED_WITH_ERRORS = "StartedWithErrors"
    PAUSING = "Pausing"
    PAUSED = "Paused"
    STOPPING = "Stopping"
    TERMINATING = "Terminating"
    TERMINATED = "Terminated"
    LIFECYCLE_ERROR = "LifecycleError"


# Statuses from which start() is legal (reference LifecycleComponent.lifecycleStart:242)
_STARTABLE = {
    LifecycleStatus.STOPPED,
    LifecycleStatus.STOPPED_WITH_ERRORS,
    LifecycleStatus.PAUSED,
}


class LifecycleProgressMonitor:
    """Collects progress messages during lifecycle transitions
    (reference: LifecycleProgressMonitor.java)."""

    def __init__(self, task_name: str = ""):
        self.task_name = task_name
        self.messages: List[str] = []

    def report(self, message: str) -> None:
        self.messages.append(message)
        LOGGER.debug("[%s] %s", self.task_name, message)


class LifecycleComponent:
    """Base class for every managed component in the framework.

    Subclasses override `on_initialize` / `on_start` / `on_stop` /
    `on_terminate`. Nested components registered with `add_nested` are
    initialized+started after the parent's hook and stopped in reverse order
    before the parent's stop hook, matching the reference's
    initializeNestedComponent/startNestedComponent flow
    (LifecycleComponent.java:218+).
    """

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.status = LifecycleStatus.STOPPED
        self.error: Optional[BaseException] = None
        self.tenant_id: Optional[str] = None  # set for tenant-engine-scoped components
        self.created_at = time.time()
        self._nested: List[LifecycleComponent] = []
        self._lock = threading.RLock()
        self._initialized = False

    # -- composition ---------------------------------------------------------

    def add_nested(self, component: "LifecycleComponent") -> "LifecycleComponent":
        with self._lock:
            self._nested.append(component)
            if component.tenant_id is None:
                component.tenant_id = self.tenant_id
        return component

    @property
    def nested(self) -> List["LifecycleComponent"]:
        return list(self._nested)

    def find(self, name: str) -> Optional["LifecycleComponent"]:
        """Depth-first lookup by component name."""
        if self.name == name:
            return self
        for child in self._nested:
            found = child.find(name)
            if found is not None:
                return found
        return None

    # -- hooks (override) ----------------------------------------------------

    def on_initialize(self, monitor: LifecycleProgressMonitor) -> None:
        pass

    def on_start(self, monitor: LifecycleProgressMonitor) -> None:
        pass

    def on_stop(self, monitor: LifecycleProgressMonitor) -> None:
        pass

    def on_terminate(self, monitor: LifecycleProgressMonitor) -> None:
        pass

    # -- transitions ---------------------------------------------------------

    def initialize(self, monitor: Optional[LifecycleProgressMonitor] = None) -> None:
        monitor = monitor or LifecycleProgressMonitor(f"Initialize {self.name}")
        with self._lock:
            self.status = LifecycleStatus.INITIALIZING
            try:
                monitor.report(f"Initializing {self.name}")
                self.on_initialize(monitor)
                for child in self._nested:
                    child.initialize(monitor)
                self._initialized = True
                self.status = LifecycleStatus.STOPPED
            except BaseException as exc:
                self.error = exc
                self.status = LifecycleStatus.INITIALIZATION_ERROR
                raise LifecycleError(f"{self.name} failed to initialize: {exc}") from exc

    def start(self, monitor: Optional[LifecycleProgressMonitor] = None) -> None:
        monitor = monitor or LifecycleProgressMonitor(f"Start {self.name}")
        with self._lock:
            if self.status == LifecycleStatus.STARTED:
                return
            if not self._initialized:
                self.initialize(monitor)
            if self.status not in _STARTABLE:
                raise LifecycleError(
                    f"Cannot start {self.name} from status {self.status.value}")
            self.status = LifecycleStatus.STARTING
            try:
                monitor.report(f"Starting {self.name}")
                self.on_start(monitor)
                errors = []
                for child in self._nested:
                    try:
                        child.start(monitor)
                    except BaseException as exc:  # reference: StartedWithErrors
                        errors.append(exc)
                        LOGGER.exception("Nested component %s failed to start", child.name)
                self.status = (LifecycleStatus.STARTED_WITH_ERRORS if errors
                               else LifecycleStatus.STARTED)
            except BaseException as exc:
                self.error = exc
                self.status = LifecycleStatus.LIFECYCLE_ERROR
                raise LifecycleError(f"{self.name} failed to start: {exc}") from exc

    def stop(self, monitor: Optional[LifecycleProgressMonitor] = None) -> None:
        monitor = monitor or LifecycleProgressMonitor(f"Stop {self.name}")
        with self._lock:
            if self.status in (LifecycleStatus.STOPPED, LifecycleStatus.TERMINATED):
                return
            self.status = LifecycleStatus.STOPPING
            errors = []
            for child in reversed(self._nested):
                try:
                    child.stop(monitor)
                except BaseException as exc:
                    errors.append(exc)
                    LOGGER.exception("Nested component %s failed to stop", child.name)
            try:
                monitor.report(f"Stopping {self.name}")
                self.on_stop(monitor)
            except BaseException as exc:
                errors.append(exc)
                LOGGER.exception("Component %s failed to stop", self.name)
            self.status = (LifecycleStatus.STOPPED_WITH_ERRORS if errors
                           else LifecycleStatus.STOPPED)

    def terminate(self, monitor: Optional[LifecycleProgressMonitor] = None) -> None:
        monitor = monitor or LifecycleProgressMonitor(f"Terminate {self.name}")
        with self._lock:
            if self.status not in (LifecycleStatus.STOPPED,
                                   LifecycleStatus.STOPPED_WITH_ERRORS):
                self.stop(monitor)
            self.status = LifecycleStatus.TERMINATING
            for child in reversed(self._nested):
                child.terminate(monitor)
            self.on_terminate(monitor)
            self.status = LifecycleStatus.TERMINATED

    def restart(self) -> None:
        """Stop + start (reference: tenant-engine restart,
        MultitenantMicroservice.java:284)."""
        self.stop()
        self.start()

    # -- introspection -------------------------------------------------------

    def is_running(self) -> bool:
        return self.status in (LifecycleStatus.STARTED,
                               LifecycleStatus.STARTED_WITH_ERRORS)

    def state_tree(self) -> Dict:
        """Serializable status snapshot of this subtree (feeds the topology
        broadcast, reference: IMicroserviceState)."""
        return {
            "name": self.name,
            "status": self.status.value,
            "tenantId": self.tenant_id,
            "error": str(self.error) if self.error else None,
            "nested": [c.state_tree() for c in self._nested],
        }


class CompositeLifecycleStep:
    """Ordered list of named lifecycle actions run under one monitor
    (reference: CompositeLifecycleStep.java)."""

    def __init__(self, name: str):
        self.name = name
        self._steps: List[tuple] = []

    def add(self, description: str, action: Callable[[], None]) -> None:
        self._steps.append((description, action))

    def add_initialize(self, component: LifecycleComponent) -> None:
        self.add(f"Initialize {component.name}", component.initialize)

    def add_start(self, component: LifecycleComponent) -> None:
        self.add(f"Start {component.name}", component.start)

    def add_stop(self, component: LifecycleComponent) -> None:
        self.add(f"Stop {component.name}", component.stop)

    def execute(self, monitor: Optional[LifecycleProgressMonitor] = None) -> None:
        monitor = monitor or LifecycleProgressMonitor(self.name)
        for description, action in self._steps:
            monitor.report(description)
            action()
