"""Schedule management: CRUD + trigger engine + job execution.

Reference: service-schedule-management — QuartzScheduleManager.java wires
ISchedule triggers (cron/simple) to jobs (jobs/CommandInvocationJob.java,
jobs/BatchCommandInvocationJob.java) that fire command invocations through
event management. Here the Quartz scheduler is a single timer thread
computing next-fire times from CronExpression / simple intervals.
"""

from __future__ import annotations

import heapq
import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.common import (
    SearchCriteria, SearchResults, now_ms)
from sitewhere_tpu_torch.model.event import (
    CommandInitiator, CommandTarget, DeviceCommandInvocation)
from sitewhere_tpu_torch.model.schedule import (
    JobConstants, Schedule, ScheduledJob, ScheduledJobState, ScheduledJobType,
    TriggerConstants, TriggerType)
from sitewhere_tpu_torch.registry.store import InMemoryStore, _Collection
from sitewhere_tpu_torch.schedule.cron import CronExpression
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

LOGGER = logging.getLogger("sitewhere.schedule")


class ScheduleManagement:
    """Persistence API (IScheduleManagement)."""

    def __init__(self, store=None):
        store = store or InMemoryStore()
        self.schedules: _Collection[Schedule] = _Collection(
            "schedule", Schedule, store, ErrorCode.INVALID_SCHEDULE_TOKEN)
        self.jobs: _Collection[ScheduledJob] = _Collection(
            "scheduled_job", ScheduledJob, store,
            ErrorCode.INVALID_SCHEDULE_TOKEN)

    def create_schedule(self, schedule: Schedule) -> Schedule:
        if schedule.trigger_type == TriggerType.CRON:
            # validate eagerly, like Quartz does at scheduling time
            CronExpression(schedule.trigger_configuration.get(
                TriggerConstants.CRON_EXPRESSION, ""))
        return self.schedules.create(schedule)

    def get_schedule_by_token(self, token: str) -> Schedule:
        return self.schedules.require_by_token(token)

    def list_schedules(self, criteria: Optional[SearchCriteria] = None
                       ) -> SearchResults[Schedule]:
        return self.schedules.list(criteria)

    def delete_schedule(self, token: str) -> Schedule:
        entity = self.schedules.require_by_token(token)
        return self.schedules.delete(entity.id)

    def create_scheduled_job(self, job: ScheduledJob) -> ScheduledJob:
        self.schedules.require_by_token(job.schedule_token)
        return self.jobs.create(job)

    def get_scheduled_job_by_token(self, token: str) -> ScheduledJob:
        return self.jobs.require_by_token(token)

    def list_scheduled_jobs(self, criteria: Optional[SearchCriteria] = None
                            ) -> SearchResults[ScheduledJob]:
        return self.jobs.list(criteria)

    def delete_scheduled_job(self, token: str) -> ScheduledJob:
        entity = self.jobs.require_by_token(token)
        return self.jobs.delete(entity.id)


class CommandInvocationJobExecutor:
    """jobs/CommandInvocationJob.java: fire one command invocation from
    job configuration (assignment token, command token, param_* values)."""

    def __init__(self, registry, events):
        self.registry = registry
        self.events = events

    def execute(self, job: ScheduledJob) -> None:
        config = job.job_configuration
        assignment_token = config.get(JobConstants.ASSIGNMENT_TOKEN, "")
        command_token = config.get(JobConstants.COMMAND_TOKEN, "")
        parameters = {k[len(JobConstants.PARAMETER_PREFIX):]: v
                      for k, v in config.items()
                      if k.startswith(JobConstants.PARAMETER_PREFIX)}
        self.events.add_command_invocations(
            assignment_token, DeviceCommandInvocation(
                initiator=CommandInitiator.SCHEDULER, initiator_id=job.token,
                target=CommandTarget.ASSIGNMENT, target_id=assignment_token,
                command_token=command_token, parameter_values=parameters))


class BatchCommandInvocationJobExecutor:
    """jobs/BatchCommandInvocationJob.java: materialize + run a batch
    command invocation across devices selected by criteria_* filters."""

    def __init__(self, registry, batch_manager, batch_management):
        self.registry = registry
        self.batch_manager = batch_manager
        self.batch = batch_management

    def _select_devices(self, config: Dict[str, str]) -> List[str]:
        device_type_token = config.get(
            JobConstants.CRITERIA_PREFIX + "deviceTypeToken", "")
        tokens = []
        for device in self.registry.devices.all():
            if device_type_token:
                dtype = self.registry.get_device_type(device.device_type_id)
                if dtype is None or dtype.token != device_type_token:
                    continue
            tokens.append(device.token)
        return tokens

    def execute(self, job: ScheduledJob) -> None:
        from sitewhere_tpu_torch.batch.manager import batch_command_invocation_request
        config = job.job_configuration
        parameters = {k[len(JobConstants.PARAMETER_PREFIX):]: v
                      for k, v in config.items()
                      if k.startswith(JobConstants.PARAMETER_PREFIX)}
        operation = batch_command_invocation_request(
            config.get(JobConstants.COMMAND_TOKEN, ""), parameters,
            self._select_devices(config))
        self.batch.create_batch_operation(operation, self.registry)
        self.batch_manager.process(operation)


class ScheduleManager(LifecycleComponent):
    """Trigger engine (QuartzScheduleManager equivalent): one timer thread,
    min-heap of (next_fire_ms, job_token)."""

    def __init__(self, management: ScheduleManagement,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__("schedule-manager")
        self.management = management
        self.executors: Dict[ScheduledJobType, object] = {}
        self._heap: List[Tuple[int, int, str]] = []  # (fire_ms, seq, token)
        self._fired_count: Dict[str, int] = {}
        self._seq = 0
        self._cv = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        m = (metrics or MetricsRegistry()).scoped("schedule")
        self.fired_counter = m.counter("jobs_fired")
        self.failed_counter = m.counter("jobs_failed")

    def register_executor(self, job_type: ScheduledJobType,
                          executor) -> None:
        self.executors[job_type] = executor

    # -- scheduling --------------------------------------------------------
    def _next_fire(self, schedule: Schedule, after_ms: int,
                   fired: int) -> Optional[int]:
        start = schedule.start_date or 0
        after_ms = max(after_ms, start - 1)
        if schedule.trigger_type == TriggerType.CRON:
            expression = CronExpression(schedule.trigger_configuration.get(
                TriggerConstants.CRON_EXPRESSION, ""))
            fire = expression.next_fire(after_ms)
        else:
            interval = int(schedule.trigger_configuration.get(
                TriggerConstants.REPEAT_INTERVAL, "0"))
            repeat = int(schedule.trigger_configuration.get(
                TriggerConstants.REPEAT_COUNT, "-1"))
            if repeat >= 0 and fired > repeat:
                return None
            if fired == 0:
                fire = max(start, after_ms + 1) if start else after_ms + 1
            elif interval <= 0:
                return None
            else:
                fire = after_ms + interval
        if schedule.end_date and fire > schedule.end_date:
            return None
        return fire

    def submit(self, job: ScheduledJob) -> None:
        """Activate a job (scheduleJob in the reference)."""
        schedule = self.management.get_schedule_by_token(job.schedule_token)
        fire = self._next_fire(schedule, now_ms(), 0)
        if fire is None:
            return
        self.management.jobs.update(
            job.id, {"job_state": ScheduledJobState.ACTIVE})
        with self._cv:
            self._seq += 1
            self._fired_count[job.token] = 0
            heapq.heappush(self._heap, (fire, self._seq, job.token))
            self._cv.notify()

    def unschedule(self, job_token: str) -> None:
        with self._cv:
            self._heap = [(f, s, t) for f, s, t in self._heap
                          if t != job_token]
            heapq.heapify(self._heap)

    # -- lifecycle ---------------------------------------------------------
    def on_start(self, monitor) -> None:
        self._stop = False
        self._thread = threading.Thread(target=self._run, name="scheduler",
                                        daemon=True)
        self._thread.start()
        # resubmit jobs that were active before restart
        for job in self.management.jobs.all():
            if job.job_state == ScheduledJobState.ACTIVE:
                self.submit(job)

    def on_stop(self, monitor) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- engine ------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                now = now_ms()
                if not self._heap:
                    self._cv.wait(1.0)
                    continue
                fire, _, token = self._heap[0]
                if fire > now:
                    self._cv.wait(min((fire - now) / 1000.0, 1.0))
                    continue
                heapq.heappop(self._heap)
            self._fire_job(token, fire)

    def _fire_job(self, token: str, fire_ms: int) -> None:
        job = self.management.jobs.get_by_token(token)
        if job is None or job.job_state != ScheduledJobState.ACTIVE:
            return
        executor = self.executors.get(job.job_type)
        if executor is None:
            self.failed_counter.inc()
            LOGGER.warning("no executor for job type %s", job.job_type)
            return
        try:
            executor.execute(job)
            self.fired_counter.inc()
        except Exception:
            self.failed_counter.inc()
            LOGGER.exception("scheduled job %s failed", token)
        fired = self._fired_count.get(token, 0) + 1
        self._fired_count[token] = fired
        schedule = self.management.schedules.get_by_token(job.schedule_token)
        next_fire = (self._next_fire(schedule, fire_ms, fired)
                     if schedule else None)
        if next_fire is None:
            self.management.jobs.update(
                job.id, {"job_state": ScheduledJobState.COMPLETE})
            return
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, (next_fire, self._seq, token))
            self._cv.notify()
