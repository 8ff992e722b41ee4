"""Scheduling model (sitewhere-core-api spi/scheduling/ISchedule.java,
IScheduledJob.java): cron/simple triggers firing command invocations, replacing
the reference's Quartz integration (QuartzScheduleManager.java)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional

from sitewhere_tpu_torch.model.common import PersistentEntity


class TriggerType(enum.Enum):
    CRON = "CronTrigger"
    SIMPLE = "SimpleTrigger"


class TriggerConstants:
    """Keys into Schedule.trigger_configuration (reference TriggerConstants)."""

    CRON_EXPRESSION = "cronExpression"  # 5-field cron
    REPEAT_INTERVAL = "repeatInterval"  # ms between firings (simple trigger)
    REPEAT_COUNT = "repeatCount"  # -1 = forever


class ScheduledJobType(enum.Enum):
    COMMAND_INVOCATION = "CommandInvocation"
    BATCH_COMMAND_INVOCATION = "BatchCommandInvocation"
    # unattended drift-refit sweeps (actuation/refit.py
    # DriftRefitJobExecutor) — no reference analogue; the adaptation
    # loop closed in-platform needs its own trigger type
    DRIFT_REFIT = "DriftRefit"


class ScheduledJobState(enum.Enum):
    UNSUBMITTED = "Unsubmitted"
    ACTIVE = "Active"
    COMPLETE = "Complete"


class JobConstants:
    """Keys into ScheduledJob.job_configuration (reference JobConstants)."""

    ASSIGNMENT_TOKEN = "assignmentToken"
    COMMAND_TOKEN = "commandToken"
    PARAMETER_PREFIX = "param_"
    CRITERIA_PREFIX = "criteria_"


@dataclass
class Schedule(PersistentEntity):
    """When to run (ISchedule)."""

    name: str = ""
    trigger_type: TriggerType = TriggerType.SIMPLE
    trigger_configuration: Dict[str, str] = field(default_factory=dict)
    start_date: Optional[int] = None
    end_date: Optional[int] = None


@dataclass
class ScheduledJob(PersistentEntity):
    """What to run on a schedule (IScheduledJob)."""

    schedule_token: str = ""
    job_type: ScheduledJobType = ScheduledJobType.COMMAND_INVOCATION
    job_configuration: Dict[str, str] = field(default_factory=dict)
    job_state: ScheduledJobState = ScheduledJobState.UNSUBMITTED
