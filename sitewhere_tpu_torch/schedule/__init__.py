"""Scheduling (reference: service-schedule-management)."""

from sitewhere_tpu_torch.schedule.cron import CronError, CronExpression
from sitewhere_tpu_torch.schedule.manager import (
    BatchCommandInvocationJobExecutor, CommandInvocationJobExecutor,
    ScheduleManagement, ScheduleManager)

__all__ = ["BatchCommandInvocationJobExecutor", "CommandInvocationJobExecutor",
           "CronError", "CronExpression", "ScheduleManagement",
           "ScheduleManager"]
