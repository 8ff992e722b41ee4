"""5-field cron expression parser + next-fire computation.

Replaces the Quartz trigger engine behind the reference's
QuartzScheduleManager (service-schedule-management). Supports the standard
minute/hour/day-of-month/month/day-of-week grammar: ``*``, lists ``1,2,3``,
ranges ``1-5``, and steps ``*/15`` / ``2-10/2``. Day-of-week 0 and 7 both
mean Sunday.
"""

from __future__ import annotations

import calendar
from datetime import datetime, timedelta
from typing import List, Set


class CronError(ValueError):
    pass


_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 7)]


def _parse_field(spec: str, lo: int, hi: int) -> Set[int]:
    values: Set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise CronError(f"bad step '{step_s}'")
            if step < 1:
                raise CronError(f"bad step {step}")
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            try:
                start, end = int(a), int(b)
            except ValueError:
                raise CronError(f"bad range '{part}'")
        else:
            try:
                start = end = int(part)
            except ValueError:
                raise CronError(f"bad value '{part}'")
        if start < lo or end > hi or start > end:
            raise CronError(f"value out of range [{lo},{hi}]: '{part}'")
        values.update(range(start, end + 1, step))
    return values


class CronExpression:
    def __init__(self, expression: str):
        fields = expression.split()
        if len(fields) != 5:
            raise CronError(
                f"expected 5 fields (min hour dom mon dow), got '{expression}'")
        self.expression = expression
        parsed: List[Set[int]] = []
        for spec, (lo, hi) in zip(fields, _FIELD_RANGES):
            parsed.append(_parse_field(spec, lo, hi))
        self.minutes, self.hours, self.dom, self.months, dow = parsed
        self.dow = {d % 7 for d in dow}  # 7 == 0 == Sunday
        # standard cron: if both dom and dow are restricted, either matches
        self.dom_restricted = self.dom != set(range(1, 32))
        self.dow_restricted = self.dow != set(range(0, 7))

    def _day_matches(self, when: datetime) -> bool:
        # Python weekday(): Monday=0; cron: Sunday=0
        cron_dow = (when.weekday() + 1) % 7
        dom_ok = when.day in self.dom
        dow_ok = cron_dow in self.dow
        if self.dom_restricted and self.dow_restricted:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def matches(self, when: datetime) -> bool:
        return (when.minute in self.minutes and when.hour in self.hours
                and when.month in self.months and self._day_matches(when))

    def next_fire(self, after_ms: int) -> int:
        """Next firing time (epoch ms) strictly after `after_ms`."""
        when = datetime.fromtimestamp(after_ms / 1000.0)
        when = when.replace(second=0, microsecond=0) + timedelta(minutes=1)
        # bounded scan: cron repeats within 4 years (leap cycle)
        for _ in range(4 * 366 * 24 * 60):
            if self.matches(when):
                return int(when.timestamp() * 1000)
            when += timedelta(minutes=1)
        raise CronError(f"'{self.expression}' never fires")
