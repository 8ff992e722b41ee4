"""Outbound connector filters.

Reference: service-outbound-connectors filter/ — DeviceTypeFilter.java,
AreaFilter.java (include/exclude by entity), GroovyFilter (scripted). A
filter either includes (event passes only if it matches) or excludes
(event dropped if it matches).
"""

from __future__ import annotations

import enum
from typing import Callable, List

from sitewhere_tpu_torch.model.event import DeviceEvent, DeviceEventContext


class FilterOperation(enum.Enum):
    INCLUDE = "include"
    EXCLUDE = "exclude"


class _MatchFilter:
    """Base: subclasses define `matches`; operation decides the gate."""

    def __init__(self, operation: FilterOperation = FilterOperation.INCLUDE):
        self.operation = operation

    def matches(self, context: DeviceEventContext,
                event: DeviceEvent) -> bool:
        raise NotImplementedError

    def accepts(self, context: DeviceEventContext,
                event: DeviceEvent) -> bool:
        matched = self.matches(context, event)
        return matched if self.operation == FilterOperation.INCLUDE \
            else not matched


class DeviceTypeFilter(_MatchFilter):
    """Match on the enriched context's device type id (DeviceTypeFilter.java).

    `registry` resolves type tokens to ids once at construction."""

    def __init__(self, registry, device_type_tokens: List[str],
                 operation: FilterOperation = FilterOperation.INCLUDE):
        super().__init__(operation)
        self.type_ids = {registry.get_device_type_by_token(t).id
                         for t in device_type_tokens}

    def matches(self, context, event) -> bool:
        return context.device_type_id in self.type_ids


class AreaFilter(_MatchFilter):
    """Match on the assignment's area (AreaFilter.java)."""

    def __init__(self, registry, area_tokens: List[str],
                 operation: FilterOperation = FilterOperation.INCLUDE):
        super().__init__(operation)
        self.area_ids = {registry.get_area_by_token(t).id
                         for t in area_tokens}

    def matches(self, context, event) -> bool:
        return context.area_id in self.area_ids


class EventTypeFilter(_MatchFilter):
    """Match on event type — common reference configuration pattern."""

    def __init__(self, event_types,
                 operation: FilterOperation = FilterOperation.INCLUDE):
        super().__init__(operation)
        self.event_types = set(event_types)

    def matches(self, context, event) -> bool:
        return event.event_type in self.event_types


class ScriptedFilter(_MatchFilter):
    """User callable `(context, event) -> bool` (GroovyFilter's extension
    point without a JVM)."""

    def __init__(self, script: Callable[[DeviceEventContext, DeviceEvent], bool],
                 operation: FilterOperation = FilterOperation.INCLUDE):
        super().__init__(operation)
        self.script = script

    def matches(self, context, event) -> bool:
        return bool(self.script(context, event))
