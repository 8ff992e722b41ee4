"""Batch and streaming analytics over the event plane (counterpart of
`sitewhere_tpu/analytics/`): windowed segment reductions on the card, replay
engines over the event log and the bus, and a micro-batch stream receiver."""

from sitewhere_tpu_torch.analytics.engine import (
    BusReplayAnalytics, WindowReport, WindowedAnalyticsEngine)
from sitewhere_tpu_torch.analytics.receiver import (
    EventStreamReceiver, MicroBatch)
from sitewhere_tpu_torch.analytics.windows import (
    WindowedStats, compact_keys, event_type_histogram, windowed_stats)

__all__ = [
    "BusReplayAnalytics", "EventStreamReceiver", "MicroBatch",
    "WindowReport", "WindowedAnalyticsEngine", "WindowedStats",
    "compact_keys", "event_type_histogram", "windowed_stats",
]
