"""The step (validate + rules + state fold + alert lanes) and its engine."""

from sitewhere_tpu_torch.pipeline.engine import (
    GeofenceRule, PipelineEngine, ThresholdRule)

__all__ = ["GeofenceRule", "PipelineEngine", "ThresholdRule"]
