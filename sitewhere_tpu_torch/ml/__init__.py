"""Anomaly models: tiny learned scorers compiled into fixed-shape weight
tables (ml/compiler.py), scored inside the step (ops/anomaly.py), installed
through a durable LWW store (ml/store.py)."""

from sitewhere_tpu_torch.ml.compiler import (
    AnomalyModelError, AnomalyModelTable, FeatureKind, ModelKind,
    model_from_dict)
from sitewhere_tpu_torch.ml.store import ModelStore

__all__ = ["AnomalyModelError", "AnomalyModelTable", "FeatureKind",
           "ModelKind", "ModelStore", "model_from_dict"]
