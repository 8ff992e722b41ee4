"""Durable anomaly-model install registry.

Counterpart of `sitewhere_tpu/ml/store.py`: the control-plane twin of
rules/store.py's RuleProgramStore for the compiled anomaly models
(ml/compiler.py) — (tenant, token) -> {spec, stamp}, JSON-durable,
last-writer-wins with removal tombstones, in the reference's file format.
"""

from __future__ import annotations

import logging

from sitewhere_tpu_torch.rules.store import SpecStore


class ModelStore(SpecStore):
    """(tenant, token) -> {spec, stamp}; JSON-durable, LWW, with removal
    tombstones."""

    FILE, WHAT = "anomaly_models.json", "anomaly-model"
    LOGGER = logging.getLogger("sitewhere.ml.store")
