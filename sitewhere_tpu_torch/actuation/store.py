"""Durable actuation-policy install registry.

Counterpart of `sitewhere_tpu/actuation/store.py`: the control-plane twin
of ml/store.py's ModelStore for the compiled alert->command policies
(actuation/compiler.py) — (tenant, token) -> {spec, stamp}, JSON-durable,
last-writer-wins with removal tombstones, in the reference's file format.
"""

from __future__ import annotations

import logging

from sitewhere_tpu_torch.rules.store import SpecStore


class ActuationPolicyStore(SpecStore):
    """(tenant, token) -> {spec, stamp}; JSON-durable, LWW, with removal
    tombstones."""

    FILE, WHAT = "actuation_policies.json", "actuation-policy"
    LOGGER = logging.getLogger("sitewhere.actuation.store")
