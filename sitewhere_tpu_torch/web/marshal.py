"""JSON marshaling between model dataclasses and the REST wire format.

Reference: service-web-rest marshals via Jackson + `*MarshalHelper` classes
(sitewhere-core `device/marshaling/`). Here dataclasses serialize through a
single recursive converter (enums by value, bytes as base64) and entity
creation goes through the same coercion layer the persistence tier uses
(registry/store.py `_entity_from_json`) so REST payloads and stored payloads
stay one format.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def to_jsonable(obj: Any) -> Any:
    """Model object → plain JSON-serializable structure."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: to_jsonable(v)
                for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, bytes):
        return base64.b64encode(obj).decode("ascii")
    if hasattr(obj, "value") and not isinstance(obj, (str, int, float, bool)):
        return obj.value  # enums
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    # enums subclass int/str above; anything else stringifies
    return str(obj)


def results_to_jsonable(results) -> Dict[str, Any]:
    """SearchResults → {numResults, results} (reference paging envelope)."""
    return {"numResults": results.num_results,
            "results": [to_jsonable(r) for r in results.results]}


def entity_from_payload(cls: Type[T], payload: Dict[str, Any]) -> T:
    """JSON body → model dataclass, with enum/nested coercion."""
    from sitewhere_tpu_torch.registry.store import _entity_from_json
    return _entity_from_json(cls, json.dumps(payload))
