"""Concurrent query serving tier (counterpart of `sitewhere_tpu/serving/`).

Reads that never stall ingest: a planner normalizes every
`measurement_windows`-shaped request and routes it host-vs-mesh by
estimated scan size (serving/planner.py; the mesh route raises until
the sharded path is ported), an incremental window cache
reuses finalized `[K, W]` grids across dashboard polls by folding only
the segments sealed since the cached watermark (serving/wincache.py),
and a bounded executor runs it all behind per-tenant read admission
with a structured 429 (serving/executor.py)."""

from sitewhere_tpu_torch.serving.executor import (  # noqa: F401
    QueryExecutor, QueryShedError)
from sitewhere_tpu_torch.serving.planner import (  # noqa: F401
    QueryPlan, QueryPlanner, WindowQuery)
from sitewhere_tpu_torch.serving.wincache import WindowGridCache  # noqa: F401

__all__ = ["QueryExecutor", "QueryShedError", "QueryPlan", "QueryPlanner",
           "WindowQuery", "WindowGridCache"]
