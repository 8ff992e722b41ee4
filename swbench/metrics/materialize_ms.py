"""materialize_ms: host ms of a step's lane fetch and alert
materialization (flight `lane_fetch` + `materialize`), mean over the
window's steps."""


def read(ctx):
    recs = [r for r in ctx.get("flight") or []
            if "lane_fetch" in r or "materialize" in r]
    if not recs:
        return None
    return sum(r.get("lane_fetch", 0.0) + r.get("materialize", 0.0)
               for r in recs) / len(recs)
