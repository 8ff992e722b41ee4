"""stage_wait_ms: host ms a step waits on the staging ring (flight
`stage_wait` + `guard`), mean over the window's steps."""


def read(ctx):
    recs = ctx.get("flight") or []
    if not recs:
        return None
    return sum(r.get("stage_wait", 0.0) + r.get("guard", 0.0)
               for r in recs) / len(recs)
