"""host_pack_ms: host ms to pack a batch into its wire blob (flight
`pack`: ops/pack.py batch_to_blob), mean over the window's steps."""


def read(ctx):
    recs = [r for r in ctx.get("flight") or [] if "pack" in r]
    if not recs:
        return None
    return sum(r["pack"] for r in recs) / len(recs)
