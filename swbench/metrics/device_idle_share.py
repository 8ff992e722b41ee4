"""device_idle_share: the share of the traced part of the window in which
no operation ran on the device (1 - union of busy intervals / window),
mean over the cell's cards."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace.get("window_s"):
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
