"""step_device_ms: device-busy ms a step in the traced part of the
window: the union of the device's busy intervals over the steps that ran
there (one geofence kernel a step), averaged over the cell's cards."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace.get("steps"):
        return None
    return trace["busy_s"] / trace["steps"] * 1e3
