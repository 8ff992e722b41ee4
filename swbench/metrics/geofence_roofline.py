"""geofence_roofline: kernel B1 (csrc/geofence.cu points_in_zones_kernel)
as a share of its roofline, in %: geofence_bound_ms at the cell's B, Z, V
and the mean pairs not y-rejected of its pool batches, over the
profiler's mean kernel time."""

from swbench.roofline import geofence_bound_ms
from swbench.trace import kernel_stats


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    secs, n = kernel_stats(trace, "points_in_zones")
    if not n:
        return None
    bound = geofence_bound_ms(ctx["B"], ctx["Z"], ctx["V"], ctx["p_in"])
    return bound / (secs / n * 1e3) * 100.0
