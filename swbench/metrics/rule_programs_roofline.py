"""rule_programs_roofline: the rule-program kernel (csrc/rule_programs.cu
rule_programs_kernel, stage 3b) as a share of its roofline, in %:
rule_bound_ms at the cell's rows and mean attach rows, over the
profiler's mean kernel time."""

from swbench.roofline import rule_bound_ms
from swbench.trace import kernel_stats


def read(ctx):
    trace = ctx.get("trace")
    rules = ctx.get("rules")
    if not trace or not rules:
        return None
    secs, n = kernel_stats(trace, "rule_programs_kernel")
    if not n:
        return None
    bound = rule_bound_ms(ctx["B"], rules["attach"], rules["opcode"],
                          rules["mm_idx"], rules["node_limit"], rules["S"])
    return bound / (secs / n * 1e3) * 100.0
