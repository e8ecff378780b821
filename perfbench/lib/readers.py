"""Arithmetic the per-layer readers share: a kernel group's share of its
roofline from the traced stretch and the frozen costs."""
from __future__ import annotations

from typing import Optional


def roofline_share(ctx, prefix: str) -> Optional[float]:
    """100 x (the least time the launches of kernels named `prefix...`
    could take, at 3.35 TB/s or at 67 TFLOP/s, whichever bounds) / (their
    summed device time), over the traced steps; None where the stretch
    has none of them or not every launch its steps must make."""
    st = getattr(ctx, "stretch", None)
    if st is None or not ctx.kernel_costs:
        return None
    bound, spent = 0.0, 0.0
    for name in ctx.kernel_costs[0]:
        if not name.startswith(prefix):
            continue
        per_step = [c[name] for c in ctx.kernel_costs]
        times = st.launches(name)
        if len(times) != sum(len(c) for c in per_step):
            return None
        bound += sum(max(c.bytes / ctx.bytes_s, c.ops / ctx.ops_s)
                     for costs in per_step for c in costs)
        spent += sum(times)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
