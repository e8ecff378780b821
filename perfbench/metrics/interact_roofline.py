"""interact_roofline: `dot_interact_fwd` and `dot_interact_bwd`'s share
of their byte bound, %, over the traced steps."""
from perfbench.lib.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "dot_interact")
