"""emb_roofline: the bag kernels' (`embedding_bag*`: forward, fused
forward, scatter) share of their byte bound, %, over the traced steps."""
from perfbench.lib.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "embedding_bag")
