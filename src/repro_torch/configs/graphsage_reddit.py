"""graphsage-reddit [arXiv:1706.02216], as repro.configs.graphsage_reddit
defines it: 2 layers, d_hidden 128, mean aggregator, 47 classes, adam.

The sampler default is fanout 25-10; the `minibatch_lg` shape overrides
it to 15-10 (1024 seed nodes, 232,965 nodes, 602 input features). The
real Reddit graph is not in the repository: the port's driver, like the
JAX one, trains on a synthetic graph of the shape's size
(`CSRGraph.random`, random features and labels from a seed).
"""
from repro_torch.configs.base import GNN_SHAPES, ArchSpec, GNNConfig

MODEL = GNNConfig(
    name="graphsage-reddit", n_layers=2, d_hidden=128, n_classes=47,
    aggregator="mean", sample_sizes=(25, 10),
)

ARCH = ArchSpec(
    arch_id="graphsage-reddit", family="gnn", model=MODEL, shapes=GNN_SHAPES,
    source="arXiv:1706.02216", optimizer="adam",
)
