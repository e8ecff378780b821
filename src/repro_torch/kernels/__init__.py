"""Hand-written Hopper kernels (the embedding bag, its fused variant for
small tables, the DLRM's dot interaction, GraphSAGE's neighbour
aggregation), their plain PyTorch versions (`ref`), and the
differentiable ops over them (`ops`).

Importing this package builds and loads nothing: the CUDA sources under
`csrc/` are compiled at the first launch (`build`).
"""
