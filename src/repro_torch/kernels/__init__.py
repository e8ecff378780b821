"""Hand-written Hopper kernels (DLRM embedding bag and dot interaction,
GraphSAGE neighbour aggregation), their plain PyTorch versions (`ref`),
and the differentiable ops over them (`ops`).

Importing this package builds and loads nothing: the CUDA sources under
`csrc/` are compiled at the first launch (`build`).
"""
