"""The DLRM of the paper's Criteo workload, GraphSAGE and wide-deep, in
PyTorch."""
