"""The DLRM of the paper's Criteo workload and GraphSAGE, in PyTorch."""
