"""The DLRM of the paper's Criteo workload, in PyTorch."""
