"""The DLRM of the paper's Criteo workload, GraphSAGE, the recsys models
and the LM family (dense and MoE decoder-only transformers), in
PyTorch."""
