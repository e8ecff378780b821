"""repro_torch: the InTune reproduction ported to PyTorch and CUDA.

The closed training loop of the paper — a tuned ProcessPipeline feeding a
DLRM adagrad train step, with the InTune DQN re-placing pipeline workers
from the measured device idle time — runs here on an NVIDIA H100. The
DLRM's two hot ops go through kernels written by hand for Hopper
(`repro_torch.kernels`). The generic driver (`repro_torch.launch.train`)
trains GraphSAGE on sampled minibatches, its neighbour aggregations
through a third such kernel, and wide-deep, its wide arm through a
fourth (the fused embedding bag) and its deep tables through the
DLRM's; it also trains the LM family (models/transformer.py, plain
PyTorch, as the JAX package's is plain jnp). Everything else is plain
PyTorch or copied
numpy code. Importing this package (or `repro_torch.data`) imports
neither torch nor CUDA, so forked or spawned pipeline workers stay cheap.
"""
