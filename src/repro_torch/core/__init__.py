"""Control plane: the InTune controller, its DQN, and the environment
and baselines it is built on."""
from repro_torch.core.controller import InTune  # noqa: F401
