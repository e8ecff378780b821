"""Runtime constants shared by every driver (port of
repro/api/constants.py).

OOM_RESTART_TICKS stays defined next to the OOM judge itself
(`repro_torch.data.simulator`) so the data plane cannot drift from it;
it is re-exported here so API users find both windows in one place.
"""
from repro_torch.data.simulator import OOM_RESTART_TICKS

# checkpoint + relaunch dead time a static (*-Adaptive) policy pays to
# adapt: the pipeline process is down for this many ticks
RELAUNCH_TICKS = 20

__all__ = ["RELAUNCH_TICKS", "OOM_RESTART_TICKS"]
