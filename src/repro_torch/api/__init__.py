"""The runtime API the closed training loop uses: the `Backend`
protocol, the `FeedBackend` adapter, `Session.step`, `FrozenPolicy`,
`Telemetry` and the runtime constants."""
from repro_torch.api.backend import Backend, BackendBase, UnsupportedEventError
from repro_torch.api.backends import FeedBackend
from repro_torch.api.constants import OOM_RESTART_TICKS, RELAUNCH_TICKS
from repro_torch.api.events import ChurnEvent, Event, ResizeEvent
from repro_torch.api.session import FrozenPolicy, Session
from repro_torch.api.telemetry import Telemetry
from repro_torch.api.validation import AllocationError, validate_allocation

__all__ = [
    "Backend", "BackendBase", "UnsupportedEventError", "FeedBackend",
    "OOM_RESTART_TICKS", "RELAUNCH_TICKS",
    "ChurnEvent", "Event", "ResizeEvent", "FrozenPolicy", "Session",
    "Telemetry", "AllocationError", "validate_allocation",
]
