"""The runtime API the closed training loop uses: the `Backend`
protocol, the `FeedBackend` adapter, `Session.step`, and `Telemetry`."""
from repro_torch.api.backend import Backend, BackendBase, UnsupportedEventError
from repro_torch.api.backends import FeedBackend
from repro_torch.api.events import ChurnEvent, Event, ResizeEvent
from repro_torch.api.session import Session
from repro_torch.api.telemetry import Telemetry
from repro_torch.api.validation import AllocationError, validate_allocation

__all__ = [
    "Backend", "BackendBase", "UnsupportedEventError", "FeedBackend",
    "ChurnEvent", "Event", "ResizeEvent", "Session",
    "Telemetry", "AllocationError", "validate_allocation",
]
