"""Session: the driver of the closed training loop, and `FrozenPolicy`,
the optimizer that holds one allocation.

The train loop owns the clock: between train steps it calls
`Session.step()`, which measures the window that just ran on the
backend (FeedBackend.measure), lets the optimizer observe it, and
applies the optimizer's next proposal. `close()` tears the backend down.

    session = Session(FeedBackend(pipe, feed), InTune(spec, machine))
    for step in range(n_steps):
        batch = next(feed)
        train_step(model, opt_state, step, batch)
        if step % tune_every == 0:
            tel = session.step()
    session.close()
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.api.backend import Backend
from repro_torch.api.telemetry import Telemetry


class FrozenPolicy:
    """The simplest Optimizer: always propose the given allocation (a
    pipeline configured once and never touched — the paper's frozen
    AUTOTUNE baseline, or any hand-set placement under test)."""

    name = "frozen"

    def __init__(self, alloc: Any) -> None:
        self.alloc = alloc

    def propose(self, spec: Any, machine: Any,
                stats: Optional[Dict[str, Any]] = None) -> Any:
        return self.alloc

    def observe(self, metrics: Telemetry) -> None:
        pass


class Session:
    """One runtime over one backend, optionally driven by an optimizer.

    `spec` defaults to the backend's own spec (StageGraph or ClusterSpec)
    and is what `optimizer.propose(spec, machine)` receives. Use as a
    context manager (or call `close()`) to tear live backends down.
    """

    def __init__(self, backend: Backend, optimizer: Optional[Any] = None,
                 *, spec: Optional[Any] = None) -> None:
        self.backend = backend
        self.optimizer = optimizer
        self.spec = spec if spec is not None \
            else getattr(backend, "spec", None)

    # ------------------------------------------------------ train-driven --
    def step(self, tel: Optional[Telemetry] = None) -> Telemetry:
        """One tuning tick driven by an EXTERNAL clock (a train loop):
        measure the window that just ran, let the optimizer observe it,
        then propose + apply the next allocation. A caller that already
        measured (e.g. to inspect the `settling` flag before deciding to
        tune) passes that Telemetry in; otherwise the backend measures.

        The ordering matters for learning optimizers: `observe` must see
        the telemetry produced UNDER the previously-applied allocation
        (its pending action), and the new proposal is applied before the
        caller runs the next batch of train steps — so every (action,
        outcome) pair the agent learns from is causally aligned. Call
        between train steps:

            for step in range(n_steps):
                batch = next(feed)
                state = train_step(state, batch)
                if step % tune_every == 0:
                    tel = session.step()   # tune against measured idle

        Backends without a `measure()` method (everything but
        FeedBackend) fall back to `apply(None)` for the measurement,
        which analytic/self-driving backends treat as a plain tick.
        """
        if tel is None:
            measure = getattr(self.backend, "measure", None)
            tel = measure() if callable(measure) \
                else self.backend.apply(None)
        if self.optimizer is not None:
            self.optimizer.observe(tel)
            alloc = self.optimizer.propose(self.spec, self.backend.machine,
                                           self.backend.stats())
            self.backend.apply(alloc)
        return tel

    # --------------------------------------------------------- lifecycle --
    def close(self) -> Dict[str, Any]:
        return self.backend.shutdown()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
