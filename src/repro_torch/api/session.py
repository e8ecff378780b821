"""Session: THE driver loop. Every benchmark, example, and test drives a
backend through this one propose -> apply -> observe loop, and
`FrozenPolicy`, the optimizer that holds one allocation.

    backend = SimBackend(spec, machine, seed=0)
    opt     = make_optimizer("intune", spec, machine, seed=0)
    result  = Session(backend, opt).run(600, events=[ResizeEvent(200, 64)])

Loop contract (kept bit-for-bit with the legacy loops so the fig5 golden
JSONs regenerate byte-identically through this path):

  - events due at tick t are injected before the tick's proposal, so
    policies propose against the post-event machine/fleet state;
  - the capacity a proposal is made against is read at propose time —
    reading it after apply would let a fleet's next-tick churn clamp this
    tick's used_cpus with t+1 capacity;
  - `relaunch_dead` > 0 charges a checkpoint+relaunch dead window
    whenever the proposal changes (static *-Adaptive policies; learning
    policies re-allocate live and pass 0). DeadWindow events schedule
    explicit down-time on top;
  - dead ticks advance the backend clock without applying anything, and
    the optimizer still observes the zero Telemetry (a restart is the
    strongest learning signal);
  - with no optimizer the backend must be self-driving
    (ControllerBackend): `apply(None)` each tick.

The train loop can own the clock instead: between train steps it calls
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

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api.backend import Backend
from repro_torch.api.events import DeadWindow, Event
from repro_torch.api.telemetry import RunResult, Telemetry


def _proposal_changed(alloc: Any, prev: Any) -> bool:
    """Allocation and FleetAllocation both expose the flattened
    workers/prefetch_mb views this compares on."""
    return (not np.array_equal(alloc.workers, prev.workers)
            or alloc.prefetch_mb != prev.prefetch_mb)


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

    # ------------------------------------------------------------- loop ---
    def run(self, ticks: int, *, events: Optional[Sequence[Event]] = None,
            relaunch_dead: int = 0,
            collect: Optional[Callable[[int, Telemetry], None]] = None
            ) -> RunResult:
        sched: List[Event] = sorted(events or [], key=lambda e: e.tick)
        nxt = 0
        dead = 0
        prev = None
        res = RunResult()
        for t in range(ticks):
            while nxt < len(sched) and sched[nxt].tick <= t:
                ev = sched[nxt]
                nxt += 1
                if isinstance(ev, DeadWindow):
                    dead = max(dead, int(ev.ticks))
                else:
                    self.backend.inject(ev)
            if self.optimizer is not None:
                # live backends supply measured stats (None from analytic
                # ones), so learning policies act on the same source they
                # observe through
                alloc = self.optimizer.propose(self.spec,
                                               self.backend.machine,
                                               self.backend.stats())
                cap = self.backend.capacity
                if relaunch_dead and prev is not None \
                        and _proposal_changed(alloc, prev):
                    # max: a relaunch never truncates a longer scheduled
                    # DeadWindow already in progress
                    dead = max(dead, relaunch_dead)
                prev = alloc
            else:
                alloc = None
                cap = self.backend.capacity
            if dead > 0:
                dead -= 1
                tel = self.backend.skip_tick()
            else:
                tel = self.backend.apply(alloc)
            if self.optimizer is not None:
                self.optimizer.observe(tel)
            if collect is not None:
                collect(t, tel)
            res.throughput.append(tel.throughput)
            res.used_cpus.append(min(tel.used_cpus, cap))
            res.mem_mb.append(tel.mem_mb)
        res.oom_count = self.backend.oom_count
        if self.optimizer is not None:
            res.extras["optimizer"] = self.optimizer
        return res

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
