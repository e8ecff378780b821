"""Time-varying arrival model for streaming ingestion.

Every benchmark before this PR tuned against an infinite backlog: the
source stage could always pull another batch, so "throughput" was purely
a capacity question. The paper's setting — and the ROADMAP's
millions-of-users north star — is a live event stream: user traffic has
a diurnal cycle, short stochastic bursts, and occasional flash crowds
(a 10x spike when something goes viral). The pipeline's job flips from
"go as fast as possible" to "keep up with the world": in a trough most
of the machine is wasted, in a spike an undersized allocation lets the
backlog (and batch staleness) grow without bound.

`ArrivalProcess` is that world model, shared verbatim by both planes:

  - the analytic plane (`PipelineSim`) integrates it per tick to get
    arrivals, and caps the stream source's service rate at
    `min(arrival_rate, amdahl_rate)` — you cannot process events that
    have not happened yet;
  - the process plane (`proc_executor.StreamSourceWork`) uses the same
    integral as a token bucket: a source worker may only emit batch k
    once `batches_before(now) > k`, so the producer is rate-limited by
    the SAME arrival curve the simulator scores.

The rate is multiplicative: `base * diurnal(t) * bursts(t) * flash(t)`,
where base comes from user-population knobs (`users x events_per_user_s`),
the diurnal term is a sinusoid, and bursts/flash crowds are piecewise-
constant multipliers. That structure keeps `events_between` EXACT (the
sinusoid integrates analytically inside each constant-gain segment) —
no numeric quadrature, so the sim's backlog accounting is reproducible
to the bit and cheap enough for a worker process to poll per item.

Determinism: the stochastic burst schedule is drawn once in
`__post_init__` from `seed` (exponential gaps over `horizon_s`) and
stored as a plain tuple, so equal-seed processes are identical, the
dataclass stays frozen/picklable across `multiprocessing` boundaries,
and tests can hand-compute every integral.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class ArrivalProcess:
    """Deterministic-under-seed arrival-rate model, in events/second.

    Population knobs: `users * events_per_user_s` is the mean event
    rate; `events_per_batch` converts to the batch units the pipeline
    (and every backlog/staleness metric) works in.

    Shape knobs:
      diurnal_amp/period/phase   rate swings +-amp (fraction of base)
                                 sinusoidally over period_s seconds
      burst_every_s              mean gap between stochastic bursts
                                 (exponential, seeded; 0 disables);
                                 each multiplies the rate by burst_gain
                                 for burst_len_s
      flash_crowds               scheduled ((t_start, duration, gain),
                                 ...) multipliers — the benchmark's
                                 10x spike is one of these
    Buffer knobs (consumed by the sim's memory/OOM judge):
      buffer_mb_per_batch        resident MB one backlogged batch holds
                                 in the ingest buffer (0 = unaccounted)
      buffer_cap_batches         drop-oldest retention cap; beyond it
                                 arrivals are shed (counted, not stored)
    """
    users: float = 1.0e6
    events_per_user_s: float = 1.0e-3
    events_per_batch: float = 4096.0
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 86400.0
    diurnal_phase_s: float = 0.0
    burst_every_s: float = 0.0
    burst_gain: float = 2.0
    burst_len_s: float = 60.0
    flash_crowds: Tuple[Tuple[float, float, float], ...] = ()
    buffer_mb_per_batch: float = 0.0
    buffer_cap_batches: Optional[float] = None
    seed: int = 0
    horizon_s: float = 7200.0

    def __post_init__(self):
        if not 0.0 <= self.diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1) so the rate "
                             "stays positive")
        bursts = []
        if self.burst_every_s > 0:
            rng = np.random.RandomState(self.seed)
            t = 0.0
            while True:
                t += float(rng.exponential(self.burst_every_s))
                if t >= self.horizon_s:
                    break
                bursts.append((t, t + self.burst_len_s, self.burst_gain))
        object.__setattr__(self, "_bursts", tuple(bursts))

    # ------------------------------------------------------------- rate ---
    @property
    def base_events_per_sec(self) -> float:
        return self.users * self.events_per_user_s

    def _windows(self) -> Tuple[Tuple[float, float, float], ...]:
        """All piecewise-constant gain windows: (start, end, gain)."""
        return self._bursts + tuple(
            (t0, t0 + dur, gain) for t0, dur, gain in self.flash_crowds)

    def _gain(self, t: float) -> float:
        g = 1.0
        for a, b, gain in self._windows():
            if a <= t < b:
                g *= gain
        return g

    def _diurnal(self, t: float) -> float:
        if self.diurnal_amp == 0.0:
            return 1.0
        return 1.0 + self.diurnal_amp * math.sin(
            _TWO_PI * (t - self.diurnal_phase_s) / self.diurnal_period_s)

    def events_per_sec(self, t: float) -> float:
        """Instantaneous arrival rate at stream time t (seconds)."""
        return self.base_events_per_sec * self._diurnal(t) * self._gain(t)

    def batches_per_sec(self, t: float) -> float:
        return self.events_per_sec(t) / self.events_per_batch

    # --------------------------------------------------------- integrals --
    def _diurnal_integral(self, a: float, b: float) -> float:
        """∫_a^b diurnal(t) dt, analytic."""
        if self.diurnal_amp == 0.0:
            return b - a
        w = _TWO_PI / self.diurnal_period_s
        ph = self.diurnal_phase_s
        return (b - a) - self.diurnal_amp / w * (
            math.cos(w * (b - ph)) - math.cos(w * (a - ph)))

    def events_between(self, t0: float, t1: float) -> float:
        """∫_t0^t1 events_per_sec(t) dt, exact: split at every gain-window
        boundary, integrate the sinusoid analytically per segment."""
        if t1 <= t0:
            return 0.0
        cuts = {t0, t1}
        for a, b, _ in self._windows():
            for c in (a, b):
                if t0 < c < t1:
                    cuts.add(c)
        pts = sorted(cuts)
        total = 0.0
        for a, b in zip(pts, pts[1:]):
            mid = 0.5 * (a + b)
            total += self._gain(mid) * self._diurnal_integral(a, b)
        return self.base_events_per_sec * total

    def batches_between(self, t0: float, t1: float) -> float:
        return self.events_between(t0, t1) / self.events_per_batch

    def batches_before(self, t: float) -> float:
        """Cumulative batches arrived in [0, t) — the token-bucket level
        the process plane's rate-limited producer claims against."""
        return self.batches_between(0.0, t)


def flash_crowd_arrivals(base_batches_per_sec: float, *,
                         events_per_batch: float = 4096.0,
                         spike_at_s: float, spike_len_s: float,
                         spike_gain: float = 10.0,
                         diurnal_amp: float = 0.0,
                         diurnal_period_s: float = 600.0,
                         buffer_mb_per_batch: float = 0.0,
                         seed: int = 0) -> ArrivalProcess:
    """The benchmark scenario: a steady (optionally mildly diurnal) base
    rate with one scheduled flash crowd. `base_batches_per_sec` is the
    mean rate in batch units; population knobs are derived so
    `users * events_per_user_s == base * events_per_batch`."""
    return ArrivalProcess(
        users=base_batches_per_sec * events_per_batch,
        events_per_user_s=1.0,
        events_per_batch=events_per_batch,
        diurnal_amp=diurnal_amp,
        diurnal_period_s=diurnal_period_s,
        flash_crowds=((float(spike_at_s), float(spike_len_s),
                       float(spike_gain)),),
        buffer_mb_per_batch=buffer_mb_per_batch,
        seed=seed)
