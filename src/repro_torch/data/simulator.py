"""Queueing simulator of the ingestion pipeline.

The paper pretrains its DQN agent "in offline simulations" (§4.2); this
module is that simulator promoted to a first-class, tested component. It is
also the benchmark engine: the container exposes one CPU, so the paper's
128-CPU Xeon scaling behavior is modeled analytically (DESIGN.md §3) —
stage throughput follows Amdahl scaling on the stage's true cost, graph
throughput propagates bottlenecks through the StageGraph in topological
order (a join runs at the min of its parents; for a linear chain this is
exactly the classic bottleneck-stage formula, pipelined execution [21]),
and memory tracks worker overheads, per-edge buffers, and the prefetch
buffer.

Semantics shared by every optimizer under test (level playing field):
  - allocations: integer workers per stage + prefetch buffer depth,
  - machine resize events change the CPU cap mid-run,
  - exceeding the memory cap is an OOM: the pipeline crashes and pays a
    teardown+restart penalty (the paper's Fig. 5B behavior),
  - observation noise on measured latencies (configurable).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.pipeline import PipelineSpec, stage_throughput


@dataclass(frozen=True)
class MachineSpec:
    n_cpus: int = 128
    mem_mb: float = 65536.0
    dram_bw_gbps: float = 25.6
    cpu_ghz: float = 3.0


@dataclass
class Allocation:
    workers: np.ndarray              # (n_stages,) int
    prefetch_mb: float = 512.0       # buffer budget for prefetch stage

    def copy(self) -> "Allocation":
        return Allocation(self.workers.copy(), self.prefetch_mb)


OOM_RESTART_TICKS = 30  # teardown + relaunch dead time (paper: "significant")


def graph_memory_mb(spec: PipelineSpec, workers, prefetch_mb: float) -> float:
    """THE memory model: framework floor + per-worker overheads +
    per-edge buffers + the prefetch buffer. PipelineSim scores OOMs with
    it and the fleet coordinator's admission control clamps against it —
    one definition, so the guard can never diverge from the judge.
    (Accumulation order is kept stable: these floats feed byte-identical
    golden files.)"""
    mb = 2048.0  # framework + model host memory floor
    for st, w in zip(spec.stages, workers):
        mb += st.mem_per_worker_mb * int(w)
    mb += spec.edge_buffer_mb * len(spec.edges)
    mb += prefetch_mb
    return mb


class PipelineSim:
    """Analytic pipeline simulator with OOM + resize dynamics.

    Streaming graphs (a `StageSpec` with kind="stream" carrying an
    `ArrivalProcess`) add a world clock: each `apply` tick spans `tick_s`
    stream-seconds, arrivals are the exact integral of the arrival curve
    over the tick, and the stream source's service rate is capped at
    what is actually available — `(backlog + arrivals) / tick_s`. What
    the pipeline cannot drain accumulates as backlog (batches), charged
    to memory at the arrival model's `buffer_mb_per_batch` (so an
    undersized allocation can OOM on backlog growth) and reported as the
    freshness metrics `backlog_items` / `batch_staleness_s` /
    `p99_queue_delay_s`. Non-stream graphs take none of these paths —
    their tick dicts (and golden files) are unchanged.
    """

    def __init__(self, spec: PipelineSpec, machine: MachineSpec,
                 model_latency: float = 0.0, seed: int = 0,
                 obs_noise: float = 0.02, tick_s: float = 1.0):
        self.spec = spec
        self.machine = machine
        self.model_latency = model_latency
        self.rng = np.random.RandomState(seed)
        self.obs_noise = obs_noise
        self.oom_count = 0
        self.restart_left = 0
        self.time = 0
        # streaming state (inert for non-stream specs)
        self.tick_s = float(tick_s)
        self.stream_clock = 0.0        # stream-seconds elapsed
        self.backlog = 0.0             # batches arrived but not drained
        self.shed_total = 0.0          # batches dropped at the buffer cap
        self._stale = 0.0
        self._delay_win: deque = deque(maxlen=100)

    # ----------------------------------------------------------- stream ---
    @property
    def _stream(self):
        i = getattr(self.spec, "stream_idx", None)
        return None if i is None else self.spec.stages[i].arrival

    def _arrivals_now(self) -> float:
        """Batches arriving during the CURRENT tick's stream window
        [stream_clock, stream_clock + tick_s) — exact integral."""
        arr = self._stream
        if arr is None:
            return 0.0
        return arr.batches_between(self.stream_clock,
                                   self.stream_clock + self.tick_s)

    # ------------------------------------------------------------ model ---
    def stage_rates(self, alloc: Allocation, *,
                    stream_capped: bool = True) -> np.ndarray:
        """Per-stage service rate (what the stage could process given its
        workers, were its inputs never the constraint). For a streaming
        source the rate is additionally capped by availability —
        `min(amdahl_rate, (backlog + arrivals)/tick_s)`; pass
        `stream_capped=False` for pure capacity planning (the oracle
        water-fills on capacity, not on today's traffic)."""
        rates = np.array([
            stage_throughput(st, int(w))
            for st, w in zip(self.spec.stages, alloc.workers)])
        idx = getattr(self.spec, "stream_idx", None)
        if idx is not None and stream_capped:
            avail = (self.backlog + self._arrivals_now()) / self.tick_s
            rates[idx] = min(rates[idx], avail)
        return rates

    def sustained_rates(self, alloc: Allocation) -> np.ndarray:
        """Per-stage sustained rate over the DAG in topological order: a
        stage runs at min(its own service rate, its input rate), and a
        join's input rate is the min over its parents (it pairs one item
        from each input stream per output). For a linear chain the sink's
        sustained rate is exactly min over all stages — the pre-DAG
        bottleneck formula."""
        out = self.stage_rates(alloc)
        for i in self.spec.topo_order:
            for p in self.spec.parents(i):
                if out[p] < out[i]:
                    out[i] = out[p]
        return out

    def throughput(self, alloc: Allocation) -> float:
        """Sustained batches/s at the sink, capped by model demand."""
        rates = self.stage_rates(alloc)
        if np.any(rates <= 0):
            return 0.0
        rate = float(self.sustained_rates(alloc)[self.spec.sink])
        if self.model_latency > 0:
            rate = min(rate, 1.0 / self.model_latency)
        return rate

    def memory_used(self, alloc: Allocation) -> float:
        return graph_memory_mb(self.spec, alloc.workers, alloc.prefetch_mb)

    def measured_latencies(self, alloc: Allocation) -> np.ndarray:
        """Per-stage effective latency (1/rate) with observation noise —
        what a live rate-meter reports."""
        rates = self.stage_rates(alloc)
        lat = np.where(rates > 0, 1.0 / np.maximum(rates, 1e-9), 10.0)
        noise = 1.0 + self.obs_noise * self.rng.randn(len(lat))
        return lat * np.clip(noise, 0.5, 1.5)

    # ---------------------------------------------------------- dynamics --
    def apply(self, alloc: Allocation) -> dict:
        """Advance one tick under `alloc`. Returns metrics for the tick."""
        self.time += 1
        arrivals = self._arrivals_now()
        mem = self.memory_used(alloc)
        arr = self._stream
        if arr is not None and arr.buffer_mb_per_batch > 0:
            # backlogged batches live in the ingest buffer — an undersized
            # allocation OOMs on backlog growth, not just static footprint
            mem += (self.backlog + arrivals) * arr.buffer_mb_per_batch
        used_cpus = int(np.sum(alloc.workers))
        if self.restart_left > 0:
            self.restart_left -= 1
            out = {"throughput": 0.0, "mem_mb": mem, "oom": False,
                   "restarting": True, "used_cpus": used_cpus}
            return self._finish_tick(out, arrivals, drained=0.0)
        if mem > self.machine.mem_mb:
            self.oom_count += 1
            self.restart_left = OOM_RESTART_TICKS
            out = {"throughput": 0.0, "mem_mb": mem, "oom": True,
                   "restarting": True, "used_cpus": used_cpus}
            return self._finish_tick(out, arrivals, drained=0.0)
        if used_cpus > self.machine.n_cpus:
            # over-subscription: everyone slows down proportionally
            scale = self.machine.n_cpus / used_cpus
            tput = self.throughput(alloc) * scale
        else:
            tput = self.throughput(alloc)
        out = {"throughput": tput, "mem_mb": mem, "oom": False,
               "restarting": False, "used_cpus": used_cpus}
        return self._finish_tick(out, arrivals, drained=tput * self.tick_s)

    def _finish_tick(self, out: dict, arrivals: float, drained: float) -> dict:
        """Stream bookkeeping at end of tick: backlog accrues (even while
        restarting — the world does not pause for an OOM), retention cap
        sheds, staleness = backlog drain time at the current rate, p99 over
        a sliding window. No-op (dict untouched) for non-stream specs, so
        golden files stay byte-identical."""
        arr = self._stream
        if arr is None:
            return out
        self.backlog = max(0.0, self.backlog + arrivals - drained)
        if arr.buffer_cap_batches is not None and \
                self.backlog > arr.buffer_cap_batches:
            self.shed_total += self.backlog - arr.buffer_cap_batches
            self.backlog = float(arr.buffer_cap_batches)
        rate = drained / self.tick_s
        if rate > 1e-9:
            self._stale = self.backlog / rate
        elif self.backlog > 1e-9:
            self._stale += self.tick_s   # stalled with work queued: ages
        else:
            self._stale = 0.0
        self._delay_win.append(self._stale)
        out["backlog_items"] = float(self.backlog)
        out["batch_staleness_s"] = float(self._stale)
        out["p99_queue_delay_s"] = float(np.percentile(self._delay_win, 99.0))
        out["arrival_rate"] = arrivals / self.tick_s
        out["shed_batches"] = float(self.shed_total)
        self.stream_clock += self.tick_s
        return out

    def resize(self, n_cpus: int):
        self.machine = dataclasses.replace(self.machine, n_cpus=n_cpus)

    # ----------------------------------------------------------- optima ---
    def best_allocation(self, n_cpus: Optional[int] = None,
                        iters: int = 4096) -> Tuple[Allocation, float]:
        """Oracle: greedy water-filling on TRUE costs + efficiency curves
        (provably optimal for min-bottleneck with concave per-stage rates:
        each CPU goes to the current bottleneck). With a single sink every
        stage is an ancestor of it, so the DAG's sustained sink rate is the
        min over all service rates and water-filling on service rates stays
        optimal."""
        n = n_cpus or self.machine.n_cpus
        workers = np.ones(self.spec.n_stages, dtype=int)
        # leave a little memory headroom; prefetch sized to depth 2
        alloc = Allocation(workers, prefetch_mb=2 * self.spec.batch_mb)
        for _ in range(n - self.spec.n_stages):
            # capacity planning: water-fill on UNCAPPED service rates — a
            # traffic-capped stream source would otherwise stay the argmin
            # forever and soak up every CPU
            rates = self.stage_rates(alloc, stream_capped=False)
            i = int(np.argmin(rates))
            trial = alloc.copy()
            trial.workers[i] += 1
            if self.memory_used(trial) > self.machine.mem_mb:
                break
            alloc = trial
            if self.model_latency > 0 and \
                    np.min(self.stage_rates(alloc, stream_capped=False)) \
                    >= 1 / self.model_latency:
                break
        return alloc, self.throughput(alloc)


def resize_schedule(total_ticks: int,
                    caps: Sequence[int] = (32, 64, 128, 64, 32)
                    ) -> List[Tuple[int, int]]:
    """The paper's rescale script: [(tick, n_cpus), ...] evenly spaced."""
    seg = total_ticks // len(caps)
    return [(i * seg, c) for i, c in enumerate(caps)]
