"""Data-pipeline stage graph: the thing InTune allocates CPUs across.

A StageGraph is a DAG of stages. The paper's pipelines are linear chains
(disk load -> shuffle -> UDF -> batch -> prefetch), but production DLRM
ingestion is multi-source: dense, sparse, and label streams read from
separate storage, joined, transformed, batched (Zhao et al.'s DSI
breakdown; BagPipe's split embedding/dense fetch). Each StageSpec names
its `inputs` (parent stages); a stage with no inputs is a source, a stage
with several is a join. A tuple of input-less stages is auto-wired into
the classic linear chain, so every pre-DAG construction site keeps
working unchanged (`PipelineSpec` remains as an alias).

Each stage carries a *true* per-batch CPU cost, a parallel-efficiency
profile (Amdahl serial fraction), and a memory footprint model. The
executor (data/executor.py) runs the graph with real threads and one
bounded queue per edge; the simulator (data/simulator.py) runs the same
spec analytically for RL training and benchmarks (DESIGN.md §3).

Stage costs default to the latency shares of the paper's Figure 3
(UDFs and disk loads dominate; shuffle/batch stay modest).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.data.stream import ArrivalProcess


@dataclass(frozen=True)
class StageSpec:
    name: str
    kind: str                  # "source" | "stream" | "shuffle" | "udf" |
                               # "join" | "batch" | "prefetch"
    cost: float                # true CPU-seconds per batch at 1 worker
    serial_frac: float = 0.05  # Amdahl: speedup(a) = 1 / (s + (1-s)/a)
    # what a one-shot profiler *thinks* the cost is (AUTOTUNE's model).
    # UDFs are black boxes: static profilers systematically underestimate
    # them (Plumber paper / InTune §3.2). est_cost = cost * est_bias, so
    # bias < 1 starves the stage; 1.0 = perfectly estimated.
    est_bias: float = 1.0
    mem_per_worker_mb: float = 64.0
    # prefetch: memory per buffered batch; tuned in MB by the agent
    mem_per_item_mb: float = 0.0
    # DAG edges: names of the stages this one consumes. () = source stage.
    inputs: Tuple[str, ...] = ()
    # "stream" sources only: the time-varying arrival model backing the
    # stage. Its service rate becomes min(arrival_rate(t), amdahl_rate) —
    # the stage cannot process events that have not happened yet — and
    # un-ingested arrivals accumulate as backlog (data/stream.py).
    arrival: Optional[ArrivalProcess] = None

    def est_cost(self) -> float:
        return self.cost * self.est_bias


@dataclass(frozen=True)
class StageGraph:
    """DAG of StageSpecs with validated topology.

    Invariants (checked at construction):
      - stage names are unique and every `inputs` entry names a stage,
      - the graph is acyclic,
      - exactly one stage has no consumers (the sink feeding the trainer),
        which with acyclicity means every stage's output reaches the sink.
    """
    name: str
    stages: Tuple[StageSpec, ...]
    batch_mb: float = 256.0          # bytes of one training batch
    target_rate: float = 10.0        # batches/s the model consumes at 0 idle
    # inter-stage buffer accounting: MB charged per graph edge by the
    # simulator's memory model. 0 keeps pre-DAG (linear) numbers identical.
    edge_buffer_mb: float = 0.0
    # what the process plane runs per item: "spin" = calibrated CPU burns
    # (proc_executor.SpinWork), "real" = actual featurization work over
    # synthetic Criteo records (data/featurize.py) realizing the same
    # cost/serial_frac contract. The analytic planes ignore this — both
    # modes follow the identical Amdahl service curve by construction.
    work: str = "spin"

    def __post_init__(self):
        if self.work not in ("spin", "real"):
            raise ValueError(f"work must be 'spin' or 'real', "
                             f"got {self.work!r}")
        stages = tuple(self.stages)
        if not stages:
            raise ValueError("StageGraph needs at least one stage")
        # Back-compat: a tuple of input-less stages is the classic linear
        # chain; wire stage i to consume stage i-1.
        if len(stages) > 1 and all(not s.inputs for s in stages):
            stages = (stages[0],) + tuple(
                dataclasses.replace(s, inputs=(stages[i].name,))
                for i, s in enumerate(stages[1:]))
            object.__setattr__(self, "stages", stages)
        index: Dict[str, int] = {}
        for i, s in enumerate(stages):
            if s.name in index:
                raise ValueError(f"duplicate stage name {s.name!r}")
            index[s.name] = i
        parents: List[Tuple[int, ...]] = []
        for s in stages:
            for p in s.inputs:
                if p not in index:
                    raise ValueError(
                        f"stage {s.name!r} consumes unknown stage {p!r}")
                if p == s.name:
                    raise ValueError(f"stage {s.name!r} consumes itself")
            parents.append(tuple(index[p] for p in s.inputs))
        children: List[List[int]] = [[] for _ in stages]
        for i, ps in enumerate(parents):
            for p in ps:
                children[p].append(i)
        sinks = [i for i, cs in enumerate(children) if not cs]
        if len(sinks) != 1:
            names = [stages[i].name for i in sinks]
            raise ValueError(
                f"StageGraph {self.name!r} must have exactly one sink "
                f"(stage nothing consumes); got {names}")
        # Kahn's algorithm; leftover nodes = a cycle.
        indeg = [len(ps) for ps in parents]
        ready = [i for i, d in enumerate(indeg) if d == 0]
        topo: List[int] = []
        while ready:
            i = ready.pop(0)
            topo.append(i)
            for c in children[i]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(topo) != len(stages):
            cyc = [stages[i].name for i in range(len(stages))
                   if i not in topo]
            raise ValueError(f"StageGraph {self.name!r} has a cycle "
                             f"through {cyc}")
        # streaming-source invariants: a "stream" stage is a source with
        # an attached ArrivalProcess; at most one per graph (backlog /
        # staleness accounting is per-graph state in the simulator)
        streams = []
        for i, s in enumerate(stages):
            if s.kind == "stream":
                if s.arrival is None:
                    raise ValueError(
                        f"stream stage {s.name!r} needs an ArrivalProcess "
                        f"(StageSpec.arrival)")
                if s.inputs:
                    raise ValueError(
                        f"stream stage {s.name!r} must be a source "
                        f"(inputs=()), got inputs={s.inputs}")
                streams.append(i)
            elif s.arrival is not None:
                raise ValueError(
                    f"stage {s.name!r} carries an ArrivalProcess but its "
                    f"kind is {s.kind!r}, not 'stream'")
        if len(streams) > 1:
            names = [stages[i].name for i in streams]
            raise ValueError(f"StageGraph {self.name!r} has multiple "
                             f"stream sources {names}; at most one is "
                             f"supported")
        object.__setattr__(self, "_stream_idx",
                           streams[0] if streams else None)
        object.__setattr__(self, "_index", index)
        object.__setattr__(self, "_parents", tuple(parents))
        object.__setattr__(self, "_children",
                           tuple(tuple(cs) for cs in children))
        object.__setattr__(self, "_topo", tuple(topo))
        object.__setattr__(self, "_sink", sinks[0])

    # ---------------------------------------------------------- topology --
    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def topo_order(self) -> Tuple[int, ...]:
        """Stage indices in dependency order (parents before children)."""
        return self._topo

    @property
    def sink(self) -> int:
        """Index of the unique output stage (feeds the training loop)."""
        return self._sink

    @property
    def sources(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.stages) if not s.inputs)

    @property
    def stream_idx(self) -> Optional[int]:
        """Index of the streaming source stage, or None for the classic
        infinite-backlog graphs."""
        return self._stream_idx

    @property
    def edges(self) -> Tuple[Tuple[int, int], ...]:
        """(producer_idx, consumer_idx) for every graph edge."""
        return tuple((p, i) for i, ps in enumerate(self._parents)
                     for p in ps)

    @property
    def is_linear(self) -> bool:
        return all(ps == ((i - 1,) if i else ())
                   for i, ps in enumerate(self._parents))

    def index(self, name: str) -> int:
        return self._index[name]

    def parents(self, i: int) -> Tuple[int, ...]:
        return self._parents[i]

    def children(self, i: int) -> Tuple[int, ...]:
        return self._children[i]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# The pre-DAG name; a linear PipelineSpec is just a StageGraph whose
# auto-wired chain topology is the identity permutation.
PipelineSpec = StageGraph


def stage_throughput(stage: StageSpec, workers: int) -> float:
    """Batches/s this stage sustains with `workers` CPUs (Amdahl scaling)."""
    if workers <= 0:
        return 0.0
    speedup = 1.0 / (stage.serial_frac + (1.0 - stage.serial_frac) / workers)
    return speedup / stage.cost


def criteo_pipeline(batch_mb: float = 256.0,
                    target_rate: float = 31.0,
                    work: str = "spin") -> StageGraph:
    """The paper's 5-stage DLRM ingestion pipeline, cost shares per Fig. 3.

    disk load and the feature-extraction UDF dominate; the UDF is the stage
    static optimizers mis-model (est_bias < 1 = underestimated). Calibrated
    so that at 128 CPUs: 1-CPU-per-stage ~ 8% of target, oracle ~ 45%
    (the paper's Fig. 5A regime: the target rate is unreachable on one
    machine) — see benchmarks/fig5_static.py for measured values.

    `work="real"` makes the process plane run actual featurization
    (hash/pool/pad/collate over synthetic Criteo records) instead of
    calibrated spin burns; analytic planes are unaffected.
    """
    stages = (
        StageSpec("disk_load", "source", cost=0.30, serial_frac=0.12,
                  est_bias=0.7, mem_per_worker_mb=96),
        StageSpec("shuffle", "shuffle", cost=0.08, serial_frac=0.30,
                  est_bias=1.0, mem_per_worker_mb=48),
        StageSpec("feature_udf", "udf", cost=0.42, serial_frac=0.15,
                  est_bias=0.15, mem_per_worker_mb=64),
        StageSpec("batch", "batch", cost=0.12, serial_frac=0.25,
                  est_bias=1.0, mem_per_worker_mb=32),
        StageSpec("prefetch", "prefetch", cost=0.08, serial_frac=0.05,
                  est_bias=1.0, mem_per_worker_mb=16,
                  mem_per_item_mb=batch_mb),
    )
    return StageGraph("criteo_dlrm", stages, batch_mb=batch_mb,
                      target_rate=target_rate, work=work)


def train_feed_pipeline(step_time_s: float = 0.25, batch_mb: float = 8.0,
                        work: str = "real",
                        cpu_share: float = 0.8) -> StageGraph:
    """The feed-bridge demo spec (benchmarks/fig_train_feed.py and the
    proc path of examples/train_dlrm_criteo.py): the Criteo 5-stage
    chain re-costed against a MEASURED train-step time.

    Total per-batch CPU at 1 worker/stage is `cpu_share * step_time_s`,
    so a single core can keep the trainer fed under a lean allocation —
    while the ELEVATED serial fractions make over-allocation waste real
    CPU through the Amdahl coordination penalty: at heuristic_even's 6
    workers/stage (nominal 30-CPU machine) per-batch CPU inflates ~2.2x
    and the trainer starves. That contrast — measured at the feed
    boundary as `device_idle_frac` — is what the tuned arm closes.
    Ballast is kept small (the nominal machine over-places ~30 workers
    on a laptop-class host).
    """
    total = cpu_share * float(step_time_s)
    plan = (("disk_load", "source", 0.30, 0.20, 24.0),
            ("shuffle", "shuffle", 0.10, 0.40, 12.0),
            ("feature_udf", "udf", 0.35, 0.20, 16.0),
            ("batch", "batch", 0.15, 0.35, 12.0),
            ("prefetch", "prefetch", 0.10, 0.10, 8.0))
    stages = tuple(
        StageSpec(name, kind, cost=share * total, serial_frac=s,
                  mem_per_worker_mb=mb,
                  mem_per_item_mb=batch_mb if kind == "prefetch" else 0.0)
        for name, kind, share, s, mb in plan)
    return StageGraph("train_feed", stages, batch_mb=batch_mb,
                      target_rate=1.0 / max(float(step_time_s), 1e-6),
                      work=work)


def custom_pipeline(batch_mb: float = 196.0,
                    target_rate: float = 27.0) -> StageGraph:
    """The paper's second workload: the internal production recommender
    (dozens of sparse features, <5 continuous, batch in the tens of
    thousands). Heavier disk share, slightly lighter UDF than Criteo."""
    stages = (
        StageSpec("disk_load", "source", cost=0.36, serial_frac=0.10,
                  est_bias=0.7, mem_per_worker_mb=112),
        StageSpec("shuffle", "shuffle", cost=0.10, serial_frac=0.28,
                  est_bias=1.0, mem_per_worker_mb=48),
        StageSpec("feature_udf", "udf", cost=0.34, serial_frac=0.14,
                  est_bias=0.2, mem_per_worker_mb=72),
        StageSpec("batch", "batch", cost=0.14, serial_frac=0.25,
                  est_bias=1.0, mem_per_worker_mb=32),
        StageSpec("prefetch", "prefetch", cost=0.06, serial_frac=0.05,
                  est_bias=1.0, mem_per_worker_mb=16,
                  mem_per_item_mb=batch_mb),
    )
    return StageGraph("custom_prod", stages, batch_mb=batch_mb,
                      target_rate=target_rate)


def multisource_dlrm_pipeline(batch_mb: float = 256.0,
                              target_rate: float = 30.0) -> StageGraph:
    """Production-shaped multi-source DLRM ingestion DAG.

    Zhao et al.'s DSI characterization: dense, sparse, and label streams
    are read from separate storage partitions and joined before the
    feature transforms. Sparse-ID reads dominate the I/O bytes and the
    feature transforms dominate CPU time (the GPU trainer is otherwise
    starved by online preprocessing), so `sparse_source` and
    `feature_udf` carry the heavy costs here; the UDF keeps the
    black-box est_bias that misleads static profilers.

        dense_source ─┐
        sparse_source ─┼─> join ─> feature_udf ─> batch ─> prefetch
        label_source ─┘
    """
    stages = (
        StageSpec("dense_source", "source", cost=0.12, serial_frac=0.10,
                  est_bias=0.8, mem_per_worker_mb=80),
        StageSpec("sparse_source", "source", cost=0.30, serial_frac=0.12,
                  est_bias=0.7, mem_per_worker_mb=112),
        StageSpec("label_source", "source", cost=0.03, serial_frac=0.05,
                  est_bias=1.0, mem_per_worker_mb=24),
        StageSpec("join", "join", cost=0.07, serial_frac=0.30,
                  est_bias=1.0, mem_per_worker_mb=48,
                  inputs=("dense_source", "sparse_source", "label_source")),
        StageSpec("feature_udf", "udf", cost=0.40, serial_frac=0.15,
                  est_bias=0.15, mem_per_worker_mb=64,
                  inputs=("join",)),
        StageSpec("batch", "batch", cost=0.11, serial_frac=0.25,
                  est_bias=1.0, mem_per_worker_mb=32,
                  inputs=("feature_udf",)),
        StageSpec("prefetch", "prefetch", cost=0.06, serial_frac=0.05,
                  est_bias=1.0, mem_per_worker_mb=16,
                  mem_per_item_mb=batch_mb, inputs=("batch",)),
    )
    return StageGraph("multisource_dlrm", stages, batch_mb=batch_mb,
                      target_rate=target_rate, edge_buffer_mb=32.0)


def stream_dlrm_pipeline(arrival: ArrivalProcess, *,
                         batch_mb: float = 64.0,
                         cost_scale: float = 1.0,
                         work: str = "spin") -> StageGraph:
    """Streaming-ingestion chain (benchmarks/fig_stream.py): a broker
    consumer ingesting live events instead of a disk source reading an
    infinite backlog.

        ingest(stream) -> decode -> feature_udf -> batch -> prefetch

    The cost profile is deliberately SKEWED toward the UDF (low serial
    fraction, ~10x the light stages): the even-split heuristic starves
    feature_udf badly, so its sustainable rate sits far below the
    water-filled oracle's — exactly the gap a 10x flash crowd exposes.
    Five stages, so the cached r5 pretrained agent transfers.
    """
    c = float(cost_scale)
    stages = (
        StageSpec("ingest", "stream", cost=0.04 * c, serial_frac=0.05,
                  mem_per_worker_mb=48, arrival=arrival),
        StageSpec("decode", "udf", cost=0.05 * c, serial_frac=0.05,
                  mem_per_worker_mb=32),
        StageSpec("feature_udf", "udf", cost=0.50 * c, serial_frac=0.02,
                  est_bias=0.15, mem_per_worker_mb=64),
        StageSpec("batch", "batch", cost=0.05 * c, serial_frac=0.10,
                  mem_per_worker_mb=32),
        StageSpec("prefetch", "prefetch", cost=0.03 * c, serial_frac=0.05,
                  mem_per_worker_mb=16, mem_per_item_mb=batch_mb),
    )
    return StageGraph("stream_dlrm", stages, batch_mb=batch_mb,
                      target_rate=arrival.batches_per_sec(0.0), work=work)


def make_pipeline(n_stages: int, seed: int = 0, batch_mb: float = 256.0,
                  target_rate: float = 10.0) -> StageGraph:
    """Randomized linear pipeline of a given length (offline RL pretraining
    uses a distribution over these; the paper trains one agent per length).
    The simulator's dynamics depend only on the per-stage rate vector, so
    agents pretrained on these chains transfer to DAGs of equal stage
    count (DESIGN.md §4)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    kinds = ["source"] + ["udf", "shuffle", "batch"][: max(n_stages - 2, 0)] \
        + ["prefetch"]
    while len(kinds) < n_stages:
        kinds.insert(1, "udf")
    kinds = kinds[:n_stages]
    stages = []
    for i, kind in enumerate(kinds):
        cost = float(rng.uniform(0.05, 0.5))
        bias = float(rng.uniform(0.3, 0.7)) if kind in ("udf", "source") \
            else 1.0
        stages.append(StageSpec(
            f"{kind}_{i}", kind, cost=cost,
            serial_frac=float(rng.uniform(0.02, 0.15)), est_bias=bias,
            mem_per_worker_mb=float(rng.uniform(16, 128)),
            mem_per_item_mb=batch_mb if kind == "prefetch" else 0.0))
    return StageGraph(f"rand{n_stages}_{seed}", tuple(stages),
                      batch_mb=batch_mb, target_rate=target_rate)
