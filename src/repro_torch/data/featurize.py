"""Real featurization work for the process plane: hash, pool, pad, collate.

`SpinWork` made the process executor's CPU demand *real* but synthetic —
a calibrated arithmetic loop. This module replaces the loop with the
actual per-batch featurization a DLRM ingestion pipeline runs (Zhao et
al.'s DSI breakdown: categorical hashing, multi-value pooling, sequence
padding, batch collation over raw click records), so `ProcessPipeline`
workers execute the same numpy code paths a production tf.data/DPP
worker would, and `repro.data.calibrate` fits curves over real code.

Two layers:

  1. PURE RECORD OPS (module functions): `hash_ids` (xxhash-style
     avalanche, deterministic across processes and interpreter seeds —
     golden-tested), `pool_pad` (multi-value pooling to a fixed hot
     size + padding short lists), `dense_transform`, `raw_block` /
     `featurize_block` / `shuffle_block` / `collate` (the per-stage
     transforms over synthetic Criteo-like records with a planted CTR
     signal, so a model trained on the pipeline's output learns).
  2. `FeaturizeWork`: the per-stage work function plugging those ops
     into `ProcessPipeline` via the exact `SpinWork` contract — same
     kind/serial-section/ballast knobs, same Amdahl coordination
     penalty, same clock discipline (`proc_executor._burn`). The stage's
     designed `cost` is realized by repeating the stage's own transform
     as the burn quantum against the kernel CPU clock, so designed cost
     == measured per-item CPU by construction AND the cycles burned are
     real featurization work, not spin. That identity is what keeps the
     calibration fit (`fit_amdahl` over CPU-normalized rates) valid on
     real-work stages: per-item CPU still varies as cost*(a*s + 1-s).

Every class and function here is picklable under both fork and spawn
(no closures, no bound locks at construction).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.data.pipeline import StageGraph, StageSpec
from repro_torch.data.proc_executor import SpinWork, _TICK_GUARD, _burn

# xxhash32 avalanche primes (finalizer constants)
_P2 = np.uint32(2246822519)
_P3 = np.uint32(3266489917)


# ---------------------------------------------------------------------------
# pure record ops (deterministic, golden-tested)
# ---------------------------------------------------------------------------

def hash_ids(raw_ids, vocab: int) -> np.ndarray:
    """xxhash-style categorical hash: raw ids -> table rows in [0, vocab).

    Pure integer avalanche (shift-xor-multiply finalizer) over the low 32
    bits — deterministic across processes, platforms, and RNG seeds (it
    reads no random state), which is what makes hashed features stable
    between a training run and its restarted resume.
    """
    x = np.asarray(raw_ids).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = x * _P2
    x = x ^ (x >> np.uint32(13))
    x = x * _P3
    x = x ^ (x >> np.uint32(16))
    return (x % np.uint32(vocab)).astype(np.int32)


def pool_pad(ids, lengths, hot: int) -> np.ndarray:
    """Multi-value pooling + padding: ragged id lists -> fixed (.., hot).

    ids: (..., K) hashed ids; lengths: (...) valid-prefix lengths in
    [1, K]. Lists longer than `hot` are truncated; shorter lists are
    padded by repeating their FIRST id (padding must be a valid table
    row, and repeating the head id keeps the bag-mean distribution
    closer to the unpadded list than a reserved zero row would).
    """
    ids = np.asarray(ids)
    k = ids.shape[-1]
    head = ids[..., :1]
    if k >= hot:
        out = ids[..., :hot]
    else:
        out = np.concatenate(
            [ids, np.broadcast_to(head, ids.shape[:-1] + (hot - k,))],
            axis=-1)
    valid = np.clip(np.asarray(lengths)[..., None], 1, hot)
    mask = np.arange(hot) < valid
    return np.where(mask, out, head).astype(np.int32)


def dense_transform(dense_raw) -> np.ndarray:
    """log1p + per-block standardization of the continuous features."""
    dense = np.log1p(np.asarray(dense_raw, np.float32))
    return ((dense - dense.mean(0)) / (dense.std(0) + 1e-6)).astype(
        np.float32)


@dataclass(frozen=True)
class RecordSpec:
    """Shape config for the synthetic click records flowing through a
    real-work pipeline (must match the consuming model's batch shape:
    `sparse_ids` (batch, n_sparse, hot) int32, `dense` (batch, n_dense)
    f32, `label` (batch,) f32)."""
    batch: int = 512
    n_sparse: int = 12
    n_dense: int = 13
    vocab: int = 1 << 16
    k_raw: int = 8          # raw multi-value list width (pre-pooling)
    hot: int = 4            # pooled bag size the model consumes
    seed: int = 0           # planted-signal weights (labels learnable)


def raw_block(rng: np.random.RandomState, rs: RecordSpec) -> dict:
    """One block of raw (pre-featurization) records with a planted CTR
    signal, so downstream training actually reduces loss."""
    w_rng = np.random.RandomState(rs.seed)
    w_dense = w_rng.randn(rs.n_dense) * 0.5
    w_sparse = w_rng.randn(rs.n_sparse) * 0.3
    n = rs.batch
    raw_ids = rng.randint(0, 1 << 31, size=(n, rs.n_sparse, rs.k_raw),
                          dtype=np.int64)
    lengths = rng.randint(1, rs.k_raw + 1,
                          size=(n, rs.n_sparse)).astype(np.int32)
    dense_raw = rng.lognormal(0.0, 1.0, size=(n, rs.n_dense))
    logit = dense_raw @ w_dense * 0.1 \
        + ((raw_ids[:, :, 0] % 97) / 97.0 - 0.5) @ w_sparse
    label = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return {"raw_ids": raw_ids, "lengths": lengths,
            "dense_raw": dense_raw.astype(np.float32), "label": label}


def shuffle_block(block: dict, rng: np.random.RandomState) -> dict:
    n = block["label"].shape[0]
    perm = rng.permutation(n)
    return {k: v[perm] for k, v in block.items()}


def featurize_block(block: dict, rs: RecordSpec) -> dict:
    """The feature UDF: hash raw ids, pool/pad multi-value lists, and
    normalize dense features — raw block in, model-ready block out."""
    hashed = hash_ids(block["raw_ids"], rs.vocab)
    sparse = pool_pad(hashed, block["lengths"], rs.hot)
    return {"sparse_ids": sparse,
            "dense": dense_transform(block["dense_raw"]),
            "label": block["label"]}


def collate(block: dict) -> dict:
    """Batch collation: contiguous, final-dtype arrays for device_put."""
    return {k: np.ascontiguousarray(v) for k, v in block.items()}


# ---------------------------------------------------------------------------
# the per-stage work function (the SpinWork contract over real ops)
# ---------------------------------------------------------------------------

# stage kind -> which transform this stage runs
_ROLES = {"source": "load", "shuffle": "shuffle", "udf": "featurize",
          "batch": "collate", "prefetch": "pass", "join": "join"}


class FeaturizeWork(SpinWork):
    """Picklable per-stage work fn burning real featurization CPU.

    Identical contract to `SpinWork` (see its docstring for the Amdahl
    coordination-penalty math: per-item CPU = cost * (a*s + 1 - s), so
    the measured service rate follows `stage_throughput` exactly), with
    two differences:

      - the item flowing downstream is a REAL record block: sources
        synthesize raw click records, the UDF hashes/pools/pads them,
        the batch stage collates — `get_batch()` hands the trainer a
        model-ready numpy batch;
      - the burn quantum is the stage's own transform over a resident
        scratch block (hashing for the UDF, permutation for shuffle,
        contiguous copies for collate, RNG draws for the source), run
        under the same `time.process_time` clock discipline as the spin
        burns. The real transform of the actual item is charged against
        the parallel portion, and the remaining budget is filled with
        quanta — so the designed cost is realized exactly while ~all
        cycles execute featurization code.
    """

    def __init__(self, role: str, cost: float, serial_frac: float = 0.0,
                 ballast_mb: float = 0.0, kind: str = "map",
                 record: Optional[RecordSpec] = None):
        super().__init__(cost, serial_frac, ballast_mb, kind)
        assert role in ("load", "shuffle", "featurize", "collate",
                        "pass", "join"), role
        self.role = role
        self.record = record if record is not None else RecordSpec()
        self._rng = None
        self._qrate = None       # quanta per CPU-second (sub-tick burns)
        self._q = None           # role-specific scratch for the quantum
        self._self_in = None     # cached input for standalone (calibration)

    # ---------------------------------------------------------- binding ---
    def bind(self, serial_lock, nworkers):
        """Worker-side setup: lock/pool-size attach + ballast (SpinWork),
        a per-process RNG (seeded from the pid so sibling workers draw
        distinct records), the quantum scratch block, and — only when
        this stage has sub-tick burn portions — a measured quantum rate
        (the real-work analog of `spin_rate` recalibration)."""
        self._lock = serial_lock
        self._workers = nworkers
        self._rng = np.random.RandomState(
            (os.getpid() * 1000003 + self.record.seed) % (1 << 31))
        self._setup_quantum()
        serial = self.serial_frac * self.cost
        par = self.cost - serial
        if 0 < serial < _TICK_GUARD or 0 < par < _TICK_GUARD:
            self._qrate = self._measure_qrate()
        self._touch_ballast()

    def _setup_quantum(self):
        rng = self._rng
        if self.role == "shuffle":
            self._q = rng.randn(2048, 16).astype(np.float32)
        elif self.role == "collate":
            self._q = rng.randn(256, 1024).astype(np.float32)
        elif self.role == "load":
            self._q = None                      # quantum draws fresh RNG
        else:                                   # featurize / pass / join
            self._q = rng.randint(0, 1 << 31, size=16384, dtype=np.int64)

    def _quantum(self):
        """One small (~0.1-0.5ms) unit of this stage's real work — what
        the clock-polled burn loop repeats to fill the designed cost."""
        if self.role == "shuffle":
            return self._q[self._rng.permutation(self._q.shape[0])]
        if self.role == "collate":
            return np.ascontiguousarray(self._q.T)
        if self.role == "load":
            return self._rng.lognormal(0.0, 1.0, size=8192)
        return hash_ids(self._q, self.record.vocab)

    def _measure_qrate(self, min_cpu_s: float = 0.12) -> float:
        """Quanta this process executes per CPU-second (only measured
        for stages with sub-tick burns, mirroring `spin_rate`)."""
        n = 0
        t0 = time.process_time()
        while time.process_time() - t0 < min_cpu_s:
            self._quantum()
            n += 1
        return max(n, 1) / max(time.process_time() - t0, 1e-3)

    def _do_burn(self, cpu_s: float):
        _burn(cpu_s, quantum=self._quantum, qrate=self._qrate)

    def release(self):
        super().release()
        self._q = None
        self._self_in = None

    # ------------------------------------------------------- production ---
    def _standalone_input(self):
        """Input block for a stage run standalone as a source (the
        calibration harness isolates every stage that way): generated
        once and reused, so the upstream transform's cost never leaks
        into this stage's measured curve."""
        if self._self_in is None:
            rng = self._rng if self._rng is not None \
                else np.random.RandomState(self.record.seed)
            blk = raw_block(rng, self.record)
            if self.role in ("collate", "pass"):
                blk = featurize_block(blk, self.record)
            self._self_in = blk
        return self._self_in

    def _produce(self, items):
        rng = self._rng if self._rng is not None \
            else np.random.RandomState(self.record.seed)
        if self.role == "load":
            return raw_block(rng, self.record)
        if self.kind == "join":
            return items
        blk = items[0] if items else self._standalone_input()
        if self.role == "shuffle":
            return shuffle_block(blk, rng)
        if self.role == "featurize":
            return featurize_block(blk, self.record)
        if self.role == "collate":
            return collate(blk)
        return blk                              # pass-through (prefetch)


def featurize_work_for(st: StageSpec, *, ballast: bool = True,
                       kind: Optional[str] = None,
                       record: Optional[RecordSpec] = None
                       ) -> FeaturizeWork:
    """One stage's FeaturizeWork: role from the spec's stage kind, the
    SpinWork wiring (kind/serial/ballast) from its topology + knobs."""
    role = _ROLES.get(st.kind, "pass")
    if kind is None:
        kind = "source" if not st.inputs \
            else ("join" if len(st.inputs) > 1 else "map")
    return FeaturizeWork(
        role, st.cost, st.serial_frac,
        ballast_mb=st.mem_per_worker_mb if ballast else 0.0,
        kind=kind, record=record)


def featurize_stage_fns(spec: StageGraph, *, ballast: bool = True,
                        record: Optional[RecordSpec] = None
                        ) -> Dict[str, FeaturizeWork]:
    """Real-featurization work fns for every stage of `spec` — the
    `work="real"` counterpart of `proc_executor.spin_stage_fns`. The
    sink delivers model-ready batches shaped by `record`."""
    return {st.name: featurize_work_for(st, ballast=ballast, record=record)
            for st in spec.stages}
