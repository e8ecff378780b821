#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure raises and the script
exits non-zero without printing a result:

  1. build    nvcc builds every kernel source under
              src/repro_torch/kernels/csrc for sm_90a (one nvcc per source,
              started together); prints ptxas' report of each kernel
              (registers, stack frame, spills; an embedding_bag_fwd
              kernel with a stack frame fails) and the card's name and
              power limit.
  2. kernels  each CUDA kernel against its plain PyTorch version on the
              card, at the main path's shapes (DLRM-Criteo: 26 tables of
              2^20 x 128 f32, batch 2048, bag 4; interaction (2048, 27,
              128)) and at ragged ones (batch 37, bag 1, mean, D not a
              multiple of 4; embedding_bag_fwd at D 1, 2, 3, 5, 8, 32,
              33, 128 and 132, B 1 and 37, bags 1, 3, 4, 16 and 17, f32
              and bf16 tables 16-, 2- and 4-byte aligned, ids of -1 and
              V; the scatter at D 1, 2, 3, 5, 8, 32, 128 and
              132 over 5 features, walked in groups of 2, at B 1 and 300
              and bags of 1, 4 and 17, with bags whose ids all repeat,
              bags padded by repeating their head id and ids of -1 and V;
              the interaction's backward at B 1, 37 and 2051, (F, D) (2,
              4), (27, 128), (27, 10) and (60, 32), and a feats 4- but not
              16-byte aligned); the forwards also with bf16 inputs (the
              TPU kernels' other dtype): embedding_bag_fwd at the main
              shape, dot_interact_fwd at F 2, 5, 27 and 60, B 1, 37 and
              2051, D 4, 7, 10, 32 and 128, feats 16-, 2- and 4-byte
              aligned. Tolerances: embedding_bag_fwd bitwise (f32 and
              bf16 tables); embedding_bag_bwd rtol 1e-5 / atol 1e-6
              (atomic order varies); dot_interact_fwd/bwd rtol 1e-5 / atol
              1e-4 against f32 cuBLAS with TF32 off, a bf16 out within 2
              bf16 ulps (rtol 2^-7, atol 1e-4). Times each kernel, its
              plain version and one PyTorch library call (device time
              from torch.profiler, from a window that holds every launch
              of the kernel and whose clock reads its reference spins
              within 8% of their CUDA-event time: see time_ms;
              launch-to-launch time from CUDA events), in f32 and, for
              the forwards, in bf16.
  3. model    DLRM forward + loss + backward through the kernels against
              the same model through the plain versions (2^16 rows, same
              parameters and batch): loss rtol 1e-5, each gradient within
              1e-4 of its L2 norm over the samples whose ReLUs agree on
              both paths (see phase_model).
  4. loop     the closed loop at the slice configuration
              (repro_torch.launch.train_dlrm_criteo.run_proc: ProcessPipeline
              + make_train_feed + FeedBackend + InTune, 40 steps, tune every
              2): loss finite, every kernel launched at least once a step.
  5. profile  one train step at the slice configuration under
              torch.profiler: device time by kernel.

The closed loop scored and resumed (slice 11), at the same widths:

  4a. idle_tail  run_proc held by a FrozenPolicy at the allocation the
              tuner served in an earlier run's tail, [2, 1, 1, 7, 1], for
              30 steps: loss finite, the allocation held, every kernel
              launched; each window's produced, consumed, batches, wall,
              settling flag, output queue and idle reading printed (the
              loop phase prints its own beside them).
  5a. train_feed  benchmarks/torch_fig_train_feed.py --model
              dlrm-criteo-1m --smoke: the even, static_best and intune
              arms, 80 steps each from the same seeded weights; each
              arm's losses finite and at least one scored window, every
              DLRM kernel launched; prints each arm's tail idle, step
              time, final workers, windows and idle series, and the idle
              reduction against even (report-only at smoke size). The
              intune arm's agent is pretrained (60 episodes of 300 ticks)
              in a process started before the build, on the last core.
  5b. checkpoint  run_proc with rows cut to 2^16 a table saves at step
              3; a second run_proc resumes with no step left, and its
              parameters, adagrad state and tuner (Q-network, agent steps,
              allocation) are bitwise the first's; a third trains 2 steps
              on, loss finite. The free disk is printed first.

GraphSAGE minibatch training (slice 2), graphsage-reddit at the
minibatch_lg widths: 1024 seed nodes, fanout 15-10, 602 features,
hidden 128, 47 classes, adam:

  2. kernels  (also) sage_aggregate_fwd and _bwd against their plain
              versions at the three shapes a train step gives them
              (neigh2 (15360, 10, 602) x (602, 128), neigh1 (1024, 15,
              602) x (602, 128), h1 (1024, 15, 128) x (128, 47)) and at
              ragged ones (B 37, F 1, D 5, H 7; H 130 over two column
              tiles; B 4225 with D 33: 32-row tiles, 4-byte copies; B
              1023 at F 15, D 602; F 43; D 300 at H 130; F 44 and 25
              at D 602; a neigh 8- or 4- but not 16-byte aligned, a
              slice of a larger buffer).
              The forward also with neigh and w bf16, or either alone, at
              every load width (16-, 4- and 2-byte loads of bf16) and at
              neigh2, timed there (a bf16 w's widening, sage_widen_w,
              beside w.float() and its bound). Tolerances: the f32
              aggregate (rows padded to a multiple of 4 floats) bitwise;
              out and d_neigh
              rtol 1e-5 / atol 1e-5 against f32 cuBLAS with TF32 off, a
              bf16 out within 2 bf16 ulps; d_w within 1e-5 of max
              |d_w| (a sum over up to 15360 rows in another order); a
              second run, out without the saved aggregate and d_w
              without d_neigh bitwise equal. Timed as above, each shape
              with its share of the bound and its ratio to the library
              call: torch.einsum("bfd,dh->bh") (the sum without the 1/F)
              for the forward and torch.mm(agg^T, d_out) for d_w (at h1,
              where the kernel writes d_neigh too, with (d_out w^T / F)
              broadcast over F and written out beside it).
  6. graph    the synthetic graph of minibatch_lg (232,965 nodes,
              114,615,892 edges, 602 random features a node), built once
              from seed 0 and shared by the phases below.
  7. gnn_model  the GraphSAGE loss and every gradient through the
              kernels against the same model through the plain versions,
              same parameters and batch: loss rtol 1e-5, each gradient
              within 1e-4 of its L2 norm over the seeds whose ReLU inputs
              and L2-norm clamps agree on both paths (phase_gnn_model).
  8. gnn_loop  the port's generic driver (repro_torch.launch.train.run)
              for 20 steps with InTune ticking: loss finite,
              sage_aggregate_fwd and _bwd launched at least 3 times a
              step; prints seed nodes/s, the loop step's time split into
              sampling + copy and the train step (host clock,
              synchronised; gnn_profile reads device time) and peak device
              memory.
  9. gnn_profile  one GNN train step under torch.profiler: device time
              by kernel.

wide-deep training (slice 3) at its published widths: 40 sparse features,
embed_dim 32, MLP 1024-512-256, 2^20 rows a table, bags of 4, row-wise
adagrad; the deep tables (40, 2^20, 32) go through embedding_bag_fwd and
the wide arm (40, 2^20) viewed as (40, 2^20, 1) through
embedding_bag_fused_fwd, both with embedding_bag_bwd as their backward:

 10. recsys_kernels  embedding_bag_fused_fwd bit-equal to
              embedding_bag_fwd and to the plain version at the wide
              arm's train shape (ids (65536, 40, 4) of the synthetic Criteo
              stream over (40, 2^20, 1), f32 and bf16), at serve_p99
              (batch 512), at reduced tables (8, 512, 8) and others with
              f32 and bf16 tables (bf16 also 2- and 4-byte aligned), with
              bag 1, bag 16 and mean, and with one out-of-range id (its
              row NaN in both kernels, the rest equal); embedding_bag_fwd
              bitwise and embedding_bag_bwd per feature at rtol 1e-5 /
              atol 1e-6 against their plain
              versions with the train shape's ids, on the wide arm (D = 1)
              and on the deep tables (40, 2^20, 32). Times at the train
              shape: the fused kernel, embedding_bag_fwd, the plain version
              and F.embedding_bag over the flattened (F*V, 1) table with
              offset ids, f32 and bf16, with the bound by 32-byte sectors
              (`sector_bound_ms`: the distinct sectors the gathers touch,
              counted on the card); embedding_bag_bwd at D = 1 (library:
              index_add_);
              and on the deep tables (D = 32) embedding_bag_fwd (library:
              F.embedding_bag over the flattened (F*V, 32) table) and
              embedding_bag_bwd (library: index_add_ into a (F*V, 32)
              gradient), each with its plain version and bound; the
              forward also with bf16 tables.
 11. recsys_model  wide-deep's loss and every gradient at the published
              widths (batch 4096) through the kernels against the plain
              versions, same parameters and batch: loss rtol 1e-5, each
              gradient within 1e-4 of its L2 norm over the samples whose
              ReLU inputs agree on both paths (as phase_model).
 12. recsys_loop  the generic driver (repro_torch.launch.train.run,
              --full --shape train_batch) for 20 steps: loss finite,
              embedding_bag_fused_fwd, embedding_bag_fwd and
              embedding_bag_bwd each launched at least 20 times; prints
              samples/s, the loop step split into batch + copy and the
              train step, peak device memory, the first and last loss.
 13. recsys_profile  one wide-deep train step under torch.profiler:
              device time by kernel, and each embedding kernel's time in
              the step (the forwards' go into their records).

The paper's DLRM at the reference's configuration, dlrm-criteo (slice
8): 26 x 2^22 x 128 bf16 tables, bf16 MLPs, row-wise adagrad, batch
65536, through the generic driver; the two DLRM backward kernels write
bf16 gradients:

 14. dlrm_bf16_bwd  embedding_bag_bwd into a bf16 gradient and
              dot_interact_bwd with bf16 d_out, feats and d_feats against
              their plain versions, at the training shapes (ids (65536,
              26, 1) of the Criteo stream into (26, 2^22, 128); (65536,
              27, 128)) and ragged ones (odd B, D 5, 7, 10 and 12, a
              29-row table whose ids repeat, bags padded by their head
              id, d_out and feats off a 16- or 4-byte boundary). The
              scatter bitwise on rows one bag slot names, else within 2
              bf16 ulps of the sum of its terms' magnitudes a slot plus
              2; the interaction within 2 bf16 ulps (rtol 2^-7, atol
              1e-5); the max ulp errors and the tolerance printed. Timed
              at the training shapes beside the plain version, the bound
              (2-byte gradients) and index_add_ into the bf16 gradient /
              bmm in bf16. The two bf16 forwards at the same training
              shapes: embedding_bag_fwd on a (26, 2^22, 128) bf16 table
              bitwise, dot_interact_fwd within 2 bf16 ulps (rtol 2^-7,
              atol 1e-4); each timed beside its plain version, bound and
              library call (F.embedding_bag; bmm and the triangle's
              gather).
 15. dlrm_model_bf16  the bf16 DLRM (2^16 rows, batch 4096) through the
              kernels against the plain versions: loss rtol 2^-8, each
              bf16 gradient within 2^-6 of its L2 norm over the samples
              whose ReLUs agree (at most 5% flip).
 16. dlrm_driver  repro_torch.launch.train.run("dlrm-criteo", full=True,
              shape=train_batch, steps=20, lr=0.02): loss finite and
              falling, peak device memory under 80 GB, every DLRM kernel
              launched at least 20 times; samples/s and the loop step
              split into batch + copy and the train step.
 17. dlrm_driver_profile  one dlrm-criteo train step under
              torch.profiler: device time by kernel, the four DLRM
              kernels' bf16 launches and time in the step.
 18. dlrm_retrieval  score_candidates at retrieval_cand (1,000,000
              candidates in 25 chunks) on that model, through the kernels
              and the plain versions: within 4 bf16 ulps of the largest
              score; host-clock seconds of each.

xDeepFM, DIEN and BERT4Rec (slice 9) at their published widths through
the generic driver at train_batch (65536), with the gradients of
SEQ_MICROBATCHES microbatches accumulated before each optimizer step:
xDeepFM's 39 tables (39, 2^20, 10) through embedding_bag_fwd and its
linear arm (39, 2^20) viewed as (39, 2^20, 1) through
embedding_bag_fused_fwd; DIEN's (2^20, 18) and BERT4Rec's (1048592, 64)
item tables gathered as bags of one through embedding_bag_fwd; the
scatter embedding_bag_bwd as the backward of each:

 19. recsys_seq_kernels  at a microbatch's lookups (xDeepFM's tables and
              linear arm, DIEN's history, BERT4Rec's sequence and its
              sampled-softmax candidates, 20 x 128 a sequence):
              embedding_bag_fwd bitwise to its plain version,
              embedding_bag_fused_fwd bitwise to it and to the row
              kernel, embedding_bag_bwd with non-negative d_out within
              rtol max(1e-5, 2 n 2^-24) / atol 1e-6 of its plain version
              on each row n ids name (BERT4Rec's MASK row takes 20 a
              sequence); each timed beside its plain version, its bound
              and its library call (F.embedding_bag over the flattened
              table; index_add_ into the flattened gradient).
 20. <arch>_model  (for each of the three) the loss and every gradient at
              the published widths (batch SEQ_MODEL_BATCH) through the
              kernels against the plain versions: loss rtol 1e-5, each
              gradient within 1e-4 of its L2 norm over the samples whose
              ReLU inputs agree on both paths (as phase_model).
 21. <arch>_driver  repro_torch.launch.train.run(arch, full=True,
              shape=train_batch, microbatches=k) for SEQ_STEPS steps:
              losses finite, peak device memory under the card's, each
              of the path's kernels launched as often as a microbatch
              needs; samples/s, the loop step split into batch + copy and
              the train step.
 22. <arch>_profile  one train step under torch.profiler: device time by
              kernel, the embedding kernels' time in the step.
 23. recsys_retrieval  score_candidates at retrieval_cand (1,000,000
              candidates in 25 chunks) for wide-deep, xDeepFM, DIEN and
              BERT4Rec at their published widths (random weights from a
              seed), through the kernels and through the plain versions:
              the scores finite and within rtol 1e-5 / atol 1e-5 of each
              other; host-clock seconds of each and peak memory.

GraphSAGE's full-graph and batched-small-graph regimes (slice 12) at the
published widths (2 layers, hidden 128, 47 classes, mean, adam): the
aggregate is the reference's gather and segment sum, in plain PyTorch
(models/segment.py, chunked), as the JAX package computes it in XLA;
no kernel of the port runs on these paths:

 9a. gnn_full_model  full_graph_sm (the whole Cora-sized graph, 2,708
              nodes, 1,433 features) and a molecule batch (128 graphs of
              up to 30 nodes): loss and every gradient on the card
              against the same model on the CPU, same parameters and
              numpy batch: loss rtol 1e-5, each gradient within 1e-4 of
              its L2 norm over the rows no ReLU or norm-clamp flip
              reaches (_check_full_model); the max aggregator's forward
              at full_graph_sm within rtol 1e-5 / atol 1e-6, NaN and inf
              in the same places.
 9b. gnn_full_graph  ogb_products (2,449,029 nodes, 61,859,140 edges, 100
              features): the graph's host build time; layer 1's chunked
              aggregate against one index_add_ over every edge at once
              (rtol 1e-5 / atol 1e-6); 10 full-batch steps of the generic
              driver: loss finite and falling, labelled nodes/s, the
              step's seconds, peak device memory under one (E, 128) f32
              message tensor (31.67 GB); one train step profiled.
 9c. gnn_molecule  the generic driver at molecule for 20 steps: loss
              finite, graphs/s, peak memory.

Launch counts are set to 0 just before each main path (the DLRM loop,
the held loop, the train-feed arms, the checkpoint round trip, the GNN
loop, the wide-deep loop, the dlrm-criteo driver, the xDeepFM,
DIEN and BERT4Rec drivers) and read just after it; the `kernels` line
reports each kernel's count from its own path (the DLRM kernels from
the DLRM loop, with `idle_tail_launches`, `train_feed_launches` and
`checkpoint_launches` beside; embedding_bag_fwd and _bwd with their
wide-deep counts beside too, the DLRM kernels' dlrm-criteo counts in their `dlrm_criteo` sub-records, and the
embedding kernels' counts on each of the three drivers in the
sub-records of that model's lookups: `xdeepfm_tables`,
`xdeepfm_linear`, `dien_hist`, `bert4rec_seq`, `bert4rec_cand`).

It prints a `kernels` JSON line (each record with the profiler events it
was read from; the forwards with a `bf16` sub-record at the 2048-row
shape, the four DLRM kernels with a `dlrm_criteo` one: bf16 at
dlrm-criteo's training shapes, with the driver's launches and each
kernel's time in its step), the card's name
and power limit, and as its last line `{"ok": true, "device": {...}}`.
It needs one CUDA card and exits 2 when there is none. It runs from the
root of the repository, whose kernel sources it builds: a copy of the
script elsewhere prints that src/repro_torch is missing and exits 2.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# a bf16 output (dot_interact_fwd, sage_aggregate_fwd) against its plain
# version: within 2 bf16 ulps (two roundings of f32 sums taken in another
# order), with the atol of the f32 check for sums that cancel
BF16_RTOL = 2.0 ** -7

STEPS = 40
TUNE_EVERY = 2
# the closed loop held at the allocation InTune served in the tail of an
# earlier run, where its windows read idle 1.0 (PERF.md §5)
IDLE_TAIL_WORKERS = (2, 1, 1, 7, 1)
IDLE_TAIL_STEPS = 30
# the checkpoint round trip: the slice configuration's widths with its
# rows cut to 2^16 a table (0.87 GB of tables, as much adagrad state)
CKPT_ROWS = 1 << 16
CKPT_STEPS = 4
GNN_STEPS = 20

RECSYS_STEPS = 20

# the reference DLRM through the generic driver: 20 steps at lr 0.02 (the
# rate of the closed loop's adagrad: at the driver's default 1e-3 under its
# 100-step warmup, 20 steps move the bf16 weights by less than their
# rounding, and the loss does not leave the batch-to-batch noise); its peak
# device memory stays under one H100's 80 GB
DRIVER_STEPS = 20
DRIVER_LR = 0.02
CARD_BYTES = 80e9
RETRIEVAL_CHUNKS = 25

# xDeepFM, DIEN and BERT4Rec through the generic driver at train_batch:
# SEQ_STEPS steps each, with the fewest microbatches (gradient
# accumulation) whose peak stays under 60 GB, three quarters of the card
# (PERF.md, on an NVIDIA H100 80GB HBM3 at 700.00 W: xDeepFM at 1 does not
# fit, at 2 peaks at 47.6 GB; DIEN at 1 at 53.4 GB; BERT4Rec at 4 at 71.5
# GB, at 8 at 36.7 GB); the model checks at a small batch
SEQ_STEPS = 5
SEQ_MICROBATCHES = {"xdeepfm": 2, "dien": 1, "bert4rec": 8}
SEQ_MODEL_BATCH = {"xdeepfm": 2048, "dien": 2048, "bert4rec": 512}

DLRM_KERNELS = ("embedding_bag_fwd", "embedding_bag_bwd", "dot_interact_fwd",
                "dot_interact_bwd")
GNN_KERNELS = ("sage_aggregate_fwd", "sage_aggregate_bwd")
RECSYS_KERNELS = ("embedding_bag_fused_fwd", "embedding_bag_fwd",
                  "embedding_bag_bwd")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# Late in a long process torch.profiler has recorded only 15 of 20
# launches of a kernel in a window, the missing ones at one end of it,
# whatever the window's length or a wait before and after it (H100, this
# script's recsys phase). So each window opens and closes with a few
# launches of a short spin kernel of PyTorch's (torch.cuda._sleep), left
# out of every sum, and a window that still holds too few events of the
# kernel under test is taken again.
SENTINEL = "spin_kernel"

# A window can also hold every launch and read every one short: one
# window of xDeepFM's embedding_bag_fwd read all 20 launches at 34.5-35.2
# us where the other windows of the same call read 72.0-74.7 us, and its
# short sentinels by the same factor, 0.47 (10.38 us for 16 against
# 21.73-21.93); another read both at 0.88 (H100; PERF.md §6). The window's
# timestamps ran at a wrong rate, not the kernel: CUDA events around the
# same calls read 0.077 ms. So each window also opens and closes with one
# reference spin of REF_CYCLES, timed beforehand by CUDA events
# (`spin_ms`), and a window that reads either of them more than CLOCK_TOL
# off that time is refused as a short window is. Windows that read right
# put the spin at 0.942-1.033 of its CUDA-event time, median 0.981 (the
# events' own cost), over 320 windows with and without 12 busy host
# processes (kernel_probes.py profiler); the tolerance takes them and
# refuses the 0.47 and 0.88 windows. Each window also waits PAD_S on the
# host at either end: without the wait, three windows in a row once lost
# 3, 10 and all 20 launches; with it, a window that lost launches lost 2
# or 3, at one end, and the next held all. Taking up to WINDOW_TRIES
# windows, not 3, leaves room for the windows the clock refuses; each one
# taken meets every check.
REF_CYCLES = 400_000        # about 0.2 ms at the H100's clock
CLOCK_TOL = 0.08
PAD_S = 0.05
WINDOW_TRIES = 5


def settle(attempt: int = 0):
    """The sentinel launches at either end of a profiled window, on an
    idle card, after PAD_S of host time: the reference spin, then the
    short ones."""
    import torch
    torch.cuda.synchronize()
    time.sleep(PAD_S)
    torch.cuda._sleep(REF_CYCLES)
    for _ in range(8 * (1 + attempt)):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def spin_ms() -> float:
    """The device time of one reference spin, torch.cuda._sleep(
    REF_CYCLES), from CUDA events around it while a spin twice as long
    holds the card (the spin is queued before the first event fires, so
    the events bracket it and not its launch): the least of 3."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(2 * REF_CYCLES)
        start.record()
        torch.cuda._sleep(REF_CYCLES)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def window_clock(prof, ref_ms: float):
    """The window's reading of its reference spins over their CUDA-event
    time (`spin_ms`): (least, largest) ratio of the two, or None if the
    profiler recorded neither."""
    spins = sorted(((e.time_range.end - e.time_range.start) / 1e3
                    for e in prof.events()
                    if SENTINEL in e.name and e.device_type.name == "CUDA"),
                   reverse=True)[:2]
    # the reference spins are the window's two longest; a short sentinel
    # is 1000 cycles
    spins = [ms for ms in spins if ms > ref_ms / 4]
    return (min(spins) / ref_ms, max(spins) / ref_ms) if spins else None


def clock_ok(clock) -> bool:
    return clock is not None and 1 - CLOCK_TOL <= clock[0] \
        and clock[1] <= 1 + CLOCK_TOL


class Timing(NamedTuple):
    ms: float         # device time a call (torch.profiler)
    wall: float       # launch to launch a call (CUDA events)
    events: int       # device events of the kernel under test (or of the
                      # call) in the profiled window
    clock: tuple = None   # the window's reading of its reference spins
                          # over their CUDA-event time (least, largest)


def _profiled(fn, args_list, calls: int, attempt: int):
    """(profile, {name: events}, summed device us, clock) of `calls` calls
    cycling through `args_list`, in one torch.profiler window opened and
    closed by the sentinel launches (left out); `clock` is
    `window_clock`'s."""
    from torch.profiler import ProfilerActivity, profile
    ref_ms = spin_ms()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        settle(attempt)
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        settle(attempt)
    device = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and SENTINEL not in e.key]
    return (prof, {e.key: e.count for e in device},
            sum(e.self_device_time_total for e in device),
            window_clock(prof, ref_ms))


def time_ms(fn, args_list, iters: int = 20, kernel: str = None) -> Timing:
    """Times `iters` calls, cycling through `args_list` (several input
    sets, so small inputs do not sit in the 50 MB L2). Device ms is the
    summed duration of every kernel, memset and copy the calls put on the
    card (torch.profiler, CUPTI), over `iters`; wall ms is CUDA events
    around the whole run, which for a call shorter than its host-side
    launch cost measures the launch, not the card. The profiled window
    must hold its full count of device events: at least `iters` named
    `kernel`, or, where `kernel` is None (a plain version or a library
    call, which may launch several kernels a call), `iters` times the
    events of one call, counted in windows of one call each (the larger
    count of two, or of up to five while they come back empty). The
    profiler has lost events (a window with none, or with 14 of 20
    launches, whose sum then read low; see SENTINEL), and a short window
    is profiled again; WINDOW_TRIES short ones in a row fail. So is a
    window whose clock reads its reference spins more than CLOCK_TOL off
    their CUDA-event time (`window_clock`)."""
    import torch
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    if kernel is None:
        # at least two windows; more (up to 5, each settled longer) while
        # none has recorded an event: a whole window can come back empty
        per_call = 0
        for attempt in range(5):
            per_call = max(per_call, sum(
                _profiled(fn, args_list, 1, attempt)[1].values()))
            if per_call and attempt:
                break
        if per_call < 1:
            raise RuntimeError("torch.profiler recorded no device event of "
                               "one call in 5 tries")
        need, what = iters * per_call, f"the call ({per_call} a call)"
    else:
        need, what = iters, kernel
    for attempt in range(WINDOW_TRIES):
        prof, counts, device_us, clock = _profiled(fn, args_list, iters,
                                                   attempt)
        events = sum(n for k, n in counts.items()
                     if kernel is None or kernel in k)
        if events >= need and clock_ok(clock):
            return Timing(device_us / 1e3 / iters, wall, events, clock)
        if events >= need:
            print(f"  torch.profiler read {device_us / 1e3 / iters:.4f} ms "
                  f"a call of {what} from a window with all {events} events "
                  f"whose clock read its reference spins at {clock} of "
                  f"their CUDA-event time; profiling again", flush=True)
            continue
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if kernel is not None and kernel in e.name
                       and e.device_type.name == "CUDA")
        span = (f"; the recorded ones span {spans[-1][1] - spans[0][0]:.1f}"
                f" us, {sum(b - a for a, b in spans) / len(spans):.1f} us "
                f"each" if spans else "")
        sentinels = sum(1 for e in prof.events() if SENTINEL in e.name
                        and e.device_type.name == "CUDA")
        print(f"  torch.profiler recorded {events} of {need} events of "
              f"{what} in {iters} calls{span}, {sentinels} of "
              f"{2 * (1 + 8 * (1 + attempt))} sentinels, window clock "
              f"{clock}; profiling again", flush=True)
    raise RuntimeError(f"torch.profiler gave no full window of {what} in "
                       f"{WINDOW_TRIES} tries: each held fewer than {need} "
                       f"events or read its reference spins off")


def kernel_record(tag, t: Timing, plain: Timing, lib, bound, err,
                  **extra) -> dict:
    """A kernel's record for the `kernels` line, printed: its device time
    and the events it was read from, launch to launch, its plain version's
    and library call's (a Timing, or None) times and the events each was
    read from, its bound, its max abs error."""
    bms, by = bound
    lib_s = "none" if lib is None else f"{lib.ms:.4f}"
    print(f"  {tag}: {t.ms:.4f} ms on the card ({t.events} events, window "
          f"clock {t.clock[0]:.3f}-{t.clock[1]:.3f}), "
          f"{t.wall:.4f} ms launch to launch (plain {plain.ms:.4f}, library "
          f"{lib_s}, bound {bms:.4f} by {by}; {bms / t.ms:.0%} of the "
          f"bound), max abs err {err:.3e}", flush=True)
    return {"ms": t.ms, "wall_ms": t.wall, "events": t.events,
            "window_clock": t.clock,
            "plain_ms": plain.ms, "plain_events": plain.events,
            "library_ms": None if lib is None else lib.ms,
            "library_events": None if lib is None else lib.events,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err, **extra}


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        print(f"== phase {self.name}", flush=True)

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== phase {self.name}: {time.monotonic() - self.t0:.1f} s",
                  flush=True)


def ptxas_report(log: str) -> dict:
    """{kernel: (registers, stack frame bytes, spill store bytes, spill
    load bytes)} from nvcc's `-Xptxas -v` output, each kernel by its
    mangled name."""
    import re
    rep, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rep[name] = [0, 0, 0, 0]
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                rep[name][1:] = [int(x) for x in m.groups()]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rep[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in rep.items()}


def phase_build(strict: bool = True):
    """Builds every kernel source and prints ptxas' report of each kernel
    built; if `strict`, fails if an instantiation of
    embedding_bag_fwd_kernel has a stack frame (its bag's words and sums
    are meant to stay in registers)."""
    from repro_torch.kernels import build
    logs = build.build_all()
    for name, out in sorted(logs.items()):
        for kernel, (regs, stack, st, ld) in ptxas_report(out).items():
            print(f"  [{name}] {kernel}: {regs} registers, {stack} bytes "
                  f"stack frame, {st}/{ld} bytes spill stores/loads")
            if strict and "embedding_bag_fwd_kernel" in kernel and stack:
                raise AssertionError(f"{kernel}: {stack} bytes stack frame")
    print(f"  built {sorted(build.SOURCES)} into {build.build_dir()}")
    print(f"  card: {card_line()}")


def _allclose(name, got, want, rtol, atol) -> float:
    import torch
    got, want = got.detach(), want.detach()
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def _check_bag(tables, ids, combiner, tag) -> dict:
    """Kernel vs plain, forward bitwise and backward allclose, sliced per
    feature so no full-size temporary is made. Returns max abs errors."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    got = eb.embedding_bag_fwd(tables, ids, combiner)
    want = ref.embedding_bag_ref(tables, ids, combiner=combiner)
    if not torch.equal(got, want):
        raise AssertionError(f"embedding_bag_fwd {tag} {combiner}: not "
                             f"bitwise equal to the plain version")
    d_out = torch.randn_like(got)
    f, v, _ = tables.shape
    g_k = eb.embedding_bag_bwd(d_out, ids, v, combiner)
    g_p = ref.embedding_bag_bwd_ref(d_out, ids, v, combiner=combiner)
    err = max(_allclose(f"embedding_bag_bwd {tag} {combiner} f={i}",
                        g_k[i], g_p[i], 1e-5, 1e-6) for i in range(f))
    return {"embedding_bag_fwd": 0.0, "embedding_bag_bwd": err}


def _ragged_bags(gen):
    """embedding_bag_fwd bitwise against its plain version at D 1, 2, 3,
    5, 6, 8, 10, 18, 32, 33, 34, 128 and 132, B 1 and 37, bags 1, 3, 4,
    16 and 17, sum and mean, f32 tables 16- and 4-byte aligned and bf16
    ones 16-, 2- and 4-byte aligned (a slice 0, 1 or 2 elements into a
    buffer): every load width (the f32 table at +1 element on 4-byte
    words), both walks, lanes from 1 to 32, both unroll bounds and a bag
    walked in chunks. Ids of -1 and V make exactly their own rows NaN,
    the rest equal. Prints the plan of each f32 narrow row (the flat
    walk)."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    n = 0
    for d in (1, 2, 3, 5, 6, 8, 10, 18, 32, 33, 34, 128, 132):
        f, v = 3, 1000
        buf = torch.randn(f * v * d + 2, device="cuda", generator=gen)
        for dtype, shift in ((torch.float32, 0), (torch.float32, 1),
                             (torch.bfloat16, 0), (torch.bfloat16, 1),
                             (torch.bfloat16, 2)):
            tables = buf.to(dtype)[shift:shift + f * v * d].view(f, v, d)
            plan = eb.fwd_plan(37, f, d, tables.element_size(),
                               tables.data_ptr() % 16)
            if dtype == torch.float32 and plan.lanes == 0:
                print(f"  embedding_bag_fwd ({f},{v},{d}) f32 +{shift} b37: "
                      f"plan {plan}")
            for b in (1, 37):
                for bag in (1, 3, 4, 16, 17):
                    ids = torch.randint(0, v, (b, f, bag), device="cuda",
                                        generator=gen, dtype=torch.int32)
                    tag = (f"({f},{v},{d}) {str(dtype)[6:]} +{shift} b{b} "
                           f"bag{bag}")
                    for combiner in ("sum", "mean"):
                        if not torch.equal(
                                eb.embedding_bag_fwd(tables, ids, combiner),
                                ref.embedding_bag_ref(tables, ids,
                                                      combiner=combiner)):
                            raise AssertionError(f"embedding_bag_fwd {tag} "
                                                 f"{combiner}: not bitwise "
                                                 f"equal to the plain version")
                        n += 1
                    bad = ids.clone()
                    bad[0, 0, 0] = -1
                    bad[b - 1, f - 1, bag - 1] = v
                    got = eb.embedding_bag_fwd(tables, bad)
                    nan = torch.isnan(got).any(-1)
                    want = ref.embedding_bag_ref(tables, ids)
                    if not (bool(torch.isnan(got[nan]).all())
                            and int(nan.sum()) == 2 and nan[0, 0]
                            and nan[b - 1, f - 1]
                            and torch.equal(got[~nan], want[~nan])):
                        raise AssertionError(f"embedding_bag_fwd {tag}: ids "
                                             f"-1 and V must poison exactly "
                                             f"their own rows")
    print(f"  embedding_bag_fwd bitwise to the plain version at {n} ragged "
          f"calls (D 1-132, B 1 and 37, bags 1-17, f32 at 16- and 4-byte "
          f"alignment, bf16 at 16-, 2- and 4-byte); ids -1 and V poison "
          f"their rows")


def _check_dot(feats, tag) -> dict:
    import torch
    from repro_torch.kernels import dot_interact as di, ref
    e_f = _allclose(f"dot_interact_fwd {tag}", di.dot_interact_fwd(feats),
                    ref.dot_interact_ref(feats), 1e-5, 1e-4)
    d_out = torch.randn((feats.shape[0], feats.shape[1]
                         * (feats.shape[1] - 1) // 2), device=feats.device)
    e_b = _allclose(f"dot_interact_bwd {tag}",
                    di.dot_interact_bwd(d_out, feats),
                    ref.dot_interact_bwd_ref(d_out, feats), 1e-5, 1e-4)
    return {"dot_interact_fwd": e_f, "dot_interact_bwd": e_b}


def _ragged_dots_bf16(gen) -> float:
    """dot_interact_fwd with bf16 feats against its plain version (within
    2 bf16 ulps) at F 2, 5, 27 and 60, B 1, 37 and 2051, D odd, 10, 32 and
    128, and feats at an offset of 0, 1 and 2 elements into a larger buffer
    (16-, 2- and 4-byte aligned: 16-byte copies, loads lane by lane,
    4-byte copies). Returns the max abs error."""
    import torch
    from repro_torch.kernels import dot_interact as di, ref
    err = 0.0
    for b, f, d in ((37, 5, 10), (1, 2, 4), (3, 60, 32), (37, 27, 128),
                    (2048 + 3, 27, 128), (37, 27, 7)):
        buf = torch.randn(b * f * d + 2, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        for shift in (0, 1, 2):
            x = buf[shift:shift + b * f * d].view(b, f, d)
            got = di.dot_interact_fwd(x)
            if got.dtype != torch.bfloat16:
                raise AssertionError(f"dot_interact_fwd bf16: out {got.dtype}")
            err = max(err, _allclose(
                f"dot_interact_fwd bf16 ({b},{f},{d}) offset {2 * shift} B",
                got, ref.dot_interact_ref(x), BF16_RTOL, 1e-4))
    return err


def _check_scatter(d_out, ids, v, combiner, tag) -> float:
    """embedding_bag_bwd against its plain version feature by feature at
    rtol 1e-5 / atol 1e-6, any id out of [0, V) adding nothing (the plain
    version sends it to one of two rows past V, which are dropped).
    Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    got = eb.embedding_bag_bwd(d_out, ids, v, combiner)
    ext = torch.where(ids < 0, v + 1, torch.where(ids >= v, v, ids))
    want = ref.embedding_bag_bwd_ref(d_out, ext, v + 2,
                                     combiner=combiner)[:, :v]
    return max(_allclose(f"embedding_bag_bwd {tag} {combiner} f={i}",
                         got[i], want[i], 1e-5, 1e-6)
               for i in range(got.shape[0]))


def _ragged_scatters(gen) -> float:
    """The scatter at every D the models use and around it (the even
    widths 6, 10, 18 and 34 on the flat walk's float2 atomics), over 5
    features (its walk's groups of 2 leave one over), at B 1 and 300 and
    bags of 1, 4 and 17: random ids (with the forward, bitwise), bags
    whose ids all repeat, bags padded by repeating their head id (the
    DLRM featurizer's padding), and ids of -1 and V; at the even widths
    also into a gradient 4-byte aligned (a slice 1 element into a buffer:
    one column a word), whose buffer outside the slice stays 0. The
    repeated ids get non-negative gradients: a row then sums many of
    them, and with signs a nearly cancelling row differs between any two
    orders of f32 atomics by more than atol. Prints the plan of each
    narrow row. Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb
    dev = torch.device("cuda")
    err = 0.0
    for d in (1, 2, 3, 5, 6, 8, 10, 18, 32, 34, 128, 132):
        f, v = 5, 2 ** 20 // d
        tables = torch.randn((f, v, d), device=dev, generator=gen)
        for b in (1, 300):
            for bag in (1, 4, 17):
                ids = torch.randint(0, v, (b, f, bag), device=dev,
                                    generator=gen, dtype=torch.int32)
                tag = f"({f},{v},{d}) b{b} bag{bag}"
                for combiner in ("sum", "mean"):
                    err = max(err, _check_bag(tables, ids, combiner,
                                              tag)["embedding_bag_bwd"])
                d_out = torch.randn((b, f, d), device=dev,
                                    generator=gen).abs()
                lengths = torch.randint(1, bag + 1, (b, f, 1), device=dev,
                                        generator=gen)
                bad = ids.clone()
                bad[0, f - 1, 0] = -1
                bad[b - 1, 0, bag - 1] = v
                for name, i in (
                        ("repeated", ids[..., :1].expand(b, f, bag)
                         .contiguous()),
                        ("head-padded", torch.where(
                            torch.arange(bag, device=dev) < lengths, ids,
                            ids[..., :1])),
                        ("out of range", bad)):
                    for combiner in ("sum", "mean"):
                        err = max(err, _check_scatter(d_out, i, v, combiner,
                                                      f"{tag} {name}"))
                if d % 4 == 2:
                    err = max(err, _check_scatter_shifted(d_out, bad, v,
                                                          tag))
        if d % 4:
            print(f"  embedding_bag_bwd ({f},{v},{d}) f32 b300: plan "
                  f"{eb.bwd_plan(300, f, v, d)}; +1 element: "
                  f"{eb.bwd_plan(300, f, v, d, 4)}")
    return err


def _check_scatter_shifted(d_out, ids, v, tag) -> float:
    """embedding_bag_scatter (sum and mean) into an f32 gradient 1
    element into a zeroed buffer (4-byte aligned: one column a word on
    the flat walk), ids of -1 and V adding nothing, against the plain
    version at rtol 1e-5 / atol 1e-6; the buffer outside the slice stays
    0. Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    b, f, _ = ids.shape
    d = d_out.shape[-1]
    ext = torch.where(ids < 0, v + 1, torch.where(ids >= v, v, ids))
    err = 0.0
    for combiner in ("sum", "mean"):
        buf = torch.zeros(f * v * d + 1, device=d_out.device)
        grad = buf[1:].view(f, v, d)
        if eb.bwd_plan(b, f, v, d, grad.data_ptr() % 16).vec != 1:
            raise AssertionError(f"embedding_bag_bwd {tag}: a 4-byte aligned "
                                 f"gradient must take one column a word")
        eb.embedding_bag_scatter(d_out, ids, grad, combiner)
        if bool(buf[0] != 0):
            raise AssertionError(f"embedding_bag_bwd {tag} +1 element: "
                                 f"writes outside its gradient")
        want = ref.embedding_bag_bwd_ref(d_out, ext, v + 2,
                                         combiner=combiner)[:, :v]
        err = max(err, max(_allclose(
            f"embedding_bag_bwd {tag} +1 element {combiner} f={i}", grad[i],
            want[i], 1e-5, 1e-6) for i in range(f)))
    return err


def phase_kernels(cfg) -> dict:
    """Every kernel against its plain version, then timed, at the main
    path's shapes. Returns one record per kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in ("embedding_bag_fwd", "embedding_bag_bwd",
                             "dot_interact_fwd", "dot_interact_bwd")}

    def note(e):
        for k, v in e.items():
            errs[k] = max(errs[k], v)

    # ragged shapes: batch 37, bag 1 and 3, mean, D not a multiple of 4
    for f, v, d, b, bag in ((3, 1000, 128, 37, 1), (3, 1000, 10, 37, 3),
                            (26, 4096, 128, 37, 4)):
        tables = torch.randn((f, v, d), device=dev, generator=gen)
        ids = torch.randint(0, v, (b, f, bag), device=dev, generator=gen,
                            dtype=torch.int32)
        for combiner in ("sum", "mean"):
            note(_check_bag(tables, ids, combiner, f"({f},{v},{d}) b{b}"))
    _ragged_bags(gen)
    note({"embedding_bag_bwd": _ragged_scatters(gen)})
    for b, f, d in ((37, 5, 10), (37, 27, 128), (1, 2, 4), (3, 60, 32)):
        note(_check_dot(torch.randn((b, f, d), device=dev, generator=gen),
                        f"({b},{f},{d})"))
    # the backward's persistent CTAs at B 1, 37 and 2051, and 4-byte copies
    # from a feats at a 4-byte offset
    for b in (1, 37, 2048 + 3):
        for f, d in ((2, 4), (27, 128), (27, 10), (60, 32)):
            buf = torch.randn(b * f * d + 1, device=dev, generator=gen)
            for shift in (0, 1):
                note(_check_dot(buf[shift:shift + b * f * d].view(b, f, d),
                                f"({b},{f},{d}) offset {4 * shift} B"))
    dot16_err = _ragged_dots_bf16(gen)

    # the main path's shapes: batch from the featurizer, full tables
    n_f, rows, dim = cfg.n_sparse, cfg.vocab_sizes[0], cfg.embed_dim
    rec = RecordSpec(batch=2048, n_sparse=n_f, n_dense=cfg.n_dense,
                     vocab=rows)
    host = featurize_block(raw_block(np.random.RandomState(1), rec), rec)
    ids = torch.as_tensor(host["sparse_ids"]).to(dev)
    b, _, bag = ids.shape
    tables = torch.empty((n_f, rows, dim), device=dev)
    tables.normal_(generator=gen).mul_(dim ** -0.5)
    note(_check_bag(tables, ids, "sum", "main"))
    feats = torch.randn((b, n_f + 1, dim), device=dev, generator=gen)
    note(_check_dot(feats, "main"))
    torch.cuda.empty_cache()

    out = {}
    ids_l = ids.long()
    flat = (ids_l + (torch.arange(n_f, device=dev) * rows)
            .view(1, n_f, 1)).reshape(b * n_f, bag)
    uniq = int(torch.unique(flat).numel())
    table_flat = tables.view(n_f * rows, dim)

    # embedding_bag_fwd
    print(f"  embedding_bag_fwd plan: {eb.fwd_plan(b, n_f, dim)} (f32), "
          f"{eb.fwd_plan(b, n_f, dim, 2)} (bf16)")
    t = time_ms(lambda: eb.embedding_bag_fwd(tables, ids), [()],
                kernel="embedding_bag_fwd_kernel")
    plain = time_ms(lambda: ref.embedding_bag_ref(tables, ids), [()])
    lib = time_ms(lambda: F.embedding_bag(flat, table_flat, mode="sum"),
                  [()])
    out["embedding_bag_fwd"] = kernel_record(
        "embedding_bag_fwd", t, plain, lib,
        bound_ms(ids.numel() * 4 + uniq * dim * 4 + b * n_f * dim * 4,
                 b * n_f * bag * dim), errs["embedding_bag_fwd"])

    # embedding_bag_bwd: the kernel scatter-adds into a zeroed gradient;
    # the zero fill belongs to the gradient's allocation and is timed
    # apart
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen)
    grad = torch.zeros_like(tables)
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    zero_ms = time_ms(lambda: grad.zero_(), [()], iters=5).ms
    del grad
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, ids, rows),
                    [()], iters=5)
    torch.cuda.empty_cache()
    upd = d_out[:, :, None, :].expand(b, n_f, bag, dim).reshape(-1, dim) \
        .contiguous()
    flat1 = flat.reshape(-1)
    grad_flat = torch.zeros((n_f * rows, dim), device=dev)
    lib = time_ms(lambda: grad_flat.index_add_(0, flat1, upd), [()])
    del grad_flat, upd
    out["embedding_bag_bwd"] = kernel_record(
        "embedding_bag_bwd", t, plain, lib,
        bound_ms(d_out.numel() * 4 + ids.numel() * 4 + 2 * uniq * dim * 4,
                 b * n_f * bag * dim), errs["embedding_bag_bwd"],
        zero_fill_ms=zero_ms)
    del d_out
    torch.cuda.empty_cache()

    # embedding_bag_fwd at the reference's bf16 tables (the same values,
    # rounded): bitwise to the plain version; bound at 2-byte elements
    tables16 = tables.to(torch.bfloat16)
    del tables, table_flat
    torch.cuda.empty_cache()
    if not torch.equal(eb.embedding_bag_fwd(tables16, ids),
                       ref.embedding_bag_ref(tables16, ids)):
        raise AssertionError("embedding_bag_fwd bf16 main: not bitwise "
                             "equal to the plain version")
    flat16 = tables16.view(n_f * rows, dim)
    out["embedding_bag_fwd"]["bf16"] = kernel_record(
        "embedding_bag_fwd bf16",
        time_ms(lambda: eb.embedding_bag_fwd(tables16, ids), [()],
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda: ref.embedding_bag_ref(tables16, ids), [()]),
        time_ms(lambda: F.embedding_bag(flat, flat16, mode="sum"), [()]),
        bound_ms(ids.numel() * 4 + uniq * dim * 2 + b * n_f * dim * 4,
                 b * n_f * bag * dim), 0.0)
    del tables16, flat16
    torch.cuda.empty_cache()

    # dot_interact: three input sets (85 MB) so the feats do not stay in L2
    fs = [(torch.randn((b, n_f + 1, dim), device=dev, generator=gen),)
          for _ in range(3)]
    n_pairs = (n_f + 1) * n_f // 2
    ii, jj = ref.tril_pairs(n_f + 1, dev)
    print(f"  dot_interact_fwd plan: {di.fwd_plan(b, n_f + 1, dim)}")
    out["dot_interact_fwd"] = kernel_record(
        "dot_interact_fwd",
        time_ms(di.dot_interact_fwd, fs, kernel="dot_interact_fwd_kernel"),
        time_ms(ref.dot_interact_ref, fs),
        time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj],
                fs),
        bound_ms(b * (n_f + 1) * dim * 4 + b * n_pairs * 4,
                 2 * b * n_pairs * dim), errs["dot_interact_fwd"])
    # bf16 feats: bf16 out within 2 ulps of the plain version's
    fs16 = [(x.to(torch.bfloat16),) for (x,) in fs]
    err16 = max(_allclose("dot_interact_fwd bf16 main",
                          di.dot_interact_fwd(x), ref.dot_interact_ref(x),
                          BF16_RTOL, 1e-4) for (x,) in fs16)
    print(f"  dot_interact_fwd bf16 plan: "
          f"{di.fwd_plan(b, n_f + 1, dim, 2)}")
    out["dot_interact_fwd"]["bf16"] = kernel_record(
        "dot_interact_fwd bf16",
        time_ms(di.dot_interact_fwd, fs16, kernel="dot_interact_fwd_kernel"),
        time_ms(ref.dot_interact_ref, fs16),
        time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj],
                fs16),
        bound_ms(b * (n_f + 1) * dim * 2 + b * n_pairs * 2,
                 2 * b * n_pairs * dim), err16)
    out["dot_interact_fwd"]["bf16"]["max_abs_err"] = max(err16, dot16_err)
    del fs16

    gs = [(torch.randn((b, n_pairs), device=dev, generator=gen), x)
          for (x,) in fs]
    sym = []
    for g, x in gs:
        s = torch.zeros((b, n_f + 1, n_f + 1), device=dev)
        s[:, ii, jj] = g
        sym.append((s + s.transpose(1, 2), x))
    out["dot_interact_bwd"] = kernel_record(
        "dot_interact_bwd",
        time_ms(di.dot_interact_bwd, gs, kernel="dot_interact_bwd_kernel"),
        time_ms(ref.dot_interact_bwd_ref, gs),
        time_ms(torch.bmm, sym),
        bound_ms(b * n_pairs * 4 + 2 * b * (n_f + 1) * dim * 4,
                 2 * b * (n_f + 1) ** 2 * dim), errs["dot_interact_bwd"])
    return out


def phase_model(cfg):
    """DLRM loss and gradients through the kernels vs the plain versions
    on the card, same parameters and batch (2^16 rows per table).

    The two paths' activations differ in the last bits (the interaction's
    f32 sums run in another order), so a pre-activation within rounding
    of 0 can take the other side of its ReLU on one path, which moves
    every gradient of that sample by its full size. Such samples are
    found from the recorded pre-activations and given loss weight 0;
    every gradient of the remaining samples' loss must then agree within
    1e-4 of its L2 norm, and the full-batch loss within rtol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm as dlrm_lib

    cfg = cfg.replace(vocab_sizes=(1 << 16,) * cfg.n_sparse)
    model = dlrm_lib.init_params(cfg, seed=0, device="cuda")
    rec = RecordSpec(batch=2048, n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                     vocab=cfg.vocab_sizes[0])
    batch = {k: torch.as_tensor(v).cuda() for k, v in featurize_block(
        raw_block(np.random.RandomState(2), rec), rec).items()}
    names, params = zip(*model.named_parameters())
    preacts = []
    for lin in list(model.bottom) + list(model.top)[:-1]:
        lin.register_forward_hook(lambda m, i, o: preacts.append(o.detach()))

    def per_sample_loss(**kw):
        z = model(batch, **kw)
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    ops.reset_launch_counts()
    loss_k = per_sample_loss()
    n_hooked = len(preacts)
    loss_p = per_sample_loss(bag_fn=ref.embedding_bag_ref,
                             interact_fn=ref.dot_interact_ref)
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(preacts[:n_hooked], preacts[n_hooked:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 100:
        raise AssertionError(f"{n_flip} samples flip a ReLU between the "
                             f"two paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError("model loss not finite")
    _allclose("model loss", loss_k.mean(), loss_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if min(counts.values()) < 1:
        raise AssertionError(f"model pass skipped a kernel: {counts}")
    grads_p = torch.autograd.grad((loss_p * keep).sum(), params)
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, grads_p):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"grad {n}: relative L2 error {rel:.3e}")
        worst = max(worst, rel)
    print(f"  loss kernels {float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of {loss_k.numel()} "
          f"samples flip a ReLU and are left out of the gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def phase_loop(cfg) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dlrm_criteo import run_proc

    # no checkpoint: one of the slice configuration is about 28 GB
    args = SimpleNamespace(steps=STEPS, batch=2048, tune_every=TUNE_EVERY,
                           finetune_ticks=90, device="cuda", seed=0,
                           ckpt_dir=None, ckpt_every=0)
    ops.reset_launch_counts()
    res = run_proc(args, cfg)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {STEPS} times "
                             f"on the main path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "device_step_s", "device_idle_frac",
                                   "workers", "max_memory_allocated",
                                   "teardown")}
    summary["loss_first"], summary["loss_last"] = res["losses"][0], \
        res["losses"][-1]
    summary["device_idle_trace"] = res["device_idle_trace"]
    summary["launches"] = counts
    print("  loop " + json.dumps(summary))
    print_windows("loop", res["windows"])
    torch.cuda.synchronize()
    return counts


def print_windows(tag, windows):
    """Each tuning window's raw readings (FeedBackend): idle is
    1 - min(batches, produced) * device step / wall, so it reads 1.0
    exactly when the pipe delivered nothing in the window."""
    for w in windows:
        print(f"  {tag} window " + json.dumps(w))
    ones = [w for w in windows if w["idle"] >= 1.0]
    print(f"  {tag}: {len(ones)} of {len(windows)} windows read idle 1.0; "
          f"produced in them {[w['produced'] for w in ones]}, batches "
          f"{[w['batches'] for w in ones]}, out queue "
          f"{[w['out_queue'] for w in ones]} at prefetch MB "
          f"{[w['prefetch_mb'] for w in ones]}, settling "
          f"{[w['settling'] for w in ones]}", flush=True)


def phase_idle_tail(cfg) -> dict:
    """The closed loop held by a FrozenPolicy at IDLE_TAIL_WORKERS, the
    tuner's served allocation in the tail of an earlier run (run_proc at
    the slice configuration, IDLE_TAIL_STEPS steps, tune every 2, the
    launch prefetch of 32 MB): loss finite, every DLRM kernel launched;
    prints each window's readings beside the tuned loop's."""
    import numpy as np
    import torch
    from repro_torch.api import FrozenPolicy
    from repro_torch.data.simulator import Allocation
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dlrm_criteo import run_proc

    args = SimpleNamespace(steps=IDLE_TAIL_STEPS, batch=2048,
                           tune_every=TUNE_EVERY, finetune_ticks=90,
                           device="cuda", seed=0, ckpt_dir=None,
                           ckpt_every=0)
    policy = FrozenPolicy(Allocation(np.array(IDLE_TAIL_WORKERS), 32.0))
    ops.reset_launch_counts()
    res = run_proc(args, cfg, policy=policy)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < IDLE_TAIL_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than "
                             f"{IDLE_TAIL_STEPS} times: {short}")
    held = [w["workers"] for w in res["windows"][1:]]
    if any(w != list(IDLE_TAIL_WORKERS) for w in held):
        raise AssertionError(f"the frozen allocation moved: {held}")
    print(f"  idle_tail at {list(IDLE_TAIL_WORKERS)}: "
          f"{res['samples_per_s']:.1f} samples/s, "
          f"{res['loop_step_s'] * 1e3:.1f} ms a loop step against a "
          f"{res['device_step_s'] * 1e3:.2f} ms device step; launches "
          f"{counts}", flush=True)
    print_windows("idle_tail", res["windows"])
    torch.cuda.synchronize()
    return counts


def start_agent_pretrain():
    """Pretrains the intune arm's agent for 5-stage pipelines
    (benchmarks/torch_common.get_agent_state: 60 episodes of 300 ticks on
    the analytic simulator, cached under build/agents) in a process of
    its own, on the host's last core and one thread, while the card runs
    the phases before train_feed. Returns the process."""
    core = (os.cpu_count() or 1) - 1
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    return subprocess.Popen(
        [sys.executable, "-c", "from benchmarks import torch_common; "
         "torch_common.get_agent_state(5)"], cwd=ROOT, env=env,
        preexec_fn=lambda: os.sched_setaffinity(0, {core}))


def phase_train_feed(agent_proc) -> dict:
    """benchmarks/torch_fig_train_feed.py at --model dlrm-criteo-1m
    --smoke: the three arms (even, static_best, intune) of TRAIN_FEED
    steps each, from the same seeded weights, on the card: every arm's
    loss finite and at least one scored tick, every DLRM kernel launched;
    prints each arm's tail idle, step time, final workers, ticks and idle
    series, and the idle reduction against even (report-only at smoke
    size, as in the reference)."""
    import torch
    from benchmarks import torch_fig_train_feed as tff
    from repro_torch.kernels import ops

    t0 = time.monotonic()
    rc = agent_proc.wait(timeout=600)
    if rc != 0:
        raise RuntimeError(f"the agent's pretraining exited {rc}")
    print(f"  agent pretrained (waited {time.monotonic() - t0:.1f} s)",
          flush=True)
    losses = {}
    ops.reset_launch_counts()
    payload = tff.main(["--model", "dlrm-criteo-1m", "--smoke"],
                       losses=losses)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    summary = {k: payload[k] for k in (
        "model", "device", "batch", "steps", "device_step_time_s",
        "idle_reduction_vs_even", "step_time_reduction_vs_even",
        "pass_20pct_bar")}
    summary["arms"] = {}
    for name, arm in payload["arms"].items():
        loss = torch.stack(losses[name]).float().cpu()
        if len(loss) != payload["steps"] or not torch.isfinite(loss).all():
            raise AssertionError(f"train_feed {name}: {len(loss)} losses, "
                                 f"not all finite: {loss.tolist()}")
        if arm["ticks"] < 1:
            raise AssertionError(f"train_feed {name}: no scored tick")
        summary["arms"][name] = dict(
            {k: arm[k] for k in ("idle_frac", "step_time_s", "workers_final",
                                 "ticks", "idle_series", "teardown")},
            loss_first=float(loss[0]), loss_last=float(loss[-1]))
    missing = [k for k, n in counts.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the train_feed "
                             f"path: {missing}")
    summary["launches"] = counts
    print("  train_feed " + json.dumps(summary), flush=True)
    return counts


def phase_checkpoint(cfg) -> dict:
    """The launcher's checkpoint round trip on the card, at the slice
    configuration's widths with CKPT_ROWS rows a table (a full-width
    checkpoint is about 28 GB): run_proc saves at step CKPT_STEPS - 1; a
    second run_proc with the same directory and no step left to run
    resumes, and its parameters, adagrad state and tuner state (the
    Q-network's weights, its step count and the allocation) are held
    bitwise against the first run's; a third trains 2 steps on from the
    checkpoint, loss finite."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dlrm_criteo import run_proc

    cut = dataclasses.replace(cfg, name=f"{cfg.name}-rows-2^16",
                              vocab_sizes=(CKPT_ROWS,) * cfg.n_sparse)
    d = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    state_gb = 2 * cfg.n_sparse * CKPT_ROWS * cfg.embed_dim * 4 / 1e9
    free_gb = shutil.disk_usage(d).free / 1e9
    print(f"  {cut.name}: rows cut 2^20 -> 2^16 a table, so a checkpoint "
          f"holds about {state_gb:.2f} GB of tables and adagrad state; "
          f"{free_gb:.1f} GB free on the disk of {d}", flush=True)
    if free_gb < 4 * state_gb:
        raise RuntimeError(f"{free_gb:.1f} GB free, under the "
                           f"{4 * state_gb:.1f} GB the round trip writes")
    args = dict(batch=2048, tune_every=TUNE_EVERY, finetune_ticks=90,
                device="cuda", seed=0, ckpt_dir=d, ckpt_every=CKPT_STEPS)
    try:
        ops.reset_launch_counts()
        t0 = time.monotonic()
        first = run_proc(SimpleNamespace(steps=CKPT_STEPS, **args), cut)
        save_s = time.monotonic() - t0
        counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
        short = {k: n for k, n in counts.items() if n < CKPT_STEPS}
        if short:
            raise AssertionError(f"kernels launched fewer than {CKPT_STEPS} "
                                 f"times: {short}")
        t0 = time.monotonic()
        again = run_proc(SimpleNamespace(steps=CKPT_STEPS, **args), cut)
        restore_s = time.monotonic() - t0
        if again["start"] != CKPT_STEPS or again["losses"]:
            raise AssertionError(f"resumed at {again['start']}, not "
                                 f"{CKPT_STEPS}")
        named = dict(again["model"].named_parameters())
        bad = [k for k, p in first["model"].named_parameters()
               if not torch.equal(p, named[k])]
        bad += [f"acc/{k}" for k, a in first["opt_state"]["acc"].items()
                if not torch.equal(a, again["opt_state"]["acc"][k])]
        st1, st2 = first["tuner"].state_dict(), again["tuner"].state_dict()
        bad += [f"qnet/{layer}/{k}" for layer, p in st1["agent"]["qnet"].items()
                for k, v in p.items()
                if not np.array_equal(v, st2["agent"]["qnet"][layer][k])]
        bad += [k for k in ("workers", "prefetch_mb") if st1[k] != st2[k]]
        if st1["agent"]["steps"] != st2["agent"]["steps"]:
            bad.append("agent steps")
        if bad:
            raise AssertionError(f"restored state differs: {bad}")
        n_params = len(named)
        del first, again, named
        torch.cuda.empty_cache()
        on = run_proc(SimpleNamespace(steps=CKPT_STEPS + 2, **args), cut)
        if on["start"] != CKPT_STEPS or len(on["losses"]) != 2 or \
                not all(math.isfinite(x) for x in on["losses"]):
            raise AssertionError(f"resumed run: start {on['start']}, "
                                 f"losses {on['losses']}")
        ckpt_gb = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(d) for f in fs) / 1e9
        print(f"  checkpoint: saved at step {CKPT_STEPS - 1} (run "
              f"{save_s:.1f} s), resumed with {n_params} parameters, "
              f"{n_params} adagrad accumulators and the tuner (agent steps "
              f"{st1['agent']['steps']}, workers {st1['workers']}, prefetch "
              f"{st1['prefetch_mb']} MB) bitwise (run {restore_s:.1f} s); "
              f"2 more steps from step {on['start']}, losses "
              f"{on['losses']}; {ckpt_gb:.2f} GB on disk; launches "
              f"{counts}", flush=True)
        del on
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def profile_steps(step, steps: int, kernels=()):
    """Device time by kernel of `steps` calls of step(k), k = 0, 1, ...:
    torch.profiler over a window that opens and closes with the sentinel
    launches (as time_ms's), taken again (up to WINDOW_TRIES times) until it holds
    `steps` events of each name in `kernels` and its clock reads its
    reference spins right (`window_clock`). Returns ([(kernel, device ms
    a step)] by time, host-clock ms a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(WINDOW_TRIES):
        ref_ms = spin_ms()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle(attempt)
            t0 = time.monotonic()
            for k in range(steps):
                step(k)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3 / steps
            settle(attempt)
        events = prof.key_averages()
        short = {k: n for k in kernels
                 for n in [sum(e.count for e in events if k in e.key)]
                 if n < steps}
        clock = window_clock(prof, ref_ms)
        if not clock_ok(clock):
            short["window clock"] = clock
        if not short:
            rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                           for e in events if SENTINEL not in e.key),
                          key=lambda r: -r[1])
            return rows, wall_ms
        print(f"  torch.profiler recorded {short} events in {steps} steps; "
              f"profiling again", flush=True)
    raise RuntimeError(f"torch.profiler recorded too few events in {steps} "
                       f"steps in {WINDOW_TRIES} tries: {short}")


def phase_profile(cfg):
    """Where one train step's device time goes at the slice configuration:
    torch.profiler over 3 steps on one featurized batch (after 2 warm-up
    steps), device time summed by kernel, against the host-clock step."""
    import numpy as np
    import torch
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.launch.train_dlrm_criteo import build_model

    dev = torch.device("cuda")
    model, opt, step_fn = build_model(cfg, seed=0, device=dev)
    state = opt.init(dict(model.named_parameters()))
    rec = RecordSpec(batch=2048, n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                     vocab=cfg.vocab_sizes[0])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in featurize_block(
        raw_block(np.random.RandomState(3), rec), rec).items()}
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3,
        ("embedding_bag_fwd_kernel", "dot_interact_fwd_kernel"))
    device_ms = sum(ms for _, ms in rows)
    print(f"  train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled)")
    for name, ms in rows[:10]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")

def _gnn_path_shapes(shape, cfg):
    """(tag, B, F, D, H, d_neigh needed) of the three sage_aggregate calls
    of one GraphSAGE train step (repro_torch.models.gnn)."""
    b, (f1, f2), d = shape.batch_nodes, shape.fanout, shape.d_feat
    return (("neigh2", b * f1, f2, d, cfg.d_hidden, False),
            ("neigh1", b, f1, d, cfg.d_hidden, False),
            ("h1", b, f1, cfg.d_hidden, cfg.n_classes, True))


def _check_sage(neigh, w, tag) -> dict:
    """Kernel vs plain on one input: the aggregate (its rows padded to a
    multiple of 4 floats) bitwise, out and d_neigh allclose, d_w within
    1e-5 of max |d_w|; out without the saved aggregate, d_w without
    d_neigh and a second run of each bitwise equal."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa
    b, f, d = neigh.shape
    out, agg = sa.sage_aggregate_fwd(neigh, w, save_agg=True)
    agg_p = ref.sage_mean_ref(neigh)
    if b > 1 and agg.stride(0) != sa.agg_stride(d):
        raise AssertionError(f"sage_aggregate_fwd {tag}: aggregate rows "
                             f"{agg.stride(0)} floats apart, not "
                             f"{sa.agg_stride(d)}")
    if not torch.equal(agg, agg_p):
        raise AssertionError(f"sage_aggregate_fwd {tag}: aggregate not "
                             f"bitwise equal to the plain version")
    out_only, none = sa.sage_aggregate_fwd(neigh, w)
    if none is not None or not torch.equal(out_only, out):
        raise AssertionError(f"sage_aggregate_fwd {tag}: out differs "
                             f"without the saved aggregate")
    if not torch.equal(sa.sage_aggregate_fwd(neigh, w, save_agg=True)[0],
                       out):
        raise AssertionError(f"sage_aggregate_fwd {tag}: two runs differ")
    e_f = _allclose(f"sage_aggregate_fwd {tag}", out,
                    ref.sage_aggregate_ref(neigh, w), 1e-5, 1e-5)
    d_out = torch.randn_like(out)
    d_neigh, d_w = sa.sage_aggregate_bwd(d_out, w, agg, f, True)
    want_n, want_w = ref.sage_aggregate_bwd_ref(d_out, w, agg_p, f)
    e_n = _allclose(f"sage_aggregate_bwd d_neigh {tag}", d_neigh, want_n,
                    1e-5, 1e-5)
    e_w = _allclose(f"sage_aggregate_bwd d_w {tag}", d_w, want_w, 0.0,
                    1e-5 * float(want_w.abs().max()))
    only_w = sa.sage_aggregate_bwd(d_out, w, agg, f, False)
    if only_w[0] is not None or not torch.equal(only_w[1], d_w):
        raise AssertionError(f"sage_aggregate_bwd {tag}: d_w differs "
                             f"without d_neigh")
    again = sa.sage_aggregate_bwd(d_out, w, agg, f, True)
    if not (torch.equal(again[0], d_neigh) and torch.equal(again[1], d_w)):
        raise AssertionError(f"sage_aggregate_bwd {tag}: two runs differ")
    return {"sage_aggregate_fwd": e_f, "sage_aggregate_bwd": max(e_n, e_w)}


def _check_sage_bf16(neigh, w, tag) -> float:
    """sage_aggregate_fwd with neigh or w (or both) bf16 against its plain
    version: the f32 aggregate bitwise, out (neigh's dtype) within 2 bf16
    ulps where it is bf16, rtol 1e-5 / atol 1e-5 where it is f32 (a bf16 w
    keeps the f32 tolerance of phase_sage_kernels); a bf16 w's widening
    kernel bitwise to w.float(). Returns the max abs error of out."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa
    if w.dtype == torch.bfloat16 and not torch.equal(sa.widen_w(w),
                                                     w.float()):
        raise AssertionError(f"widen_w {tag}: not w.float() bit for bit")
    out, agg = sa.sage_aggregate_fwd(neigh, w, save_agg=True)
    if out.dtype != neigh.dtype or agg.dtype != torch.float32:
        raise AssertionError(f"sage_aggregate_fwd {tag}: out {out.dtype}, "
                             f"aggregate {agg.dtype}")
    if not torch.equal(agg, ref.sage_mean_ref(neigh)):
        raise AssertionError(f"sage_aggregate_fwd {tag}: aggregate not "
                             f"bitwise equal to the plain version")
    if not torch.equal(sa.sage_aggregate_fwd(neigh, w)[0], out):
        raise AssertionError(f"sage_aggregate_fwd {tag}: out differs "
                             f"without the saved aggregate")
    rtol, atol = ((BF16_RTOL, 1e-5) if out.dtype == torch.bfloat16
                  else (1e-5, 1e-5))
    return _allclose(f"sage_aggregate_fwd {tag}", out,
                     ref.sage_aggregate_ref(neigh, w), rtol, atol)


def _ragged_sage_bf16(gen) -> float:
    """_check_sage_bf16 at every load width of a bf16 neigh (D 602: 4-byte
    loads; D 128: 16-byte; D 5 and a neigh 2-byte aligned: one element),
    w whole (H <= 128, rows 16-byte aligned or not) and in column tiles
    (H 130), tiles of 8 and 32 rows, and neigh or w alone in bf16."""
    import torch
    dev = torch.device("cuda")
    err = 0.0
    for tag, b, f, d, h, shift, dtypes in (
            ("ragged", 37, 1, 5, 7, 0, "bb"),
            ("ragged-h", 37, 3, 33, 130, 0, "bb"),
            ("ragged-b", 1023, 15, 602, 128, 0, "bb"),
            ("ragged-wide", 4225, 2, 34, 7, 0, "bb"),
            ("h1", 1024, 15, 128, 47, 0, "bb"),
            ("ragged-2b", 300, 10, 602, 128, 1, "bb"),
            ("ragged-4b", 300, 15, 128, 47, 2, "bb"),
            ("neigh only", 300, 10, 602, 128, 0, "bf"),
            ("w only", 300, 10, 602, 128, 0, "fb")):
        buf = torch.randn(b * f * d + shift, device=dev, generator=gen)
        neigh = buf.to(torch.bfloat16 if dtypes[0] == "b"
                       else torch.float32)[shift:].view(b, f, d)
        w = (torch.randn((d, h), device=dev, generator=gen) * d ** -0.5).to(
            torch.bfloat16 if dtypes[1] == "b" else torch.float32)
        err = max(err, _check_sage_bf16(neigh, w, f"{tag} {dtypes}"))
    return err


def phase_sage_kernels(shape, cfg) -> dict:
    """sage_aggregate_fwd and _bwd against their plain versions at the
    GNN path's three shapes and at ragged ones, then timed at the path's
    shapes. Returns one record per kernel: the top-level numbers are those
    of the main shape (neigh2); `per_shape` lists all three."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {k: 0.0 for k in GNN_KERNELS}

    def inputs(b, f, d, h, shift=0):
        # shift > 0: neigh is a slice `shift` floats into a larger buffer
        buf = torch.randn(b * f * d + shift, device=dev, generator=gen)
        neigh = buf[shift:].view(b, f, d)
        w = torch.randn((d, h), device=dev, generator=gen) * d ** -0.5
        return neigh, w

    path = _gnn_path_shapes(shape, cfg)
    # ragged shapes reach every variant of the forward: tiles of 8 or 32
    # rows, 4-, 8- or 16-byte loads of neigh (D odd, a base 4- or 8- but
    # not 16-byte aligned), w's rows 16-byte aligned or not (H 47, 7,
    # 130), one or two column tiles, B not a multiple of 4, F D = 2 mod 4
    # (neigh1's 15 x 602), many neighbours (F 44; the sampler's default
    # fanout 25), several tiles a CTA; and d_w's clusters of 2 and 8 with
    # one or more clusters a tile
    for tag, b, f, d, h, shift in (
            ("ragged", 37, 1, 5, 7, 0),
            ("ragged-h", 37, 3, 33, 130, 0),
            ("ragged-wide", 4225, 2, 33, 7, 0),
            ("ragged-b", 1023, 15, 602, 128, 0),
            ("ragged-f", 5, 43, 6, 47, 0),
            ("ragged-h2", 600, 10, 300, 130, 0),
            ("ragged-fc", 300, 44, 602, 128, 0),
            ("fanout25", 1024, 25, 602, 128, 0),
            ("ragged-8b", 300, 15, 128, 47, 2),
            ("ragged-4b", 300, 10, 602, 128, 1),
            ("ragged-8b-wide", 5000, 10, 602, 128, 2),
            *[(t, b, f, d, h, 0) for t, b, f, d, h, _ in path]):
        for k, v in _check_sage(*inputs(b, f, d, h, shift), tag).items():
            errs[k] = max(errs[k], v)
        torch.cuda.empty_cache()
    sage16_err = _ragged_sage_bf16(gen)

    per = {k: [] for k in GNN_KERNELS}
    print(f"  d_w clusters that fit the card at once, by size: "
          f"{ {c: sa.dw_active_clusters(dev, c) for c in (1, 2, 4, 8)} }")
    for tag, b, f, d, h, need_neigh in path:
        print(f"  {tag}: {sa.fwd_plan(b, f, d, h)}, "
              f"{sa.dw_plan(b, d, h, lambda c: sa.dw_active_clusters(dev, c))}")
        # enough input sets to cycle through more than the 50 MB L2
        n_sets = max(1, min(8, -(-64 * 2 ** 20 // (4 * b * f * d))))
        sets = [inputs(b, f, d, h) for _ in range(n_sets)]
        t = time_ms(lambda n, w: sa.sage_aggregate_fwd(n, w, True), sets,
                    kernel="sage_fwd_kernel")
        plain = time_ms(ref.sage_aggregate_ref, sets)
        lib = time_ms(lambda n, w: torch.einsum("bfd,dh->bh", n, w), sets)
        bms, by = bound_ms(4 * (b * f * d + d * h + b * h + b * d),
                           b * f * d + 2 * b * d * h)
        per["sage_aggregate_fwd"].append(
            {"shape": tag, "B": b, "F": f, "D": d, "H": h, "ms": t.ms,
             "wall_ms": t.wall, "events": t.events, "plain_ms": plain.ms,
             "plain_events": plain.events, "library_ms": lib.ms,
             "library_events": lib.events, "bound_ms": bms, "bound_by": by})
        if tag == path[0][0]:
            # bf16 neigh and w at the main shape: the aggregate bitwise,
            # out within 2 bf16 ulps; bound at 2-byte inputs and outputs
            sets16 = [(n.to(torch.bfloat16), w.to(torch.bfloat16))
                      for n, w in sets]
            err16 = max(_check_sage_bf16(n, w, f"{tag} bf16")
                        for n, w in sets16[:1])
            bf16 = kernel_record(
                f"sage_aggregate_fwd {tag} bf16",
                time_ms(lambda n, w: sa.sage_aggregate_fwd(n, w, True),
                        sets16, kernel="sage_fwd_kernel"),
                time_ms(ref.sage_aggregate_ref, sets16),
                time_ms(lambda n, w: torch.einsum("bfd,dh->bh", n, w),
                        sets16),
                bound_ms(2 * (b * f * d + d * h + b * h) + 4 * b * d,
                         b * f * d + 2 * b * d * h), err16)
            # the bf16 w's widening, a kernel of its own that the call
            # above launches first (its time is in the call's)
            wsets = [(w,) for _, w in sets16]
            wt = time_ms(sa.widen_w, wsets, kernel="widen_w_kernel")
            wl = time_ms(lambda x: x.float(), wsets)
            wb, wby = bound_ms(d * h * (2 + 4), 0)
            bf16["widen_w"] = {"ms": wt.ms, "wall_ms": wt.wall,
                               "events": wt.events, "library_ms": wl.ms,
                               "library_events": wl.events, "bound_ms": wb,
                               "bound_by": wby}
            print(f"    widen_w ({d}, {h}) bf16: {wt.ms:.4f} ms on the card "
                  f"({wt.events} events), {wt.wall:.4f} launch to launch "
                  f"(w.float() {wl.ms:.4f}, bound {wb:.4f} by {wby})")
            del sets16
        bsets = [(torch.randn((b, h), device=dev, generator=gen), w,
                  sa.sage_aggregate_fwd(n, w, True)[1]) for n, w in sets]
        del sets
        t = time_ms(
            lambda g, w, a: sa.sage_aggregate_bwd(g, w, a, f, need_neigh),
            bsets, kernel="sage_dw_kernel")
        plain = time_ms(lambda g, w, a: ref.sage_aggregate_bwd_ref(
            g, w, a, f, need_neigh=need_neigh), bsets)
        # one library call computes d_w alone (mm); with d_neigh, the
        # library's calls are that mm and (d_out @ w^T / F) broadcast over
        # the F neighbours, written out as the kernel writes d_neigh
        if need_neigh:
            lib = time_ms(lambda g, w, a: (
                torch.mm(a.t(), g), (g @ w.t() / f)[:, None, :]
                .expand(b, f, d).contiguous()), bsets)
        else:
            lib = time_ms(lambda g, w, a: torch.mm(a.t(), g), bsets)
        n_bytes = 4 * (b * h + b * d + d * h)
        flops = 2 * b * d * h
        if need_neigh:
            n_bytes += 4 * (d * h + b * f * d)
            flops += 2 * b * d * h
        bms, by = bound_ms(n_bytes, flops)
        per["sage_aggregate_bwd"].append(
            {"shape": tag, "B": b, "F": f, "D": d, "H": h,
             "d_neigh": need_neigh, "ms": t.ms, "wall_ms": t.wall,
             "events": t.events, "plain_ms": plain.ms,
             "plain_events": plain.events,
             "library_ms": None if lib is None else lib.ms,
             "library_events": None if lib is None else lib.events,
             "bound_ms": bms, "bound_by": by})
        del bsets
        torch.cuda.empty_cache()

    out = {}
    for name in GNN_KERNELS:
        main = per[name][0]
        out[name] = {k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "wall_ms",
                                          "events", "plain_events",
                                          "library_events")}
        out[name]["max_abs_err"] = errs[name]
        out[name]["per_step_ms"] = sum(r["ms"] for r in per[name])
        out[name]["per_step_bound_ms"] = sum(r["bound_ms"] for r in per[name])
        out[name]["per_shape"] = per[name]
        for r in per[name]:
            lib = "none" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f}"
            vs_lib = "" if r["library_ms"] is None \
                else f", {r['ms'] / r['library_ms']:.2f}x the library's"
            print(f"  {name} {r['shape']} ({r['B']}, {r['F']}, {r['D']}) x "
                  f"({r['D']}, {r['H']}): {r['ms']:.4f} ms on the card, "
                  f"{r['wall_ms']:.4f} ms launch to launch (plain "
                  f"{r['plain_ms']:.4f}, library {lib}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}; "
                  f"{r['bound_ms'] / r['ms']:.0%} of the bound{vs_lib})")
        print(f"  {name}: {out[name]['per_step_ms']:.4f} ms a train step "
              f"(bound {out[name]['per_step_bound_ms']:.4f}), max abs err "
              f"{errs[name]:.3e}")
    bf16["max_abs_err"] = max(bf16["max_abs_err"], sage16_err)
    out["sage_aggregate_fwd"]["bf16"] = bf16
    return out


def build_graph(shape, cfg):
    """The synthetic graph of `shape` and its sampler, as the port's
    driver builds it (repro_torch.launch.train.make_sampler)."""
    import numpy as np
    from repro_torch.launch.train import make_sampler
    t0 = time.monotonic()
    sampler = make_sampler(cfg, shape, np.random.RandomState(0))
    print(f"  {shape.n_nodes} nodes, {len(sampler.g.nbr)} edges, features "
          f"{sampler.x.shape} {sampler.x.dtype} "
          f"({sampler.x.nbytes / 1e6:.1f} MB) in "
          f"{time.monotonic() - t0:.1f} s")
    return sampler


def _gnn_batch(sampler, shape, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev)
            for k, v in sampler.sample(shape.batch_nodes).items()}


@contextlib.contextmanager
def recording_combine(gnn, rec):
    """Within the block, each hidden layer's combine of `gnn` also appends
    its pre-activation and its norm to `rec` (recomputed by the same
    operations on the same inputs, so with the same bits)."""
    import torch
    combine = gnn._sage_combine

    def wrapped(h_self, proj, layer, *, final):
        if not final:
            with torch.no_grad():
                pre = torch.matmul(h_self, layer.w_self) + proj + layer.b
                rec.append(pre)
                rec.append(torch.linalg.vector_norm(torch.relu(pre), dim=-1,
                                                    keepdim=True))
        return combine(h_self, proj, layer, final=final)
    gnn._sage_combine = wrapped
    try:
        yield
    finally:
        gnn._sage_combine = combine


def phase_gnn_model(shape, cfg, sampler):
    """GraphSAGE loss and gradients through the kernels vs the plain
    versions on the card, same parameters and batch, full width.

    As in phase_model, a ReLU input within rounding of 0 (or an L2 norm
    within rounding of its 1e-6 clamp) can fall on the other side on one
    path, which moves that seed's gradients by their full size. Such seeds
    are found from the recorded pre-activations and norms and given loss
    weight 0; every gradient of the remaining seeds' loss must then agree
    within 1e-4 of its L2 norm, and the full-batch loss within rtol
    1e-5."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import gnn

    dev = torch.device("cuda")
    model = gnn.init_params(cfg, shape.d_feat, seed=0, device=dev)
    batch = _gnn_batch(sampler, shape, dev)
    names, params = zip(*model.named_parameters())
    rec_k, rec_p = [], []
    ops.reset_launch_counts()
    with recording_combine(gnn, rec_k):
        nll_k = gnn.minibatch_nll(model, batch)
    with recording_combine(gnn, rec_p):
        nll_p = gnn.minibatch_nll(model, batch,
                                  agg_fn=ref.sage_aggregate_ref)
    b = nll_k.shape[0]
    flips = torch.zeros(b, dtype=torch.bool, device=dev)
    # rec alternates pre-activation (threshold 0) and norm (1e-6)
    for i, (a, p) in enumerate(zip(rec_k, rec_p)):
        t = 0.0 if i % 2 == 0 else 1e-6
        flips |= ((a > t) != (p > t)).reshape(b, -1).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > b // 100:
        raise AssertionError(f"{n_flip} seeds flip a ReLU or a norm clamp "
                             f"between the two paths")
    if not bool(torch.isfinite(nll_k).all()):
        raise AssertionError("GNN loss not finite")
    _allclose("GNN loss", nll_k.mean(), nll_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((nll_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in GNN_KERNELS}
    if min(counts.values()) < 3:
        raise AssertionError(f"GNN pass skipped a kernel call: {counts}")
    grads_p = torch.autograd.grad((nll_p * keep).sum(), params)
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, grads_p):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"GNN grad {n}: relative L2 error "
                                 f"{rel:.3e}")
        worst = max(worst, rel)
    print(f"  loss kernels {float(nll_k.detach().mean()):.7f} plain "
          f"{float(nll_p.detach().mean()):.7f}; {n_flip} of {b} seeds flip "
          f"a ReLU or norm clamp and are left out of the gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def phase_gnn_loop(shape, sampler) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run("graphsage-reddit", steps=GNN_STEPS, shape=shape,
                    full=True, device="cuda", sampler=sampler, log_every=5)
    counts = {k: ops.launch_counts()[k] for k in GNN_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"GNN loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < 3 * GNN_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {3 * GNN_STEPS} "
                             f"times on the GNN path: {short}")
    summary = {k: res[k] for k in ("seed_nodes_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary["loss_first"], summary["loss_last"] = res["losses"][0], \
        res["losses"][-1]
    summary["launches"] = counts
    print("  gnn_loop " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts


def phase_gnn_profile(shape, cfg, sampler):
    """Where one GNN train step's device time goes: torch.profiler over 3
    steps on one sampled block already on the card (after 2 warm-up
    steps), device time summed by kernel, against the host-clock step."""
    import torch
    from repro_torch.models import gnn
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    model = gnn.init_params(cfg, shape.d_feat, seed=0, device=dev)
    opt = make_optimizer("adam", lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(gnn.minibatch_loss, opt)
    batch = _gnn_batch(sampler, shape, dev)
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3,
        ("sage_fwd_kernel",))
    device_ms = sum(ms for _, ms in rows)
    sage_ms = sum(ms for name, ms in rows if "sage_" in name)
    print(f"  GNN train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); sage_aggregate "
          f"kernels {sage_ms:.3f} ms ({100 * sage_ms / device_ms:.1f}%)")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")


# ----------------------------------------- GraphSAGE's other regimes ---
# the ogb_products driver run: its peak device memory must stay under one
# (E, 128) f32 message tensor, 61,859,140 x 128 x 4 bytes
GNN_FULL_STEPS = 10
MOLECULE_STEPS = 20
MESSAGE_BYTES = 61_859_140 * 128 * 4


def _combine_flips(rec_a, rec_b):
    """(rows,) bool: rows of any recorded layer whose ReLU input (records
    0, 2, ...: threshold 0) or norm (1, 3, ...: its 1e-6 clamp) falls on
    the other side on the two paths."""
    import torch
    flips = None
    for i, (a, b) in enumerate(zip(rec_a, rec_b)):
        t = 0.0 if i % 2 == 0 else 1e-6
        f = ((a > t) != (b.to(a.device) > t)).reshape(a.shape[0], -1) \
            .any(dim=1)
        flips = f if flips is None else flips | f
    return flips if flips is not None else torch.zeros(0, dtype=torch.bool)


def _nll_on(gnn, model, batch, kind):
    """(per-row nll, per-row weight) of a full graph (nodes, the label
    mask) or a batch of small graphs (graphs, 1), with the hidden layers'
    ReLU inputs and norms recorded."""
    import torch
    rec = []
    with recording_combine(gnn, rec):
        if kind == "full_graph":
            nll, mask = gnn.full_graph_nll(model, batch)
        else:
            nll = gnn.batched_graphs_nll(model, batch)
            mask = torch.ones_like(nll)
    return nll, mask, rec


def _check_full_model(gnn, cfg, shape, batch_np):
    """The port's model of a full-graph or batched-small shape on the card
    against the same model on the CPU, same parameters and numpy batch:
    loss rtol 1e-5, each gradient within 1e-4 of its L2 norm.

    A ReLU input or norm within rounding of its threshold can fall on the
    other side on one device, which moves its node's gradients by their
    full size; such nodes are found from the recorded pre-activations,
    and the rows whose loss they reach get weight 0: in a full graph the
    node and every node it sends a message to (layer 2 aggregates layer
    1's output), in a batch of small graphs the node's graph."""
    import torch
    runs = []
    for dev in ("cpu", "cuda"):
        model = gnn.init_params(cfg, shape.d_feat, seed=0, device="cpu") \
            .to(dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        runs.append((model,) + _nll_on(gnn, model, batch, shape.kind))
    (m_c, nll_c, mask_c, rec_c), (m_g, nll_g, mask_g, rec_g) = runs
    flips = _combine_flips(rec_c, rec_g)
    n_flip = int(flips.sum())
    if shape.kind == "full_graph":
        src = torch.from_numpy(batch_np["edge_src"]).long()
        dst = torch.from_numpy(batch_np["edge_dst"]).long()
        real = dst < shape.n_nodes
        hit = flips.clone()
        hit[dst[real][flips[src[real]]]] = True
    else:
        hit = flips.reshape(batch_np["x"].shape[0], -1).any(dim=1)
    if n_flip > flips.numel() // 100:
        raise AssertionError(f"{n_flip} rows flip a ReLU or a norm clamp "
                             f"between the CPU and the card")
    loss_c = (nll_c * mask_c).sum() / mask_c.sum().clamp(min=1.0)
    loss_g = (nll_g * mask_g).sum() / mask_g.sum().clamp(min=1.0)
    if not bool(torch.isfinite(loss_g)):
        raise AssertionError(f"{shape.name} loss not finite on the card")
    _allclose(f"{shape.name} loss", loss_g.cpu(), loss_c, 1e-5, 0.0)
    keep_c = mask_c * (~hit).float()
    keep_g = mask_g * (~hit).float().to(mask_g.device)
    names, params_c = zip(*m_c.named_parameters())
    grads_c = torch.autograd.grad((nll_c * keep_c).sum() / keep_c.sum(),
                                  params_c)
    grads_g = torch.autograd.grad((nll_g * keep_g).sum() / keep_g.sum(),
                                  list(m_g.parameters()))
    worst = 0.0
    for n, gc, gg in zip(names, grads_c, grads_g):
        rel = float(torch.linalg.vector_norm(gg.cpu() - gc)
                    / torch.linalg.vector_norm(gc))
        if not rel <= 1e-4:
            raise AssertionError(f"{shape.name} grad {n}: relative L2 "
                                 f"error {rel:.3e}")
        worst = max(worst, rel)
    print(f"  {shape.name}: loss card {float(loss_g.detach()):.7f} cpu "
          f"{float(loss_c.detach()):.7f}; {n_flip} rows flip a ReLU or "
          f"norm clamp, {int(hit.sum())} of {hit.numel()} left out of the "
          f"gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e})")


def phase_gnn_full_model(arch):
    """graphsage-reddit at its published widths on full_graph_sm (the
    whole Cora-sized graph, 1,433 features) and on a molecule batch
    (128 graphs): loss and gradients on the card against the CPU
    (_check_full_model); and the max aggregator's forward at
    full_graph_sm, where isolated nodes send -inf and then NaN on, within
    rtol 1e-5 / atol 1e-6 with NaN and inf in the same places. None of
    the port's kernels runs on these paths."""
    import numpy as np
    import torch
    from repro_torch.data.graphs import full_graph_batch, molecule_batch
    from repro_torch.kernels import ops
    from repro_torch.models import gnn

    cfg = arch.model
    full = arch.shape("full_graph_sm")
    mol = arch.shape("molecule")
    full_np = full_graph_batch(full, cfg.n_classes, np.random.RandomState(0))
    ops.reset_launch_counts()
    _check_full_model(gnn, cfg, full, full_np)
    _check_full_model(gnn, cfg, mol, molecule_batch(
        mol, cfg.n_classes, np.random.RandomState(0)))
    max_cfg = cfg.replace(aggregator="max")
    outs = []
    for dev in ("cpu", "cuda"):
        model = gnn.init_params(max_cfg, full.d_feat, seed=0,
                                device="cpu").to(dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in full_np.items()}
        with torch.no_grad():
            outs.append(gnn.full_graph_forward(
                model, b["x"], gnn.graph_plan(b["edge_src"], b["edge_dst"],
                                              full.n_nodes)).cpu())
    want, got = outs
    for name, f in (("NaN", torch.isnan), ("inf", torch.isinf)):
        if not torch.equal(f(got), f(want)):
            raise AssertionError(f"max forward: {name} in other places "
                                 f"on the card")
    ok = torch.isfinite(want)
    err = _allclose("max forward", got[ok], want[ok], 1e-5, 1e-6)
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"a kernel ran on the full-graph path: "
                             f"{counts}")
    print(f"  max aggregator at {full.name}: logits agree (max abs err "
          f"{err:.3e}); {int(torch.isnan(want).any(dim=1).sum())} of "
          f"{full.n_nodes} nodes NaN on both (isolated nodes' -inf sent "
          f"on)")


def phase_gnn_full_graph(arch) -> dict:
    """graphsage-reddit at ogb_products (2,449,029 nodes, 61,859,140
    edges, 100 features) at its published widths: builds the graph (host
    seconds printed); holds layer 1's chunked aggregate against one
    index_add_ over every edge at once on the card (a 24.7 GB message
    tensor, freed after) within rtol 1e-5 / atol 1e-6, atomics adding in
    another order; runs the generic driver for GNN_FULL_STEPS full-batch
    steps (loss finite and falling, peak device memory under one (E, 128)
    f32 message tensor, no kernel launched); profiles one train step."""
    import numpy as np
    import torch
    from repro_torch.data.graphs import full_graph_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import gnn, segment
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg, shape = arch.model, arch.shape("ogb_products")
    n, e = shape.n_nodes, shape.n_edges
    t0 = time.monotonic()
    graph = full_graph_batch(shape, cfg.n_classes, np.random.RandomState(0))
    print(f"  graph: {n} nodes, {e} edges padded to "
          f"{graph['edge_src'].shape[0]}, x {graph['x'].shape} "
          f"({graph['x'].nbytes / 1e9:.2f} GB) built in "
          f"{time.monotonic() - t0:.1f} s on the host")

    dev = torch.device("cuda")
    x = torch.from_numpy(graph["x"]).to(dev)
    src = torch.from_numpy(graph["edge_src"]).to(dev)
    dst = torch.from_numpy(graph["edge_dst"]).to(dev)
    plan = gnn.graph_plan(src, dst, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    chunked = segment.segment_sum(x, plan) \
        / torch.clamp(plan.count, min=1.0)[:, None]
    torch.cuda.synchronize()
    t_chunked = time.monotonic() - t0
    t0 = time.monotonic()
    msg = x.index_select(0, src[:e])
    one_shot = torch.zeros_like(x).index_add_(0, dst[:e], msg)
    del msg
    deg = torch.bincount(dst[:e], minlength=n).clamp(min=1)
    one_shot /= deg[:, None].float()
    torch.cuda.synchronize()
    t_once = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    err = _allclose("ogb_products layer-1 aggregate", chunked, one_shot,
                    1e-5, 1e-6)
    print(f"  layer-1 mean aggregate, chunked ({segment.CHUNK_PAIRS} pairs "
          f"a chunk) against one index_add_: max abs err {err:.3e}; "
          f"{t_chunked * 1e3:.1f} ms against {t_once * 1e3:.1f} ms (host "
          f"clock, synchronised); the check's peak "
          f"{peak / 1e9:.2f} GB")
    del x, src, dst, plan, chunked, one_shot, deg
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    res = train.run("graphsage-reddit", steps=GNN_FULL_STEPS, shape=shape,
                    full=True, device="cuda", graph=graph, log_every=1)
    counts = ops.launch_counts()
    losses = res["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ogb_products loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ogb_products loss did not fall: {losses}")
    if res["max_memory_allocated"] >= MESSAGE_BYTES:
        raise AssertionError(
            f"ogb_products peak {res['max_memory_allocated'] / 1e9:.2f} GB "
            f"reaches one (E, 128) f32 message tensor, "
            f"{MESSAGE_BYTES / 1e9:.2f} GB")
    if any(counts.values()):
        raise AssertionError(f"a kernel ran on the full-graph path: "
                             f"{counts}")
    summary = {k: res[k] for k in ("nodes_per_s", "loop_step_s",
                                   "train_step_s", "max_memory_allocated")}
    summary.update(loss_first=losses[0], loss_last=losses[-1],
                   peak_gb=res["max_memory_allocated"] / 1e9)
    print("  gnn_full_graph " + json.dumps(summary))
    torch.cuda.empty_cache()

    model = gnn.init_params(cfg, shape.d_feat, seed=0, device=dev)
    opt = make_optimizer("adam", lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(gnn.full_graph_loss, opt)
    batch = {k: torch.from_numpy(graph[k]).to(dev) for k in ("x", "labels")}
    batch["plan"] = gnn.graph_plan(
        torch.from_numpy(graph["edge_src"]).to(dev),
        torch.from_numpy(graph["edge_dst"]).to(dev), n)
    del graph
    step_fn(model, state, 0, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 1 + k, batch), 1)
    device_ms = sum(ms for _, ms in rows)
    print(f"  ogb_products train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled)")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    return summary


def phase_gnn_molecule(arch) -> dict:
    """The generic driver at molecule (128 graphs of up to 30 nodes and 64
    edges a batch, published widths) for MOLECULE_STEPS steps: loss
    finite, no kernel launched; graphs/s and peak memory."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run("graphsage-reddit", steps=MOLECULE_STEPS,
                    shape=arch.shape("molecule"), full=True, device="cuda",
                    log_every=5)
    counts = ops.launch_counts()
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"molecule loss not finite: {res['losses']}")
    if any(counts.values()):
        raise AssertionError(f"a kernel ran on the molecule path: {counts}")
    summary = {k: res[k] for k in ("graphs_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary.update(loss_first=res["losses"][0], loss_last=res["losses"][-1])
    print("  gnn_molecule " + json.dumps(summary))
    torch.cuda.synchronize()
    return summary


def _criteo_batch(cfg, n, seed):
    """n synthetic Criteo records of the wide-deep widths through the
    driver's online feature work (numpy, on the host)."""
    from repro_torch.data.synthetic import CriteoStream
    stream = CriteoStream(n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                          vocab=cfg.vocab_sizes[0], multi_hot=cfg.multi_hot,
                          seed=seed)
    return stream.feature_udf(stream.raw_block(n))


def _check_fused(tables, ids, combiner, tag):
    """embedding_bag_fused_fwd, embedding_bag_fwd and the plain version:
    all bit-equal (or, with an out-of-range id, NaN in the same rows and
    bit-equal elsewhere)."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    row = eb.embedding_bag_fwd(tables, ids, combiner)
    nan = torch.isnan(row)
    if not nan.any() and not torch.equal(
            row, ref.embedding_bag_fused_ref(tables, ids, combiner=combiner)):
        raise AssertionError(f"embedding_bag_fwd {tag} {combiner}: not "
                             f"bitwise equal to the plain version")
    got = eb.embedding_bag_fused_fwd(tables, ids, combiner)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], row[~nan])):
        raise AssertionError(f"embedding_bag_fused_fwd {tag} {combiner}: "
                             f"not bitwise equal to embedding_bag_fwd")
    return int(nan.any(dim=-1).sum())


def phase_recsys_kernels(cfg) -> dict:
    """embedding_bag_fused_fwd against embedding_bag_fwd and the plain
    version (bitwise) at the wide arm's shapes and at ragged ones;
    embedding_bag_fwd/_bwd against their plain versions at the train
    shape on the wide arm and the deep tables; then the fused kernel
    timed at the wide arm's train shape beside the row kernel, the plain
    version and F.embedding_bag, and embedding_bag_bwd timed at D = 1.
    Returns the fused kernel's record and the row kernels' errors on
    this path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    n_f, rows = cfg.n_sparse, cfg.vocab_sizes[0]
    # the wide arm: (F, V) viewed as (F, V, 1), weights ~ 0.01 N(0, 1)
    wide = torch.empty((n_f, rows, 1), device=dev)
    wide.normal_(generator=gen).mul_(0.01)
    main = torch.as_tensor(_criteo_batch(cfg, 65536, 1)["sparse_ids"]) \
        .to(dev)
    serve = torch.as_tensor(_criteo_batch(cfg, 512, 2)["sparse_ids"]).to(dev)
    for combiner in ("sum", "mean"):
        _check_fused(wide, main, combiner, "train_batch (65536, 40, 4)")
        _check_fused(wide, serve, combiner, "serve_p99 (512, 40, 4)")
    for combiner in ("sum", "mean"):
        _check_fused(wide.to(torch.bfloat16), main, combiner,
                     "train_batch bf16")
    # ragged shapes, f32 and bf16 tables; the bf16 ones also 2- and 4-byte
    # aligned (a slice 1 or 2 elements into a larger buffer): every load
    # width of both kernels
    for f, v, d, b, bag in ((8, 512, 8, 4096, 4), (8, 512, 8, 37, 1),
                            (3, 1000, 5, 37, 16), (40, 4096, 1, 300, 16),
                            (6, 256, 32, 33, 3), (3, 1000, 10, 37, 3),
                            (26, 4096, 128, 37, 4)):
        buf = torch.randn(f * v * d + 2, device=dev, generator=gen)
        ids = torch.randint(0, v, (b, f, bag), device=dev, generator=gen,
                            dtype=torch.int32)
        for dtype, shift in ((torch.float32, 0), (torch.bfloat16, 0),
                             (torch.bfloat16, 1), (torch.bfloat16, 2)):
            tables = buf.to(dtype)[shift:shift + f * v * d].view(f, v, d)
            tag = f"({f},{v},{d}) b{b} bag{bag} {str(dtype)[6:]} +{shift}"
            for combiner in ("sum", "mean"):
                _check_fused(tables, ids, combiner, tag)
            bad = ids.clone()
            bad[b // 2, f - 1, 0] = v
            if _check_fused(tables, bad, "sum", f"{tag} out of range") != 1:
                raise AssertionError("an out-of-range id must poison "
                                     "exactly its own row")
    bad = serve.clone()
    bad[7, 3, 2] = -1
    if _check_fused(wide, bad, "sum", "serve_p99 out of range") != 1:
        raise AssertionError("an out-of-range id must poison exactly its "
                             "own row")
    print("  embedding_bag_fused_fwd bit-equal to embedding_bag_fwd and "
          "the plain version at every shape, f32 and bf16")

    # the row kernels at the path's train shape: the wide arm's D = 1
    # (262,144 ids a feature scattered over 2^20 rows) and the deep tables
    path_errs = _check_bag(wide, main, "sum", "wide arm train_batch")
    dim = cfg.embed_dim
    deep = torch.empty((n_f, rows, dim), device=dev)
    deep.normal_(generator=gen).mul_(0.01)
    for name, err in _check_bag(deep, main, "sum",
                                "deep tables train_batch").items():
        path_errs[name] = max(path_errs[name], err)
    torch.cuda.empty_cache()
    print(f"  embedding_bag_fwd/_bwd at (65536, 40, 4) x (40, 2^20, 1) and "
          f"x (40, 2^20, {cfg.embed_dim}): forward bit-equal, backward max "
          f"abs err {path_errs['embedding_bag_bwd']:.3e}")

    # timed at the train shape, cycling two id sets (84 MB) so the ids do
    # not sit in the 50 MB L2 from one launch to the next
    b, _, bag = main.shape
    sets = [(main,), (torch.as_tensor(_criteo_batch(cfg, 65536, 3)
                                      ["sparse_ids"]).to(dev),)]
    offs = (torch.arange(n_f, device=dev) * rows).view(1, n_f, 1)
    flat_sets = [((i.long() + offs).reshape(b * n_f, bag),) for (i,) in sets]
    uniq = int(torch.unique(flat_sets[0][0]).numel())
    print(f"  embedding_bag_fused_fwd plan: "
          f"{eb.fused_plan(b, n_f, rows, 1, bag)} (f32), "
          f"{eb.fused_plan(b, n_f, rows, 1, bag, 2)} (bf16); {uniq} "
          f"distinct rows of "
          f"{n_f * rows}")
    rec = None
    for dtype in (torch.float32, torch.bfloat16):
        table = wide.to(dtype)
        elem = table.element_size()
        # the 32-byte sectors the gathers touch (8 rows of f32, 16 of bf16)
        sectors = int(torch.unique(flat_sets[0][0] // (32 // elem)).numel())
        r = kernel_record(
            f"embedding_bag_fused_fwd (65536, 40, 4) x (40, 2^20, 1) "
            f"{str(dtype)[6:]}",
            time_ms(lambda i: eb.embedding_bag_fused_fwd(table, i), sets,
                    kernel="embedding_bag_fused_fwd_kernel"),
            time_ms(lambda i: ref.embedding_bag_fused_ref(table, i), sets),
            time_ms(lambda x: F.embedding_bag(x, table.view(n_f * rows, 1),
                                              mode="sum"), flat_sets),
            bound_ms(main.numel() * 4 + uniq * elem + b * n_f * 4,
                     b * n_f * bag), 0.0,
            embedding_bag_fwd_ms=time_ms(
                lambda i: eb.embedding_bag_fwd(table, i), sets,
                kernel="embedding_bag_fwd_kernel").ms,
            distinct_rows=uniq, sectors=sectors,
            sector_bound_ms=bound_ms(main.numel() * 4 + sectors * 32
                                     + b * n_f * 4, 0)[0])
        print(f"    {sectors} sectors of 32 B touched: sector bound "
              f"{r['sector_bound_ms']:.4f} ms; embedding_bag_fwd "
              f"{r['embedding_bag_fwd_ms']:.4f} ms")
        if rec is None:
            rec = r
        else:
            rec["bf16"] = r
        del table

    # embedding_bag_bwd at the wide arm's D = 1 (checked above; here grad
    # piles up over the timed calls, which changes no memory traffic)
    d_out = torch.randn((b, n_f, 1), device=dev, generator=gen)
    grad = torch.zeros_like(wide)
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, main, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, main, rows),
                    [()])
    upd = d_out.expand(b, n_f, bag).reshape(-1, 1).contiguous()
    idx = flat_sets[0][0].reshape(-1)
    lib = time_ms(lambda: grad.view(n_f * rows, 1).index_add_(0, idx, upd),
                  [()])
    rec["embedding_bag_bwd_d1"] = kernel_record(
        "embedding_bag_bwd at D = 1 (wide arm)", t, plain, lib,
        bound_ms(d_out.numel() * 4 + main.numel() * 4 + 2 * uniq * 4,
                 b * n_f * bag), path_errs["embedding_bag_bwd"])
    del grad, upd
    torch.cuda.empty_cache()

    # the deep tables (D = 32) with the same ids: embedding_bag_fwd against
    # F.embedding_bag over the flattened (F*V, 32) table, embedding_bag_bwd
    # against index_add_ into a (F*V, 32) gradient
    deep_flat = deep.view(n_f * rows, dim)
    print(f"  embedding_bag_fwd plan: {eb.fwd_plan(b, n_f, dim)} (f32), "
          f"{eb.fwd_plan(b, n_f, dim, 2)} (bf16)")
    rec["embedding_bag_fwd_d32"] = kernel_record(
        "embedding_bag_fwd at D = 32 (deep tables)",
        time_ms(lambda i: eb.embedding_bag_fwd(deep, i), sets,
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda i: ref.embedding_bag_ref(deep, i), sets, iters=5),
        time_ms(lambda x: F.embedding_bag(x, deep_flat, mode="sum"),
                flat_sets),
        bound_ms(main.numel() * 4 + uniq * dim * 4 + b * n_f * dim * 4,
                 b * n_f * bag * dim), 0.0)
    # the deep tables in bf16 (the same values, rounded): bitwise to the
    # plain version; bound at 2-byte elements
    deep16 = deep.to(torch.bfloat16)
    if not torch.equal(eb.embedding_bag_fwd(deep16, main),
                       ref.embedding_bag_ref(deep16, main)):
        raise AssertionError("embedding_bag_fwd bf16 deep arm: not bitwise "
                             "equal to the plain version")
    deep16_flat = deep16.view(n_f * rows, dim)
    rec["embedding_bag_fwd_d32"]["bf16"] = kernel_record(
        "embedding_bag_fwd at D = 32 (deep tables) bf16",
        time_ms(lambda i: eb.embedding_bag_fwd(deep16, i), sets,
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda i: ref.embedding_bag_ref(deep16, i), sets, iters=5),
        time_ms(lambda x: F.embedding_bag(x, deep16_flat, mode="sum"),
                flat_sets),
        bound_ms(main.numel() * 4 + uniq * dim * 2 + b * n_f * dim * 4,
                 b * n_f * bag * dim), 0.0)
    del deep16, deep16_flat
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen)
    grad = torch.zeros_like(deep)
    del deep, deep_flat
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, main, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, main, rows),
                    [()], iters=3)
    torch.cuda.empty_cache()
    upd = d_out[:, :, None, :].expand(b, n_f, bag, dim).reshape(-1, dim) \
        .contiguous()
    lib = time_ms(lambda: grad.view(n_f * rows, dim).index_add_(
        0, idx, upd), [()])
    rec["embedding_bag_bwd_d32"] = kernel_record(
        "embedding_bag_bwd at D = 32 (deep tables)", t, plain, lib,
        bound_ms(d_out.numel() * 4 + main.numel() * 4 + 2 * uniq * dim * 4,
                 b * n_f * bag * dim), path_errs["embedding_bag_bwd"])
    del grad, upd, d_out
    torch.cuda.empty_cache()
    return {"embedding_bag_fused_fwd": rec}, path_errs


def phase_recsys_model(cfg):
    """wide-deep's loss and gradients through the kernels vs the plain
    versions on the card, same parameters and batch, published widths,
    batch 4096. As in phase_model, samples whose MLP pre-activations take
    the other side of a ReLU on one path are given loss weight 0; every
    gradient of the others' loss must agree within 1e-4 of its L2 norm,
    and the full-batch loss within rtol 1e-5."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys

    dev = torch.device("cuda")
    model = recsys.init_model(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in _criteo_batch(cfg, 4096, 4).items()}
    names, params = zip(*model.named_parameters())
    preacts = []
    for lin in list(model.mlp)[:-1]:
        lin.register_forward_hook(lambda m, i, o: preacts.append(o.detach()))

    def per_sample_loss(**kw):
        z = model(batch, **kw)
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    ops.reset_launch_counts()
    loss_k = per_sample_loss()
    n_hooked = len(preacts)
    loss_p = per_sample_loss(bag_fn=ref.embedding_bag_fused_ref)
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(preacts[:n_hooked], preacts[n_hooked:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 100:
        raise AssertionError(f"{n_flip} samples flip a ReLU between the "
                             f"two paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError("wide-deep loss not finite")
    _allclose("wide-deep loss", loss_k.mean(), loss_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in RECSYS_KERNELS}
    if counts["embedding_bag_fused_fwd"] < 1 or \
            counts["embedding_bag_fwd"] < 1 or counts["embedding_bag_bwd"] < 2:
        raise AssertionError(f"wide-deep pass skipped a kernel: {counts}")
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, torch.autograd.grad(
            (loss_p * keep).sum(), params)):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"wide-deep grad {n}: relative L2 error "
                                 f"{rel:.3e}")
        worst = max(worst, rel)
    print(f"  loss kernels {float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of {loss_k.numel()} "
          f"samples flip a ReLU and are left out of the gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def phase_recsys_loop(arch) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run("wide-deep", steps=RECSYS_STEPS, full=True,
                    shape=arch.shape("train_batch"), device="cuda",
                    log_every=5)
    counts = {k: ops.launch_counts()[k] for k in RECSYS_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"wide-deep loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < RECSYS_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {RECSYS_STEPS} "
                             f"times on the wide-deep path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary["loss_first"], summary["loss_last"] = res["losses"][0], \
        res["losses"][-1]
    summary["launches"] = counts
    print("  recsys_loop " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts


def phase_recsys_profile(arch):
    """Where one wide-deep train step's device time goes: torch.profiler
    over 3 steps on one batch already on the card (after 2 warm-up
    steps), device time summed by kernel, against the host-clock step.
    Returns each embedding kernel's device ms a step."""
    import torch
    from repro_torch.models import recsys
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = arch.model
    model = recsys.init_model(cfg, seed=0, device=dev)
    opt = make_optimizer(arch.optimizer, lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(recsys.ctr_loss, opt)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in _criteo_batch(
        cfg, arch.shape("train_batch").batch, 6).items()}
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3,
        ("embedding_bag_fused_fwd_kernel", "embedding_bag_fwd_kernel",
         "embedding_bag_bwd_kernel"))
    device_ms = sum(ms for _, ms in rows)
    bag_ms = sum(ms for name, ms in rows if "embedding_bag" in name)
    print(f"  wide-deep train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); embedding_bag "
          f"kernels {bag_ms:.3f} ms ({100 * bag_ms / device_ms:.1f}%)")
    for name, ms in rows[:14]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    # the embedding kernels in the step: the scatter's <false, 4> is the
    # wide arm's D = 1, <true, 4> the deep tables' D = 32 (float4
    # atomics); the fused forward is the wide arm's
    in_step = {}
    for name, ms in rows:
        for kernel in ("embedding_bag_bwd_kernel",
                       "embedding_bag_fused_fwd_kernel",
                       "embedding_bag_fwd_kernel"):
            if kernel in name:
                print(f"  {kernel[:-7]} in the step: {ms:.4f} ms  "
                      f"{name[:70]}")
                in_step[kernel[:-7]] = in_step.get(kernel[:-7], 0.0) + ms
    return in_step


# ---- slice 8: the reference DLRM (bf16, row-wise adagrad) -------------

def _bf16_ulp(x):
    """One bf16 ulp at |x| (2^-7 of its power of two), elementwise; the
    smallest normal's at 0."""
    import torch
    x = x.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _check_scatter_bf16(d_out, ids, v, combiner, tag) -> tuple:
    """embedding_bag_bwd into a bf16 gradient against its plain version
    (f32 sums rounded once), over the rows the ids touch (no f32
    temporary of the table's size): bitwise on every row that one bag
    slot names; a row that n slots name within 2 bf16 ulps of the sum of
    its terms' magnitudes a slot, plus 2 (each bf16 atomic rounds the
    row's running sum, in an order that varies between runs); every
    other row 0. Returns (max error in bf16 ulps of that sum, the largest
    tolerance used in the same unit, rows touched once, rows touched
    more than once)."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    b, f, bag = ids.shape
    d = d_out.shape[-1]
    got = eb.embedding_bag_bwd(d_out, ids, v, combiner,
                               dtype=torch.bfloat16)
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"embedding_bag_bwd bf16 {tag}: {got.dtype}")
    flat = (torch.arange(f, device=ids.device).view(1, f, 1) * v
            + ids.long()).reshape(-1)
    rows, slot, touches = torch.unique(flat, return_inverse=True,
                                       return_counts=True)
    g = d_out.float()
    if combiner == "mean":
        g = g / torch.full((), bag, dtype=g.dtype, device=g.device)
    mag = torch.zeros((rows.numel(), d), device=g.device)
    mag.index_add_(0, slot, g.abs()[:, :, None, :].expand(b, f, bag, d)
                   .reshape(-1, d))
    nonzero = sum(int(torch.count_nonzero(got[i])) for i in range(f))
    got_rows = got.view(-1, d)[rows]
    del got
    want = ref.embedding_bag_bwd_ref(d_out, ids, v, combiner=combiner,
                                     dtype=torch.bfloat16).view(-1, d)[rows]
    once = touches == 1
    if not torch.equal(got_rows[once], want[once]):
        raise AssertionError(f"embedding_bag_bwd bf16 {tag} {combiner}: a "
                             f"row touched once is not bitwise the plain "
                             f"version")
    if nonzero != int(torch.count_nonzero(got_rows)):
        raise AssertionError(f"embedding_bag_bwd bf16 {tag} {combiner}: "
                             f"writes outside the rows its ids name")
    ulps = (got_rows.float() - want.float()).abs() / _bf16_ulp(mag)
    tol = 2.0 * (touches + 1).view(-1, 1).float()
    if bool((ulps > tol).any()):
        raise AssertionError(f"embedding_bag_bwd bf16 {tag} {combiner}: "
                             f"{int((ulps > tol).sum())} elements off, max "
                             f"{float(ulps.max()):.2f} ulps")
    return (float(ulps.max()) if ulps.numel() else 0.0,
            float(tol.max()) if tol.numel() else 0.0, int(once.sum()),
            int((~once).sum()))


def _check_dot_bf16(d_out, feats, tag) -> tuple:
    """dot_interact_bwd with bf16 d_out and feats against its plain
    version (f32 sums rounded once) within 2 bf16 ulps (rtol 2^-7, atol
    1e-5). Returns (max abs error, max error in bf16 ulps of the plain
    value)."""
    from repro_torch.kernels import dot_interact as di, ref
    got = di.dot_interact_bwd(d_out, feats)
    want = ref.dot_interact_bwd_ref(d_out, feats)
    err = _allclose(f"dot_interact_bwd bf16 {tag}", got.float(),
                    want.float(), BF16_RTOL, 1e-5)
    ulps = float(((got.float() - want.float()).abs()
                  / _bf16_ulp(want.float())).max())
    return err, ulps


def phase_dlrm_bf16_bwd(arch) -> dict:
    """The two DLRM backward kernels with bf16 gradients against their
    plain versions on the card, at the training shapes of dlrm-criteo
    (ids (65536, 26, 1) of the synthetic Criteo stream into (26, 2^22,
    128) bf16 tables; the interaction at (65536, 27, 128)) and at ragged
    ones (odd B, D % 8 != 0, a table of 29 rows so that ids repeat, bags
    of 4 padded by their head id, d_out or feats off a 16- or 4-byte
    boundary); and the two bf16 forwards at the same training shapes
    (embedding_bag_fwd bitwise, dot_interact_fwd within 2 bf16 ulps).
    Each of the four is timed at the training shapes beside its plain
    version, its bound and one PyTorch call (F.embedding_bag on the bf16
    table; index_add_ into the bf16 gradient; bmm in bf16, and for the
    forward its lower triangle gathered). Returns the four bf16 records
    at the training shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(8)
    cfg = arch.model
    worst = {"scatter": [0.0, 0.0], "dot": [0.0, 0.0]}

    def note(kind, e):
        worst[kind] = [max(a, b) for a, b in zip(worst[kind], e)]

    # ragged
    for b, f, v, d, bag in ((301, 3, 29, 5, 1), (301, 3, 29, 128, 4),
                            (37, 5, 4096, 12, 4), (1, 2, 29, 8, 17)):
        ids = torch.randint(0, v, (b, f, bag), device=dev, generator=gen)
        ids[..., bag // 2:] = ids[..., :1]
        ids = ids.to(torch.int32)
        buf = torch.randn(b * f * d + 1, device=dev, generator=gen)
        for shift in (0, 1):
            d_out = buf[shift:shift + b * f * d].view(b, f, d)
            for combiner in ("sum", "mean"):
                note("scatter", _check_scatter_bf16(
                    d_out, ids, v, combiner,
                    f"({b},{f},{v},{d}) bag{bag} +{4 * shift} B")[:2])
    for b, f, d in ((2051, 27, 10), (37, 27, 7), (301, 5, 12), (1, 2, 4),
                    (2051, 27, 128), (3, 60, 32)):
        p = f * (f - 1) // 2
        xb = torch.randn(b * f * d + 2, device=dev, generator=gen).to(bf16)
        gb = torch.randn(b * p + 1, device=dev, generator=gen).to(bf16)
        for shift in (0, 1, 2):
            for gshift in (0, 1):
                note("dot", _check_dot_bf16(
                    gb[gshift:gshift + b * p].view(b, p),
                    xb[shift:shift + b * f * d].view(b, f, d),
                    f"({b},{f},{d}) feats +{2 * shift} B d_out "
                    f"+{2 * gshift} B"))
    print(f"  ragged: scatter max {worst['scatter'][0]:.2f} bf16 ulps "
          f"(tolerance up to {worst['scatter'][1]:.0f}), interaction max "
          f"abs err {worst['dot'][0]:.3e}, {worst['dot'][1]:.2f} ulps")

    # the training shapes
    n_f, rows, dim = cfg.n_sparse, cfg.vocab_sizes[0], cfg.embed_dim
    batch = arch.shape("train_batch").batch
    ids = torch.as_tensor(_criteo_batch(cfg, batch, 9)["sparse_ids"]) \
        .to(dev)
    b, _, bag = ids.shape
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen) \
        .to(bf16).float()
    e_ulps, tol, once, more = _check_scatter_bf16(d_out, ids, rows, "sum",
                                                  "main")
    print(f"  embedding_bag_bwd bf16 at ({b}, {n_f}, {bag}) into ({n_f}, "
          f"{rows}, {dim}): {once} rows touched once (bitwise), {more} "
          f"more than once; max {e_ulps:.2f} bf16 ulps (tolerance up to "
          f"{tol:.0f}); ragged max {worst['scatter'][0]:.2f}")
    torch.cuda.empty_cache()
    flat = (ids.long() + (torch.arange(n_f, device=dev) * rows)
            .view(1, n_f, 1)).reshape(-1)
    uniq = int(torch.unique(flat).numel())

    # embedding_bag_fwd on a bf16 table of the reference's size, bitwise
    # to its plain version; the same 27.9 GB then holds the scatter's
    # gradient
    tables = torch.empty((n_f, rows, dim), dtype=bf16, device=dev)
    tables.normal_(generator=gen).mul_(dim ** -0.5)
    if not torch.equal(eb.embedding_bag_fwd(tables, ids),
                       ref.embedding_bag_ref(tables, ids)):
        raise AssertionError(f"embedding_bag_fwd bf16 at ({b}, {n_f}, {bag}) "
                             f"into ({n_f}, {rows}, {dim}): not bitwise "
                             f"equal to the plain version")
    print(f"  embedding_bag_fwd bf16 at ({b}, {n_f}, {bag}) into ({n_f}, "
          f"{rows}, {dim}): bitwise to the plain version; plan "
          f"{eb.fwd_plan(b, n_f, dim, 2)}")
    bags, table_flat = flat.view(b * n_f, bag), tables.view(n_f * rows, dim)
    recs = {"embedding_bag_fwd": kernel_record(
        "embedding_bag_fwd bf16",
        time_ms(lambda: eb.embedding_bag_fwd(tables, ids), [()],
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda: ref.embedding_bag_ref(tables, ids), [()]),
        time_ms(lambda: F.embedding_bag(bags, table_flat, mode="sum"),
                [()]),
        bound_ms(ids.numel() * 4 + uniq * dim * 2 + b * n_f * dim * 4,
                 b * n_f * bag * dim), 0.0, shape=[b, n_f, bag, rows, dim])}
    del table_flat
    grad = tables.zero_()
    del tables
    plan = eb.bwd_plan(b, n_f, rows, dim, 0, 2)
    print(f"  embedding_bag_bwd bf16 plan: {plan}")
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    zero_ms = time_ms(lambda: grad.zero_(), [()], iters=5).ms
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(
        d_out, ids, rows, dtype=bf16), [()], iters=3)
    upd = d_out.to(bf16)[:, :, None, :].expand(b, n_f, bag, dim) \
        .reshape(-1, dim).contiguous()
    grad_flat = grad.view(n_f * rows, dim)
    lib = time_ms(lambda: grad_flat.index_add_(0, flat, upd), [()])
    del grad, grad_flat, upd
    torch.cuda.empty_cache()
    recs["embedding_bag_bwd"] = kernel_record(
        "embedding_bag_bwd bf16", t, plain, lib,
        bound_ms(d_out.numel() * 4 + ids.numel() * 4 + 2 * uniq * dim * 2,
                 b * n_f * bag * dim), 0.0,
        max_ulps=max(e_ulps, worst["scatter"][0]), zero_fill_ms=zero_ms,
        shape=[b, n_f, bag, rows, dim])
    del d_out, ids

    fs = [(torch.randn((b, n_f + 1, dim), device=dev, generator=gen)
           .to(bf16),) for _ in range(3)]
    n_pairs = (n_f + 1) * n_f // 2
    ii, jj = ref.tril_pairs(n_f + 1, dev)
    err = max(_allclose("dot_interact_fwd bf16 main", di.dot_interact_fwd(x),
                        ref.dot_interact_ref(x), BF16_RTOL, 1e-4)
              for (x,) in fs)
    print(f"  dot_interact_fwd bf16 at ({b}, {n_f + 1}, {dim}): max abs err "
          f"{err:.3e}; plan {di.fwd_plan(b, n_f + 1, dim, 2)}")
    recs["dot_interact_fwd"] = kernel_record(
        "dot_interact_fwd bf16",
        time_ms(di.dot_interact_fwd, fs, kernel="dot_interact_fwd_kernel"),
        time_ms(ref.dot_interact_ref, fs),
        time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj], fs),
        bound_ms(b * (n_f + 1) * dim * 2 + b * n_pairs * 2,
                 2 * b * n_pairs * dim), err, shape=[b, n_f + 1, dim])
    gs = [(torch.randn((b, n_pairs), device=dev, generator=gen).to(bf16), x)
          for (x,) in fs]
    err, ulps = _check_dot_bf16(*gs[0], "main")
    print(f"  dot_interact_bwd bf16 at ({b}, {n_f + 1}, {dim}): max abs err "
          f"{err:.3e}, {ulps:.2f} bf16 ulps; plan "
          f"{di.bwd_plan(b, n_f + 1, dim, 0, 2)}")
    sym = []
    for g, x in gs:
        s = torch.zeros((b, n_f + 1, n_f + 1), device=dev, dtype=bf16)
        s[:, ii, jj] = g
        sym.append((s + s.transpose(1, 2), x))
    recs["dot_interact_bwd"] = kernel_record(
        "dot_interact_bwd bf16",
        time_ms(di.dot_interact_bwd, gs, kernel="dot_interact_bwd_kernel"),
        time_ms(ref.dot_interact_bwd_ref, gs),
        time_ms(torch.bmm, sym),
        bound_ms(b * n_pairs * 2 + 2 * b * (n_f + 1) * dim * 2,
                 2 * b * (n_f + 1) ** 2 * dim),
        max(err, worst["dot"][0]), max_ulps=max(ulps, worst["dot"][1]),
        shape=[b, n_f + 1, dim])
    # the f32 kernel at the same shape, the path a bf16 input took before
    # the kernel took bf16 (its casts aside)
    del sym
    fs32 = [(g.float(), x.float()) for g, x in gs]
    f32 = time_ms(di.dot_interact_bwd, fs32, kernel="dot_interact_bwd_kernel")
    recs["dot_interact_bwd"]["f32_ms"] = f32.ms
    f32_bound = bound_ms(b * n_pairs * 4 + 2 * b * (n_f + 1) * dim * 4, 0)[0]
    print(f"  dot_interact_bwd f32 at ({b}, {n_f + 1}, {dim}): {f32.ms:.4f} "
          f"ms on the card ({f32.events} events), bound {f32_bound:.4f} ms")
    return recs


def phase_dlrm_model_bf16(arch):
    """The bf16 DLRM (the reference configuration at 2^16 rows a table,
    batch 4096 of the Criteo stream) through the kernels against the same
    model through the plain versions: as in phase_model, samples whose
    MLP pre-activations take the other side of a ReLU on one path (at
    most 5%: the two paths' bf16 activations differ by an ulp here and
    there) get loss weight 0; the loss within rtol 2^-8 (one bf16 ulp)
    and each gradient, bf16 on both paths, within 2^-6 of its L2 norm
    (four bf16 ulps)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm as dlrm_lib

    cfg = arch.model.replace(vocab_sizes=(1 << 16,) * arch.model.n_sparse)
    model = dlrm_lib.init_params(cfg, seed=0, device="cuda")
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in _criteo_batch(cfg, 4096, 10).items()}
    names, params = zip(*model.named_parameters())
    preacts = []
    for lin in list(model.bottom) + list(model.top)[:-1]:
        lin.register_forward_hook(lambda m, i, o: preacts.append(o.detach()))

    def per_sample_loss(**kw):
        z = model(batch, **kw).float()
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    ops.reset_launch_counts()
    loss_k = per_sample_loss()
    n_hooked = len(preacts)
    loss_p = per_sample_loss(bag_fn=ref.embedding_bag_ref,
                             interact_fn=ref.dot_interact_ref)
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(preacts[:n_hooked], preacts[n_hooked:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 20:
        raise AssertionError(f"{n_flip} samples flip a ReLU between the "
                             f"two bf16 paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError("bf16 model loss not finite")
    _allclose("bf16 model loss", loss_k.mean(), loss_p.mean(), 2.0 ** -8,
              0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if min(counts.values()) < 1:
        raise AssertionError(f"bf16 model pass skipped a kernel: {counts}")
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, torch.autograd.grad(
            (loss_p * keep).sum(), params)):
        if gk.dtype != torch.bfloat16 or gp.dtype != torch.bfloat16:
            raise AssertionError(f"grad {n}: {gk.dtype} / {gp.dtype}")
        rel = float(torch.linalg.vector_norm(gk.float() - gp.float())
                    / torch.linalg.vector_norm(gp.float()))
        if not rel <= 2.0 ** -6:
            raise AssertionError(f"bf16 grad {n}: relative L2 error "
                                 f"{rel:.3e}")
        worst = max(worst, rel)
    print(f"  bf16 loss kernels {float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of "
          f"{loss_k.numel()} samples flip a ReLU and are left out of the "
          f"gradients; {len(names)} bf16 gradients agree (worst relative "
          f"L2 error {worst:.3e}); launches {counts}")


def phase_dlrm_driver(arch) -> dict:
    """The generic driver on the reference configuration: --arch
    dlrm-criteo --full --shape train_batch (26 x 2^22 x 128 bf16 tables,
    bf16 MLPs, row-wise adagrad, batch 65536) for DRIVER_STEPS steps at lr
    DRIVER_LR: the loss finite and falling (the last 5 steps' mean under
    the first 5's), peak device memory under the card's, each DLRM
    kernel launched at least once a step. Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run(arch.arch_id, steps=DRIVER_STEPS, full=True,
                    shape=arch.shape("train_batch"), device="cuda",
                    lr=DRIVER_LR, log_every=5)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dlrm-criteo loss not finite: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"dlrm-criteo loss not falling: {losses}")
    peak = res["max_memory_allocated"]
    card = torch.cuda.get_device_properties(0).total_memory
    if not peak < min(card, CARD_BYTES):
        raise AssertionError(f"dlrm-criteo peak {peak / 1e9:.2f} GB")
    short = {k: n for k, n in counts.items() if n < DRIVER_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {DRIVER_STEPS} "
                             f"times on the dlrm-criteo path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary.update(loss_first5=first, loss_last5=last, losses=losses,
                   launches=counts)
    print("  dlrm_driver " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts


def phase_dlrm_driver_profile(arch):
    """One train step of the reference configuration under
    torch.profiler (3 steps on one batch on the card, after 2 warm-up
    steps): device time by kernel, the four DLRM kernels' launches in
    the window and their time in the step. Returns (the model, after the
    5 steps, for the retrieval phase; each DLRM kernel's device ms a
    step)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = arch.model
    model = train.init_params_for(arch, cfg, 0, device=dev)
    opt = make_optimizer(arch.optimizer, lr=DRIVER_LR)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(train.make_loss_fn(arch, cfg), opt)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in _criteo_batch(
        cfg, arch.shape("train_batch").batch, 11).items()}
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    kernels = tuple(k + "_kernel" for k in DLRM_KERNELS)
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3, kernels)
    launches = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    device_ms = sum(ms for _, ms in rows)
    print(f"  dlrm-criteo train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); launches in the "
          f"window (3 steps, each window taken at most {WINDOW_TRIES} "
          f"times) "
          f"{launches}")
    for name, ms in rows[:14]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    in_step = {}
    for name, ms in rows:
        for k in kernels:
            if k + "<" in name or name.endswith(k):
                print(f"  {k[:-7]} in the step: {ms:.4f} ms  {name[:80]}")
                in_step[k[:-7]] = in_step.get(k[:-7], 0.0) + ms
    if set(in_step) != set(DLRM_KERNELS):
        raise AssertionError(f"profile misses a DLRM kernel: {in_step}")
    del state, opt
    return model, in_step


def phase_dlrm_retrieval(model, arch) -> dict:
    """score_candidates at retrieval_cand (one user, 1,000,000 candidates
    in 25 chunks) on the driver's bf16 model, through the kernels and
    through the plain versions: the scores finite, the two within 4 bf16
    ulps of the largest score; host-clock seconds of each (synchronised,
    after a warm-up call)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm as dlrm_lib

    cfg = model.cfg
    shape = arch.shape("retrieval_cand")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    user = {k: torch.as_tensor(v).to(dev)
            for k, v in _criteo_batch(cfg, shape.batch, 12).items()}
    cand = torch.randint(0, 2 ** 31 - 1, (shape.n_candidates,), device=dev,
                         generator=gen, dtype=torch.int32)
    plain_fns = dict(bag_fn=ref.embedding_bag_ref,
                     interact_fn=ref.dot_interact_ref)
    out = {}
    for tag, kw in (("kernels", {}), ("plain", plain_fns)):
        dlrm_lib.score_candidates(model, user, cand,
                                  chunks=RETRIEVAL_CHUNKS, **kw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        scores = dlrm_lib.score_candidates(model, user, cand,
                                           chunks=RETRIEVAL_CHUNKS, **kw)
        torch.cuda.synchronize()
        out[tag] = (scores, time.monotonic() - t0,
                    {k: n for k, n in ops.launch_counts().items() if n})
    (sk, tk, lk), (sp, tp, _) = out["kernels"], out["plain"]
    if sk.shape != (shape.n_candidates,) or sk.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(sk).all()):
        raise AssertionError(f"retrieval scores {sk.shape} {sk.dtype}")
    if lk.get("dot_interact_fwd") != RETRIEVAL_CHUNKS \
            or lk.get("embedding_bag_fwd") != 1:
        raise AssertionError(f"retrieval launches {lk}")
    err = float((sk.float() - sp.float()).abs().max())
    ulp = float(_bf16_ulp(sp.float().abs().max()))
    if not err <= 4 * ulp:
        raise AssertionError(f"retrieval scores off by {err:.3e} "
                             f"({err / ulp:.1f} bf16 ulps)")
    res = {"candidates": shape.n_candidates, "chunks": RETRIEVAL_CHUNKS,
           "kernels_s": tk, "plain_s": tp, "max_abs_err": err,
           "max_ulps": err / ulp, "launches": lk}
    print("  dlrm_retrieval " + json.dumps(res))
    return res


# ---- slice 9: xDeepFM, DIEN and BERT4Rec through the driver -----------

def _seq_batch(cfg, n, seed):
    """n synthetic records of cfg's arch as the driver makes them (numpy,
    on the host): Criteo records for xDeepFM, `dien_batch` and
    `bert4rec_batch` from a RandomState of `seed` for the others."""
    import numpy as np
    from repro_torch.data.synthetic import bert4rec_batch, dien_batch
    rng = np.random.RandomState(seed)
    if cfg.name == "dien":
        return dien_batch(rng, n, cfg.seq_len, cfg.vocab_sizes[0],
                          cfg.n_dense)
    if cfg.name == "bert4rec":
        return bert4rec_batch(rng, n, cfg.seq_len, cfg.n_items, cfg.n_mask,
                              cfg.n_negatives)
    return _criteo_batch(cfg, n, seed)


def _seq_lookups(cfg, n, seed) -> dict:
    """The lookups a microbatch of n gives the embedding kernels on cfg's
    path: {tag: (table shape (F, V, D), ids (B, F, 1) int32 on the card,
    fused)}; the item gathers of DIEN and BERT4Rec are bags of one of a
    (1, V, D) table, ids in memory order."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    b = _seq_batch(cfg, n, seed)
    col = lambda a: torch.as_tensor(a).to(dev).reshape(-1, 1, 1)
    if cfg.name == "xdeepfm":
        ids = torch.as_tensor(b["sparse_ids"]).to(dev)
        rows = cfg.vocab_sizes[0]
        return {"xdeepfm_tables": ((cfg.n_sparse, rows, cfg.embed_dim), ids,
                                   False),
                "xdeepfm_linear": ((cfg.n_sparse, rows, 1), ids, True)}
    if cfg.name == "dien":
        return {"dien_hist": ((1, cfg.vocab_sizes[0], cfg.embed_dim),
                              col(b["hist_ids"]), False)}
    vocab = -(-(cfg.n_items + 2) // 16) * 16
    cand = np.concatenate([b["mask_labels"][..., None], b["neg_ids"]], -1)
    return {"bert4rec_seq": ((1, vocab, cfg.embed_dim), col(b["item_seq"]),
                             False),
            "bert4rec_cand": ((1, vocab, cfg.embed_dim), col(cand), False)}


def _check_scatter_counted(d_out, ids, v, tag) -> float:
    """embedding_bag_bwd (sum) against its plain version where a row may
    be named many times (BERT4Rec's MASK id, 20 times a sequence): every
    d_out non-negative, each row within rtol max(1e-5, 2 n 2^-24) / atol
    1e-6 of the plain version, n the times the ids name it (two orders of
    n non-negative f32 adds each lie within (n - 1) 2^-24 of the exact
    sum, relative); the rows no id names exactly 0. Feature by feature,
    over the touched rows only. Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    got = eb.embedding_bag_bwd(d_out, ids, v)
    want = ref.embedding_bag_bwd_ref(d_out, ids, v)
    err = 0.0
    for f in range(ids.shape[1]):
        count = torch.bincount(ids[:, f].reshape(-1).long(), minlength=v)
        hit = count > 0
        if bool(got[f][~hit].any()):
            raise AssertionError(f"embedding_bag_bwd {tag} f={f}: writes "
                                 f"rows no id names")
        g, w = got[f][hit].double(), want[f][hit].double()
        rtol = torch.clamp(2.0 * count[hit].double() * 2.0 ** -24,
                           min=1e-5)[:, None]
        diff = (g - w).abs()
        bad = diff > 1e-6 + rtol * w.abs()
        if bool(bad.any()):
            raise AssertionError(f"embedding_bag_bwd {tag} f={f}: "
                                 f"{int(bad.sum())} elements off, max abs "
                                 f"err {float(diff.max()):.3e}")
        err = max(err, float(diff.max()))
    return err


def phase_recsys_seq_kernels(archs, microbatches) -> dict:
    """The embedding kernels at the lookups of xDeepFM, DIEN and BERT4Rec
    at a driver microbatch (train_batch / microbatches of the arch): the
    forwards bitwise against their plain versions (the fused kernel at
    xDeepFM's linear arm against the row kernel too); the scatter with
    non-negative d_out against its plain version (`_check_scatter_counted`).
    Then each timed beside its plain version, its bound (bytes over 3.35
    TB/s: ids, the distinct rows, the output; the scatter reads and
    writes each touched row) and its library calls (F.embedding_bag and,
    for these bags of one, F.embedding over the flattened table;
    index_add_ into the flattened gradient). Returns {kernel: {lookup
    tag: record}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    out = {"embedding_bag_fwd": {}, "embedding_bag_bwd": {},
           "embedding_bag_fused_fwd": {}}
    for arch in archs:
        cfg = arch.model
        n = arch.shape("train_batch").batch // microbatches[arch.arch_id]
        sets = [_seq_lookups(cfg, n, seed) for seed in (1, 2)]
        for tag, (shape, ids, fused) in sets[0].items():
            f, v, d = shape
            table = torch.empty(shape, device=dev)
            table.normal_(generator=gen).mul_(d ** -0.5)
            id_sets = [(s[tag][1],) for s in sets]
            b = ids.shape[0]
            offs = (torch.arange(f, device=dev) * v).view(1, f, 1)
            flat = [((i.long() + offs).reshape(b * f, 1),)
                    for (i,) in id_sets]
            uniq = int(torch.unique(flat[0][0]).numel())
            kind = "fused" if fused else "row"
            kname = "embedding_bag_fused_fwd" if fused else \
                "embedding_bag_fwd"
            fn = getattr(eb, kname)
            if fused:
                _check_fused(table, ids, "sum", tag)
            elif not torch.equal(eb.embedding_bag_fwd(table, ids),
                                 ref.embedding_bag_ref(table, ids)):
                raise AssertionError(f"embedding_bag_fwd {tag}: not "
                                     f"bitwise the plain version")
            plan = eb.fused_plan(b, f, v, d, 1) if fused else \
                eb.fwd_plan(b, f, d)
            print(f"  {tag}: ids {tuple(ids.shape)} into {shape} f32, "
                  f"{uniq} distinct rows; {kind} kernel bitwise the plain "
                  f"version; plan {plan}", flush=True)
            flat_table = table.view(f * v, d)
            # bags of one: F.embedding computes the same function too
            gather = time_ms(lambda x: F.embedding(x, flat_table), flat)
            print(f"  {kname} {tag}: F.embedding {gather.ms:.4f} ms "
                  f"({gather.events} events), {gather.wall:.4f} ms launch "
                  f"to launch", flush=True)
            out[kname][tag] = kernel_record(
                f"{kname} {tag}",
                time_ms(lambda i: fn(table, i), id_sets,
                        kernel=kname + "_kernel"),
                time_ms(lambda i: ref.embedding_bag_ref(table, i), id_sets,
                        iters=5),
                time_ms(lambda x: F.embedding_bag(x, flat_table, mode="sum"),
                        flat),
                bound_ms(ids.numel() * 4 + uniq * d * 4 + b * f * d * 4,
                         b * f * d), 0.0, ids=list(ids.shape),
                table=list(shape), distinct_rows=uniq,
                embedding_library_ms=gather.ms,
                embedding_library_events=gather.events)
            # the scatter (the lookup's backward), non-negative d_out
            d_out = torch.rand((b, f, d), device=dev, generator=gen)
            err = _check_scatter_counted(d_out, ids, v, tag)
            print(f"  embedding_bag_bwd {tag}: plan {eb.bwd_plan(b, f, v, d)}"
                  f"; max abs err {err:.3e}", flush=True)
            grad = torch.zeros_like(table)
            del table, flat_table
            torch.cuda.empty_cache()
            t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad),
                        [()], kernel="embedding_bag_bwd_kernel")
            plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, ids, v),
                            [()], iters=3)
            idx = flat[0][0].reshape(-1)
            lib = time_ms(lambda: grad.view(f * v, d).index_add_(
                0, idx, d_out.view(b * f, d)), [()])
            out["embedding_bag_bwd"][tag] = kernel_record(
                f"embedding_bag_bwd {tag}", t, plain, lib,
                bound_ms(d_out.numel() * 4 + ids.numel() * 4
                         + 2 * uniq * d * 4, b * f * d), err,
                ids=list(ids.shape), table=list(shape), distinct_rows=uniq)
            del grad, d_out, id_sets, flat, idx
            torch.cuda.empty_cache()
    return out


def _relu_flips(layers, run_k, run_p):
    """Runs run_k() and run_p() (each a per-sample loss), recording the
    pre-activations of `layers` (the hidden nn.Linear layers of an MLP)
    on each; returns (loss_k, loss_p, samples whose ReLU inputs take
    another side on the two paths)."""
    import torch
    pre = []
    hooks = [lin.register_forward_hook(
        lambda m, i, o: pre.append(o.detach())) for lin in layers]
    loss_k = run_k()
    n = len(pre)
    loss_p = run_p()
    for h in hooks:
        h.remove()
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(pre[:n], pre[n:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    return loss_k, loss_p, flips


def phase_seq_model(arch, n: int):
    """The arch's loss and every gradient at its published widths (batch
    n) through the kernels against the plain versions, same parameters
    and batch: the loss rtol 1e-5, each gradient within 1e-4 of its L2
    norm, over the samples whose MLP ReLU inputs agree on both paths
    (xDeepFM's DNN, DIEN's MLP; BERT4Rec has no ReLU), at most 1% left
    out; each of the path's kernels launched."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys

    dev = torch.device("cuda")
    cfg = arch.model
    model = recsys.init_model(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in _seq_batch(cfg, n, 7).items()}
    names, params = zip(*model.named_parameters())

    def per_sample(**kw):
        if cfg.name == "bert4rec":
            logp = torch.log_softmax(
                model.sampled_logits(batch, **kw).float(), dim=-1)
            mask = (batch["mask_labels"] >= 0).float()
            return -(logp[..., 0] * mask).sum(1) / mask.sum(1)
        z = model(batch, **kw)
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    mlp = {"xdeepfm": "dnn", "dien": "mlp"}.get(cfg.name)
    layers = list(getattr(model, mlp))[:-1] if mlp else []
    ops.reset_launch_counts()
    loss_k, loss_p, flips = _relu_flips(
        layers, per_sample, lambda: per_sample(bag_fn=ref.embedding_bag_ref))
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 100:
        raise AssertionError(f"{cfg.name}: {n_flip} samples flip a ReLU "
                             f"between the two paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError(f"{cfg.name} loss not finite")
    _allclose(f"{cfg.name} loss", loss_k.mean(), loss_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    need = {"embedding_bag_fwd", "embedding_bag_bwd"}
    if cfg.name == "xdeepfm":
        need.add("embedding_bag_fused_fwd")
    if not need <= set(counts):
        raise AssertionError(f"{cfg.name} pass skipped a kernel: {counts}")
    worst = 0.0
    for name, gk, gp in zip(names, grads_k, torch.autograd.grad(
            (loss_p * keep).sum(), params)):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"{cfg.name} grad {name}: relative L2 "
                                 f"error {rel:.3e}")
        worst = max(worst, rel)
    print(f"  {cfg.name} at batch {n}: loss kernels "
          f"{float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of "
          f"{loss_k.numel()} samples flip a ReLU and are left out; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def _seq_kernels(cfg) -> dict:
    """{kernel: launches a microbatch} on cfg's training path: xDeepFM's
    tables, its linear arm and both scatters; DIEN's history and target
    lookups, or BERT4Rec's sequence and candidate ones, and theirs."""
    if cfg.name == "xdeepfm":
        return {"embedding_bag_fwd": 1, "embedding_bag_fused_fwd": 1,
                "embedding_bag_bwd": 2}
    return {"embedding_bag_fwd": 2, "embedding_bag_bwd": 2}


def phase_seq_driver(arch, microbatches: int) -> dict:
    """The generic driver at the arch's published widths: --full --shape
    train_batch --microbatches k for SEQ_STEPS steps: losses finite, peak
    device memory under the card's, each of the path's kernels launched
    as often as `_seq_kernels` says a microbatch; samples/s, the loop
    step split into batch + copy and the train step. Returns the launch
    counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run(arch.arch_id, steps=SEQ_STEPS, full=True,
                    shape=arch.shape("train_batch"), device="cuda",
                    microbatches=microbatches, log_every=1)
    counts = {k: ops.launch_counts()[k] for k in _seq_kernels(arch.model)}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"{arch.arch_id} loss not finite: "
                             f"{res['losses']}")
    peak = res["max_memory_allocated"]
    card = torch.cuda.get_device_properties(0).total_memory
    if not peak < min(card, CARD_BYTES):
        raise AssertionError(f"{arch.arch_id} peak {peak / 1e9:.2f} GB")
    need = {k: SEQ_STEPS * microbatches * n
            for k, n in _seq_kernels(arch.model).items()}
    short = {k: n for k, n in counts.items() if n < need[k]}
    if short:
        raise AssertionError(f"kernels launched fewer than {need} times on "
                             f"the {arch.arch_id} path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated", "microbatches")}
    summary.update(losses=res["losses"], launches=counts)
    print(f"  {arch.arch_id}_driver " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts


def phase_seq_profile(arch, microbatches: int) -> dict:
    """Where one train step's device time goes (torch.profiler over one
    step on a batch already on the card, after one warm-up step), against
    the host-clock step. Returns each embedding kernel's device ms a
    step."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = arch.model
    model = train.init_params_for(arch, cfg, 0, device=dev)
    opt = make_optimizer(arch.optimizer, lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(train.make_loss_fn(arch, cfg), opt,
                              microbatches)
    batch = train.make_batch_fn(arch, cfg, arch.shape("train_batch").batch,
                                np.random.RandomState(13), device=dev)()
    step_fn(model, state, 0, batch)
    torch.cuda.synchronize()
    kernels = tuple(k + "_kernel" for k in _seq_kernels(cfg))
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 1 + k, batch), 1, kernels)
    device_ms = sum(ms for _, ms in rows)
    print(f"  {arch.arch_id} train step ({microbatches} microbatches): "
          f"{device_ms:.3f} ms of device time in {wall_ms:.3f} ms of "
          f"host-clock time (profiled)")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    in_step = {}
    for name, ms in rows:
        for k in kernels:
            if k + "<" in name or name.endswith(k):
                in_step[k[:-7]] = in_step.get(k[:-7], 0.0) + ms
    print(f"  embedding kernels in the step: {json.dumps(in_step)}")
    del model, state, opt, batch
    return in_step


def phase_recsys_retrieval(archs) -> dict:
    """score_candidates at retrieval_cand (one user, 1,000,000 candidates
    in RETRIEVAL_CHUNKS chunks) for wide-deep, xDeepFM, DIEN and BERT4Rec
    at their published widths (random weights from seed 0), through the
    kernels and through the plain versions: the scores finite, the two
    within rtol 1e-5 / atol 1e-5 (the lookups are bitwise; everything
    after them the same operations); host-clock seconds of each
    (synchronised, after a warm-up call)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys

    dev = torch.device("cuda")
    res = {}
    for arch in archs:
        torch.cuda.reset_peak_memory_stats()
        cfg = arch.model
        shape = arch.shape("retrieval_cand")
        model = recsys.init_model(cfg, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(14)
        user = {k: torch.as_tensor(v).to(dev)
                for k, v in _seq_batch(cfg, shape.batch, 14).items()
                if k not in ("label", "mask_pos", "mask_labels", "neg_ids")}
        high = {"dien": cfg.vocab_sizes[0], "bert4rec": cfg.n_items}.get(
            cfg.name, 2 ** 31 - 1)
        cand = torch.randint(0, high, (shape.n_candidates,), device=dev,
                             generator=gen, dtype=torch.int32)
        out = {}
        for tag, kw in (("kernels", {}),
                        ("plain", {"bag_fn": ref.embedding_bag_ref})):
            recsys.score_candidates(model, user, cand,
                                    chunks=RETRIEVAL_CHUNKS, **kw)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.monotonic()
            scores = recsys.score_candidates(model, user, cand,
                                             chunks=RETRIEVAL_CHUNKS, **kw)
            torch.cuda.synchronize()
            out[tag] = (scores, time.monotonic() - t0,
                        {k: n for k, n in ops.launch_counts().items() if n})
        (sk, tk, lk), (sp, tp, lp) = out["kernels"], out["plain"]
        if sk.shape != (shape.n_candidates,) or \
                not bool(torch.isfinite(sk).all()):
            raise AssertionError(f"{cfg.name} retrieval scores {sk.shape}")
        if not lk or lp:
            raise AssertionError(f"{cfg.name} retrieval launches: kernels "
                                 f"{lk}, plain {lp}")
        err = _allclose(f"{cfg.name} retrieval", sk, sp, 1e-5, 1e-5)
        res[cfg.name] = {"candidates": shape.n_candidates,
                         "chunks": RETRIEVAL_CHUNKS, "kernels_s": tk,
                         "plain_s": tp, "max_abs_err": err,
                         "bitwise": bool(torch.equal(sk, sp)),
                         "launches": lk,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
        print(f"  {cfg.name}_retrieval " + json.dumps(res[cfg.name]),
              flush=True)
        del model, out, sk, sp, scores
        torch.cuda.empty_cache()
    return res


SOURCES = {
    "embedding_bag_fwd": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:75"),
    "embedding_bag_bwd": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:75"),
    "embedding_bag_fused_fwd": (
        "src/repro_torch/kernels/csrc/embedding_bag_fused.cu",
        "src/repro/kernels/embedding_bag.py:135"),
    "dot_interact_fwd": ("src/repro_torch/kernels/csrc/dot_interact.cu",
                         "src/repro/kernels/dot_interact.py:51"),
    "dot_interact_bwd": ("src/repro_torch/kernels/csrc/dot_interact.cu",
                         "src/repro/kernels/dot_interact.py:51"),
    "sage_aggregate_fwd": ("src/repro_torch/kernels/csrc/sage_aggregate.cu",
                           "src/repro/kernels/sage_aggregate.py:32"),
    "sage_aggregate_bwd": ("src/repro_torch/kernels/csrc/sage_aggregate.cu",
                           "src/repro/kernels/sage_aggregate.py:32"),
}


def main() -> int:
    # the kernels are built from the checkout's sources: a copy of this
    # script elsewhere has none to build and exits as without a card
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: {os.path.join(ROOT, 'src', 'repro_torch')} is "
              f"missing; run this script from the root of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    agent_proc = start_agent_pretrain()
    try:
        return run_phases(agent_proc)
    finally:
        if agent_proc.poll() is None:
            agent_proc.kill()
        agent_proc.wait()


def run_phases(agent_proc) -> int:
    import torch
    from repro_torch.configs.dlrm_criteo import ARCH as DLRM_ARCH
    from repro_torch.configs.dlrm_criteo import MODEL
    from repro_torch.configs.bert4rec import ARCH as B4R_ARCH
    from repro_torch.configs.dien import ARCH as DIEN_ARCH
    from repro_torch.configs.graphsage_reddit import ARCH as GNN_ARCH
    from repro_torch.configs.wide_deep import ARCH as WD_ARCH
    from repro_torch.configs.xdeepfm import ARCH as XD_ARCH
    gnn_shape = GNN_ARCH.shape("minibatch_lg")
    gnn_cfg = GNN_ARCH.model

    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        recs = phase_kernels(MODEL)
        torch.cuda.empty_cache()
        recs.update(phase_sage_kernels(gnn_shape, gnn_cfg))
    torch.cuda.empty_cache()
    with Phase("model"):
        phase_model(MODEL)
    torch.cuda.empty_cache()
    with Phase("loop"):
        launches = phase_loop(MODEL)
    torch.cuda.empty_cache()
    with Phase("idle_tail"):
        tail_launches = phase_idle_tail(MODEL)
    torch.cuda.empty_cache()
    with Phase("profile"):
        phase_profile(MODEL)
    torch.cuda.empty_cache()
    with Phase("train_feed"):
        feed_launches = phase_train_feed(agent_proc)
    torch.cuda.empty_cache()
    with Phase("checkpoint"):
        ckpt_launches = phase_checkpoint(MODEL)
    for name in DLRM_KERNELS:
        recs[name].update(idle_tail_launches=tail_launches[name],
                          train_feed_launches=feed_launches[name],
                          checkpoint_launches=ckpt_launches[name])
    torch.cuda.empty_cache()
    with Phase("graph"):
        sampler = build_graph(gnn_shape, gnn_cfg)
    with Phase("gnn_model"):
        phase_gnn_model(gnn_shape, gnn_cfg, sampler)
    torch.cuda.empty_cache()
    with Phase("gnn_loop"):
        launches.update(phase_gnn_loop(gnn_shape, sampler))
    torch.cuda.empty_cache()
    with Phase("gnn_profile"):
        phase_gnn_profile(gnn_shape, gnn_cfg, sampler)
    del sampler
    torch.cuda.empty_cache()
    with Phase("gnn_full_model"):
        phase_gnn_full_model(GNN_ARCH)
    torch.cuda.empty_cache()
    with Phase("gnn_full_graph"):
        phase_gnn_full_graph(GNN_ARCH)
    torch.cuda.empty_cache()
    with Phase("gnn_molecule"):
        phase_gnn_molecule(GNN_ARCH)
    torch.cuda.empty_cache()
    with Phase("recsys_kernels"):
        fused_rec, wd_errs = phase_recsys_kernels(WD_ARCH.model)
        recs.update(fused_rec)
    torch.cuda.empty_cache()
    with Phase("recsys_model"):
        phase_recsys_model(WD_ARCH.model)
    torch.cuda.empty_cache()
    with Phase("recsys_loop"):
        wd_launches = phase_recsys_loop(WD_ARCH)
    launches["embedding_bag_fused_fwd"] = wd_launches.pop(
        "embedding_bag_fused_fwd")
    for name, n in wd_launches.items():
        recs[name]["wide_deep_launches"] = n
        recs[name]["wide_deep_max_abs_err"] = wd_errs[name]
    torch.cuda.empty_cache()
    with Phase("recsys_profile"):
        in_step = phase_recsys_profile(WD_ARCH)
    recs["embedding_bag_fused_fwd"]["in_step_ms"] = \
        in_step["embedding_bag_fused_fwd"]
    recs["embedding_bag_fused_fwd"]["embedding_bag_fwd_d32"]["in_step_ms"] \
        = in_step["embedding_bag_fwd"]
    torch.cuda.empty_cache()
    with Phase("dlrm_bf16_bwd"):
        bf16_recs = phase_dlrm_bf16_bwd(DLRM_ARCH)
    torch.cuda.empty_cache()
    with Phase("dlrm_model_bf16"):
        phase_dlrm_model_bf16(DLRM_ARCH)
    torch.cuda.empty_cache()
    with Phase("dlrm_driver"):
        drv_launches = phase_dlrm_driver(DLRM_ARCH)
    torch.cuda.empty_cache()
    with Phase("dlrm_driver_profile"):
        model, drv_in_step = phase_dlrm_driver_profile(DLRM_ARCH)
    with Phase("dlrm_retrieval"):
        phase_dlrm_retrieval(model, DLRM_ARCH)
    del model
    torch.cuda.empty_cache()
    # each DLRM kernel in bf16 at dlrm-criteo's training shapes, with its
    # launches and time in the step on the driver's path
    for name in DLRM_KERNELS:
        recs[name]["dlrm_criteo"] = dict(
            bf16_recs[name], launches=drv_launches[name],
            in_step_ms=drv_in_step[name])
    seq_archs = (XD_ARCH, DIEN_ARCH, B4R_ARCH)
    with Phase("recsys_seq_kernels"):
        seq_recs = phase_recsys_seq_kernels(seq_archs, SEQ_MICROBATCHES)
    torch.cuda.empty_cache()
    seq_launches, seq_in_step = {}, {}
    for arch in seq_archs:
        k = SEQ_MICROBATCHES[arch.arch_id]
        with Phase(f"{arch.arch_id}_model"):
            phase_seq_model(arch, SEQ_MODEL_BATCH[arch.arch_id])
        torch.cuda.empty_cache()
        with Phase(f"{arch.arch_id}_driver"):
            seq_launches[arch.arch_id] = phase_seq_driver(arch, k)
        torch.cuda.empty_cache()
        with Phase(f"{arch.arch_id}_profile"):
            seq_in_step[arch.arch_id] = phase_seq_profile(arch, k)
        torch.cuda.empty_cache()
    with Phase("recsys_retrieval"):
        phase_recsys_retrieval((WD_ARCH,) + seq_archs)
    torch.cuda.empty_cache()
    # each embedding kernel at each lookup of the three models, with its
    # launches and time in the step on that model's driver path
    for name, by_lookup in seq_recs.items():
        for tag, rec in by_lookup.items():
            arch_id = tag.split("_")[0]
            recs[name][tag] = dict(
                rec, launches=seq_launches[arch_id][name],
                in_step_ms=seq_in_step[arch_id].get(name))
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches[name], **recs[name]}
               for name, (src, tpu) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
