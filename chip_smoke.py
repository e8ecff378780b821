#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure raises and the script
exits non-zero without printing a result:

  1. build    nvcc builds every kernel source under
              src/repro_torch/kernels/csrc for sm_90a (one nvcc per source,
              started together); prints ptxas' register and shared-memory
              report and the card's name and power limit.
  2. kernels  each CUDA kernel against its plain PyTorch version on the
              card, at the main path's shapes (DLRM-Criteo: 26 tables of
              2^20 x 128 f32, batch 2048, bag 4; interaction (2048, 27,
              128)) and at ragged ones (batch 37, bag 1, mean, D not a
              multiple of 4). Tolerances: embedding_bag_fwd bitwise;
              embedding_bag_bwd rtol 1e-5 / atol 1e-6 (atomic order
              varies); dot_interact_fwd/bwd rtol 1e-5 / atol 1e-4 against
              f32 cuBLAS with TF32 off. Times each kernel, its plain
              version and one PyTorch library call (device time from
              torch.profiler; launch-to-launch time from CUDA events).
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
              Tolerances: the aggregate (rows padded to a multiple of 4
              floats) bitwise; out and d_neigh rtol 1e-5 / atol 1e-5
              against f32 cuBLAS with TF32 off; d_w within 1e-5 of max
              |d_w| (a sum over up to 15360 rows in another order); a
              second run, out without the saved aggregate and d_w
              without d_neigh bitwise equal. Timed as above, each shape
              with its share of the bound and its ratio to the library
              call: torch.einsum("bfd,dh->bh") (the sum without the 1/F)
              for the forward and torch.mm(agg^T, d_out) for d_w.
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
              stream over (40, 2^20, 1)), at serve_p99 (batch 512), at a
              reduced table (8, 512, 8), at F not a multiple of its walk's
              group of 4, with bag 1, bag 16 and mean, and with one
              out-of-range id (its row NaN in both kernels, the rest
              equal); embedding_bag_fwd bitwise and embedding_bag_bwd per
              feature at rtol 1e-5 / atol 1e-6 against their plain
              versions with the train shape's ids, on the wide arm (D = 1)
              and on the deep tables (40, 2^20, 32). Times at the train
              shape: the fused kernel, embedding_bag_fwd, the plain version
              and F.embedding_bag over the flattened (F*V, 1) table with
              offset ids; and embedding_bag_bwd at D = 1 (library:
              index_add_).
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
              device time by kernel.

Launch counts are set to 0 just before each main path (the DLRM loop,
the GNN loop, the wide-deep loop) and read just after it; the `kernels`
line reports each kernel's count from its own path (embedding_bag_fwd
and _bwd from the DLRM loop, with their wide-deep counts beside).

It prints a `kernels` JSON line, the card's name and power limit, and as
its last line `{"ok": true, "device": {...}}`. It needs one CUDA card
and exits non-zero when there is none.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

STEPS = 40
TUNE_EVERY = 2
GNN_STEPS = 20

RECSYS_STEPS = 20

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


def time_ms(fn, args_list, iters: int = 20):
    """(device ms, wall ms) per call over `iters` calls, cycling through
    `args_list` (several input sets, so small inputs do not sit in the
    50 MB L2). Device ms is the summed duration of every kernel, memset
    and copy the call put on the card (torch.profiler, CUPTI); wall ms is
    CUDA events around the whole run, which for a call shorter than its
    host-side launch cost measures the launch, not the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    # the profiler now and then returns a window with no device events
    # (seen once in many calls on the H100); such a window is profiled
    # again, and three empty ones in a row fail
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total
                        for e in prof.key_averages())
        if device_us > 0:
            return device_us / 1e3 / iters, wall
        print("  torch.profiler recorded no device time; profiling again")
    raise RuntimeError("torch.profiler recorded no device time in 3 tries")


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


def phase_build():
    from repro_torch.kernels import build
    logs = build.build_all()
    for name, out in sorted(logs.items()):
        for line in out.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                print(f"  [{name}] {line.strip()}")
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
    for b, f, d in ((37, 5, 10), (37, 27, 128), (1, 2, 4), (3, 60, 32)):
        note(_check_dot(torch.randn((b, f, d), device=dev, generator=gen),
                        f"({b},{f},{d})"))

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

    recs = []
    ids_l = ids.long()
    flat = (ids_l + (torch.arange(n_f, device=dev) * rows)
            .view(1, n_f, 1)).reshape(b * n_f, bag)
    uniq = int(torch.unique(flat).numel())
    table_flat = tables.view(n_f * rows, dim)

    # embedding_bag_fwd
    ms, wall = time_ms(lambda: eb.embedding_bag_fwd(tables, ids), [()])
    plain, _ = time_ms(lambda: ref.embedding_bag_ref(tables, ids), [()])
    lib, _ = time_ms(lambda: F.embedding_bag(flat, table_flat, mode="sum"),
                     [()])
    bnd = bound_ms(ids.numel() * 4 + uniq * dim * 4 + b * n_f * dim * 4,
                   b * n_f * bag * dim)
    recs.append(("embedding_bag_fwd", ms, plain, lib, bnd,
                 {"wall_ms": wall}))

    # embedding_bag_bwd: the kernel scatter-adds into a zeroed gradient;
    # the zero fill belongs to the gradient's allocation and is timed
    # apart
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen)
    grad = torch.zeros_like(tables)
    ms, wall = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad),
                       [()])
    zero_ms, _ = time_ms(lambda: grad.zero_(), [()], iters=5)
    del grad
    plain, _ = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, ids, rows),
                       [()], iters=5)
    torch.cuda.empty_cache()
    upd = d_out[:, :, None, :].expand(b, n_f, bag, dim).reshape(-1, dim) \
        .contiguous()
    flat1 = flat.reshape(-1)
    grad_flat = torch.zeros((n_f * rows, dim), device=dev)
    lib, _ = time_ms(lambda: grad_flat.index_add_(0, flat1, upd), [()])
    del grad_flat, upd
    bnd = bound_ms(d_out.numel() * 4 + ids.numel() * 4 + 2 * uniq * dim * 4,
                   b * n_f * bag * dim)
    recs.append(("embedding_bag_bwd", ms, plain, lib, bnd,
                 {"wall_ms": wall, "zero_fill_ms": zero_ms}))
    del tables, table_flat
    torch.cuda.empty_cache()

    # dot_interact: three input sets (85 MB) so the feats do not stay in L2
    fs = [(torch.randn((b, n_f + 1, dim), device=dev, generator=gen),)
          for _ in range(3)]
    n_pairs = (n_f + 1) * n_f // 2
    ii, jj = ref.tril_pairs(n_f + 1, dev)
    ms, wall = time_ms(di.dot_interact_fwd, fs)
    plain, _ = time_ms(ref.dot_interact_ref, fs)
    lib, _ = time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj],
                     fs)
    bnd = bound_ms(b * (n_f + 1) * dim * 4 + b * n_pairs * 4,
                   2 * b * n_pairs * dim)
    recs.append(("dot_interact_fwd", ms, plain, lib, bnd,
                 {"wall_ms": wall}))

    gs = [(torch.randn((b, n_pairs), device=dev, generator=gen), x)
          for (x,) in fs]
    sym = []
    for g, x in gs:
        s = torch.zeros((b, n_f + 1, n_f + 1), device=dev)
        s[:, ii, jj] = g
        sym.append((s + s.transpose(1, 2), x))
    ms, wall = time_ms(di.dot_interact_bwd, gs)
    plain, _ = time_ms(ref.dot_interact_bwd_ref, gs)
    lib, _ = time_ms(torch.bmm, sym)
    bnd = bound_ms(b * n_pairs * 4 + 2 * b * (n_f + 1) * dim * 4,
                   2 * b * (n_f + 1) ** 2 * dim)
    recs.append(("dot_interact_bwd", ms, plain, lib, bnd,
                 {"wall_ms": wall}))

    out = {}
    for name, ms, plain, lib, (bms, by), extra in recs:
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bms, "bound_by": by,
                     "max_abs_err": errs[name], **extra}
        print(f"  {name}: {ms:.4f} ms on the card, {extra['wall_ms']:.4f}"
              f" ms launch to launch (plain {plain:.4f}, library {lib:.4f},"
              f" bound {bms:.4f} by {by}), max abs err {errs[name]:.3e}")
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

    args = SimpleNamespace(steps=STEPS, batch=2048, tune_every=TUNE_EVERY,
                           finetune_ticks=90, device="cuda", seed=0)
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
    torch.cuda.synchronize()
    return counts


def phase_profile(cfg):
    """Where one train step's device time goes at the slice configuration:
    torch.profiler over 3 steps on one featurized batch (after 2 warm-up
    steps), device time summed by kernel, against the host-clock step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    steps = 3
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(steps):
            step_fn(model, state, 2 + k, batch)
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                   for e in prof.key_averages()), key=lambda r: -r[1])
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

    per = {k: [] for k in GNN_KERNELS}
    print(f"  d_w clusters that fit the card at once, by size: "
          f"{ {c: sa.dw_active_clusters(dev, c) for c in (1, 2, 4, 8)} }")
    for tag, b, f, d, h, need_neigh in path:
        print(f"  {tag}: {sa.fwd_plan(b, f, d, h)}, "
              f"{sa.dw_plan(b, d, h, lambda c: sa.dw_active_clusters(dev, c))}")
        # enough input sets to cycle through more than the 50 MB L2
        n_sets = max(1, min(8, -(-64 * 2 ** 20 // (4 * b * f * d))))
        sets = [inputs(b, f, d, h) for _ in range(n_sets)]
        ms, wall = time_ms(lambda n, w: sa.sage_aggregate_fwd(n, w, True),
                           sets)
        plain, _ = time_ms(ref.sage_aggregate_ref, sets)
        lib, _ = time_ms(lambda n, w: torch.einsum("bfd,dh->bh", n, w), sets)
        bms, by = bound_ms(4 * (b * f * d + d * h + b * h + b * d),
                           b * f * d + 2 * b * d * h)
        per["sage_aggregate_fwd"].append(
            {"shape": tag, "B": b, "F": f, "D": d, "H": h, "ms": ms,
             "wall_ms": wall, "plain_ms": plain, "library_ms": lib,
             "bound_ms": bms, "bound_by": by})
        bsets = [(torch.randn((b, h), device=dev, generator=gen), w,
                  sa.sage_aggregate_fwd(n, w, True)[1]) for n, w in sets]
        del sets
        ms, wall = time_ms(
            lambda g, w, a: sa.sage_aggregate_bwd(g, w, a, f, need_neigh),
            bsets)
        plain, _ = time_ms(lambda g, w, a: ref.sage_aggregate_bwd_ref(
            g, w, a, f, need_neigh=need_neigh), bsets)
        # one library call computes d_w alone; none computes both outputs
        lib = None if need_neigh else time_ms(
            lambda g, w, a: torch.mm(a.t(), g), bsets)[0]
        n_bytes = 4 * (b * h + b * d + d * h)
        flops = 2 * b * d * h
        if need_neigh:
            n_bytes += 4 * (d * h + b * f * d)
            flops += 2 * b * d * h
        bms, by = bound_ms(n_bytes, flops)
        per["sage_aggregate_bwd"].append(
            {"shape": tag, "B": b, "F": f, "D": d, "H": h,
             "d_neigh": need_neigh, "ms": ms, "wall_ms": wall,
             "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
             "bound_by": by})
        del bsets
        torch.cuda.empty_cache()

    out = {}
    for name in GNN_KERNELS:
        main = per[name][0]
        out[name] = {k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "wall_ms")}
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
    from torch.profiler import ProfilerActivity, profile
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
    steps = 3
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(steps):
            step_fn(model, state, 2 + k, batch)
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    sage_ms = sum(ms for name, ms in rows if "sage_" in name)
    print(f"  GNN train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); sage_aggregate "
          f"kernels {sage_ms:.3f} ms ({100 * sage_ms / device_ms:.1f}%)")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")


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
    for f, v, d, b, bag in ((8, 512, 8, 4096, 4), (8, 512, 8, 37, 1),
                            (3, 1000, 5, 37, 16), (40, 4096, 1, 300, 16),
                            (6, 256, 32, 33, 3)):
        tables = torch.randn((f, v, d), device=dev, generator=gen)
        ids = torch.randint(0, v, (b, f, bag), device=dev, generator=gen,
                            dtype=torch.int32)
        for combiner in ("sum", "mean"):
            _check_fused(tables, ids, combiner, f"({f},{v},{d}) b{b} "
                                                f"bag{bag}")
        ids[b // 2, f - 1, 0] = v
        if _check_fused(tables, ids, "sum", f"({f},{v},{d}) out of "
                                            f"range") != 1:
            raise AssertionError("an out-of-range id must poison exactly "
                                 "its own row")
    bad = serve.clone()
    bad[7, 3, 2] = -1
    if _check_fused(wide, bad, "sum", "serve_p99 out of range") != 1:
        raise AssertionError("an out-of-range id must poison exactly its "
                             "own row")
    print("  embedding_bag_fused_fwd bit-equal to embedding_bag_fwd and "
          "the plain version at every shape")

    # the row kernels at the path's train shape: the wide arm's D = 1
    # (262,144 ids a feature scattered over 2^20 rows) and the deep tables
    path_errs = _check_bag(wide, main, "sum", "wide arm train_batch")
    deep = torch.empty((n_f, rows, cfg.embed_dim), device=dev)
    deep.normal_(generator=gen).mul_(0.01)
    for name, err in _check_bag(deep, main, "sum",
                                "deep tables train_batch").items():
        path_errs[name] = max(path_errs[name], err)
    del deep
    torch.cuda.empty_cache()
    print(f"  embedding_bag_fwd/_bwd at (65536, 40, 4) x (40, 2^20, 1) and "
          f"x (40, 2^20, {cfg.embed_dim}): forward bit-equal, backward max "
          f"abs err {path_errs['embedding_bag_bwd']:.3e}")

    # timed at the train shape, cycling two id sets (84 MB) so the ids do
    # not sit in the 50 MB L2 from one launch to the next
    b, _, bag = main.shape
    sets = [(main,), (torch.as_tensor(_criteo_batch(cfg, 65536, 3)
                                      ["sparse_ids"]).to(dev),)]
    ms, wall = time_ms(lambda i: eb.embedding_bag_fused_fwd(wide, i), sets)
    row_ms, _ = time_ms(lambda i: eb.embedding_bag_fwd(wide, i), sets)
    plain, _ = time_ms(lambda i: ref.embedding_bag_fused_ref(wide, i), sets)
    offs = (torch.arange(n_f, device=dev) * rows).view(1, n_f, 1)
    flat_sets = [((i.long() + offs).reshape(b * n_f, bag),) for (i,) in sets]
    wide_flat = wide.view(n_f * rows, 1)
    lib, _ = time_ms(lambda x: F.embedding_bag(x, wide_flat, mode="sum"),
                     flat_sets)
    uniq = int(torch.unique(flat_sets[0][0]).numel())
    bms, by = bound_ms(main.numel() * 4 + uniq * 4 + b * n_f * 4,
                       b * n_f * bag)
    rec = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
           "bound_by": by, "max_abs_err": 0.0, "wall_ms": wall,
           "embedding_bag_fwd_ms": row_ms, "distinct_rows": uniq}
    print(f"  embedding_bag_fused_fwd (65536, 40, 4) x (40, 2^20, 1): "
          f"{ms:.4f} ms on the card, {wall:.4f} ms launch to launch; "
          f"embedding_bag_fwd {row_ms:.4f}, plain {plain:.4f}, "
          f"F.embedding_bag {lib:.4f}, bound {bms:.4f} by {by} ({uniq} "
          f"distinct rows of {n_f * rows})")

    # embedding_bag_bwd at the wide arm's D = 1 (checked above; here grad
    # piles up over the timed calls, which changes no memory traffic)
    d_out = torch.randn((b, n_f, 1), device=dev, generator=gen)
    grad = torch.zeros_like(wide)
    bwd_ms, _ = time_ms(lambda: eb.embedding_bag_scatter(d_out, main, grad),
                        [()])
    bwd_plain, _ = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, main,
                                                             rows), [()])
    upd = d_out.expand(b, n_f, bag).reshape(-1, 1).contiguous()
    idx = flat_sets[0][0].reshape(-1)
    bwd_lib, _ = time_ms(lambda: grad.view(n_f * rows, 1).index_add_(
        0, idx, upd), [()])
    bwd_bms, bwd_by = bound_ms(d_out.numel() * 4 + main.numel() * 4
                               + 2 * uniq * 4, b * n_f * bag)
    rec["embedding_bag_bwd_d1"] = {
        "ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": bwd_lib,
        "bound_ms": bwd_bms, "bound_by": bwd_by}
    print(f"  embedding_bag_bwd at D = 1 (wide arm): {bwd_ms:.4f} ms on the "
          f"card (plain {bwd_plain:.4f}, index_add_ {bwd_lib:.4f}, bound "
          f"{bwd_bms:.4f} by {bwd_by})")
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
    model = recsys.init_wide_deep(cfg, seed=0, device=dev)
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
    steps), device time summed by kernel, against the host-clock step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import recsys
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = arch.model
    model = recsys.init_wide_deep(cfg, seed=0, device=dev)
    opt = make_optimizer(arch.optimizer, lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(recsys.ctr_loss, opt)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in _criteo_batch(
        cfg, arch.shape("train_batch").batch, 6).items()}
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    steps = 3
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(steps):
            step_fn(model, state, 2 + k, batch)
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    bag_ms = sum(ms for name, ms in rows if "embedding_bag" in name)
    print(f"  wide-deep train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); embedding_bag "
          f"kernels {bag_ms:.3f} ms ({100 * bag_ms / device_ms:.1f}%)")
    for name, ms in rows[:14]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")


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
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs.dlrm_criteo import MODEL
    from repro_torch.configs.graphsage_reddit import ARCH as GNN_ARCH
    from repro_torch.configs.wide_deep import ARCH as WD_ARCH
    gnn_shape = GNN_ARCH.shape("minibatch_lg")
    gnn_cfg = GNN_ARCH.model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
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
    with Phase("profile"):
        phase_profile(MODEL)
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
        phase_recsys_profile(WD_ARCH)
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
