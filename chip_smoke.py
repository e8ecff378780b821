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

It prints a `kernels` JSON line, the card's name and power limit, and as
its last line `{"ok": true, "device": {...}}`. It needs one CUDA card
and exits non-zero when there is none.
"""
from __future__ import annotations

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    if device_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return device_us / 1e3 / iters, wall


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
    counts = ops.launch_counts()
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
    counts = ops.launch_counts()
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


SOURCES = {
    "embedding_bag_fwd": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:75"),
    "embedding_bag_bwd": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:75"),
    "dot_interact_fwd": ("src/repro_torch/kernels/csrc/dot_interact.cu",
                         "src/repro/kernels/dot_interact.py:51"),
    "dot_interact_bwd": ("src/repro_torch/kernels/csrc/dot_interact.cu",
                         "src/repro/kernels/dot_interact.py:51"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs.dlrm_criteo import MODEL

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
    with Phase("model"):
        phase_model(MODEL)
    torch.cuda.empty_cache()
    with Phase("loop"):
        launches = phase_loop(MODEL)
    torch.cuda.empty_cache()
    with Phase("profile"):
        phase_profile(MODEL)
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
