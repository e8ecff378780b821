"""Quickstart on the PyTorch port (the port of examples/quickstart.py): the
one-call API, then drop-in tuning of a real pipeline under a DLRM trained
on the card.

Three escalating integrations of the paper's controller (§4.4, Listing 1),
all through `repro_torch.api` — the single runtime API over every
substrate:

  1. `tune(...)` — one line from a pipeline spec to a tuned run on the
     analytic simulator (offline capacity planning / benchmarks).
  2. `tune(..., backend="live")` — the SAME line, now driving a real
     ThreadedPipeline: worker threads realize each stage's true cost and
     throughput is measured, not modeled.
  3. Drop-in: wrap YOUR pipeline (real stage fns over the synthetic
     Criteo stream) with `ExecutorBackend.wrap` and run the tuning
     Session in a background thread while the training loop consumes
     batches — InTune re-allocates the worker pools live under a real
     DLRM training job. The DLRM trains on `--device` (the card unless
     asked for the CPU): its embedding bags and interaction run through
     the port's kernels there, forward and backward.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.api import ExecutorBackend, Session, tune
from repro_torch.configs.base import DLRMConfig
from repro_torch.core.controller import InTune
from repro_torch.data.executor import ThreadedPipeline
from repro_torch.data.live_fleet import live_linear_pipeline
from repro_torch.data.pipeline import criteo_pipeline
from repro_torch.data.simulator import MachineSpec
from repro_torch.data.synthetic import CriteoStream
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.train.optim import make_optimizer
from repro_torch.train.train_step import make_train_step

# part 3's tiny DLRM: 8 sparse features over 4096-row tables at D = 16, so
# the interaction takes (256, 9, 16) a step
QS_CONFIG = DLRMConfig(name="dlrm-qs", n_sparse=8, n_dense=6, embed_dim=16,
                       vocab_sizes=(4096,) * 8, bottom_mlp=(32, 16),
                       top_mlp=(64, 32, 1))
QS_BATCH = 256
QS_STEPS = 30        # part 3's train steps
QS_TICKS = 20        # part 3's tuning windows of 0.2 s


def part1_one_liner(ticks: int = 250) -> dict:
    print("== 1. tune() on the analytic simulator ==")
    spec = criteo_pipeline()
    machine = MachineSpec(n_cpus=64, mem_mb=65536)
    res = tune(spec, machine, optimizer="intune", backend="sim",
               ticks=ticks, seed=0)
    steady = float(np.mean(res.throughput[-50:]))
    base = tune(spec, machine, optimizer="autotune", backend="sim",
                ticks=1, seed=0)
    print(f"  InTune steady state {steady:.2f} b/s vs AUTOTUNE-like "
          f"{base.throughput[0]:.2f} b/s (OOMs: {res.oom_count})")
    return {"steady": steady, "autotune": base.throughput[0],
            "oom_count": res.oom_count}


def part2_live_backend(ticks: int = 12) -> dict:
    print("== 2. the same call on a REAL threaded pipeline ==")
    spec = live_linear_pipeline()          # ms-scale costs: measurable
    machine = MachineSpec(n_cpus=8, mem_mb=4096)
    res = tune(spec, machine, optimizer="oracle", backend="live",
               ticks=ticks, seed=0, backend_kw={"window_s": 0.1})
    live = res.extras["live"]
    print(f"  measured {float(np.mean(res.throughput[2:])):.1f} b/s "
          f"over {res.ticks} windows | OOMs {res.oom_count} | "
          f"threads joined: {live['all_joined']}")
    return {"throughput": res.throughput, "oom_count": res.oom_count,
            "live": live}


def part3_drop_in(device="cuda", steps: int = QS_STEPS,
                  ticks: int = QS_TICKS, record=None) -> dict:
    """The drop-in integration: `steps` train steps of QS_CONFIG on
    `device` off the live pipeline while a background Session tunes it
    for `ticks` windows. `record`, if given, receives each host batch as
    the pipeline delivered it. Returns the per-step losses, the worker
    counts each tick saw, the final workers, the teardown accounting and
    the loop's seconds."""
    print("== 3. drop-in: tune YOUR pipeline under a live training job ==")
    device = torch.device(device)
    spec = criteo_pipeline(batch_mb=1.0)
    machine = MachineSpec(n_cpus=8, mem_mb=8192)
    stream = CriteoStream(n_sparse=8, n_dense=6, vocab=4096)
    rng = np.random.RandomState(0)

    # ---- the user's pipeline, standard framework code (paper §4.4) ----
    pipe = ThreadedPipeline(
        spec,
        source_fn=lambda: stream.raw_block(QS_BATCH),
        stage_fns=[
            lambda b: CriteoStream.shuffle_udf(b, rng),   # shuffle
            stream.feature_udf,                           # UDF (hot spot)
            CriteoStream.batch_udf,                       # batch
            lambda b: b,                                  # prefetch
        ],
        queue_depth=8, item_mb=1.0, machine=machine)

    # ---- wrap it: backend + controller + a background Session ---------
    backend = ExecutorBackend.wrap(pipe, window_s=0.2)
    tuner = InTune(spec, machine, seed=0, head="factored",
                   finetune_ticks=50)
    session = Session(backend, tuner)
    seen, errors = [list(pipe.worker_counts())], []

    def drive():
        try:
            session.run(ticks, collect=lambda t, tel: seen.append(
                list(pipe.worker_counts())))
        except BaseException as e:     # surfaced on the main thread
            errors.append(e)

    driver = threading.Thread(target=drive, daemon=True)
    driver.start()

    # ---- train a tiny DLRM off the pipeline (the consumer) ------------
    model = dlrm_lib.init_params(QS_CONFIG, seed=0, device=device)
    opt = make_optimizer("adagrad", lr=0.05)
    opt_state = opt.init(dict(model.named_parameters()))
    step = make_train_step(dlrm_lib.loss_fn, opt)

    print(f"  training {steps} steps off the live pipeline on "
          f"{device.type}...")
    losses = []
    t0 = time.monotonic()
    try:
        for i in range(steps):
            host = pipe.get_batch()
            if record is not None:
                record.append(host)
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in host.items()}
            model, opt_state, metrics = step(model, opt_state, i, batch)
            losses.append(metrics["loss"])
            if i % 10 == 0:
                print(f"  step {i:3d} loss {float(metrics['loss']):.4f} "
                      f"workers {pipe.worker_counts()}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.monotonic() - t0
        driver.join(timeout=30)
    finally:
        acct = session.close()
    if errors:
        raise errors[0]
    if driver.is_alive():
        raise RuntimeError("the tuning Session did not finish its "
                           f"{ticks} windows within 30 s of training")
    final = list(pipe.worker_counts())
    print(f"  done — InTune re-allocated the pools live "
          f"(final workers {final}, "
          f"threads joined: {acct['all_joined']})")
    return {"losses": [float(x) for x in losses], "workers_seen": seen,
            "workers_final": final, "teardown": acct, "train_s": train_s,
            "steps_per_s": steps / train_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where part 3's DLRM trains (default: the card)")
    args = ap.parse_args(argv)
    return {"part1": part1_one_liner(), "part2": part2_live_backend(),
            "part3": part3_drop_in(args.device)}


if __name__ == "__main__":
    main()
