"""The readings each limit of `perfbench/limits/<cell>.json` is set from,
at the cell's own size, on the card; the benchmark's runs never run it.

    python3 perfbench/control.py --workload <name> --seeds 12 \
        [--control-seeds 3] [--first-seed N] [--out readings.jsonl]

For a training cell it builds the program's train step once and, for
each seed, fills it from the seed, takes the three checked steps on the
mix's first three batches through its feed and `correct.checked_steps`
(the harness's own), and compares them with the reference: the
program's readings, whose largest is each number's lower reading. On the
control seeds it also compares the reference computed in the precision
below the configuration's (its `control_precision`: int8 for bf16, TF32
for f32) and the program with each fault of `lib/faults.py` planted:
the upper readings. A state left unchanged reads 1 on the gradient and
change numbers and is not run. For a scoring cell: the program's widest
logit gap, the control's and each fault's. One JSON line a reading, then
a summary line.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def train_readings(cell, seeds, control_seeds, device, emit):
    import torch

    from perfbench.lib import correct, faults, weights
    cfg, mix, mod = cell.cfg, cell.mix, cell.model
    model, opt_state, step_fn = mod.build_train(cfg, mix["batch"], device)
    step0 = cfg["optimizer"]["first_step"]
    planted = {k: f("step", step_fn, mod) for k, f in faults.TRAIN.items()
               if k != "unchanged"}
    for i, seed in enumerate(seeds):
        feed = cell.part("feeds", mix["feed"]).make(cfg, mix, seed, device)
        first = [feed.next() for _ in range(3)]
        first = [{k: v.clone() for k, v in b.items()} for b in first]
        numbers, ref_batches = feed.check(cfg, first)
        feed.close()
        ref = correct.reference_train(mod, cfg, seed, ref_batches,
                                      device=device)
        kinds = [("program", step_fn)]
        if i < control_seeds:
            kinds += list(planted.items())
        for kind, fn in kinds:
            weights.fill(model, mod.leaves(cfg), mod.TABLES, seed)
            for a in opt_state["acc"].values():
                a.zero_()
            state = {"model": model, "opt": opt_state}

            def one(k, b):
                state["model"], state["opt"], m = fn(
                    state["model"], state["opt"], step0 + k, b)
                return m
            obs = correct.checked_steps(one, state, first, cfg, mod)
            got = correct.train_numbers(obs, ref)
            if kind == "program":
                got.update(numbers)
                got["grad_leaf"] = correct.worst_leaf(obs["grad_norms"],
                                                      ref["grad_norms"])
                got["delta_leaf"] = correct.worst_leaf(obs["deltas"],
                                                       ref["deltas"])
            emit({"kind": kind, "seed": seed, **got})
            del obs, state
        if i < control_seeds:
            low = correct.reference_train(mod, cfg, seed, ref_batches,
                                          precision=cfg["control_precision"],
                                          device=device)
            got = correct.train_numbers(low, ref)
            got.update(feed.control(cfg))
            emit({"kind": "control", "seed": seed, **got})
        del ref, first, ref_batches
        torch.cuda.empty_cache() if torch.cuda.is_available() else None


def serve_readings(cell, seeds, control_seeds, device, emit):
    import torch

    from perfbench.lib import correct, faults, traffic, weights
    cfg, mix, mod = cell.cfg, cell.mix, cell.model
    model, score = mod.build_serve(cfg, device)
    planted = {k: f("score", score, mod) for k, f in faults.SCORE.items()}
    for i, seed in enumerate(seeds):
        weights.fill(model, mod.leaves(cfg), mod.TABLES, seed)
        batches = traffic.make(cfg, mix, seed, device)
        outs = [score(b).float() for b in batches]
        refs = correct.reference_scores(mod, cfg, seed, batches,
                                        device=device)
        emit({"kind": "program", "seed": seed,
              "score_gap": correct.score_gap(outs, refs)})
        if i < control_seeds:
            low = correct.reference_scores(mod, cfg, seed, batches,
                                           precision=cfg["control_precision"],
                                           device=device)
            emit({"kind": "control", "seed": seed,
                  "score_gap": correct.score_gap(low, refs)})
            for kind, fn in planted.items():
                got = [fn(b).float() for b in batches]
                emit({"kind": kind, "seed": seed,
                      "score_gap": correct.score_gap(got, refs)})
                del got
        del outs, refs, batches
        torch.cuda.empty_cache() if torch.cuda.is_available() else None


def summarize(rows):
    """Each number's lower reading (the program's largest) and upper one
    (the least of the control's and the faults')."""
    out = {}
    for r in rows:
        for k, v in r.items():
            if k in ("kind", "seed") or not isinstance(v, (int, float)):
                continue
            d = out.setdefault(k, {"lower": None, "upper": None})
            if r["kind"] == "program":
                d["lower"] = v if d["lower"] is None else max(d["lower"], v)
            else:
                d["upper"] = v if d["upper"] is None else min(d["upper"], v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench.lib.harness import Cell
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    device = "cuda"
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = []
    out = open(args.out, "a") if args.out else None

    def emit(r):
        r = {"workload": args.workload, **r}
        rows.append(r)
        print(json.dumps(r), flush=True)
        if out:
            out.write(json.dumps(r) + "\n")
            out.flush()
    fn = train_readings if cell.mix["mode"] == "train" else serve_readings
    fn(cell, seeds, args.control_seeds, device, emit)
    summary = {"workload": args.workload, "summary": summarize(rows)}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
