"""Faults planted underneath the timed path, each of which a cell's
`correct` has to catch: `fault(kind, fn, mod)` takes the program's step
("step": fn(model, opt_state, k, batch)) or scoring ("score": fn(batch))
and the configuration's model adapter, and returns the broken function.
`perfbench/control.py` reads them on the card at a cell's own size; the
tests drive whole runs with them on the CPU."""
from __future__ import annotations

import torch

from perfbench.reference import common


def unchanged(kind, fn, mod):
    """A step that returns its state unchanged (its loss still read)."""
    def step(model, opt_state, k, batch):
        with torch.no_grad():
            loss = common.bce(model(batch).float(), batch["label"].float())
        return model, opt_state, {"loss": loss}
    return step


def half_batch(kind, fn, mod):
    """Half of the batch left out, the mean taken over the rest; scoring
    answers the left-out half with zeros."""
    if kind == "step":
        def step(model, opt_state, k, batch):
            n = batch["label"].shape[0] // 2
            return fn(model, opt_state, k, {key: v[:n]
                                            for key, v in batch.items()})
        return step

    def score(batch):
        n = batch["label"].shape[0] // 2
        out = fn({key: v[:n] for key, v in batch.items()})
        return torch.cat([out, torch.zeros_like(out)])
    return score


def altered(kind, fn, mod):
    """One score altered where it is produced."""
    def score(batch):
        out = fn(batch).clone()
        out[batch["label"].shape[0] // 3] += 1.0
        return out
    return score


def repeats_averaged(kind, fn, mod):
    """The tables' scatter takes the mean of a row's repeated lookups
    instead of their sum: only the rows a batch reads twice or more go
    wrong (a fault of a dedup or of a sparse optimizer's gather)."""
    def step(model, opt_state, k, batch):
        ids = batch["sparse_ids"]
        handles = []
        for name, p in model.named_parameters():
            if name not in mod.TABLES or p.dim() != 3 \
                    or p.shape[0] != ids.shape[1]:
                continue

            @torch.no_grad()
            def hook(g, ids=ids):
                for f in range(g.shape[0]):
                    u, c = torch.unique(ids[:, f].reshape(-1).long(),
                                        return_counts=True)
                    rep = c > 1
                    g[f, u[rep]] = (g[f, u[rep]].float()
                                    / c[rep].float()[:, None]).to(g.dtype)
                return g
            handles.append(p.register_hook(hook))
        try:
            return fn(model, opt_state, k, batch)
        finally:
            for h in handles:
                h.remove()
    return step


def dense_frozen(kind, fn, mod):
    """The step moves the tables alone: every dense (non-table) leaf is
    put back as it was, its accumulator still fed."""
    def step(model, opt_state, k, batch):
        with torch.no_grad():
            keep = {n: p.detach().clone()
                    for n, p in model.named_parameters()
                    if n not in mod.TABLES}
        out = fn(model, opt_state, k, batch)
        with torch.no_grad():
            for n, p in out[0].named_parameters():
                if n in keep:
                    p.copy_(keep[n])
        return out
    return step


TRAIN = {"unchanged": unchanged, "half_batch": half_batch,
         "repeats_averaged": repeats_averaged, "dense_frozen": dense_frozen}
SCORE = {"half_batch": half_batch, "altered": altered}
