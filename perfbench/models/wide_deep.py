"""How the benchmark drives a wide-and-deep configuration through the
port: its train step from `repro_torch.launch.train.build_step`
(unplaced), its scoring through the model's forward under `no_grad`; its
leaves, FLOPs and kernels' least work, counted here."""
from __future__ import annotations

import torch

from perfbench.lib import costs
from perfbench.reference import wide_deep as ref

TABLES = ("tables", "wide")
leaves = ref.leaves
reference_forward = ref.forward

# the port's dispatch: a feature's table of at most 8 MiB, bags of at
# most 16, go through the fused kernel
FUSED_MAX_TABLE_BYTES = 8 * 1024 * 1024


def _program_config(cfg: dict):
    from repro_torch.configs.registry import get_arch
    arch = get_arch(cfg["arch"])
    mc = arch.model.replace(
        n_sparse=cfg["n_sparse"], n_dense=cfg["n_dense"],
        embed_dim=cfg["embed_dim"],
        vocab_sizes=(cfg["rows"],) * cfg["n_sparse"],
        mlp_dims=tuple(cfg["mlp"]), multi_hot=cfg["multi_hot"],
        param_dtype=cfg["param_dtype"])
    return arch, mc


def build_train(cfg: dict, batch: int, device):
    from repro_torch.configs.base import RecsysShape
    from repro_torch.launch.train import build_step
    arch, mc = _program_config(cfg)
    if arch.optimizer != cfg["optimizer"]["name"]:
        raise ValueError(f"{cfg['arch']} trains with {arch.optimizer}")
    model, opt_state, step_fn, _, _ = build_step(
        arch, mc, RecsysShape("train_batch", "train", batch),
        torch.device(device), lr=cfg["optimizer"]["lr"])
    return model, opt_state, step_fn


def build_serve(cfg: dict, device):
    from repro_torch.models import recsys
    _, mc = _program_config(cfg)
    model = recsys.init_model(mc, seed=0, device=device)

    @torch.no_grad()
    def score(batch):
        return model(batch)
    return model, score


def forward_flops(cfg: dict) -> float:
    dims = [cfg["n_sparse"] * cfg["embed_dim"] + cfg["n_dense"]] \
        + list(cfg["mlp"]) + [1]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:])) + cfg["n_dense"]
    return 2.0 * macs


def kernels(cfg: dict, batch: int, uniq: int, train: bool) -> dict:
    f, d, hot, v = (cfg["n_sparse"], cfg["embed_dim"], cfg["multi_hot"],
                    cfg["rows"])
    elem = torch.empty((), dtype=getattr(torch, cfg["param_dtype"])
                       ).element_size()
    deep = costs.bag_fwd(batch, f, hot, v, d, elem, uniq)
    wide = costs.bag_fwd(batch, f, hot, v, 1, elem, uniq)
    if v * elem <= FUSED_MAX_TABLE_BYTES and hot <= 16:
        out = {"embedding_bag_fwd_kernel": [deep],
               "embedding_bag_fused_fwd_kernel": [wide]}
    else:
        out = {"embedding_bag_fwd_kernel": [deep, wide]}
    if train:
        out["embedding_bag_bwd_kernel"] = [
            costs.bag_bwd(batch, f, hot, v, d, elem, uniq),
            costs.bag_bwd(batch, f, hot, v, 1, elem, uniq)]
    return out
