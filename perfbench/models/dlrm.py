"""How the benchmark drives a DLRM configuration through the port: its
train step from `repro_torch.launch.train.build_step` (unplaced), its
scoring through `repro_torch.models.dlrm.DLRM`'s forward under
`no_grad`; its leaves, FLOPs and kernels' least work, counted here."""
from __future__ import annotations

import torch

from perfbench.lib import costs
from perfbench.reference import dlrm as ref

TABLES = ("tables",)
leaves = ref.leaves
reference_forward = ref.forward


def _program_config(cfg: dict):
    from repro_torch.configs.registry import get_arch
    arch = get_arch(cfg["arch"])
    mc = arch.model.replace(
        n_sparse=cfg["n_sparse"], n_dense=cfg["n_dense"],
        embed_dim=cfg["embed_dim"],
        vocab_sizes=(cfg["rows"],) * cfg["n_sparse"],
        bottom_mlp=tuple(cfg["bottom_mlp"]), top_mlp=tuple(cfg["top_mlp"]),
        multi_hot=cfg["multi_hot"], param_dtype=cfg["param_dtype"])
    return arch, mc


def build_train(cfg: dict, batch: int, device):
    """(model, optimizer state, step_fn) of `launch/train`'s train step."""
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
    """(model, score_fn(batch) -> logits) of the DLRM's forward."""
    from repro_torch.models import dlrm
    _, mc = _program_config(cfg)
    model = dlrm.init_params(mc, seed=0, device=device)

    @torch.no_grad()
    def score(batch):
        return model(batch)
    return model, score


def forward_flops(cfg: dict) -> float:
    """A sample's forward FLOPs: the MLPs' products and the dots."""
    f1 = cfg["n_sparse"] + 1
    bottom = [cfg["n_dense"]] + list(cfg["bottom_mlp"])
    top = [f1 * (f1 - 1) // 2 + cfg["bottom_mlp"][-1]] + list(cfg["top_mlp"])
    macs = sum(a * b for dims in (bottom, top)
               for a, b in zip(dims[:-1], dims[1:]))
    return 2.0 * (macs + f1 * (f1 - 1) // 2 * cfg["embed_dim"])


def kernels(cfg: dict, batch: int, uniq: int, train: bool) -> dict:
    """{kernel: [least work of each launch in a step]}."""
    f, d, hot, v = (cfg["n_sparse"], cfg["embed_dim"], cfg["multi_hot"],
                    cfg["rows"])
    elem = torch.empty((), dtype=getattr(torch, cfg["param_dtype"])
                       ).element_size()
    out = {"embedding_bag_fwd_kernel":
           [costs.bag_fwd(batch, f, hot, v, d, elem, uniq)],
           "dot_interact_fwd_kernel": [costs.dot_fwd(batch, f + 1, d, elem)]}
    if train:
        out["embedding_bag_bwd_kernel"] = [
            costs.bag_bwd(batch, f, hot, v, d, elem, uniq)]
        out["dot_interact_bwd_kernel"] = [costs.dot_bwd(batch, f + 1, d,
                                                        elem)]
    return out
