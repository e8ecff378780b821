"""GraphSAGE (mean aggregator), minibatch regime, in PyTorch.

Port of the sampled-blocks path of repro/models/gnn.py: dense-fanout
blocks x0 (B, d), neigh1 (B, F1, d), neigh2 (B, F1, F2, d) from
data/sampler.py through a 2-layer GraphSAGE. Each neighbour term
`mean(x, axis) @ layer["w_neigh"]` runs through the hand-written kernel
`ops.sage_aggregate` (forward and backward), three calls a forward; the
`h_self @ w_self` products stay `torch.matmul`, as the JAX package leaves
them to XLA. The full-graph and batched-graph regimes are not ported yet.

Parameters cross between the packages as numpy in the JAX layout,
`{"layers": ({"w_self": (d_in, d_out), "w_neigh": (d_in, d_out),
"b": (d_out,)}, ...)}`, through `params_from_numpy` / `params_to_numpy`;
the module holds them in that layout (no transpose), named
`layers.<l>.<key>`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.kernels import ops

_KEYS = ("w_self", "w_neigh", "b")


class SageLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()

        def normal():
            t = torch.empty((d_in, d_out), dtype=dtype, device=device)
            with torch.no_grad():
                t.normal_(generator=generator).mul_(d_in ** -0.5)
            return nn.Parameter(t)
        self.w_self = normal()
        self.w_neigh = normal()
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype,
                                          device=device))


class GraphSAGE(nn.Module):
    """Layer l maps dims[l] -> dims[l + 1], dims = [d_feat] + [d_hidden] *
    (n_layers - 1) + [n_classes]."""

    def __init__(self, cfg: GNNConfig, d_feat: int, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dims = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) \
            + [cfg.n_classes]
        dtype = getattr(torch, cfg.param_dtype)
        self.layers = nn.ModuleList(
            SageLayer(dims[i], dims[i + 1], dtype=dtype, device=device,
                      generator=generator) for i in range(cfg.n_layers))


def init_params(cfg: GNNConfig, d_feat: int, *, seed: int = 0,
                device="cuda") -> GraphSAGE:
    """A GraphSAGE with random weights drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return GraphSAGE(cfg, d_feat, device=device, generator=gen)


def _sage_combine(h_self, h_neigh_proj, layer: SageLayer, *, final: bool):
    """h_self @ w_self + (the neighbour term, already projected) + b, then
    ReLU and an L2 normalisation unless final."""
    out = torch.matmul(h_self, layer.w_self) + h_neigh_proj + layer.b
    if not final:
        out = torch.relu(out)
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        # L2-normalise as in the paper (Hamilton et al. 2017, Alg. 1 l. 7)
        out = out / torch.clamp(norm, min=1e-6)
    return out


def minibatch_forward(model: GraphSAGE, x0, neigh1, neigh2, *,
                      agg_fn: Optional[Callable] = None):
    """Dense-fanout 2-layer GraphSAGE -> logits (B, C).

    x0 (B, d) seed features, neigh1 (B, F1, d), neigh2 (B, F1, F2, d).
    `agg_fn(neigh (N, F, d), w (d, h)) -> (N, h)` replaces the kernel op
    (a comparison against the plain version on the card uses it)."""
    agg_fn = agg_fn or ops.sage_aggregate
    l1, l2 = model.layers
    b, f1, f2, d = neigh2.shape
    # layer 1 at the depth-1 frontier: aggregate 2-hop into 1-hop nodes
    n2 = agg_fn(neigh2.reshape(b * f1, f2, d), l1.w_neigh).view(b, f1, -1)
    h1 = _sage_combine(neigh1, n2, l1, final=False)
    # layer 1 at the seeds themselves (aggregate 1-hop raw features)
    h0 = _sage_combine(x0, agg_fn(neigh1, l1.w_neigh), l1, final=False)
    # layer 2 at the seeds: aggregate 1-hop hidden into seeds
    return _sage_combine(h0, agg_fn(h1, l2.w_neigh), l2, final=True)


def minibatch_nll(model: GraphSAGE, batch: Dict[str, torch.Tensor],
                  **kw) -> torch.Tensor:
    """Per-seed negative log-likelihood (B,) f32."""
    logits = minibatch_forward(model, batch["x0"], batch["neigh1"],
                               batch["neigh2"], **kw)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None])[:, 0]


def minibatch_loss(model: GraphSAGE, batch: Dict[str, torch.Tensor], **kw):
    loss = minibatch_nll(model, batch, **kw).mean()
    return loss, {"xent": loss}


# ------------------------------------------------------ numpy exchange ---
def tree_from_named(named: Dict[str, object]) -> dict:
    """{"layers.<l>.<key>": x} -> the JAX layout {"layers": ({key: x},
    ...)} (for parameters and for optimizer state alike)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in named)
    return {"layers": tuple({key: named[f"layers.{l}.{key}"]
                             for key in _KEYS} for l in range(n_layers))}


def named_from_tree(tree: dict) -> Dict[str, object]:
    """The inverse of `tree_from_named`."""
    return {f"layers.{l}.{key}": layer[key]
            for l, layer in enumerate(tree["layers"]) for key in _KEYS}


def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy parameters -> a `GraphSAGE.state_dict()` (CPU
    tensors; `load_state_dict` copies them to the model's device)."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in named_from_tree(params).items()}


def params_to_numpy(model: GraphSAGE) -> dict:
    """The model's parameters as JAX-layout numpy arrays."""
    return tree_from_named({k: p.detach().cpu().numpy()
                            for k, p in model.named_parameters()})
