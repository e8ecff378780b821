"""Parameters as numpy in the JAX layout: the element encoding and the
weight transpose shared by the model modules' `params_from_numpy` /
`params_to_numpy` and by train/checkpoint.py.

A bf16 array travels as its 2-byte elements. `np.savez` of a JAX bf16
array stores them as the void type `|V2`, and `np.load` gives them back
as such; a JAX array handed over directly is `ml_dtypes.bfloat16`.
`torch.from_numpy` takes neither, and the port needs no package that
adds a numpy bf16, so both directions go through an int16 view of the
bits.
"""
from __future__ import annotations

import numpy as np
import torch


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; a bf16 tensor's bits as 2-byte
    void elements (`|V2`)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a) -> torch.Tensor:
    """A host numpy array as a (CPU) tensor that owns a copy of it; any
    2-byte void or non-numpy 2-byte type (`|V2` from `np.load`, or
    `ml_dtypes.bfloat16` from a JAX array) is read as bf16."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V":
        return torch.from_numpy(np.array(a.view(np.int16), copy=True)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def generator(device, seed: int):
    """A generator on `device` seeded with `seed`; None on the meta
    device, which holds shapes and no values (the dry run's)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def transpose(x):
    """A 2-D torch tensor or numpy array, transposed and contiguous: an
    `nn.Linear` weight (out, in) to the JAX layout's `w` (in, out) and
    back."""
    if torch.is_tensor(x):
        return x.t().contiguous()
    return np.ascontiguousarray(np.asarray(x).T)
