"""Flax `MLP` params <-> torch (the port of
`aadff_tpu/psfnet/convert.py:35-46`, and its inverse for `save_net`).
Flax `Dense_i.kernel` is [in, out]; torch `Linear.weight` is [out, in]."""
from __future__ import annotations

import numpy as np
import torch


def flax_mlp_to_torch_state(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': {'Dense_i': {'kernel', 'bias'}}} -> {'net.{2i}.weight/bias'}."""
    dense = variables["params"]
    out = {}
    for i in range(len(dense)):
        layer = dense[f"Dense_{i}"]
        out[f"net.{2 * i}.weight"] = torch.from_numpy(
            np.array(np.asarray(layer["kernel"], np.float32).T, order="C"))
        out[f"net.{2 * i}.bias"] = torch.from_numpy(
            np.array(layer["bias"], np.float32))
    return out


def torch_mlp_to_flax(model) -> dict:
    """The inverse: `MLP` -> {'params': {'Dense_i': {'kernel', 'bias'}}} of
    numpy f32 arrays, the variables the JAX package's `PSFNet` saves."""
    return {"params": {
        f"Dense_{i}": {
            "kernel": np.ascontiguousarray(
                lin.weight.detach().cpu().numpy().T, dtype=np.float32),
            "bias": lin.bias.detach().cpu().numpy().astype(np.float32),
        } for i, lin in enumerate(model.linears())}}
