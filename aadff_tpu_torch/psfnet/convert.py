"""Flax `MLP` params -> torch state dict (the port of
`aadff_tpu/psfnet/convert.py:35-46`).  Flax `Dense_i.kernel` is [in, out];
torch `Linear.weight` is [out, in]."""
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
