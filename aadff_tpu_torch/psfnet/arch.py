"""PSF surrogate MLP (the port of `aadff_tpu/psfnet/arch.py:17-38`)."""
from __future__ import annotations

import torch
from torch import nn


class MLP(nn.Module):
    """4 -> hidden//4 -> hidden -> [hidden]*layers -> out, Sigmoid, L1-norm.

    Layers sit at `net.{2i}` like the reference torch module, so the state
    dict keys are `net.0.weight` ... `net.{2*(layers+2)}.bias`.
    """

    def __init__(self, in_features: int = 4, out_features: int = 121,
                 hidden_features: int = 256, hidden_layers: int = 8):
        super().__init__()
        widths = ([in_features, hidden_features // 4, hidden_features]
                  + [hidden_features] * hidden_layers + [out_features])
        layers = []
        for i in range(len(widths) - 1):
            layers += [nn.Linear(widths[i], widths[i + 1]), nn.ReLU()]
        layers[-1] = nn.Sigmoid()
        self.net = nn.Sequential(*layers)

    @torch.no_grad()
    def init_lecun(self, generator: torch.Generator):
        """Flax Dense's initialisation (`lecun_normal`: a normal truncated to
        +-2 sigma, scaled to variance 1/fan_in; zero biases), drawn from
        `generator`."""
        for lin in self.linears():
            std = (1.0 / lin.in_features) ** 0.5 / 0.87962566103423978
            w = torch.empty(lin.weight.shape, device=generator.device)
            nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
            lin.weight.copy_(w * std)
            lin.bias.zero_()

    def linears(self) -> list[nn.Linear]:
        return [m for m in self.net if isinstance(m, nn.Linear)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.net(x)
        return x / (x.abs().sum(dim=-1, keepdim=True) + 1e-12)
