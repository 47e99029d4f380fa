"""DFF training engine (the port of `aadff_tpu/train/trainer.py`):
`render_focal_stack` :170-189, the AiF train step `_aif_step_body` :68-112
with its non-finite guard `guard_nonfinite` :57-65 (`guarded_step`, which
the DFV step of `train/dff_dfv.py` shares), `make_aif_eval_step` :159-167
and the checkpoints :274-287.

JAX's train state is immutable; here `TrainState` holds the model and the
optimizer state, and a train step updates them in place.  The optimizer is
optax's `adam(cosine_decay_schedule(lr, decay_steps, alpha=0))` written out
over tensors, so that the guard is a `torch.where` on every tensor of the
state and never waits for the host.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
from torch import nn

from ..models.aifnet import compute_loss


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) scaled by
    optax.cosine_decay_schedule(lr, decay_steps, alpha=0) evaluated at the
    count before the update; moments and count are device tensors."""

    def __init__(self, params, lr: float, decay_steps: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if decay_steps <= 0:
            raise ValueError(f"decay_steps must be positive, got {decay_steps}")
        self.params = list(params)
        self.lr, self.decay_steps = lr, float(decay_steps)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.float(), max=self.decay_steps)
        return self.lr * (0.5 * (1 + torch.cos(math.pi * c / self.decay_steps)))

    @torch.no_grad()
    def step(self, grads, ok: torch.Tensor):
        """One update where `ok` (a 0-d bool tensor); where it is False the
        parameters, moments and count keep their values."""
        count_inc = self.count + 1
        neg_lr = -self.learning_rate(self.count)
        bc1 = 1 - self.b1 ** count_inc
        bc2 = 1 - self.b2 ** count_inc
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m_new = (1 - self.b1) * g + self.b1 * m
            v_new = (1 - self.b2) * g ** 2 + self.b2 * v
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            p.copy_(torch.where(ok, p + update * neg_lr, p))
            m.copy_(torch.where(ok, m_new, m))
            v.copy_(torch.where(ok, v_new, v))
        self.count.copy_(torch.where(ok, count_inc, self.count))

    def tensors(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}


@dataclass
class TrainState:
    model: nn.Module
    opt: Adam
    step: torch.Tensor


def create_train_state(model: nn.Module, lr: float,
                       decay_steps: int) -> TrainState:
    """The train state of any DFF model (AiFDepthNet, DFVNet): Adam over
    its parameters with the cosine schedule, and a step count of 0."""
    device = next(model.parameters()).device
    return TrainState(model=model, opt=Adam(model.parameters(), lr, decay_steps),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def guarded_step(state: TrainState, loss_fn) -> dict:
    """One train step with the non-finite guard (`guard_nonfinite`, shared
    by the AiF and DFV steps of the JAX package).

    `loss_fn(model)` runs the train-mode forward and returns a dict of 0-d
    losses with the objective under "total".  A batch whose loss or gradient
    norm is not finite leaves the parameters, the Adam moments and count and
    the BatchNorm statistics as they were; its losses read 0 and
    `skipped_nonfinite` 1.
    """
    model = state.model
    model.train()
    stats = list(model.buffers())
    stats_before = [b.clone() for b in stats]
    losses = loss_fn(model)
    # a parameter the loss does not reach (DFVNet's coarsest projections,
    # whose BatchNorm statistics still update) gets a zero gradient, as in JAX
    grads = torch.autograd.grad(losses["total"], state.opt.params,
                                allow_unused=True, materialize_grads=True)
    gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    ok = torch.isfinite(losses["total"]) & torch.isfinite(gnorm)
    state.opt.step(grads, ok)
    with torch.no_grad():
        for b, before in zip(stats, stats_before):
            b.copy_(torch.where(ok, b, before))
        state.step += 1
    losses = {k: torch.where(ok, v.detach(), 0.0) for k, v in losses.items()}
    losses["skipped_nonfinite"] = (~ok).float()
    return losses


def trunk_dtype(args: dict):
    """The AiFDepthNet trunk dtype that a run's args select:
    `compute_dtype: "bf16"` gives torch.bfloat16, anything else None (f32),
    as `aadff_tpu/train/dff_aif.py:53-57` chooses."""
    return torch.bfloat16 if args.get("compute_dtype") == "bf16" else None


def make_aif_train_step(task: str, disp_w: float = 1.0, aif_w: float = 0.0,
                        smooth_w: float = 0.0):
    """Returns train_step(state, stack, focus_dists, depth, aif) -> losses,
    guarded as `guarded_step` says.

    stack [B, S, H, W, C]; depth and aif NCHW like the reference.  The model
    may have a bf16 trunk (`AiFDepthNet(dtype=torch.bfloat16)`): its
    parameters, Adam's moments, the guard and the loss stay f32.
    """

    def train_step(state: TrainState, stack, focus_dists, depth, aif):
        return guarded_step(state, lambda model: compute_loss(
            model(stack, focus_dists), {"depth": depth, "AiF_img": aif},
            task, disp_w=disp_w, aif_w=aif_w, smooth_w=smooth_w))

    return train_step


def make_aif_eval_step():
    """Returns eval_step(state, stack, focus_dists) -> model outputs, with
    BatchNorm on its running statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, stack, focus_dists):
        state.model.eval()
        return state.model(stack, focus_dists)

    return eval_step


def render_focal_stack(lens, aif, depth, focus_dists) -> torch.Tensor:
    """Render an aberrated focal stack (reference
    2_aber_aware_dff_aif.py:107-116).

    aif [B, C, H, W]; depth [B, 1, H, W] in m (> 0); focus_dists [B, S] in m.
    Returns [B, S, H, W, C] (channels last, the models' input layout).
    """
    stack = lens.render_stack(aif, depth * -1e3, focus_dists * -1e3)
    return stack.permute(0, 1, 3, 4, 2)


def save_checkpoint(ckpt_dir: str, state: TrainState, name: str = "last"):
    """Write the whole train state to depth_net_<name>.pt, atomically (a kill
    mid-write leaves the previous file intact)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"depth_net_{name}.pt")
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(), **state.opt.tensors(),
                "step": state.step}, tmp)
    os.replace(tmp, path)


def load_checkpoint(ckpt_dir: str, state: TrainState,
                    name: str = "last") -> TrainState:
    """Restore a train state written by `save_checkpoint` into `state`."""
    path = os.path.join(ckpt_dir, f"depth_net_{name}.pt")
    device = state.step.device
    sd = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(sd["model"])
    with torch.no_grad():
        for dst, src in zip(state.opt.mu + state.opt.nu, sd["mu"] + sd["nu"]):
            dst.copy_(src)
        state.opt.count.copy_(sd["count"])
        state.step.copy_(sd["step"])
    return state
