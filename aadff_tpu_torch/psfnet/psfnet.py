"""PSF surrogate: load, predict and render focal stacks (the port of
`PSFNet.load_net`, `pred`, `render`, `render_stack` and `render_path` in
`aadff_tpu/psfnet/psfnet.py:109-118, 551-722`).

The port takes `sensor_res` directly and builds no ray-traced `Lens`.  Units
are the reference's: depths and focus distances in negative millimetres,
normalised over [d_min, d_max] = [-DMIN, -DMAX] and clipped to [0, 1].

Routes, chosen per frame as `psfnet.py:583,642` choose them:
  * a frame of the sensor's size goes through the fused render
    (`ops/fused_render.py`: field -> MLP -> per-pixel convolution in one
    kernel, the whole stack in one launch);
  * any other frame takes the two-stage route: `psf_field` -> the PSF MLP
    (`ops/mlp_psf.py`) -> `ops/render.py:local_psf_render`, one frame of the
    stack at a time as `lax.map` does.
The JAX package also sends a sensor-sized frame down the two-stage route
when the TPU's tiles do not divide it (`fused_tile_height`); the CUDA fused
kernel takes any H x W, so the port does not.  On a CPU tensor both routes
run their plain PyTorch versions.

Two attributes mirror JAX's (`psfnet.py:41,55-61`): `render_dtype` ("f32",
the default, or "bf16") is the compute dtype of the PSF MLP on both routes,
and `stack_kernel` (default True) renders a sensor-sized stack in one fused
launch; False renders it frame by frame through the fused kernel's
one-frame launch, as `lax.map` over `render_impl` does (`:663-667`).
"""
from __future__ import annotations

import torch

from ..constants import DMAX, DMIN
from ..ops.fused_render import fused_psf_render, psf_field
from ..ops.mlp_psf import mlp_psf
from ..ops.render import local_psf_render
from ..utils import flax_msgpack
from .arch import MLP
from .convert import flax_mlp_to_torch_state


RENDER_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class PSFNet:
    def __init__(self, kernel_size: int = 11, sensor_res=(480, 640),
                 device="cuda", render_dtype: str = "f32"):
        self.kernel_size = kernel_size
        self.sensor_res = tuple(sensor_res)
        self.device = torch.device(device)
        self.d_max = -DMAX
        self.d_min = -DMIN
        self.model = MLP(in_features=4, out_features=kernel_size ** 2,
                         hidden_features=256, hidden_layers=8).to(self.device)
        self.model.requires_grad_(False)
        self.render_dtype = render_dtype
        self.compute_dtype()  # raises on a dtype the kernels do not take
        self.stack_kernel = True

    def compute_dtype(self) -> torch.dtype:
        """The torch dtype of `render_dtype`; raises on any other value."""
        if self.render_dtype not in RENDER_DTYPES:
            raise ValueError(f"render_dtype must be 'f32' or 'bf16', got "
                             f"{self.render_dtype!r}")
        return RENDER_DTYPES[self.render_dtype]

    def load_net(self, net_path: str):
        """Load Flax msgpack weights (`{'params': {'Dense_i': ...}}`)."""
        state = flax_mlp_to_torch_state(flax_msgpack.load(net_path))
        self.model.load_state_dict(state)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).contiguous()

    @torch.no_grad()
    def pred(self, inp) -> torch.Tensor:
        """[..., 4] -> [..., ks, ks] PSFs."""
        psf = self.model(self._tensor(inp))
        return psf.reshape(*psf.shape[:-1], self.kernel_size, self.kernel_size)

    @torch.no_grad()
    def _render_two_stage(self, img, depth, foc, dtype) -> torch.Tensor:
        """img [N, C, H, W], depth [N, H, W], foc [N] -> [N, C, H, W]."""
        N, C, H, W = img.shape
        ks = self.kernel_size
        field = psf_field(depth, foc, self.d_min, self.d_max)
        psf = mlp_psf(self.model, field.reshape(-1, 4), dtype)
        return local_psf_render(img, psf.reshape(N, H, W, ks, ks), ks)

    def _render_fused(self, img, depth, focus, dtype) -> torch.Tensor:
        return fused_psf_render(self.model, img, depth, focus,
                                self.kernel_size, self.d_min, self.d_max,
                                dtype)

    def render_stack(self, img, depth, focus_dists) -> torch.Tensor:
        """img [B, C, H, W]; depth [B, 1, H, W] mm (<0); focus_dists [B, S]
        mm (<0) -> [B, S, C, H, W]."""
        dtype = self.compute_dtype()
        img = self._tensor(img)
        B, C, H, W = img.shape
        depth = self._tensor(depth).reshape(B, H, W)
        focus = self._tensor(focus_dists).reshape(B, -1)
        S = focus.shape[1]
        if (H, W) == self.sensor_res and self.stack_kernel:
            return self._render_fused(img, depth, focus, dtype)
        if (H, W) == self.sensor_res:
            frames = [self._render_fused(img, depth,
                                         focus[:, s:s + 1].contiguous(),
                                         dtype)[:, 0] for s in range(S)]
        else:
            frames = [self._render_two_stage(img, depth, focus[:, s], dtype)
                      for s in range(S)]
        return torch.stack(frames, dim=1)

    def render(self, img, depth, foc_dist) -> torch.Tensor:
        """img [N, C, H, W] (or [C, H, W]); depth [N, 1, H, W] or [N, H, W] mm
        (<0); foc_dist [N] mm (<0) -> [N, C, H, W]."""
        img = self._tensor(img)
        if img.dim() == 3:
            img = img[None]
        foc = self._tensor(foc_dist).reshape(-1, 1)
        return self.render_stack(img, depth, foc)[:, 0]

    def render_path(self, res=None) -> str:
        """Label of the route render()/render_stack() take on this device for
        frames of size `res` (default: the sensor resolution), with the
        render dtype as JAX's labels carry it (`psfnet.py:700-701`)."""
        res = self.sensor_res if res is None else tuple(res)
        self.compute_dtype()
        dt = self.render_dtype
        if self.device.type != "cuda":
            return f"torch-mlp+taploop({dt})"
        if res == self.sensor_res:
            return f"fused-mlp+conv({dt},cuda)"
        return f"mlp-psf({dt},cuda)+taploop"
