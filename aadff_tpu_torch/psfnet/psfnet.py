"""PSF surrogate: fit it to a ray-traced lens, gate it, and render focal
stacks through it (the port of `aadff_tpu/psfnet/psfnet.py`).

Fitting (`psfnet.py:96-548`): given a lens file, `PSFNet` owns the port's
ray-traced `Lens` (`self.lens`; its attributes are also reached through the
net, as in JAX) and fits the MLP to PSFs that `optics/psf.py` traces on the
fly: `train_psfnet` (AdamW with a cosine schedule and the non-finite
guard), `get_training_data`, `evaluate_psf_score` (the quality gate),
`evaluate_psf` (PNG panels), `thin_lens_psf` and `save_net` (a Flax msgpack
file that either package reads).  The 20 training focus states are
resolved once per fit or gate, as JAX does (`psfnet.py:275-283,
439-445`).  Every label is traced under `torch.no_grad()` (JAX stops the
gradient there), and the labels and the fit's MLP run in full f32
(`full_f32`) whatever the process's TF32 flags say.  Random draws come
from `self.generator` (a generator on the net's device, seeded with
seed + 17 as JAX seeds its key); the functions the tests hold to JAX also
take them as tensors (`draws=`).

Rendering (`psfnet.py:551-722`).  Units are the reference's: depths and
focus distances in negative millimetres, normalised over [d_min, d_max] =
[-DMIN, -DMAX] and clipped to [0, 1].  Routes, chosen per frame as
`psfnet.py:583,642` choose them:
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

import logging
import os

import numpy as np
import torch

from ..constants import DEFAULT_WAVE, DMAX, DMIN
from ..ops.fused_render import fused_psf_render, jax_linspace, psf_field
from ..ops.mlp_psf import mlp_psf
from ..ops.render import local_psf_render
from ..optics.lens import Lens
from ..optics.psf import (PsfDraws, draw_psf, full_f32, lens_psf, lens_scalars,
                          psf_impl)
from ..train.trainer import Adam
from ..utils import flax_msgpack
from ..utils.image import write_png
from .arch import MLP
from .convert import flax_mlp_to_torch_state, torch_mlp_to_flax


RENDER_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The 20 focus distances the surrogate is fitted and gated at [mm]
# (`psfnet.py:69-74`).
FOC_D_ARR = np.array(
    [-500, -600, -700, -800, -900,
     -1000, -1250, -1500, -1750, -2000,
     -2500, -3000, -4000, -5000, -6000,
     -8000, -10000, -12000, -15000, -20000], dtype=np.float64)
WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX fit uses
# Rays a gate chunk traces at once: 57M for the 20 x 10 lattice would take
# several GB a 3-vector, so the lattice goes in chunks of whole combinations.
GATE_CHUNK_RAYS = 8 * 2**20


class PSFNet:
    def __init__(self, kernel_size: int = 11, sensor_res=(480, 640),
                 device="cuda", render_dtype: str = "f32", filename=None,
                 seed: int = 0):
        self.kernel_size = kernel_size
        self.sensor_res = tuple(sensor_res)
        self.device = torch.device(device)
        self.d_max = -DMAX
        self.d_min = -DMIN
        self.lens_path = filename
        self.lens = (None if filename is None else
                     Lens(filename, sensor_res=sensor_res, seed=seed,
                          device=self.device))
        self.model = MLP(in_features=4, out_features=kernel_size ** 2,
                         hidden_features=256, hidden_layers=8)
        self.model.init_lecun(torch.Generator().manual_seed(seed))
        self.model.to(self.device).requires_grad_(False)
        self.render_dtype = render_dtype
        self.compute_dtype()  # raises on a dtype the kernels do not take
        self.stack_kernel = True

        # fitting settings (`psfnet.py:63-78`)
        self.spp = 4096
        self.patch_size = 64
        self.psf_grid = [self.sensor_res[0] // self.patch_size,
                         self.sensor_res[1] // self.patch_size]
        self.foc_d_arr = FOC_D_ARR.copy()
        self.foc_z_arr = (self.foc_d_arr - self.d_min) / (self.d_max - self.d_min)
        self._np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)

    def __getattr__(self, name):
        """The lens's attributes (refocus, entrance_pupil, trace, ...)."""
        lens = self.__dict__.get("lens")
        if lens is not None and hasattr(lens, name):
            return getattr(lens, name)
        raise AttributeError(name)

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

    def save_net(self, net_path: str):
        """Write the weights as the JAX package's `save_net` does: a Flax
        msgpack file, atomically."""
        flax_msgpack.save(net_path, torch_mlp_to_flax(self.model))

    def z2depth(self, z):
        """Normalised depth -> mm (`psfnet.py:138-139`)."""
        return z * (self.d_max - self.d_min) + self.d_min

    # ------------------------------------------------------------------
    # Ray-traced ground truth
    # ------------------------------------------------------------------
    def _need_lens(self):
        if self.lens is None:
            raise ValueError("this PSFNet has no lens: pass filename=")
        return self.lens

    def psf(self, points, ks=None, spp=None, wvln=DEFAULT_WAVE, center=True,
            generator=None, draws=None):
        """PSFs [N, ks, ks] of points [N, 3] at the lens's current focus."""
        ks = self.kernel_size if ks is None else ks
        spp = self.spp if spp is None else spp
        with torch.no_grad():
            return lens_psf(self._need_lens(), points, ks=ks, wvln=wvln, spp=spp,
                            center=center, generator=generator, draws=draws)

    def focus_states(self, foc_idx=None) -> list[tuple]:
        """The lens scalars of `psf_impl` (`lens_scalars`) at each focus
        distance of `foc_d_arr[foc_idx]` (default: all 20), as f32 tensors
        on the net's device."""
        lens = self._need_lens()
        foc_idx = range(len(self.foc_d_arr)) if foc_idx is None else foc_idx
        states = []
        for i in foc_idx:
            lens.refocus(float(self.foc_d_arr[i]))
            states.append(tuple(torch.tensor(np.float32(v), device=self.device)
                                for v in lens_scalars(lens)))
        return states

    def fit_batch(self, foc_z, ux, uy, zn):
        """(MLP input [bs, 4], points [bs, 3]) of a fit batch from its draws:
        uniforms ux, uy and a standard normal zn, each [bs]
        (`psfnet.py:174-182`).  `foc_z` is a number (get_training_data) or
        an f32 tensor (the fit), as in JAX."""
        x = (ux - 0.5) * 2
        y = (uy - 0.5) * 2
        zg = torch.clamp(zn, -3, 3)
        z = torch.where(zg > 0, (1 - foc_z) * zg / 3 + foc_z, foc_z * zg / 3 + foc_z)
        inp = torch.stack([x, y, z, torch.full_like(x, 1.0) * foc_z], dim=-1)
        depth = self.z2depth(z)
        points = torch.stack([x, y, depth], dim=-1)
        return inp, points

    def _draw_batch(self, bs, spp, generator=None):
        g = self.generator if generator is None else generator
        dev = self.device
        return (torch.rand(bs, generator=g, device=dev),
                torch.rand(bs, generator=g, device=dev),
                torch.randn(bs, generator=g, device=dev),
                draw_psf(spp, g, dev))

    def get_training_data(self, bs=256, spp=4096, generator=None, draws=None):
        """One batch of (input [bs, 4], ray-traced PSF [bs, ks*ks]) at a focus
        drawn from the net's numpy stream (`psfnet.py:351-367`).  `draws`
        = (ux, uy, zn, PsfDraws), default from `generator`."""
        foc_z = float(self._np_rng.choice(self.foc_z_arr))
        foc_dist = foc_z * (self.d_max - self.d_min) + self.d_min
        self._need_lens().refocus(foc_dist)
        ux, uy, zn, psf_draws = (self._draw_batch(bs, spp, generator)
                                 if draws is None else draws)
        f32 = [torch.as_tensor(u, dtype=torch.float32, device=self.device)
               for u in (ux, uy, zn)]
        inp, points = self.fit_batch(foc_z, *f32)
        psf = self.psf(points=points, ks=self.kernel_size, spp=spp,
                       draws=psf_draws)
        return inp, psf.reshape(bs, -1)

    # ------------------------------------------------------------------
    # Fitting (`psfnet.py:163-312`, model 'mlp')
    # ------------------------------------------------------------------
    def fit_optimizer(self, lr: float, iters: int) -> Adam:
        """optax.adamw(cosine_decay_schedule(lr, iters, alpha=0)) over the
        MLP's parameters, with optax.adamw's weight decay 1e-4."""
        return Adam(self.model.parameters(), lr, iters,
                    weight_decay=WEIGHT_DECAY)

    def fit_step(self, opt: Adam, foc_z, scalars, bs=128, spp=4096,
                 draws=None) -> torch.Tensor:
        """One fit iteration (`psfnet.py:172-213`): a batch at focus `foc_z`
        (f32) with lens scalars `scalars` (one of `focus_states`), its PSFs
        traced without gradient, the MSE of the MLP's prediction, and an
        AdamW update guarded against a non-finite loss or gradient norm (a
        guarded batch leaves parameters, moments and both counts as they
        were).  `draws` = (ux, uy, zn, PsfDraws), default from the net's
        generator.  Returns the loss, a 0-d tensor (NaN where guarded)."""
        lens = self._need_lens()
        ux, uy, zn, psf_draws = (self._draw_batch(bs, spp) if draws is None
                                 else draws)
        foc_z = torch.as_tensor(foc_z, dtype=torch.float32, device=self.device)
        inp, points = self.fit_batch(foc_z, ux, uy, zn)
        with full_f32():
            with torch.no_grad():
                psf_gt = psf_impl(lens.params, lens.metas, points, psf_draws,
                                  self.kernel_size, DEFAULT_WAVE, True,
                                  tuple(range(len(lens.metas))), *scalars)
                psf_gt = psf_gt.reshape(bs, -1)
            self.model.requires_grad_(True)
            try:
                loss = torch.mean((self.model(inp) - psf_gt) ** 2)
                grads = torch.autograd.grad(loss, opt.params)
            finally:
                self.model.requires_grad_(False)
        gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        opt.step(grads, torch.isfinite(loss) & torch.isfinite(gnorm))
        return loss.detach()

    def train_psfnet(self, iters=10000, bs=128, lr=1e-4, spp=2048,
                     evaluate_every=1000, result_dir="./results/temp"):
        """Fit the surrogate with ray-traced labels (`psfnet.py:248-312`):
        iters + 1 iterations, each at one of the 20 focus states drawn from
        the net's numpy stream.  Every `evaluate_every` iterations (and at
        the end) the losses are read, logged, and the weights saved to
        <result_dir>/PSFNet_mlp.msgpack.  Returns the losses."""
        os.makedirs(result_dir, exist_ok=True)
        opt = self.fit_optimizer(lr, int(iters))
        states = self.focus_states()
        foc_z = torch.tensor(self.foc_z_arr.astype(np.float32), device=self.device)
        losses, pending = [], []
        total = int(iters) + 1
        for done in range(1, total + 1):
            idx = int(self._np_rng.integers(0, len(states)))
            pending.append(self.fit_step(opt, foc_z[idx], states[idx], bs, spp))
            if done % evaluate_every == 0 or done == total:
                losses.extend(torch.stack(pending).tolist())
                pending.clear()
                logging.info(f"iter {done}: loss {losses[-1]:.3e}")
                self.save_net(os.path.join(result_dir, "PSFNet_mlp.msgpack"))
        return losses

    # ------------------------------------------------------------------
    # Evaluation (`psfnet.py:414-546`)
    # ------------------------------------------------------------------
    def gate_lattice(self, n_z=40, foc_subset=None):
        """The gate's lattice, foc-major as the reference loops it: (focus
        indices, per combination: index into them, z, foc_z)."""
        foc_idx = (np.arange(len(self.foc_z_arr)) if foc_subset is None
                   else np.asarray(foc_subset))
        test_z = np.linspace(0, 1, n_z, endpoint=True)
        fi = np.repeat(np.arange(len(foc_idx)), n_z)
        zs = np.tile(test_z, len(foc_idx)).astype(np.float32)
        foc_zs = np.asarray(self.foc_z_arr, np.float32)[foc_idx][fi]
        return foc_idx, fi, zs, foc_zs

    def evaluate_psf_score(self, spp=None, n_z=40, foc_subset=None):
        """Mean L1/L2 PSF error over the (foc, z, field-grid) lattice against
        freshly ray-traced PSFs (`psfnet.py:414-486`).  Returns (l1, l2)."""
        spp = self.spp if spp is None else spp
        foc_idx, fi, zs, foc_zs = self.gate_lattice(n_z, foc_subset)
        states = self.focus_states(foc_idx)
        draws = draw_psf(spp, self.generator, self.device, n_calls=len(fi))
        return self.psf_score(states, fi, zs, foc_zs, draws)

    def psf_score(self, states, fi, zs, foc_zs, draws: PsfDraws,
                  chunk_rays: int = GATE_CHUNK_RAYS):
        """(l1, l2) of the lattice (fi, zs, foc_zs) at focus states `states`,
        with one set of draws per combination ([spp, C], [GEO_SPP, C]).
        Whole combinations are traced together, at most `chunk_rays` rays a
        chunk."""
        lens = self._need_lens()
        ks = self.kernel_size
        gh, gw = self.psf_grid
        x, y = np.meshgrid(
            np.linspace(-1 + 1 / (2 * gw), 1 - 1 / (2 * gw), gw),
            np.linspace(1 - 1 / (2 * gh), -1 + 1 / (2 * gh), gh),
            indexing="xy",
        )
        dev = self.device
        xj = torch.tensor(x.reshape(-1), dtype=torch.float32, device=dev)
        yj = torch.tensor(y.reshape(-1), dtype=torch.float32, device=dev)
        P, spp = len(xj), draws.theta.shape[0]
        stacked = [torch.stack([s[j] for s in states]) for j in range(len(states[0]))]
        fi = torch.as_tensor(np.asarray(fi), device=dev)
        zs = torch.as_tensor(np.asarray(zs, np.float32), device=dev)
        foc_zs = torch.as_tensor(np.asarray(foc_zs, np.float32), device=dev)
        per_chunk = max(1, chunk_rays // (P * spp))
        l1s, l2s = [], []
        with torch.no_grad(), full_f32():
            for c0 in range(0, len(fi), per_chunk):
                sl = slice(c0, c0 + per_chunk)
                z, foc_z = zs[sl], foc_zs[sl]
                B = len(z)
                depth = z * (self.d_max - self.d_min) + self.d_min
                pts = torch.stack([xj.repeat(B), yj.repeat(B),
                                   depth.repeat_interleave(P)], dim=-1)
                scal = [s[fi[sl]].repeat_interleave(P) for s in stacked]
                d = PsfDraws(*(t[:, sl].repeat_interleave(P, dim=1) for t in draws))
                psf_gt = psf_impl(lens.params, lens.metas, pts, d, ks,
                                  DEFAULT_WAVE, True,
                                  tuple(range(len(lens.metas))), *scal)
                inp = torch.stack([pts[:, 0], pts[:, 1], z.repeat_interleave(P),
                                   foc_z.repeat_interleave(P)], dim=-1)
                err = (psf_gt - self.model(inp).reshape(-1, ks, ks)).reshape(B, -1)
                n = err.shape[1]
                l1s.append(torch.sum(torch.abs(err), dim=1) / n)
                l2s.append(torch.sum(err**2, dim=1) / n)
        return (float(torch.mean(torch.cat(l1s))),
                float(torch.mean(torch.cat(l2s))))

    def thin_lens_psf(self, depth, foc_dist, thinlens=None):
        """Thin-lens Gaussian-CoC PSF [ks, ks] (`psfnet.py:488-504`): an
        unclipped Gaussian of the CoC radius, masked to the CoC disc, L1
        normalised."""
        ks = self.kernel_size
        if thinlens is None:
            thinlens = ThinLens(self.lens.foclen, self.lens.fnum, ks,
                                self.lens.sensor_size, self.lens.sensor_res)
        g = jax_linspace(-ks / 2 + 0.5, ks / 2 - 0.5, ks, self.device)
        xg, yg = torch.meshgrid(g, g, indexing="xy")
        radius = thinlens.coc(depth, foc_dist).to(self.device) / 2
        r2 = xg**2 + yg**2
        psf = torch.exp(-r2 / (2 * radius**2)) * (r2 < radius**2)
        return psf / torch.clamp(psf.sum(), min=1e-12)

    def evaluate_psf(self, result_dir="./"):
        """GT / prediction / thin-lens comparison (`psfnet.py:506-546`): the
        lens focused at 1.5 m, PSFs at 1.2 / 1.5 / 2 m and 3 field points,
        one PNG per depth (rows GT, pred, thin lens; a linear grey map of
        [0, 0.1], each PSF tap 16 x 16 pixels)."""
        ks = self.kernel_size
        x = torch.tensor([0.0, 0.6, 0.98], device=self.device)
        y = torch.tensor([0.0, 0.6, 0.98], device=self.device)
        test_foc_dists = [-1500.0]
        test_dists = [-1200.0, -1500.0, -2000.0]
        lens = self._need_lens()
        thinlens = ThinLens(lens.foclen, lens.fnum, ks, lens.sensor_size,
                            lens.sensor_res)
        for foc_dist in test_foc_dists:
            foc_z = float(np.clip((foc_dist - self.d_min) / (self.d_max - self.d_min), 0, 1))
            lens.refocus(foc_dist)
            for depth in test_dists:
                z = float(np.clip((depth - self.d_min) / (self.d_max - self.d_min), 0, 1))
                pts = torch.stack([x, y, torch.full_like(x, depth)], dim=-1)
                psf_gt = self.psf(points=pts, ks=ks)
                inp = torch.stack(
                    [x, y, torch.full_like(x, z), torch.full_like(x, foc_z)], dim=-1)
                psf_pred = self.pred(inp)
                psf_thin = self.thin_lens_psf(depth, foc_dist, thinlens)
                rows = [psf_gt, psf_pred, psf_thin.expand(len(x), ks, ks)]
                panel = torch.cat([torch.cat(list(r), dim=1) for r in rows], dim=0)
                grey = (torch.clamp(panel / 0.1, 0, 1) * 255).round().to(torch.uint8)
                grey = grey.repeat_interleave(16, 0).repeat_interleave(16, 1)
                write_png(os.path.join(
                    result_dir, f"foc{-foc_dist:.0f}_depth{-depth:.0f}.png"),
                    grey.cpu().numpy())

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


class ThinLens:
    """Thin-lens circle of confusion (`psfnet.py:728-754`): what
    `thin_lens_psf` needs of JAX's `ThinLens`."""

    def __init__(self, foc_len, fnum, kernel_size, sensor_size, sensor_res):
        self.d_max = DMAX
        self.d_min = DMIN
        self.kernel_size = kernel_size
        self.foc_len = foc_len
        self.fnum = fnum
        self.sensor_size = sensor_size
        self.sensor_res = sensor_res
        self.ps = self.sensor_size[0] / self.sensor_res[0]

    def coc(self, depth, foc_dist):
        """Circle of confusion in pixels."""
        depth = torch.as_tensor(depth, dtype=torch.float32)
        foc_dist = torch.as_tensor(foc_dist, dtype=torch.float32)
        neg = torch.any(depth < 0)
        depth = torch.where(neg, -depth, depth)
        foc_dist = torch.where(neg, -foc_dist, foc_dist)
        depth = torch.clamp(depth, self.d_min, self.d_max)
        coc = (
            self.foc_len / self.fnum
            * torch.abs(depth - foc_dist) / depth
            * self.foc_len / (foc_dist - self.foc_len)
        )
        return torch.clamp(coc / self.ps, min=0.1)
