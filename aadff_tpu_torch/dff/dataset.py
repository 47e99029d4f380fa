"""RGB-D / focal-stack datasets, augmentation and a prefetching loader (the
port of `aadff_tpu/dff/dataset.py`): the same directory layouts, scale
factors, augmentation policy and batch order.

Items are host numpy arrays, CHW float32 like the reference's ToTensor
output; the train loop moves them to the device.  Images are read with the
port's PNG reader (`utils/image.py`), which reads PNG only: a JPEG file
(Matterport3D's colour images, RealWorld's .JPG captures) raises.  The
augmentation rotates with `scipy.ndimage.rotate`, which the JAX package
uses when its native library is not built (`dataset.py:32-43`).
"""
from __future__ import annotations

import os
import queue
import random
import threading
from glob import glob

import numpy as np
from scipy.ndimage import rotate

from ..utils.image import imread_color, read_pfm, read_png, resize_hw


def _to_chw(img_hwc):
    return np.ascontiguousarray(np.transpose(img_hwc, (2, 0, 1))).astype(np.float32)


# ================================
# Augmentation (reference dff/dataset.py:252-286)
# ================================
def auto_augment(img, depth, rng=None):
    """img: [H, W, 3] (or [H, W, 3, S]); depth: [H, W].  Draws from numpy's
    global stream unless `rng` (a RandomState) is given."""
    rng = np.random if rng is None else rng
    if rng.rand() > 0.5:
        contrast = rng.rand()
        brightness = rng.rand()
        img = np.clip((0.5 + contrast * (img - 0.5)) + brightness, 0.0, 1.0)
    if rng.rand() > 0.5:
        img = np.flip(img, 1)
        depth = np.flip(depth, 1)
    if rng.rand() > 0.5:
        img = np.flip(img, 0)
        depth = np.flip(depth, 0)
    if rng.rand() > 0.5:
        degree = rng.randint(0, 180)
        img = np.ascontiguousarray(img, np.float32)
        if img.ndim == 4:
            for i in range(img.shape[-1]):
                img[..., i] = rotate(img[..., i], degree, reshape=False)
        else:
            img = rotate(img, degree, reshape=False)
        depth = rotate(depth.astype(np.float32), degree, reshape=False)
        depth = np.where(depth < 0, 0, depth)
    return np.ascontiguousarray(img), np.ascontiguousarray(depth)


# ================================
# Datasets
# ================================
class Dataset:
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class Matterport3D(Dataset):
    """RGB-D pairs (reference dff/dataset.py:17-52); depth png / 4000 -> [m]."""

    def __init__(self, rgb_path, depth_path, resize=None, train=True):
        self.rgb_path = rgb_path
        self.depth_path = depth_path
        self.scenes = [s.split("/")[-1] for s in glob(f"{rgb_path}/*")]
        self.resize = resize
        self.train = train
        self.imgs, self.depths = [], []
        for scene in self.scenes:
            self.imgs += sorted(glob(f"{rgb_path}/{scene}/undistorted_color_images/*.jpg"))
            self.depths += sorted(glob(f"{depth_path}/{scene}/render_depth/*.png"))

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, idx):
        aif = imread_color(self.imgs[idx]) / 255.0
        depth = read_png(self.depths[idx]) / 4000  # [m]
        if self.train:
            aif, depth = auto_augment(aif, depth)
        aif = resize_hw(aif.astype(np.float32), self.resize)
        depth = resize_hw(depth.astype(np.float32), self.resize)
        return [_to_chw(aif), depth[None].astype(np.float32)]


class FlyingThings3D(Dataset):
    """AiF or pre-rendered focal stacks (reference dff/dataset.py:55-110)."""

    DEPTH_FACTOR = 20

    def __init__(self, dataset_dir, resize=None, train=True, fs_num=0):
        self.dataset_dir = dataset_dir
        self.scenes = [s.split("/")[-1] for s in glob(f"{dataset_dir}/*")]
        self.resize = resize
        self.fs_num = fs_num
        self.train = train

    def __len__(self):
        return len(self.scenes)

    def _read_disp(self, scene):
        """disp.pfm, or disp.npy (the JAX package reads disp.exr first, with
        OpenCV's EXR codec, which the port does not have)."""
        d = self.dataset_dir
        if os.path.exists(f"{d}/{scene}/disp.exr"):
            raise NotImplementedError(
                f"{d}/{scene}/disp.exr: EXR is not read by the port; provide "
                f"disp.pfm or disp.npy")
        if os.path.exists(f"{d}/{scene}/disp.pfm"):
            return read_pfm(f"{d}/{scene}/disp.pfm")[0]
        return np.load(f"{d}/{scene}/disp.npy")

    def __getitem__(self, index):
        d = self.dataset_dir
        scene = self.scenes[index]
        depth = resize_hw(self._read_disp(scene) / self.DEPTH_FACTOR, self.resize)
        if self.fs_num > 0:
            focused, fdists = [], []
            stack_files = sorted(glob(f"{d}/{scene}/*.png"))[:-1]
            for name in random.sample(stack_files, self.fs_num):
                fdists.append(float(name.split("/")[-1][:-4]) / self.DEPTH_FACTOR)
                # the reference reads these in OpenCV's BGR order and keeps it
                bgr = imread_color(name)[..., ::-1]
                focused.append(resize_hw(bgr.astype(np.float32) / 255.0,
                                         self.resize))
            stack = np.stack(focused, axis=-1)
            if self.train:
                stack, depth = auto_augment(stack, depth)
            stack = np.transpose(stack, (3, 2, 0, 1)).astype(np.float32)  # [S,C,H,W]
            return [stack, depth[None].astype(np.float32),
                    np.asarray(fdists, np.float32)]
        aif = imread_color(f"{d}/{scene}/AiF.png") / 255.0
        if self.train:
            aif, depth = auto_augment(aif, depth)
        aif = resize_hw(aif.astype(np.float32), self.resize)
        depth = resize_hw(depth.astype(np.float32), self.resize)
        return [_to_chw(aif), depth[None].astype(np.float32)]


class Middlebury(Dataset):
    """Middlebury2014/2021 eval set (reference dff/dataset.py:173-205), and
    the SynthMiddlebury sets in the same layout: <scene>/im0.png (RGB) and
    <scene>/depth.png (uint16, mm).

    `train=True` applies the shared augmentation policy, as in the JAX
    package; the default `train=False` is the reference's eval behaviour.
    """

    def __init__(self, dataset_dir, resize=None, train=False):
        self.dataset_dir = dataset_dir
        self.scenes = sorted(s.split("/")[-1] for s in glob(f"{dataset_dir}/*"))
        self.resize = resize
        self.train = train

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, index):
        d, scene = self.dataset_dir, self.scenes[index]
        aif = imread_color(f"{d}/{scene}/im0.png") / 255.0
        depth = resize_hw(read_png(f"{d}/{scene}/depth.png") / 1000, self.resize)
        if self.train:
            aif, depth = auto_augment(aif, depth)
        aif = resize_hw(aif.astype(np.float32), self.resize)
        return [_to_chw(aif), depth[None].astype(np.float32)]


class RealWorld(Dataset):
    """Captured focal stacks, focus distance parsed from filenames
    (reference dff/dataset.py:208-246)."""

    def __init__(self, dataset_dir, resize=None, depth=False):
        self.dataset_dir = dataset_dir
        self.scenes = sorted(s.split("/")[-1] for s in glob(f"{dataset_dir}/*"))
        self.resize = resize
        self.depth = depth

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, index):
        d, scene = self.dataset_dir, self.scenes[index]
        focused, fdists = [], []
        stack_files = (
            sorted(glob(f"{d}/{scene}/align/*.png"))
            + sorted(glob(f"{d}/{scene}/*.JPG"))
            + sorted(glob(f"{d}/{scene}/*.png"))
        )
        for name in stack_files:
            fdists.append(float(name.split("/")[-1].split("_")[1][4:]) / 1000)
            # the reference reads these in OpenCV's BGR order and keeps it
            bgr = imread_color(name)[..., ::-1]
            focused.append(resize_hw(bgr.astype(np.float32) / 255.0, self.resize))
        stack = np.transpose(np.stack(focused, axis=-1), (3, 2, 0, 1)).astype(np.float32)
        if self.depth:
            # OpenCV resizes the uint16 map and rounds to integers; so does
            # this, from float64 sums (one unit apart where a sum is a tie)
            depth = np.rint(resize_hw(read_png(f"{d}/{scene}/depth/depth.png")
                                      .astype(np.float64), self.resize))
            depth = (depth / 65535 * 3000 + 500) / 1000
            depth = depth[None].astype(np.float32)
        else:
            depth = np.zeros_like(stack[0, 0][None])
        return [stack, depth, np.asarray(fdists, np.float32)]


# ================================
# Loader
# ================================
class NumpyLoader:
    """Batching iterator with optional shuffling and background prefetch.

    The order of a shuffled epoch is `np.random.default_rng(seed).shuffle`
    of the indices, as in the JAX package; a worker's exception is raised
    in the consuming loop."""

    def __init__(self, dataset, batch_size=1, shuffle=False, prefetch=2, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            items = [self.dataset[int(i)]
                     for i in idx[b * self.batch_size : (b + 1) * self.batch_size]]
            yield [np.stack([it[k] for it in items]) for k in range(len(items[0]))]

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def worker():
            # a failed __getitem__ (a corrupt or missing file) is handed to
            # the consumer, so it raises in the loop instead of silently
            # ending the epoch early
            try:
                for batch in self._batches():
                    q.put(batch)
                q.put(done)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
