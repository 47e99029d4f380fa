"""Data parallelism over `torch.distributed` ranks (the port of
`aadff_tpu/parallel/mesh.py`).

The JAX package shards each batch over a device mesh and replicates the
parameters; under `jit`, XLA computes every reduction of the step over the
global batch, so one device and N devices give the same numbers
(PARITY.md:62-72).  Here each rank is a process that holds a copy of the
parameters and its own rows of each global batch.  The reductions that must
see the whole batch call the functions below: BatchNorm's statistics
(`models/layers.py`), the masked means of the losses (`models/aifnet.py`,
`models/dfv/dffnet.py`), the gradient mean and the non-finite guard
(`train/trainer.py:guarded_step`), and the train loops' NaN-depth skip.

`setup` joins the process group that the launcher describes
(`python -m torch.distributed.run --nproc_per_node N ...` sets RANK,
WORLD_SIZE, LOCAL_RANK and the rendezvous address) and makes it the active
mesh; the backend is the caller's: NCCL on the card, gloo on the CPU, or
gloo on one card shared by the ranks.  Nothing falls back to another
backend or device.  Every collective names the active mesh's group.  With
no active mesh, or a world of 1, every function here is the identity and
the one-device path runs as it did without this module.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Mesh:
    """The ranks of one data-parallel run: the process group, this
    process's rank, the world size and the device its tensors live on."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


_active: Mesh | None = None


def active() -> Mesh | None:
    return _active


def size() -> int:
    return 1 if _active is None else _active.size


def rank() -> int:
    return 0 if _active is None else _active.rank


def distributed() -> bool:
    """Whether reductions must span more than this process."""
    return size() > 1


def launched() -> bool:
    """Whether a launcher started this process as one rank of a group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def setup(backend: str, device="cuda", *, rank: int | None = None,
          world_size: int | None = None, init_method: str = "env://",
          timeout_s: float = 600.0) -> Mesh:
    """Join a process group and make it the active mesh.

    `rank` and `world_size` default to the launcher's RANK and WORLD_SIZE,
    and a CUDA device without an index to cuda:LOCAL_RANK.  NCCL needs a
    CUDA device; gloo takes either (its collectives copy CUDA tensors
    through the host).  `timeout_s` bounds every collective, so a rank that
    never arrives fails the others instead of hanging them."""
    global _active
    if _active is not None:
        raise RuntimeError("a mesh is already active; call teardown() first")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"backend {backend} on {device} was asked for "
                               f"but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    _active = Mesh(dist.group.WORLD, rank, world_size, device, backend)
    return _active


def setup_from_launcher(device="cuda", backend: str | None = None) -> Mesh | None:
    """The mesh a launcher describes, or None in a process started without
    one.  `backend` defaults to NCCL on a CUDA device and gloo on the CPU."""
    if not launched():
        return None
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    return setup(backend, device)


def teardown():
    """Leave the active mesh's process group."""
    global _active
    if _active is not None:
        dist.destroy_process_group()
        _active = None


def check_batch(batch_size: int):
    """Refuse a world larger than the global batch, or one that does not
    divide it.  JAX's loops take a mesh of min(devices, bs) devices
    (`aadff_tpu/train/dff_aif.py:48`) and leave the other devices idle; a
    launcher starts every rank it counts, and an idle rank would wait at
    every collective of the others."""
    n = size()
    if n > batch_size or batch_size % n:
        raise ValueError(
            f"{n} ranks cannot split a batch of {batch_size}: launch at most "
            f"bs ranks, and a number that divides bs")


def _tensor_device() -> torch.device:
    """Where a collective's tensors must live: NCCL reduces on the card,
    gloo on the CPU or the card."""
    return _active.device if _active.backend == "nccl" else torch.device("cpu")


def shard_batch(*arrays):
    """This rank's contiguous rows of dim 0 of each global-batch array
    (numpy or torch), as `data_sharding` splits a batch over the mesh: rank
    r of n holds rows [r * B / n, (r + 1) * B / n).  A batch the ranks do
    not divide is refused."""
    n, r = size(), rank()
    out = []
    for a in arrays:
        rows = a.shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} ranks")
        k = rows // n
        out.append(a[r * k:(r + 1) * k])
    return out


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def replicate(module: torch.nn.Module):
    """Overwrite `module`'s parameters and buffers with rank 0's, in place,
    in one broadcast of a flat buffer (the parameters are float32)."""
    if not distributed():
        return module
    tensors = [*module.parameters(), *module.buffers()]
    with torch.no_grad():
        flat = _flat(tensors)
        dist.broadcast(flat, src=0, group=_active.group)
        for t, v in zip(tensors, _unflat(flat, tensors)):
            t.copy_(v)
    return module


def mean_over_ranks(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor (all of one dtype), from one
    all-reduce of a flat buffer; every rank gets the same values."""
    if not distributed():
        return list(tensors)
    flat = _flat([t.detach() for t in tensors])
    dist.all_reduce(flat, group=_active.group)
    flat.div_(_active.size)
    return _unflat(flat, tensors)


class _SumOverRanks(torch.autograd.Function):
    """The sum of x over the ranks.  Each rank's objective is its share of
    the global one, and the sum feeds every rank's objective, so the
    gradient of x on a rank is the sum over the ranks of the gradients
    that reach the sum: its backward all-reduces them.  With `saved` (a
    recomputation, `models/layers.py:checkpoint`) the forward returns the
    sum saved from the first pass and communicates nothing."""

    @staticmethod
    def forward(ctx, x, group, saved):
        ctx.group = group
        if saved is not None:
            return saved.clone()
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


def sum_over_ranks(x: torch.Tensor, saved: torch.Tensor | None = None):
    """x summed over the ranks, differentiable (see `_SumOverRanks`)."""
    if not distributed():
        return x
    return _SumOverRanks.apply(x, _active.group, saved)


def gather_rows(x: torch.Tensor, saved: torch.Tensor | None = None):
    """x of every rank stacked in rank order, [size, *x.shape],
    differentiable: the sum over the ranks of a stack that holds x in this
    rank's row and zeros elsewhere (see `_SumOverRanks` for `saved`)."""
    if not distributed():
        return x[None]
    rows = x.new_zeros((_active.size, *x.shape))
    rows[_active.rank] = x
    return _SumOverRanks.apply(rows, _active.group, saved)


def global_sums(*values: torch.Tensor) -> list[torch.Tensor]:
    """0-d tensors summed over the ranks in one differentiable all-reduce."""
    if not distributed():
        return list(values)
    return list(sum_over_ranks(torch.stack(values)).unbind())


def any_over_ranks(flag: bool) -> bool:
    """Whether `flag` holds on any rank (a decision every rank then takes
    together)."""
    if not distributed():
        return bool(flag)
    t = torch.tensor([float(flag)], device=_tensor_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_active.group)
    return bool(t.item())


def broadcast_object(obj):
    """Rank 0's `obj` (picklable) on every rank."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_active.group,
                               device=_tensor_device())
    return box[0]


def barrier():
    """Wait until every rank arrives."""
    if not distributed():
        return
    if _active.backend == "nccl":
        dist.barrier(group=_active.group, device_ids=[_active.device.index])
    else:
        dist.barrier(group=_active.group)
