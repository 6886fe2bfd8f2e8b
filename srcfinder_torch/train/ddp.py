"""Data-parallel training over several devices.

The JAX package trains data-parallel by putting the same jitted step on a
batch-sharded mesh (``TrainConfig(devices=N)``, train/train.py:179-195):
GSPMD inserts the gradient and BatchNorm reductions, so the step computes
the global batch's math. The port runs N processes, one rank per device,
under ``torch.distributed``:

- NCCL when every rank has a card of its own; gloo on the CPU and when
  ranks share a card (NCCL refuses two ranks on one device);
- the rendezvous is a file in the run's own directory (``file://``), so
  runs on one host never share one;
- every rank builds the same global batch with the same shuffle and takes
  its contiguous rows ``[r·B/N, (r+1)·B/N)`` (the JAX package's
  ``batch_sharding``, ``P("data")``); a batch that N does not divide runs
  whole on every rank, as the JAX step runs it replicated
  (:func:`shard_batch`);
- the model is wrapped in ``DistributedDataParallel`` with
  ``broadcast_buffers=False``: the running statistics are equal on every
  rank by construction (the global batch's, :mod:`.sam`), and a rank-0
  rebroadcast at each of SAM's two forwards would be wrong.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..device import resolve_device
from ..parallel.mesh import make_mesh

__all__ = ["rank_devices", "backend_for", "spawn", "wrap", "shard_batch"]


def rank_devices(device, world: int) -> list:
    """The device of each of ``world`` ranks: ``"cuda"`` gives each rank a
    card of its own (raises with fewer than ``world`` cards), a device
    with an index (``"cuda:0"``) or ``"cpu"`` puts every rank on it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(world, "cuda")
    return [resolve_device(dev)] * world


def backend_for(devices) -> str:
    """NCCL when the ranks hold distinct cards, else gloo."""
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def _entry(rank, fn, devices, backend, init_method, args):
    world = len(devices)
    dev = resolve_device(devices[rank])          # TF32 off, as on one card
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # NCCL binds each rank's communicator to its card
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **({"device_id": dev} if backend == "nccl" else {}))
    try:
        fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device, rendezvous: str, args=()) -> str:
    """Run ``fn(rank, world, device, *args)`` in ``world`` processes
    (``torch.multiprocessing.spawn``), one per device of
    :func:`rank_devices`, each in the process group of
    :func:`backend_for`, which meets at the file ``rendezvous`` (it must
    not exist; it is removed after). ``fn`` and ``args`` must pickle.
    Returns the backend's name; raises if any rank failed."""
    import torch.multiprocessing as mp

    devices = rank_devices(device, world)
    backend = backend_for(devices)
    if os.path.exists(rendezvous):
        raise FileExistsError(f"rendezvous file {rendezvous} exists")
    try:
        mp.spawn(_entry, args=(fn, [str(d) for d in devices], backend,
                               "file://" + os.path.abspath(rendezvous), tuple(args)),
                 nprocs=world, join=True)
    finally:
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
    return backend


def wrap(model, device) -> DistributedDataParallel:
    """``model`` (on ``device``) in ``DistributedDataParallel`` with
    ``broadcast_buffers=False``; its parameters and buffers start as rank
    0's."""
    ids = [device] if device.type == "cuda" else None
    with warnings.catch_warnings():
        # newer torch marks broadcast_buffers deprecated and keeps its
        # meaning: parameters and buffers synced at construction only
        warnings.simplefilter("ignore", FutureWarning)
        return DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False)


def shard_batch(images, labels, rank: int, world: int):
    """This rank's rows of a global batch: ``(images, labels, group)``.
    Where ``world`` divides the batch, rows ``[rank·B/world,
    (rank+1)·B/world)`` and the default process group, over which the step
    reduces; else the whole batch and None (replicated)."""
    n = len(images)
    if n % world:
        return images, labels, None
    lo, hi = rank * n // world, (rank + 1) * n // world
    return images[lo:hi], labels[lo:hi], dist.group.WORLD
