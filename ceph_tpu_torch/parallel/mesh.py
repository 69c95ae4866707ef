"""Device meshes: ordered slots of devices with named axes.

The port of ``ceph_tpu/parallel/mesh.py``. A ``Mesh`` is what the
sharded pipelines split their batch over:

- ``shard``: the data-parallel axis: stripes for EC, PG-id blocks for
  CRUSH. Ceph's "every PG / every stripe is independent" parallelism
  (SURVEY.md §2.5) lands on the cards as a batch split over the slots.

A slot is one shard of the work, and its device is where that shard
runs. Slots may repeat a device: eight slots on the CPU, or four on one
card, run the sharded code paths exactly as eight or four cards would
(the counterpart of the ``--xla_force_host_platform_device_count`` that
gives JAX virtual CPU devices). Work for slots that share a device runs
one slot after another on it.

A mesh may span processes (``parallel.multihost``): each slot then
names the ``torch.distributed`` rank that runs it, and a process runs
only its own slots.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.utils import device as devsel


def _canonical(dev) -> torch.device:
    """A device with its index: ``cuda`` is the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Slots of devices laid out on named axes.

    ``devices`` is an object array of ``torch.device`` in the mesh's
    shape (``mesh.devices.size`` slots); ``ranks`` gives the process that
    runs each slot (all 0 in one process)."""

    def __init__(self, devices, axis_names=("shard",), ranks=None):
        devs = np.asarray(devices, dtype=object)
        flat = np.empty(devs.size, dtype=object)
        flat[:] = [_canonical(d) for d in devs.reshape(-1)]
        self.devices = flat.reshape(devs.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.ranks = np.zeros(self.devices.shape, dtype=np.int64) \
            if ranks is None else \
            np.asarray(ranks, dtype=np.int64).reshape(self.devices.shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_count(self) -> int:
        return len(set(self.ranks.reshape(-1).tolist()))

    def slots(self) -> list[tuple[int, torch.device]]:
        """(slot index, device) of every slot this process runs, in slot
        order: all of them in one process; in a mesh that spans
        processes, those of this ``torch.distributed`` rank."""
        flat = list(self.devices.reshape(-1))
        if self.process_count == 1:
            return list(enumerate(flat))
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("a mesh that spans processes needs "
                               "torch.distributed initialised")
        me = dist.get_rank()
        return [(i, d) for i, (d, r) in
                enumerate(zip(flat, self.ranks.reshape(-1))) if r == me]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(devices=None, axes: tuple[str, ...] = ("shard",),
              shape: tuple[int, ...] | None = None) -> Mesh:
    """Build a Mesh over ``devices`` (default: every visible card) with
    named ``axes``; ``shape`` defaults to every slot on the first axis."""
    if devices is None:
        devsel.resolve(None)             # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axes)


def local_mesh(n: int | None = None, device=None) -> Mesh:
    """A 1-D ('shard',) mesh of ``n`` slots: spread over the visible
    cards in turn (default: one slot a card), or all on the CPU when
    ``device="cpu"`` (default: one slot)."""
    dev = devsel.resolve(device)
    if dev.type == "cpu":
        return make_mesh([dev] * (n or 1))
    cards = torch.cuda.device_count()
    if dev.index is not None:
        return make_mesh([dev] * (n or 1))
    return make_mesh([torch.device("cuda", i % cards)
                      for i in range(n or cards)])
