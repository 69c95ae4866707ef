"""Sharded EC pipelines: stripe batches split over the device mesh.

The port of ``ceph_tpu/parallel/sharded.py``. The EC analog of the
reference's primary->shard fan-out (ref: src/osd/ECBackend.cc
handle_sub_write fan-out over MOSDECSubOpWrite): instead of sending k+m
sub-ops over a messenger, the stripe batch is split over the mesh's
slots and every slot encodes its stripes on its own device, with no
communication on the hot path.

Each slot's part goes through ``gf.ops.encode_stripes`` with the encode
kernel (``backend="kernel"``: ``gf.kernels.gf_encode``). The output
stays on the slots that computed it, one tensor a slot, as JAX's stays
sharded; ``gather`` brings the parts to one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.gf import ops


def shard_batch(mesh, data) -> tuple[torch.Tensor, ...]:
    """Split ``data`` (batch, ...) along the batch over this process's
    slots (``torch.tensor_split``: the first parts take one more row when
    the batch does not divide), each part on its slot's device."""
    t = data if isinstance(data, torch.Tensor) else \
        torch.as_tensor(np.ascontiguousarray(data))
    slots = mesh.slots()
    return tuple(part.to(dev).contiguous() for part, (_, dev) in
                 zip(torch.tensor_split(t, len(slots)), slots))


def gather(parts, device=None) -> torch.Tensor:
    """The per-slot parts of a sharded result as one tensor on
    ``device`` (default: the first part's)."""
    device = parts[0].device if device is None else device
    return torch.cat([p.to(device) for p in parts])


def sharded_encode(mesh, bitmatrix, lo, hi, data,
                   backend: str = "kernel") -> tuple[torch.Tensor, ...]:
    """Encode (batch, k, C) with the batch split over the mesh's slots ->
    one (part, m, C) uint8 tensor per slot, on that slot's device.

    ``data`` is one tensor (or array), which ``shard_batch`` splits, or
    already one part per slot, each on its slot's device. The small
    matrix and table operands are copied once to each device."""
    parts = tuple(data) if isinstance(data, (tuple, list)) else \
        shard_batch(mesh, data)
    if len(parts) != len(mesh.slots()):
        raise ValueError(f"{len(parts)} parts for {len(mesh.slots())} "
                         f"slots")
    operands = {}
    out = []
    for part in parts:
        dev = part.device
        if dev not in operands:
            operands[dev] = tuple(torch.as_tensor(a).to(dev).contiguous()
                                  for a in (bitmatrix, lo, hi))
        out.append(ops.encode_stripes(*operands[dev], part,
                                      backend=backend))
    return tuple(out)


# Reconstruction is the same sharded matrix application with a
# per-erasure-pattern decode matrix: chunks (batch, n_avail, C) ->
# (batch, n_want, C). Recovery reads in the reference gather k surviving
# shards to the primary (ref: src/osd/ECCommon.cc ReadPipeline); here the
# stripe batch is already on the slots' devices, so reconstruction needs
# no communication.
sharded_decode = sharded_encode


def sharded_crush_sweep(mesh, mapper, ruleno: int, start_x: int,
                        n: int, result_max: int):
    """Aggregated CRUSH sweep with the PG range sharded over the mesh.

    The strict contract of the reference's first version: ``n`` must
    divide by the slot count. ``crush.sharded_sweep.sharded_sweep`` (or
    ``Mapper(mesh=...)``) takes any ``n``."""
    if n % mesh.size:
        raise ValueError(f"n={n} must divide by {mesh.size} devices")
    from ceph_tpu_torch.crush.sharded_sweep import sharded_sweep
    return sharded_sweep(mesh, mapper, ruleno, start_x, n, result_max)
