"""Pod-scale CRUSH: the mapping sweep sharded over a device mesh.

The port of ``ceph_tpu/crush/sharded_sweep.py``. The single-device
engine (``mapper.Mapper``) streams PG blocks through one device; here
the PG-id batch is the data-parallel axis of a ``parallel.Mesh`` and
every slot maps its own share, with

- **replicated map tensors**: the packed CRUSH arrays and the kernel's
  plan (a few MiB even at 10k OSDs) lie whole on every device the mesh
  names. The Mapper copies them to a device at its first use there and
  keeps the copy, so slots that share a device share one copy. The map
  is the only shared state of CRUSH (SURVEY.md §5.8), and replicating it
  is what keeps the hot path free of collectives;
- **per-shard ranges**: each slot derives its own PG-id range from its
  index, ``start_x + slot * local_n`` wrapped to 32 bits, so nothing of
  O(n_pgs) is materialised in one place;
- **no collective on the hot path**: mapping is independent per PG, so
  the only communication of the aggregated sweep is one reduction of
  the ``(max_devices,)`` placement counts and ``bad`` at the end, onto
  the mesh's first device and, for a mesh that spans processes, one
  ``torch.distributed`` all-reduce (``sharded_map_pgs`` has none: each
  shard's rows are copied to the Mapper's device).

Both entry points serve the engine the single-device path would use:
the ``crush_straw2`` kernel with its flagged lanes recomputed by the rule
VM when the rule is eligible, the rule VM otherwise. So the sharded
result equals ``Mapper.map_pgs``/``Mapper.sweep`` lane for lane, the
flagged lanes included (tests/test_torch_sharded_sweep.py pins it across
shard boundaries, non-divisible batches, zero-weight slots and
choose_args weight-sets). Tiles advance in rounds: each round queues one
tile on every slot before it reads any tile's flags back, so slots on
different cards run together.

Non-divisible batches: every slot gets the same (ceil) share.
``sharded_map_pgs`` pads the PG-id batch with lane ``xs[0]`` up to a
multiple of the slot count and strips the padding; ``sharded_sweep``
leaves the lanes past ``n`` out of every slot's tiles, so they count
nowhere. (The reference also rounds each slot's share up to a power of
two below one tile, to bound XLA's compiled shapes; a CUDA kernel has no
per-shape build, so the port does not.)

Wiring: ``Mapper(mesh=...)`` (or ``Mapper.attach_mesh``) routes
``sweep``/``map_pgs`` batches of at least ``mesh_min_batch`` lanes
through this module; ``osd/osdmap_mapping.py`` full-pool sweeps reuse it
when a mesh is attached to the mapping (the ``remap_sharded_sweeps``
perf counter records each one).
"""

from __future__ import annotations

import torch

from ceph_tpu_torch.crush.hash import M32
from ceph_tpu_torch.crush.types import ITEM_NONE

# Below this many lanes a split costs more than it saves; Mapper
# delegation and OSDMapMapping full sweeps stay on one device for smaller
# batches. Overridable per Mapper (mesh_min_batch): tests lower it to
# drive the sharded path on small pools.
MESH_MIN_BATCH = 1 << 16


def _refuse_legacy(mapper, ruleno: int, entry: str) -> None:
    from ceph_tpu_torch.crush.mapper import _scalar_reason_of
    reason = _scalar_reason_of(mapper.map, mapper._steps(ruleno))
    if reason:
        raise ValueError(
            f"map uses legacy tunables ({reason}); the scalar fallback "
            f"cannot shard — use Mapper.{entry}")


def sharded_map_pgs(mesh, mapper, ruleno: int, xs,
                    result_max: int) -> torch.Tensor:
    """Vectorized crush_do_rule over ``xs`` with the batch sharded over
    the mesh -> (N, result_max) int32 on the Mapper's device, equal to
    ``Mapper.map_pgs`` lane for lane.

    ``xs`` may be any length: the batch pads up to a multiple of the slot
    count (pad lanes recompute lane xs[0]; their rows are stripped before
    return). The mesh must lie in this process."""
    _refuse_legacy(mapper, ruleno, "map_pgs")
    if mesh.process_count > 1:
        raise ValueError("sharded_map_pgs needs a mesh of one process; "
                         "sharded_sweep serves a mesh that spans processes")
    from ceph_tpu_torch.crush.mapper import _seeds
    x = _seeds(xs, mapper.device)
    n = x.shape[0]
    if n == 0:
        return torch.full((0, result_max), ITEM_NONE, dtype=torch.int32,
                          device=mapper.device)
    slots = mesh.slots()
    local_n = -(-n // len(slots))
    pad = local_n * len(slots) - n
    if pad:
        x = torch.cat([x, x[:1].expand(pad)])
    path = mapper.mapping_path(ruleno, result_max)
    block = min(mapper.effective_block(ruleno, result_max), local_n)
    shard_x = [x[me * local_n:(me + 1) * local_n].to(dev)
               for me, (_, dev) in enumerate(slots)]
    rows = [[] for _ in slots]
    for lo in range(0, local_n, block):
        got = mapper._map_round(ruleno, [sx[lo:lo + block] for sx in shard_x],
                                result_max, path, "crush_sharded_map")
        for r, g in zip(rows, got):
            r.append(g)
    out = torch.cat([torch.cat(r).to(mapper.device) for r in rows])
    mapper.last_map_path = path + "+sharded"
    return out[:n].to(torch.int32)


def sharded_sweep(mesh, mapper, ruleno: int, start_x: int, n: int,
                  result_max: int):
    """Aggregated CRUSH sweep of [start_x, start_x + n) with the PG range
    sharded over the mesh: the multi-device ``Mapper.sweep``.

    Any ``n`` is accepted. Returns (counts int64 (max_devices,), bad int64
    scalar) on the first device of this process's slots, equal to the
    single-device sweep's; a mesh that spans processes returns every
    process's totals to each."""
    _refuse_legacy(mapper, ruleno, "sweep")
    from ceph_tpu_torch.crush.mapper import tally
    nd = mapper.packed.max_devices
    local_n = max(1, -(-n // mesh.size))
    path = mapper.mapping_path(ruleno, result_max)
    block = min(mapper.effective_block(ruleno, result_max), local_n)
    firstn = mapper.rule_is_firstn(ruleno)
    slots = mesh.slots()
    # (device, base seed, live lanes) per slot: the ceil split leaves the
    # last slots short when n does not divide
    shards = [(dev, (start_x + me * local_n) & M32,
               max(0, min(local_n, n - me * local_n))) for me, dev in slots]
    # one accumulator per device: slots that share a device share it
    acc = {}
    for dev, _, _ in shards:
        if dev not in acc:
            acc[dev] = (torch.zeros(nd + 1, dtype=torch.int64, device=dev),
                        torch.zeros((), dtype=torch.int64, device=dev))
    for lo in range(0, local_n, block):
        live = [(dev, base, min(block, rem - lo))
                for dev, base, rem in shards if rem > lo]
        if not live:
            break
        xs = [(torch.arange(lo, lo + w, dtype=torch.int64, device=dev)
               + base) & M32 for dev, base, w in live]
        got = mapper._map_round(ruleno, xs, result_max, path,
                                "crush_sharded_sweep")
        for (dev, _, _), w in zip(live, got):
            tally(*acc[dev], w, nd, result_max, firstn)
    # the one reduction: every device's counts onto the first device...
    first = slots[0][1]
    counts = sum(c.to(first) for c, _ in acc.values())
    bad = sum(b.to(first) for _, b in acc.values())
    if mesh.process_count > 1:
        # ...and across processes, one all-reduce of counts and bad
        import torch.distributed as dist
        both = torch.cat([counts, bad[None]]).cpu()
        dist.all_reduce(both)
        both = both.to(first)
        counts, bad = both[:nd + 1], both[nd + 1]
    mapper.last_map_path = path + "+sharded"
    return counts[:nd], bad
