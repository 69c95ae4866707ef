"""Multi-process meshes on ``torch.distributed``: the cross-host story.

The port of ``ceph_tpu/parallel/multihost.py``. N coordinated processes
(``torch.distributed`` ranks on the ``gloo`` backend, rendezvous at
``tcp://<coordinator>``), each with ``--local-devices`` mesh slots of its
own, form one global mesh whose rank boundary stands for the hosts'
network. Two pipelines run over it:

- EC encode with the stripe batch split over the ranks, and each rank's
  part over its own slots: no bytes cross ranks on the hot path, which
  is why EC striping scales out. Each rank's checksum of its parity is a
  sum wrapped to 32 bits; one all-reduce of the checksums gives the
  checksum of a local encode of the whole batch.
- the aggregated CRUSH sweep over a 1-D mesh of every rank's slots: its
  one all-reduce of the (max_devices,) counts and ``bad`` is the whole
  communication cost of scaling placement.

Both are checked equal to the local single-process computation, and the
worker raises when they differ. Gloo serves even on the card: NCCL
refuses two ranks on one GPU, and the one reduction is a small vector.

Run one worker per rank (the test spawns two):

    python -m ceph_tpu_torch.parallel.multihost --coordinator 127.0.0.1:PORT \\
        --num-processes 2 --process-id {0,1} [--device cpu]

Each runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys

M32 = 0xFFFFFFFF
RENDEZVOUS_S = 120          # a rank that never shows up fails the others


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def run_worker(coordinator: str, num_processes: int, process_id: int,
               local_devices: int = 4, device=None) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.crush.mapper import Mapper
    from ceph_tpu_torch.ec import matrix as rs
    from ceph_tpu_torch.gf import kernels, tables
    from ceph_tpu_torch.parallel import (Mesh, local_mesh, sharded_crush_sweep,
                                         sharded_encode)
    from ceph_tpu_torch.utils import device as devsel

    dev = devsel.resolve(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    try:
        local = local_mesh(local_devices, device=dev)

        # --- EC over the rank axis: each rank encodes its slice ---------
        k, m, C, batch = 4, 2, 4096, 8 * num_processes
        coding = rs.coding_matrix("reed_sol_van", k, m)
        bitmatrix = tables.expand_bitmatrix(coding)
        lo, hi = tables.nibble_tables(coding)
        rng = np.random.default_rng(7)           # same stream on all ranks
        data = rng.integers(0, 256, size=(batch, k, C), dtype=np.uint8)
        per = batch // num_processes
        parity = sharded_encode(local, bitmatrix, lo, hi,
                                data[process_id * per:(process_id + 1) * per])
        # every part stays on its slot, and together they are this rank's
        # slice of the batch
        _require(sum(p.shape[0] for p in parity) == per and
                 all(p.device == d for p, (_, d) in
                     zip(parity, local.slots())),
                 f"rank {process_id}: parity parts "
                 f"{[(tuple(p.shape), str(p.device)) for p in parity]}")
        mine = sum(int(p.to(torch.int64).sum()) for p in parity) & M32
        total = torch.tensor([mine], dtype=torch.int64)
        dist.all_reduce(total)
        checksum = int(total) & M32
        whole = kernels.gf_encode(torch.as_tensor(bitmatrix, device=dev),
                                  torch.as_tensor(data, device=dev))
        _require(checksum == int(whole.to(torch.int64).sum()) & M32,
                 "cross-rank EC checksum differs from a local encode")

        # --- CRUSH over every rank's slots ------------------------------
        slots = list(local.devices.reshape(-1))
        mesh = Mesh(slots * num_processes,
                    ranks=np.repeat(np.arange(num_processes), len(slots)))
        cm, root = builder.build_hierarchy(8, 8, n_racks=2)
        rid = builder.add_simple_rule(cm, root, builder.TYPE_HOST)
        n_pgs = 256 * mesh.size
        counts, bad = sharded_crush_sweep(
            mesh, Mapper(cm, block=1 << 9, device=dev), rid, 0, n_pgs, 3)
        got = counts.cpu()
        # the local single-process sweep on a fresh Mapper
        ref_counts, ref_bad = Mapper(cm, block=1 << 9, device=dev).sweep(
            rid, 0, n_pgs, 3)
        _require(torch.equal(got, ref_counts.cpu()),
                 "cross-rank CRUSH counts differ from the local sweep")
        _require(int(bad) == int(ref_bad) and int(got.sum()) == 3 * n_pgs,
                 f"cross-rank CRUSH bad {int(bad)} vs {int(ref_bad)}, "
                 f"placements {int(got.sum())}")
        return {"ok": True, "process_id": process_id,
                "processes": dist.get_world_size(),
                "global_devices": mesh.size,
                "local_devices": local_devices,
                "ec_checksum": checksum,
                "crush_placements": int(got.sum())}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multihost")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run_worker(args.coordinator, args.num_processes,
                     args.process_id, args.local_devices, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
