"""Device-scaling table: EC encode + CRUSH sweep at 1..N mesh slots.

The port of ``ceph_tpu/bench/multichip.py``. Each row runs the sharded
EC encode (``parallel.sharded_encode``) and the aggregated CRUSH sweep
(``parallel.sharded_crush_sweep``) over a mesh of 1, 2, 4, ... slots up
to ``--max-devices`` (default: one slot a visible card), and the last
record is one measured full sweep of ``--crush-pgs`` PGs over all of
them (``crush_multichip``):

    python -m ceph_tpu_torch.bench.multichip --crush-pgs 100000000 \\
        --num-osds 10240

Slots are spread over the visible cards in turn, so with more slots than
cards some share a card: such rows show the sharded structure (the EC
path has no communication; the CRUSH sweep's only one is the final
reduction of a (max_devices,) vector), not a speed-up. Runs on the card
unless ``--device cpu``; times are host-clock seconds of work that ends
in a read-back.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ceph_tpu_torch.utils import device as devsel


def _sync(mesh) -> None:
    for dev in {d for _, d in mesh.slots()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def ec_rate(mesh, n_devices: int, batch: int, C: int) -> float:
    """Bytes of data per second through ``sharded_encode``, k=8 m=3
    ``reed_sol_van``, best of three runs after one warm-up."""
    from ceph_tpu_torch.ec import matrix as rs
    from ceph_tpu_torch.gf import tables
    from ceph_tpu_torch.parallel import sharded_encode
    from ceph_tpu_torch.parallel.sharded import shard_batch

    k, m = 8, 3
    coding = rs.coding_matrix("reed_sol_van", k, m)
    bitmatrix = tables.expand_bitmatrix(coding)
    lo, hi = tables.nibble_tables(coding)
    rng = np.random.default_rng(0)
    data = shard_batch(mesh, rng.integers(0, 256, (batch, k, C), np.uint8))
    sharded_encode(mesh, bitmatrix, lo, hi, data)
    _sync(mesh)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sharded_encode(mesh, bitmatrix, lo, hi, data)
        _sync(mesh)
        best = min(best, time.perf_counter() - t0)
    return batch * k * C / best


def measured_sweep(mesh, mapper, n_pgs: int, num_rep: int = 3,
                   rule: int = 0, reps: int = 2) -> dict:
    """The crush_multichip record: wall time of ONE full aggregated
    sharded sweep of ``n_pgs``, anchored by reading the counts back.

    ``measured: true`` means the wall covers a real run of every PG in
    ``n_pgs`` on this mesh, not a slope between two sizes and not a
    one-device rate times the slot count. Below 100M PGs,
    ``seconds_100M`` is the measured wall rescaled and ``extrapolated``
    is true; at 100M it is the measured wall itself."""
    from ceph_tpu_torch.crush.sharded_sweep import sharded_sweep

    counts, bad = sharded_sweep(mesh, mapper, rule, 0, n_pgs, num_rep)
    counts.cpu()                                    # warm
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        counts, bad = sharded_sweep(mesh, mapper, rule, 0, n_pgs, num_rep)
        host = counts.cpu()                         # D2H anchor
        best = min(best, time.perf_counter() - t0)
    return {
        "metric": "crush_multichip",
        "measured": True,
        "n_devices": mesh.size,
        "n_pgs": int(n_pgs),
        "num_rep": num_rep,
        "n_osds": int(mapper.packed.max_devices),
        "seconds_wall": round(best, 3),
        "mappings_per_s": round(n_pgs / best, 1),
        "seconds_100M": round(best * (1e8 / n_pgs), 3),
        "extrapolated": bool(n_pgs < 100_000_000),
        "bad_mappings": int(bad),
        "placements": int(host.sum()),
        "path": mapper.last_map_path,
        "platform": devsel.describe(mesh.slots()[0][1])[0],
    }


def crush_rate(mesh, mapper, n_pgs: int) -> float:
    """PGs per second through ``sharded_crush_sweep`` (rule 0, three
    replicas), best of two runs after one warm-up."""
    from ceph_tpu_torch.parallel import sharded_crush_sweep

    counts, _ = sharded_crush_sweep(mesh, mapper, 0, 0, n_pgs, 3)
    counts.cpu()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        counts, _ = sharded_crush_sweep(mesh, mapper, 0, 0, n_pgs, 3)
        counts.cpu()
        best = min(best, time.perf_counter() - t0)
    return n_pgs / best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="multichip_bench")
    ap.add_argument("--max-devices", type=int, default=0,
                    help="mesh slots; 0 = one a visible card (one on "
                         "the CPU)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=64 << 10)
    ap.add_argument("--crush-pgs", type=int, default=1 << 15)
    ap.add_argument("--num-osds", type=int, default=1024,
                    help="OSDs of the canonical CRUSH map")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ceph_tpu_torch.bench.crush_sweep import canonical_map
    from ceph_tpu_torch.crush.mapper import Mapper
    from ceph_tpu_torch.parallel import local_mesh

    dev = devsel.resolve(args.device)
    maxd = args.max_devices or local_mesh(device=dev).size
    mapper = Mapper(canonical_map(args.num_osds), device=dev)
    rows = []
    sizes = []
    d = 1
    while d < maxd:
        sizes.append(d)
        d *= 2
    sizes.append(maxd)          # always include the full slot count
    for d in sizes:
        mesh = local_mesh(d, device=dev)
        ec = ec_rate(mesh, d, args.batch, args.chunk)
        n_pgs = args.crush_pgs - args.crush_pgs % d   # shardable count
        cr = crush_rate(mesh, mapper, n_pgs)
        rows.append({"devices": d,
                     "ec_encode_MBps": round(ec / 1e6, 1),
                     "crush_mappings_per_s": round(cr, 1)})
        print(json.dumps(rows[-1]), flush=True)
    out = {"platform": devsel.describe(dev)[0], "table": rows}
    out["crush_multichip"] = measured_sweep(
        local_mesh(maxd, device=dev), mapper, args.crush_pgs)
    if len(rows) > 1:
        out["ec_scaling"] = round(rows[-1]["ec_encode_MBps"]
                                  / rows[0]["ec_encode_MBps"], 2)
        out["crush_scaling"] = round(
            rows[-1]["crush_mappings_per_s"]
            / rows[0]["crush_mappings_per_s"], 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
