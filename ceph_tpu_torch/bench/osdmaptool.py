"""osdmaptool-style CLI: build synthetic maps, map PGs, run churn sweeps.

ref: src/tools/osdmaptool.cc (--createsimple, --test-map-pgs,
--mark-up-in/--mark-out); the port of ``ceph_tpu/bench/osdmaptool.py``,
with the same flags plus ``--device``. The heavy mode is ``--churn``: the
BASELINE config #5 rebalance simulation with every epoch's full placement
computed as one batched CRUSH launch on the card.

    python -m ceph_tpu_torch.bench.osdmaptool --createsimple 64 \
        --pg-num 1024 --test-map-pgs --churn 4 [--device cpu] \
        [--format json] [--export FILE] [--mapfn FILE]

``main`` prints the record and returns it. The CRUSH step runs on CUDA
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.types import ITEM_NONE, WEIGHT_ONE, CrushMap
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool
from ceph_tpu_torch.sim import ChurnSim


def create_simple(n_osds: int, pg_num: int, size: int, erasure: bool,
                  osds_per_host: int = 4, device=None) -> OSDMap:
    """ref: osdmaptool.cc --createsimple N (host-grouped straw2 tree).

    Builds exactly n_osds devices; the last host holds the remainder."""
    crush = CrushMap(type_names=dict(builder.DEFAULT_TYPE_NAMES))
    crush.max_devices = n_osds
    hosts = []
    for hi, lo in enumerate(range(0, n_osds, osds_per_host)):
        osds = list(range(lo, min(lo + osds_per_host, n_osds)))
        hosts.append(builder.make_bucket(
            crush, builder.TYPE_HOST, osds, [WEIGHT_ONE] * len(osds),
            name=f"host{hi}"))
    root = builder.make_bucket(crush, builder.TYPE_ROOT, hosts, name="root")
    rule = builder.add_simple_rule(crush, root, builder.TYPE_HOST,
                                   indep=erasure)
    m = OSDMap(crush, device=device)
    m.add_pool(PGPool(id=1, pg_num=pg_num, size=size,
                      type=POOL_TYPE_ERASURE if erasure else 1,
                      crush_rule=rule))
    return m


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="osdmaptool",
        description="batched OSDMap experiments (osdmaptool analog)")
    p.add_argument("--createsimple", type=int, metavar="N", default=64,
                   help="number of OSDs in the synthetic map")
    p.add_argument("--pg-num", type=int, default=1024)
    p.add_argument("--size", type=int, default=3)
    p.add_argument("--erasure", action="store_true",
                   help="EC pool (indep rule, positional sets)")
    p.add_argument("--osds-per-host", type=int, default=4)
    p.add_argument("--test-map-pgs", action="store_true",
                   help="map all PGs, print distribution statistics")
    p.add_argument("--mark-down", type=int, action="append", default=[])
    p.add_argument("--mark-out", type=int, action="append", default=[])
    p.add_argument("--churn", type=int, metavar="STEPS", default=0,
                   help="random thrash steps (down/out + revive)")
    p.add_argument("--upmap", action="store_true",
                   help="run the upmap balancer (OSDMap::calc_pg_upmaps) "
                        "and report the deviation before/after")
    p.add_argument("--upmap-deviation", type=int, default=5,
                   help="max per-OSD PG-count deviation to aim for "
                        "(ref: mgr balancer upmap_max_deviation)")
    p.add_argument("--upmap-max", type=int, default=200,
                   help="max balancer optimization iterations")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--format", choices=("plain", "json"), default="plain")
    p.add_argument("--mapfn", metavar="FILE", default=None,
                   help="load a binary osdmap instead of --createsimple "
                        "(ref: osdmaptool <mapfilename>)")
    p.add_argument("--export", metavar="FILE", default=None,
                   help="write the (possibly mutated) binary osdmap")
    p.add_argument("--export-crush", metavar="FILE", default=None,
                   help="write the map's crush blob "
                        "(ref: osdmaptool --export-crush)")
    p.add_argument("--import-crush", metavar="FILE", default=None,
                   help="replace the map's crush blob "
                        "(ref: osdmaptool --import-crush)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the CRUSH step runs (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mapfn:
        from ceph_tpu_torch.encoding import decode_osdmap
        with open(args.mapfn, "rb") as f:
            m = decode_osdmap(f.read(), device=args.device)
    else:
        m = create_simple(args.createsimple, args.pg_num, args.size,
                          args.erasure, args.osds_per_host,
                          device=args.device)
    if args.import_crush:
        from ceph_tpu_torch.encoding import decode_crush_map
        with open(args.import_crush, "rb") as f:
            m.set_crush(decode_crush_map(f.read()))
    if not m.pools:
        raise SystemExit("osdmap has no pools")
    pool_id = next(iter(m.pools))
    for o in args.mark_down:
        m.mark_down(o)
    for o in args.mark_out:
        m.mark_out(o)
    pool = m.pools[pool_id]
    out: dict = {"osds": m.max_osd, "pg_num": pool.pg_num,
                 "size": pool.size,
                 "pool_type": "erasure" if pool.is_erasure()
                 else "replicated"}

    if args.test_map_pgs or not args.churn:
        t0 = time.perf_counter()
        up, upp, _, _ = m.map_pool(pool_id)
        dt = time.perf_counter() - t0
        util = np.bincount(up[up != ITEM_NONE], minlength=m.max_osd)
        in_osds = util[np.asarray(m.osd_weight) > 0]
        out["map_pgs"] = {
            "seconds": round(dt, 4),
            "mappings_per_s": round(pool.pg_num / max(dt, 1e-9)),
            "avg": round(float(in_osds.mean()), 2),
            "min": int(in_osds.min()), "max": int(in_osds.max()),
            "stddev": round(float(in_osds.std()), 2),
            "degraded_pgs": int((up == ITEM_NONE).any(axis=1).sum()),
        }

    if args.upmap:
        def devstats():
            util = m.pool_utilization(pool_id).astype(np.float64)
            inmask = np.asarray(m.osd_weight) > 0
            tgt = util[inmask].sum() / max(inmask.sum(), 1)
            dev = util[inmask] - tgt
            return {"max_deviation": round(float(np.abs(dev).max()), 2),
                    "stddev": round(float(dev.std()), 2)}
        before = devstats()
        t0 = time.perf_counter()
        changes = m.calc_pg_upmaps(max_deviation=args.upmap_deviation,
                                   max_iterations=args.upmap_max)
        out["upmap"] = {
            "seconds": round(time.perf_counter() - t0, 3),
            "changes": changes,
            "upmap_items": len(m.pg_upmap_items),
            "before": before,
            "after": devstats(),
        }

    if args.churn:
        sim = ChurnSim(m, pool_id)
        rng = np.random.default_rng(args.seed)
        t0 = time.perf_counter()
        reports = sim.random_thrash(rng, args.churn)
        dt = time.perf_counter() - t0
        out["churn"] = {
            "seconds": round(dt, 3),
            "steps": [r.to_dict() for r in reports[-10:]],
            **sim.summary(),
        }

    if args.export:
        from ceph_tpu_torch.encoding import encode_osdmap
        with open(args.export, "wb") as f:
            f.write(encode_osdmap(m))
    if args.export_crush:
        from ceph_tpu_torch.encoding import encode_crush_map
        with open(args.export_crush, "wb") as f:
            f.write(encode_crush_map(m.crush))
    if args.format == "json":
        print(json.dumps(out, indent=2))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
