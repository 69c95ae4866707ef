"""crushtool on the card: the --build / -c / -d / --test subset.

ref: src/tools/crushtool.cc; the same flags as
``ceph_tpu/bench/crushtool.py``, plus ``--device``:

    python -m ceph_tpu_torch.bench.crushtool \
        --build --num-osds 40 --hosts 10 [--racks N] [--alg straw2] \
        --test --rule 0 --num-rep 3 --min-x 0 --max-x 1048575 \
        [--show-utilization] [--show-statistics] [--show-mappings] \
        [--show-bad-mappings] [--weight OSD W]... [--device cpu]

``-c FILE`` compiles a crushmap text file and ``-d`` decompiles to text
(``ceph_tpu_torch.crush.compiler``); ``-i FILE`` loads a binary map and
``-o FILE`` writes one after ``-c``/``--build``/``-i`` (text after
``-d``), through ``ceph_tpu_torch.encoding``, byte for byte the format
of ``ceph_tpu``'s crushtool. The mapping runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import (
    ALG_LIST, ALG_STRAW, ALG_STRAW2, ALG_TREE, ALG_UNIFORM, ITEM_NONE,
    WEIGHT_ONE,
)

ALGS = {"straw2": ALG_STRAW2, "uniform": ALG_UNIFORM, "list": ALG_LIST,
        "straw": ALG_STRAW, "tree": ALG_TREE}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="crushtool",
                                 description="CRUSH map tool (PyTorch/CUDA)")
    ap.add_argument("--build", action="store_true")
    ap.add_argument("-c", "--compile", metavar="FILE", default=None,
                    help="compile a crushmap text file")
    ap.add_argument("-i", "--infn", metavar="FILE", default=None,
                    help="load a binary crushmap (crushtool -i)")
    ap.add_argument("-d", "--decompile", metavar="FILE", nargs="?",
                    const="", default=None,
                    help="decompile to crushmap text (optionally from a "
                         "binary FILE)")
    ap.add_argument("-o", "--outfn", metavar="FILE", default=None,
                    help="output file: binary map after -c/--build/-i, "
                         "text after -d (ref crushtool semantics)")
    ap.add_argument("--num-osds", type=int, default=16)
    ap.add_argument("--hosts", type=int, default=0,
                    help="host count (0 = flat map)")
    ap.add_argument("--racks", type=int, default=0)
    ap.add_argument("--alg", choices=sorted(ALGS), default="straw2")
    ap.add_argument("--indep", action="store_true",
                    help="build an erasure (indep) rule")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--rule", type=int, default=0)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--weight", nargs=2, action="append", default=[],
                    metavar=("OSD", "W"),
                    help="override device reweight (0.0-1.0)")
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--show-statistics", action="store_true")
    ap.add_argument("--show-mappings", action="store_true")
    ap.add_argument("--show-bad-mappings", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the mapping runs (default cuda)")
    return ap.parse_args(argv)


def build_map(args):
    if args.hosts:
        per = args.num_osds // args.hosts
        if per * args.hosts != args.num_osds:
            raise SystemExit("--num-osds must divide evenly into --hosts")
        m, root = builder.build_hierarchy(args.hosts, per,
                                          alg=ALGS[args.alg],
                                          n_racks=args.racks)
        fd = builder.TYPE_RACK if args.racks else builder.TYPE_HOST
    else:
        m, root = builder.build_flat(args.num_osds, alg=ALGS[args.alg])
        fd = builder.TYPE_OSD
    builder.add_simple_rule(m, root, fd, indep=args.indep)
    return m


def main(argv=None) -> dict:
    args = parse_args(argv)
    sources = [s for s in (args.compile, args.infn, args.decompile or None)
               if s]
    if len(sources) > 1 or (sources and args.build):
        raise SystemExit("conflicting input sources: pick ONE of "
                         "--build / -c FILE / -i FILE / -d FILE")
    if args.compile:
        from ceph_tpu_torch.crush.compiler import compile_crushmap
        with open(args.compile) as f:
            m = compile_crushmap(f.read())
    elif args.infn or args.decompile:
        from ceph_tpu_torch.encoding import EncodingError, decode_crush_map
        path = args.infn or args.decompile
        with open(path, "rb") as f:
            blob = f.read()
        try:
            m = decode_crush_map(blob)
        except EncodingError as e:
            raise SystemExit(f"{path}: not a binary crush map ({e})")
    elif args.build:
        m = build_map(args)
    else:
        raise SystemExit("pass --build, --compile FILE, -i FILE or -d FILE")
    if args.decompile is not None:
        from ceph_tpu_torch.crush.compiler import decompile_crushmap
        text = decompile_crushmap(m)
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            print(text, end="")
    elif args.outfn:
        from ceph_tpu_torch.encoding import encode_crush_map
        with open(args.outfn, "wb") as f:
            f.write(encode_crush_map(m))
    out: dict = {"max_devices": m.max_devices,
                 "rules": {r.id: r.name for r in m.rules.values()}}
    if args.test:
        weights = np.full(m.max_devices, WEIGHT_ONE, dtype=np.int64)
        for osd, w in args.weight:
            weights[int(osd)] = int(float(w) * WEIGHT_ONE)
        tester = CrushTester(m, weights, batch=args.batch,
                             device=args.device)
        res = tester.test(args.rule, args.num_rep, args.min_x, args.max_x,
                          keep_mappings=args.show_mappings)
        if args.show_mappings:
            for i, row in enumerate(res.mappings):
                devs = [int(d) for d in row if d != ITEM_NONE]
                print(f"CRUSH rule {args.rule} x {args.min_x + i} {devs}")
        if args.show_utilization:
            for dev, c in enumerate(res.device_counts):
                print(f"  device {dev}:\t\t stored : {int(c)}")
        if args.show_bad_mappings and res.bad_mappings:
            print(f"bad mappings: {res.bad_mappings}")
        if args.show_statistics:
            print(f"total mappings {res.total_x} in {res.seconds:.4f}s "
                  f"({res.mappings_per_second:,.0f}/s)")
        out.update({
            "rule": args.rule, "num_rep": args.num_rep,
            "total_x": res.total_x, "seconds": res.seconds,
            "mappings_per_second": res.mappings_per_second,
            "bad_mappings": res.bad_mappings,
            "utilization": res.utilization_summary(),
            "path": tester.mapper.last_map_path,
        })
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
