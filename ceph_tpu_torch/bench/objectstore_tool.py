"""ceph-objectstore-tool analog: offline surgery on an OSD's store.

ref: src/tools/ceph_objectstore_tool.cc — operate directly on a
stopped OSD's data directory:

    python -m ceph_tpu_torch.bench.objectstore_tool --data-path DIR \
        --op list-pgs
    ... --op list [--pgid PG]
    ... --op export --pgid PG --file OUT
    ... --op import --file IN
    ... --op remove --pgid PG
    ... --op info --pgid PG --object OID
    ... --op fsck

The port's copy of ``ceph_tpu/bench/objectstore_tool.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.encoding.denc import Decoder, Encoder
from ceph_tpu_torch.os_.objectstore import StoreError, Transaction, WALStore

EXPORT_MAGIC = 0x74704F45  # 'EOpt'


def export_pg(store: WALStore, pgid: str) -> bytes:
    """One PG's full state (objects + attrs + omap), importable
    elsewhere (ref: tool's export/import PG surgery)."""
    e = Encoder()
    e.u32(EXPORT_MAGIC)
    with e.start(1):
        e.string(pgid)
        objs = store.list_objects(pgid)
        e.u32(len(objs))
        for oid in objs:
            e.string(oid)
            e.blob(store.read(pgid, oid))
            e.map(store.getattrs(pgid, oid),
                  lambda e, k: e.string(k), lambda e, v: e.blob(v))
            e.map(store.omap_get(pgid, oid),
                  lambda e, k: e.string(k), lambda e, v: e.blob(v))
    return e.tobytes()


def import_pg(store: WALStore, blob: bytes) -> str:
    d = Decoder(blob)
    if d.u32() != EXPORT_MAGIC:
        raise SystemExit("not a PG export file")
    with d.start(1):
        pgid = d.string()
        t = Transaction()
        if pgid not in store.list_collections():
            t.create_collection(pgid)
        for _ in range(d.u32()):
            oid = d.string()
            data = d.blob()
            attrs = d.map(lambda d: d.string(), lambda d: d.blob())
            omap = d.map(lambda d: d.string(), lambda d: d.blob())
            t.touch(pgid, oid)
            t.truncate(pgid, oid, 0)
            if data:
                t.write(pgid, oid, 0, data)
            if attrs:
                t.setattrs(pgid, oid, attrs)
            t.omap_clear(pgid, oid)
            if omap:
                t.omap_setkeys(pgid, oid, omap)
        store.queue_transaction(t)
    return pgid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-objectstore-tool",
                                description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--op", required=True,
                   choices=["list-pgs", "list", "export", "import",
                            "remove", "info", "fsck"])
    p.add_argument("--pgid", default=None)
    p.add_argument("--object", default=None)
    p.add_argument("--file", default=None)
    p.add_argument("--type", default="auto",
                   choices=["auto", "walstore", "bluestore"],
                   help="store format (auto sniffs for a BlueStore "
                        "block file)")
    args = p.parse_args(argv)
    import os as _os
    kind = args.type
    if kind == "auto":
        kind = "bluestore" if _os.path.exists(
            _os.path.join(args.data_path, "block")) else "walstore"
    if kind == "bluestore":
        from ceph_tpu_torch.os_.bluestore import BlueStore
        store = BlueStore(args.data_path)
    else:
        store = WALStore(args.data_path)
    try:
        if args.op == "list-pgs":
            for cid in store.list_collections():
                print(cid)
        elif args.op == "list":
            cids = [args.pgid] if args.pgid else \
                store.list_collections()
            for cid in cids:
                for oid in store.list_objects(cid):
                    print(json.dumps([cid, oid]))
        elif args.op == "export":
            if not (args.pgid and args.file):
                raise SystemExit("--op export needs --pgid and --file")
            with open(args.file, "wb") as f:
                f.write(export_pg(store, args.pgid))
            print(f"export {args.pgid} done", file=sys.stderr)
        elif args.op == "import":
            if not args.file:
                raise SystemExit("--op import needs --file")
            with open(args.file, "rb") as f:
                pgid = import_pg(store, f.read())
            print(f"import {pgid} done", file=sys.stderr)
        elif args.op == "remove":
            if not args.pgid:
                raise SystemExit("--op remove needs --pgid")
            store.queue_transaction(
                Transaction().remove_collection(args.pgid))
            print(f"remove {args.pgid} done", file=sys.stderr)
        elif args.op == "info":
            if not (args.pgid and args.object):
                raise SystemExit("--op info needs --pgid and --object")
            try:
                data = store.read(args.pgid, args.object)
                attrs = store.getattrs(args.pgid, args.object)
            except StoreError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            print(json.dumps({
                "pgid": args.pgid, "oid": args.object,
                "size": len(data),
                "attrs": {k: v.hex() for k, v in attrs.items()},
                "omap_keys": sorted(
                    store.omap_get(args.pgid, args.object))}))
        elif args.op == "fsck":
            errors = store.fsck()
            for err in errors:
                print(err, file=sys.stderr)
            print(f"fsck: {len(errors)} errors")
            return 1 if errors else 0
        return 0
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
