"""Sequential writes into one growing object of a ``WALStore``: the
seconds each transaction holds its caller (an OSD's loop) for.

A store is filled with ``--base-mib`` of 4 MiB objects, then one object
is written ``--xfer-mib`` at a time up to ``--object-mib`` (ior-easy's
file per process on a store that holds other data). Each write rewrites
the whole object into the WAL, and a WAL past the store's compaction
threshold (64 MiB, ``--threshold-mib``) starts a compaction of the whole table. By default
that compaction runs in the background, as the store runs it;
``--inline`` waits for each inside the write that started it, which
is what an in-line compaction costs. Prints one JSON object: each
write's seconds, the worst and the sum, and how many snapshots the
compactions wrote. It touches the store only through its public calls
and two optional ones, so it also runs against an older checkout of the
package (``PYTHONPATH=<checkout> python3 <this file>``), where every
compaction runs in line.

    python -m ceph_tpu_torch.bench.walstore_bench [--inline]
        [--base-mib 200] [--object-mib 64] [--xfer-mib 4]
        [--threshold-mib 64] [--dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from ceph_tpu_torch.os_.objectstore import Transaction, WALStore


def run(base_mib: int, object_mib: int, xfer_mib: int, inline: bool,
        path: str, threshold_mib: int = 64) -> dict:
    st = WALStore(path, compact_threshold=threshold_mib << 20)
    st.queue_transaction(Transaction().create_collection("1.0"))
    block = os.urandom(4 << 20)
    for i in range(base_mib // 4):
        st.queue_transaction(Transaction().write("1.0", f"base{i}", 0, block))
    wait = getattr(st.db, "_wait_compaction", lambda: None)
    wait()                              # the filling's own compactions
    snap = os.path.join(path, "snapshot.kv")

    def snapshots(last: list) -> None:
        # a new snapshot file (a new inode) since the last look
        now = os.stat(snap).st_ino if os.path.exists(snap) else None
        if now != last[0]:
            last[0], last[1] = now, last[1] + 1
    last = [None, 0]
    snapshots(last)
    before = last[1]
    xfer = block[:xfer_mib << 20]
    writes = []
    for off in range(0, object_mib << 20, len(xfer)):
        t0 = time.perf_counter()
        st.queue_transaction(Transaction().write("1.0", "file", off, xfer))
        if inline:
            wait()
        writes.append(time.perf_counter() - t0)
        snapshots(last)
    st.umount()
    snapshots(last)
    compactions = last[1] - before
    return {"base_mib": base_mib, "object_mib": object_mib,
            "xfer_mib": xfer_mib, "threshold_mib": threshold_mib,
            "inline": inline, "writes_s": writes,
            "worst_s": max(writes), "sum_s": sum(writes),
            "compactions": compactions}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="walstore_bench")
    ap.add_argument("--base-mib", type=int, default=200)
    ap.add_argument("--object-mib", type=int, default=64)
    ap.add_argument("--xfer-mib", type=int, default=4)
    ap.add_argument("--threshold-mib", type=int, default=64,
                    help="the WAL's compaction threshold (the store's)")
    ap.add_argument("--inline", action="store_true")
    ap.add_argument("--dir", default=None,
                    help="where the store goes (default: a temporary dir)")
    a = ap.parse_args(argv)
    path = a.dir or tempfile.mkdtemp(prefix="walstore_bench_")
    try:
        out = run(a.base_mib, a.object_mib, a.xfer_mib, a.inline,
                  os.path.join(path, "store"), a.threshold_mib)
    finally:
        shutil.rmtree(os.path.join(path, "store"), ignore_errors=True)
        if a.dir is None:
            shutil.rmtree(path, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
