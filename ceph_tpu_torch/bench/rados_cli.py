"""The `rados` object CLI.

ref: src/tools/rados/rados.cc — pool object operations plus the
classic `rados bench` workload generator:

    python -m ceph_tpu_torch.bench.rados_cli -c CONF -p POOL put NAME FILE
    ... -p POOL get NAME FILE | rm NAME | stat NAME | ls
    ... -p POOL bench SECONDS write [-b SIZE] [-t CONCURRENCY]
    ... df | lspools

The port's copy of ``ceph_tpu/bench/rados_cli.py``. ``--device cpu``
runs the client's maps on the CPU; by default they map on the card
(CUDA), and the tool raises without one. ``-c`` defaults to the conf
``python -m ceph_tpu_torch.cluster.vstart --serve`` writes.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import tempfile
import time

from ceph_tpu_torch.cluster.conf import read_conf
from ceph_tpu_torch.rados import ObjectOperationError, Rados


async def _bench(io, seconds: int, size: int, concurrency: int) -> dict:
    """ref: rados bench write — timed fixed-size object writes with a
    bounded in-flight window, reporting MB/s + iops + latency."""
    payload = b"\xcb" * size
    stop = time.perf_counter() + seconds
    lat: list[float] = []
    done = 0
    idx = 0

    async def one(i: int) -> None:
        nonlocal done
        t0 = time.perf_counter()
        await io.write_full(f"benchmark_data_{i}", payload)
        lat.append(time.perf_counter() - t0)
        done += 1

    pending: set = set()
    t_start = time.perf_counter()
    while time.perf_counter() < stop:
        while len(pending) < concurrency and time.perf_counter() < stop:
            pending.add(asyncio.ensure_future(one(idx)))
            idx += 1
        finished, pending = await asyncio.wait(
            pending, return_when=asyncio.FIRST_COMPLETED)
    if pending:
        await asyncio.wait(pending)
    elapsed = time.perf_counter() - t_start
    return {
        "seconds": round(elapsed, 3),
        "ops": done,
        "bytes": done * size,
        "mb_per_sec": round(done * size / elapsed / (1 << 20), 3),
        "iops": round(done / elapsed, 1),
        "avg_latency_s": round(sum(lat) / max(len(lat), 1), 4),
        "max_latency_s": round(max(lat, default=0), 4),
    }


async def _run(conf: str, pool: str | None, words: list[str],
               device: str = "cuda") -> int:
    monmap, keyring = read_conf(conf)
    r = Rados(monmap, keyring=keyring, device=device)
    try:
        await r.connect()
        cmd = words[0]
        if cmd == "lspools":
            ret, rs, out = await r.mon_command(
                {"prefix": "osd pool ls"})
            if ret != 0:
                print(f"error: {rs} ({ret})", file=sys.stderr)
                return 1
            for p in json.loads(out):
                print(p["name"])
            return 0
        if cmd == "df":
            ret, rs, out = await r.mon_command({"prefix": "osd df"})
            if ret != 0:
                print(f"error: {rs} ({ret})", file=sys.stderr)
                return 1
            print(json.dumps(json.loads(out), indent=2))
            return 0
        if pool is None:
            print("specify a pool with -p", file=sys.stderr)
            return 1
        io = await r.open_ioctx(pool)
        if cmd == "put":
            with open(words[2], "rb") as f:
                await io.write_full(words[1], f.read())
        elif cmd == "get":
            data = await io.read(words[1])
            with open(words[2], "wb") as f:
                f.write(data)
        elif cmd == "rm":
            await io.remove(words[1])
        elif cmd == "stat":
            size = await io.stat(words[1])
            print(f"{pool}/{words[1]} size {size}")
        elif cmd == "ls":
            for name in await io.list_objects():
                print(name)
        elif cmd == "bench":
            seconds = int(words[1])
            size = 1 << 20
            conc = 16
            if "-b" in words:
                size = int(words[words.index("-b") + 1])
            if "-t" in words:
                conc = int(words[words.index("-t") + 1])
            rep = await _bench(io, seconds, size, conc)
            print(json.dumps(rep, indent=2))
        else:
            print(f"unknown command {cmd!r}", file=sys.stderr)
            return 1
        return 0
    except ObjectOperationError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await r.shutdown()


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    conf = os.path.join(tempfile.gettempdir(), "ceph_tpu_torch.conf")
    pool = None
    device = "cuda"
    while args and args[0] in ("-c", "--conf", "-p", "--pool",
                               "--device"):
        if args[0] in ("-c", "--conf"):
            conf = args[1]
        elif args[0] == "--device":
            device = args[1]
        else:
            pool = args[1]
        args = args[2:]
    if not args:
        print(__doc__)
        return 0
    return asyncio.run(_run(conf, pool, args, device))


if __name__ == "__main__":
    sys.exit(main())
