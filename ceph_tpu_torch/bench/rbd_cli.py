"""The `rbd` block-image CLI.

ref: src/tools/rbd/ (rbd.cc + action/*) — image lifecycle, snapshots,
and export/import incl. the incremental diff pair:

    python -m ceph_tpu_torch.bench.rbd_cli -c CONF -p POOL create NAME
        --size BYTES
    ... ls | info NAME | rm NAME | resize NAME --size BYTES
    ... snap create NAME@SNAP | snap ls NAME | snap rm NAME@SNAP
    ... export NAME[@SNAP] FILE | import FILE NAME
    ... export-diff NAME[@SNAP] [--from-snap S] FILE
    ... import-diff FILE NAME

The port's copy of ``ceph_tpu/bench/rbd_cli.py``. ``--device cpu``
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

from ceph_tpu_torch.cluster.conf import read_conf
from ceph_tpu_torch.rados import ObjectOperationError, Rados
from ceph_tpu_torch.rbd import RBD


def _split_at_snap(spec: str) -> tuple[str, str | None]:
    name, _, snap = spec.partition("@")
    return name, snap or None


async def _run(conf: str, pool: str | None, words: list[str],
               device: str = "cuda") -> int:
    monmap, keyring = read_conf(conf)
    r = Rados(monmap, keyring=keyring, device=device)
    try:
        await r.connect()
        if pool is None:
            print("specify a pool with -p", file=sys.stderr)
            return 1
        io = await r.open_ioctx(pool)
        rbd = RBD(io)
        cmd = words[0]
        if cmd == "create":
            size = _flag_int(words, "--size", required=True)
            order = _flag_int(words, "--order") or 22
            await rbd.create(words[1], size, order=order)
            return 0
        if cmd == "ls":
            for name in await rbd.list():
                print(name)
            return 0
        if cmd == "info":
            img = await rbd.open(words[1])
            print(json.dumps(await img.stat()))
            return 0
        if cmd == "rm":
            await rbd.remove(words[1])
            return 0
        if cmd == "resize":
            size = _flag_int(words, "--size", required=True)
            img = await rbd.open(words[1])
            await img.resize(size)
            return 0
        if cmd == "snap":
            sub = words[1]
            if sub == "ls":
                img = await rbd.open(words[2])
                for s in await img.snap_list():
                    print(json.dumps(s))
                return 0
            name, snap = _split_at_snap(words[2])
            if snap is None:
                print("need image@snap", file=sys.stderr)
                return 1
            img = await rbd.open(name)
            if sub == "create":
                await img.snap_create(snap)
            elif sub == "rm":
                await img.snap_remove(snap)
            else:
                print(f"unknown snap op {sub}", file=sys.stderr)
                return 1
            return 0
        if cmd == "export":
            name, snap = _split_at_snap(words[1])
            img = await rbd.open(name, snapshot=snap)
            data = await img.read(0, img.size_bytes)
            _write_out(words[2], data)
            return 0
        if cmd == "import":
            data = _read_in(words[1])
            order = _flag_int(words, "--order") or 22
            await rbd.create(words[2], len(data), order=order)
            img = await rbd.open(words[2])
            if data:
                await img.write(0, data)
            return 0
        if cmd == "export-diff":
            name, snap = _split_at_snap(words[1])
            from_snap = _flag_str(words, "--from-snap")
            img = await rbd.open(name, snapshot=snap)
            _write_out(words[2], await img.export_diff(from_snap))
            return 0
        if cmd == "import-diff":
            img = await rbd.open(words[2])
            await img.import_diff(_read_in(words[1]))
            return 0
        print(f"unknown command {cmd!r}", file=sys.stderr)
        return 1
    except ObjectOperationError as e:
        print(f"rbd: {e}", file=sys.stderr)
        return 1
    finally:
        await r.shutdown()


def _flag_int(words: list[str], flag: str,
              required: bool = False) -> int | None:
    if flag in words:
        return int(words[words.index(flag) + 1])
    if required:
        raise SystemExit(f"{flag} is required")
    return None


def _flag_str(words: list[str], flag: str) -> str | None:
    if flag in words:
        return words[words.index(flag) + 1]
    return None


def _write_out(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def _read_in(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


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
