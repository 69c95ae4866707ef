"""The `ceph` admin CLI.

ref: src/ceph.in — argv is translated into mon command dicts and sent
through MonClient, mirroring the reference's command spellings:

    python -m ceph_tpu_torch.bench.ceph_cli -c CONF [--device cpu] status
    ... osd tree | osd dump | osd df | osd pool ls | pg dump
    ... osd pool create <name> <pg_num> [replicated|erasure [profile]]
    ... osd pool set <name> <var> <val>
    ... osd out <id> | osd in <id> | osd down <id>
    ... osd blocklist add|rm <entity> [expire-s] | osd blocklist ls
    ... pg repair <pgid>
    ... fs status | fs dump | mds fail <name-or-gid>
    ... fs set max_mds <n> | fs subtree pin <path> <rank>
    ... fs subtree ls
    ... osd map <pool> <object>
    ... osd erasure-code-profile set <name> k=2 m=1 ...
    ... config set <who> <name> <value> | config get <who> [<name>]
    ... quorum_status | mon dump | health
    ... osd perf                     # per-OSD commit/apply latency
    ... progress ls | progress json  # long-running-op events
    ... mgr dump | mgr stat | mgr fail
    ... tune status | tune log [n]   # mgr tuner ledger + audit trail

Admin-socket commands (`ceph daemon <asok-path> <command>`, ref:
src/ceph.in daemon mode) talk to one daemon out-of-band:

    ... daemon /tmp/osd.0.asok ops              # in-flight client ops
    ... daemon /tmp/osd.0.asok dump_historic_ops
    ... daemon /tmp/osd.0.asok dump_slow_ops    # past complaint time
    ... daemon /tmp/mgr.x.asok daemon-stats osd.0   # live rates from
        the mgr's reported-counter time series
    ... daemon /tmp/cluster.asok fault ls       # runtime fault sets
    ... daemon /tmp/cluster.asok '{"prefix": "fault install",
        "name": "p", "rules": [{"kind": "partition",
        "a": "osd.0", "b": "osd.1"}]}'
    ... daemon /tmp/cluster.asok fault clear

The port's copy of ``ceph_tpu/bench/ceph_cli.py``. ``--device cpu``
decodes the maps the command client follows on the CPU; by default on
the card (CUDA), and the tool raises without one (``daemon`` opens no
client). ``-c`` defaults to the conf
``python -m ceph_tpu_torch.cluster.vstart --serve`` writes.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import tempfile

from ceph_tpu_torch.cluster.conf import read_conf
from ceph_tpu_torch.mon.client import MonClient


def parse_command(words: list[str]) -> tuple[dict, bytes]:
    """argv words -> mon command dict (ref: ceph CLI's cmdmap)."""
    try:
        return _parse_command(words)
    except (IndexError, ValueError):   # truncated words / bad numerics
        raise SystemExit(
            f"unrecognized/incomplete command: {' '.join(words)!r}")


def _parse_command(words: list[str]) -> tuple[dict, bytes]:
    w = words
    j = " ".join(w)
    if j in ("status", "-s", "health", "mon dump", "quorum_status",
             "osd dump", "osd tree", "osd df", "osd pool ls",
             "pg dump", "osd getmap", "osd getcrushmap",
             "config dump", "osd new", "fs status", "fs dump",
             "auth ls", "osd perf", "progress ls", "progress json",
             "mgr dump", "mgr stat", "mgr fail"):
        return {"prefix": "status" if j == "-s" else j}, b""
    if w[:2] == ["mon", "add"]:
        # ceph mon add <name> <host> <port> — runtime monmap growth
        return {"prefix": "mon add", "name": w[2], "host": w[3],
                "port": int(w[4])}, b""
    if w[:2] == ["mon", "rm"] or w[:2] == ["mon", "remove"]:
        return {"prefix": "mon rm", "name": w[2]}, b""
    if w[0] == "auth":
        # ceph auth get-or-create|get|rm|rotate <entity> / auth caps
        # <entity> <json> — the AuthMonitor key lifecycle
        if w[1] in ("get-or-create", "get", "rm", "del", "rotate"):
            return {"prefix": f"auth {w[1]}", "entity": w[2]}, b""
        if w[1] == "caps":
            return {"prefix": "auth caps", "entity": w[2],
                    "caps": w[3]}, b""
    if w[0] == "log":
        if w[1] == "last":
            cmd = {"prefix": "log last"}
            if len(w) > 2:
                cmd["num"] = int(w[2])
            return cmd, b""
        return {"prefix": "log", "logtext": " ".join(w[1:])}, b""
    if w[0] == "trace":
        # ceph trace ls [limit] | show <trace_id> | dump — the
        # reassembled distributed-trace views (slowest-first ls)
        if w[1] == "ls":
            cmd = {"prefix": "trace ls"}
            if len(w) > 2:
                cmd["limit"] = int(w[2])
            return cmd, b""
        if w[1] == "show":
            return {"prefix": "trace show", "trace_id": int(w[2])}, b""
        if w[1] == "dump":
            return {"prefix": "trace dump"}, b""
    if w[:2] == ["mds", "fail"]:
        return {"prefix": "mds fail", "who": w[2]}, b""
    if w[:2] == ["fs", "set"]:
        # ceph fs set max_mds <n> — open/retire active ranks
        return {"prefix": "fs set", "var": w[2], "val": w[3]}, b""
    if w[:3] == ["fs", "subtree", "pin"]:
        # ceph fs subtree pin <path> <rank> — migrate subtree authority
        return {"prefix": "fs subtree pin", "path": w[3],
                "rank": int(w[4])}, b""
    if w[:3] == ["fs", "subtree", "ls"]:
        return {"prefix": "fs subtree ls"}, b""
    if w[:3] == ["osd", "pool", "create"]:
        cmd = {"prefix": "osd pool create", "pool": w[3]}
        if len(w) > 4:
            cmd["pg_num"] = int(w[4])
        if len(w) > 5:
            cmd["pool_type"] = w[5]
        if len(w) > 6:
            cmd["erasure_code_profile"] = w[6]
        return cmd, b""
    if w[:3] == ["osd", "pool", "rm"]:
        return {"prefix": "osd pool rm", "pool": w[3]}, b""
    if w[:3] == ["osd", "pool", "set"]:
        return {"prefix": "osd pool set", "pool": w[3], "var": w[4],
                "val": w[5]}, b""
    if w[:2] == ["osd", "map"]:
        return {"prefix": "osd map", "pool": w[2], "object": w[3]}, b""
    if w[:2] == ["osd", "crush"] and w[2] == "add":
        cmd = {"prefix": "osd crush add", "id": int(w[3]),
               "weight": float(w[4])}
        for extra in w[5:]:
            if extra.startswith("host="):
                cmd["host"] = extra[5:]
        return cmd, b""
    if w[0] == "osd" and w[1] in ("out", "in", "down"):
        return {"prefix": f"osd {w[1]}", "id": int(w[2])}, b""
    if w[:2] == ["osd", "blocklist"]:
        # ceph osd blocklist add|rm <entity> [expire-s] | ls
        cmd = {"prefix": "osd blocklist", "blocklistop": w[2]}
        if w[2] in ("add", "rm"):
            cmd["addr"] = w[3]
            if len(w) > 4:
                cmd["expire"] = float(w[4])
        return cmd, b""
    if w[:2] == ["osd", "slow"]:
        # ceph osd slow ls — confirmed slow OSDs + score table
        return {"prefix": "osd slow ls"}, b""
    if w[:2] == ["tune", "status"]:
        # ceph tune status — TunerModule mode + commit/revert counters
        # + owned-target table (what the tuner is currently holding)
        return {"prefix": "tune status"}, b""
    if w[:2] == ["tune", "log"]:
        # ceph tune log [n] — the bounded tuner audit trail, newest
        # last; each entry carries policy + sensors + command
        cmd = {"prefix": "tune log"}
        if len(w) > 2:
            cmd["num"] = int(w[2])
        return cmd, b""
    if w[:2] == ["device-runtime", "status"]:
        # ceph device-runtime status — per-daemon kernel engine,
        # mismatch rate, compile count/time, transfer GiB
        return {"prefix": "device-runtime status"}, b""
    if w[0] == "crash":
        # ceph crash ls | info <id> | archive <id> | archive-all —
        # the pooled daemon crash reports behind RECENT_CRASH
        if w[1] == "ls":
            return {"prefix": "crash ls"}, b""
        if w[1] in ("info", "archive"):
            return {"prefix": f"crash {w[1]}", "id": w[2]}, b""
        if w[1] == "archive-all":
            return {"prefix": "crash archive-all"}, b""
    if w[:2] == ["osd", "client-profile"]:
        # ceph osd client-profile set <entity> <res> <weight> <limit>
        #                          | rm <entity> | ls
        cmd = {"prefix": "osd client-profile", "op": w[2]}
        if w[2] in ("set", "rm"):
            cmd["entity"] = w[3]
        if w[2] == "set":
            cmd["reservation"] = float(w[4])
            cmd["weight"] = float(w[5])
            cmd["limit"] = float(w[6])
        return cmd, b""
    if w[:2] == ["pg", "repair"]:
        # ceph pg repair <pgid> — rewrite digest-mismatched replicas
        # from the authoritative copy (mon messages the acting primary)
        return {"prefix": "pg repair", "pgid": w[2]}, b""
    if w[:2] == ["osd", "reweight"]:
        return {"prefix": "osd reweight", "id": int(w[2]),
                "weight": float(w[3])}, b""
    if w[:2] == ["osd", "erasure-code-profile"]:
        if w[2] == "set":
            return {"prefix": "osd erasure-code-profile set",
                    "name": w[3], "profile": w[4:]}, b""
        if w[2] == "get":
            return {"prefix": "osd erasure-code-profile get",
                    "name": w[3]}, b""
        if w[2] == "ls":
            return {"prefix": "osd erasure-code-profile ls"}, b""
    if w[0] == "config":
        if w[1] == "set":
            return {"prefix": "config set", "who": w[2], "name": w[3],
                    "value": w[4]}, b""
        if w[1] == "get":
            cmd = {"prefix": "config get", "who": w[2]}
            if len(w) > 3:
                cmd["name"] = w[3]
            return cmd, b""
        if w[1] == "rm":
            return {"prefix": "config rm", "who": w[2],
                    "name": w[3]}, b""
    raise SystemExit(f"unrecognized command: {j!r}")


async def _run_daemon(words: list[str]) -> int:
    """`ceph daemon <asok-path> <command...>` — out-of-band admin
    socket access (ref: src/ceph.in's daemon mode)."""
    from ceph_tpu_torch.utils.admin_socket import daemon_command
    if len(words) < 2:
        print("usage: daemon <asok-path> <command|json>",
              file=sys.stderr)
        return 1
    path, rest = words[0], " ".join(words[1:])
    if words[1] == "daemon-stats" and len(words) >= 3:
        # `ceph daemon <mgr.asok> daemon-stats osd.0` — the mgr-side
        # live-rates view over one daemon's reported time series
        cmd: dict = {"prefix": "daemon-stats", "name": words[2]}
        try:
            return print(json.dumps(
                await daemon_command(path, cmd), indent=2,
                default=str)) or 0
        except (ConnectionError, OSError) as e:
            print(f"Error: cannot reach admin socket {path}: {e}",
                  file=sys.stderr)
            return 1
    try:
        cmd = json.loads(rest)
        if not isinstance(cmd, dict):
            raise ValueError
    except (json.JSONDecodeError, ValueError):
        cmd = {"prefix": rest}
    try:
        out = await daemon_command(path, cmd)
    except (ConnectionError, OSError) as e:
        print(f"Error: cannot reach admin socket {path}: {e}",
              file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, default=str))
    return 1 if isinstance(out, dict) and "error" in out else 0


async def _run(conf: str, words: list[str], out_file: str | None,
               device: str = "cuda") -> int:
    if words and words[0] == "daemon":
        return await _run_daemon(words[1:])
    monmap, keyring = read_conf(conf)
    mc = MonClient("client.admin", monmap, keyring=keyring, device=device)
    try:
        cmd, inbl = parse_command(words)
        ret, rs, outbl = await mc.command(cmd)
        if ret != 0:
            print(f"Error: {rs} ({ret})", file=sys.stderr)
            return 1
        if out_file:
            with open(out_file, "wb") as f:
                f.write(outbl)
        elif outbl:
            try:
                print(json.dumps(json.loads(outbl), indent=2))
            except (json.JSONDecodeError, UnicodeDecodeError):
                sys.stdout.write(outbl.decode(errors="replace"))
        if rs:
            print(rs, file=sys.stderr)
        return 0
    finally:
        await mc.shutdown()


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    conf = os.path.join(tempfile.gettempdir(), "ceph_tpu_torch.conf")
    out_file = None
    if args and args[0] in ("-c", "--conf"):
        conf = args[1]
        args = args[2:]
    if "-o" in args:
        i = args.index("-o")
        out_file = args[i + 1]
        args = args[:i] + args[i + 2:]
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        args = args[:i] + args[i + 2:]
    if not args:
        print(__doc__)
        return 0
    return asyncio.run(_run(conf, args, out_file, device))


if __name__ == "__main__":
    sys.exit(main())
