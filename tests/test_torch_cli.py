"""The port's CLIs (``ceph_tpu_torch/bench/{ceph,rados,rbd}_cli.py``,
``--device cpu``) against ``ceph_tpu``'s on the same inputs:
``tests/test_cli_tools.py``'s four cases, the mgr verbs
(``mgr dump|stat|fail``, ``progress ls|json``, ``tune status|log``,
``daemon <mgr asok> status``) and the fs verbs (``fs status|dump``,
``fs subtree ls``, ``mds fail``).

Each package serves its own cluster in a subprocess, with the same
arguments (one mon, three OSDs, two mgrs, pool ``rbd`` of 64 PGs; for
the fs verbs a second pair with two MDSs on pool ``cephfs``), and
each step runs through both packages' CLIs, each on its own cluster.
Tolerance: exact. Return codes and standard output are equal, text or
JSON, with only what differs between two live clusters masked: map
epochs, blocklist expiry times and the ports of addresses (``_masked``). Files the tools write
(``get``, ``export``, ``export-diff``) are equal byte for byte.
``rados bench``'s report has equal keys; its numbers are timings.

Without ``--device`` each port CLI maps on the card, and raises on a
machine without one.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

from ceph_tpu.bench import ceph_cli as ref_ceph_cli
from ceph_tpu.bench import rados_cli as ref_rados_cli
from ceph_tpu.bench import rbd_cli as ref_rbd_cli
from ceph_tpu_torch.bench import ceph_cli, rados_cli, rbd_cli


REPO = pathlib.Path(__file__).resolve().parent.parent
SERVE_ARGS = ["--serve", "--mon-num", "1", "--osd-num", "3",
              "--mgr-num", "2", "--pool", "rbd", "--pg-num", "64"]
FS_SERVE_ARGS = ["--serve", "--mon-num", "1", "--osd-num", "3",
                 "--mds-num", "2", "--pool", "cephfs", "--pg-num", "16"]
CLIS = {"ceph": (ref_ceph_cli.main, ceph_cli.main),
        "rados": (ref_rados_cli.main, rados_cli.main),
        "rbd": (ref_rbd_cli.main, rbd_cli.main)}


def _serve(module: str, tmp: pathlib.Path, extra: list,
           args: list = SERVE_ARGS):
    conf = str(tmp / "cluster.conf")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    logf = open(conf + ".log", "wb")      # a pipe would deadlock once
    proc = subprocess.Popen(               # the buffer fills
        [sys.executable, "-m", module] + args + extra
        + ["--conf", conf, "--asok", str(tmp / "cluster.asok")],
        cwd=str(REPO), env=env, stdout=logf, stderr=subprocess.STDOUT)
    return proc, conf, logf


def _wait_conf(proc, conf: str, deadline: float) -> None:
    while not os.path.exists(conf):
        if proc.poll() is not None:
            out = pathlib.Path(conf + ".log").read_bytes().decode(
                errors="replace")
            raise RuntimeError(f"vstart died:\n{out[-2000:]}")
        if time.time() > deadline:
            raise TimeoutError("vstart never published its conf")
        time.sleep(0.5)


def _stop(proc, logf) -> None:
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
    logf.close()


def _served_pair(tmp_path_factory, args: list, name: str):
    """(reference conf, port conf): both clusters started together."""
    served = [_serve("ceph_tpu.cluster.vstart",
                     tmp_path_factory.mktemp(f"{name}_ref"), [], args),
              _serve("ceph_tpu_torch.cluster.vstart",
                     tmp_path_factory.mktemp(f"{name}_port"),
                     ["--device", "cpu"], args)]
    try:
        deadline = time.time() + 180
        for proc, conf, _ in served:
            _wait_conf(proc, conf, deadline)
        yield served[0][1], served[1][1]
    finally:
        for proc, _, logf in served:
            _stop(proc, logf)


@pytest.fixture(scope="module")
def confs(tmp_path_factory):
    yield from _served_pair(tmp_path_factory, SERVE_ARGS, "cli")


@pytest.fixture(scope="module")
def fs_confs(tmp_path_factory):
    yield from _served_pair(tmp_path_factory, FS_SERVE_ARGS, "cli_fs")


def _mask(x):
    if isinstance(x, dict):
        if "blocklist" in x:          # entity -> wall-clock expiry
            x = dict(x, blocklist={e: "<expiry>" for e in x["blocklist"]})
        return {k: "<epoch>" if k == "epoch" else _mask(v)
                for k, v in x.items()}
    if isinstance(x, list):
        if "127.0.0.1" in x:          # an address: host, then its ports
            i = x.index("127.0.0.1")
            return [_mask(v) for v in x[:i + 1]] + ["<port>"] * (
                len(x) - i - 1)
        return [_mask(v) for v in x]
    return x


def _masked(out: str) -> str:
    """A command's output with map epochs, blocklist expiry times and
    the ports of addresses masked; JSON as a whole or line by line, other text as it is."""
    try:
        return json.dumps(_mask(json.loads(out)), indent=1,
                          sort_keys=True)
    except ValueError:
        pass
    lines = []
    for line in out.splitlines():
        try:
            lines.append(json.dumps(_mask(json.loads(line)),
                                    sort_keys=True))
        except ValueError:
            lines.append(line)
    return "\n".join(lines)


class Both:
    """One CLI step through ``ceph_tpu``'s tool on its cluster (side 0)
    and the port's on its own (side 1); the port's output is returned
    once both agree."""

    def __init__(self, confs, capsys):
        self.confs = confs
        self.capsys = capsys

    def one(self, side: int, tool: str, argv: list, rc: int = 0) -> str:
        """One side's run of a step: its standard output."""
        conf = ["-c", self.confs[side]] + ["--device", "cpu"] * side
        self.capsys.readouterr()
        assert CLIS[tool][side](conf + argv) == rc, (side, tool, argv)
        return self.capsys.readouterr().out

    def raw(self, tool: str, argv, rc: int = 0) -> tuple:
        """Both sides' output; ``argv(side)`` gives each its words."""
        return tuple(self.one(side, tool, argv(side), rc)
                     for side in (0, 1))

    def __call__(self, tool: str, *words: str, rc: int = 0) -> str:
        ref_out, port_out = self.raw(tool, lambda _: list(words), rc)
        assert _masked(port_out) == _masked(ref_out), words
        return port_out

    def files(self, tool: str, words: list, tmp_path) -> None:
        """A step whose words name files: each side has its own
        directory under ``tmp_path`` (``{d}`` in a word)."""
        dirs = [tmp_path / "ref", tmp_path / "port"]
        for d in dirs:
            d.mkdir(exist_ok=True)
        ref_out, port_out = self.raw(
            tool, lambda i: [w.format(d=dirs[i]) for w in words])
        assert _masked(port_out) == _masked(ref_out), words

    def until(self, pred, words: list, what: str,
              agree: bool = False) -> None:
        """Polls ``ceph <words>`` on each side until ``pred`` holds of
        its JSON reply. With ``agree``, the two sides are read again until
        their replies are also equal once masked, within a deadline of
        its own: a transient health check (``OSD_SLOW`` under load) that
        one served cluster raises and the other does not is waited out,
        not compared."""
        for side in (0, 1):
            deadline = time.time() + 60
            while not pred(got := json.loads(
                    self.one(side, "ceph", words))):
                assert time.time() < deadline, (what, side, got)
                time.sleep(0.5)
        deadline = time.time() + 60
        while agree:
            ref_out, port_out = self.raw("ceph", lambda _: list(words))
            if _masked(port_out) == _masked(ref_out):
                break
            if time.time() >= deadline:
                assert _masked(port_out) == _masked(ref_out), words
            time.sleep(0.5)


@pytest.fixture
def both(confs, capsys):
    return Both(confs, capsys)


def test_ceph_status_and_pool_admin(both):
    both.until(lambda s: s["health"]["status"] == "HEALTH_OK"
               and s["pgmap"]["states"] == {"clean": 64},
               ["status"], "the cluster settles")
    status = json.loads(both("ceph", "status"))
    assert status["osdmap"]["num_up_osds"] == 3
    assert "host0" in both("ceph", "osd", "tree")
    pools = json.loads(both("ceph", "osd", "pool", "ls"))
    assert any(p["name"] == "rbd" for p in pools)
    mapping = json.loads(both("ceph", "osd", "map", "rbd", "someobj"))
    assert len(mapping["acting"]) == 3
    both.until(lambda s: s["health"]["status"] == "HEALTH_OK",
               ["health"], "health agrees", agree=True)
    for words in (["mon", "dump"], ["osd", "dump"],
                  ["osd", "df"], ["pg", "dump"],
                  ["osd", "erasure-code-profile", "ls"]):
        both("ceph", *words)
    both("ceph", "config", "set", "global", "debug_osd", "5")
    assert both("ceph", "config", "get", "global",
                "debug_osd").strip() == "5"
    both("ceph", "config", "dump")


def test_rados_put_get_ls_bench(both, tmp_path):
    payload = os.urandom(4096)
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "in.bin").write_bytes(payload)
    both.files("rados", ["-p", "rbd", "put", "cliobj", "{d}/in.bin"],
               tmp_path)
    both.files("rados", ["-p", "rbd", "get", "cliobj", "{d}/out.bin"],
               tmp_path)
    assert ((tmp_path / "port" / "out.bin").read_bytes()
            == (tmp_path / "ref" / "out.bin").read_bytes() == payload)
    assert "size 4096" in both("rados", "-p", "rbd", "stat", "cliobj")
    assert "cliobj" in both("rados", "-p", "rbd", "ls").split()
    # a short bench: the reference's `rados bench 3 write`; the report's
    # numbers are timings, so only its keys are held equal
    ref_out, port_out = both.raw(
        "rados", lambda _: ["-p", "rbd", "bench", "3", "write",
                            "-b", "65536", "-t", "8"])
    rep, ref_rep = json.loads(port_out), json.loads(ref_out)
    assert list(rep) == list(ref_rep)
    assert rep["ops"] > 0 and rep["mb_per_sec"] > 0
    assert rep["bytes"] == rep["ops"] * 65536
    both("rados", "-p", "rbd", "rm", "cliobj")
    assert "rbd" in both("rados", "lspools").split()


def test_rbd_cli_lifecycle_and_diff(both, tmp_path):
    """rbd CLI against the served clusters: create/ls/info/snap,
    export/import, and the export-diff/import-diff replication chain
    (ref: src/tools/rbd action set)."""
    c = ["-p", "rbd"]
    both("rbd", *c, "create", "img", "--size", "131072", "--order", "16")
    assert "img" in both("rbd", *c, "ls")
    assert json.loads(both("rbd", *c, "info", "img"))["size"] == 131072

    # seed data by importing a file, snapshot, mutate, diff-replicate
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "payload.bin").write_bytes(b"AB" * 8192)
    both.files("rbd", c + ["import", "{d}/payload.bin", "img2",
                           "--order", "16"], tmp_path)
    both("rbd", *c, "snap", "create", "img2@s1")
    both.files("rbd", c + ["export-diff", "img2@s1", "{d}/full.diff"],
               tmp_path)
    both("rbd", *c, "resize", "img2", "--size", "32768")
    both("rbd", *c, "info", "img2")
    both.files("rbd", c + ["export-diff", "img2", "{d}/incr.diff",
                           "--from-snap", "s1"], tmp_path)

    # replicate onto a fresh image via import-diff
    both("rbd", *c, "create", "copy", "--size", "16384", "--order", "16")
    both.files("rbd", c + ["import-diff", "{d}/full.diff", "copy"],
               tmp_path)
    both.files("rbd", c + ["export", "copy", "{d}/copy.bin"], tmp_path)
    both.files("rbd", c + ["export", "img2@s1", "{d}/snap.bin"], tmp_path)
    for name in ("full.diff", "incr.diff", "copy.bin", "snap.bin"):
        port = (tmp_path / "port" / name).read_bytes()
        assert port == (tmp_path / "ref" / name).read_bytes(), name
    assert (tmp_path / "port" / "copy.bin").read_bytes() == b"AB" * 8192
    assert "s1" in both("rbd", *c, "snap", "ls", "copy")
    both("rbd", *c, "info", "copy")
    both("rbd", *c, "snap", "rm", "img2@s1")
    both("rbd", *c, "rm", "img")
    assert both("rbd", *c, "ls").split() == ["copy", "img2"]


def test_ceph_osd_blocklist_cli(both):
    """ceph osd blocklist add/ls/rm through the CLI (the fence behind
    MDS eviction, operator-driven)."""
    both("ceph", "osd", "blocklist", "add", "client.evil", "600")
    assert "client.evil" in both("ceph", "osd", "blocklist", "ls")
    both("ceph", "osd", "blocklist", "rm", "client.evil")
    assert "client.evil" not in both("ceph", "osd", "blocklist", "ls")


def test_mgr_verbs_and_failover(both, confs):
    """`ceph mgr dump|stat`, `progress ls|json`, `tune status|log`, the
    active mgr's admin socket, and `ceph mgr fail` with the standby's
    takeover, each equal to the reference's on its own cluster."""
    both.until(lambda s: s.get("available"), ["mgr", "stat"],
               "a mgr goes active")
    both("ceph", "mgr", "stat")
    dump = json.loads(both("ceph", "mgr", "dump"))
    active = dump["active_name"]
    assert active in ("x", "y") and dump["standbys"]
    for verb in ("ls", "json"):
        assert "events" in json.loads(both("ceph", "progress", verb))
    both("ceph", "tune", "status")
    both("ceph", "tune", "log")
    # the admin socket's status: equal keys, and equal name, role and
    # modules (its other values are the daemon's live counters)
    ref_st, st = (json.loads(out) for out in both.raw(
        "ceph", lambda side: ["daemon", os.path.join(
            os.path.dirname(confs[side]), f"mgr.{active}.asok"),
            "status"]))
    assert st["name"] == active and st["active"] is True
    assert "pg_autoscaler" in st["modules"]
    assert list(st) == list(ref_st)
    assert ([st[k] for k in ("name", "active", "modules")]
            == [ref_st[k] for k in ("name", "active", "modules")])
    both("ceph", "mgr", "fail")
    both.until(lambda d: d.get("active_name") not in (None, "", active)
               and d.get("standbys") == [active], ["mgr", "dump"],
               "the standby takes over and the failed mgr stands by")
    assert both("ceph", "mgr", "dump")


def test_fs_verbs_and_mds_fail(fs_confs, capsys):
    """`ceph fs status|dump`, `fs subtree ls` and `ceph mds fail` with
    the standby's takeover, each equal to the reference's on its own
    cluster (``fs dump``'s fence epoch is an osdmap epoch, masked like
    the others)."""
    both = Both(fs_confs, capsys)
    both.until(lambda d: d["ranks"] and d["ranks"][0]["state"] == "active"
               and len(d["standbys"]) == 1, ["fs", "status"],
               "an MDS goes active beside a standby")

    def fs(*words):
        outs = [json.loads(o) for o in both.raw("ceph",
                                                lambda _: list(words))]
        for d in outs:
            d["last_failure_osd_epoch"] = \
                "<epoch>" if d["last_failure_osd_epoch"] else 0
        assert _mask(outs[1]) == _mask(outs[0]), words
        return outs[1]
    st = fs("fs", "status")
    assert fs("fs", "dump")["subtrees"] == {"/": 0}
    both("ceph", "fs", "subtree", "ls")
    active = st["ranks"][0]["name"]
    both("ceph", "mds", "fail", active)
    both.until(lambda d: d["ranks"] and d["ranks"][0]["name"] != active
               and d["ranks"][0]["state"] == "active", ["fs", "dump"],
               "the standby takes rank 0")
    after = fs("fs", "dump")
    assert after["stopped_gids"] and not after["standbys"]
    assert after["last_failure_osd_epoch"] == "<epoch>"


def test_clis_map_on_the_card_unless_told(confs, monkeypatch):
    """Without --device the tools' clients map on CUDA: with no card
    (as here, or with CUDA hidden), each refuses instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((ceph_cli.main, ["status"]),
                       (rados_cli.main, ["-p", "rbd", "ls"]),
                       (rbd_cli.main, ["-p", "rbd", "ls"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-c", confs[1]] + argv)
