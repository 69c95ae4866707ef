"""Cluster conf file: how external tools find a running cluster.

ref: ceph.conf + keyring files — a json document holding the fsid,
monmap addresses and entity keys, written by vstart --serve and read
by the ceph/rados CLIs (ref: rados -c ceph.conf --keyring ...).
"""

from __future__ import annotations

import base64
import json

from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.msg import Keyring


def write_conf(path: str, monmap: MonMap,
               keyring: Keyring | None,
               config: dict | None = None,
               extra: dict | None = None) -> None:
    """``config`` (JSON-scalar knob overrides) and ``extra``
    (backend-specific fields like ``data_dir``) extend the document
    for the proc backend's spawned children — readers that only want
    monmap+keyring (read_conf) ignore them."""
    doc = {
        "fsid": monmap.fsid,
        "mons": {n: list(v) for n, v in monmap.mons.items()},
        "keys": {n: base64.b64encode(k).decode()
                 for n, k in keyring.keys.items()} if keyring else {},
    }
    if config:
        doc["config"] = {
            k: v for k, v in config.items()
            if isinstance(v, (str, int, float, bool)) or v is None}
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def read_conf_doc(path: str) -> dict:
    """The FULL conf document (incl. ``config``/``data_dir``) — what a
    proc-backend child reads to reconstruct its runtime."""
    with open(path) as f:
        return json.load(f)


def conf_monmap(doc: dict) -> MonMap:
    monmap = MonMap(fsid=doc.get("fsid", ""))
    for name, (rank, host, port) in doc["mons"].items():
        monmap.add(name, rank, host, port)
    return monmap


def conf_keyring(doc: dict) -> Keyring | None:
    if not doc.get("keys"):
        return None
    return Keyring({n: base64.b64decode(k)
                    for n, k in doc["keys"].items()})


def read_conf(path: str) -> tuple[MonMap, Keyring | None]:
    with open(path) as f:
        doc = json.load(f)
    monmap = MonMap(fsid=doc.get("fsid", ""))
    for name, (rank, host, port) in doc["mons"].items():
        monmap.add(name, rank, host, port)
    keyring = None
    if doc.get("keys"):
        keyring = Keyring({n: base64.b64decode(k)
                           for n, k in doc["keys"].items()})
    return monmap, keyring
