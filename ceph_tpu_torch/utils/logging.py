"""Subsystem-gated structured logging.

An analog of Ceph's dout() machinery (ref: src/common/debug.h dout,
src/common/subsys.h subsystem table, src/log/Log.cc async writer). Each
subsystem has a gate level; a record is emitted only if its level <= gate,
mirroring ``debug_<subsys> = N`` config. We keep a bounded in-memory ring of
recent records (ref: src/log/Log.cc m_recent) dumpable on failure, and lean on
Python's logging for the writer instead of a custom async thread.
"""

from __future__ import annotations

import collections
import logging
import sys
import threading
import time

# Mirrors the reference subsystem list where analogous
# (ref: src/common/subsys.h). Default gate level 1 (errors/milestones only).
SUBSYS = {
    "crush": 1,
    "osd": 1,
    "ec": 1,
    "bench": 1,
    "mon": 1,
    "sim": 1,
    "tpu": 1,
    "interop": 1,
}

_RING_SIZE = 4096
_ring: collections.deque = collections.deque(maxlen=_RING_SIZE)
_lock = threading.Lock()
_levels = dict(SUBSYS)

_root = logging.getLogger("ceph_tpu")
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname).1s %(message)s"))
    _root.addHandler(_h)
    _root.setLevel(logging.DEBUG)
    _root.propagate = False


def set_subsys_level(subsys: str, level: int) -> None:
    """``debug_<subsys> = level`` analog."""
    _levels[subsys] = level


def get_subsys_level(subsys: str) -> int:
    return _levels.get(subsys, 0)


def dump_recent() -> list[str]:
    """Recent-record ring, dumped on crash (ref: src/log/Log.cc dump_recent)."""
    with _lock:
        return list(_ring)


class SubsysLogger:
    """``dout(level) << msg`` analog: ``log.dout(level, msg, **fields)``."""

    def __init__(self, subsys: str):
        if subsys not in SUBSYS:
            SUBSYS[subsys] = 1
            _levels.setdefault(subsys, 1)
        self.subsys = subsys
        self._logger = _root.getChild(subsys)

    def dout(self, level: int, msg: str, **fields) -> None:
        record = f"[{self.subsys}:{level}] {msg}" + (
            " " + " ".join(f"{k}={v}" for k, v in fields.items())
            if fields else "")
        with _lock:
            _ring.append(f"{time.time():.6f} {record}")
        if level <= _levels.get(self.subsys, 0):
            self._logger.info(record)

    def error(self, msg: str, **fields) -> None:
        record = f"[{self.subsys}:-1] {msg}" + (
            " " + " ".join(f"{k}={v}" for k, v in fields.items())
            if fields else "")
        with _lock:
            _ring.append(f"{time.time():.6f} {record}")
        self._logger.error(record)


_loggers: dict[str, SubsysLogger] = {}


def get_logger(subsys: str) -> SubsysLogger:
    if subsys not in _loggers:
        _loggers[subsys] = SubsysLogger(subsys)
    return _loggers[subsys]
