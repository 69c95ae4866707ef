"""Wire encodings of the port's messages against the golden corpus.

Every message type the port registers (``osd/messages.py``,
``mon/messages.py``, ``mgr/messages.py``, ``cephfs/mds.py``) encodes its
canonical instance, built the way
``tests/test_meta.py`` builds the reference's, to the bytes recorded in
``tests/golden/messages.json`` (read only), equal to ``ceph_tpu``'s
encoding of the same instance, and decodes back to it field for field.

Tolerance: exact bytes.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

import ceph_tpu.cephfs.mds  # noqa: F401  (registers the reference's)
import ceph_tpu.mgr.messages  # noqa: F401
import ceph_tpu.mon.messages  # noqa: F401
import ceph_tpu.osd.messages  # noqa: F401
import ceph_tpu_torch.cephfs.mds  # noqa: F401  (registers the port's)
import ceph_tpu_torch.mgr.messages  # noqa: F401
import ceph_tpu_torch.mon.messages  # noqa: F401
import ceph_tpu_torch.osd.messages  # noqa: F401
from ceph_tpu.msg.message import _REGISTRY as REF_REGISTRY
from ceph_tpu_torch.msg.message import _REGISTRY as PORT_REGISTRY
from ceph_tpu_torch.msg.message import Message

GOLDEN = json.loads((Path(__file__).parent / "golden" /
                     "messages.json").read_text())
PORT = {code: cls for code, cls in PORT_REGISTRY.items()
        if cls.__module__.startswith("ceph_tpu_torch.")}


def _sample(codec: str, i: int):
    """Canonical per-field value (``tests/test_meta.py``'s)."""
    base, _, rest = codec.partition(":")
    if base in ("u8", "u16", "u32", "u64"):
        return i + 1
    if base in ("s32", "s64"):
        return -(i + 1)
    if base == "f64":
        return i + 0.5
    if base == "bool":
        return i % 2 == 0
    if base == "str":
        return f"s{i}"
    if base in ("blob", "blob_view"):
        return bytes([i % 256, 0x5A])
    if base == "list":
        return [_sample(rest, i), _sample(rest, i + 1)]
    if base == "map":
        k_codec, _, v_codec = rest.partition(":")
        return {_sample(k_codec, i): _sample(v_codec, i + 1)}
    raise ValueError(f"unknown codec {codec!r}")


def _canonical(cls):
    return cls(**{name: _sample(codec, i)
                  for i, (name, codec) in enumerate(cls.FIELDS)})


def test_the_port_registers_the_osd_and_mon_messages():
    """Every osd/mon/mgr/mds message of the reference has its port twin,
    under the same type code and name, with the same fields."""
    ref = {code: cls for code, cls in REF_REGISTRY.items()
           if cls.__module__ in ("ceph_tpu.osd.messages",
                                 "ceph_tpu.mon.messages",
                                 "ceph_tpu.mgr.messages",
                                 "ceph_tpu.cephfs.mds")}
    assert {c: cls.__name__ for c, cls in PORT.items()} == \
        {c: cls.__name__ for c, cls in ref.items()}
    for code, cls in PORT.items():
        assert cls.FIELDS == ref[code].FIELDS, cls.__name__
    assert len(PORT) >= 40
    assert {c for c in PORT if 220 <= c <= 226} == set(range(220, 227))


@pytest.mark.parametrize("code", sorted(PORT),
                         ids=[PORT[c].__name__ for c in sorted(PORT)])
def test_encoding_equals_golden_and_reference(code):
    cls = PORT[code]
    key = f"{cls.__name__}:{code}"
    blob = _canonical(cls).encode()
    assert blob.hex() == GOLDEN[key]
    assert blob == _canonical(REF_REGISTRY[code]).encode()
    back = Message.decode(blob)
    assert type(back) is cls
    ref = _canonical(cls)
    for name, _ in cls.FIELDS:
        got = getattr(back, name)
        if isinstance(got, memoryview):
            got = bytes(got)
        elif isinstance(got, list):
            got = [bytes(x) if isinstance(x, memoryview) else x
                   for x in got]
        assert got == getattr(ref, name), f"{key}.{name}"
