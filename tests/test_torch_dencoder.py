"""The port's ``ceph-dencoder`` (``bench/dencoder.py``) against ceph_tpu's.

Every type the reference lists, every canonical test instance of it:
``encode`` + ``hexdump``, ``dump_json``, ``encode decode dump_json`` and
a round trip through a file (``export``, then ``import decode encode``)
print the same bytes in both packages, and the port re-encodes what the
reference exported and the reverse. The port builds and decodes osdmaps
on the CPU (``--device cpu``); the error paths exit alike.

Tolerance: exact (the tool's whole output).
"""

from __future__ import annotations

import contextlib
import io

import pytest

from ceph_tpu.bench import dencoder as ref
from ceph_tpu_torch.bench import dencoder as port

CASES = [(t, i) for t, spec in ref.TYPES.items()
         for i in range(len(spec["tests"]))]


def _run(mod, args):
    out, err = io.StringIO(), io.StringIO()
    argv = list(args) + (["--device", "cpu"] if mod is port else [])
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_the_port_lists_the_same_types():
    assert _run(port, ["list_types"]) == _run(ref, ["list_types"])
    assert list(port.TYPES) == list(ref.TYPES)


@pytest.mark.parametrize("typ,i", CASES, ids=[f"{t}-{i}" for t, i in CASES])
@pytest.mark.parametrize("verbs", [
    ["encode", "hexdump"],
    ["dump_json"],
    ["encode", "decode", "dump_json"],
    ["encode", "decode", "encode", "hexdump"],
], ids=["encode", "dump", "decode", "round_trip"])
def test_each_type_prints_the_same(typ, i, verbs):
    args = ["type", typ, "count_tests", "select_test", str(i), *verbs]
    got, want = _run(port, args), _run(ref, args)
    assert got == want
    assert got[0] == 0 and got[1]


@pytest.mark.parametrize("typ,i", CASES, ids=[f"{t}-{i}" for t, i in CASES])
def test_files_cross_between_the_packages(typ, i, tmp_path):
    """Bytes one package exports, the other imports, decodes and
    re-encodes unchanged."""
    for a, b in ((ref, port), (port, ref)):
        f = tmp_path / f"{a.__name__}.bin"
        rc, _, _ = _run(a, ["type", typ, "select_test", str(i), "encode",
                            "export", str(f)])
        assert rc == 0
        got = _run(b, ["type", typ, "import", str(f), "decode", "encode",
                       "hexdump"])
        assert got[0] == 0 and got[1].strip() == f.read_bytes().hex()
        assert _run(b, ["type", typ, "import", str(f), "decode",
                        "dump_json"]) == \
            _run(a, ["type", typ, "import", str(f), "decode", "dump_json"])


@pytest.mark.parametrize("args", [
    ["type", "nope"],
    ["encode"],
    ["type", "pg_t", "decode"],
    ["type", "pg_t", "encode"],
    ["florp"],
], ids=["unknown_type", "no_type", "no_bytes", "no_object", "unknown_verb"])
def test_error_paths_exit_alike(args):
    got, want = _run(port, args), _run(ref, args)
    assert got == want and got[0] == 1


def test_the_port_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["list_types"])
