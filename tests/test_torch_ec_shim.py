"""The port's reverse shim (``ceph_tpu_torch/interop/ec_shim.py`` and
``ceph_tpu_torch/csrc/plugin_torch_shim.cc``, built as
``build/native_torch/libec_jax.so``), held against the in-process
plugins.

The counterparts of ``tests/test_native.py``'s ``TestJaxReverseShim``:
the native ``ec_bench`` harness encodes and decodes through the shim
with ``--verify``, and the shim's vtable gives the same parity and the
same decoded chunks as the port's ``ErasureCodeTorch``, the port's
native ``ErasureCodeRef`` and ``ceph_tpu``'s ``ErasureCodeJax``. The
reference loads its shim into pytest's own interpreter; here the vtable
case runs in a child ``python3`` that the test starts, with the same
checks, so a crash in native code fails one test and leaves the test
worker alive. Every run asks for the CPU with the profile key
``device=cpu``. Skips where make, g++ or ``python3-config --embed`` is
missing, as the reference's does. Everything is integer, so the
tolerance is equality.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.interop import native

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def shim_dir():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable")
    if native.embed_flags() is None:
        pytest.skip("libec_jax.so not built (no python3-config --embed)")
    return native.build_native_shim()


def _env() -> dict:
    """The embedded interpreter finds torch through the venv it runs in."""
    env = dict(os.environ)
    if sys.prefix != sys.base_prefix:
        env["VIRTUAL_ENV"] = sys.prefix
    return env


def _ec_bench(build, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [str(build / "ec_bench"), "--plugin", "jax", "--dir", str(build),
         *args, "--parameter", "device=cpu", "--verify"],
        capture_output=True, text=True, timeout=300, env=_env())


def test_ec_bench_plugin_jax_encode_verify(shim_dir):
    out = _ec_bench(shim_dir, "--workload", "encode", "--size", "262144",
                    "--iterations", "2", "--parameter", "k=4",
                    "--parameter", "m=2")
    assert out.returncode == 0, out.stderr
    assert "verify: ok" in out.stderr
    secs, mbs = out.stdout.split()
    assert float(secs) > 0 and float(mbs) > 0


def test_ec_bench_plugin_jax_decode_verify(shim_dir):
    out = _ec_bench(shim_dir, "--workload", "decode", "--size", "262144",
                    "--iterations", "1", "--erasures", "2",
                    "--parameter", "k=8", "--parameter", "m=3")
    assert out.returncode == 0, out.stderr
    assert "verify: ok" in out.stderr


# The child: the registry's factory loads the shim, which reuses this
# interpreter (PyGILState); an encode and a decode through the C vtable.
CHILD = r"""
import ctypes, json, sys
import numpy as np
build, profile, k, m, chunk, erased = json.loads(sys.argv[1])

class VT(ctypes.Structure):
    _fields_ = [
        ("create", ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p)),
        ("destroy", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
        ("k_of", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)),
        ("m_of", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)),
        ("encode", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_size_t)),
        ("decode", ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t)),
    ]

lib = ctypes.CDLL(build + "/libec_registry.so", mode=ctypes.RTLD_GLOBAL)
lib.ec_registry_factory.restype = ctypes.c_void_p
lib.ec_registry_factory.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_void_p)]
vt_ptr = ctypes.c_void_p()
be = lib.ec_registry_factory(b"jax", build.encode(), profile.encode(),
                             ctypes.byref(vt_ptr))
assert be and vt_ptr.value, "shim factory failed"
vt = ctypes.cast(vt_ptr, ctypes.POINTER(VT)).contents
assert (vt.k_of(be), vt.m_of(be)) == (k, m)
data = np.random.default_rng(7).integers(0, 256, size=(k, chunk),
                                         dtype=np.uint8)
parity = np.zeros((m, chunk), dtype=np.uint8)
assert vt.encode(be, data.ctypes.data_as(ctypes.c_char_p),
                 parity.ctypes.data_as(ctypes.c_char_p), chunk) == 0
full = np.concatenate([data, parity])
avail = [i for i in range(k + m) if i not in erased][:k]
chunks = np.ascontiguousarray(full[avail])
out = np.zeros((len(erased), chunk), dtype=np.uint8)
av = (ctypes.c_int * k)(*avail)
wa = (ctypes.c_int * len(erased))(*erased)
assert vt.decode(be, av, k, wa, len(erased),
                 chunks.ctypes.data_as(ctypes.c_char_p),
                 out.ctypes.data_as(ctypes.c_char_p), chunk) == 0
vt.destroy(be)
print(json.dumps({"parity": parity.tobytes().hex(),
                  "decoded": out.tobytes().hex()}))
"""


@pytest.mark.parametrize("k,m,tech,erased", [
    (4, 2, "reed_sol_van", [0, 5]),
    (8, 3, "reed_sol_van", [1, 2, 9]),
    (8, 3, "cauchy_good", [0, 7, 10])])
def test_shim_vtable_parity_vs_python(shim_dir, k, m, tech, erased):
    """Byte parity through the C vtable, in a child interpreter: the
    shim's parity and decoded chunks equal the port's torch plugin's,
    the port's native backend's and ceph_tpu's JAX plugin's."""
    chunk = 512
    prof = f"k={k} m={m} technique={tech}"
    out = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(
            [str(shim_dir), f"{prof} device=cpu", k, m, chunk, erased])],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env=dict(_env(), PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    parity = np.frombuffer(bytes.fromhex(got["parity"]),
                           dtype=np.uint8).reshape(m, chunk)
    decoded = np.frombuffer(bytes.fromhex(got["decoded"]),
                            dtype=np.uint8).reshape(len(erased), chunk)
    data = np.random.default_rng(7).integers(0, 256, size=(k, chunk),
                                             dtype=np.uint8)
    port = ErasureCodeTorch(prof, device="cpu")
    assert np.array_equal(parity, port.encode_chunks(data))
    assert np.array_equal(parity, native.ErasureCodeRef(prof).encode_chunks(
        data))
    assert np.array_equal(parity, ErasureCodeJax(prof).encode_chunks(data))
    full = np.concatenate([data, parity])
    surv = {i: full[i] for i in range(k + m) if i not in erased}
    want = port.decode_chunks(erased, surv)
    for i, e in enumerate(erased):
        assert np.array_equal(decoded[i], full[e])
        assert np.array_equal(decoded[i], want[e])
