"""ctypes bridge to the native EC runtime (native/).

ErasureCodeRef implements the Python ErasureCodeInterface on top of
libec_ref.so, the C++ RS backend whose matrix construction is
coefficient-exact with the GF tables of ``ec.matrix``. It is a second
implementation of the same code, on the host, and serves as plugin
``ref`` and as ``isa``'s native branch (``ec.registry``):

    factory("plugin=ref technique=reed_sol_van k=8 m=3")

The port's counterpart of ``ceph_tpu/interop/native.py``, with one
difference in the build: everything the port builds goes into its own
directory ``build/native_torch/`` at the repository root, under a lock
file there, so two packages' makes never race on one set of object
files. ``build_native`` makes ``libec_ref.so`` from the repository's
``native/ec/*.cc`` (``make -C native``, the sources read in place).
``build_native_shim`` makes the dlopen registry and the ``ec_bench``
harness the same way, and the port's reverse shim
(``ceph_tpu_torch/csrc/plugin_torch_shim.cc``, which embeds CPython and
serves the port's plugin through ``interop/ec_shim.py``) as
``libec_jax.so``, the name the registry loads for ``--plugin jax``; as
``native/Makefile`` does, only where ``python3-config --embed`` exists.

    build = build_native_shim()
    ec_bench --plugin jax --dir build ... --parameter device=cpu --verify
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import os
import pathlib
import shutil
import subprocess
from typing import Mapping, Sequence

import numpy as np

from ceph_tpu_torch.ec.interface import (ErasureCodeInterface,
                                         ErasureCodeProfile)

_REPO = pathlib.Path(__file__).resolve().parents[2]
_NATIVE = _REPO / "native"
LIBRARY = "libec_ref.so"
SHIM = "libec_jax.so"                 # the registry's file for "jax"
SHIM_SOURCE = _REPO / "ceph_tpu_torch" / "csrc" / "plugin_torch_shim.cc"
NATIVE_TARGETS = ("libec_registry.so", "ec_bench")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")  # the Makefile's


def native_build_dir() -> pathlib.Path:
    return _REPO / "build" / "native_torch"


def embed_flags() -> tuple[list[str], list[str]] | None:
    """``python3-config --embed``'s (includes, ldflags), or None where
    it is missing: the shim links libpython only through it."""
    if shutil.which("python3-config") is None:
        return None
    try:
        inc, ld = (subprocess.run(
            ["python3-config", "--embed", flag], check=True,
            capture_output=True, text=True, timeout=30).stdout.split()
            for flag in ("--includes", "--ldflags"))
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    return inc, ld


def make_cmd(build: pathlib.Path, targets) -> list[str]:
    """The make that builds ``targets`` of ``native/Makefile`` into
    ``build``."""
    return ["make", "-C", str(_NATIVE), f"BUILD={build}"] + [
        str(build / t) for t in targets]


def shim_cmd(build: pathlib.Path, flags, out: pathlib.Path) -> list[str]:
    """The compile and link of the port's shim into ``out``."""
    inc, ld = flags
    return ["g++", *CXXFLAGS, *inc, f"-I{_NATIVE / 'ec'}", "-shared",
            str(SHIM_SOURCE), "-o", str(out), *ld]


@contextlib.contextmanager
def _build_lock(build: pathlib.Path):
    """Serialises the processes that build at once (test workers), so no
    two compilers write one object file."""
    build.mkdir(parents=True, exist_ok=True)
    with open(build / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def _run(cmd: list[str]) -> None:
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        out = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(f"native build failed: {out}") from e


def build_native() -> pathlib.Path:
    """Ensure ``libec_ref.so`` is up to date; returns the build dir.

    Always invokes make (it is incremental), so the loaded library tracks
    the C++ sources. Raises RuntimeError when the toolchain or the build
    fails and no library was built before."""
    build = native_build_dir()
    with _build_lock(build):
        try:
            _run(make_cmd(build, (LIBRARY,)))
        except FileNotFoundError as e:
            # no make: a library built before still serves
            if not (build / LIBRARY).exists():
                raise RuntimeError(f"native build failed: {e}") from e
    return build


def build_native_shim() -> pathlib.Path:
    """Ensure the registry, ``ec_bench`` and the port's reverse shim are
    up to date in the build dir, which it returns. The shim is relinked
    when its source or ``plugin.h`` is newer, and lands by a rename, so a
    process loading it never sees half a file. Raises RuntimeError where
    ``python3-config --embed`` is missing or a build fails."""
    flags = embed_flags()
    if flags is None:
        raise RuntimeError("python3-config --embed not found: the shim "
                           "embeds CPython")
    build = native_build_dir()
    out = build / SHIM
    with _build_lock(build):
        _run(make_cmd(build, NATIVE_TARGETS))
        newest = max(p.stat().st_mtime
                     for p in (SHIM_SOURCE, _NATIVE / "ec" / "plugin.h"))
        if not out.exists() or out.stat().st_mtime < newest:
            tmp = build / (SHIM + ".tmp")
            _run(shim_cmd(build, flags, tmp))
            os.replace(tmp, out)
    return build


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native() / LIBRARY))
    lib.ec_ref_init.restype = ctypes.c_void_p
    lib.ec_ref_init.argtypes = [ctypes.c_int, ctypes.c_int,
                                ctypes.c_char_p]
    lib.ec_ref_free.argtypes = [ctypes.c_void_p]
    lib.ec_ref_encode.restype = ctypes.c_int
    lib.ec_ref_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_size_t]
    lib.ec_ref_decode.restype = ctypes.c_int
    lib.ec_ref_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.ec_ref_coding_matrix.restype = ctypes.c_int
    lib.ec_ref_coding_matrix.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    return lib


class ErasureCodeRef(ErasureCodeInterface):
    """plugin=ref: the native C++ RS backend (a host oracle)."""

    def __init__(self, profile: ErasureCodeProfile | str | None = None):
        super().__init__()
        self.technique = "reed_sol_van"
        self._h = None
        if profile is not None:
            self.init(ErasureCodeProfile.parse(profile))

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 2)
        self.m = profile.get_int("m", 2)
        self.technique = profile.get("technique", "reed_sol_van")
        self._h = _lib().ec_ref_init(self.k, self.m,
                                     self.technique.encode())
        if not self._h:
            raise ValueError(
                f"ec_ref_init failed: k={self.k} m={self.m} "
                f"technique={self.technique}")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                _lib().ec_ref_free(h)
            except Exception:
                pass

    def is_mds(self) -> bool:
        return True

    def coding_matrix(self) -> np.ndarray:
        out = np.zeros((self.m, self.k), dtype=np.uint8)
        rc = _lib().ec_ref_coding_matrix(
            self._h, out.ctypes.data_as(ctypes.c_char_p))
        assert rc == 0
        return out

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        k, chunk = data.shape
        assert k == self.k
        parity = np.zeros((self.m, chunk), dtype=np.uint8)
        rc = _lib().ec_ref_encode(
            self._h, data.ctypes.data_as(ctypes.c_char_p),
            parity.ctypes.data_as(ctypes.c_char_p), chunk)
        if rc != 0:
            raise RuntimeError(f"ec_ref_encode rc={rc}")
        return parity

    def decode_chunks(self, want: Sequence[int],
                      chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        avail = sorted(chunks)[:self.k]
        if len(avail) < self.k:
            raise ValueError(f"need {self.k} chunks, have {len(chunks)}")
        chunk = np.asarray(chunks[avail[0]]).shape[0]
        stacked = np.ascontiguousarray(
            np.stack([np.asarray(chunks[i], dtype=np.uint8)
                      for i in avail]))
        want_l = list(want)
        out = np.zeros((len(want_l), chunk), dtype=np.uint8)
        av = (ctypes.c_int * len(avail))(*avail)
        wa = (ctypes.c_int * len(want_l))(*want_l)
        rc = _lib().ec_ref_decode(
            self._h, av, len(avail), wa, len(want_l),
            stacked.ctypes.data_as(ctypes.c_char_p),
            out.ctypes.data_as(ctypes.c_char_p), chunk)
        if rc != 0:
            raise RuntimeError(f"ec_ref_decode rc={rc}")
        return {w: out[i] for i, w in enumerate(want_l)}
