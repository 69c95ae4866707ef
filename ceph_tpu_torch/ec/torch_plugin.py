"""The erasure-code plugin on torch: RS encode/decode on the GPU.

The counterpart of ``ceph_tpu/ec/jax_plugin.py`` ``ErasureCodeJax``: the
ErasureCodeInterface contract with GF(2^8) Reed-Solomon as the fused
CUDA kernel of ``gf.kernels`` (or the plain torch ops), and the array
codes as packet-plane products (ref: src/erasure-code/isa/ErasureCodeIsa.cc
ErasureCodeIsa; src/erasure-code/jerasure/ErasureCodeJerasure.cc).

Backends (profile key ``backend``):

- ``kernel`` (also spelled ``pallas``, the reference's name, so its
  profiles parse unchanged): ``gf.kernels.gf_encode``, the hand-written
  kernel on CUDA and its plain version on the CPU. ``auto`` picks it.
- ``bitmatmul`` and ``lut``: the plain torch ops of ``gf.ops``.

The device is CUDA unless the profile says ``device=cpu`` (or the
constructor's ``device`` does); with no CUDA and no such request, init
raises. Per-erasure-pattern decode matrices are inverted once on the host
and cached, as in the reference
(ref: src/erasure-code/isa/ErasureCodeIsaTableCache.cc).
"""

from __future__ import annotations

import logging
import math
from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.ec import bitmatrix as bmx
from ceph_tpu_torch.ec import matrix as rs
from ceph_tpu_torch.ec.interface import (DEFAULT_ALIGNMENT,
                                         ErasureCodeInterface,
                                         ErasureCodeProfile)
from ceph_tpu_torch.gf import kernels, ops, tables
from ceph_tpu_torch.utils import device as devsel

log = logging.getLogger("ceph_tpu_torch.ec")

BACKENDS = ("kernel", "bitmatmul", "lut")
_BACKEND_ALIASES = {"auto": "kernel", "pallas": "kernel"}


class _MatrixKernel:
    """A GF coding matrix on the device: its (8m, 8k) bitmatrix for the
    kernel and the bit-plane op, its nibble tables for the lut op."""

    def __init__(self, coeffs: np.ndarray, backend: str,
                 device: torch.device):
        self.coeffs = np.asarray(coeffs, dtype=np.uint8)
        self.backend = backend
        self.bitmatrix = torch.as_tensor(
            tables.expand_bitmatrix(self.coeffs), device=device)
        lo, hi = tables.nibble_tables(self.coeffs)
        self.lo = torch.as_tensor(lo, device=device)
        self.hi = torch.as_tensor(hi, device=device)

    def apply_batch(self, data: torch.Tensor) -> torch.Tensor:
        """(batch, rows_in, C) -> (batch, rows_out, C)."""
        if self.backend == "kernel":
            return kernels.gf_encode(self.bitmatrix, data)
        return ops.encode_stripes(self.bitmatrix, self.lo, self.hi, data,
                                  backend=self.backend)

    def apply(self, data: torch.Tensor) -> torch.Tensor:
        """(rows_in, L) uint8 -> (rows_out, L) uint8."""
        return self.apply_batch(data[None])[0]


class _BitmatrixKernel:
    """A raw GF(2) bitmatrix (array code) acting on w packets per chunk
    (ref: jerasure bitmatrix techniques)."""

    def __init__(self, bm: np.ndarray, w: int, device: torch.device):
        self.bm = torch.as_tensor(np.asarray(bm, dtype=np.uint8),
                                  device=device)
        self.w = w

    def apply_batch(self, data: torch.Tensor) -> torch.Tensor:
        """(batch, drives_in, C) -> (batch, drives_out, C); C % w == 0."""
        return ops.bitmatrix_encode_stripes(self.bm, data, self.w)

    def apply(self, data: torch.Tensor) -> torch.Tensor:
        return self.apply_batch(data[None])[0]


def _xor_packets(bm: np.ndarray, chunks: np.ndarray, w: int) -> np.ndarray:
    """Host mirror of ops.bitmatrix_encode_stripes: (B, drives_in, C) ->
    (B, rows_out / w, C) under the 0/1 matrix bm."""
    B, _, C = chunks.shape
    ps = C // w
    flat = chunks.reshape(B, -1, ps).transpose(1, 0, 2).reshape(-1, B * ps)
    out = np.zeros((bm.shape[0], B * ps), dtype=np.uint8)
    for r, sel in enumerate(bm != 0):
        if sel.any():
            out[r] = np.bitwise_xor.reduce(flat[sel], axis=0)
    return out.reshape(-1, B, ps).transpose(1, 0, 2).reshape(B, -1, C)


class ErasureCodeTorch(ErasureCodeInterface):
    """plugin=jax k=K m=M technique= reed_sol_van | reed_sol_r6_op |
    cauchy_orig | cauchy_good | liberation | blaum_roth | liber8tion
    [backend=auto|kernel|pallas|bitmatmul|lut] [device=cuda|cpu]

    GF(2^8) techniques run as (8m)x(8k) bitmatrix products; the array-code
    techniques as (2w)x(kw) packet-plane products."""

    DEFAULT_TECHNIQUE = "reed_sol_van"

    def __init__(self, profile: ErasureCodeProfile | str | None = None,
                 backend: str = "auto",
                 device: str | torch.device | None = None):
        super().__init__()
        self.technique = self.DEFAULT_TECHNIQUE
        self.backend = backend
        self._device_request = device
        self.device: torch.device | None = None
        self.w = 8
        self._bitmatrix = None
        self._encode_kernel = None
        self._decode_cache: dict[tuple, object] = {}
        self._decode_ref_cache: dict[tuple, np.ndarray] = {}
        if profile is not None:
            self.init(ErasureCodeProfile.parse(profile))

    # -- lifecycle --------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 2)
        self.m = profile.get_int("m", 2)
        self.technique = profile.get("technique", self.DEFAULT_TECHNIQUE)
        backend = profile.get("backend", self.backend)
        self.backend = _BACKEND_ALIASES.get(backend, backend)
        if self.k < 1 or self.m < 1:
            raise ValueError(f"invalid geometry k={self.k} m={self.m}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; supported: "
                             f"kernel (pallas), bitmatmul, lut, auto")
        self.device = devsel.resolve(
            profile.get("device", self._device_request))
        if self.technique in rs.BITMATRIX_TECHNIQUES:
            self.w = profile.get_int("w", 0) or bmx.default_w(
                self.technique, self.k)
            self._bitmatrix = bmx.bitmatrix_for(self.technique, self.k,
                                                self.m, self.w)
            self._encode_kernel = _BitmatrixKernel(self._bitmatrix, self.w,
                                                   self.device)
        else:
            self.w = 8
            self._bitmatrix = None
            self._encode_kernel = _MatrixKernel(
                rs.coding_matrix(self.technique, self.k, self.m),
                self.backend, self.device)
        self._decode_cache.clear()
        self._decode_ref_cache.clear()
        log.debug("init k=%d m=%d technique=%s backend=%s device=%s",
                  self.k, self.m, self.technique, self.backend, self.device)

    def get_alignment(self) -> int:
        # bitmatrix chunks are w packets; keep packets aligned too
        if self._bitmatrix is not None:
            return DEFAULT_ALIGNMENT * self.w // math.gcd(
                DEFAULT_ALIGNMENT, self.w)
        return DEFAULT_ALIGNMENT

    def is_mds(self) -> bool:
        return True

    def _on_device(self, data) -> torch.Tensor:
        if not isinstance(data, torch.Tensor):
            data = np.ascontiguousarray(data, dtype=np.uint8)
        return torch.as_tensor(data, dtype=torch.uint8,
                               device=self.device).contiguous()

    # -- encode -----------------------------------------------------------
    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        return self._encode_kernel.apply(self._on_device(data)).cpu().numpy()

    def encode_batch(self, data) -> torch.Tensor:
        """(batch, k, C) uint8 -> (batch, m, C) parity, on the device."""
        return self._encode_kernel.apply_batch(self._on_device(data))

    def encode_batch_reference(self, data) -> np.ndarray:
        """Host-only bit-exact reference encode, pure numpy:
        ``gf_matmul_np`` for the GF(2^8) techniques, the packet-plane XOR
        mirror for the array codes. (B, k, C) uint8 -> (B, m, C)."""
        data = np.ascontiguousarray(np.asarray(data), dtype=np.uint8)
        if self._bitmatrix is not None:
            return _xor_packets(np.asarray(self._bitmatrix), data, self.w)
        x = data.transpose(1, 0, 2)                       # (k, B, C)
        return tables.gf_matmul_np(self._encode_kernel.coeffs,
                                   x).transpose(1, 0, 2)

    # -- decode -----------------------------------------------------------
    def _decode_matrix(self, avail: tuple[int, ...],
                       want: tuple[int, ...]) -> np.ndarray:
        if self._bitmatrix is not None:
            return bmx.decode_bitmatrix(self._bitmatrix, self.k, self.m,
                                        self.w, avail, want)
        return rs.decode_matrix(self.technique, self.k, self.m, avail, want)

    def _decode_kernel(self, avail: tuple[int, ...],
                       want: tuple[int, ...]):
        key = (avail, want)
        kern = self._decode_cache.get(key)
        if kern is None:
            d = self._decode_matrix(avail, want)
            if self._bitmatrix is not None:
                kern = _BitmatrixKernel(d, self.w, self.device)
            else:
                kern = _MatrixKernel(d, self.backend, self.device)
            self._decode_cache[key] = kern
            log.debug("decode matrix built avail=%s want=%s", avail, want)
        return kern

    def decode_chunks(self, want: Sequence[int],
                      chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        avail = tuple(sorted(chunks))[:self.k]
        if len(avail) < self.k:
            raise ValueError(
                f"cannot decode: have {len(chunks)} chunks, need {self.k}")
        want_t = tuple(want)
        kern = self._decode_kernel(avail, want_t)
        stacked = self._on_device(np.stack(
            [np.asarray(chunks[i], dtype=np.uint8) for i in avail]))
        out = kern.apply(stacked).cpu().numpy()
        return {c: out[i] for i, c in enumerate(want_t)}

    def decode_batch(self, want: Sequence[int], avail: Sequence[int],
                     chunks) -> torch.Tensor:
        """chunks (batch, len(avail), C) -> (batch, len(want), C), on the
        device."""
        kern = self._decode_kernel(tuple(avail), tuple(want))
        return kern.apply_batch(self._on_device(chunks))

    def decode_batch_reference(self, want: Sequence[int],
                               avail: Sequence[int], chunks) -> np.ndarray:
        """Host-only bit-exact reference decode, pure numpy: the same
        per-erasure-pattern matrix the device path caches, applied with
        ``gf_matmul_np`` or the packet-plane XOR mirror.
        (B, len(avail), C) uint8 -> (B, len(want), C)."""
        chunks = np.ascontiguousarray(np.asarray(chunks), dtype=np.uint8)
        key = (tuple(avail), tuple(want))
        d = self._decode_ref_cache.get(key)
        if d is None:
            d = np.asarray(self._decode_matrix(*key), dtype=np.uint8)
            self._decode_ref_cache[key] = d
        if self._bitmatrix is not None:
            return _xor_packets(d, chunks, self.w)
        x = chunks.transpose(1, 0, 2)          # (len(avail), B, C)
        return tables.gf_matmul_np(d, x).transpose(1, 0, 2)
