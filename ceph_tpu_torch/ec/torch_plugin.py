"""The erasure-code plugin on torch: RS encode/decode on the GPU.

The counterpart of ``ceph_tpu/ec/jax_plugin.py`` ``ErasureCodeJax``: the
ErasureCodeInterface contract with GF(2^8) Reed-Solomon as the fused
CUDA kernel of ``gf.kernels`` (or the plain torch ops), and the array
codes as packet-plane products (ref: src/erasure-code/isa/ErasureCodeIsa.cc
ErasureCodeIsa; src/erasure-code/jerasure/ErasureCodeJerasure.cc).

Backends (profile key ``backend``):

- ``kernel`` (also spelled ``pallas``, the reference's name, so its
  profiles parse unchanged): ``gf.kernels.encode_batch_planned`` with
  one plan per coding matrix (the encode matrix and each cached decode
  matrix), the hand-written kernel on CUDA and its plain version on the
  CPU. ``auto`` picks it.
- ``bitmatmul`` and ``lut``: the plain torch ops of ``gf.ops``.

The device is CUDA unless the profile says ``device=cpu`` (or the
constructor's ``device`` does); with no CUDA and no such request, init
raises. Per-erasure-pattern decode matrices are inverted once on the host
and cached, as in the reference
(ref: src/erasure-code/isa/ErasureCodeIsaTableCache.cc).

Also here, for the OSD's data plane: the fused checksum+encode
(``encode_batch_with_crc``), the device-resident stripe cache
(``DeviceShardCache``) and the double-buffered ingest pipeline
(``StreamingEncodePipeline``). Every batched device call is accounted
through ``utils.devmon``.
"""

from __future__ import annotations

import itertools
import logging
import math
import warnings
from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.ec import bitmatrix as bmx
from ceph_tpu_torch.ec import crc as ec_crc
from ceph_tpu_torch.ec import matrix as rs
from ceph_tpu_torch.ec.interface import (DEFAULT_ALIGNMENT,
                                         ErasureCodeInterface,
                                         ErasureCodeProfile)
from ceph_tpu_torch.gf import kernels, ops, tables
from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils.devmon import devmon as _devmon
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = logging.getLogger("ceph_tpu_torch.ec")

BACKENDS = ("kernel", "bitmatmul", "lut")
_BACKEND_ALIASES = {"auto": "kernel", "pallas": "kernel"}


def to_host(x) -> np.ndarray:
    """A result as a host numpy array: a torch tensor is read back
    (``.cpu().numpy()``; for a CUDA tensor this is where the host waits
    for the kernel), anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def on_card(ec) -> bool:
    """Whether a plugin's work runs on a CUDA device. Such work is never
    handed to a host path when the card fails: the OSD's degrade ladders
    retry it on the card, then raise. A plugin without a ``device`` is a
    host one."""
    dev = getattr(ec, "device", None)
    return dev is not None and torch.device(dev).type == "cuda"


class _MatrixKernel:
    """A GF coding matrix on the device: its (8m, 8k) bitmatrix for the
    bit-plane op, its nibble tables for the lut op, and for the kernel
    its plan (``kernels.make_plan``: the table words, built once)."""

    def __init__(self, coeffs: np.ndarray, backend: str,
                 device: torch.device):
        self.coeffs = np.asarray(coeffs, dtype=np.uint8)
        self.backend = backend
        bm = tables.expand_bitmatrix(self.coeffs)
        self.plan = None
        if backend == "kernel":
            self.plan = kernels.make_plan(bm, device)
            self.bitmatrix = self.plan.bitmatrix
        else:
            self.bitmatrix = torch.as_tensor(bm, device=device)
        lo, hi = tables.nibble_tables(self.coeffs)
        self.lo = torch.as_tensor(lo, device=device)
        self.hi = torch.as_tensor(hi, device=device)

    def apply_batch(self, data: torch.Tensor) -> torch.Tensor:
        """(batch, rows_in, C) -> (batch, rows_out, C)."""
        if self.backend == "kernel":
            return kernels.encode_batch_planned(self.plan, data)
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
            if not data.flags.writeable:
                # a read-only buffer (a received frame): torch warns that
                # its tensor cannot be read-only; nothing here writes it
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    return torch.as_tensor(data, device=self.device)
        return torch.as_tensor(data, dtype=torch.uint8,
                               device=self.device).contiguous()

    # -- encode -----------------------------------------------------------
    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        return self._encode_kernel.apply(self._on_device(data)).cpu().numpy()

    def encode_batch(self, data) -> torch.Tensor:
        """(batch, k, C) uint8 -> (batch, m, C) parity, on the device.

        The first call per (kernel, shape) is accounted through devmon
        as ``ec_encode``: a new batch shape under the OSD aggregator is
        a countable event."""
        kern = self._encode_kernel
        data = self._on_device(data)
        return _devmon().jit_call("ec_encode", (id(kern), tuple(data.shape)),
                                  kern.apply_batch, data)

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

    def encode_batch_with_crc(self, data):
        """Fused checksum+encode: one device pass computes the parity AND
        a raw CRC32 per shard row (data rows included).

        (B, k, C) uint8 -> (parity (B, m, C) uint8, row_crcs (B, k+m)
        int64 holding uint32 values), both on the device. The parity
        comes from the encode kernel (``gf.kernels.encode_batch_planned``
        with the encode matrix's plan); the CRC leg is
        ``ec.crc.row_crcs_t``, the GF(2) product of the word's row bits
        with ``row_crc_matrix(C)`` in exact float32 torch ops, taken over
        chunks of C so its operand stays near the batch's own size. The
        per-shard combine over a write's rows is O(rows) 32-bit host work
        in ``ec.crc``. Accounted as ``ec_encode_crc``."""
        kern = self._encode_kernel
        data = self._on_device(data)
        return _devmon().jit_call("ec_encode_crc",
                                  (id(kern), tuple(data.shape)),
                                  self._encode_with_crc, data)

    def _encode_with_crc(self, data: torch.Tensor):
        parity = self._encode_kernel.apply_batch(data)
        B, _, C = data.shape
        word = torch.cat([data, parity], dim=1)           # (B, k+m, C)
        crcs = ec_crc.row_crcs_t(word.reshape(-1, C))
        return parity, crcs.reshape(B, self.k + self.m)

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
        device; accounted through devmon as ``ec_decode``."""
        kern = self._decode_kernel(tuple(avail), tuple(want))
        chunks = self._on_device(chunks)
        return _devmon().jit_call("ec_decode",
                                  (id(kern), tuple(chunks.shape)),
                                  kern.apply_batch, chunks)

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


def _resident_perf():
    """Per-OSD counter family for the hot-shard residency cache
    (register=False: several in-process OSDs each own one; they reach
    prometheus through the daemon->mgr report path as
    ``ceph_osd_ec_resident_*`` rows)."""
    return (
        PerfCountersBuilder("osd_ec_resident")
        .add_u64_counter("hits",
                         "gathers served from the device-resident "
                         "cache (no subreads, no decode, no H2D)")
        .add_u64_counter("misses", "gathers that went to the shards")
        .add_u64_counter("inserts", "stripe ranges staged resident")
        .add_u64_counter("evictions",
                         "LRU evictions under osd_ec_resident_bytes")
        .add_u64_counter("invalidations",
                         "entries dropped by a write to their object")
        .add_u64_counter("rejected",
                         "ranges larger than the whole budget, never "
                         "cached")
        .add_u64("resident_bytes", "bytes currently resident (gauge)")
        .add_u64("entries", "entries currently resident (gauge)")
        .create_perf_counters(register=False))


class DeviceShardCache:
    """Bounded device-side LRU of gathered stripe ranges: hot-shard
    residency for the OSD data path.

    A read-modify-write or a repeated degraded read would re-gather the
    same stripes (k subread round-trips + a decode + an H2D stage) every
    time. This cache keeps the gathered (count, k, C) batch in device
    memory under an ``osd_ec_resident_bytes`` budget (read live), keyed
    by (PG, object, stripe range, object VERSION): any write bumps the
    version and makes every cached generation of that object
    unreachable. Explicit ``invalidate`` on sub-write apply reclaims
    those dead entries eagerly instead of waiting for LRU pressure.

    Entries are device tensors on ``device`` (CUDA unless the caller
    names the CPU), immutable by contract: ``get`` returns the stored
    tensor; callers read it or feed it to a kernel, never write it.
    """

    def __init__(self, config: dict | None = None,
                 device: str | torch.device | None = None):
        self.config = config if config is not None else {}
        self.device = devsel.resolve(device)
        self.perf = _resident_perf()
        # key -> (device tensor, nbytes); insertion order = LRU order
        self._lru: "dict[tuple, tuple[torch.Tensor, int]]" = {}
        self._bytes = 0

    # knobs (read LIVE: shrinking the budget takes effect on the next
    # insert's eviction sweep; 0 disables lookups AND inserts)
    def budget(self) -> int:
        return int(self.config.get("osd_ec_resident_bytes", 64 << 20))

    def enabled(self) -> bool:
        return self.budget() > 0

    def get(self, key: tuple) -> torch.Tensor | None:
        if not self.enabled():
            return None
        ent = self._lru.get(key)
        if ent is None:
            self.perf.inc("misses")
            return None
        # move-to-end = most recently used
        del self._lru[key]
        self._lru[key] = ent
        self.perf.inc("hits")
        return ent[0]

    def put(self, key: tuple, host_array) -> None:
        if not self.enabled() or key in self._lru:
            return
        arr = np.asarray(host_array, dtype=np.uint8)
        nbytes = int(arr.nbytes)
        budget = self.budget()
        if nbytes > budget:
            self.perf.inc("rejected")
            return
        while self._bytes + nbytes > budget and self._lru:
            old_key = next(iter(self._lru))
            _, old_n = self._lru.pop(old_key)
            self._bytes -= old_n
            self.perf.inc("evictions")
        try:
            # always a copy, on the CPU too (torch.as_tensor and
            # torch.from_numpy would alias the caller's buffer, which the
            # caller keeps and may write)
            dev = torch.tensor(arr, device=self.device)
        except RuntimeError as e:          # device out of memory
            log.warning("resident cache insert failed (%s: %s)",
                        type(e).__name__, str(e)[:200])
            return
        self._lru[key] = (dev, nbytes)
        self._bytes += nbytes
        self.perf.inc("inserts")
        self._gauges()

    def invalidate(self, *prefix) -> int:
        """Drop every entry whose key starts with ``prefix`` (e.g.
        (pgid, oid) on a sub-write apply). Version-keying already makes
        stale generations unreachable; this reclaims their bytes."""
        n = 0
        for key in [k for k in self._lru if k[:len(prefix)] == prefix]:
            _, nbytes = self._lru.pop(key)
            self._bytes -= nbytes
            n += 1
        if n:
            self.perf.inc("invalidations", n)
            self._gauges()
        return n

    def clear(self) -> None:
        self._lru.clear()
        self._bytes = 0
        self._gauges()

    def _gauges(self) -> None:
        self.perf.set("resident_bytes", self._bytes)
        self.perf.set("entries", len(self._lru))

    def dump(self) -> dict:
        d = self.perf.dump()
        return {
            "enabled": self.enabled(),
            "budget_bytes": self.budget(),
            "resident_bytes": self._bytes,
            "entries": len(self._lru),
            "hits": d.get("hits", 0),
            "misses": d.get("misses", 0),
            "inserts": d.get("inserts", 0),
            "evictions": d.get("evictions", 0),
            "invalidations": d.get("invalidations", 0),
        }


class _Slot:
    """One ping/pong staging slot of the pipeline: a pinned host buffer,
    the device buffer it is copied into, and the two events that say when
    each may be written again."""

    __slots__ = ("host", "dev", "copied", "read")

    def __init__(self):
        self.host: torch.Tensor | None = None    # pinned, flat uint8
        self.dev: torch.Tensor | None = None     # device, flat uint8
        self.copied = None   # event: the H2D out of `host` is done
        self.read = None     # event: the encode that read `dev` is done


class StreamingEncodePipeline:
    """Double-buffered H2D/D2H streaming encode.

    The resident benchmark number assumes the stripes already live in
    device memory; a real ingest path pays host->device per batch. On
    CUDA this pipeline overlaps the three legs:

    - **H2D of batch N+1** is issued BEFORE batch N's encode: the batch
      is copied into one of two pinned host buffers (ping/pong, taking
      the place of JAX's buffer donation), then ``copy_(non_blocking=
      True)`` on a side stream moves it into that slot's device buffer.
      Events order the reuse: the host refills a pinned buffer only
      after its last H2D completed, and the side stream overwrites a
      device buffer only after the encode that read it;
    - **encode of batch N** runs on the current stream, after an event
      wait on its H2D;
    - **D2H of batch N-1** goes on a second side stream into a pinned
      buffer; the host waits on its event, then copies the parity out,
      so every yielded array is the caller's own, never a view of a
      reused pinned buffer. That wait is the overlap window: batch N
      executes meanwhile.

    On the CPU it is the plain sequential loop (stage, encode, read
    back, one batch at a time).
    """

    def __init__(self, ec: ErasureCodeTorch):
        self.ec = ec
        self._kern = ec._encode_kernel
        self.device = ec.device
        if self.device.type == "cuda":
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
            self._slots = (_Slot(), _Slot())
            self._out_host: torch.Tensor | None = None

    def _encode(self, dm, key, data: torch.Tensor) -> torch.Tensor:
        return dm.jit_call("ec_stream_encode", key + (tuple(data.shape),),
                           self._kern.apply_batch, data)

    # -- the CUDA legs -----------------------------------------------------
    def _stage(self, host: np.ndarray, slot: _Slot, dm) -> torch.Tensor:
        """Copy a host batch into the slot's pinned buffer (the one host
        copy of the ingest path, counted through ``note_staging``) and
        start its H2D on the side stream."""
        n = host.nbytes
        if slot.host is None or slot.host.numel() < n:
            for ev in (slot.copied, slot.read):
                if ev is not None:
                    ev.synchronize()
            slot.host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            slot.dev = torch.empty(n, dtype=torch.uint8, device=self.device)
            # the new device block is ordered on the current stream only;
            # the side stream that fills it waits for that stream once
            self._h2d.wait_stream(torch.cuda.current_stream(self.device))
        elif slot.copied is not None:
            slot.copied.synchronize()
        pinned = slot.host[:n]
        np.copyto(pinned.numpy(), host.reshape(-1))
        dm.note_staging(n)
        with torch.cuda.stream(self._h2d):
            if slot.read is not None:
                self._h2d.wait_event(slot.read)
            dev = slot.dev[:n]
            dev.copy_(pinned, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._h2d)
        return dev.view(host.shape)

    def _launch(self, dm, dev: torch.Tensor, slot: _Slot):
        """Encode a staged batch on the current stream once its H2D is
        done; returns the parity and the event that marks its end."""
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(slot.copied)
        out = self._encode(dm, ("stream", id(self)), dev)
        done = torch.cuda.Event()
        done.record(compute)
        slot.read = done
        return out, done

    def _readback(self, dm, out: torch.Tensor, done) -> np.ndarray:
        n = out.numel()
        if self._out_host is None or self._out_host.numel() < n:
            self._out_host = torch.empty(n, dtype=torch.uint8,
                                         pin_memory=True)
        pinned = self._out_host[:n]
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(done)
            pinned.copy_(out.reshape(-1), non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._d2h)
        # the host reads the pinned buffer only after the copy's event;
        # `out` stays referenced until then
        copied.synchronize()
        host = pinned.numpy().reshape(tuple(out.shape)).copy()
        dm.record_d2h(host.nbytes)
        return host

    def _pipelined(self, it, pending: list, dm):
        try:
            first = np.ascontiguousarray(next(it), dtype=np.uint8)
        except StopIteration:
            return
        pending.append(first)
        dm.record_h2d(first.nbytes)
        i = 0
        cur = self._stage(first, self._slots[0], dm)
        prev = None
        for nxt_host in it:
            nxt_host = np.ascontiguousarray(nxt_host, dtype=np.uint8)
            pending.append(nxt_host)
            dm.record_h2d(nxt_host.nbytes)
            nxt = self._stage(nxt_host, self._slots[(i + 1) % 2], dm)
            out = self._launch(dm, cur, self._slots[i % 2])
            if prev is not None:
                yield self._readback(dm, *prev)
                pending.pop(0)
            prev, cur = out, nxt
            i += 1
        out = self._launch(dm, cur, self._slots[i % 2])
        if prev is not None:
            yield self._readback(dm, *prev)
            pending.pop(0)
        yield self._readback(dm, *out)
        pending.pop(0)

    def _sequential(self, it, pending: list, dm):
        for host in it:
            host = np.ascontiguousarray(host, dtype=np.uint8)
            pending.append(host)
            dm.record_h2d(host.nbytes)
            out = self._encode(dm, ("stream", id(self)),
                               self.ec._on_device(host))
            host_out = to_host(out)
            dm.record_d2h(host_out.nbytes)
            yield host_out
            pending.pop(0)

    def encode_iter(self, batches):
        """host (B, k, C) uint8 batches in -> parity numpy arrays out, in
        order; on CUDA the transfer of batch N+1 overlaps the encode of
        batch N.

        Transfer accounting: every H2D stage and D2H readback feeds the
        device-runtime monitor's byte counters.

        Fault discipline: a transfer/encode failure mid-pipeline does NOT
        lose batches. Every staged host batch is kept until its parity is
        yielded, so on failure the pipeline falls back to the unpipelined
        loop (the CPU path's own, still on the pipeline's device),
        re-encodes the in-flight batches from their host copies and
        drains the rest of the iterator (devmon counts a
        ``stream_fallbacks``; the replayed batches' H2D is counted
        again, since it happens again)."""
        dm = _devmon()
        it = iter(batches)
        # host batches staged whose parity has NOT been yielded yet,
        # oldest first: the fallback's replay source
        pending: list[np.ndarray] = []
        legs = self._pipelined if self.device.type == "cuda" \
            else self._sequential
        try:
            yield from legs(it, pending, dm)
        except Exception as e:
            dm.perf.inc("stream_fallbacks")
            log.warning("streaming encode pipeline failed (%s: %s); "
                        "falling back to the unpipelined path for %d "
                        "in-flight batches + the rest", type(e).__name__,
                        str(e)[:200], len(pending))
            yield from self._sequential(
                itertools.chain(list(pending), it), [], dm)

    def encode_all(self, batches) -> list:
        return list(self.encode_iter(batches))

    def encode_payload_iter(self, payloads, k: int, chunk_size: int):
        """Messenger-ingest handoff: wire-frame payload buffers in, parity
        out.

        Each payload is whatever the messenger delivered for a write
        (``bytes`` or a ``memoryview`` over the received frame) whose
        length is a multiple of the stripe width k*chunk_size.
        ``np.frombuffer`` wraps the buffer in place and the reshape is a
        view, so on CUDA the bytes take one host copy, into the pinned
        staging buffer (counted through ``note_staging``), on their way
        to the device; on the CPU none."""
        W = k * chunk_size

        def _carve():
            for p in payloads:
                arr = np.frombuffer(p, dtype=np.uint8)
                if arr.size % W:
                    raise ValueError(
                        f"payload of {arr.size} bytes is not a whole "
                        f"number of {W}-byte stripes")
                yield arr.reshape(-1, k, chunk_size)
        return self.encode_iter(_carve())
