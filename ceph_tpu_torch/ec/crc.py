"""CRC32 as GF(2) linear algebra: the fused checksum+encode plan.

The counterpart of ``ceph_tpu/ec/crc.py``. The EC write path stamps every
shard with a write-time ``_hcrc`` (zlib.crc32 of the shard bytes, the
hinfo analog scrub-repair uses to LOCATE a corrupt shard). This module
lets the checksum ride the same device pass as the encode.

The decomposition (all facts pinned by tests/test_torch_ec_agg.py):

- ``raw(m) = zlib.crc32(m, 0xffffffff) ^ 0xffffffff`` is the init-free
  CRC state machine. It is **linear over GF(2)** in the message bits
  (``raw(a ^ b) = raw(a) ^ raw(b)`` for equal lengths), and
  ``zlib.crc32(m) = raw(m) ^ zlib.crc32(b"\\0" * len(m))``: the
  init/final-xor affine part depends only on the length.
- For a fixed row length C, ``raw`` of one row is a (32 x 8C) GF(2)
  matrix ``G_C`` applied to the row's bits. On the device this is a
  product of the row bits with ``G_C`` and the parity of each sum
  (:func:`row_crcs_t`), one uint32 row-CRC per shard row.
- Rows concatenate through the fixed 32x32 "append C zero bytes"
  operator ``M_C``: ``raw(A || B) = M_C(raw(A)) ^ raw(B)``. The per-shard
  fold over a write's ``count`` rows is O(count) 32-bit host ops on the
  device-produced row CRCs; the O(bytes) work stays on the device.

The plan (``row_crc_matrix``, the combine, ``_zero_crc``) is host code
(numpy + zlib), copied from the reference and cached per chunk size.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils.devmon import devmon as _devmon

_M32 = 0xFFFFFFFF


def raw_crc(data: bytes, state: int = 0) -> int:
    """The init-free CRC32 state machine (zlib pre/post-inverts
    internally; this peels that off). Linear over GF(2) in the message
    bits at state 0; composes: ``raw(a + b) = raw(b, raw(a))``."""
    return zlib.crc32(data, state ^ _M32) ^ _M32


@functools.lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
    """(256,) uint64: raw CRC of each single-byte message."""
    return np.array([raw_crc(bytes([x])) for x in range(256)],
                    dtype=np.uint64)


def _zero_byte_update(state: np.ndarray) -> np.ndarray:
    """Advance raw CRC state(s) by one zero message byte (vectorized)."""
    t = _byte_table()
    s = np.asarray(state, dtype=np.uint64)
    return (s >> np.uint64(8)) ^ t[(s & np.uint64(0xFF)).astype(np.int64)]


@functools.lru_cache(maxsize=8)
def row_crc_matrix(chunk_size: int) -> np.ndarray:
    """(8C, 32) int8 GF(2) matrix: bits of a C-byte row (LSB-first per
    byte, matching gf.ops.unpack_bits) -> bits of the row's raw CRC.

    Row 8p+b is the 32-bit contribution of byte position p, bit b,
    built by walking the single-byte table backward through the
    zero-byte-append operator (position p is followed by C-1-p zero
    bytes in the row's state machine)."""
    C = int(chunk_size)
    contrib = np.zeros((C, 8), dtype=np.uint64)
    contrib[C - 1] = _byte_table()[[1 << b for b in range(8)]]
    for p in range(C - 2, -1, -1):
        contrib[p] = _zero_byte_update(contrib[p + 1])
    bits = (contrib[:, :, None] >> np.arange(32, dtype=np.uint64)) \
        & np.uint64(1)
    return bits.reshape(8 * C, 32).astype(np.int8)


@functools.lru_cache(maxsize=8)
def _crc_matrix_t(chunk_size: int, device: torch.device) -> torch.Tensor:
    """``row_crc_matrix(C)`` on the device, as uint8 (256 bytes per byte
    of C): float32 would be 4x that, 512 MiB at C = 512 KiB, so each
    chunk of the C axis is widened to float32 only while it is used."""
    return torch.as_tensor(row_crc_matrix(chunk_size).view(np.uint8),
                           device=device)


# Bytes of a row per product. An (R, 8 CH) float32 bit operand is 32 CH
# bytes a row; C // 32 keeps it at the batch's own size (the reference's
# memory promise for this leg), and 256 keeps small rows from splitting
# into many tiny products. Each product sums at most 8 CH <= 2^24 terms
# of 0/1, which float32 (and TF32) hold exactly.
_MIN_CHUNK = 256
_MAX_CHUNK = 1 << 21


def _chunk_width(C: int) -> int:
    return min(C, max(_MIN_CHUNK, min(C // 32, _MAX_CHUNK)))


def row_crcs_t(rows: torch.Tensor) -> torch.Tensor:
    """(R, C) uint8 rows -> (R,) int64 raw row CRCs (values < 2^32), on
    the rows' device: the row bits times ``row_crc_matrix(C)`` over
    GF(2). The C axis is taken in chunks (see ``_chunk_width``); each
    chunk's sums are exact in float32 and reduced to their low bit, and
    the chunks' bits add by XOR. The 32 result bits are packed in int64
    (uint32 arithmetic is missing from torch on the CPU)."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be (R, C) uint8, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    R, C = rows.shape
    dev = rows.device
    G = _crc_matrix_t(int(C), dev)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    acc = torch.zeros((R, 32), dtype=torch.int32, device=dev)
    ch = _chunk_width(int(C))
    for c0 in range(0, C, ch):
        c1 = min(C, c0 + ch)
        bits = ((rows[:, c0:c1, None] >> shifts) & 1).reshape(
            R, 8 * (c1 - c0)).to(torch.float32)
        part = bits @ G[8 * c0:8 * c1].to(torch.float32)
        acc ^= part.to(torch.int32) & 1
    weights = torch.ones(32, dtype=torch.int64, device=dev) << \
        torch.arange(32, dtype=torch.int64, device=dev)
    return (acc.to(torch.int64) * weights).sum(dim=1)


def device_row_crcs(rows, device: str | torch.device | None = None
                    ) -> np.ndarray:
    """ONE batched device CRC job: (R, C) uint8 rows -> (R,) uint32 raw
    row CRCs.

    The standalone twin of the fused encode+crc pass: :func:`row_crcs_t`
    on ``device`` (CUDA unless the caller names the CPU), accounted
    through devmon as ``scrub_crc``. Deep scrub turns a whole chunk-map
    sweep's per-object ``zlib.crc32`` calls into O(batches) device jobs;
    the per-shard fold back to zlib-equal values is :func:`shard_crc32`
    (O(rows) host work)."""
    dev = devsel.resolve(device)
    if isinstance(rows, torch.Tensor):
        arr = rows.to(device=dev, dtype=torch.uint8)
    else:
        arr = torch.as_tensor(np.ascontiguousarray(rows, dtype=np.uint8),
                              device=dev)
    if arr.dim() != 2:
        raise ValueError("device_row_crcs wants a (rows, C) batch")
    R, C = (int(s) for s in arr.shape)
    # pow2-pad the row axis (same discipline as the EC aggregators):
    # scrub batches arrive at arbitrary per-PG row counts; padding bounds
    # the distinct shapes at O(log max_rows) per chunk size
    padded = 1 << (R - 1).bit_length() if R > 1 else 1
    if padded != R:
        arr = torch.cat([arr, torch.zeros((padded - R, C),
                                          dtype=torch.uint8, device=dev)])
    out = _devmon().jit_call("scrub_crc", (C, tuple(arr.shape), str(dev)),
                             row_crcs_t, arr)
    return out[:R].cpu().numpy().astype(np.uint32)


@functools.lru_cache(maxsize=8)
def _shift_columns(chunk_size: int) -> np.ndarray:
    """(32,) uint32-valued columns of M_C, the 'append C zero bytes'
    operator on raw CRC states: column j = M_C applied to basis 2^j."""
    cols = np.array([1 << j for j in range(32)], dtype=np.uint64)
    for _ in range(int(chunk_size)):
        cols = _zero_byte_update(cols)
    return cols


def combine_row_crcs(row_crcs: np.ndarray, chunk_size: int) -> np.ndarray:
    """Fold per-row raw CRCs into per-shard raw CRCs.

    ``row_crcs``: (..., count) uint32: count C-byte rows per shard, in
    concatenation order. Returns (...) uint64-valued raw CRC of each
    shard's count*C bytes. O(count) vectorized 32-bit host ops; the
    O(bytes) part already ran on the device."""
    rc = np.asarray(row_crcs, dtype=np.uint64)
    cols = _shift_columns(chunk_size)
    state = np.zeros(rc.shape[:-1], dtype=np.uint64)
    j = np.arange(32, dtype=np.uint64)
    for i in range(rc.shape[-1]):
        bits = ((state[..., None] >> j) & np.uint64(1)).astype(bool)
        state = np.bitwise_xor.reduce(
            np.where(bits, cols, np.uint64(0)), axis=-1) ^ rc[..., i]
    return state


def _apply_cols(cols: np.ndarray, state: int) -> int:
    """Apply a 32x32 GF(2) operator (given as its 32 basis-column
    images) to one state."""
    j = np.arange(32, dtype=np.uint64)
    bits = ((np.uint64(state) >> j) & np.uint64(1)).astype(bool)
    return int(np.bitwise_xor.reduce(
        np.where(bits, cols, np.uint64(0))))


@functools.lru_cache(maxsize=64)
def _zero_crc(length: int) -> int:
    """zlib.crc32 of `length` zero bytes: the affine (init/final-xor)
    part of the checksum, a function of the length alone. Computed in
    O(log length) by square-and-multiply over the append-one-zero-byte
    operator (ref: crc32_combine); a length-sized zero buffer would
    bring back the O(bytes) host work the fused path offloads."""
    state = _M32            # the pre-inverted init register
    cols = _zero_byte_update(
        np.array([1 << j for j in range(32)], dtype=np.uint64))
    n = int(length)
    while n:
        if n & 1:
            state = _apply_cols(cols, state)
        n >>= 1
        if n:
            # square the operator: image of basis j under cols∘cols
            cols = np.array([_apply_cols(cols, int(c)) for c in cols],
                            dtype=np.uint64)
    return state ^ _M32


def shard_crc32(row_crcs: np.ndarray, chunk_size: int) -> np.ndarray:
    """Device-produced row CRCs -> zlib.crc32-equal per-shard values.

    ``row_crcs``: (..., count) uint32 from the fused pass. Returns (...)
    values equal to ``zlib.crc32`` of each shard's bytes."""
    rc = np.asarray(row_crcs, dtype=np.uint64)
    lin = combine_row_crcs(rc, chunk_size)
    return lin ^ np.uint64(_zero_crc(rc.shape[-1] * int(chunk_size)))


def hcrc_attr(shard_bytes: bytes, row_crcs=None,
              chunk_size: int | None = None) -> bytes:
    """The ONE producer of the ``_hcrc`` shard attribute (4 bytes LE).

    Consumes the fused pass's per-row CRC output when the caller has one
    (``row_crcs``: (count,) uint32 for this shard, ``chunk_size``
    required), and falls back to host-side ``zlib.crc32`` otherwise;
    both producers are pinned byte-for-byte equal by test."""
    if row_crcs is not None:
        if not chunk_size:
            raise ValueError(
                "row_crcs needs the chunk size to combine")
        v = int(shard_crc32(np.asarray(row_crcs), chunk_size))
    else:
        v = zlib.crc32(shard_bytes)
    return int(v).to_bytes(4, "little")
