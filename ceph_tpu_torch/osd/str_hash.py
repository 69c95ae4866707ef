"""Object-name hashes — the object->PG step's randomness source.

ref: src/common/ceph_hash.cc (ceph_str_hash_rjenkins, ceph_str_hash_linux)
and src/include/ceph_fs.h (CEPH_STR_HASH_* ids). rjenkins here is the
*byte-stream* variant (lookup2 style, golden-ratio init) — distinct from
the fixed-arity crush_hash32_* mixes in ceph_tpu_torch.crush.hash, though both
share the same 96-bit mix rounds.

Two shapes:
- ``str_hash``: one bytestring -> uint32 (client-side single-op path);
- ``str_hash_batch``: (N, L) padded uint8 matrix + lengths -> (N,) uint32,
  vectorized for batched op mapping (numpy).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.crush.hash import _mix, _quiet

CEPH_STR_HASH_LINUX = 0x1
CEPH_STR_HASH_RJENKINS = 0x2

_GOLDEN = 0x9E3779B9


def _word(k, o, xp):
    """Little-endian uint32 from 4 consecutive byte lanes at offset o."""
    u = k[..., o].astype(xp.uint32)
    u = u | (k[..., o + 1].astype(xp.uint32) << xp.uint32(8))
    u = u | (k[..., o + 2].astype(xp.uint32) << xp.uint32(16))
    u = u | (k[..., o + 3].astype(xp.uint32) << xp.uint32(24))
    return u


def str_hash_rjenkins(data: bytes) -> int:
    """ref: ceph_hash.cc ceph_str_hash_rjenkins (12-byte blocks + tail)."""
    out = str_hash_batch_rjenkins(
        np.frombuffer(data, dtype=np.uint8)[None, :],
        np.array([len(data)]), xp=np)
    return int(out[0])


def str_hash_batch_rjenkins(padded, lengths, xp=np):
    """(N, L) uint8 zero-padded names + (N,) lengths -> (N,) uint32.

    Vectorized port of the scalar block loop: lanes shorter than the
    current block are masked out; the tail "switch fallthrough" becomes
    per-byte masks on the tail length.
    """
    with _quiet(xp):
        padded = xp.asarray(padded, dtype=xp.uint8)
        lengths = xp.asarray(lengths, dtype=xp.uint32)
        n, cap = padded.shape
        # Room for the widest full-block read the longest lane performs
        # (and at least one block so tail gathers have somewhere to clip).
        target = max(12, -(-cap // 12) * 12)
        if cap < target:
            pad = xp.zeros((n, target - cap), dtype=xp.uint8)
            padded = xp.concatenate([padded, pad], axis=1)
        a = xp.full((n,), _GOLDEN, dtype=xp.uint32)
        b = xp.full((n,), _GOLDEN, dtype=xp.uint32)
        c = xp.zeros((n,), dtype=xp.uint32)
        nblocks = int(cap) // 12
        remaining = lengths
        for blk in range(nblocks):
            active = remaining >= 12
            o = blk * 12
            a2 = a + _word(padded, o, xp)
            b2 = b + _word(padded, o + 4, xp)
            c2 = c + _word(padded, o + 8, xp)
            a2, b2, c2 = _mix(a2, b2, c2, xp)
            a = xp.where(active, a2, a)
            b = xp.where(active, b2, b)
            c = xp.where(active, c2, c)
            remaining = xp.where(active, remaining - 12, remaining)
        # Tail: base offset of the final partial block per lane.
        base = (lengths - remaining).astype(xp.int64)
        tail = remaining.astype(xp.int64)  # 0..11
        c = c + lengths
        idx = xp.arange(padded.shape[1], dtype=xp.int64)

        def byte_at(off):
            pos = xp.clip(base + off, 0, padded.shape[1] - 1)
            return xp.take_along_axis(padded, pos[:, None],
                                      axis=1)[:, 0].astype(xp.uint32)

        del idx
        # switch(len) fallthrough: byte j contributes iff tail > j.
        shifts_c = {10: 24, 9: 16, 8: 8}
        shifts_b = {7: 24, 6: 16, 5: 8, 4: 0}
        shifts_a = {3: 24, 2: 16, 1: 8, 0: 0}
        for j, sh in shifts_c.items():
            c = xp.where(tail > j, c + (byte_at(j) << xp.uint32(sh)), c)
        for j, sh in shifts_b.items():
            b = xp.where(tail > j, b + (byte_at(j) << xp.uint32(sh)), b)
        for j, sh in shifts_a.items():
            a = xp.where(tail > j, a + (byte_at(j) << xp.uint32(sh)), a)
        a, b, c = _mix(a, b, c, xp)
        return c


def str_hash_linux(data: bytes) -> int:
    """ref: ceph_hash.cc ceph_str_hash_linux (dcache-style)."""
    h = 0
    for ch in data:
        h = (h + (ch << 4) + (ch >> 4)) * 11
        h &= 0xFFFFFFFF
    return h


def str_hash_batch_linux(padded, lengths, xp=np):
    with _quiet(xp):
        padded = xp.asarray(padded, dtype=xp.uint8)
        lengths = xp.asarray(lengths, dtype=xp.uint32)
        h = xp.zeros(padded.shape[0], dtype=xp.uint32)
        for j in range(padded.shape[1]):
            ch = padded[:, j].astype(xp.uint32)
            h2 = (h + (ch << xp.uint32(4)) + (ch >> xp.uint32(4))) \
                * xp.uint32(11)
            h = xp.where(lengths > j, h2, h)
        return h


def str_hash(algo: int, data: bytes) -> int:
    """ref: ceph_hash.cc ceph_str_hash dispatch."""
    if algo == CEPH_STR_HASH_LINUX:
        return str_hash_linux(data)
    if algo == CEPH_STR_HASH_RJENKINS:
        return str_hash_rjenkins(data)
    raise ValueError(f"unknown str hash algo {algo}")


def str_hash_batch(algo: int, padded, lengths, xp=np):
    if algo == CEPH_STR_HASH_LINUX:
        return str_hash_batch_linux(padded, lengths, xp=xp)
    if algo == CEPH_STR_HASH_RJENKINS:
        return str_hash_batch_rjenkins(padded, lengths, xp=xp)
    raise ValueError(f"unknown str hash algo {algo}")


def pack_names(names: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of names into the (N, L) matrix str_hash_batch wants."""
    cap = max((len(s) for s in names), default=1) or 1
    out = np.zeros((len(names), cap), dtype=np.uint8)
    lens = np.zeros(len(names), dtype=np.uint32)
    for i, s in enumerate(names):
        out[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    return out, lens
