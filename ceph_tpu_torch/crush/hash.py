"""rjenkins1 integer hash — the randomness source of CRUSH.

ref: src/crush/hash.c (crush_hash32_rjenkins1*, crush_hashmix). Robert
Jenkins' 96-bit mix, seeded with 1315423911, applied to 1-4 uint32 inputs.
Everything downstream (straw2 draws, perm shuffles, out-checks) consumes
these 32-bit values, so this must wrap exactly like C uint32 arithmetic.

The numpy form (uint32 dtype, whose add/sub/shift wrap identically to
C) serves the scalar oracle and the host-side OSDMap. ``hash32_2_t`` /
``hash32_3_t`` are the torch forms the rule VM and the kernel's plain
version use: torch has no uint32 arithmetic on the CPU and its int32
``>>`` is arithmetic, so they carry the 32-bit values in int64 tensors,
masked to 32 bits after every add, subtract and left shift, where ``>>``
of a non-negative value is the logical shift C's uint32 does.
"""

from __future__ import annotations

import numpy as np
import torch

CRUSH_HASH_SEED = 1315423911

# The hash-algorithm id stored in buckets/rules; only rjenkins1 exists
# (ref: src/crush/hash.h CRUSH_HASH_RJENKINS1).
CRUSH_HASH_RJENKINS1 = 0


def _mix(a, b, c, xp):
    """One crush_hashmix round. Returns updated (a, b, c).

    uint32 add/sub/shift wrap identically to C in numpy.
    """
    u32 = xp.uint32
    a = a - b
    a = a - c
    a = a ^ (c >> u32(13))
    b = b - c
    b = b - a
    b = b ^ (a << u32(8))
    c = c - a
    c = c - b
    c = c ^ (b >> u32(13))
    a = a - b
    a = a - c
    a = a ^ (c >> u32(12))
    b = b - c
    b = b - a
    b = b ^ (a << u32(16))
    c = c - a
    c = c - b
    c = c ^ (b >> u32(5))
    a = a - b
    a = a - c
    a = a ^ (c >> u32(3))
    b = b - c
    b = b - a
    b = b ^ (a << u32(10))
    c = c - a
    c = c - b
    c = c ^ (b >> u32(15))
    return a, b, c


class _quiet:
    """Silence numpy's unsigned-overflow RuntimeWarnings (wrap is
    intended); a no-op for any other array namespace."""

    def __init__(self, xp):
        self._ctx = np.errstate(over="ignore") if xp is np else None

    def __enter__(self):
        if self._ctx:
            self._ctx.__enter__()

    def __exit__(self, *exc):
        if self._ctx:
            self._ctx.__exit__(*exc)


def _u32(v, xp):
    return xp.asarray(v).astype(xp.uint32)


def hash32_2(a, b, xp=np):
    """crush_hash32_rjenkins1_2."""
    with _quiet(xp):
        a, b = _u32(a, xp), _u32(b, xp)
        h = xp.uint32(CRUSH_HASH_SEED) ^ a ^ b
        x = xp.uint32(231232)
        y = xp.uint32(1232)
        a, b, h = _mix(a, b, h, xp)
        x, a, h = _mix(x, a, h, xp)
        b, y, h = _mix(b, y, h, xp)
        return h


def hash32_3(a, b, c, xp=np):
    """crush_hash32_rjenkins1_3."""
    with _quiet(xp):
        a, b, c = _u32(a, xp), _u32(b, xp), _u32(c, xp)
        h = xp.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c
        x = xp.uint32(231232)
        y = xp.uint32(1232)
        a, b, h = _mix(a, b, h, xp)
        c, x, h = _mix(c, x, h, xp)
        y, a, h = _mix(y, a, h, xp)
        b, x, h = _mix(b, x, h, xp)
        y, c, h = _mix(y, c, h, xp)
        return h


def hash32_4(a, b, c, d, xp=np):
    """crush_hash32_rjenkins1_4."""
    with _quiet(xp):
        a, b, c, d = _u32(a, xp), _u32(b, xp), _u32(c, xp), _u32(d, xp)
        h = xp.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c ^ d
        x = xp.uint32(231232)
        y = xp.uint32(1232)
        a, b, h = _mix(a, b, h, xp)
        c, d, h = _mix(c, d, h, xp)
        a, x, h = _mix(a, x, h, xp)
        y, b, h = _mix(y, b, h, xp)
        c, x, h = _mix(c, x, h, xp)
        y, d, h = _mix(y, d, h, xp)
        return h


# ---------------------------------------------------------------------------
# torch forms: uint32 values carried in int64 tensors
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _mix_t(a, b, c):
    """crush_hashmix on int64 tensors holding values in [0, 2^32)."""
    a = (a - b - c) & M32
    a = a ^ (c >> 13)
    b = (b - c - a) & M32
    b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 13)
    a = (a - b - c) & M32
    a = a ^ (c >> 12)
    b = (b - c - a) & M32
    b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 5)
    a = (a - b - c) & M32
    a = a ^ (c >> 3)
    b = (b - c - a) & M32
    b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


def _t32(v):
    """Any integer tensor (negative ids included) as int64 in [0, 2^32)."""
    return v.to(torch.int64) & M32


def hash32_2_t(a, b):
    """crush_hash32_rjenkins1_2 over broadcastable integer tensors;
    returns int64 in [0, 2^32)."""
    a, b = torch.broadcast_tensors(_t32(a), _t32(b))
    h = CRUSH_HASH_SEED ^ a ^ b
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix_t(a, b, h)
    x, a, h = _mix_t(x, a, h)
    b, y, h = _mix_t(b, y, h)
    return h


def hash32_3_t(a, b, c):
    """crush_hash32_rjenkins1_3 over broadcastable integer tensors;
    returns int64 in [0, 2^32)."""
    a, b, c = torch.broadcast_tensors(_t32(a), _t32(b), _t32(c))
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix_t(a, b, h)
    c, x, h = _mix_t(c, x, h)
    y, a, h = _mix_t(y, a, h)
    b, x, h = _mix_t(b, x, h)
    y, c, h = _mix_t(y, c, h)
    return h


def hash32_4_t(a, b, c, d):
    """crush_hash32_rjenkins1_4 over broadcastable integer tensors;
    returns int64 in [0, 2^32)."""
    a, b, c, d = torch.broadcast_tensors(_t32(a), _t32(b), _t32(c),
                                         _t32(d))
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix_t(a, b, h)
    c, d, h = _mix_t(c, d, h)
    a, x, h = _mix_t(a, x, h)
    y, b, h = _mix_t(y, b, h)
    c, x, h = _mix_t(c, x, h)
    y, d, h = _mix_t(y, d, h)
    return h
