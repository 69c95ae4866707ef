"""Upstream-exact fixed-point log2 tables and crush_ln.

ref: src/crush/mapper.c crush_ln; src/crush/crush_ln_table.h
(__RH_LH_tbl / __LL_tbl). straw2 computes draw = ln(hash16)/weight in
64-bit fixed point, where crush_ln is a table-driven log2 on the 2^44
scale.

Round 2 change: round 1 used repo-invented table scales (documented as
such); this version reproduces the upstream header's generation —

    __RH_LH_tbl[2i]   = ceil(2^56 / index1)             index1 = 256+2i
    __RH_LH_tbl[2i+1] = round(2^48 * log2(index1/256))
    __LL_tbl[k]       = round(2^48 * log2(1 + k/2^15))

and mirrors crush_ln's exact integer path: normalize x+1 into
[0x8000, 0x10000] (iexpon), split on index1 = (x>>8)<<1, residual
index2 = ((x * RH) >> 48) & 0xff, result = (iexpon << 44) + ((LH+LL) >> 4).

Why ceil for RH: x*RH >= x*2^56/index1 guarantees the residual byte never
truncates below its true value at exact multiples of index1; measured over
all 2^16 inputs this is the unique rounding that makes crush_ln monotone
(floor/round both produce ~0.011-log2 overshoots at 400+ inputs), and it
reproduces the remembered upstream constant below bit-exactly.

Anchor constants (remembered upstream values, reproduced by the formulas
above; see tests/golden/):
    RH(index1=258) = 0x0000fe03f80fe040  (= ceil(2^55/129))
    LH(index1=258) = 0x000002dfca16dde1
The full shipped header could not be byte-compared (the reference mount
is empty — SURVEY.md provenance warning); the generation formula is the
documented one and is deterministic.

All callers (vectorized mapper, scalar mapper_ref) consume these same
tables, so cross-validation between them remains exact.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def rh_lh_tables() -> tuple[np.ndarray, np.ndarray]:
    """(RH, LH) for index1 = 256, 258, ..., 512 (129 even entries).

    Entry j corresponds to index1 = 256 + 2j, i.e. the table is indexed by
    (index1 - 256) >> 1. RH(512) is included because x = 0x10000
    (xin = 0xffff) normalizes with iexpon=15 and index1=512.
    """
    index1 = np.arange(256, 514, 2)
    rh = np.array([-((-(1 << 56)) // int(i)) for i in index1],  # exact ceil
                  dtype=np.uint64)
    lh = np.rint(2.0 ** 48 * np.log2(index1 / 256.0)).astype(np.uint64)
    rh.flags.writeable = False
    lh.flags.writeable = False
    return rh, lh


@functools.lru_cache(maxsize=None)
def ll_table() -> np.ndarray:
    """__LL_tbl: 256 entries, LL[k] = round(2^48 * log2(1 + k/2^15))."""
    k = np.arange(256, dtype=np.float64)
    t = np.rint(2.0 ** 48 * np.log2(1.0 + k / 2.0 ** 15)).astype(np.uint64)
    t.flags.writeable = False
    return t


def crush_ln(xin, xp=np):
    """2^44 * log2(xin + 1) for xin in [0, 0xffff], array-vectorized,
    following mapper.c crush_ln's exact integer path.

    Returns int64 (values in [0, 2^48]).
    """
    rh, lh = rh_lh_tables()
    ll = ll_table()

    x = xp.asarray(xin).astype(xp.uint64) + xp.uint64(1)      # [1, 0x10000]
    # normalize: shift left until bit 15 (or 16) is set; iexpon = 15 - bits
    nbits = _bit_length(x, xp).astype(xp.int64)               # [1, 17]
    shift = xp.maximum(xp.zeros_like(nbits),
                       xp.int64(16) - nbits)                  # 0 when >=0x8000
    x_norm = x << shift.astype(xp.uint64)                     # [0x8000, 0x10000]
    iexpon = xp.int64(15) - shift

    index1 = (x_norm >> xp.uint64(8)) << xp.uint64(1)         # [256, 512] even
    j = ((index1 - xp.uint64(256)) >> xp.uint64(1)).astype(xp.int32)
    RH = rh[j]                                                # 2^56/index1
    LH = lh[j].astype(xp.int64)                               # 2^48*log2(i1/256)

    # xl64 = (x * RH) >> 48 ~ 2^15 * x/(128*index1); residual low byte.
    # x <= 2^16 and RH <= 2^48, so the product fits uint64 exactly.
    xl64 = (x_norm * RH) >> xp.uint64(48)
    index2 = (xl64 & xp.uint64(0xFF)).astype(xp.int32)
    LL = ll[index2].astype(xp.int64)

    return (iexpon << xp.int64(44)) + ((LH + LL) >> xp.int64(4))


def crush_ln_t(u):
    """``crush_ln`` on an integer tensor of values in [0, 0xffff]; int64.

    torch has no uint64, so the product ``x_norm * RH`` (in [2^62, 2^64))
    wraps negative in int64 for every input. Only bits 48..55 of it are
    used, and an arithmetic ``>> 48`` followed by ``& 0xFF`` keeps those
    bits exactly, so the result equals the numpy form on all 65,536
    inputs (tests/test_torch_crush.py checks every one)."""
    import torch
    rh, lh, ll = _torch_tables(u.device)
    x = u.to(torch.int64) + 1                                 # [1, 0x10000]
    nbits = torch.zeros_like(x)
    v = x
    for b in (16, 8, 4, 2, 1):
        big = v >= (1 << b)
        nbits = torch.where(big, nbits + b, nbits)
        v = torch.where(big, v >> b, v)
    nbits = nbits + 1                                         # bit_length
    shift = torch.clamp(16 - nbits, min=0)
    x_norm = x << shift
    iexpon = 15 - shift
    j = (x_norm >> 8) - 128                                   # [0, 128]
    index2 = ((x_norm * rh[j]) >> 48) & 0xFF
    return (iexpon << 44) + ((lh[j] + ll[index2]) >> 4)


_TORCH_TABLES: dict = {}


def _torch_tables(device):
    """(RH, LH, LL) as int64 tensors on ``device`` (RH < 2^63, so the
    uint64 values fit), cached per device."""
    import torch
    key = str(device)
    if key not in _TORCH_TABLES:
        rh, lh = rh_lh_tables()
        _TORCH_TABLES[key] = tuple(
            torch.as_tensor(t.astype(np.int64), device=device)
            for t in (rh, lh, ll_table()))
    return _TORCH_TABLES[key]


def _bit_length(x, xp):
    """Position of the highest set bit (1-indexed) for x in [1, 2^17),
    uint64 in/out."""
    n = xp.zeros_like(x)
    v = x
    for b in (16, 8, 4, 2, 1):
        big = v >= xp.uint64(1 << b)
        n = xp.where(big, n + xp.uint64(b), n)
        v = xp.where(big, v >> xp.uint64(b), v)
    return n + xp.uint64(1)


@functools.lru_cache(maxsize=None)
def ln_gap_info() -> tuple[int, np.ndarray]:
    """(G, zg) over the full 16-bit domain of crush_ln:

    G  = minimum POSITIVE gap between crush_ln values of adjacent inputs
         (~2^28.5 for the upstream tables);
    zg = bool[65536], zg[v] = crush_ln(v) == crush_ln(v+1) (an
         "ln-equality pair"; verified: every equality class is exactly
         an adjacent pair — no runs of >= 2 zero gaps exist).

    These license the vectorized mapper's uniform-weight straw2 shortcut:
    for a bucket whose items all share one weight w with 0 < w <= G, two
    slots tie in the post-division draw iff their hashes are ln-equal,
    which is iff they are equal or an adjacent zg pair — so the scalar
    winner (first index among the draw-tie set) is recoverable from the
    hash values alone, with no ln or division at all.
    """
    t = crush_ln(np.arange(0x10000, dtype=np.int64))
    d = np.diff(t)
    assert (d >= 0).all(), "crush_ln must be monotone"
    runs = np.diff(np.where(d == 0)[0])
    assert not (runs == 1).any(), "ln equality classes must be pairs"
    G = int(d[d > 0].min())
    zg = np.zeros(0x10000, dtype=bool)
    zg[:-1] = d == 0
    zg.flags.writeable = False
    return G, zg
