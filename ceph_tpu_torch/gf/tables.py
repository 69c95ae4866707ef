"""GF(2^8) table construction and numpy oracle.

Field: GF(2^8) with primitive polynomial x^8+x^4+x^3+x^2+1 = 0x11d, the
polynomial used by jerasure/gf-complete at w=8 and by ISA-L — matching it is
required for parity-bit compatibility with the reference plugins
(ref: src/erasure-code/jerasure vendored gf-complete gf_w8.c).

Everything here is host-side numpy: table/matrix construction is tiny and
happens once per profile; the per-byte hot loops live in ``ops.py`` (torch)
and ``kernels.py`` (the CUDA encode kernel).
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # primitive polynomial, w=8
GF_ORDER = 256


@functools.lru_cache(maxsize=None)
def _log_exp_tables() -> tuple[np.ndarray, np.ndarray]:
    """(log, exp) tables for generator alpha=2 under GF_POLY."""
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]  # wraparound so exp[log a + log b] needs no mod
    log[0] = -1  # sentinel; 0 has no log
    log.flags.writeable = False
    exp.flags.writeable = False
    return log, exp


def gf_mul(a: int, b: int) -> int:
    log, exp = _log_exp_tables()
    if a == 0 or b == 0:
        return 0
    return int(exp[log[a] + log[b]])


def gf_pow(a: int, n: int) -> int:
    log, exp = _log_exp_tables()
    if a == 0:
        return 0 if n else 1
    return int(exp[(log[a] * n) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    log, exp = _log_exp_tables()
    return int(exp[255 - log[a]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("gf_div by 0")
    if a == 0:
        return 0
    log, exp = _log_exp_tables()
    return int(exp[(log[a] - log[b]) % 255])


@functools.lru_cache(maxsize=None)
def mul_table() -> np.ndarray:
    """Full 256x256 product table, uint8."""
    log, exp = _log_exp_tables()
    a = np.arange(256)
    la = log[a]
    t = exp[(la[:, None] + la[None, :])]
    t[0, :] = 0
    t[:, 0] = 0
    t = t.astype(np.uint8)
    t.flags.writeable = False  # cached: mutation would corrupt all GF math
    return t


def gf_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF product of uint8 arrays (broadcasting)."""
    return mul_table()[np.asarray(a, dtype=np.uint8),
                       np.asarray(b, dtype=np.uint8)]


def gf_matmul_np(m: np.ndarray, x: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: (r,k) @ (k,...) -> (r,...), XOR-accumulated.

    The numpy oracle for the torch ops and the CUDA kernel; also used for the tiny per-profile
    matrix algebra (decode-matrix construction).
    """
    m = np.asarray(m, dtype=np.uint8)
    x = np.asarray(x, dtype=np.uint8)
    midx = (slice(None), slice(None)) + (None,) * (x.ndim - 1)
    prod = mul_table()[m[midx], x[None]]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_matinv_np(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan.

    Used to build decode matrices from the surviving rows of the generator
    (ref: src/erasure-code/jerasure jerasure_invert_matrix).
    Raises ValueError if singular.
    """
    m = np.array(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError("square matrix required")
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col]:
                pivot = row
                break
        if pivot is None:
            raise ValueError("singular GF matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = gf_mul_np(aug[col], inv)
        for row in range(n):
            if row != col and aug[row, col]:
                aug[row] ^= gf_mul_np(aug[row, col], aug[col])
    return aug[:, n:]


# ---------------------------------------------------------------------------
# Bit-matrix decomposition (the MXU formulation)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _coeff_bitmatrices() -> np.ndarray:
    """(256, 8, 8) uint8: bitmatrix of every coefficient.

    For y = c*x with x = sum_j x_j alpha^j (LSB-first bits), column j of M_c
    is bits(c * alpha^j):  y_i = XOR_j M_c[i, j] * x_j.
    Same role as jerasure_matrix_to_bitmatrix at w=8 (ref:
    src/erasure-code/jerasure vendored jerasure.c), derived directly from
    field linearity rather than translated.
    """
    out = np.zeros((256, 8, 8), dtype=np.uint8)
    for c in range(256):
        for j in range(8):
            col = gf_mul(c, 1 << j)
            for i in range(8):
                out[c, i, j] = (col >> i) & 1
    out.flags.writeable = False  # cached: see mul_table
    return out


def coeff_bitmatrix(c: int) -> np.ndarray:
    """8x8 0/1 matrix of multiply-by-c."""
    return _coeff_bitmatrices()[c]


def expand_bitmatrix(coding: np.ndarray) -> np.ndarray:
    """Expand an (m, k) GF coding matrix to its (8m, 8k) 0/1 bit-matrix."""
    coding = np.asarray(coding, dtype=np.uint8)
    m, k = coding.shape
    bm = _coeff_bitmatrices()[coding]          # (m, k, 8, 8)
    return bm.transpose(0, 2, 1, 3).reshape(8 * m, 8 * k)


# ---------------------------------------------------------------------------
# Nibble product tables (the VPU/LUT formulation)
# ---------------------------------------------------------------------------

def nibble_tables(coding: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-coefficient 16-entry product tables (lo, hi), each (m, k, 16).

    lo[c][n] = c*n,  hi[c][n] = c*(n<<4):  c*x = lo[x & 15] ^ hi[x >> 4].
    The ISA-L vpshufb formulation (ref: src/isa-l gf_vect_mul SIMD kernels),
    expressed as gather tables.
    """
    coding = np.asarray(coding, dtype=np.uint8)
    n = np.arange(16, dtype=np.uint8)
    lo = gf_mul_np(coding[..., None], n)
    hi = gf_mul_np(coding[..., None], (n << 4).astype(np.uint8))
    return lo, hi
