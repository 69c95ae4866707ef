"""Reed-Solomon coding-matrix constructions over GF(2^8).

Reimplements (from the published algorithms, not the code) the matrix
constructions used by the reference's jerasure and isa plugins so that parity
bytes are compatible:

- ``reed_sol_van``: systematic matrix derived from an extended Vandermonde
  matrix by Gauss-Jordan column elimination — Plank's construction
  (ref: src/erasure-code/jerasure vendored reed_sol.c
  reed_sol_vandermonde_coding_matrix / reed_sol_big_vandermonde_distribution_matrix).
- ``cauchy_orig``: C[i][j] = 1/(x_i + y_j) with x_i = i, y_j = m + j
  (ref: vendored cauchy.c cauchy_original_coding_matrix).
- ``cauchy_good``: cauchy_orig column-normalized so row 0 is all ones
  (ref: vendored cauchy.c cauchy_improve_coding_matrix; we apply the
  normalization step, not the bit-count row optimization, which only affects
  XOR-schedule cost, not the code itself).

NOTE (provenance): the reference tree was unavailable (SURVEY.md warning), so
bit-compatibility with jerasure is asserted from the published algorithm and
property-tested (systematic + MDS), pending byte-level verification against a
live reference build.
"""

from __future__ import annotations

import functools

import numpy as np

from ceph_tpu_torch.gf import tables


def extended_vandermonde(rows: int, cols: int) -> np.ndarray:
    """Extended Vandermonde matrix, rows x cols over GF(2^8).

    Row 0 = e_0, row rows-1 = e_{cols-1}, row i (0<i<rows-1) = [i^j for j].
    MDS for rows <= 257 at w=8.
    """
    if rows > 256 + 1:
        raise ValueError("k+m must be <= 257 at w=8")
    v = np.zeros((rows, cols), dtype=np.uint8)
    v[0, 0] = 1
    v[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        acc = 1
        for j in range(cols):
            v[i, j] = acc
            acc = tables.gf_mul(acc, i)
    return v


def _systematize(dist: np.ndarray, cols: int) -> np.ndarray:
    """Column-eliminate so the top cols x cols block is the identity.

    Mirrors the elimination order of the published jerasure construction:
    column operations pivoting down the diagonal, then normalize row `cols`
    to all ones via column scaling, then scale each remaining row so its
    first element is one.
    """
    rows = dist.shape[0]
    dist = dist.copy()
    for i in range(1, cols):
        # Pivot: find a row >= i with a nonzero in column i, swap into row i.
        if dist[i, i] == 0:
            for j in range(i + 1, rows):
                if dist[j, i]:
                    dist[[i, j]] = dist[[j, i]]
                    break
            else:
                raise ValueError("singular construction")
        # Scale column i so dist[i, i] == 1.
        if dist[i, i] != 1:
            inv = tables.gf_inv(int(dist[i, i]))
            dist[:, i] = tables.gf_mul_np(dist[:, i], inv)
        # Zero the rest of row i with column ops (col_j += e * col_i).
        for j in range(cols):
            e = int(dist[i, j])
            if j != i and e:
                dist[:, j] ^= tables.gf_mul_np(e, dist[:, i])
    if rows > cols:
        # Make row `cols` all ones by scaling columns.
        for j in range(cols):
            e = int(dist[cols, j])
            if e == 0:
                raise ValueError("singular construction")
            if e != 1:
                inv = tables.gf_inv(e)
                dist[cols:, j] = tables.gf_mul_np(dist[cols:, j], inv)
        # Make the first element of each later row one by scaling rows.
        for i in range(cols + 1, rows):
            e = int(dist[i, 0])
            if e == 0:
                raise ValueError("singular construction")
            if e != 1:
                inv = tables.gf_inv(e)
                dist[i, :] = tables.gf_mul_np(dist[i, :], inv)
    return dist


@functools.lru_cache(maxsize=None)
def reed_sol_van(k: int, m: int) -> np.ndarray:
    """(m, k) coding matrix: parity_i = sum_j M[i,j] * data_j."""
    dist = _systematize(extended_vandermonde(k + m, k), k)
    top = dist[:k]
    assert np.array_equal(top, np.eye(k, dtype=np.uint8)), \
        "systematic top block must be identity"
    return np.ascontiguousarray(dist[k:])


@functools.lru_cache(maxsize=None)
def cauchy_orig(k: int, m: int) -> np.ndarray:
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for cauchy at w=8")
    out = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[i, j] = tables.gf_inv(i ^ (m + j))
    return out


@functools.lru_cache(maxsize=None)
def cauchy_good(k: int, m: int) -> np.ndarray:
    c = cauchy_orig(k, m).copy()
    for j in range(k):
        e = int(c[0, j])
        if e != 1:
            c[:, j] = tables.gf_mul_np(c[:, j], tables.gf_inv(e))
    return c


@functools.lru_cache(maxsize=None)
def reed_sol_r6_op(k: int, m: int) -> np.ndarray:
    """RAID-6 optimized RS: P = XOR of data, Q = sum 2^i * d_i
    (ref: jerasure reed_sol.c reed_sol_r6_coding_matrix; m must be 2)."""
    if m != 2:
        raise ValueError(f"reed_sol_r6_op requires m=2, got {m}")
    out = np.ones((2, k), dtype=np.uint8)
    acc = 1
    for i in range(1, k):
        acc = tables.gf_mul(acc, 2)
        out[1, i] = acc
    return out


TECHNIQUES = {
    "reed_sol_van": reed_sol_van,
    "reed_sol_r6_op": reed_sol_r6_op,
    "cauchy_orig": cauchy_orig,
    "cauchy_good": cauchy_good,
    # ISA-L's two techniques are the same constructions
    # (ref: src/erasure-code/isa/ErasureCodeIsa.cc).
    "cauchy": cauchy_good,
}

# Techniques defined as raw GF(2) bitmatrices over w packets per chunk
# (see ceph_tpu_torch/ec/bitmatrix.py).
BITMATRIX_TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")


def coding_matrix(technique: str, k: int, m: int) -> np.ndarray:
    try:
        fn = TECHNIQUES[technique]
    except KeyError:
        raise ValueError(
            f"unknown technique {technique!r}; supported: "
            f"{sorted(TECHNIQUES)}") from None
    return fn(k, m)


def generator_matrix(technique: str, k: int, m: int) -> np.ndarray:
    """(k+m, k): identity stacked on the coding matrix (systematic code)."""
    return np.concatenate(
        [np.eye(k, dtype=np.uint8), coding_matrix(technique, k, m)], axis=0)


def decode_matrix(technique: str, k: int, m: int,
                  available: tuple[int, ...],
                  want: tuple[int, ...]) -> np.ndarray:
    """Rows reconstructing `want` chunk ids from `available` chunk ids.

    Returns (len(want), len(available)) GF matrix D with
    chunk[want] = D @ chunk[available].  available must contain >= k ids.
    This is the per-erasure-pattern inversion the reference caches
    (ref: src/erasure-code/isa/ErasureCodeIsaTableCache.cc).
    """
    g = generator_matrix(technique, k, m)
    avail = list(available)[:k]
    if len(avail) < k:
        raise ValueError(f"need {k} chunks to decode, have {len(available)}")
    sub = g[avail]                      # (k, k)
    inv = tables.gf_matinv_np(sub)      # data = inv @ chunks[avail]
    rows = g[list(want)]                # (w, k)
    d = tables.gf_matmul_np(rows, inv)  # (w, k) — over the k used chunks
    if len(available) > k:
        pad = np.zeros((len(want), len(available) - k), dtype=np.uint8)
        d = np.concatenate([d, pad], axis=1)
    return d
