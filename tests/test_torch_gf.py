"""The port's GF(2^8) layer held against ceph_tpu's, byte for byte.

Same inputs, made with numpy from a seed, go through the JAX package (on
the CPU; its Pallas kernel in interpret mode) and through
``ceph_tpu_torch`` on the CPU. Everything is integer, so the tolerance
is byte equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import bitmatrix as jbitmatrix
from ceph_tpu.ec import matrix as jmatrix
from ceph_tpu.gf import ops as jops
from ceph_tpu.gf import pallas_kernels as pk
from ceph_tpu.gf import tables as jtables
from ceph_tpu_torch.ec import bitmatrix, matrix
from ceph_tpu_torch.gf import kernels, ops, tables

GF_TECHNIQUES = ["reed_sol_van", "cauchy_orig", "cauchy_good",
                 "reed_sol_r6_op", "cauchy"]
ARRAY_TECHNIQUES = ["liberation", "blaum_roth", "liber8tion"]


def _m_for(technique: str) -> int:
    return 2 if technique in ("reed_sol_r6_op", *ARRAY_TECHNIQUES) else 3


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _bytes(rng, *shape) -> np.ndarray:
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _bitmatrix_oracle(bm: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Any (8m, 8k) GF(2) matrix applied to (B, k, C) bytes, in numpy:
    output bit b of row j is the parity of bm's row 8j+b over the input
    bits (bit b' of chunk i is column 8i+b')."""
    B, k, C = data.shape
    bits = (data[:, :, None, :] >> np.arange(8, dtype=np.uint8)[:, None]) & 1
    bits = bits.reshape(B, 8 * k, C).astype(np.int64)
    out_bits = np.einsum("rc,bcl->brl", bm.astype(np.int64), bits) & 1
    m = bm.shape[0] // 8
    weights = (1 << np.arange(8))[:, None]
    return (out_bits.reshape(B, m, 8, C) * weights).sum(axis=2).astype(
        np.uint8)


# -- tables and matrices ------------------------------------------------------

def test_field_tables_equal():
    assert np.array_equal(tables.mul_table(), jtables.mul_table())
    assert np.array_equal(tables._coeff_bitmatrices(),
                          jtables._coeff_bitmatrices())
    for a, b in [(3, 7), (0, 9), (255, 254), (2, 128)]:
        assert tables.gf_mul(a, b) == jtables.gf_mul(a, b)
        assert tables.gf_pow(a, b) == jtables.gf_pow(a, b)
        if b:
            assert tables.gf_div(a, b) == jtables.gf_div(a, b)


def test_matinv_equal(rng):
    mat = matrix.generator_matrix("reed_sol_van", 5, 3)[[0, 2, 5, 6, 7]]
    assert np.array_equal(tables.gf_matinv_np(mat),
                          jtables.gf_matinv_np(mat))
    with pytest.raises(ValueError):
        tables.gf_matinv_np(np.zeros((3, 3), dtype=np.uint8))


@pytest.mark.parametrize("k", [3, 5, 8])
@pytest.mark.parametrize("technique", GF_TECHNIQUES)
def test_gf_matrices_equal(technique, k):
    m = _m_for(technique)
    coding = matrix.coding_matrix(technique, k, m)
    assert np.array_equal(coding, jmatrix.coding_matrix(technique, k, m))
    assert np.array_equal(tables.expand_bitmatrix(coding),
                          jtables.expand_bitmatrix(coding))
    for mine, theirs in zip(tables.nibble_tables(coding),
                            jtables.nibble_tables(coding)):
        assert np.array_equal(mine, theirs)
    avail = tuple(range(m, m + k))
    want = tuple(range(m))
    assert np.array_equal(
        matrix.decode_matrix(technique, k, m, avail, want),
        jmatrix.decode_matrix(technique, k, m, avail, want))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("technique", ARRAY_TECHNIQUES)
def test_array_code_bitmatrices_equal(technique, k):
    w = bitmatrix.default_w(technique, k)
    assert w == jbitmatrix.default_w(technique, k)
    bm = bitmatrix.bitmatrix_for(technique, k, 2, w)
    assert np.array_equal(bm, jbitmatrix.bitmatrix_for(technique, k, 2, w))
    avail, want = tuple(range(2, k + 2)), (0, 1)
    assert np.array_equal(
        bitmatrix.decode_bitmatrix(bm, k, 2, w, avail, want),
        jbitmatrix.decode_bitmatrix(bm, k, 2, w, avail, want))


# -- plain torch ops ----------------------------------------------------------

def test_unpack_pack_bits_equal(rng):
    data = _bytes(rng, 3, 257)
    bits = ops.unpack_bits(torch.from_numpy(data))
    assert bits.dtype == torch.int8
    assert np.array_equal(_np(bits), np.asarray(jops.unpack_bits(data)))
    assert np.array_equal(_np(ops.pack_bits(bits)),
                          np.asarray(jops.pack_bits(np.asarray(_np(bits)))))
    assert np.array_equal(_np(ops.pack_bits(bits)), data)


@pytest.mark.parametrize("op", ["bitplanes", "lut", "bytes"])
def test_gf_matmul_equal(rng, op):
    coding = _bytes(rng, 3, 5)
    data = _bytes(rng, 5, 300)
    bm = tables.expand_bitmatrix(coding)
    lo, hi = tables.nibble_tables(coding)
    t = torch.from_numpy
    if op == "bitplanes":
        got = ops.gf_matmul_bitplanes(t(bm), t(data))
        want = jops.gf_matmul_bitplanes(bm, data)
    elif op == "lut":
        got = ops.gf_matmul_lut(t(lo), t(hi), t(data))
        want = jops.gf_matmul_lut(lo, hi, data)
    else:
        got = ops.gf_matmul_bytes(t(coding), t(data))
        want = jops.gf_matmul_bytes(coding, data)
    assert np.array_equal(_np(got), np.asarray(want))
    assert np.array_equal(_np(got), tables.gf_matmul_np(coding, data))


def test_bitplane_sum_does_not_wrap(rng):
    # 8k = 256 ones per row: an int8 accumulator would wrap to 0 and an
    # odd count would read even; the float32 sum is exact.
    k = 32
    bm = np.ones((8, 8 * k), dtype=np.uint8)
    data = np.full((k, 4), 255, dtype=np.uint8)
    data[0, 1] = 254
    got = _np(ops.gf_matmul_bitplanes(torch.from_numpy(bm),
                                      torch.from_numpy(data)))
    assert np.array_equal(got, np.asarray(jops.gf_matmul_bitplanes(bm, data)))


def test_gf2_matmul_bytes_equal(rng):
    bm = rng.integers(0, 2, size=(6, 10), dtype=np.uint8)
    planes = _bytes(rng, 10, 64)
    got = ops.gf2_matmul_bytes(torch.from_numpy(bm), torch.from_numpy(planes))
    assert np.array_equal(_np(got),
                          np.asarray(jops.gf2_matmul_bytes(bm, planes)))


def test_bitmatrix_encode_stripes_equal(rng):
    k, w = 4, 5
    bm = bitmatrix.liberation_bitmatrix(k, w)
    data = _bytes(rng, 3, k, 10 * w)
    got = ops.bitmatrix_encode_stripes(torch.from_numpy(bm),
                                       torch.from_numpy(data), w)
    want = jops.bitmatrix_encode_stripes(bm.astype(np.int8), data, w)
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("backend", ["bitmatmul", "lut"])
def test_encode_stripes_equal(rng, backend):
    coding = matrix.reed_sol_van(4, 2)
    bm = tables.expand_bitmatrix(coding)
    lo, hi = tables.nibble_tables(coding)
    data = _bytes(rng, 3, 4, 130)
    t = torch.from_numpy
    got = ops.encode_stripes(t(bm), t(lo), t(hi), t(data), backend=backend)
    want = jops.encode_stripes(bm.astype(np.int8), lo, hi, data,
                               backend=backend)
    assert np.array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError):
        ops.encode_stripes(t(bm), t(lo), t(hi), t(data), backend="nope")


# -- the kernel's plain version --------------------------------------------------

def test_plain_matches_pallas_interpret(rng):
    """At the shape tests/test_gf.py runs the Pallas kernel in interpret
    mode: k=8, m=3, B=2, C=32768."""
    coding = _bytes(rng, 3, 8)
    bm = tables.expand_bitmatrix(coding)
    data = _bytes(rng, 2, 8, pk.TILE_L)
    want = np.asarray(pk.encode_batch_planned(pk.make_plan(bm), data,
                                              interpret=True))
    got = kernels.gf_encode(torch.from_numpy(bm), torch.from_numpy(data))
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("C", [1, 15, 1000 + 3])
def test_plain_matches_encode_stripes_unaligned(rng, C):
    coding = matrix.reed_sol_van(8, 3)
    bm = tables.expand_bitmatrix(coding)
    lo, hi = tables.nibble_tables(coding)
    data = _bytes(rng, 2, 8, C)
    want = np.asarray(jops.encode_stripes(bm.astype(np.int8), lo, hi, data))
    got = kernels.gf_encode_plain(torch.from_numpy(bm), torch.from_numpy(data))
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("k,m", [(3, 5), (8, 3), (6, 1)])
def test_plain_random_bitmatrix_matches_oracle(rng, k, m):
    """Any GF(2) bitmatrix, not only the expansion of a GF(2^8) matrix."""
    bm = rng.integers(0, 2, size=(8 * m, 8 * k), dtype=np.uint8)
    data = _bytes(rng, 2, k, 77)
    got = kernels.gf_encode(torch.from_numpy(bm), torch.from_numpy(data))
    assert np.array_equal(_np(got), _bitmatrix_oracle(bm, data))


def test_oracle_agrees_with_gf_matmul_np(rng):
    coding = _bytes(rng, 3, 4)
    data = _bytes(rng, 2, 4, 33)
    want = np.stack([tables.gf_matmul_np(coding, d) for d in data])
    assert np.array_equal(
        _bitmatrix_oracle(tables.expand_bitmatrix(coding), data), want)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing(rng):
    bm = torch.from_numpy(tables.expand_bitmatrix(_bytes(rng, 2, 3)))
    data = torch.from_numpy(_bytes(rng, 1, 3, 40))
    before = kernels.gf_encode.launches
    out = kernels.gf_encode(bm, data)
    assert out.shape == (1, 2, 40) and out.dtype == torch.uint8
    assert kernels.gf_encode.launches == before


def test_wrapper_rejects_bad_inputs(rng):
    bm = torch.from_numpy(tables.expand_bitmatrix(_bytes(rng, 2, 3)))
    data = torch.from_numpy(_bytes(rng, 1, 3, 40))
    with pytest.raises(ValueError):
        kernels.gf_encode(bm, data.to(torch.int32))
    with pytest.raises(ValueError):
        kernels.gf_encode(bm, data[0])
    with pytest.raises(ValueError):
        kernels.gf_encode(bm[:, :16], data)
    # a tensor that is neither on the CPU nor on CUDA is refused, never
    # computed by the plain version
    with pytest.raises(ValueError):
        kernels.gf_encode(bm.to("meta"), data.to("meta"))
