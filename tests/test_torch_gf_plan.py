"""The encode kernel's plan held against ceph_tpu's field and kernel.

``gf.kernels.make_plan`` builds, once per coding matrix, the nibble-table
words that the CUDA kernel copies into shared memory. Here, on the CPU:
the words are each nibble's image under the bitmatrix (and, for a matrix
expanded from GF(2^8) coefficients, the field's products in
``ceph_tpu/gf/tables.py``); a numpy emulation of the kernel's lookups
that reads only the words equals the plain version and ceph_tpu's Pallas
kernel in interpret mode; ``encode_batch_planned`` runs the plain version
on the CPU and counts no launch; and the plugin's planned encode and
decode equal ``ErasureCodeJax``. Inputs are made with numpy from a seed;
everything is integer, so the tolerance is byte equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu.gf import pallas_kernels as pk
from ceph_tpu.gf import tables as jtables
from ceph_tpu_torch.ec import matrix
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.gf import kernels, tables

KS = [1, 3, 8, 10, 16]
MS = [1, 3, 4, 5, 9]


def _bytes(rng, *shape) -> np.ndarray:
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _bitmatrix(rng, k: int, m: int, kind: str):
    """(bitmatrix, coefficients or None): expanded from random GF(2^8)
    coefficients, or random 0/1 entries that no coding matrix makes."""
    if kind == "coding":
        coeffs = _bytes(rng, m, k)
        return jtables.expand_bitmatrix(coeffs), coeffs
    return rng.integers(0, 2, size=(8 * m, 8 * k), dtype=np.uint8), None


def _oracle(bm: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Any (8m, 8k) GF(2) matrix on (B, k, C) bytes, bit by bit: output
    bit b of row j is the parity of bm's row 8j+b over the input bits
    (bit b' of row i is column 8i+b')."""
    B, k, C = data.shape
    bits = (data[:, :, None, :] >> np.arange(8, dtype=np.uint8)[:, None]) & 1
    out_bits = np.einsum("rc,bcl->brl", bm.astype(np.int64),
                         bits.reshape(B, 8 * k, C).astype(np.int64)) & 1
    m = bm.shape[0] // 8
    return (out_bits.reshape(B, m, 8, C) << np.arange(8)[:, None]).sum(
        axis=2).astype(np.uint8)


def _emulate(words: np.ndarray, m: int, data: np.ndarray) -> np.ndarray:
    """The kernel's lookups in numpy, from the plan's words alone: for
    each input byte v of row i, word ^= tab[g][i][0][v & 15] ^
    tab[g][i][1][v >> 4]; output row 4g+j is byte j of the word."""
    groups, k = words.shape[:2]
    B, _, C = data.shape
    out = np.zeros((B, 4 * groups, C), dtype=np.uint8)
    for g in range(groups):
        acc = np.zeros((B, C), dtype=np.uint32)
        for i in range(k):
            v = data[:, i, :]
            acc ^= words[g, i, 0][v & 15] ^ words[g, i, 1][v >> 4]
        for j in range(4):
            out[:, 4 * g + j] = (acc >> (8 * j)) & 0xFF
    return out[:, :m]


@pytest.mark.parametrize("kind", ["coding", "random"])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
def test_plan_words_are_nibble_images(k, m, kind):
    rng = np.random.default_rng(100 * k + 10 * m + (kind == "random"))
    bm, coeffs = _bitmatrix(rng, k, m, kind)
    words = kernels.plan_words(bm)
    groups = -(-m // 4)
    assert words.dtype == np.uint32 and words.shape == (groups, k, 2, 16)
    # the images of every nibble in every position of every input row,
    # as 32 columns (16h + n) of a batch with one nonzero row each
    x = (np.arange(16)[None, :] << (4 * np.arange(2))[:, None]).reshape(32)
    data = np.zeros((k, k, 32), dtype=np.uint8)
    for i in range(k):
        data[i, i] = x
    images = _oracle(bm, data)                      # (i, m, 32)
    padded = np.zeros((k, 4 * groups, 32), dtype=np.uint32)
    padded[:, :m] = images
    want = np.zeros((groups, k, 32), dtype=np.uint32)
    for g in range(groups):
        for j in range(4):
            want[g] |= padded[:, 4 * g + j] << np.uint32(8 * j)
    assert np.array_equal(words.reshape(groups, k, 32), want)
    if coeffs is not None:
        mul = jtables.mul_table()
        for g in range(groups):
            for j in range(min(4, m - 4 * g)):
                for i in range(k):
                    prods = mul[coeffs[4 * g + j, i], x]
                    got = (words[g, i].reshape(32) >> np.uint32(8 * j)) & 0xFF
                    assert np.array_equal(got, prods)


@pytest.mark.parametrize("C", [1, 15, 4099])
@pytest.mark.parametrize("k,m,kind", [(8, 3, "coding"), (3, 9, "random"),
                                      (10, 4, "coding"), (1, 5, "random")])
def test_lookup_emulation_equals_plain(k, m, kind, C):
    rng = np.random.default_rng(7 * k + m + C)
    bm, _ = _bitmatrix(rng, k, m, kind)
    data = _bytes(rng, 2, k, C)
    got = _emulate(kernels.plan_words(bm), m, data)
    plain = kernels.gf_encode_plain(torch.as_tensor(bm),
                                    torch.as_tensor(data)).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, _oracle(bm, data))


@pytest.mark.parametrize("kind", ["coding", "random"])
def test_lookup_emulation_equals_pallas_interpret(kind):
    rng = np.random.default_rng(11)
    bm, _ = _bitmatrix(rng, 8, 3, kind)
    data = _bytes(rng, 2, 8, pk.TILE_L)
    want = np.asarray(pk.encode_batch_planned(pk.make_plan(bm), data,
                                              interpret=True))
    assert np.array_equal(_emulate(kernels.plan_words(bm), 3, data), want)
    plan = kernels.make_plan(bm, "cpu")
    got = kernels.encode_batch_planned(plan, torch.as_tensor(data))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m,C", [(8, 3, 4096), (5, 6, 17), (16, 9, 1)])
def test_planned_on_cpu_equals_gf_encode_and_counts_nothing(k, m, C):
    rng = np.random.default_rng(k + m + C)
    bm = jtables.expand_bitmatrix(_bytes(rng, m, k))
    data = torch.as_tensor(_bytes(rng, 3, k, C))
    plan = kernels.make_plan(bm, "cpu")
    assert (plan.k, plan.m, plan.device.type) == (k, m, "cpu")
    assert np.array_equal(plan.bitmatrix.numpy(), bm)
    assert np.array_equal(plan.words.numpy().view(np.uint32),
                          kernels.plan_words(bm))
    before = kernels.gf_encode.launches
    got = kernels.encode_batch_planned(plan, data)
    assert kernels.gf_encode.launches == before
    assert torch.equal(got, kernels.gf_encode(torch.as_tensor(bm), data))
    # a plan from the tensor form of the same matrix is the same plan
    again = kernels.make_plan(torch.as_tensor(bm), "cpu")
    assert torch.equal(again.words, plan.words)


def test_planned_refuses_bad_inputs():
    rng = np.random.default_rng(5)
    plan = kernels.make_plan(jtables.expand_bitmatrix(_bytes(rng, 3, 4)),
                             "cpu")
    with pytest.raises(ValueError):
        kernels.encode_batch_planned(plan, torch.zeros((1, 5, 64),
                                                       dtype=torch.uint8))
    with pytest.raises(ValueError):
        kernels.encode_batch_planned(plan, torch.zeros((1, 4, 64),
                                                       dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.plan_words(np.ones((12, 16), dtype=np.uint8))


def test_make_plan_takes_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bm = jtables.expand_bitmatrix(np.ones((2, 2), dtype=np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.make_plan(bm)
    assert kernels.make_plan(bm, "cpu").device.type == "cpu"


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy_good"])
def test_plugin_plans_equal_jax(technique, monkeypatch):
    prof = f"k=8 m=3 technique={technique}"
    mine = ErasureCodeTorch(prof, device="cpu")
    theirs = ErasureCodeJax(prof)
    calls = []
    real = kernels.encode_batch_planned

    def spy(plan, data):
        calls.append(plan)
        return real(plan, data)
    monkeypatch.setattr(kernels, "encode_batch_planned", spy)
    enc = mine._encode_kernel
    assert np.array_equal(
        enc.plan.words.numpy().view(np.uint32),
        kernels.plan_words(tables.expand_bitmatrix(
            matrix.coding_matrix(technique, 8, 3))))
    rng = np.random.default_rng(21)
    data = _bytes(rng, 3, 8, 2 * mine.get_alignment())
    parity = mine.encode_batch(data).numpy()
    assert np.array_equal(parity, np.asarray(theirs.encode_batch(data)))
    full = np.concatenate([data, parity], axis=1)
    want, avail = [0, 9], [1, 2, 3, 4, 5, 6, 7, 8]
    chunks = np.ascontiguousarray(full[:, avail])
    got = mine.decode_batch(want, avail, chunks).numpy()
    assert np.array_equal(got, full[:, want])
    assert np.array_equal(got, np.asarray(
        theirs.decode_batch(want, avail, chunks)))
    dec = mine._decode_cache[(tuple(avail), tuple(want))]
    assert [p is enc.plan for p in calls] == [True, False]
    assert calls[1] is dec.plan and (dec.plan.k, dec.plan.m) == (8, 2)
    # a second decode of the pattern reuses its plan
    mine.decode_batch(want, avail, chunks)
    assert calls[2] is dec.plan
