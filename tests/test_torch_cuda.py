"""The port on the card: the CUDA kernel against its plain version,
through both entry points (``gf_encode`` and a plan's
``encode_batch_planned``).

Every test here needs a CUDA device and skips without one. The file
imports no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Everything is integer, so the tolerance is byte equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.gf import kernels, tables

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(rng, *shape) -> np.ndarray:
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


SHAPES = [(1, 8, 3, 4099), (2, 8, 3, 1), (2, 8, 3, 16 * 1024),
          (3, 5, 6, 17), (2, 10, 4, 4096), (1, 1, 1, 31),
          (2, 16, 9, 2048 + 5)]
# the shapes of the erasure-code paths: a 4 MiB object, a 4 KiB write,
# the flagship's 64 stripes of 4 MiB objects; and m = 9 at k = 8
PATH_SHAPES = [(128, 8, 3, 4096), (1, 8, 3, 4096), (64, 8, 3, 524288),
               (4, 8, 9, 4096)]


@pytest.mark.parametrize("B,k,m,C", SHAPES)
def test_kernel_matches_plain(cuda, B, k, m, C):
    rng = np.random.default_rng(B * 1000 + k * 100 + m * 10 + C)
    bm = torch.as_tensor(tables.expand_bitmatrix(_bytes(rng, m, k)),
                         device=cuda)
    data = torch.as_tensor(_bytes(rng, B, k, C), device=cuda)
    before = kernels.gf_encode.launches
    got = kernels.gf_encode(bm, data)
    assert kernels.gf_encode.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.gf_encode_plain(bm, data))


@pytest.mark.parametrize("B,k,m,C", SHAPES + PATH_SHAPES)
def test_planned_matches_raw_and_plain(cuda, B, k, m, C):
    rng = np.random.default_rng(B * 1000 + k * 100 + m * 10 + C + 1)
    bm_np = tables.expand_bitmatrix(_bytes(rng, m, k))
    plan = kernels.make_plan(bm_np, cuda)
    data = torch.as_tensor(_bytes(rng, B, k, C), device=cuda)
    before = kernels.gf_encode.launches
    got = kernels.encode_batch_planned(plan, data)
    assert kernels.gf_encode.launches == before + 1
    raw = kernels.gf_encode(plan.bitmatrix, data)
    assert kernels.gf_encode.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, raw)
    step = max(1, (32 << 20) // (k * C))
    for s in range(0, B, step):
        assert torch.equal(got[s:s + step], kernels.gf_encode_plain(
            plan.bitmatrix, data[s:s + step]))


def test_planned_random_bitmatrix_and_misaligned_pointer(cuda):
    rng = np.random.default_rng(8)
    plan = kernels.make_plan(
        rng.integers(0, 2, size=(40, 64), dtype=np.uint8), cuda)
    flat = torch.as_tensor(_bytes(rng, 2 * 8 * 4096 + 5), device=cuda)
    data = flat[5:].view(2, 8, 4096)
    before = kernels.gf_encode.launches
    got = kernels.encode_batch_planned(plan, data)
    assert kernels.gf_encode.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.gf_encode_plain(plan.bitmatrix, data))


def test_plan_words_on_the_card_equal_the_host_build(cuda):
    rng = np.random.default_rng(9)
    for k, m in ((8, 3), (8, 2), (16, 9), (1, 1)):
        bm = tables.expand_bitmatrix(_bytes(rng, m, k))
        plan = kernels.make_plan(bm, cuda)
        assert plan.words.device.type == "cuda" and plan.device == \
            plan.words.device
        assert np.array_equal(plan.words.cpu().numpy().view(np.uint32),
                              kernels.plan_words(bm))
        assert np.array_equal(plan.bitmatrix.cpu().numpy(), bm)


def test_planned_refuses(cuda):
    rng = np.random.default_rng(10)
    bm = tables.expand_bitmatrix(_bytes(rng, 2, 2))
    data = torch.zeros((1, 2, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kernels.encode_batch_planned(kernels.make_plan(bm, "cpu"), data)
    with pytest.raises(ValueError):
        kernels.encode_batch_planned(kernels.make_plan(bm, cuda),
                                     data.cpu())


def test_kernel_random_bitmatrix_and_misaligned_pointer(cuda):
    rng = np.random.default_rng(7)
    bm = torch.as_tensor(rng.integers(0, 2, size=(24, 32), dtype=np.uint8),
                         device=cuda)
    flat = torch.as_tensor(_bytes(rng, 2 * 4 * 4096 + 3), device=cuda)
    data = flat[3:].view(2, 4, 4096)
    got = kernels.gf_encode(bm, data)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.gf_encode_plain(bm, data))


def test_kernel_wrapper_refuses(cuda):
    bm = torch.ones((8, 16), dtype=torch.uint8, device=cuda)
    data = torch.zeros((1, 2, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kernels.gf_encode(bm.cpu(), data)
    with pytest.raises(ValueError):
        kernels.gf_encode(bm, data.transpose(1, 2).contiguous().transpose(
            1, 2))


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy_good",
                                       "reed_sol_r6_op", "liberation"])
def test_plugin_on_card(cuda, technique):
    m = 3 if technique in ("reed_sol_van", "cauchy_good") else 2
    ec = ErasureCodePluginRegistry.instance().factory(
        "jax", f"k=6 m={m} technique={technique}")
    assert ec.device.type == "cuda" and ec.backend == "kernel"
    rng = np.random.default_rng(3)
    data = _bytes(rng, 4, 6, 2 * ec.get_alignment())
    before = kernels.gf_encode.launches
    parity = ec.encode_batch(data)
    # the GF(2^8) techniques launch the kernel with the encode plan; the
    # array code (liberation) is a packet-plane product
    assert kernels.gf_encode.launches == before + (technique != "liberation")
    assert parity.device.type == "cuda"
    assert np.array_equal(parity.cpu().numpy(),
                          ec.encode_batch_reference(data))
    full = np.concatenate([data, parity.cpu().numpy()], axis=1)
    avail = [i for i in range(6 + m) if i not in (0, 6)][:6]
    got = ec.decode_batch([0, 6], avail, full[:, avail])
    assert np.array_equal(got.cpu().numpy(), full[:, [0, 6]])


@pytest.mark.parametrize("n,offset", [(1, 0), (4099, 0), (4099, 3),
                                      ((1 << 20) + 3, 5)])
def test_xor_anchor_on_card(cuda, n, offset):
    """The fold runs on the tensor's device and equals the host's XOR."""
    from ceph_tpu_torch.utils.timing import xor_anchor

    a = _bytes(np.random.default_rng(n + offset), n)
    x = torch.as_tensor(a, device=cuda)[offset:]
    got = xor_anchor(x)
    assert got.device == x.device and got.dtype == torch.uint8
    assert int(got) == int(np.bitwise_xor.reduce(a[offset:]))
    w = np.random.default_rng(n).integers(-2**15, 2**15, n).astype(np.int16)
    got = xor_anchor(torch.as_tensor(w, device=cuda)[offset:])
    assert got.device == x.device and got.dtype == torch.int32
    assert int(got) == int(np.bitwise_xor.reduce(
        w[offset:].astype(np.int32)))
