"""The port on the card: the CUDA kernel against its plain version.

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


@pytest.mark.parametrize("B,k,m,C", [
    (1, 8, 3, 4099), (2, 8, 3, 1), (2, 8, 3, 16 * 1024), (3, 5, 6, 17),
    (2, 10, 4, 4096), (1, 1, 1, 31), (2, 16, 9, 2048 + 5)])
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
    parity = ec.encode_batch(data)
    assert parity.device.type == "cuda"
    assert np.array_equal(parity.cpu().numpy(),
                          ec.encode_batch_reference(data))
    full = np.concatenate([data, parity.cpu().numpy()], axis=1)
    avail = [i for i in range(6 + m) if i not in (0, 6)][:6]
    got = ec.decode_batch([0, 6], avail, full[:, avail])
    assert np.array_equal(got.cpu().numpy(), full[:, [0, 6]])
