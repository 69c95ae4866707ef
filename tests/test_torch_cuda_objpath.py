"""The port's erasure-coded object path on the card.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_objpath.py -q

Covered: ``ECBackendLite`` over the card's plugin with residency on
(writes, read-modify-writes, recovery, scrub), its stored parity held
against the kernel's plain version on the card and against the native
C++ backend (``plugin=isa``, independent); the resident ranges living on
the card; the layered plugins on the card against the same plugin on
the CPU; and the ``ec_daemon_path`` section on the card at a small
shape. Everything is integer, so the tolerance is byte equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.bench import ec_daemon_path
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.gf import kernels, tables
from ceph_tpu_torch.osd.ec_backend import (ECBackendLite,
                                           ec_backend_from_state,
                                           ec_backend_state)

pytestmark = pytest.mark.cuda

K, M, C = 8, 3, 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _backend(cfg=None):
    ec = factory(f"plugin=jax k={K} m={M} technique=reed_sol_van")
    return ECBackendLite(ec, chunk_size=C, name="cuda_objpath",
                         config=cfg)


def test_object_path_on_card_matches_plain_and_native(cuda):
    """A 1 MiB object, 64 unaligned RMWs, then every stripe's stored
    parity equals the kernel's plain version on the card and the native
    C++ backend; every launch went through the kernel."""
    be = _backend({"osd_ec_resident_bytes": 64 << 20})
    assert be.ec.device.type == "cuda"
    assert be.resident.device.type == "cuda"
    mirror = bytearray(_payload(1, 1 << 20))
    before = kernels.gf_encode.launches
    be.write("obj", 0, bytes(mirror))
    rng = np.random.default_rng(2)
    for _ in range(64):
        off = int(rng.integers(0, len(mirror) - 4096))
        data = _payload(int(off), 4096)
        be.write("obj", off, data)
        mirror[off:off + 4096] = data
    assert kernels.gf_encode.launches - before == 65
    assert be.read("obj", 0, len(mirror)) == bytes(mirror)
    n = be.sinfo.object_stripes(len(mirror))
    data = np.stack([be.shards[c]["obj"] for c in range(K)], axis=1)
    parity = np.stack([be.shards[K + p]["obj"] for p in range(M)], axis=1)
    bm = be.ec._encode_kernel.bitmatrix
    plain = kernels.gf_encode_plain(bm, torch.as_tensor(data, device=cuda))
    assert np.array_equal(plain.cpu().numpy(), parity)
    native = factory(f"plugin=isa k={K} m={M} technique=reed_sol_van")
    assert getattr(native, "independent", False) is True
    for s in range(0, n, 7):
        assert np.array_equal(native.encode_chunks(data[s]), parity[s])
    assert be.scrub("obj") == []


def test_recovery_and_scrub_on_card(cuda):
    """One data and one parity shard lost on several objects, rebuilt in
    one decode launch per object; a flipped byte is localized."""
    be = _backend()
    objs = {f"o{i}": _payload(10 + i, 300_000 + 4096 * i) for i in range(4)}
    for oid, data in objs.items():
        be.write(oid, 0, data)
    saved = {(s, o): be.shards[s][o].copy() for s in (2, 9) for o in objs}
    be.lose_shard(2)
    be.lose_shard(9)
    before = kernels.gf_encode.launches
    fixed = be.recover_all()
    assert kernels.gf_encode.launches - before == len(objs)
    assert fixed == {o: {2, 9} for o in objs}
    for (s, o), arr in saved.items():
        assert np.array_equal(be.shards[s][o], arr)
    for oid, data in objs.items():
        assert be.read(oid, 0, len(data)) == data
    be.shards[4]["o1"][3, 100] ^= 0x40
    be.shards[10]["o2"][0, 0] ^= 1
    assert be.scrub("o1") == [4]
    assert be.scrub("o2") == [10]
    assert be.scrub("o3") == []


def test_residency_generations_on_card(cuda):
    """Repeated reads hit the card-resident cache; a write bumps the
    generation, so the next read misses and sees the new bytes; the
    cache stays within its budget."""
    budget = 8 << 20
    be = _backend({"osd_ec_resident_bytes": budget})
    data = _payload(20, 1 << 20)
    be.write("obj", 0, data)
    assert be.read("obj", 0, len(data)) == data
    hits = be.resident.dump()["hits"]
    assert be.read("obj", 0, len(data)) == data
    assert be.resident.dump()["hits"] == hits + 1
    be.write("obj", 5, b"\x77" * 10)
    want = bytearray(data)
    want[5:15] = b"\x77" * 10
    assert be.read("obj", 0, len(data)) == bytes(want)
    d = be.resident.dump()
    assert d["invalidations"] >= 1 and d["resident_bytes"] <= budget
    key = next(iter(be.resident._lru))
    assert be.resident._lru[key][0].device.type == "cuda"


@pytest.mark.parametrize("profile,lost", [("plugin=lrc k=4 m=2 l=3", 0),
                                          ("plugin=shec k=8 m=4 c=3", 3)])
def test_layered_plugins_on_card_match_the_cpu(cuda, profile, lost):
    """LRC and SHEC on the card: write, lose a shard, recover through the
    local minimum_to_decode set; the shards equal the same plugin's on
    the CPU carried the same history."""
    be = ECBackendLite(factory(profile), chunk_size=C, name="cuda_layered")
    assert be.ec.device.type == "cuda"
    data = _payload(30, 200_000)
    be.write("obj", 0, data)
    cpu = ec_backend_from_state(factory(profile + " device=cpu"),
                                ec_backend_state(be), name="cpu_layered")
    be.lose_shard(lost, "obj")
    cpu.lose_shard(lost, "obj")
    _, to_read = be.recovery_plan("obj")
    assert len(to_read) < be.k
    assert be.recover("obj") == cpu.recover("obj") == {lost}
    for s in range(be.n):
        assert np.array_equal(be.shards[s]["obj"], cpu.shards[s]["obj"])
    assert be.read("obj", 0, len(data)) == data


def test_ec_daemon_path_on_card(cuda, monkeypatch):
    """The read-side bench on the card at a small shape: every leg's
    decode equals the numpy oracle's contract (positive rates), the
    record names the card."""
    monkeypatch.setenv("CEPH_TPU_BENCH_ECDAEMON_OPS", "8")
    monkeypatch.setenv("CEPH_TPU_BENCH_ECDAEMON_STRIPES", "4")
    rec = ec_daemon_path.ec_daemon_path_section(reps=1)
    assert rec["device"] == "cuda" and rec["platform"] == "gpu"
    assert rec["gpu_name"] == torch.cuda.get_device_name(0)
    assert rec["n_ops"] == 8 and rec["chunk_size"] == 4096
    assert rec["read_agg_batches"] >= 1
    for key in ("per_op_GiBs", "read_agg_GiBs", "resident_GiBs"):
        assert rec[key] > 0
    assert "cpu_caveat" not in rec


def test_decode_on_card_equals_numpy_oracle(cuda):
    """A recovered data shard equals the numpy oracle's decode matrix
    applied to the survivors (independent of the kernel)."""
    from ceph_tpu_torch.ec import matrix as rs
    be = _backend()
    data = _payload(40, K * C * 5)
    be.write("obj", 0, data)
    be.lose_shard(0, "obj")
    reads = sorted(be.recovery_plan("obj")[1])
    surv = np.stack([be.shards[s]["obj"] for s in reads])   # (k, S, C)
    d = rs.decode_matrix("reed_sol_van", K, M, tuple(reads), (0,))
    want = tables.gf_matmul_np(d, surv)[0]
    be.recover("obj")
    assert np.array_equal(be.shards[0]["obj"], want)
