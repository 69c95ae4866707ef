"""The port's meshes and sharded pipelines held against ceph_tpu's.

The counterparts of ``tests/test_parallel.py`` (but its two
``__graft_entry__`` cases, the JAX package's own entry hook): the port's
``parallel`` on ``local_mesh(8, device="cpu")`` (the encode kernel's
plain version on each slot) beside ceph_tpu's on the 8-device virtual
CPU mesh, on the same numpy inputs. Parity, decodes and placements are
integer, so the tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu import parallel as ref_parallel
from ceph_tpu.bench.crush_sweep import canonical_map as ref_canonical_map
from ceph_tpu.crush.mapper import Mapper as RefMapper
from ceph_tpu.ec import matrix as ref_rs
from ceph_tpu.gf import gf_matmul_np
from ceph_tpu.gf import tables as ref_tables
from ceph_tpu_torch.bench.crush_sweep import canonical_map
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.ec import matrix as rs
from ceph_tpu_torch.gf import tables
from ceph_tpu_torch.parallel import (
    local_mesh, make_mesh, sharded_crush_sweep, sharded_decode,
    sharded_encode,
)
from ceph_tpu_torch.parallel.sharded import gather, shard_batch


@pytest.fixture(scope="module")
def mesh():
    return local_mesh(8, device="cpu")


def _ref_operands(coding):
    bitmatrix = jnp.asarray(ref_tables.expand_bitmatrix(coding), jnp.int8)
    lo, hi = map(jnp.asarray, ref_tables.nibble_tables(coding))
    return bitmatrix, lo, hi


def _operands(coding):
    lo, hi = tables.nibble_tables(coding)
    return tables.expand_bitmatrix(coding), lo, hi


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8 == ref_parallel.local_mesh().devices.size
    assert mesh.shape == {"shard": 8}
    # slots may repeat a device: all eight run on the CPU
    assert {str(d) for d in mesh.devices.reshape(-1)} == {"cpu"}
    assert [i for i, _ in mesh.slots()] == list(range(8))


def test_make_mesh_shape_mismatch():
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 8, axes=("a", "b"), shape=(3, 2))
    with pytest.raises(ValueError):
        ref_parallel.make_mesh(jax.devices(), axes=("a", "b"), shape=(3, 2))
    two = make_mesh(["cpu"] * 8, axes=("a", "b"), shape=(4, 2))
    assert two.shape == {"a": 4, "b": 2} and two.size == 8


def test_sharded_encode_matches_oracle(mesh, rng):
    k, m = 4, 2
    coding = rs.coding_matrix("reed_sol_van", k, m)
    assert np.array_equal(coding,
                          ref_rs.coding_matrix("reed_sol_van", k, m))
    data = rng.integers(0, 256, size=(16, k, 128), dtype=np.uint8)
    parts = sharded_encode(mesh, *_operands(coding), data)
    # the output stays on the slots: one part of two stripes each
    assert len(parts) == 8 and all(p.shape == (2, m, 128) for p in parts)
    out = gather(parts).numpy()
    theirs = np.asarray(ref_parallel.sharded_encode(
        ref_parallel.local_mesh(), *_ref_operands(coding),
        jnp.asarray(data)))
    assert np.array_equal(out, theirs)
    for b in range(16):
        assert np.array_equal(out[b], gf_matmul_np(coding, data[b]))


def test_sharded_roundtrip(mesh, rng):
    k, m = 8, 3
    coding = rs.coding_matrix("reed_sol_van", k, m)
    data_np = rng.integers(0, 256, size=(8, k, 128), dtype=np.uint8)
    data = shard_batch(mesh, data_np)
    parity = sharded_encode(mesh, *_operands(coding), data)
    # full stripes, still one part per slot
    full = tuple(torch.cat([d, p], dim=1) for d, p in zip(data, parity))
    erased = (1, 8, 10)
    avail = tuple(i for i in range(k + m) if i not in erased)[:k]
    dmat = rs.decode_matrix("reed_sol_van", k, m, avail, erased)
    assert np.array_equal(dmat, ref_rs.decode_matrix(
        "reed_sol_van", k, m, avail, erased))
    rec = sharded_decode(mesh, *_operands(dmat),
                         tuple(f[:, list(avail)].contiguous() for f in full))
    got = gather(rec).numpy()
    want = gather(full).numpy()[:, list(erased)]
    assert np.array_equal(got, want)
    # the reference's sharded round trip gives the same chunks
    ref_mesh = ref_parallel.local_mesh()
    rfull = jnp.concatenate([jnp.asarray(data_np), ref_parallel.sharded_encode(
        ref_mesh, *_ref_operands(coding), jnp.asarray(data_np))], axis=1)
    rrec = ref_parallel.sharded_decode(ref_mesh, *_ref_operands(dmat),
                                       rfull[:, jnp.asarray(avail), :])
    assert np.array_equal(got, np.asarray(rrec))


def test_sharded_encode_uneven_batch(mesh, rng):
    """A batch that does not divide by the slots: the first parts take
    one more stripe; the gathered parity equals one encode."""
    coding = rs.coding_matrix("reed_sol_van", 4, 2)
    data = rng.integers(0, 256, size=(13, 4, 64), dtype=np.uint8)
    parts = sharded_encode(mesh, *_operands(coding), data)
    assert [p.shape[0] for p in parts] == [2] * 5 + [1] * 3
    whole = sharded_encode(local_mesh(1, device="cpu"),
                           *_operands(coding), data)
    assert torch.equal(gather(parts), gather(whole))
    with pytest.raises(ValueError):
        sharded_encode(mesh, *_operands(coding), parts[:3])


class TestShardedCrush:
    def test_sharded_sweep_matches_single_device(self, mesh):
        """The multi-device CRUSH sweep agrees exactly with Mapper.sweep
        and with the reference's sharded sweep on the same map."""
        mp = Mapper(canonical_map(256), block=1 << 11, device="cpu")
        c, b = sharded_crush_sweep(mesh, mp, 0, 0, 8192, 3)
        c1, b1 = mp.sweep(0, 0, 8192, 3)
        assert torch.equal(c, c1) and int(b) == int(b1)
        assert int(c.sum()) == 3 * 8192
        rmp = RefMapper(ref_canonical_map(256), block=1 << 11)
        rc, rb = ref_parallel.sharded_crush_sweep(
            ref_parallel.local_mesh(8), rmp, 0, 0, 8192, 3)
        assert np.array_equal(c.numpy(), np.asarray(rc))
        assert int(b) == int(rb)

    def test_uneven_n_rejected(self, mesh):
        mp = Mapper(canonical_map(64), block=1 << 10, device="cpu")
        with pytest.raises(ValueError):
            sharded_crush_sweep(mesh, mp, 0, 0, 1001, 3)
        with pytest.raises(ValueError):
            ref_parallel.sharded_crush_sweep(
                ref_parallel.local_mesh(8),
                RefMapper(ref_canonical_map(64), block=1 << 10),
                0, 0, 1001, 3)


def test_multichip_bench_record():
    """bench.multichip on the CPU: the table at 1, 2 and 4 slots and the
    crush_multichip record, with the reference's keys and its counts."""
    from ceph_tpu.bench import multichip as ref_multichip
    from ceph_tpu_torch.bench import multichip

    out = multichip.main(["--device", "cpu", "--max-devices", "4",
                          "--crush-pgs", "4096", "--chunk", "1024",
                          "--batch", "8", "--num-osds", "1024"])
    assert out["platform"] == "cpu"
    assert [r["devices"] for r in out["table"]] == [1, 2, 4]
    rec = out["crush_multichip"]
    assert rec["path"] == "kernel-plain+sharded" and rec["n_devices"] == 4
    ref = ref_multichip.measured_sweep(
        ref_parallel.local_mesh(4), RefMapper(ref_canonical_map(1024)),
        4096, reps=1)
    assert set(rec) == set(ref)
    for key in ("measured", "n_pgs", "num_rep", "n_osds", "extrapolated",
                "bad_mappings", "placements", "platform"):
        assert rec[key] == ref[key], key
