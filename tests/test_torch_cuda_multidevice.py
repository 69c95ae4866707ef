"""The multi-device layer on the card: a four-slot mesh on one card.

The sharded CRUSH paths (``crush.sharded_sweep``, ``Mapper(mesh=)``,
``OSDMapMapping(mesh=)``) and the sharded EC encode and decode are held
against the single-device kernel paths, and every ``crush_straw2`` and
``gf_encode`` launch against its plain version on the same inputs. Two
``parallel.multihost`` ranks share the card over gloo.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_multidevice.py -q

Placement and parity are integer, so the tolerance is exact equality.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ceph_tpu_torch.bench import crush_sweep, osdmaptool
from ceph_tpu_torch.crush import kernels as ckernels
from ceph_tpu_torch.crush import mapper as mapper_mod
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.sharded_sweep import sharded_map_pgs, sharded_sweep
from ceph_tpu_torch.ec import matrix as rs
from ceph_tpu_torch.gf import kernels as gkernels
from ceph_tpu_torch.gf import tables
from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
from ceph_tpu_torch.parallel import local_mesh, sharded_decode, sharded_encode
from ceph_tpu_torch.parallel.sharded import gather

pytestmark = pytest.mark.cuda
SLOTS = 4


@pytest.fixture
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return local_mesh(SLOTS, device="cuda:0")


@pytest.fixture
def checked(monkeypatch, card_mesh):
    """Every crush_straw2 and gf_encode launch held against its plain
    version on the same inputs; yields the launch counts."""
    real_c, real_g = ckernels.crush_straw2, gkernels.gf_encode
    seen = {"crush": 0, "gf": 0}

    def crush(pt, xs, numrep):
        leaves, bad = real_c(pt, xs, numrep)
        plain, plain_bad = ckernels.crush_straw2_plain(pt, xs, numrep)
        assert torch.equal(leaves, plain) and torch.equal(bad, plain_bad)
        seen["crush"] += 1
        return leaves, bad

    def gf(bm, data):
        out = real_g(bm, data)
        assert torch.equal(out, gkernels.gf_encode_plain(bm, data))
        seen["gf"] += 1
        return out
    real_planned = gkernels.encode_batch_planned

    def planned(plan, data):
        out = real_planned(plan, data)
        assert torch.equal(out, gkernels.gf_encode_plain(plan.bitmatrix,
                                                         data))
        seen["gf"] += 1
        return out
    monkeypatch.setattr(ckernels, "crush_straw2", crush)
    monkeypatch.setattr(gkernels, "gf_encode", gf)
    monkeypatch.setattr(gkernels, "encode_batch_planned", planned)
    return seen


def test_sharded_map_pgs_and_sweep_equal_the_kernel_path(card_mesh,
                                                         checked):
    mp = Mapper(crush_sweep.canonical_map(1024), device="cuda")
    n = (1 << 16) + 17
    xs = torch.arange(n, dtype=torch.int64, device="cuda")
    got = sharded_map_pgs(card_mesh, mp, 0, xs, 3)
    assert mp.last_map_path == "kernel+sharded"
    assert checked["crush"] == SLOTS
    assert torch.equal(got, mp.map_pgs(0, xs, 3))
    c, b = sharded_sweep(card_mesh, mp, 0, 12345, n, 3)
    c1, b1 = mp.sweep(0, 12345, n, 3)
    assert torch.equal(c, c1) and int(b) == int(b1)
    # the four slots share the Mapper's own tables: no copy was made
    assert mp._replicas == {}


def test_mapper_mesh_routes_and_osdmap_mapping(card_mesh, checked):
    from ceph_tpu_torch.utils.devmon import devmon
    m = osdmaptool.create_simple(1024, 8192, 3, erasure=False)
    before = devmon().perf.dump()["launches_sharded"]
    mm = OSDMapMapping(m, mesh=card_mesh, mesh_min_batch=1)
    assert mm.last_sharded_sweeps > 0
    assert devmon().perf.dump()["launches_sharded"] > before
    m.attach_mesh(None)
    plain = OSDMapMapping(m)
    assert plain.last_sharded_sweeps == 0
    for pid in m.pools:
        assert np.array_equal(mm._pools[pid].craw, plain._pools[pid].craw)
        assert np.array_equal(mm._pools[pid].acting,
                              plain._pools[pid].acting)


def test_sharded_kernel_failure_raises(card_mesh, monkeypatch):
    """On the card a kernel failure in the sharded path is counted and
    raised, never served by the rule VM."""
    def broken(pt, xs, numrep):
        raise RuntimeError("injected kernel failure")
    monkeypatch.setattr(ckernels, "crush_straw2", broken)
    mp = Mapper(crush_sweep.canonical_map(1024), device="cuda",
                mesh=card_mesh, mesh_min_batch=1)
    fails = mapper_mod.PERF.dump()["kernel_exec_failures"]
    with pytest.raises(RuntimeError, match="injected"):
        mp.map_pgs(0, np.arange(4096, dtype=np.uint32), 3)
    with pytest.raises(RuntimeError, match="injected"):
        mp.sweep(0, 0, 4096, 3)
    assert mapper_mod.PERF.dump()["kernel_exec_failures"] == fails + 2
    assert mp.mapping_path(0, 3) == "kernel"


def test_sharded_encode_and_decode(card_mesh, checked):
    k, m = 8, 3
    coding = rs.coding_matrix("reed_sol_van", k, m)
    bm = tables.expand_bitmatrix(coding)
    lo, hi = tables.nibble_tables(coding)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    data = torch.randint(0, 256, (16, k, 65536), dtype=torch.uint8,
                         device="cuda", generator=gen)
    parity = sharded_encode(card_mesh, bm, lo, hi, data)
    assert len(parity) == SLOTS and checked["gf"] == SLOTS
    whole = gkernels.gf_encode(torch.as_tensor(bm, device="cuda"), data)
    assert torch.equal(gather(parity), whole)
    erased, avail = (0, 9), tuple(i for i in range(k + m)
                                  if i not in (0, 9))[:k]
    dmat = rs.decode_matrix("reed_sol_van", k, m, avail, erased)
    full = torch.cat([data, whole], dim=1)
    rec = sharded_decode(card_mesh, tables.expand_bitmatrix(dmat),
                         *tables.nibble_tables(dmat),
                         full[:, list(avail)].contiguous())
    assert torch.equal(gather(rec), full[:, list(erased)])


def test_two_ranks_on_the_card(card_mesh):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.parallel.multihost",
         "--coordinator", coord, "--num-processes", "2",
         "--process-id", str(i), "--local-devices", str(SLOTS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=dict(os.environ))
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    a, b = outs
    assert a["ec_checksum"] == b["ec_checksum"]
    assert a["crush_placements"] == b["crush_placements"] == \
        3 * 256 * 2 * SLOTS
