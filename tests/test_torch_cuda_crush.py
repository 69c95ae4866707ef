"""The CRUSH kernel on the card against its plain version.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_crush.py -q

Placement is integer, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import builder, kernels, mapper_ref
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.types import ITEM_NONE, WEIGHT_ONE, ChooseArg

pytestmark = pytest.mark.cuda
W = WEIGHT_ONE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hier(n_hosts, per, n_racks=0, osd_weights=None, choose_args=False):
    m, root = builder.build_hierarchy(n_hosts, per, n_racks=n_racks,
                                      osd_weights=osd_weights)
    rid = builder.add_simple_rule(m, root, builder.TYPE_HOST)
    if choose_args:
        rng = np.random.default_rng(5)
        m.choose_args[0] = {
            bid: ChooseArg(weight_set=[[max(1, int(w * s)) for w, s in zip(
                b.weights, rng.uniform(0.9, 1.1, size=b.size))]])
            for bid, b in m.buckets.items()}
    return m, rid


def _flat(n, weights=None):
    m, root = builder.build_flat(n, weights=weights)
    return m, builder.add_simple_rule(m, root, builder.TYPE_OSD)


MAPS = {
    "uniform": (lambda: _hier(64, 8, n_racks=4), None, None, 3),
    "mixed": (lambda: _hier(32, 6, n_racks=4, osd_weights=[
        W * (1 + i % 3) for i in range(192)]), None, None, 3),
    "choose_args": (lambda: _hier(16, 4, n_racks=2, choose_args=True), None,
                    0, 3),
    "flat_firstn_osd": (lambda: _flat(40, [W + 977 * i for i in range(40)]),
                        None, None, 4),
    "reweights": (lambda: _hier(4, 2), [0x10000, 0x1000, 0x2000, 0x800,
                                        0x10000, 0x100, 0x3000, 0x10000],
                  None, 4),
    "wide_numrep": (lambda: _hier(40, 2), None, None, 12),
}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_kernel_matches_plain(cuda, name):
    build, weights, ca, numrep = MAPS[name]
    m, rid = build()
    dw = None if weights is None else np.asarray(weights, dtype=np.int64)
    pt = kernels.plan_tensors(kernels.build_plan(m, rid, dw, ca), cuda)
    xs = torch.arange(-5000, 60000, 3, dtype=torch.int32, device=cuda)
    before = kernels.crush_straw2.launches
    got, bad = kernels.crush_straw2(pt, xs, numrep)
    assert kernels.crush_straw2.launches == before + 1
    torch.cuda.synchronize()
    plain, plain_bad = kernels.crush_straw2_plain(pt, xs, numrep)
    assert torch.equal(got, plain) and torch.equal(bad, plain_bad)
    if name == "reweights":
        assert bool(bad.any())


@pytest.mark.parametrize("name", ["uniform", "choose_args", "reweights"])
def test_mapper_on_card_matches_scalar(cuda, name):
    build, weights, ca, numrep = MAPS[name]
    m, rid = build()
    mp = Mapper(m, None if weights is None else np.asarray(weights),
                choose_args=ca, device=cuda)
    xs = np.arange(0, 2 ** 32, 2 ** 32 // 512, dtype=np.int64)
    got, path = mp.map_pgs_path(rid, xs, numrep)
    assert path == "kernel"
    cargs = m.choose_args.get(ca) if ca is not None else None
    for i, x in enumerate(xs):
        want = mapper_ref.do_rule(m, rid, int(x), numrep, weights, cargs)
        want = want + [ITEM_NONE] * (numrep - len(want))
        assert got[i].tolist() == want


def test_kernel_launch_failure_raises(cuda):
    """numrep + SPEC_EXTRA beyond the kernel's candidate registers: the
    launch is refused and the wrapper raises (no fallback)."""
    m, rid = _hier(8, 2)
    pt = kernels.plan_tensors(kernels.build_plan(m, rid), cuda)
    xs = torch.arange(64, dtype=torch.int32, device=cuda)
    before = kernels.crush_straw2.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.crush_straw2(pt, xs, kernels.MAX_CAND)
    assert kernels.crush_straw2.launches == before
    with pytest.raises(ValueError):
        kernels.crush_straw2(pt, xs.cpu(), 3)


def test_kernel_plan_info_on_card(cuda):
    """The plan's launch facts on the card; nothing is launched."""
    m, rid = _hier(16, 4, n_racks=4)
    mp = Mapper(m, device=cuda)
    before = kernels.crush_straw2.launches
    info = mp.kernel_plan_info(rid, 3)
    assert mp.mapping_path(rid, 3) == "kernel"
    n_levels = mp.kernel_plan(rid).plan.n_levels
    assert info == {"fetches_per_sweep": 5 * n_levels,
                    "fetch_amortization": 1.0, "candidate_batched": False,
                    "kernel_lanes": kernels.THREADS, "candidate_fold": 1}
    assert kernels.crush_straw2.launches == before
    root = m.rules[rid].steps[0].arg1
    indep = builder.add_simple_rule(m, root, builder.TYPE_HOST, indep=True)
    assert Mapper(m, device=cuda).kernel_plan_info(indep, 3) is None
