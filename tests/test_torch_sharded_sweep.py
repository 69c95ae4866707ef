"""The port's mesh-sharded CRUSH sweep held against ceph_tpu's.

The counterparts of ``tests/test_sharded_sweep.py``: the same maps,
built through each package's builder from the same arguments and seeds
(their encoded bytes equal), go through the port's
``crush.sharded_sweep`` on ``local_mesh(8, device="cpu")`` (eight slots
on the CPU: the kernel's plain version and the rule VM) and through
ceph_tpu's on the 8-device virtual CPU mesh that ``tests/conftest.py``
forces, and through both packages' single-device ``Mapper``. Placement
is integer, so the tolerance is exact equality throughout.

The reference's costs are XLA compiles of 8-shard programs, so the
tests share one module-scope map and its reference tables.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as rbuilder
from ceph_tpu.crush import mapper_ref
from ceph_tpu.crush.mapper import Mapper as RefMapper
from ceph_tpu.crush.sharded_sweep import (
    sharded_map_pgs as ref_sharded_map_pgs,
    sharded_sweep as ref_sharded_sweep,
)
from ceph_tpu.crush.types import ChooseArg as RefChooseArg
from ceph_tpu.crush.types import ITEM_NONE, WEIGHT_ONE
from ceph_tpu.encoding import encode_crush_map as ref_encode_crush_map
from ceph_tpu.parallel import local_mesh as ref_local_mesh
from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.sharded_sweep import sharded_map_pgs, sharded_sweep
from ceph_tpu_torch.crush.types import ChooseArg, Tunables
from ceph_tpu_torch.encoding import encode_crush_map
from ceph_tpu_torch.parallel import local_mesh
from ceph_tpu_torch.utils.devmon import devmon

N = 8 * 97          # shard-boundary-rich, non-divisible by block


@pytest.fixture(scope="module")
def mesh():
    m = local_mesh(8, device="cpu")
    assert m.devices.size == 8
    return m


@pytest.fixture(scope="module")
def ref_mesh():
    m = ref_local_mesh()
    assert m.devices.size == 8
    return m


def _hier(n_hosts, per_host, weights=None):
    """(reference map, port map, rule): the same hierarchy through each
    package's builder."""
    kw = dict(n_racks=max(1, n_hosts // 4), osd_weights=weights)
    rm, rroot = rbuilder.build_hierarchy(n_hosts, per_host, **kw)
    rrid = rbuilder.add_simple_rule(rm, rroot, rbuilder.TYPE_HOST)
    m, root = builder.build_hierarchy(n_hosts, per_host, **kw)
    rid = builder.add_simple_rule(m, root, builder.TYPE_HOST)
    assert rid == rrid and encode_crush_map(m) == ref_encode_crush_map(rm)
    return rm, m, rid


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def hier(mesh, ref_mesh):
    """One shared map, its port Mapper and the reference's tables:
    single-device and sharded, over N lanes and the 757-PG sweep."""
    rm, m, rid = _hier(8, 4)
    rmp = RefMapper(rm, block=1 << 10)
    xs = np.arange(N, dtype=np.uint32)
    want = np.asarray(rmp.map_pgs(rid, xs, 3))
    assert (np.asarray(ref_sharded_map_pgs(ref_mesh, rmp, rid, xs, 3))
            == want).all()
    rc, rb = rmp.sweep(rid, 0, 757, 3)
    rsc, rsb = ref_sharded_sweep(ref_mesh, rmp, rid, 0, 757, 3)
    assert (np.asarray(rc) == np.asarray(rsc)).all() and int(rb) == int(rsb)
    mp = Mapper(m, block=1 << 10, device="cpu")
    return {"rm": rm, "m": m, "rid": rid, "rmp": rmp, "mp": mp,
            "want": want, "sweep": (np.asarray(rc), int(rb))}


def _assert_rows_match_ref(rm, rid, got, xs, numrep, weights=None,
                           choose_args=None):
    wl = list(weights) if weights is not None else None
    for i, x in enumerate(xs):
        ref = mapper_ref.do_rule(rm, rid, int(x), numrep, weight=wl,
                                 choose_args=choose_args)
        ref = ref + [ITEM_NONE] * (numrep - len(ref))
        assert list(got[i]) == ref, (int(x), list(got[i]), ref)


class TestBitExact:
    def test_map_pgs_matches_single_device_and_ref_at_boundaries(
            self, mesh, hier):
        """Shard-boundary PG ids do not smear: the whole table equals the
        port's and the reference's single-device and sharded tables, and
        the lanes at every shard edge equal the scalar spec."""
        h = hier
        xs = np.arange(N, dtype=np.uint32)
        got = _np(sharded_map_pgs(mesh, h["mp"], h["rid"], xs, 3))
        assert h["mp"].last_map_path == "kernel-plain+sharded"
        assert (got == h["want"]).all()
        assert (got == _np(h["mp"].map_pgs(h["rid"], xs, 3))).all()
        local_n = N // 8
        edges = sorted({0, N - 1} | {
            b for s in range(1, 8) for b in
            (s * local_n - 1, s * local_n)})
        _assert_rows_match_ref(h["rm"], h["rid"], got[edges], xs[edges], 3)

    def test_non_divisible_batch_padding(self, mesh, hier):
        """n % slots != 0 pads (map) / leaves the tail out (sweep): both
        entry points equal the reference's at an awkward size."""
        h = hier
        n = 757                           # prime: 757 % 8 == 5
        xs = np.arange(n, dtype=np.uint32)
        got = _np(sharded_map_pgs(mesh, h["mp"], h["rid"], xs, 3))
        assert (got == h["want"][:n]).all()
        c, b = sharded_sweep(mesh, h["mp"], h["rid"], 0, n, 3)
        assert (_np(c) == h["sweep"][0]).all() and int(b) == h["sweep"][1]
        c1, b1 = h["mp"].sweep(h["rid"], 0, n, 3)
        assert torch.equal(c, c1) and int(b) == int(b1)

    def test_randomized_sweep(self, mesh, ref_mesh, hier, rng):
        """Randomized PG ids (not a contiguous range) through both
        packages' sharded full-mapping paths and the single-device one."""
        h = hier
        xs = rng.integers(0, 1 << 31, size=N).astype(np.uint32)
        got = _np(sharded_map_pgs(mesh, h["mp"], h["rid"], xs, 3))
        want = np.asarray(ref_sharded_map_pgs(ref_mesh, h["rmp"], h["rid"],
                                              xs, 3))
        assert (got == want).all()
        assert (got == np.asarray(h["rmp"].map_pgs(h["rid"], xs, 3))).all()
        # seeds near 2^32: each shard's base wraps as uint32
        c, b = sharded_sweep(mesh, h["mp"], h["rid"], (1 << 32) - 300,
                             757, 3)
        rc, rb = ref_sharded_sweep(ref_mesh, h["rmp"], h["rid"],
                                   (1 << 32) - 300, 757, 3)
        assert (_np(c) == np.asarray(rc)).all() and int(b) == int(rb)

    def test_zero_weight_slots(self, mesh, ref_mesh):
        """Zero-weight OSDs (dead slots in their host buckets) are never
        chosen, sharded or not, in either package."""
        weights = [0 if i % 5 == 0 else WEIGHT_ONE for i in range(16)]
        rm, m, rid = _hier(4, 4, weights=weights)
        xs = np.arange(203, dtype=np.uint32)
        got = _np(sharded_map_pgs(mesh, Mapper(m, block=1 << 10,
                                               device="cpu"), rid, xs, 3))
        rmp = RefMapper(rm, block=1 << 10)
        assert (got == np.asarray(rmp.map_pgs(rid, xs, 3))).all()
        assert (got == np.asarray(ref_sharded_map_pgs(
            ref_mesh, rmp, rid, xs, 3))).all()
        dead = [i for i in range(16) if weights[i] == 0]
        assert not (np.isin(got, dead)).any()
        _assert_rows_match_ref(rm, rid, got[:16], xs[:16], 3)

    def test_choose_args_weight_sets(self, mesh, ref_mesh):
        """A balancer-style single-position choose_args weight-set rides
        the sharded path in both packages (the port's kernel plan takes
        one weight set, so this is its kernel; the reference's XLA VM)."""
        rm, m, rid = _hier(4, 5)
        rng = np.random.default_rng(7)
        sets = {}
        for bid, b in rm.buckets.items():
            scale = rng.uniform(0.9, 1.1, size=b.size)
            sets[bid] = [max(1, int(w * s))
                         for w, s in zip(b.weights, scale)]
        rm.choose_args[0] = {bid: RefChooseArg(weight_set=[ws])
                             for bid, ws in sets.items()}
        m.choose_args[0] = {bid: ChooseArg(weight_set=[list(ws)])
                            for bid, ws in sets.items()}
        assert encode_crush_map(m) == ref_encode_crush_map(rm)
        mp = Mapper(m, block=1 << 10, choose_args=0, device="cpu")
        xs = np.arange(203, dtype=np.uint32)
        got = _np(sharded_map_pgs(mesh, mp, rid, xs, 3))
        assert mp.last_map_path == "kernel-plain+sharded"
        rmp = RefMapper(rm, block=1 << 10, choose_args=0)
        assert (got == np.asarray(rmp.map_pgs(rid, xs, 3))).all()
        assert (got == np.asarray(ref_sharded_map_pgs(
            ref_mesh, rmp, rid, xs, 3))).all()
        _assert_rows_match_ref(rm, rid, got[:16], xs[:16], 3,
                               choose_args=rm.choose_args[0])

    def test_legacy_tunables_rejected(self, mesh, ref_mesh):
        """Legacy tunables cannot shard, in either package, with the
        same error."""
        from ceph_tpu.crush.types import Tunables as RefTunables
        rm, m, rid = _hier(4, 2)
        rm.tunables = RefTunables(chooseleaf_stable=0)
        m.tunables = Tunables(chooseleaf_stable=0)
        mp, rmp = Mapper(m, device="cpu"), RefMapper(rm)
        xs = np.arange(64, dtype=np.uint32)
        for fn, rfn, args in (
                (sharded_map_pgs, ref_sharded_map_pgs, (rid, xs, 3)),
                (sharded_sweep, ref_sharded_sweep, (rid, 0, 64, 3))):
            with pytest.raises(ValueError) as mine:
                fn(mesh, mp, *args)
            with pytest.raises(ValueError) as theirs:
                rfn(ref_mesh, rmp, *args)
            assert str(mine.value) == str(theirs.value)


class TestKernelPath:
    """The port's kernel (its plain version here) through the sharded
    path, including lanes it flags to the rule VM."""

    def test_ambiguity_flagged_lanes_bit_exact(self, mesh, ref_mesh,
                                               monkeypatch):
        """Most OSDs reweighted toward 0: the kernel runs out of
        candidates and flags lanes in every shard, which the rule VM
        recomputes; the sharded rows equal the scalar spec and the
        reference's sharded kernel path (interpret mode, every lane
        flagged to its fallback as in the reference's test)."""
        from ceph_tpu.crush import pallas_mapper as pm
        monkeypatch.setenv("CEPH_TPU_CRUSH_KERNEL", "interpret")
        monkeypatch.setattr(pm, "MARGIN_ABS", 1e30)
        weights = [WEIGHT_ONE + 991 * i for i in range(8)]
        rm, rroot = rbuilder.build_flat(8, weights=weights)
        rid = rbuilder.add_simple_rule(rm, rroot, rbuilder.TYPE_OSD)
        m, root = builder.build_flat(8, weights=weights)
        assert builder.add_simple_rule(m, root, builder.TYPE_OSD) == rid
        devw = np.array([WEIGHT_ONE if i < 4 else 0x800
                         for i in range(8)], dtype=np.int64)
        mp = Mapper(m, device_weights=devw, block=1 << 8, device="cpu")
        xs = np.arange(130, dtype=np.uint32)
        got = _np(sharded_map_pgs(mesh, mp, rid, xs, 3))
        assert mp.last_map_path == "kernel-plain+sharded"
        assert mp.flagged_lanes > 0
        _assert_rows_match_ref(rm, rid, got, xs, 3, weights=devw)
        rmp = RefMapper(rm, device_weights=devw, block=1 << 8)
        assert rmp._kernel_body(rid, 3) is not None
        assert (got == np.asarray(ref_sharded_map_pgs(
            ref_mesh, rmp, rid, xs, 3))).all()

    def test_kernel_sharded_bit_exact(self, mesh):
        """The kernel's lanes through the sharded path equal the
        single-device kernel engine, which flags the same lanes, and the
        reference's XLA table."""
        rm, m, rid = _hier(4, 4)
        mp = Mapper(m, block=1 << 9, device="cpu")
        assert mp.kernel_plan(rid) is not None
        xs = np.arange(257, dtype=np.uint32)
        got = _np(sharded_map_pgs(mesh, mp, rid, xs, 3))
        single = Mapper(m, block=1 << 9, device="cpu")
        want = _np(single.map_pgs(rid, xs, 3))
        assert mp.flagged_lanes == single.flagged_lanes
        assert (got == want).all()
        assert (got == np.asarray(RefMapper(rm, block=1 << 9).map_pgs(
            rid, xs, 3))).all()
        _assert_rows_match_ref(rm, rid, got[:16], xs[:16], 3)
        # eight slots on the Mapper's own device share its tables
        assert mp._replicas == {}


class TestWiring:
    def test_mapper_mesh_option(self, mesh, ref_mesh, hier):
        """Mapper(mesh=...) routes big batches through the sharded path
        (the path's suffix, devmon's launches_sharded), small ones stay
        local, as the reference's Mapper does."""
        h = hier
        mp = Mapper(h["m"], block=1 << 10, mesh=mesh, mesh_min_batch=128,
                    device="cpu")
        rmp = RefMapper(h["rm"], block=1 << 10, mesh=ref_mesh,
                        mesh_min_batch=128)
        xs = np.arange(N, dtype=np.uint32)
        before = devmon().perf.dump()["launches_sharded"]
        got = _np(mp.map_pgs(h["rid"], xs, 3))
        assert mp.last_map_path == "kernel-plain+sharded"
        assert devmon().perf.dump()["launches_sharded"] == before + 1
        assert (got == h["want"]).all()
        assert (got == np.asarray(rmp.map_pgs(h["rid"], xs, 3))).all()
        assert rmp.last_map_path == "xla+sharded"
        small = _np(mp.map_pgs(h["rid"], xs[:16], 3))
        assert mp.last_map_path == "kernel-plain"
        assert (small == h["want"][:16]).all()
        c, b = mp.sweep(h["rid"], 0, 757, 3)
        assert mp.last_map_path == "kernel-plain+sharded"
        assert (_np(c) == h["sweep"][0]).all() and int(b) == h["sweep"][1]
        # a sweep counting into a given width stays local
        mp.sweep(h["rid"], 0, 757, 3, device_counts_size=40)
        assert mp.last_map_path == "kernel-plain"

    def test_osdmap_mapping_sharded_full_sweep(self, mesh, ref_mesh):
        """A crush-topology change forces the full-sweep fallback; with a
        mesh attached it runs sharded and bumps remap_sharded_sweeps. The
        tables equal a mesh-less rebuild and the reference's sharded
        table."""
        from ceph_tpu.bench import osdmaptool as ref_osdmaptool
        from ceph_tpu.osd.osdmap import Incremental as RefIncremental
        from ceph_tpu.osd.osdmap_mapping import (
            OSDMapMapping as RefOSDMapMapping,
        )
        from ceph_tpu_torch.bench import osdmaptool
        from ceph_tpu_torch.osd.osdmap import PERF, Incremental
        from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping

        m = osdmaptool.create_simple(32, 256, 3, erasure=False, device="cpu")
        rm = ref_osdmaptool.create_simple(32, 256, 3, erasure=False)
        before = PERF.dump()["remap_sharded_sweeps"]
        mm = OSDMapMapping(m, mesh=mesh, mesh_min_batch=1)
        rmm = RefOSDMapMapping(rm, mesh=ref_mesh, mesh_min_batch=1)
        assert mm.last_sharded_sweeps == rmm.last_sharded_sweeps > 0
        assert mm.last_full_sweep_pools == rmm.last_full_sweep_pools > 0
        # crush topology edit -> full-sweep fallback, sharded again
        for om, inc in ((m, Incremental), (rm, RefIncremental)):
            om.crush.buckets[-1].weights[0] += 7        # in-place edit
            om.crush_version += 1
            om.apply_incremental(inc(epoch=om.epoch + 1))
        mm.update(m)
        rmm.update(rm)
        assert mm.last_sharded_sweeps == rmm.last_sharded_sweeps > 0
        assert PERF.dump()["remap_sharded_sweeps"] > before
        m.attach_mesh(None)       # the map keeps the last table's mesh
        plain = OSDMapMapping(m)
        assert plain.last_sharded_sweeps == 0
        for pid in m.pools:
            for name in ("craw", "up", "up_primary", "acting",
                         "acting_primary"):
                got = getattr(mm._pools[pid], name)
                assert np.array_equal(got, getattr(plain._pools[pid], name))
                assert np.array_equal(got, getattr(rmm._pools[pid], name))

    def test_crush_sweep_span(self, mesh, ref_mesh):
        """Bulk full sweeps emit a crush_sweep span tagged n_pgs / path /
        n_devices through the attached Tracer, as the reference's do."""
        from ceph_tpu.bench import osdmaptool as ref_osdmaptool
        from ceph_tpu.osd.osdmap_mapping import (
            OSDMapMapping as RefOSDMapMapping,
        )
        from ceph_tpu.utils.tracing import Tracer as RefTracer
        from ceph_tpu_torch.bench import osdmaptool
        from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
        from ceph_tpu_torch.utils.tracing import Tracer

        cfg = {"trace_sampling_rate": 1.0, "trace_slow_keep_s": 30.0}
        tags = []
        for mk, mapping, tracer, msh in (
                (lambda: osdmaptool.create_simple(16, 64, 3, erasure=False,
                                                  device="cpu"),
                 OSDMapMapping, Tracer("osd.test", dict(cfg)), mesh),
                (lambda: ref_osdmaptool.create_simple(16, 64, 3,
                                                      erasure=False),
                 RefOSDMapMapping, RefTracer("osd.test", dict(cfg)),
                 ref_mesh)):
            mapping(mk(), mesh=msh, mesh_min_batch=1, tracer=tracer)
            spans = [s for s in tracer.dump()["spans"]
                     if s["name"] == "crush_sweep"]
            assert spans, "no crush_sweep span recorded"
            tags.append(spans[-1]["tags"])
        mine, theirs = tags
        assert mine["n_pgs"] == theirs["n_pgs"] == 64
        assert mine["n_devices"] == theirs["n_devices"] == 8
        assert mine["path"] == "kernel-plain+sharded"
        assert theirs["path"].endswith("+sharded")


class TestMeshProvenance:
    """The ``osd_crush_mesh`` knob decides where an OSD's device mesh
    comes from: ``auto`` attaches a mesh of every card at boot when more
    than one is visible."""

    def test_boot_crush_mesh_knob(self):
        from ceph_tpu_torch.osd.daemon import _boot_crush_mesh
        cpu = torch.device("cpu")
        assert _boot_crush_mesh({}, cpu) is None                # default
        assert _boot_crush_mesh({"osd_crush_mesh": "off"}, cpu) is None
        # the CPU, or one card, keeps the plain path
        assert _boot_crush_mesh({"osd_crush_mesh": "auto"}, cpu) is None

    def test_auto_builds_mesh_over_visible_devices(self, monkeypatch):
        """More than one card: auto returns make_mesh over every card
        (the device count is faked here, the constructor observed)."""
        import ceph_tpu_torch.parallel
        from ceph_tpu_torch.osd import daemon as osd_daemon
        built = {}

        def fake_make_mesh(devices):
            built["devices"] = devices
            return "mesh-sentinel"
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(ceph_tpu_torch.parallel, "make_mesh",
                            fake_make_mesh)
        got = osd_daemon._boot_crush_mesh({"osd_crush_mesh": "auto"},
                                          torch.device("cuda"))
        assert got == "mesh-sentinel"
        assert built["devices"] == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]

    def test_osd_boot_wires_mesh_into_tracked_table(self, monkeypatch):
        """OSD.__init__ hands the knob's mesh to the MonClient, which
        builds the tracked OSDMapMapping with it."""
        from ceph_tpu_torch.mon.monitor import MonMap
        from ceph_tpu_torch.osd import daemon as osd_daemon
        sentinel = object()
        monkeypatch.setattr(osd_daemon, "_boot_crush_mesh",
                            lambda cfg, device: sentinel
                            if cfg.get("osd_crush_mesh") == "auto"
                            else None)
        monmap = MonMap()
        monmap.add("a", 0, "127.0.0.1", 6789)
        osd = osd_daemon.OSD(0, monmap, config={"osd_crush_mesh": "auto"},
                             device="cpu")
        assert osd.monc.mapping_mesh is sentinel
        osd2 = osd_daemon.OSD(1, monmap, config={}, device="cpu")
        assert osd2.monc.mapping_mesh is None
