"""The port's resumable sweep (``ceph_tpu_torch/utils/checkpoint.py``),
its profiler harness (``utils/profiling.py``) and ``crush_sweep``'s
``--checkpoint/--chunk/--profile`` flags, held against ``ceph_tpu``'s.

``tests/test_checkpoint.py``'s three cases, each through both packages
on the same map (the port's Mapper on the CPU): the interrupted sweep
resumes to the one-shot counts, and the checkpoint file each package
saves after every call is equal, byte for byte; a changed map is
refused by both; a ``SweepState`` saved by one package loads in the
other. Then ``crush_sweep --checkpoint`` in both packages: the records
are equal key for key, and value for value apart from the run's seconds.
Counts are integers, so the tolerance is equality.
"""

import json

import numpy as np
import pytest

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush.mapper import Mapper as RefMapper
from ceph_tpu.utils import checkpoint as ref_ckpt
from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.utils import checkpoint, profiling


def make_maps():
    """The same 8-host map built by each package: (port, reference, rule)."""
    m, root = builder.build_hierarchy(8, 2)
    rid = builder.add_simple_rule(m, root, builder.TYPE_HOST)
    rm, rroot = ref_builder.build_hierarchy(8, 2)
    rrid = ref_builder.add_simple_rule(rm, rroot, ref_builder.TYPE_HOST)
    assert rid == rrid
    return m, rm, rid


def test_interrupted_resume_matches_oneshot(tmp_path):
    m, rm, rid = make_maps()
    ck, rck = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    mapper = Mapper(m, block=512, device="cpu")
    rmapper = RefMapper(rm, block=512)
    c_all, b_all = mapper.sweep(rid, 0, 4096, 3)
    truth = c_all.numpy()
    assert np.array_equal(truth,
                          np.asarray(rmapper.sweep(rid, 0, 4096, 3)[0]))
    # interrupted: 2 chunks, then a fresh call resumes from the file
    st, done = checkpoint.resumable_sweep(m, rid, 4096, 3, ck, chunk=1024,
                                          mapper=mapper, max_chunks=2)
    ref_ckpt.resumable_sweep(rm, rid, 4096, 3, rck, chunk=1024,
                             mapper=rmapper, max_chunks=2)
    assert not done and st.cursor == 2048
    assert open(ck).read() == open(rck).read()
    st2, done2 = checkpoint.resumable_sweep(m, rid, 4096, 3, ck, chunk=1024,
                                            mapper=mapper)
    ref_ckpt.resumable_sweep(rm, rid, 4096, 3, rck, chunk=1024,
                             mapper=rmapper)
    assert done2 and st2.cursor == 4096
    assert (st2.counts == truth).all()
    assert st2.bad == int(b_all)
    assert open(ck).read() == open(rck).read()


def test_mismatched_checkpoint_rejected(tmp_path):
    m, rm, rid = make_maps()
    for pkg_builder, mp, sweep, mapper in (
            (builder, m, checkpoint.resumable_sweep,
             Mapper(m, block=512, device="cpu")),
            (ref_builder, rm, ref_ckpt.resumable_sweep,
             RefMapper(rm, block=512))):
        ck = str(tmp_path / f"{pkg_builder.__name__}.json")
        sweep(mp, rid, 2048, 3, ck, chunk=1024, mapper=mapper, max_chunks=1)
        # mutate the map: partial counts no longer belong to it
        pkg_builder.adjust_item_weight(mp, 0, 2 * 0x10000)
        with pytest.raises(ValueError):
            if sweep is checkpoint.resumable_sweep:
                sweep(mp, rid, 2048, 3, ck, chunk=1024, device="cpu")
            else:
                sweep(mp, rid, 2048, 3, ck, chunk=1024)


def test_state_roundtrip(tmp_path):
    fields = dict(crushmap_text="x", rule=1, num_rep=3, n_total=10,
                  cursor=4, bad=1, counts=np.arange(5, dtype=np.int64))
    p, rp = str(tmp_path / "s.json"), str(tmp_path / "r.json")
    checkpoint.SweepState(**fields).save(p)
    ref_ckpt.SweepState(**fields).save(rp)
    assert open(p).read() == open(rp).read()
    for load in (checkpoint.SweepState.load, ref_ckpt.SweepState.load):
        got = load(p)
        assert got.cursor == 4 and got.bad == 1
        assert (got.counts == fields["counts"]).all()
    assert checkpoint.SweepState.load(str(tmp_path / "missing.json")) is None


def test_crush_sweep_checkpoint_records_equal(tmp_path, capsys):
    """``crush_sweep --checkpoint`` in both packages on the canonical map
    cut to 64 OSDs: one interrupted-free run each, records equal but the
    seconds; a rerun on a finished checkpoint does no work. With
    ``--profile`` the port writes one Chrome trace of the run."""
    from ceph_tpu.bench import crush_sweep as ref_sweep
    from ceph_tpu_torch.bench import crush_sweep
    args = ["--num-osds", "64", "--num-pgs", "2048", "--chunk", "512"]
    got = crush_sweep.main(args + ["--checkpoint", str(tmp_path / "p.json"),
                                   "--device", "cpu", "--profile",
                                   str(tmp_path / "prof")])
    # the reference's block is sized from its device memory unless given;
    # its compile at that size takes a minute on the CPU
    want = ref_sweep.main(args + ["--checkpoint", str(tmp_path / "r.json"),
                                  "--block", "512"])
    capsys.readouterr()
    assert list(got) == list(want)
    for k in want:
        if k != "seconds_this_run":
            assert got[k] == want[k], k
    assert got["done"] and got["placements"] == 3 * 2048
    again = crush_sweep.main(args + ["--checkpoint",
                                     str(tmp_path / "p.json"),
                                     "--device", "cpu"])
    assert again["cursor"] == 2048 and again["placements"] == 3 * 2048
    traces = list((tmp_path / "prof").iterdir())
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert events


def test_profiling_trace_and_annotate(tmp_path):
    """No directory, no trace; with one, the annotated region is in the
    Chrome trace written there."""
    with profiling.trace(None):
        with profiling.annotate("region"):
            pass
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("ceph-region"):
            sum(range(1000))
    (trace,) = (tmp_path / "t").iterdir()
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "ceph-region" in names
