"""``Thrasher.device_storm``'s card contract, on the card.

On the CPU the storm's degrade legs hold (``test_torch_storm_device.py``):
a poisoned EC encode is served by the host reference encoder and the
CRUSH kernel path is quarantined while the rule VM serves. On the card
neither host path exists: the aggregators retry on the card and then
raise, and a Mapper counts a kernel failure and raises. What holds
instead, on an in-process ``Cluster`` on the card with a k=2 m=1 pool:

- a ``jit_fail`` injected at devmon's chokepoint in front of every
  ``gf_encode`` launch is counted by devmon (``faults_injected``);
- it surfaces to the client as an error (-EIO), and no write is acked:
  the object does not exist afterwards;
- the plain version never serves in the kernel's place: no call of
  ``gf_encode_plain`` or of the host reference encoder outside the
  checking hook, and no aggregator ``fallback_ops``;
- once the fault is cleared, a write launches the kernel again and reads
  back.

Every ``gf_encode`` launch is held against ``gf_encode_plain`` on the
same inputs, exactly. The file imports no jax and needs a CUDA device
(it skips without one):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_storm.py -q
"""

import asyncio

import pytest
import torch

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.gf import kernels as gkern
from ceph_tpu_torch.rados import ObjectOperationError
from ceph_tpu_torch.sim import faults as F
from ceph_tpu_torch.utils.devmon import devmon

pytestmark = pytest.mark.cuda


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 300.0))


@pytest.fixture
def watched(monkeypatch):
    """gf_encode held against its plain version at every launch (through
    the plain function captured here); counts the launches, and every
    call of the plain version or the host reference encoder that
    production code makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = {"launches": 0, "plain_served": 0, "reference_served": 0}
    real, plain = gkern.gf_encode, gkern.gf_encode_plain
    real_ref = ErasureCodeTorch.encode_batch_reference

    def gf(bm, data):
        out = real(bm, data)
        assert torch.equal(out, plain(bm, data))
        counts["launches"] += 1
        return out

    def served_plain(bm, data):
        counts["plain_served"] += 1
        return plain(bm, data)

    def served_reference(self, data):
        counts["reference_served"] += 1
        return real_ref(self, data)
    monkeypatch.setattr(gkern, "gf_encode", gf)
    monkeypatch.setattr(gkern, "gf_encode_plain", served_plain)
    monkeypatch.setattr(ErasureCodeTorch, "encode_batch_reference",
                        served_reference)
    return counts


def test_an_injected_gf_encode_failure_surfaces_to_the_client(watched):
    async def go():
        c = await Cluster(n_mons=1, n_osds=3,
                          config={"mon_osd_down_out_interval": 600.0},
                          device="cuda").start()
        try:
            cl = c.client
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd erasure-code-profile set", "name": "p21",
                 "profile": ["k=2", "m=1", "crush-failure-domain=osd",
                             "stripe_unit=4096"]})
            assert ret == 0, rs
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd pool create", "pool": "ec", "pg_num": 4,
                 "pool_type": "erasure", "erasure_code_profile": "p21"})
            assert ret == 0, rs
            await c.wait_for_clean(timeout=120)
            io = await cl.open_ioctx("ec")
            await io.write_full("before", b"b" * 8192)
            assert watched["launches"] > 0
            injector = F.FaultInjector(seed=1)
            c.install_faults(injector)
            f0 = devmon().perf.dump().get("faults_injected", 0)
            l0 = watched["launches"]
            injector.install("gf", [F.jit_fail("ec_encode*")])
            with pytest.raises(ObjectOperationError) as err:
                await io.write_full("storm", b"s" * 8192, timeout=30)
            assert err.value.errno == -5, err.value
            assert devmon().perf.dump().get("faults_injected", 0) > f0
            assert watched["launches"] == l0     # refused before launch
            injector.clear("gf")
            with pytest.raises(ObjectOperationError) as err:
                await io.stat("storm")
            assert err.value.errno == -2          # nothing was acked
            assert watched["plain_served"] == 0
            assert watched["reference_served"] == 0
            assert not any(o.ec_agg.perf.dump().get("fallback_ops", 0)
                           for o in c.osds)
            await io.write_full("after", b"a" * 8192)
            assert watched["launches"] > l0
            assert await io.read("after") == b"a" * 8192
            assert await io.read("before") == b"b" * 8192
        finally:
            await c.stop()
    run(go())
