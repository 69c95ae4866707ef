"""The port's LRC / SHEC / CLAY plugins held against ceph_tpu's.

Mirrors the lrc, shec and clay cases of tests/test_ec_plugins.py (the
reference's per-plugin gtest pattern: encode a known buffer, erase
chunks, check minimum_to_decode, decode, byte-compare), and in each one
holds the port (``device=cpu``) against the same plugin of ``ceph_tpu``
on JAX's CPU backend: the same chunk bytes from the same payload, the
same decoded chunks, the same repair plans. Everything is integer, so
the tolerance is equality.
"""

import numpy as np
import pytest

from ceph_tpu.ec.clay import ErasureCodeClay as JaxClay
from ceph_tpu.ec.lrc import ErasureCodeLrc as JaxLrc
from ceph_tpu.ec.lrc import generate_kml as jax_generate_kml
from ceph_tpu.ec.shec import ErasureCodeShec as JaxShec
from ceph_tpu.ec.shec import shec_matrix as jax_shec_matrix
from ceph_tpu_torch.ec.clay import ErasureCodeClay
from ceph_tpu_torch.ec.interface import ErasureCodeProfile
from ceph_tpu_torch.ec.lrc import ErasureCodeLrc, generate_kml
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.ec.shec import ErasureCodeShec, shec_matrix
from ceph_tpu_torch.ec.torch_plugin import to_host


def roundtrip(ec, ref, payload: bytes, erase: list[int]) -> None:
    """Encode with both plugins (equal chunks), erase, decode with both
    (equal chunks, equal to the originals), reassemble the payload."""
    n = ec.get_chunk_count()
    enc = ec.encode(range(n), payload)
    assert enc == ref.encode(range(n), payload)
    chunks = {i: c for i, c in enc.items() if i not in erase}
    dec = ec.decode(list(range(n)), chunks)
    assert dec == ref.decode(list(range(n)), chunks)
    for i in range(n):
        assert dec[i] == enc[i], f"chunk {i} mismatch after erasing {erase}"
    out = ec.decode_concat(dict(chunks))
    assert out[:len(payload)] == payload


class TestKmlGeneration:
    def test_doc_example(self):
        # doc/rados/operations/erasure-code-lrc.rst k=4 m=2 l=3
        mapping, layers = generate_kml(4, 2, 3)
        assert mapping == "__DD__DD"
        assert layers[0][0] == "_cDD_cDD"
        assert layers[1][0] == "cDDD____"
        assert layers[2][0] == "____cDDD"
        for kml in ((4, 2, 3), (8, 4, 3), (6, 3, 3)):
            assert generate_kml(*kml) == jax_generate_kml(*kml)

    def test_invalid(self):
        with pytest.raises(ValueError):
            generate_kml(4, 2, 4)  # (k+m) % l != 0


class TestLrc:
    PROFILE = "plugin=lrc k=4 m=2 l=3"

    def setup_method(self):
        self.ec = ErasureCodeLrc(self.PROFILE + " device=cpu")
        self.ref = JaxLrc(self.PROFILE)
        self.payload = bytes(range(256)) * 13

    def test_geometry(self):
        assert self.ec.get_chunk_count() == 8
        assert self.ec.get_data_chunk_count() == 4
        assert self.ec.get_chunk_mapping() == self.ref.get_chunk_mapping()
        assert self.ec.device.type == "cpu"

    def test_roundtrip_single(self):
        for erase in range(8):
            roundtrip(self.ec, self.ref, self.payload, [erase])

    def test_roundtrip_double(self):
        roundtrip(self.ec, self.ref, self.payload, [0, 5])
        roundtrip(self.ec, self.ref, self.payload, [1, 2])

    def test_batch_encode_and_reference(self):
        """The batched device encode (one kernel launch per layer, the
        scatter by index assignment) and its host mirror equal ceph_tpu's
        batched encode."""
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, (3, 4, 256), dtype=np.uint8)
        got = to_host(self.ec.encode_batch(data))
        assert np.array_equal(got, np.asarray(self.ref.encode_batch(data)))
        assert np.array_equal(got, self.ec.encode_batch_reference(data))

    def test_local_repair_reads_l_not_k(self):
        """One lost chunk needs only its local group (l=3 reads), not
        k=4: the same plan as ceph_tpu's."""
        avail = set(range(8)) - {0}
        need = self.ec.minimum_to_decode([0], avail)
        assert need == self.ref.minimum_to_decode([0], avail)
        assert len(need) == 3
        mapping = self.ec.get_chunk_mapping()
        pos = {mapping[i] for i in need} | {mapping[0]}
        assert pos <= set(range(0, 4))

    def test_comma_separated_profile_with_layers(self):
        prof = ErasureCodeProfile.parse(
            'plugin=lrc,mapping=__DD__DD,'
            'layers=[["_cDD_cDD",""],["cDDD____",""],["____cDDD",""]]')
        assert prof["mapping"] == "__DD__DD"
        assert prof["plugin"] == "lrc"
        ec = ErasureCodeLrc(prof, device="cpu")
        assert ec.get_chunk_count() == 8

    def test_explicit_profile(self):
        prof = ('plugin=lrc mapping=__DD__DD '
                'layers=[["_cDD_cDD",""],["cDDD____",""],["____cDDD",""]]')
        roundtrip(ErasureCodeLrc(prof + " device=cpu"), JaxLrc(prof),
                  self.payload, [2])

    def test_registry(self):
        ec = factory(self.PROFILE + " device=cpu")
        assert isinstance(ec, ErasureCodeLrc)
        assert all(la.code.device.type == "cpu" for la in ec.layers)

    def test_undecodable_raises(self):
        # losing a whole local group of 4 exceeds any layer's power
        enc = self.ec.encode(range(8), self.payload)
        chunks = {i: c for i, c in enc.items() if i >= 4}
        with pytest.raises(ValueError):
            self.ec.decode(list(range(4)), chunks)
        with pytest.raises(ValueError):
            self.ref.decode(list(range(4)), chunks)


class TestShec:
    PROFILE = "plugin=shec k=4 m=3 c=2"

    def setup_method(self):
        self.ec = ErasureCodeShec(self.PROFILE + " device=cpu")
        self.ref = JaxShec(self.PROFILE)
        self.payload = b"shec" * 999

    def test_matrix_windows(self):
        mat = shec_matrix(4, 3, 2)
        assert np.array_equal(mat, jax_shec_matrix(4, 3, 2))
        assert np.array_equal(shec_matrix(8, 4, 3),
                              jax_shec_matrix(8, 4, 3))
        for i in range(3):
            cov = np.flatnonzero(mat[i])
            assert len(cov) <= 3
            assert (np.diff(cov) == 1).all()
        assert (mat != 0).sum() >= 4 * 2

    def test_roundtrip_single(self):
        for erase in range(7):
            roundtrip(self.ec, self.ref, self.payload, [erase])

    def test_roundtrip_double(self):
        roundtrip(self.ec, self.ref, self.payload, [0, 3])
        roundtrip(self.ec, self.ref, self.payload, [1, 5])

    def test_local_repair_cheaper_than_k(self):
        avail = set(range(7)) - {0}
        need = self.ec.minimum_to_decode([0], avail)
        assert need == self.ref.minimum_to_decode([0], avail)
        assert len(need) <= 3

    def test_registry(self):
        ec = factory(self.PROFILE + " device=cpu")
        assert isinstance(ec, ErasureCodeShec)
        # the kernel's backend, not ceph_tpu's XLA bit-plane op: the same
        # parity (see ec/shec.py)
        assert ec._kern.backend == "kernel"
        rng = np.random.default_rng(4)
        data = rng.integers(0, 256, (4, 384), dtype=np.uint8)
        assert np.array_equal(ec.encode_chunks(data),
                              self.ref.encode_chunks(data))


class TestClay:
    PROFILE = "plugin=clay k=4 m=2"

    def setup_method(self):
        self.ec = ErasureCodeClay(self.PROFILE)
        self.ref = JaxClay(self.PROFILE)
        self.payload = bytes(range(256)) * 9

    def test_geometry(self):
        # q=2, n=6 -> t=3, alpha=8
        assert self.ec.q == 2 and self.ec.t == 3
        assert self.ec.sub_chunk_count() == 8
        assert self.ec.get_repair_sub_chunk_count() == 4
        assert self.ec.get_chunk_size(100) % 8 == 0
        assert self.ec.get_chunk_size(4 << 20) == \
            self.ref.get_chunk_size(4 << 20)

    def test_roundtrip_single_each(self):
        for erase in range(6):
            roundtrip(self.ec, self.ref, self.payload, [erase])

    def test_roundtrip_double_all_patterns(self):
        for a in range(6):
            for b in range(a + 1, 6):
                roundtrip(self.ec, self.ref, self.payload, [a, b])

    def test_repair_matches_full_decode(self):
        """Bandwidth-optimal repair and layered decode agree bit-exact."""
        enc = self.ec.encode(range(6), self.payload)
        for failed in range(6):
            chunks = {i: c for i, c in enc.items() if i != failed}
            got = self.ec.decode([failed], chunks)[failed]
            assert got == enc[failed], f"repair of {failed} diverged"

    def test_repair_reads_subchunk_fraction(self):
        """Single repair consumes exactly alpha/q sub-chunks per helper."""
        enc = self.ec.encode(range(6), self.payload)
        failed = 2
        C = len(enc[0])
        alpha = self.ec.sub_chunk_count()
        S = C // alpha
        R = self.ec.repair_plane_indices(failed)
        assert R == self.ref.repair_plane_indices(failed)
        assert len(R) == alpha // self.ec.q
        arrs = {i: np.frombuffer(c, dtype=np.uint8).reshape(alpha, S)
                for i, c in enc.items() if i != failed}
        subs = {p: {zi: a[zi] for zi in R} for p, a in arrs.items()}
        got = self.ec.repair_chunk(failed, subs, C)
        assert got.tobytes() == enc[failed]
        assert np.array_equal(got, self.ref.repair_chunk(failed, subs, C))

    def test_minimum_single_failure_is_all_helpers(self):
        need = self.ec.minimum_to_decode([1], set(range(6)) - {1})
        assert need == set(range(6)) - {1}

    def test_k8_m4_geometry(self):
        ec = ErasureCodeClay("plugin=clay k=8 m=4")
        assert ec.sub_chunk_count() == 64
        payload = b"clay-8-4" * 512
        enc = ec.encode(range(12), payload)
        assert enc == JaxClay("plugin=clay k=8 m=4").encode(range(12),
                                                            payload)
        chunks = {i: c for i, c in enc.items() if i not in (0, 5, 9, 11)}
        dec = ec.decode(list(range(12)), chunks)
        for i in range(12):
            assert dec[i] == enc[i]

    def test_virtual_padding_geometry(self):
        # k=5 m=2: n=7, q=2, t=4 (pad 1 virtual), alpha=16
        prof = "plugin=clay k=5 m=2"
        ec = ErasureCodeClay(prof)
        assert ec.nu == 1
        payload = b"pad" * 1000
        for erase in ([0], [6], [1, 4]):
            roundtrip(ec, JaxClay(prof), payload, erase)

    def test_registry(self):
        ec = factory("plugin=clay k=4 m=2 d=5")
        assert isinstance(ec, ErasureCodeClay)

    def test_unsupported_d(self):
        with pytest.raises(NotImplementedError):
            ErasureCodeClay("plugin=clay k=4 m=2 d=4")
