"""CLAY: Coupled-LAYer MSR codes (repair-bandwidth-optimal).

A copy of ``ceph_tpu/ec/clay.py``: there it is host numpy
(``_decode_layered``, ``repair_chunk``), so it is host numpy here.

ref: src/erasure-code/clay/ErasureCodeClay.{h,cc} and the FAST'18 paper
"Clay Codes: Moulding MDS Codes to Yield Vector Codes". Supported
geometry: d = k+m-1 helpers (the upstream default), so q = d-k+1 = m.

Structure: n = k+m nodes padded to n' = q*t grid nodes (virtual
"shortened" nodes hold zero chunks); every chunk is a vector of
alpha = q^t sub-chunks indexed by planes z in Z_q^t. Node (x, y) sits at
grid position y*q + x. Vertex (x,y;z) is *unpaired* when z_y == x;
otherwise it couples with vertex (z_y, y; z with z_y:=x) through the
symmetric pairwise transform

    C(v) = U(v) + gamma * U(partner(v))        [gamma^2 != 1]

where U is the uncoupled code: in every plane z, the U values across the
n' nodes form a codeword of a scalar (n', n'-m) MDS code.

- encode   = layered decode with the m parity nodes as erasures;
- decode   = layered decode (planes processed by Intersection Score);
- repair   = single failure (x*,y*) reads ONLY the alpha/q sub-chunks of
  planes {z : z_{y*} = x*} from each of the d = n-1 helpers, solving one
  m x m MDS system per plane — bandwidth (n-1)/m * alpha/q vs k*alpha,
  the whole point of the code.

Provenance: the reference tree was empty during the survey (SURVEY.md
warning); coupling coefficient and sub-chunk ordering are this
implementation's own conventions, property-verified (MDS + repair
bandwidth) rather than byte-matched.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from ceph_tpu_torch.ec import matrix as rs
from ceph_tpu_torch.ec.interface import (ErasureCodeInterface,
                                         ErasureCodeProfile)
from ceph_tpu_torch.gf import tables
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("ec")

GAMMA = 2  # coupling coefficient; needs gamma^2 != 1 in GF(2^8)


class ErasureCodeClay(ErasureCodeInterface):
    """plugin=clay k=K m=M (d=K+M-1) technique=reed_sol_van"""

    def __init__(self, profile: ErasureCodeProfile | str | None = None):
        super().__init__()
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0      # virtual (shortened) nodes
        self.technique = "reed_sol_van"
        if profile is not None:
            self.init(ErasureCodeProfile.parse(profile))

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 4)
        self.m = profile.get_int("m", 2)
        self.d = profile.get_int("d", self.k + self.m - 1)
        self.technique = profile.get("technique", "reed_sol_van")
        if self.d != self.k + self.m - 1:
            raise NotImplementedError(
                f"clay: only d=k+m-1 supported (got d={self.d})")
        n = self.k + self.m
        self.q = self.d - self.k + 1      # == m
        self.t = -(-n // self.q)
        self.nu = self.q * self.t - n     # virtual nodes at grid tail
        nprime = self.q * self.t
        # plane MDS code: data = real data + virtual zeros, parity = m
        self.kprime = nprime - self.m
        self._coding = rs.coding_matrix(self.technique, self.kprime, self.m)
        self._inv_det = tables.gf_inv(1 ^ tables.gf_mul(GAMMA, GAMMA))
        self._decode_plane_cache: dict = {}
        log.dout(5, "clay init", k=self.k, m=self.m, d=self.d, q=self.q,
                 t=self.t, sub_chunks=self.sub_chunk_count())

    # -- geometry ---------------------------------------------------------
    def sub_chunk_count(self) -> int:
        """alpha = q^t (ref: ErasureCodeClay::get_sub_chunk_count)."""
        return self.q ** self.t

    def get_repair_sub_chunk_count(self) -> int:
        """Sub-chunks read per helper for one repair: alpha/q
        (ref: ErasureCodeClay::get_repair_sub_chunk_count)."""
        return self.sub_chunk_count() // self.q

    def get_alignment(self) -> int:
        return self.sub_chunk_count()

    def get_chunk_size(self, object_size: int) -> int:
        align = self.sub_chunk_count()
        chunk = -(-object_size // self.k)
        return -(-chunk // align) * align

    # -- grid helpers -----------------------------------------------------
    # grid node p = y*q + x; chunks: 0..k-1 data, k..n-1 parity,
    # n..n'-1 virtual. Plane z = digits (z_0..z_{t-1}), index
    # sum(z_y * q**y).
    def _plane_digits(self, zi: int) -> list[int]:
        out = []
        for _ in range(self.t):
            out.append(zi % self.q)
            zi //= self.q
        return out

    def _plane_index(self, digits: Sequence[int]) -> int:
        return sum(d * self.q ** y for y, d in enumerate(digits))

    def _plane_rows(self) -> tuple[list[int], list[int]]:
        """plane-code (data_rows, parity_rows) in grid order."""
        n = self.k + self.m
        nprime = self.q * self.t
        data = list(range(self.k)) + list(range(n, nprime))
        parity = list(range(self.k, n))
        return data, parity

    # -- pairwise transform ----------------------------------------------
    def _uncouple_pair(self, c_v, c_p):
        """U(v) from C(v), C(partner): U = (C(v) + g*C(p)) / (1 + g^2)."""
        return tables.gf_mul_np(
            self._inv_det, c_v ^ tables.gf_mul_np(GAMMA, c_p))

    # -- layered decode (the engine) --------------------------------------
    def _decode_layered(self, chunks: dict[int, np.ndarray],
                        erased: list[int], C: int) -> dict[int, np.ndarray]:
        """Recover C of erased nodes (<= m) from the others.

        chunks: node -> (C,) uint8 for all non-erased REAL nodes.
        Works on (n', alpha, S) sub-chunk tensors; plane sweep in
        Intersection-Score order, then per-plane MDS recovery of U,
        finally re-couple the erased nodes' C.
        """
        q, t = self.q, self.t
        nprime = q * t
        alpha = self.sub_chunk_count()
        S = C // alpha
        n = self.k + self.m
        cc = np.zeros((nprime, alpha, S), dtype=np.uint8)
        for p, buf in chunks.items():
            cc[p] = np.asarray(buf, dtype=np.uint8).reshape(alpha, S)
        erased_set = set(erased)
        if len(erased_set) > self.m:
            raise ValueError(f"clay: {len(erased_set)} erasures > m={self.m}")

        planes = [self._plane_digits(zi) for zi in range(alpha)]
        is_of = []
        for z in planes:
            s = sum(1 for y in range(t)
                    if z[y] + y * q in erased_set)
            is_of.append(s)
        order = sorted(range(alpha), key=lambda zi: is_of[zi])

        U = np.zeros_like(cc)
        u_known = np.zeros((nprime, alpha), dtype=bool)
        data_rows, parity_rows = self._plane_rows()
        row_order = data_rows + parity_rows  # plane-code row id -> grid
        code_id = {p: i for i, p in enumerate(row_order)}
        dec_cache: dict = {}
        for zi in order:
            z = planes[zi]
            # 1) uncouple the non-erased nodes
            for p in range(nprime):
                if p in erased_set:
                    continue
                x, y = p % q, p // q
                if z[y] == x:
                    U[p, zi] = cc[p, zi]
                else:
                    pp = z[y] + y * q
                    z2 = list(z)
                    z2[y] = x
                    zi2 = self._plane_index(z2)
                    if pp in erased_set:
                        # partner plane has lower IS: its U is recovered
                        assert u_known[pp, zi2]
                        U[p, zi] = cc[p, zi] ^ tables.gf_mul_np(
                            GAMMA, U[pp, zi2])
                    else:
                        U[p, zi] = self._uncouple_pair(cc[p, zi],
                                                       cc[pp, zi2])
                u_known[p, zi] = True
            # 2) MDS-recover U of erased nodes in this plane
            if erased_set:
                avail = tuple(code_id[p] for p in range(nprime)
                              if p not in erased_set)
                want = tuple(code_id[p] for p in sorted(erased_set))
                key = (avail, want)
                if key not in dec_cache:
                    dec_cache[key] = rs.decode_matrix(
                        self.technique, self.kprime, self.m,
                        avail, want)
                dmat = dec_cache[key]
                stacked = np.stack([U[p, zi] for p in range(nprime)
                                    if p not in erased_set])[:self.kprime]
                out = tables.gf_matmul_np(dmat[:, :self.kprime], stacked)
                for idx, p in enumerate(sorted(erased_set)):
                    U[p, zi] = out[idx]
                    u_known[p, zi] = True
        # 3) re-couple erased nodes
        result: dict[int, np.ndarray] = {}
        for p in sorted(erased_set):
            if p >= n:
                continue
            x, y = p % q, p // q
            outc = np.zeros((alpha, S), dtype=np.uint8)
            for zi in range(alpha):
                z = planes[zi]
                if z[y] == x:
                    outc[zi] = U[p, zi]
                else:
                    pp = z[y] + y * q
                    z2 = list(z)
                    z2[y] = x
                    zi2 = self._plane_index(z2)
                    outc[zi] = U[p, zi] ^ tables.gf_mul_np(
                        GAMMA, U[pp, zi2])
            result[p] = outc.reshape(-1)
        return result

    # -- bandwidth-optimal single repair ----------------------------------
    def repair_plane_indices(self, failed: int) -> list[int]:
        """The alpha/q planes each helper is read at:
        {z : z_{y*} = x*}."""
        x, y = failed % self.q, failed // self.q
        return [zi for zi in range(self.sub_chunk_count())
                if self._plane_digits(zi)[y] == x]

    def repair_chunk(self, failed: int,
                     helper_subchunks: Mapping[int, Mapping[int, np.ndarray]],
                     chunk_size: int) -> np.ndarray:
        """Reconstruct `failed` from helpers' repair-plane sub-chunks only.

        helper_subchunks: node -> {plane_index -> (S,) uint8}, for every
        real node != failed, at exactly repair_plane_indices(failed)
        (virtual nodes are implicit zeros). Per plane: uncouple all nodes
        outside row y*, then solve the m x m parity-check system whose
        unknowns are the q = m row-y* node values.
        """
        q, t = self.q, self.t
        nprime = q * t
        alpha = self.sub_chunk_count()
        S = chunk_size // alpha
        x_f, y_f = failed % q, failed // q
        R = self.repair_plane_indices(failed)
        rset = set(R)
        # full parity-check H (m, n') in grid order: H @ U(plane) = 0
        data_rows, parity_rows = self._plane_rows()
        H = np.zeros((self.m, nprime), dtype=np.uint8)
        for j, p in enumerate(data_rows):
            H[:, p] = self._coding[:, j]
        for i, p in enumerate(parity_rows):
            H[i, p] = 1

        def read(p, zi):
            if p >= self.k + self.m:
                return np.zeros(S, dtype=np.uint8)  # virtual
            return np.asarray(helper_subchunks[p][zi], dtype=np.uint8)

        row_nodes = [y_f * q + xx for xx in range(q)]  # unknown columns
        Hs_inv = tables.gf_matinv_np(H[:, row_nodes])
        ginv = tables.gf_inv(GAMMA)
        out = np.zeros((alpha, S), dtype=np.uint8)
        for zi in R:
            z = self._plane_digits(zi)
            # rhs = sum of H-coded U over all known (non-row-y*) nodes;
            # pairs of such nodes stay inside the repair planes.
            rhs = np.zeros((self.m, S), dtype=np.uint8)
            for p in range(nprime):
                if p // q == y_f:
                    continue
                x, y = p % q, p // q
                if z[y] == x:
                    u = read(p, zi)
                else:
                    pp = z[y] + y * q
                    z2 = list(z)
                    z2[y] = x
                    zi2 = self._plane_index(z2)
                    assert zi2 in rset, "partner outside repair planes"
                    u = self._uncouple_pair(read(p, zi), read(pp, zi2))
                for i in range(self.m):
                    if H[i, p]:
                        rhs[i] ^= tables.gf_mul_np(int(H[i, p]), u)
            u_row = tables.gf_matmul_np(Hs_inv, rhs)  # (q, S): row-y* U's
            # failed vertex is unpaired at repair planes: C = U.
            out[zi] = u_row[x_f]
            # Non-repair planes z2 = z(y_f -> xx), xx != x_f (each covered
            # exactly once over zi in R): the failed vertex at z2 pairs
            # with the row node (xx, y_f) at plane z, giving
            #   C(node xx @ z)   = U(node xx @ z) + g * U(failed @ z2)
            #   C(failed  @ z2)  = U(failed @ z2) + g * U(node xx @ z)
            # (virtual row nodes work too: their C reads as zero).
            for xx in range(q):
                if xx == x_f:
                    continue
                z2 = list(z)
                z2[y_f] = xx
                zi2 = self._plane_index(z2)
                c_helper = read(y_f * q + xx, zi)
                u_helper = u_row[xx]
                u_failed_z2 = tables.gf_mul_np(ginv, c_helper ^ u_helper)
                out[zi2] = u_failed_z2 ^ tables.gf_mul_np(GAMMA, u_helper)
        return out.reshape(-1)

    # -- interface kernels ------------------------------------------------
    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        C = data.shape[1]
        chunks = {i: data[i] for i in range(self.k)}
        out = self._decode_layered(
            chunks, list(range(self.k, self.k + self.m)), C)
        return np.stack([out[self.k + i] for i in range(self.m)])

    def decode_chunks(self, want: Sequence[int],
                      chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        n = self.k + self.m
        have = {i: np.asarray(c, dtype=np.uint8) for i, c in chunks.items()}
        missing = sorted(set(range(n)) - set(have))
        C = next(iter(have.values())).shape[0]
        if len(have) < self.k:
            raise ValueError(
                f"clay: need {self.k} chunks, have {len(have)}")
        if not missing:
            return {i: have[i] for i in want}
        if len(missing) == 1 and len(have) == n - 1:
            # bandwidth-optimal path (reads only alpha/q per helper)
            failed = missing[0]
            R = self.repair_plane_indices(failed)
            alpha = self.sub_chunk_count()
            S = C // alpha
            subs = {p: {zi: have[p].reshape(alpha, S)[zi] for zi in R}
                    for p in have}
            rec = {failed: self.repair_chunk(failed, subs, C)}
        else:
            rec = self._decode_layered(have, missing, C)
        out = {}
        for i in want:
            out[i] = have[i] if i in have else rec[i]
        return out

    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> set[int]:
        """Single failure: all d = n-1 helpers (each read at only
        alpha/q sub-chunks — fewer BYTES than any k full chunks);
        otherwise any k (ref: ErasureCodeClay::minimum_to_decode)."""
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return want
        n = self.k + self.m
        missing = set(range(n)) - avail
        if len(missing) == 1 and len(avail) == n - 1:
            return avail
        return super().minimum_to_decode(want, avail)
