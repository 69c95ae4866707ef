"""SHEC: Shingled Erasure Code.

The counterpart of ``ceph_tpu/ec/shec.py``.

ref: src/erasure-code/shec/ (ErasureCodeShec, shec_make_table). SHEC(k,m,c)
trades MDS-ness for cheap single-failure repair: each of the m parities
covers only a sliding window of ~k*c/m consecutive data chunks ("shingles"),
so repairing one data chunk reads a window (w+1 chunks) instead of k.
``c`` is the average number of parities covering each data chunk (the
durability estimator).

Construction here: window width w = ceil(k*c/m), parity i covers data
chunks [floor(i*k/m), floor(i*k/m)+w) clamped to k, with Cauchy
coefficients (any square Cauchy submatrix is invertible, which maximizes
the set of decodable erasure patterns a windowed code can have).

Provenance: the reference tree was empty during the survey (SURVEY.md
warning); the layout follows the published SHEC design, not upstream's
byte-exact tables.

Engines: ``ceph_tpu`` encodes SHEC with its XLA bit-plane product
(``_MatrixKernel(..., "bitmatmul")``). Here that product is the encode
kernel's plain version, which serves nothing on a path with a card, so
SHEC's encode goes through the ``gf_encode`` kernel (backend
``kernel``) on CUDA and its plain version on the CPU. The parity is the
same GF(2^8) product, byte for byte. Decode stays host numpy, as in the
reference.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

import torch

from ceph_tpu_torch.ec.interface import (ErasureCodeInterface,
                                         ErasureCodeProfile)
from ceph_tpu_torch.ec.torch_plugin import _MatrixKernel
from ceph_tpu_torch.gf import tables
from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("ec")


def shec_matrix(k: int, m: int, c: int) -> np.ndarray:
    """(m, k) windowed Cauchy coding matrix; zeros outside each shingle."""
    if not (0 < c <= m <= k):
        raise ValueError(f"invalid shec geometry k={k} m={m} c={c}")
    w = -(-k * c // m)
    mat = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        start = (i * k) // m
        for j in range(start, min(start + w, k)):
            mat[i, j] = tables.gf_inv(i ^ (m + j))
    return mat


class ErasureCodeShec(ErasureCodeInterface):
    """plugin=shec k=K m=M c=C technique=multiple [device=cuda|cpu]"""

    def __init__(self, profile: ErasureCodeProfile | str | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self._device_request = device
        self.device: torch.device | None = None
        self.c = 0
        self.matrix: np.ndarray | None = None
        self._kern: _MatrixKernel | None = None
        self._decode_cache: dict = {}
        if profile is not None:
            self.init(ErasureCodeProfile.parse(profile))

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 4)
        self.m = profile.get_int("m", 3)
        self.c = profile.get_int("c", 2)
        self.matrix = shec_matrix(self.k, self.m, self.c)
        self.device = devsel.resolve(
            profile.get("device", self._device_request))
        self._kern = _MatrixKernel(self.matrix, "kernel", self.device)
        self._decode_cache.clear()
        log.dout(5, "shec init", k=self.k, m=self.m, c=self.c)

    # -- structure queries ------------------------------------------------
    def parity_window(self, i: int) -> list[int]:
        """Data chunk ids covered by parity i."""
        return [j for j in range(self.k) if self.matrix[i, j]]

    def _generator(self) -> np.ndarray:
        return np.concatenate(
            [np.eye(self.k, dtype=np.uint8), self.matrix], axis=0)

    # -- encode -----------------------------------------------------------
    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        return self._kern.apply(
            torch.as_tensor(data, device=self.device)).cpu().numpy()

    # -- repair planning --------------------------------------------------
    def _repair_plan(self, want: set[int],
                     avail: set[int]) -> list[tuple[int, list[int]]] | None:
        """Iterative local repair: (target, reads) steps, or None.

        Each step reconstructs one missing chunk from one parity whose
        window is otherwise intact — the shingled fast path
        (ref: ErasureCodeShec minimum_to_decode search).
        """
        have = set(avail)
        plan: list[tuple[int, list[int]]] = []
        missing = set(want) - have
        for _ in range(len(missing) + 1):
            if not missing:
                return plan
            progress = False
            for t in sorted(missing):
                best: list[int] | None = None
                if t < self.k:
                    for i in range(self.m):
                        win = self.parity_window(i)
                        if t not in win or self.k + i not in have:
                            continue
                        reads = [j for j in win if j != t] + [self.k + i]
                        if all(r in have for r in reads) and (
                                best is None or len(reads) < len(best)):
                            best = reads
                else:
                    win = self.parity_window(t - self.k)
                    if all(j in have for j in win):
                        best = list(win)
                if best is not None:
                    plan.append((t, best))
                    have.add(t)
                    missing.discard(t)
                    progress = True
            if not progress:
                return None
        return plan

    def _solve_general(self, want: list[int],
                       avail: list[int]) -> np.ndarray | None:
        """Pick k GF-linearly-independent available generator rows via
        incremental Gauss elimination; returns (decode_matrix, rows) or
        None (SHEC is not MDS — some patterns are genuinely
        unrecoverable)."""
        g = self._generator()
        rows: list[int] = []
        reduced: list[np.ndarray] = []
        pivots: list[int] = []
        for r in sorted(avail):
            v = g[r].copy()
            for red, p in zip(reduced, pivots):
                if v[p]:
                    v = v ^ tables.gf_mul_np(int(v[p]), red)
            nz = np.flatnonzero(v)
            if not nz.size:
                continue
            piv = int(nz[0])
            v = tables.gf_mul_np(tables.gf_inv(int(v[piv])), v)
            rows.append(r)
            reduced.append(v)
            pivots.append(piv)
            if len(rows) == self.k:
                break
        if len(rows) < self.k:
            return None
        inv = tables.gf_matinv_np(g[rows])
        d = tables.gf_matmul_np(g[list(want)], inv)
        return d, rows

    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> set[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return want
        plan = self._repair_plan(want, avail)
        if plan is not None:
            reads = set(want & avail)
            produced: set[int] = set()
            for t, rs in plan:
                reads |= {r for r in rs if r not in produced}
                produced.add(t)
            return reads & avail
        solved = self._solve_general(sorted(want - avail), sorted(avail))
        if solved is None:
            raise ValueError(
                f"shec cannot decode {sorted(want - avail)} from "
                f"{sorted(avail)}")
        _, rows = solved
        return set(rows) | (want & avail)

    # -- decode -----------------------------------------------------------
    def decode_chunks(self, want: Sequence[int],
                      chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        have = {i: np.asarray(c, dtype=np.uint8)
                for i, c in chunks.items()}
        missing = [i for i in want if i not in have]
        plan = self._repair_plan(set(want), set(have))
        if plan is not None:
            g = self._generator()
            for t, reads in plan:
                if t >= self.k:
                    row = self.matrix[t - self.k]
                    acc = np.zeros_like(have[reads[0]])
                    for j in reads:
                        acc ^= tables.gf_mul_np(row[j], have[j])
                    have[t] = acc
                else:
                    # t = (parity - sum others) / coef_t within the window
                    pi = reads[-1] - self.k
                    row = self.matrix[pi]
                    acc = have[self.k + pi].copy()
                    for j in reads[:-1]:
                        acc ^= tables.gf_mul_np(row[j], have[j])
                    have[t] = tables.gf_mul_np(
                        tables.gf_inv(int(row[t])), acc)
            return {i: have[i] for i in want}
        solved = self._solve_general(missing, sorted(have))
        if solved is None:
            raise ValueError(
                f"shec cannot decode {missing} from {sorted(have)}")
        d, rows = solved
        stacked = np.stack([have[r] for r in rows])
        out = tables.gf_matmul_np(d, stacked)
        res = {i: have[i] for i in want if i in have}
        for idx, i in enumerate(missing):
            res[i] = out[idx]
        return res
