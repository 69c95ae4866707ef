"""The erasure-code contract and shared base behavior.

Mirrors the reference's stable plugin contract
(ref: src/erasure-code/ErasureCodeInterface.h ErasureCodeInterface) and the
shared base-class logic (ref: src/erasure-code/ErasureCode.cc ErasureCode):
profile parsing, chunk sizing/padding (encode_prepare), the default
minimum_to_decode, and byte-level encode/decode built on the subclass's
chunk-array kernels.

Byte-level methods (`encode`, `decode`, `decode_concat`) speak `bytes` for
harness compatibility; the device hot path is the array-level
`encode_chunks` / `decode_chunks` on (k, chunk) uint8 arrays, plus the
batched `encode_batch` used by the benchmark.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Iterable, Mapping, Sequence

import numpy as np

# Per-chunk byte alignment. It fixes the chunk geometry and so the shard
# bytes on disk: it stays the reference's 128 although the GPU kernel
# needs no alignment at all.
DEFAULT_ALIGNMENT = 128


class ErasureCodeProfile(dict):
    """An EC profile: ``plugin=jax technique=reed_sol_van k=8 m=3``.

    (ref: src/erasure-code/ErasureCodeInterface.h profile map;
    src/osd/OSDMap "erasure-code-profile" pool metadata.)
    """

    @classmethod
    def parse(cls, text: str | Mapping[str, str]) -> "ErasureCodeProfile":
        if isinstance(text, Mapping):
            return cls(text)
        prof = cls()
        # commas separate pairs only at bracket depth 0 (lrc layers carry
        # JSON values with their own commas)
        depth = 0
        parts: list[str] = [""]
        for ch in text:
            if ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append("")
            else:
                parts[-1] += ch
        for part in parts:
            for tok in part.split():
                key, _, val = tok.partition("=")
                prof[key.strip()] = val.strip()
        return prof

    def get_int(self, key: str, default: int) -> int:
        return int(self.get(key, default))

    def __str__(self) -> str:
        return " ".join(f"{k}={v}" for k, v in sorted(self.items()))


class ErasureCodeInterface(ABC):
    """ref: src/erasure-code/ErasureCodeInterface.h (same method surface)."""

    def __init__(self) -> None:
        self.profile = ErasureCodeProfile()
        self.k = 0
        self.m = 0

    # -- lifecycle --------------------------------------------------------
    @abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Parse the profile and build per-profile state."""

    # -- geometry ---------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_alignment(self) -> int:
        return DEFAULT_ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        """Bytes per chunk for an object of `object_size` bytes.

        round_up(object_size / k, alignment)
        (ref: src/erasure-code/jerasure/ErasureCodeJerasure.cc get_chunk_size).
        """
        align = self.get_alignment()
        chunk = -(-object_size // self.k)
        return -(-chunk // align) * align

    def get_chunk_mapping(self) -> list[int]:
        """chunk index -> shard remap; empty = identity
        (ref: ErasureCodeInterface.h get_chunk_mapping)."""
        return []

    # -- decode planning --------------------------------------------------
    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> set[int]:
        """Smallest chunk set needed to produce `want_to_read`.

        Base semantics (ref: src/erasure-code/ErasureCode.cc
        _minimum_to_decode): if everything wanted is available return it,
        else any k available chunks (ordered).
        """
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return want
        if len(avail) < self.k:
            raise ValueError(
                f"cannot decode: {len(avail)} chunks available, need {self.k}")
        return set(sorted(avail)[:self.k])

    def minimum_to_decode_with_cost(
            self, want_to_read: Iterable[int],
            available: Mapping[int, int]) -> set[int]:
        """Like minimum_to_decode but `available` maps chunk -> read cost;
        prefer the cheapest k (ref: ErasureCodeInterface.h
        minimum_to_decode_with_cost)."""
        want = set(want_to_read)
        if want <= set(available):
            return want
        by_cost = sorted(available, key=lambda c: (available[c], c))
        if len(by_cost) < self.k:
            raise ValueError("not enough chunks to decode")
        return set(by_cost[:self.k])

    # -- array-level kernels (subclass provides) --------------------------
    @abstractmethod
    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        """(k, C) uint8 data chunks -> (m, C) uint8 parity chunks."""

    @abstractmethod
    def decode_chunks(self, want: Sequence[int],
                      chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        """Reconstruct chunk ids `want` from available `chunks`."""

    def is_mds(self) -> bool:
        """True when any k chunks decode everything (RS); layered codes
        (lrc/shec/clay) override to False and may want more chunks."""
        return False

    # -- batched kernels (subclasses override with fused device paths) ----
    def encode_batch(self, data):
        """(B, k, C) uint8 -> (B, m, C) parity. Base: per-stripe loop."""
        data = np.asarray(data)
        return np.stack([np.asarray(self.encode_chunks(data[b]))
                         for b in range(data.shape[0])])

    def encode_batch_reference(self, data):
        """(B, k, C) uint8 -> (B, m, C) parity via a HOST-ONLY path —
        no jit, no device, bit-exact with ``encode_batch`` by
        construction. This is the last rung of the OSD aggregator's
        degrade ladder (osd/ec_aggregator): when the device encode
        keeps failing, a client write is served from here rather than
        erroring. Base: the per-stripe loop (still host-only when
        ``encode_chunks`` is — device plugins MUST override with a
        genuinely device-free implementation)."""
        data = np.asarray(data)
        return np.stack([np.asarray(self.encode_chunks(data[b]))
                         for b in range(data.shape[0])])

    def encode_batch_with_crc(self, data):
        """(B, k, C) -> (parity (B, m, C), row_crcs (B, k+m) | None).

        ``row_crcs`` are per-row raw CRC32 values (ec.crc) for every
        data AND parity row of the batch, produced in the SAME device
        program as the encode when the plugin supports fusion. Base
        plugins return None — callers fall back to host zlib.crc32
        (the ec.crc.hcrc_attr contract)."""
        return self.encode_batch(data), None

    def decode_batch(self, want: Sequence[int], avail: Sequence[int],
                     chunks):
        """(B, len(avail), C) -> (B, len(want), C). Base: per-stripe."""
        chunks = np.asarray(chunks)
        out = []
        for b in range(chunks.shape[0]):
            got = self.decode_chunks(
                list(want), {a: chunks[b, i] for i, a in enumerate(avail)})
            out.append(np.stack([np.asarray(got[w]) for w in want]))
        return np.stack(out)

    def decode_batch_reference(self, want: Sequence[int],
                               avail: Sequence[int], chunks):
        """(B, len(avail), C) -> (B, len(want), C) via a HOST-ONLY
        path — no jit, no device, bit-exact with ``decode_batch`` by
        construction. The last rung of the OSD read aggregator's
        degrade ladder (osd/ec_read_aggregator): when the device
        decode keeps failing, a degraded read is served from here
        rather than erroring. Base: the per-stripe loop (still
        host-only when ``decode_chunks`` is — device plugins MUST
        override with a genuinely device-free implementation)."""
        chunks = np.asarray(chunks)
        out = []
        for b in range(chunks.shape[0]):
            got = self.decode_chunks(
                list(want), {a: chunks[b, i] for i, a in enumerate(avail)})
            out.append(np.stack([np.asarray(got[w]) for w in want]))
        return np.stack(out)

    # -- byte-level API (base implements; harness-compatible) -------------
    def encode_prepare(self, data: bytes) -> np.ndarray:
        """Pad to k*chunk_size and carve into the (k, C) chunk array
        (ref: src/erasure-code/ErasureCode.cc encode_prepare)."""
        chunk = self.get_chunk_size(len(data))
        padded = np.zeros(self.k * chunk, dtype=np.uint8)
        padded[:len(data)] = np.frombuffer(data, dtype=np.uint8)
        return padded.reshape(self.k, chunk)

    def encode(self, want_to_encode: Iterable[int],
               data: bytes) -> dict[int, bytes]:
        """ref: src/erasure-code/ErasureCode.cc encode."""
        chunks = self.encode_prepare(data)
        parity = np.asarray(self.encode_chunks(chunks))
        out: dict[int, bytes] = {}
        for i in want_to_encode:
            if i < self.k:
                out[i] = chunks[i].tobytes()
            else:
                out[i] = parity[i - self.k].tobytes()
        return out

    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, bytes],
               chunk_size: int | None = None) -> dict[int, bytes]:
        """ref: src/erasure-code/ErasureCode.cc decode -> decode_chunks."""
        arrs = {i: np.frombuffer(c, dtype=np.uint8) for i, c in chunks.items()}
        sizes = {a.shape[0] for a in arrs.values()}
        if chunk_size is not None:
            sizes.add(chunk_size)
        if len(sizes) > 1:
            raise ValueError(f"chunk size mismatch: {sorted(sizes)}")
        want = list(want_to_read)
        have = {i: arrs[i] for i in want if i in arrs}
        missing = [i for i in want if i not in arrs]
        if missing:
            have.update(self.decode_chunks(missing, arrs))
        return {i: np.asarray(have[i]).tobytes() for i in want}

    def decode_concat(self, chunks: Mapping[int, bytes]) -> bytes:
        """Reassemble the original object from data chunks
        (ref: src/erasure-code/ErasureCode.cc decode_concat)."""
        want = list(range(self.k))
        decoded = self.decode(want, chunks)
        return b"".join(decoded[i] for i in want)
