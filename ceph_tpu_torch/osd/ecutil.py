"""Stripe geometry math for erasure-coded objects.

ref: src/osd/ECUtil.h (ECUtil::stripe_info_t). An EC object is striped:
logical bytes are laid out rotor-style across k data chunks per stripe of
``stripe_width = k * chunk_size`` bytes; each chunk lands on a distinct
shard (spg_t shard id). Partial writes must be widened to full stripes
(the read-modify-write pipeline, ref: src/osd/ECCommon.h RMWPipeline).

All helpers are pure integer math (host-side planning); the data path
they feed is batched on device.

The port's copy of ``ceph_tpu/osd/ecutil.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StripeInfo:
    """ref: ECUtil::stripe_info_t (k = stripe_width / chunk_size)."""

    k: int
    chunk_size: int

    @property
    def stripe_width(self) -> int:
        return self.k * self.chunk_size

    # -- offset mapping (names mirror the reference methods) --------------
    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        """Round a logical offset down to its stripe start."""
        return offset - offset % self.stripe_width

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        """Round a logical offset up to the next stripe boundary."""
        return -(-offset // self.stripe_width) * self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        """Stripe-aligned logical offset -> per-shard chunk offset."""
        assert offset % self.stripe_width == 0, offset
        return offset // self.k

    def chunk_aligned_logical_offset(self, chunk_offset: int) -> int:
        assert chunk_offset % self.chunk_size == 0, chunk_offset
        return chunk_offset * self.k

    def offset_len_to_stripe_bounds(self, offset: int,
                                    length: int) -> tuple[int, int]:
        """(aligned_offset, aligned_length) covering [offset, offset+len)
        widened to whole stripes — the RMW read set."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    def stripe_range(self, offset: int, length: int) -> tuple[int, int]:
        """(first_stripe, n_stripes) touched by a logical byte range."""
        start, alen = self.offset_len_to_stripe_bounds(offset, length)
        return start // self.stripe_width, alen // self.stripe_width

    def object_stripes(self, logical_size: int) -> int:
        return -(-logical_size // self.stripe_width) if logical_size else 0

    # -- byte <-> (stripe, chunk, intra) decomposition --------------------
    def logical_to_stripe_chunk(self, offset: int) -> tuple[int, int, int]:
        """logical byte -> (stripe index, data chunk index, byte within
        chunk). Layout: stripe s holds logical bytes
        [s*W, (s+1)*W) split contiguously into k chunks."""
        stripe, within = divmod(offset, self.stripe_width)
        chunk, intra = divmod(within, self.chunk_size)
        return stripe, chunk, intra
