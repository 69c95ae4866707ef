"""Physical bounds of the card, the honesty guard of the benchmarks.

A rate above what the card's memory could move is a timing bug, not a
result: ``check`` refuses to report one. The bounds are optimistic
(least possible device-memory traffic), so a rate below them is possible,
not certified.

The table holds public datasheet figures (NVIDIA H100 Tensor Core GPU
datasheet): device-memory bandwidth and capacity, and the dense int8
tensor-core rate. It is keyed on ``torch.cuda.get_device_name()``. These
are a datasheet's numbers, not measurements.

The INT32 rate is derived, not quoted: the datasheet's non-tensor
float32 rate (66.9 TFLOP/s SXM, 51.2 PCIe) is SMs x 128 lanes x 2
(a fused multiply-add) x the boost clock, which gives 1.98 GHz (SXM,
132 SMs) and 1.755 GHz (PCIe, 114 SMs); a Hopper SM has 64 INT32 lanes
(the Hopper architecture white paper), so SMs x 64 x clock.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_bytes_per_s: float      # peak device-memory bandwidth
    hbm_bytes: float            # device-memory capacity
    int8_ops_per_s: float       # dense int8 tensor-core peak, operations/s
    int32_ops_per_s: float      # 32-bit integer ALU peak, operations/s


# Checked in order; the first key contained in the device name wins.
_SPECS = (
    ("H100 PCIe", DeviceSpec("H100 PCIe", 2.0e12, 80e9, 1513e12,
                             114 * 64 * 1.755e9)),
    ("H100", DeviceSpec("H100 SXM", 3.35e12, 80e9, 1979e12,
                        132 * 64 * 1.98e9)),
)


def device_spec(device_name: str) -> DeviceSpec | None:
    """Spec for a CUDA device name; None when the card is not in the
    table (and for the CPU, where no guard applies)."""
    for key, spec in _SPECS:
        if key in device_name:
            return spec
    return None


def bound_seconds(bytes_moved: float, ops: float, spec: DeviceSpec,
                  ops_per_s: float | None = None) -> tuple[float, str]:
    """The least time the card could take for a function that must move
    ``bytes_moved`` bytes and do ``ops`` operations at ``ops_per_s``
    (default: the int8 tensor-core rate): the larger of the two times,
    and which one bounds it ("bytes" or "operations")."""
    t_bytes = bytes_moved / spec.hbm_bytes_per_s
    t_ops = ops / (ops_per_s or spec.int8_ops_per_s)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_encode_work(B: int, k: int, m: int, C: int) -> tuple[int, int]:
    """(bytes, operations) of one (B, k, C) x (8m, 8k) GF(2^8) product:
    read each input byte once, write each output byte once; the bit-plane
    form does (8m)(8k) multiply-accumulates (2 operations) per column."""
    return B * (k + m) * C, 2 * 64 * m * k * B * C


# 32-bit operations of one straw2 slot evaluation in csrc/crush_straw2.cu,
# counted with Hopper's three-input add and logic (IADD3, LOP3): each
# rjenkins mix line (a -= b; a -= c; a ^= c >> k) is 3, a mix 27, hash3
# 2 + 5 mixes = 137; crush_ln 12; subtracting 2^48 2 (64-bit); the
# 64-bit division counted as ONE 64-bit operation, 2 (the card has no
# divider and emulates it in tens of instructions: so this is a floor);
# the zero-weight test 1; compare and select 3.
CRUSH_SLOT_OPS = 137 + 12 + 2 + 2 + 1 + 3


def crush_straw2_work(level_min_slots, n: int, numrep: int, n_cand: int,
                      table_bytes: int = 0) -> tuple[int, int]:
    """(bytes, operations) of one crush_straw2 launch over n lanes: read
    each seed (4 B) and the map's tables once, write numrep leaves and a
    bad flag (4 B each); every lane evaluates n_cand candidates, each
    visiting one row per level, counted at each level's smallest row (so
    the count is exact on maps whose rows per level are equal, and a
    floor elsewhere). The is_out hash of reweighted leaves is not
    counted."""
    slots = sum(level_min_slots)
    return (4 * n * (numrep + 2) + table_bytes,
            n * n_cand * slots * CRUSH_SLOT_OPS)


def encode_bound(k: int, m: int, spec: DeviceSpec) -> float:
    """Upper bound on encode *input* bytes/s: each input byte costs at
    least 1 (read data) + m/k (write parity) bytes of traffic; the
    operations never bound this function (see gf_encode_work)."""
    return spec.hbm_bytes_per_s / (1.0 + m / k)


def decode_bound(n_erased: int, n_read: int, spec: DeviceSpec) -> float:
    """Upper bound on decode *read* bytes/s (the benchmark's headline
    decode unit): each read byte costs at least 1 + n_erased/n_read
    bytes of traffic."""
    return spec.hbm_bytes_per_s / (1.0 + max(n_erased, 1) / n_read)


class RooflineViolation(RuntimeError):
    pass


def check(measured_bytes_per_s: float, bound_bytes_per_s: float | None,
          what: str = "throughput") -> None:
    """Refuse to report a physically impossible number."""
    if bound_bytes_per_s is None:
        return
    if measured_bytes_per_s > bound_bytes_per_s * 1.02:  # 2% timer slack
        raise RooflineViolation(
            f"measured {what} {measured_bytes_per_s / 2**30:.1f} GiB/s exceeds "
            f"the device bound {bound_bytes_per_s / 2**30:.1f} GiB/s; the "
            f"timing loop is not measuring execution")
