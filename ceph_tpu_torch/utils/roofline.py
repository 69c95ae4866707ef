"""Physical bounds of the card, the honesty guard of the benchmarks.

A rate above what the card's memory could move is a timing bug, not a
result: ``check`` refuses to report one. The bounds are optimistic
(least possible device-memory traffic), so a rate below them is possible,
not certified.

The table holds public datasheet figures (NVIDIA H100 Tensor Core GPU
datasheet): device-memory bandwidth and capacity, and the dense int8
tensor-core rate. It is keyed on ``torch.cuda.get_device_name()``. These
are a datasheet's numbers, not measurements.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_bytes_per_s: float      # peak device-memory bandwidth
    hbm_bytes: float            # device-memory capacity
    int8_ops_per_s: float       # dense int8 tensor-core peak, operations/s


# Checked in order; the first key contained in the device name wins.
_SPECS = (
    ("H100 PCIe", DeviceSpec("H100 PCIe", 2.0e12, 80e9, 1513e12)),
    ("H100", DeviceSpec("H100 SXM", 3.35e12, 80e9, 1979e12)),
)


def device_spec(device_name: str) -> DeviceSpec | None:
    """Spec for a CUDA device name; None when the card is not in the
    table (and for the CPU, where no guard applies)."""
    for key, spec in _SPECS:
        if key in device_name:
            return spec
    return None


def bound_seconds(bytes_moved: float, ops: float, spec: DeviceSpec) -> tuple[
        float, str]:
    """The least time the card could take for a function that must move
    ``bytes_moved`` bytes and do ``ops`` int8-class operations: the larger
    of the two times, and which one bounds it ("bytes" or "operations")."""
    t_bytes = bytes_moved / spec.hbm_bytes_per_s
    t_ops = ops / spec.int8_ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_encode_work(B: int, k: int, m: int, C: int) -> tuple[int, int]:
    """(bytes, operations) of one (B, k, C) x (8m, 8k) GF(2^8) product:
    read each input byte once, write each output byte once; the bit-plane
    form does (8m)(8k) multiply-accumulates (2 operations) per column."""
    return B * (k + m) * C, 2 * 64 * m * k * B * C


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
