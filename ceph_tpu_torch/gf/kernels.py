"""The GF(2^8) encode kernel: its wrapper, its plain version, its count.

``gf_encode(bitmatrix, data)`` computes what
``ceph_tpu/gf/pallas_kernels.py::encode_batch_planned`` computes on the
TPU: the GF(2^8) matrix product of (B, k, C) uint8 stripes with an
(8m, 8k) GF(2) bitmatrix, giving (B, m, C) uint8. It serves Reed-Solomon
encode and every decode pattern of the erasure-code plugin.

On a CUDA tensor it launches the hand-written kernel
``ceph_tpu_torch/csrc/gf_encode.cu`` (nibble tables in shared memory,
16 bytes a thread; the source says what bounds it and why), or raises.
On a CPU tensor it runs the plain version, ``gf_encode_plain``. The
kernel takes any C >= 1, so unlike the TPU kernel it needs no shape gate.

``gf_encode.launches`` counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ceph_tpu_torch.gf import ops
from ceph_tpu_torch.utils import cuda_build


def gf_encode_plain(bitmatrix: torch.Tensor,
                    data: torch.Tensor) -> torch.Tensor:
    """The kernel's plain torch version: unpack the bit planes, take the
    exact float32 product, keep the low bit, pack back to bytes."""
    _check_shapes(bitmatrix, data)
    return ops.gf_matmul_bitplanes(bitmatrix, data)


@functools.cache
def _launcher():
    lib = cuda_build.load("gf_encode")
    fn = lib.gf_encode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gf_encode_error_string.argtypes = [ctypes.c_int]
    lib.gf_encode_error_string.restype = ctypes.c_char_p
    return fn, lib.gf_encode_error_string


def _check_shapes(bitmatrix: torch.Tensor, data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError(f"data must be (B, k, C) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if bitmatrix.dtype not in (torch.uint8, torch.int8) \
            or bitmatrix.dim() != 2 or bitmatrix.shape[0] % 8 \
            or bitmatrix.shape[1] != 8 * data.shape[1]:
        raise ValueError(f"bitmatrix must be (8m, 8k={8 * data.shape[1]}) "
                         f"uint8/int8, got {tuple(bitmatrix.shape)} "
                         f"{bitmatrix.dtype}")


def gf_encode(bitmatrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(8m, 8k) 0/1 bitmatrix x (B, k, C) uint8 -> (B, m, C) uint8."""
    _check_shapes(bitmatrix, data)
    if data.device.type == "cpu" and bitmatrix.device.type == "cpu":
        return gf_encode_plain(bitmatrix, data)
    if data.device.type != "cuda" or bitmatrix.device != data.device:
        raise ValueError(f"gf_encode needs both tensors on one CUDA device "
                         f"(or both on the CPU), got {bitmatrix.device} "
                         f"and {data.device}")
    if not (data.is_contiguous() and bitmatrix.is_contiguous()):
        raise ValueError("gf_encode needs contiguous tensors")
    B, k, C = data.shape
    m = bitmatrix.shape[0] // 8
    out = torch.empty((B, m, C), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    launch, error_string = _launcher()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = launch(bitmatrix.data_ptr(), data.data_ptr(), out.data_ptr(),
                     B, k, m, C, stream)
    if err:
        raise RuntimeError(f"gf_encode launch failed: "
                           f"{error_string(err).decode()} (cudaError {err})")
    _counted.launches += 1
    return out


gf_encode.launches = 0
# the count lives on this function object, so a wrapper bound to the
# name ``gf_encode`` later (a checking hook) does not take it over
_counted = gf_encode
