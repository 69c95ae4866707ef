"""The GF(2^8) encode kernel: its wrappers, its plan, its plain version,
its count.

``gf_encode(bitmatrix, data)`` computes what
``ceph_tpu/gf/pallas_kernels.py::encode_batch_planned`` computes on the
TPU: the GF(2^8) matrix product of (B, k, C) uint8 stripes with an
(8m, 8k) GF(2) bitmatrix, giving (B, m, C) uint8. It serves Reed-Solomon
encode and every decode pattern of the erasure-code plugin.

As in the reference, a coding matrix that is applied many times gets a
plan: ``make_plan(bitmatrix, device)`` builds the kernel's nibble-table
words once, on the host, and uploads them; ``encode_batch_planned(plan,
data)`` then launches the kernel with them, so no block derives its
tables from the bitmatrix (``gf_encode`` leaves that to each block).

On a CUDA tensor both entry points launch the hand-written kernel
``ceph_tpu_torch/csrc/gf_encode.cu`` (nibble tables in shared memory,
16 bytes a thread; the source says what bounds it and why), or raise.
On a CPU tensor they run the plain version, ``gf_encode_plain``. The
kernel takes any C >= 1, so unlike the TPU kernel it needs no shape gate.

``gf_encode.launches`` counts the kernel's launches from both entry
points, and nothing else: building a plan launches nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.gf import ops
from ceph_tpu_torch.utils import cuda_build
from ceph_tpu_torch.utils import device as devsel

GROUP = 4   # output rows packed into one table word, as in the kernel


class EncodePlan(NamedTuple):
    """One coding bitmatrix, ready for the kernel on one device."""
    bitmatrix: torch.Tensor   # (8m, 8k) uint8
    words: torch.Tensor       # (groups, k, 2, 16) int32: the uint32 words
    k: int
    m: int
    device: torch.device


def gf_encode_plain(bitmatrix: torch.Tensor,
                    data: torch.Tensor) -> torch.Tensor:
    """The kernel's plain torch version: unpack the bit planes, take the
    exact float32 product, keep the low bit, pack back to bytes."""
    _check_shapes(bitmatrix, data)
    return ops.gf_matmul_bitplanes(bitmatrix, data)


def plan_words(bitmatrix) -> np.ndarray:
    """The kernel's table words of an (8m, 8k) 0/1 bitmatrix, as
    ``tab[g][i][h][n]`` (uint32, shape (ceil(m / 4), k, 2, 16)): byte j of
    the word is output row 4g+j's image of the input byte ``n << 4h`` in
    row i (rows past m are zero). Only the low bit of each entry counts,
    as in the kernel."""
    bm = np.asarray(bitmatrix, dtype=np.uint8) & 1
    if bm.ndim != 2 or bm.shape[0] % 8 or bm.shape[1] % 8 or not bm.size:
        raise ValueError(f"bitmatrix must be (8m, 8k), got {bm.shape}")
    m, k = bm.shape[0] // 8, bm.shape[1] // 8
    groups = -(-m // GROUP)
    # bits of each nibble image's input byte: (h, n, b')
    x = (np.arange(16)[None, :] << (4 * np.arange(2))[:, None])
    xbits = (x[:, :, None] >> np.arange(8)) & 1
    # output bits r of input row i's images: (i, h, n, r)
    ybits = np.einsum("rib,hnb->ihnr", bm.reshape(8 * m, k, 8).astype(
        np.int64), xbits) & 1
    images = (ybits.reshape(k, 2, 16, m, 8) << np.arange(8)).sum(axis=-1)
    padded = np.zeros((k, 2, 16, GROUP * groups), dtype=np.uint32)
    padded[..., :m] = images
    words = (padded.reshape(k, 2, 16, groups, GROUP) <<
             (8 * np.arange(GROUP, dtype=np.uint32))).sum(
                 axis=-1, dtype=np.uint32)
    return np.ascontiguousarray(words.transpose(3, 0, 1, 2))


def make_plan(bitmatrix, device: str | torch.device | None = None
              ) -> EncodePlan:
    """A plan for one coding bitmatrix (numpy or a tensor) on ``device``
    (the card unless the caller asks for the CPU): the bitmatrix and its
    table words, each uploaded once."""
    if isinstance(bitmatrix, torch.Tensor):
        bitmatrix = bitmatrix.cpu().numpy()
    bm = np.ascontiguousarray(bitmatrix, dtype=np.uint8)
    words = plan_words(bm)
    dev = devsel.resolve(device)
    words_t = torch.as_tensor(words.view(np.int32), device=dev)
    return EncodePlan(torch.as_tensor(bm, device=dev), words_t,
                      bm.shape[1] // 8, bm.shape[0] // 8, words_t.device)


@functools.cache
def _launcher():
    lib = cuda_build.load("gf_encode")
    fn = lib.gf_encode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
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


def _on_one_card(what: str, owner: torch.device, data: torch.Tensor) -> None:
    if data.device.type != "cuda" or owner != data.device:
        raise ValueError(f"{what} needs its operands on one CUDA device "
                         f"(or all on the CPU), got {owner} and "
                         f"{data.device}")
    if not data.is_contiguous():
        raise ValueError(f"{what} needs contiguous tensors")


def _launch(bitmatrix: torch.Tensor, words: torch.Tensor | None,
            data: torch.Tensor) -> torch.Tensor:
    """One kernel launch on the data's device and current stream."""
    B, k, C = data.shape
    m = bitmatrix.shape[0] // 8
    out = torch.empty((B, m, C), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    launch, error_string = _launcher()
    dev = data.device.index
    args = (bitmatrix.data_ptr(), 0 if words is None else words.data_ptr(),
            data.data_ptr(), out.data_ptr(), B, k, m, C, dev,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(dev):
            err = launch(*args)
    if err:
        raise RuntimeError(f"gf_encode launch failed: "
                           f"{error_string(err).decode()} (cudaError {err})")
    _counted.launches += 1
    return out


def gf_encode(bitmatrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(8m, 8k) 0/1 bitmatrix x (B, k, C) uint8 -> (B, m, C) uint8."""
    _check_shapes(bitmatrix, data)
    if data.device.type == "cpu" and bitmatrix.device.type == "cpu":
        return gf_encode_plain(bitmatrix, data)
    _on_one_card("gf_encode", bitmatrix.device, data)
    if not bitmatrix.is_contiguous():
        raise ValueError("gf_encode needs contiguous tensors")
    return _launch(bitmatrix, None, data)


def encode_batch_planned(plan: EncodePlan,
                         data: torch.Tensor) -> torch.Tensor:
    """plan x (B, k, C) uint8 -> (B, m, C) uint8, with the plan's table
    words (the counterpart of the reference's ``encode_batch_planned``)."""
    _check_shapes(plan.bitmatrix, data)
    if data.device.type == "cpu" and plan.device.type == "cpu":
        return gf_encode_plain(plan.bitmatrix, data)
    _on_one_card("encode_batch_planned", plan.device, data)
    return _launch(plan.bitmatrix, plan.words, data)


gf_encode.launches = 0
# the count lives on this function object, so a wrapper bound to the
# name ``gf_encode`` later (a checking hook) does not take it over
_counted = gf_encode
