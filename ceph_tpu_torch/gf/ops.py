"""GF(2^8) linear algebra over byte streams, as plain torch ops.

The counterparts of ``ceph_tpu/gf/ops.py``: the bit-plane product
(``bitmatmul``), the nibble-table product (``lut``) and the packet-plane
product of the array codes. They run on whatever device their tensors
lie on; the fused encode kernel lives in ``kernels.py``.

Layouts: byte payloads are (k, L) uint8, k chunks of L bytes. Every op
also takes leading batch dimensions, (..., k, L), which is how the batched
``encode_stripes`` runs without the reference's (k, B*C) transpose.

The bit-plane products use float32 matmuls. They are exact: every operand
is 0 or 1 (exact in float32 and in TF32, should
``torch.backends.cuda.matmul.allow_tf32`` be on) and every partial sum is
an integer at most 8k <= 2048, exact in the float32 accumulator. An int8
``torch.matmul`` would not do: it returns int8 on the CPU, wrapping the
sum, and is not implemented on CUDA.
"""

from __future__ import annotations

import functools

import torch

from ceph_tpu_torch.gf import tables


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-accumulate along a dimension (GF(2^8) addition)."""
    parts = x.unbind(dim)
    return functools.reduce(torch.bitwise_xor, parts[1:], parts[0].clone())


def _shifts(like: torch.Tensor) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=like.device)


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., k, L) uint8 -> (..., 8k, L) int8 bit-planes, LSB-first.

    Chunk i's bits occupy rows [8i, 8i+8), bit j (value 2^j) at row 8i+j,
    matching tables.expand_bitmatrix.
    """
    *lead, k, L = data.shape
    bits = (data.unsqueeze(-2) >> _shifts(data).view(8, 1)) & 1
    return bits.reshape(*lead, 8 * k, L).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8m, L) 0/1 -> (..., m, L) uint8, inverse of unpack_bits."""
    *lead, m8, L = bits.shape
    b = bits.reshape(*lead, m8 // 8, 8, L).to(torch.int32)
    weights = (1 << _shifts(bits).to(torch.int32)).view(8, 1)
    return (b * weights).sum(dim=-2).to(torch.uint8)


def gf_matmul_bitplanes(bitmatrix: torch.Tensor,
                        data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) coding-matrix product as one binary matmul.

    bitmatrix: (8m, 8k) 0/1 (tables.expand_bitmatrix of the GF matrix, or
    any GF(2) matrix of that shape); data: (..., k, L) uint8.
    Returns (..., m, L) uint8: the XOR is the low bit of the integer sum.
    """
    bits = unpack_bits(data).to(torch.float32)
    acc = torch.matmul(bitmatrix.to(torch.float32), bits)
    return pack_bits(acc.to(torch.int32) & 1)


def gf_matmul_lut(lo: torch.Tensor, hi: torch.Tensor,
                  data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) coding-matrix product via nibble product tables.

    lo, hi: (m, k, 16) uint8 from tables.nibble_tables; data: (..., k, L)
    uint8. Returns (..., m, L) uint8.
    """
    m, k, _ = lo.shape
    low = (data & 15).long().unsqueeze(-3)               # (..., 1, k, L)
    high = (data >> 4).long().unsqueeze(-3)
    shape = (*data.shape[:-2], m, k, 16)
    prod = (torch.gather(lo.expand(shape), -1, low.expand(*shape[:-1],
                                                          data.shape[-1]))
            ^ torch.gather(hi.expand(shape), -1, high.expand(
                *shape[:-1], data.shape[-1])))          # (..., m, k, L)
    return xor_reduce(prod, dim=-2)


def gf_matmul_bytes(matrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Full 256x256 product-table gathers: (m, k) uint8 coefficients x
    (k, L) uint8 -> (m, L). Slow; for testing and validation only."""
    table = torch.tensor(tables.mul_table().reshape(-1),
                         device=data.device)
    idx = matrix[:, :, None].long() * 256 + data[None].long()
    return xor_reduce(table[idx], dim=1)


def gf2_matmul_bytes(bm: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """GF(2) combine of byte rows: out[i] = XOR_{j: bm[i,j]=1} planes[j],
    for planes (R_in, L) uint8 -> (R_out, L) uint8.

    The packet-granularity bitmatrix product of the array codes
    (liberation, blaum_roth, liber8tion): each byte's 8 bits ride as
    parallel lanes, the contraction is over packet rows only.
    """
    r_in, L = planes.shape
    bits = (planes.unsqueeze(1) >> _shifts(planes).view(8, 1)) & 1
    acc = torch.matmul(bm.to(torch.float32),
                       bits.reshape(r_in, 8 * L).to(torch.float32))
    return pack_bits((acc.to(torch.int32) & 1).reshape(-1, L))


def bitmatrix_encode_stripes(bm: torch.Tensor, data: torch.Tensor,
                             w: int) -> torch.Tensor:
    """Batched packet-plane encode: data (B, k, C) with C % w == 0 ->
    (B, rows_out/w, C). Each chunk is w packets of C/w bytes (jerasure's
    word/packet layout); drive d's packets are bitmatrix rows
    [d*w, (d+1)*w)."""
    B, k, C = data.shape
    ps = C // w
    flat = data.reshape(B, k * w, ps).transpose(0, 1).reshape(k * w, B * ps)
    out = gf2_matmul_bytes(bm, flat)                     # (mw, B*ps)
    mw = out.shape[0]
    return out.reshape(mw, B, ps).transpose(0, 1).reshape(B, mw // w, C)


def encode_stripes(bitmatrix: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, data: torch.Tensor,
                   backend: str = "bitmatmul") -> torch.Tensor:
    """Batched stripe encode: data (batch, k, C) uint8 -> (batch, m, C).

    Every stripe is independent; the ops take the batch as a leading
    dimension, so no transpose is needed. ``backend="kernel"`` launches
    the encode kernel (``kernels.gf_encode``: its plain version on the
    CPU), the others are the plain torch products.
    """
    if backend == "kernel":
        from ceph_tpu_torch.gf import kernels
        return kernels.gf_encode(bitmatrix, data)
    if backend == "bitmatmul":
        return gf_matmul_bitplanes(bitmatrix, data)
    if backend == "lut":
        return gf_matmul_lut(lo, hi, data)
    raise ValueError(f"unknown gf backend {backend!r}")
