"""GF(2^8) arithmetic: numpy tables, torch ops, the CUDA encode kernel."""

from ceph_tpu_torch.gf.tables import (
    GF_POLY,
    gf_mul,
    gf_div,
    gf_inv,
    gf_pow,
    gf_mul_np,
    gf_matmul_np,
    gf_matinv_np,
    coeff_bitmatrix,
    expand_bitmatrix,
    nibble_tables,
)
from ceph_tpu_torch.gf.ops import (
    unpack_bits,
    pack_bits,
    gf_matmul_bitplanes,
    gf_matmul_lut,
    gf_matmul_bytes,
)
