"""Binary codecs of the placement maps (copy of ``ceph_tpu.encoding``)."""

from ceph_tpu_torch.encoding.denc import (
    BufferList, Decoder, Encoder, EncodingError,
)
from ceph_tpu_torch.encoding.maps import (
    decode_crush_map, decode_incremental, decode_osdmap,
    encode_crush_map, encode_incremental, encode_osdmap,
)

__all__ = [
    "BufferList", "Decoder", "Encoder", "EncodingError",
    "encode_crush_map", "decode_crush_map",
    "encode_osdmap", "decode_osdmap",
    "encode_incremental", "decode_incremental",
]
