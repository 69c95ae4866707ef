"""Binary encoding primitives: the bufferlist/denc analog.

ref: src/include/buffer.h (ceph::buffer::list), src/include/denc.h and
src/include/encoding.h (ENCODE_START/DECODE_START versioned sections).
Same wire discipline as the reference — little-endian fixed-width ints,
u32-length-prefixed strings/blobs, and versioned struct sections carrying
(struct_v, struct_compat, length) so old decoders can skip unknown
trailing fields and new decoders can reject incompatible structs — but
the byte layout is this framework's own (the reference tree was not
available to byte-match; tests/golden pins OUR format so it cannot
drift silently between versions).

The port's copy of ``ceph_tpu/encoding/denc.py``.
"""

from __future__ import annotations

import struct
from contextlib import contextmanager
from typing import Callable, Iterable


class EncodingError(Exception):
    pass


class BufferList:
    """Chained-segment byte container (ref: src/include/buffer.h
    ceph::buffer::list — append-only builder + zero-copy reads).

    Appending never copies existing segments; ``tobytes`` flattens once.
    """

    def __init__(self, data: bytes | bytearray | memoryview | None = None):
        self._segs: list[memoryview] = []
        self._len = 0
        if data is not None:
            self.append(data)

    def append(self, data) -> None:
        if isinstance(data, BufferList):
            self._segs.extend(data._segs)
            self._len += data._len
            return
        mv = memoryview(data).cast("B") if not isinstance(data, memoryview) \
            else data.cast("B")
        if len(mv):
            self._segs.append(mv)
            self._len += len(mv)

    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        return iter(self._segs)

    def tobytes(self) -> bytes:
        if len(self._segs) == 1:
            return bytes(self._segs[0])
        return b"".join(bytes(s) for s in self._segs)

    def substr(self, off: int, length: int) -> bytes:
        return self.tobytes()[off:off + length]

    def crc32(self, seed: int = 0) -> int:
        import zlib
        c = seed
        for s in self._segs:
            c = zlib.crc32(s, c)
        return c & 0xFFFFFFFF


class Encoder:
    """Little-endian append-only encoder (the ::encode side)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    # -- fixed-width ints --------------------------------------------------
    def u8(self, v: int) -> "Encoder":
        self._buf += struct.pack("<B", v)
        return self

    def u16(self, v: int) -> "Encoder":
        self._buf += struct.pack("<H", v)
        return self

    def u32(self, v: int) -> "Encoder":
        self._buf += struct.pack("<I", v & 0xFFFFFFFF)
        return self

    def u64(self, v: int) -> "Encoder":
        self._buf += struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF)
        return self

    def s32(self, v: int) -> "Encoder":
        self._buf += struct.pack("<i", v)
        return self

    def s64(self, v: int) -> "Encoder":
        self._buf += struct.pack("<q", v)
        return self

    def f64(self, v: float) -> "Encoder":
        self._buf += struct.pack("<d", v)
        return self

    def bool(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    # -- variable ----------------------------------------------------------
    def blob(self, b: bytes | bytearray | memoryview) -> "Encoder":
        self.u32(len(b))
        self._buf += b
        return self

    def string(self, s: str) -> "Encoder":
        return self.blob(s.encode("utf-8"))

    def raw(self, b: bytes) -> "Encoder":
        self._buf += b
        return self

    # -- containers --------------------------------------------------------
    def list(self, items: Iterable, fn: Callable[["Encoder", object], None]
             ) -> "Encoder":
        items = list(items)
        self.u32(len(items))
        for it in items:
            fn(self, it)
        return self

    def map(self, d: dict, kfn, vfn) -> "Encoder":
        self.u32(len(d))
        for k, v in d.items():
            kfn(self, k)
            vfn(self, v)
        return self

    def optional(self, v, fn) -> "Encoder":
        if v is None:
            return self.bool(False)
        self.bool(True)
        fn(self, v)
        return self

    # -- versioned sections ------------------------------------------------
    @contextmanager
    def start(self, version: int, compat: int = 1):
        """ENCODE_START analog: u8 struct_v, u8 struct_compat, u32 len."""
        self.u8(version).u8(compat)
        pos = len(self._buf)
        self.u32(0)  # length placeholder
        yield self
        length = len(self._buf) - pos - 4
        struct.pack_into("<I", self._buf, pos, length)

    def tobytes(self) -> bytes:
        return bytes(self._buf)


class Decoder:
    """The ::decode side; bounds-checked, forward-compatible sections."""

    def __init__(self, data: bytes | bytearray | memoryview, off: int = 0):
        self._mv = memoryview(data)
        self.off = off

    def _take(self, n: int) -> memoryview:
        if self.off + n > len(self._mv):
            raise EncodingError(
                f"decode past end ({self.off}+{n} > {len(self._mv)})")
        out = self._mv[self.off:self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def s32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def s64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def bool(self) -> bool:
        return self.u8() != 0

    def blob(self) -> bytes:
        return bytes(self._take(self.u32()))

    def blob_view(self) -> memoryview:
        """Zero-copy blob: a view over the decoder's buffer instead of
        a bytes copy. For bulk payloads (EC write data) the view rides
        the received wire frame all the way into ``np.frombuffer`` —
        no host staging copy between the messenger and the device
        transfer. Holding the view keeps the whole frame alive; copy
        (``bytes(v)``) anything retained past the op."""
        return self._take(self.u32())

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def list(self, fn: Callable[["Decoder"], object]) -> list:
        return [fn(self) for _ in range(self.u32())]

    def map(self, kfn, vfn) -> dict:
        return {kfn(self): vfn(self) for _ in range(self.u32())}

    def optional(self, fn):
        return fn(self) if self.bool() else None

    @contextmanager
    def start(self, max_compat: int):
        """DECODE_START analog: yields struct_v; on exit skips any
        trailing bytes a newer encoder appended (forward compat); raises
        if the struct requires a decoder newer than ``max_compat``."""
        v = self.u8()
        compat = self.u8()
        length = self.u32()
        end = self.off + length
        if end > len(self._mv):
            raise EncodingError("section length past end")
        if compat > max_compat:
            raise EncodingError(
                f"struct requires decoder v{compat}, have v{max_compat}")
        yield v
        if self.off > end:
            raise EncodingError("decoded past section end")
        self.off = end

    def remaining(self) -> int:
        return len(self._mv) - self.off
