"""Message model: typed, self-encoding wire messages.

ref: src/msg/Message.{h,cc} — every wire op is a Message subclass with a
numeric type, a versioned payload, and encode/decode. The reference
registers types in a giant decode_message switch; here a registry maps
type codes to classes and a declarative ``fields`` spec generates the
common payload codecs (subclasses with odd shapes override
encode_payload/decode_payload).

The port's copy of ``ceph_tpu/msg/message.py``.
"""

from __future__ import annotations

from typing import Callable, ClassVar

from ceph_tpu_torch.encoding.denc import Decoder, Encoder

_REGISTRY: dict[int, type["Message"]] = {}


def register(cls: type["Message"]) -> type["Message"]:
    code = cls.TYPE
    if code in _REGISTRY and _REGISTRY[code] is not cls:
        raise ValueError(f"message type {code} already registered "
                         f"({_REGISTRY[code].__name__})")
    _REGISTRY[code] = cls
    return cls


# field codecs for the declarative spec
_ENC: dict[str, Callable] = {
    "u8": lambda e, v: e.u8(v), "u16": lambda e, v: e.u16(v),
    "u32": lambda e, v: e.u32(v), "u64": lambda e, v: e.u64(v),
    "s32": lambda e, v: e.s32(v), "s64": lambda e, v: e.s64(v),
    "f64": lambda e, v: e.f64(v),
    "bool": lambda e, v: e.bool(v), "str": lambda e, v: e.string(v),
    "blob": lambda e, v: e.blob(v),
    "blob_view": lambda e, v: e.blob(v),
    "list:s32": lambda e, v: e.list(v, lambda e, x: e.s32(x)),
    "list:u32": lambda e, v: e.list(v, lambda e, x: e.u32(x)),
    "list:u64": lambda e, v: e.list(v, lambda e, x: e.u64(x)),
    "list:str": lambda e, v: e.list(v, lambda e, x: e.string(x)),
    "list:blob": lambda e, v: e.list(v, lambda e, x: e.blob(x)),
    "list:blob_view": lambda e, v: e.list(v, lambda e, x: e.blob(x)),
    "map:str:str": lambda e, v: e.map(v, lambda e, k: e.string(k),
                                      lambda e, x: e.string(x)),
    "map:str:u64": lambda e, v: e.map(v, lambda e, k: e.string(k),
                                      lambda e, x: e.u64(x)),
    "map:str:blob": lambda e, v: e.map(v, lambda e, k: e.string(k),
                                       lambda e, x: e.blob(x)),
    "map:s32:blob": lambda e, v: e.map(v, lambda e, k: e.s32(k),
                                       lambda e, x: e.blob(x)),
    "map:u64:blob": lambda e, v: e.map(v, lambda e, k: e.u64(k),
                                       lambda e, x: e.blob(x)),
}
_DEC: dict[str, Callable] = {
    "u8": lambda d: d.u8(), "u16": lambda d: d.u16(),
    "u32": lambda d: d.u32(), "u64": lambda d: d.u64(),
    "s32": lambda d: d.s32(), "s64": lambda d: d.s64(),
    "f64": lambda d: d.f64(),
    "bool": lambda d: d.bool(), "str": lambda d: d.string(),
    "blob": lambda d: d.blob(),
    # zero-copy on decode (the encode side is plain blob): bulk
    # payloads arrive as memoryviews over the wire frame and feed
    # np.frombuffer / the streaming encode pipeline without a host
    # staging copy
    "blob_view": lambda d: d.blob_view(),
    "list:s32": lambda d: d.list(lambda d: d.s32()),
    "list:u32": lambda d: d.list(lambda d: d.u32()),
    "list:u64": lambda d: d.list(lambda d: d.u64()),
    "list:str": lambda d: d.list(lambda d: d.string()),
    "list:blob": lambda d: d.list(lambda d: d.blob()),
    "list:blob_view": lambda d: d.list(lambda d: d.blob_view()),
    "map:str:str": lambda d: d.map(lambda d: d.string(),
                                   lambda d: d.string()),
    "map:str:u64": lambda d: d.map(lambda d: d.string(),
                                   lambda d: d.u64()),
    "map:str:blob": lambda d: d.map(lambda d: d.string(),
                                    lambda d: d.blob()),
    "map:s32:blob": lambda d: d.map(lambda d: d.s32(),
                                    lambda d: d.blob()),
    "map:u64:blob": lambda d: d.map(lambda d: d.u64(),
                                    lambda d: d.blob()),
}


# zero value per codec family: omitted constructor fields default to
# it, so appending a field to a message's FIELDS doesn't break older
# construction sites (the reference's versioned-payload evolution)
def _zero(codec: str):
    base = codec.split(":", 1)[0]
    if base in ("u8", "u16", "u32", "u64", "s32", "s64"):
        return 0
    if base == "f64":
        return 0.0
    if base == "bool":
        return False
    if base == "str":
        return ""
    if base in ("blob", "blob_view"):
        return b""
    if base == "list":
        return []
    return {}                                   # map


class Message:
    """Base wire message. Subclasses set TYPE and either a ``FIELDS``
    spec ([(name, codec), ...]) or override encode/decode_payload."""

    TYPE: ClassVar[int] = 0
    FIELDS: ClassVar[list[tuple[str, str]]] = []

    def __init__(self, **kw):
        for name, codec in self.FIELDS:
            setattr(self, name,
                    kw.pop(name) if name in kw else _zero(codec))
        if kw:
            raise TypeError(f"unknown fields {sorted(kw)} for "
                            f"{type(self).__name__}")
        # transport metadata (set by the messenger on receive)
        self.seq = 0
        self.src = None          # EntityName of the sender
        self.conn = None         # Connection it arrived on
        # distributed-trace context (ref: the trace context riding
        # MOSDOp through src/common/tracer.cc): appended zero-filled
        # to every frame, so every existing construction site keeps
        # working and pre-trace blobs decode with a zeroed context.
        # 0 = untraced.
        self.trace_id = 0
        self.parent_span_id = 0

    def set_trace(self, span) -> None:
        """Stamp an outgoing message with ``span``'s context so the
        receiver's span becomes its child. No-op for None / unsampled
        (local-only) spans — their context must not propagate."""
        if span is not None and span.trace_id:
            self.trace_id = span.trace_id
            self.parent_span_id = span.span_id

    # -- payload ----------------------------------------------------------
    def encode_payload(self, e: Encoder) -> None:
        for name, codec in self.FIELDS:
            _ENC[codec](e, getattr(self, name))

    @classmethod
    def decode_payload(cls, d: Decoder) -> "Message":
        kw = {name: _DEC[codec](d) for name, codec in cls.FIELDS}
        return cls(**kw)

    # -- framing ----------------------------------------------------------
    def encode(self) -> bytes:
        e = Encoder()
        e.u16(self.TYPE).u64(self.seq)
        self.encode_payload(e)
        # trace context rides APPENDED, after the payload: old decoders
        # stop at their payload's end, and old blobs (no trailing pair)
        # decode below with a zeroed context
        e.u64(self.trace_id).u64(self.parent_span_id)
        return e.tobytes()

    @staticmethod
    def decode(data: bytes) -> "Message":
        d = Decoder(data)
        code = d.u16()
        seq = d.u64()
        cls = _REGISTRY.get(code)
        if cls is None:
            raise ValueError(f"unknown message type {code}")
        m = cls.decode_payload(d)
        m.seq = seq
        if d.remaining() >= 16:           # pre-trace blob: stays zeroed
            m.trace_id = d.u64()
            m.parent_span_id = d.u64()
        return m

    def __repr__(self) -> str:
        fields = ", ".join(f"{n}={getattr(self, n)!r}"
                           for n, _ in self.FIELDS[:4])
        return f"{type(self).__name__}({fields})"
