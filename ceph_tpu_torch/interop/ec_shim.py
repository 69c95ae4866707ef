"""Python half of the port's reverse shim (``build/native_torch/libec_jax.so``).

The forward bridge (``interop.native``) lets Python call the C++ EC
runtime; this module is the opposite direction. The native plugin
registry dlopens the shim (built from
``ceph_tpu_torch/csrc/plugin_torch_shim.cc`` by
``interop.native.build_native_shim``), which embeds a CPython
interpreter and calls these functions, so the native ``ec_bench``
harness can drive the port's torch plugin through the exact
``__erasure_code_init`` contract every other plugin uses (ref: the role
of src/erasure-code/ErasureCodePlugin.cc __erasure_code_init; SURVEY.md
§7 step 6). The port's copy of ``ceph_tpu/interop/ec_shim.py``.

Buffers cross the boundary as memoryviews over the caller's chunk
arrays: no copies on input; one ndarray assignment on output.

Device: the plugin runs on the card, and its encodes and decodes are
``gf_encode`` launches there, unless the profile asks for the CPU with
the key ``device=cpu`` (``ec_bench --parameter device=cpu``). The
reference pins its embedded interpreter to the CPU; nothing here pins.
"""

from __future__ import annotations


def create(profile: str):
    """profile "k=8 m=3 technique=..." -> ErasureCodeInterface instance."""
    from ceph_tpu_torch.ec.registry import factory
    prof = profile.strip() or "k=2 m=2"
    if "plugin=" not in prof:
        prof = "plugin=jax " + prof
    return factory(prof)


def encode(h, data_mv, parity_mv, chunk: int) -> int:
    import numpy as np
    data = np.frombuffer(data_mv, dtype=np.uint8).reshape(h.k, chunk)
    parity = h.encode_chunks(data)
    np.frombuffer(parity_mv, dtype=np.uint8).reshape(h.m, chunk)[:] = parity
    return 0


def decode(h, avail, want, chunks_mv, out_mv, chunk: int) -> int:
    import numpy as np
    chunks = np.frombuffer(chunks_mv, dtype=np.uint8).reshape(
        len(avail), chunk)
    got = h.decode_chunks(list(want),
                          {a: chunks[i] for i, a in enumerate(avail)})
    out = np.frombuffer(out_mv, dtype=np.uint8).reshape(len(want), chunk)
    for i, w in enumerate(want):
        out[i] = got[w]
    return 0
