"""Native interop: the C++ runtime behind ctypes, and the reverse.

``native.py`` loads libec_ref.so (the C ABI RS backend) as plugin
``ref``, an independent correctness oracle for the card's plugin and the
native branch of ``isa``, and builds the native harness and the port's
reverse shim; ``ec_shim.py`` is the shim's Python half, through which
``ec_bench --plugin jax`` drives the port's torch plugin.
"""

from ceph_tpu_torch.interop.native import (  # noqa: F401
    ErasureCodeRef, build_native, build_native_shim, native_build_dir,
)
