"""Native interop: the C++ runtime behind ctypes.

``native.py`` loads libec_ref.so (the C ABI RS backend) as plugin
``ref``, an independent correctness oracle for the card's plugin and the
native branch of ``isa``.
"""

from ceph_tpu_torch.interop.native import (  # noqa: F401
    ErasureCodeRef, build_native, native_build_dir,
)
