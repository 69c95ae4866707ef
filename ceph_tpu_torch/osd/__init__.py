"""OSDMap placement: PG types, object-name hashes, pg_to_up_acting_osds."""

from ceph_tpu_torch.osd.str_hash import (  # noqa: F401
    CEPH_STR_HASH_LINUX, CEPH_STR_HASH_RJENKINS,
)
from ceph_tpu_torch.osd.types import (  # noqa: F401
    PGPool, ObjectLocator, pg_t, spg_t,
    POOL_TYPE_REPLICATED, POOL_TYPE_ERASURE,
    FLAG_HASHPSPOOL, ceph_stable_mod,
)
from ceph_tpu_torch.osd.osdmap import OSDMap  # noqa: F401
from ceph_tpu_torch.osd.str_hash import str_hash, str_hash_batch  # noqa: F401
