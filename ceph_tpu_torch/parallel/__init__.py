"""Scale-out: device meshes and sharded pipelines.

The port of ``ceph_tpu/parallel``: PG-sharding and EC fan-out become the
data-parallel axis of a ``Mesh`` of device slots; a mesh may span
``torch.distributed`` ranks (``multihost``), whose one reduction of the
CRUSH counts is the only communication between them.
"""

from ceph_tpu_torch.parallel.mesh import Mesh, local_mesh, make_mesh
from ceph_tpu_torch.parallel.sharded import (
    sharded_crush_sweep,
    sharded_decode,
    sharded_encode,
)
