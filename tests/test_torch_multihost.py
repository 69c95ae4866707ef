"""Two ``torch.distributed`` ranks (gloo, on the CPU) over one mesh.

The counterpart of ``tests/test_multihost.py``: two worker processes of
``ceph_tpu_torch.parallel.multihost``, four mesh slots each, form an
8-slot mesh whose rank boundary stands for the hosts' network. Each
worker checks the sharded EC checksum and the CRUSH sweep against its
own local computation and raises on a difference; here both workers must
agree, and the EC checksum must equal the one of ceph_tpu's encode of the
same batch. Integer results: exact equality.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from ceph_tpu.ec import matrix as ref_rs
from ceph_tpu.gf import ops as ref_ops
from ceph_tpu.gf import tables as ref_tables

WORKER_TIMEOUT = 180        # seconds, each worker


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ref_checksum(num_processes: int) -> int:
    """ceph_tpu's encode of the workers' batch, summed mod 2^32."""
    k, m, C, batch = 4, 2, 4096, 8 * num_processes
    coding = ref_rs.coding_matrix("reed_sol_van", k, m)
    data = np.random.default_rng(7).integers(0, 256, size=(batch, k, C),
                                             dtype=np.uint8)
    out = np.asarray(ref_ops.encode_stripes(
        jnp.asarray(ref_tables.expand_bitmatrix(coding), dtype=jnp.int8),
        *map(jnp.asarray, ref_tables.nibble_tables(coding)),
        jnp.asarray(data), backend="bitmatmul"))
    return int(out.astype(np.uint64).sum() & 0xFFFFFFFF)


def test_two_rank_gloo_mesh():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.parallel.multihost",
             "--coordinator", coord, "--num-processes", "2",
             "--process-id", str(i), "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    a, b = outs
    assert a["ok"] and b["ok"]
    assert [a["process_id"], b["process_id"]] == [0, 1]
    assert a["processes"] == b["processes"] == 2
    assert a["global_devices"] == b["global_devices"] == 8
    assert a["local_devices"] == b["local_devices"] == 4
    # both ranks reduced to the same totals
    assert a["ec_checksum"] == b["ec_checksum"] == _ref_checksum(2)
    assert a["crush_placements"] == b["crush_placements"] == 3 * 256 * 8
