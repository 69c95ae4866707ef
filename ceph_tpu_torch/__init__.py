"""ceph_tpu_torch: the PyTorch/CUDA port of ``ceph_tpu``.

It mirrors the JAX package's layout, one slice at a time, and is held
byte for byte against it by the ``tests/test_torch_*.py`` tests. It
imports torch and never jax, nor anything of ``ceph_tpu``.

- ``ceph_tpu_torch.gf``     GF(2^8) tables (numpy), torch ops, and the
                            hand-written CUDA encode kernel (``kernels``).
- ``ceph_tpu_torch.ec``     Reed-Solomon erasure coding behind the
                            ``ErasureCodeInterface`` contract, the lrc,
                            shec and clay plugins, plugin registry,
                            profiles; the fused checksum+encode
                            (``crc``), device-resident stripes and the
                            streaming ingest pipeline.
- ``ceph_tpu_torch.crush``  CRUSH: map model, hashes, crush_ln, the rule
                            VM (``mapper.Mapper``), the hand-written CUDA
                            straw2 rule kernel (``kernels``), the scalar
                            spec, builder, compiler, tester.
- ``ceph_tpu_torch.osd``    OSDMap placement (``pg_to_up_acting_osds``,
                            incrementals, the lookup memo), the
                            OSDMapMapping table kept across epochs, PG
                            types, object-name hashes, the EC write and
                            read aggregators, the EC object backend
                            (``ec_backend``: RMW, recovery, scrub,
                            residency), stripe math, the PG log.
- ``ceph_tpu_torch.mon``    the monitor quorum (store, elector, paxos,
                            the services, ``Monitor``, ``MonMap``) and
                            ``MonClient``, whose tracked table maps on
                            the card.
- ``ceph_tpu_torch.mgr``    the mgr daemon (``Mgr``: active/standby,
                            the report sessions' index, the balancer,
                            autoscaler, prometheus, tracing, progress,
                            rest and tuner modules), whose placement
                            table maps on the card, and the daemons'
                            ``MgrReporter``.
- ``ceph_tpu_torch.rbd``    RBD images striped over RADOS objects
                            (snapshots, clones, ``rbd diff v1``).
- ``ceph_tpu_torch.rados``, ``osdc``, ``cluster`` librados, the
                            objecter, and the dev cluster (vstart, one
                            process per daemon).
- ``ceph_tpu_torch.cephfs`` the FSMap the MDSMonitor commits.
- ``ceph_tpu_torch.msg``    the messenger, auth and wire messages.
- ``ceph_tpu_torch.os_``    object stores: kv, allocator, MemStore,
                            WALStore, BlueStore (host only).
- ``ceph_tpu_torch.interop`` the native C++ RS backend (``ref``, ``isa``)
                            over ctypes.
- ``ceph_tpu_torch.encoding`` binary codecs of crush maps, osdmaps and
                            incrementals (ceph_tpu's bytes).
- ``ceph_tpu_torch.sim``    the churn (rebalance) simulator, fault
                            injection.
- ``ceph_tpu_torch.bench``  ``ceph_erasure_code_benchmark``-compatible CLI,
                            ``crushtool``, ``crush_sweep``, ``osdmaptool``,
                            ``objectstore_tool``, ``ec_streaming``,
                            ``ec_daemon_path``, ``dencoder`` and the
                            ``ceph``, ``rados`` and ``rbd`` CLIs.
- ``ceph_tpu_torch.utils``  Device selection, kernel build, timing,
                            bounds, perf counters, logging, the
                            device-runtime monitor (``devmon``), the
                            config registry, the admin socket, crash
                            reports, tracing, op tracking, throttles.
- ``ceph_tpu_torch/csrc``   CUDA sources, built by ``utils.cuda_build``.

Entry points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
