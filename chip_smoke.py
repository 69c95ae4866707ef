#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``ceph_tpu_torch``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ceph_tpu_torch/csrc`` into
``build/torch_kernels/`` (one nvcc per source, all started together) and
runs these phases; any failure raises, so the script exits non-zero and
prints no result. The erasure-code path:

1. The main path, at full width: Reed-Solomon k=8 m=3 (reed_sol_van)
   through the plugin registry on CUDA with ``backend=auto``, encode of
   64 stripes of 4 MiB objects (C = 512 KiB), then a decode of chunks 0
   and 1 from 8 survivors. The kernel's launch count must move.
2. Checks: the parity byte for byte against the kernel's plain version
   on the card (in stripe slices) and against the numpy oracle on a few
   stripes; the decode exact; one cauchy_good (k=8 m=3) and one
   reed_sol_r6_op (k=8 m=2) profile through the same kernel.
3. Ragged shapes: the kernel called directly at C not a multiple of 16,
   C = 1, B = 1, a misaligned pointer and a non-RS bitmatrix, against the
   plain version.
4. Times (CUDA events) at the flagship shape: the kernel through the
   plugin's plans and through ``gf_encode``, and its plain version, for
   encode and decode, the bound, and the port's benchmark; then the
   kernel alone at the six shapes of the EC paths
   (``bench/gf_kernel_bench.py``), both entry points in turns, each
   beside its bound.

Then CRUSH placement, at full width (``crush_phases``):

6. The main path: ``Mapper`` on the canonical 10,240-OSD map (root -> 20
   racks -> 640 hosts -> 16 OSDs, straw2, 3-replica chooseleaf host),
   ``map_pgs`` of 2^21 PGs on CUDA, and the same on the mixed-weight and
   choose_args maps. Each must run on the ``kernel`` engine, and the
   crush_straw2 launch count must move.
7. Checks: all 2^21 lanes (leaves and ``bad``) of each map equal the
   kernel's plain version on the card; 2,048 PGs spread over the range
   equal ``mapper_ref``, the scalar spec (in a pool of CPU processes).
8. The fallback: 4 hosts x 2 OSDs, numrep 4, most OSDs reweighted
   toward 0: lanes must be flagged, and every lane equals mapper_ref.
9. Placement: an OSDMap on the canonical map, a size-3 pool of 2^18
   PGs, two OSDs down, two out, one pg_upmap item; every PG through
   pg_to_up_acting_osds, 1,024 of them against mapper_ref and the same
   post-CRUSH pipeline.
10. Times (CUDA events): the kernel and its plain version at 2^21 PGs,
   the bound, crush_sweep's mappings/s on the three maps, and crushtool
   --build --num-osds 10240 --hosts 640 --racks 20 --test over 2^20 PGs.

Then placement across epochs, at full width (``placement_epochs_phase``,
on the same pool of CPU processes), the crush_straw2 launch count set to
0 just before each update and read just after:

17. Build: an OSDMap on the canonical 10,240-OSD map with a size-3 pool
   of 2^18 PGs (rule 0, the kernel) and a k=8 m=3 pool of 2^16 PGs under
   an ``indep`` host rule (the rule VM, on the card), about 147 PG shards
   per OSD; ``OSDMapMapping`` builds both tables and is attached.
18. A seeded stream of 26 ``Incremental``s (down/up, out, reweights down
   and up, in, pg_temp, primary_temp and pg_upmap_items set and cleared,
   primary affinity, one crush bucket-weight edit) through
   ``apply_incremental`` + ``update``. Each update must take its kind's
   path (no full sweep for a state, override or weight decrease; both
   pools re-swept for an increase or the crush edit); the rows it touched
   and 4,096 rows per pool equal a from-scratch sweep; the whole table
   does at the first, middle and last epoch; at the last, 1,024 PGs per
   pool equal ``mapper_ref`` + the post-CRUSH pipeline. Every
   crush_straw2 launch of the phase equals crush_straw2_plain on the same
   plan and lanes (a checking hook around the wrapper).
19. The memo: 1,000 scalar lookups at the attached epoch come from the
   table (``mapping_cache_hits`` + 1,000, no launch); after one more
   incremental with no update, lookups miss and equal a fresh sweep.
20. Health: ``path_mismatch`` and ``quarantine_entries`` 0, no Mapper
   quarantined.
21. ``osdmaptool --createsimple 10240 --pg-num 262144 --test-map-pgs
   --churn 4 --export F``, then ``--mapfn F``: the distribution and the
   bytes survive the round trip; ``crushtool -i``/``-o`` round-trips the
   canonical map byte for byte. One ``placement_epochs`` JSON line.

Then the monitor quorum, at full width (``mon_path_phase``, on the same
pool of CPU processes): the placement-epochs map written as epoch 1 into
three ``WALDB`` stores (``ceph-mon --mkfs --osdmap``), three ``Monitor``s
in a spawned process of their own (crc mode, the registry's timers; it
reports elections, commits, wire bytes and its own crush_straw2
launches), and one ``MonClient`` in this process with ``track_mapping``
on the card. Every crush_straw2 launch of the phase, in either process,
is held against its plain version by the same hook; the count is set to
0 just before the client subscribes and read from its map handling:

35. Build: the client's first map builds both pools' tables on the card
   (one kernel launch, both pools swept); the whole table equals a
   from-scratch sweep.
36. A stream of 18 map changes through ``MonClient.command`` (down, out,
   in, reweight down and up, primary affinity with a tuner's provenance
   set and cleared, pg-upmap-items set and cleared on both pools, a
   crush bucket-weight edit through ``osd setcrushmap``) and an
   ``MOSDBoot`` for each up, the leader stopped halfway: each change
   takes its kind's path, its rows and 4,096 sampled rows per pool equal
   a from-scratch sweep, and the whole table does at the first, middle
   and last change. The other two mons elect a leader and the client
   hunts to it.
37. Balancer traffic: 32 concurrent ``osd pg-upmap-items``; commits/s and
   the time until the client's table holds all 64. The mons' commits so
   far launched no kernel and moved no byte to the card (their devmon).
38. ``osd map`` of 256 seeded names from the leader (its kernel on its
   card) equals the client's table rows.
39. The last epoch: the whole table equals a from-scratch sweep, 1,024
   PGs per pool equal ``mapper_ref`` + the pipeline, and ``osd getmap``
   is byte-equal on both surviving mons and the client's map.
40. The client's epochs are contiguous; no election beyond the quorum's
   forming and the failover's, and no epoch won by two mons. One
   ``mon_path`` JSON line.

Then the OSD's erasure-code data plane, at full width (k=8 m=3,
``reed_sol_van``; ``ec_plane_phases``), each path driven with the
gf_encode launch count set to 0 just before it and read just after:

11. Write path: 256 concurrent ops x 32 stripes x C = 4096 (256 MiB)
   through ``ECAggregator`` with ``with_crc=True`` and the default
   ``osd_ec_agg_max_stripes`` 4096: two full flushes, two fused
   checksum+encode launches. Each flushed 4096-stripe batch's parity
   equals the kernel's plain version on the card, byte for byte, and
   every op's parity equals its own encode launch; every shard's folded
   CRC equals zlib.crc32.
12. Read path: the same ops with chunks 0 and 1 erased, rebuilt from
   2..9 through ``ECReadAggregator`` (two launches); equal to the data
   and to the plain version of the decode, and ``decode_batch_reference``
   agrees on a sample.
13. Streaming: ``StreamingEncodePipeline`` over the same 256 MiB in 16
   batches; each equal to the plain version on the card and to per-batch
   encode, and one op of each batch, all m parity rows, equal to the
   numpy oracle ``gf_matmul_np``.
14. Scrub CRCs: ``device_row_crcs`` over 4096 rows x 4096 B, equal to
   zlib. Residency: ``DeviceShardCache`` put/get/evict/invalidate under
   its 64 MiB default budget.
15. Ladders: every degrade-ladder counter of the aggregators, the
   pipeline and the fault chokepoint is 0, or the run fails.
16. Times: the ``ec_streaming`` bench record at its production shape,
   and the fused CRC leg's ms beside the encode kernel's ms at the
   aggregated batch shape (4096 stripes).

Then the EC plugins (``ec_plugin_phase``): one 4 MiB object encoded and
decoded through ``plugin=lrc k=4 m=2 l=3``, ``plugin=shec k=8 m=4 c=3``
and ``plugin=clay k=4 m=2 d=5``, each against its host reference.

Then the OSD's erasure-coded object path, at full width
(``ec_object_path_phase``): ``ECBackendLite(chunk_size=4096)`` over the
flagship ``plugin=jax k=8 m=3 reed_sol_van`` with a 256 MiB residency
budget, 256 objects of 4 MiB (RBD's default object) and a host mirror of
each. Every gf_encode launch of these phases is timed (CUDA events) and
held against gf_encode_plain by a checking hook, and the launch count is
set to 0 just before each path and read just after:

22. Write: every object whole (one launch of 128 stripes each).
23. RMW: 4,096 writes of 4 KiB at seeded unaligned offsets, one in eight
   straddling a stripe boundary, then 64 of 100 KiB; every object reads
   back equal to its mirror.
24. Recovery: shards 2 (data) and 9 (parity) lost on every object, then
   ``recover_all``: each rebuilt shard equals its copy saved before the
   loss, ``recover_chunks`` is 256 x 2 x 128, every object reads back.
25. Scrub: one byte flipped in one shard of 16 objects (8 data, 8
   parity); ``scrub`` returns exactly that shard; 16 clean objects
   scrub ``[]``.
26. Residency: 32 objects read twice, the second pass all hits, the
   cache within its budget; a write invalidates its stale generation.
27. 1,024 seeded stripes' stored parity equals the native C++ backend
   (``plugin=isa``, which must be the independent ``ErasureCodeRef``).
28. ``plugin=lrc k=4 m=2 l=3`` and ``plugin=shec k=8 m=4 c=3`` on 16
   objects each: a shard lost, recovered from the plugin's local
   ``minimum_to_decode`` set, every object equal to its mirror.
29. ``ec_daemon_path`` at its production shape (256 degraded reads of
   32 x 8 x 4096 B), per-op, aggregated and resident.
One ``ec_object_path`` JSON line gives the host-clock rates, the
launches and CUDA-event milliseconds by operation, the kernel's times
and bounds at (128, 8, 4096) and (1, 8, 4096), the residency and
``ec_backend`` counters and the card.

Then the erasure-coded PG path, at full width (``ec_pg_path_phase``):
one PG of a k=8 m=3 ``reed_sol_van`` pool (size 11, min_size 9,
``stripe_unit`` 4096) on 12 OSD facades (``OSDFacade``: a MemStore, a
messenger on 127.0.0.1 in crc mode, an ``ECAggregator``, an
``ECReadAggregator`` and a 256 MiB ``DeviceShardCache`` each, all on the
card), its acting set from ``OSDMap.pg_to_up_acting_osds`` under an
``indep`` host rule; a client messenger sends ``MOSDOp``s to the primary.
Every gf_encode launch is held against its plain version by the same
hook, the count set to 0 just before the path and read just after:

30. 128 concurrent whole-object writes of 4 MiB, then 256 4 KiB partial
   writes (one in eight straddling a stripe); every object reads back
   equal to its mirror, and 32 of them again from the residency cache.
31. The OSDs at positions 2 (data) and 9 (parity) die and the map marks
   them down: every object read degraded through ``ECReadAggregator``.
32. The spare takes position 2 (``pg-upmap-items``); recovery pushes
   rebuild its 128 shards, each equal to the mirror's bytes with its
   ``_hcrc`` and ``_pos``; 16 objects' stored parity equals the native
   C++ backend.
33. One shard of 16 objects corrupted in its store, 8 of them among the
   last read (at least one resident in the primary's cache; deep scrub
   reads the stored shards around it): a deep scrub flags exactly those
   16, repair names each culprit shard and restores it,
   and the sweeps' digests come from one device CRC job per sweep and
   per deep check (``SCRUB_PERF``), equal to zlib; every ladder rung 0,
   and no recovery rebuild failed on the card (``push_device_failures``,
   ``rebuild_device_failures``).
34. Off the path, on a healthy PG of its own: a 4 MiB write and a 4 KiB
   partial write taken apart on the host clock.
One ``ec_pg_path`` JSON line gives the host-clock rates, the launches
and CUDA-event milliseconds by operation, the aggregator, residency,
scrub and wire counters, the breakdown and the card.

Then the OSD daemon and the dev cluster, at full width
(``osd_cluster_path_phase``, after the mon path, on the same pool of CPU
processes): an erasure-coded RBD deployment as Ceph documents it. A
``vstart`` cluster of three mons and twelve OSD daemons, one process
each (the proc backend: WALStores, crc-mode messengers, ``DEFAULT_CFG``
with the proc backend's timers, a 256 MiB residency budget per OSD; the
OSDs and the client on the card, the mons on the CPU as on hosts of
their own), serves a client's ``rados`` ops through the objecter. Each
daemon runs under ``chip_smoke.py --proc-child``, which puts the same
hooks around both kernels in its process and answers ``smoke *`` verbs
on its admin socket; every gf_encode and crush_straw2 launch of the
phase is timed (CUDA events) and held against its plain version there,
each daemon's counts start at 0 with its process and the client's are
set to 0 just before the cluster starts. Each cluster start prints its
seconds, elections, paxos timeouts and slow commands, and fails, as the
path's end does, when two mons won one election epoch; no cluster is
started again:

41. A k=8 m=3 ``reed_sol_van`` profile (``crush-failure-domain=host``,
   ``stripe_unit`` 4096) and an ``erasure`` pool of 32 PGs on it, and a
   replicated size-3 pool of 32 PGs (the image metadata); clean. Every
   ECPG's plugin and every residency cache is on the card.
42. ``rados bench``'s defaults, cut to 64 objects of 4 MiB written, 16 in
   flight, and 128 header objects of 4 KiB with an xattr and two omap
   keys; all read back, 16 in flight, equal to a host mirror.
43. 256 4 KiB overwrites at seeded 4 KiB-aligned offsets, 16 in flight.
44. Two OSDs hard-stopped; the seconds until the mon marks both down
   from the heartbeat reports.
45. All 64 objects read degraded (PGs that lost two shards decode two
   erasures) and 64 more overwrites.
46. One OSD revived (log recovery), the other ``osd out`` (its slot to
   another OSD, and some holders change slot); the seconds to clean and
   the bytes pushed. Then every stored EC shard is its holder's slot's
   position, stamped so, with the bytes the host mirror gives it
   (``smoke shards``, ``shard_audit``), and a deep scrub of every EC PG
   (``smoke deep_scrub``, reading the stored shards) finds nothing.
47. One shard of 16 objects, picked without regard to residency,
   corrupted in its OSD's store; ``pg repair`` of each PG until every
   shard is restored; the audit and the deep scrub of every EC PG again
   find nothing.
48. Everything read back equal to the mirror; every PG clean; every
   ladder rung and ``*_device_failures`` counter 0; markdowns only of
   the two stopped OSDs and no election after the quorum formed; every
   OSD's tracked table equal, and one's equal to ``mapper_ref`` + the
   post-CRUSH pipeline on every PG of both pools. One
   ``osd_cluster_path`` JSON line gives the rates, the launches and
   CUDA-event ms of both kernels by step, the aggregators' stripes and
   distinct PGs per flush, residency, scheduler grants, epochs,
   markdowns, elections, wire bytes and the client's one-PG lookups
   per epoch.

Then RBD images and the mgr, at full width (``rbd_path_phase``, after
the OSD cluster path): the same layout (three mons on the CPU, twelve OSD
daemons and the client on the card) with two mgr daemons, ``x`` and
``y``, each with the reference's default modules (balancer in upmap
mode, pg_autoscaler, prometheus, tracing, progress, tuner), run on the
CPU as on hosts of their own (``RBD_ON_CPU``; ``--proc-child``
hooks them too and answers ``smoke stats`` with their balancer ticks,
promotions and demotions). The CLIs run as users run them, each in a
process of its own through ``chip_smoke.py --cli-child``, which holds
that process's launches against the plain versions:

49. A k=8 m=3 pool of 32 PGs and a replicated pool of 128 (what the
   autoscaler recommends for 12 OSDs and two pools); the seconds until a
   mgr is active, and until the balancer's last two ticks changed
   nothing on a clean cluster, with the upmaps it committed.
50. ``rbd_cli create`` of ``vol0``, 512 MiB at order 22, on the k=8 m=3
   pool.
51. ``rbd bench``'s parameters through ``Image``, 16 in flight: the
   whole image in sequential 4 MiB writes, 256 random 4 KiB writes, 256
   random 4 KiB reads and a sequential read, every read equal to a host
   mirror.
52. ``vol1`` (64 MiB) on the replicated pool: a snap, 64 4 KiB writes,
   the snap read back equal to the pre-snap mirror, protect, clone, a
   copy-up write to the clone, and ``export-diff``/``import-diff`` into
   a fresh image, equal in bytes.
53. ``ceph_cli mgr fail``; the standby takes over and its first balancer
   tick changes nothing; prometheus's ``/metrics`` scraped on both mgrs;
   ``ceph_cli progress json`` and ``status``.
54. No markdown, no election, no mgr promotion or demotion but the
   first active's and the failover's; the pools' ``pg_num`` unchanged;
   every ladder rung and ``*_device_failures`` counter 0. One
   ``rbd_path`` JSON line gives the rates, the mgr's seconds, upmaps,
   scrapes and worst loop stall, both kernels' launches and CUDA-event
   ms by process kind (mgr, OSD, client, CLI), and the aggregators'
   distinct PGs per flush.

Then the S3 gateway and CephFS (``fs_rgw_path``, steps 55-61 of
``rbd_path_phase``, on its cluster after the mgr failover; its launches
are those of steps labelled ``fs_rgw_*`` and of the MDS processes):
Ceph's documented CephFS setup ("Create a Ceph File System": an active
MDS and a standby, two MDS processes on the card) on a replicated size-3
pool ``cephfs`` of 128 PGs (what the autoscaler recommends for three
pools, so it splits nothing), and S3 through an ``RGWGateway`` in this
process over the client's ``Rados`` on the k=8 m=3 pool ("Ceph Object
Gateway"), SigV4 users on:

55. ``ProcCluster.start_fs``; the MDSs' start-up seconds and devices
   (the card); the balancer quiet again after the new pool's moves.
56. 32 PUTs of 4 MiB (``rgw_obj_stripe_size``) at 16 in flight, each
   ETag equal to the md5; the bucket listing; 32 HEADs and 32 GETs at 16
   in flight, every byte equal to a host mirror.
57. A 64 MiB multipart upload in 8 MiB parts, its ETag md5-of-md5s-8
   and its bytes; a presigned GET; a ``public-read`` object's anonymous
   GET (a private one's is refused).
58. Two ``CephFSClient``s on the card (keys in the conf), IO500's
   mdtest-easy at 64 empty files per client in a directory of its own:
   creates, with ``ceph_cli mds fail <active>`` started with them (each
   client's last 32 creates wait for it), so the standby takes rank 0
   and the clients reconnect and replay; every acknowledged file listed
   once; stats; unlinks.
59. ior-easy: a file per client, 32 MiB in sequential 4 MiB transfers,
   written and read back equal to a host mirror.
60. ``mkdir /ior/0/.snap/s1``, a rewrite of one transfer: the snapshot
   reads the old bytes, the head the new.
61. An OSD hard-stopped; 16 degraded GETs (15 objects and the multipart
   one), bytes and ETags exact. No markdown but that OSD's, no election,
   no mgr move, the MDSs' takeovers only the first active's and the
   failover's; the pools' ``pg_num`` unchanged. One ``fs_rgw_path``
   JSON line gives the S3 and CephFS rates, the failover and reconnect
   seconds, the MDSs' start-up and worst loop stall, and both kernels'
   launches and CUDA-event ms by process kind and step.

Then the load generator and the Thrasher's storms (``storm_path``,
steps 62-67 of ``rbd_path_phase``, on the same cluster after
``fs_rgw_path``; its launches are those of steps labelled ``storm_*``,
of its loadgen worker and of ``ec_bench``):

62. The OSD that step 61 hard-stopped starts again; every PG clean.
63. ``sim.loadgen.run_sharded`` with one worker process (a
   ``sitecustomize`` hooks both kernels there) on the k=8 m=3 pool:
   2,000 sessions of 2 ops (a 4 KiB write, then a read or a write), 64
   sessions in flight over 8 ``Rados`` handles on the card; zero errors,
   every op acked, every OSD's worst loop stall in it under the 3 s
   heartbeat grace; ops/s and p50/p99.
64. ``Thrasher.proc_storm`` on the k=8 m=3 pool: a writer keeps writing
   while the last OSD, the lead mon and the active mgr are SIGKILLed in
   turn and respawned, and the standby mgr's metrics fill again; zero
   writer errors, every acked write read back bit-identical, the
   cluster clean. No gray pass: the smoke's 3 s OSD heartbeat grace is
   shorter than the ``OSD_SLOW`` confirm window (the CPU test runs it).
65. ``Thrasher.mds_storm`` with ``fs_rgw_path``'s two CephFS clients,
   after a fresh incarnation of the MDS that ``mds fail`` removed stands
   by: the active is SIGKILLed while each client writes 10 files; a
   standby active on rank 0 in time, zero writer errors, every acked
   file read back, and the killed incarnation's late journal write
   refused (-EBLOCKLISTED).
66. The native ``ec_bench --plugin jax`` through the port's reverse shim
   (``build/native_torch/libec_jax.so``, which embeds CPython; a
   same ``sitecustomize`` hooks both kernels there and checks their
   launches once ``ec_bench`` destroys the plugin, after its timed loop):
   an encode of 262,144 bytes and a decode of 2 erasures at k=8 m=3,
   each with ``--verify``.
67. ``utils.checkpoint.resumable_sweep`` of the canonical 10,240-OSD map
   on the card, 2^22 PGs in chunks of 2^20, stopped after two chunks;
   ``crush_sweep --checkpoint --profile`` resumes it from the file, and
   the saved counts equal one sweep of all the PGs (the trace's CUDA
   kernel events are counted).
   Elections only during the lead mon's SIGKILL, markdowns only of the
   SIGKILLed OSD, one mgr promotion (the survivor's) and one change of
   rank 0's holder. One ``storm_path`` JSON line gives the loadgen
   report, both storms' summaries, ec_bench's seconds and MB/s, the
   resumed sweep's record, and both kernels' launches by process kind
   and step.

Then the multi-device layer (``multi_device_path``, after the EC PG
path), on the one card: every crush_straw2 and gf_encode launch is held
against its plain version (``EdgeLaunchLog``, ``GfLaunchLog``), and the
counts are set to 0 just before each sharded path and read just after:

68. ``bench.multichip`` at the pod-scale target, on ``local_mesh()`` (one
   slot): ``--crush-pgs 100000000`` on the canonical 10,240-OSD map, rule
   0, 3 replicas, in tiles of 2^21 PGs. The ``crush_multichip`` record is
   measured, not extrapolated; a sharded sweep's counts and ``bad`` equal
   an unsharded ``Mapper.sweep`` of the same range, and the placements
   are 3 x 100M. In these sweeps the plain version checks the first
   65,536 lanes of each shard's first tile and the last 65,536 of its
   last (it takes ~1.3 s a tile); every other launch of the phase is
   checked whole.
69. A four-slot mesh of the card: ``sharded_map_pgs`` of 2^21 + 17 seeds
   equals ``Mapper.map_pgs`` lane for lane (four launches, one copy of
   the map: the Mapper's), the shard edges and 64 spread rows equal the
   scalar spec; an ``OSDMapMapping(mesh=, mesh_min_batch=1)`` of
   ``osdmaptool --createsimple 10240 --pg-num 65536`` equals the
   mesh-less table, with sharded sweeps counted there and in devmon's
   ``launches_sharded``; ``sharded_encode`` and ``sharded_decode`` at
   (64, 8, 524288), k=8 m=3, equal ``encode_batch`` and ``decode_batch``
   exactly; the sharded encode's GiB/s at one and four slots.
70. Two ``python -m ceph_tpu_torch.parallel.multihost`` ranks on the card
   (gloo, four slots each; a ``sitecustomize`` hooks both kernels in
   each rank): both exit 0 within 180 s, their EC checksums equal an
   encode of the whole batch here and their placements 3 x 256 x 8; each
   rank's launches are checked and counted.
71. Every step launched its kernels. One ``multi_device_path`` JSON line.

Two lines of phases. The main process runs the main paths above, CRUSH,
the mon path and the cluster paths (the OSD cluster, RBD, S3 and CephFS,
the storms) in turn. From the mon path on, one spawned process runs
beside it, at nice 10 (``SidePhases``): placement across epochs, the EC
data plane and plugins, the EC object path, the EC PG path and the
multi-device layer, in turn. Each phase sets and reads its counts in the
process it runs in; the side's output (``build/side_phases.log``) is
printed whole after the storms, and a failure there fails the smoke.
The side's times are taken while the clusters share the card and host.

Last: one JSON line listing both kernels, then the card from
nvidia-smi, then the last line ``{"ok": true, "device": {...}}``.

It exits with code 2, before any work, when no CUDA device is present.
"""

from __future__ import annotations

import asyncio
import json
import logging
import multiprocessing
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

SEED = 20261016
B, K, M, C = 64, 8, 3, 524288          # flagship: 4 MiB objects, k=8 m=3
ERASED, AVAIL = [0, 1], list(range(2, 2 + K))
PLAIN_SLICE = 8                        # stripes per plain-version check
CRUSH_N = 1 << 21                      # PG lanes of the CRUSH main path
CRUSH_SAMPLE = 2048                    # PGs held against the scalar spec
PG_NUM = 1 << 18                       # ~100 PG replicas per OSD
EC_PG_NUM = 1 << 16                    # the k=8 m=3 pool of the epochs phase
EPOCH_SAMPLE = 4096                    # rows per pool checked every epoch
SCALAR_SAMPLE = 1024                   # PGs per pool against mapper_ref
MEMO_LOOKUPS = 1000
TABLES = ("craw", "up", "up_primary", "acting", "acting_primary")
# the placement-epochs stream: every kind of map change, each victim
# revived before the end except the last one
EPOCH_KINDS = ("down", "pg_temp", "out", "affinity", "upmap", "reweight",
               "primary_temp", "down2", "pg_temp2", "up", "in", "upmap2",
               "out2", "crush", "pg_temp_rm", "upmap_rm", "primary_temp_rm",
               "affinity_rm", "reweight_in", "up2", "in2", "pg_temp2_rm",
               "upmap2_rm", "down3", "out3", "reweight_half")
N_OPS, OP_STRIPES, OP_C = 256, 32, 4096   # ec_streaming production shape
STREAM_OPS = 16                        # ops per streamed batch (16 MiB)
SCRUB_ROWS = 4096                      # rows of the scrub CRC job
FP32_FLOPS = 67e12                     # H100 SXM datasheet, non-tensor
# the EC object path: RBD's default object (rbd_default_order 22)
OBJ_COUNT, OBJ_SIZE, OBJ_C = 256, 4 << 20, 4096
OBJ_RESIDENT_BYTES = 256 << 20
RMW_OPS, RMW_BYTES = 4096, 4096        # RBD's 4K random write
RMW_BIG_OPS, RMW_BIG = 64, 100 << 10
SCRUB_OBJS = 16                        # corrupted, and as many clean
RESIDENT_OBJS = 32
NATIVE_STRIPES = 1024
LAYER_OBJS = 16                        # objects per lrc/shec profile
# the EC PG path: one PG of a k=8 m=3 pool (size 11, min_size 9) on 12
# OSD facades, 11 acting and one spare, the object path's objects
# 256 ran past the phase's ~90 s; at 64 the 256 MiB residency budget
# holds every object and the degraded reads decode nothing (PERF.md
# section 4)
PG_OSDS, PG_OBJS = 12, 128
# 4 KiB partial writes, cut from 256 to hold the smoke's time limit
PG_RMW_OPS = 128
PG_SCRUB_OBJS = PG_NATIVE_OBJS = 16
OBJ_RESERVE_LARGE, OBJ_RESERVE_SMALL = 4 << 30, 512 << 20


T_SMOKE = time.perf_counter()


def mark(what: str) -> None:
    """The smoke's own clock: seconds since the script started."""
    print(f"smoke: {what} done at {time.perf_counter() - T_SMOKE:.1f} s",
          flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


class PaxosTimeouts(logging.Handler):
    """Counts this process's paxos collect and begin timeouts (``n``),
    from the lines the mons' paxos logs for each, in both packages,
    until ``close``."""

    def __init__(self):
        super().__init__()
        self.n = {"collect": 0, "begin": 0}
        logging.getLogger("ceph_tpu").addHandler(self)

    def emit(self, record):
        msg = record.getMessage()
        if "collect timed out" in msg:
            self.n["collect"] += 1
        elif "timed out; calling election" in msg:
            self.n["begin"] += 1

    def close(self):
        logging.getLogger("ceph_tpu").removeHandler(self)
        super().close()


def random_bytes(shape, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def events_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back runs,
    after one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err_vs_plain(kernels, bm: torch.Tensor, data: torch.Tensor,
                     got: torch.Tensor, step: int = PLAIN_SLICE) -> int:
    """Largest |kernel - plain| byte difference, in slices of ``step``
    stripes."""
    worst = 0
    for s in range(0, data.shape[0], step):
        plain = kernels.gf_encode_plain(bm, data[s:s + step])
        diff = (got[s:s + step].int() - plain.int()).abs().max()
        worst = max(worst, int(diff))
    return worst


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    # Exact float32 products in the plain versions (their 0/1 operands are
    # exact under TF32 too); stated, as every reference here should.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ceph_tpu_torch.bench import ec_benchmark, gf_kernel_bench
    from ceph_tpu_torch.ec import matrix as rs
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.gf import kernels, tables
    from ceph_tpu_torch.utils import cuda_build, roofline, timing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build(["gf_encode", "crush_straw2"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for src, log in logs.items():
        print(f"[nvcc {src}]\n{log.strip()}")

    # -- 1. the main path ----------------------------------------------------
    registry = ErasureCodePluginRegistry.instance()
    ec = registry.factory("jax", "k=8 m=3 technique=reed_sol_van")
    require(ec.backend == "kernel" and ec.device.type == "cuda",
            f"backend=auto chose {ec.backend} on {ec.device}")
    data = random_bytes((B, K, C), SEED)
    torch.cuda.synchronize()
    kernels.gf_encode.launches = 0
    parity = ec.encode_batch(data)
    chunks = torch.cat([data, parity], dim=1)[:, AVAIL].contiguous()
    decoded = ec.decode_batch(ERASED, AVAIL, chunks)
    torch.cuda.synchronize()
    launches = kernels.gf_encode.launches
    require(launches == 2, f"gf_encode launched {launches} times, want 2 "
                           f"(one encode_batch, one decode_batch)")
    print(f"main path: encode {tuple(data.shape)} -> {tuple(parity.shape)}, "
          f"decode {ERASED} from {AVAIL}; gf_encode launches {launches}")

    # -- 2. checks -----------------------------------------------------------
    coeffs = rs.coding_matrix("reed_sol_van", K, M)
    enc_bm, dec_bm = flagship_bitmatrices()
    err_enc = max_err_vs_plain(kernels, enc_bm, data, parity)
    err_dec = max_err_vs_plain(kernels, dec_bm, chunks, decoded)
    require(err_enc == 0, f"encode differs from plain by {err_enc}")
    require(err_dec == 0, f"decode differs from plain by {err_dec}")
    for s in (0, B // 2, B - 1):
        oracle = tables.gf_matmul_np(coeffs, data[s].cpu().numpy())
        require(np.array_equal(parity[s].cpu().numpy(), oracle),
                f"stripe {s} parity differs from the numpy oracle")
    require(torch.equal(decoded, data[:, ERASED]),
            "decode did not return the erased chunks")
    print("checks: encode and decode equal plain and oracle; decode exact")

    for tech, m in (("cauchy_good", 3), ("reed_sol_r6_op", 2)):
        other = registry.factory("jax", f"k={K} m={m} technique={tech}")
        sub = data[:PLAIN_SLICE]
        par = other.encode_batch(sub)
        want = np.stack([tables.gf_matmul_np(rs.coding_matrix(tech, K, m), x)
                         for x in sub[:2].cpu().numpy()])
        require(np.array_equal(par[:2].cpu().numpy(), want),
                f"{tech} parity differs from the numpy oracle")
        erased, avail = [0, K], [i for i in range(K + m) if i not in (0, K)]
        full = torch.cat([sub, par], dim=1)
        got = other.decode_batch(erased, avail[:K],
                                 full[:, avail[:K]].contiguous())
        require(torch.equal(got, full[:, erased]), f"{tech} decode not exact")
        print(f"checks: {tech} k={K} m={m} encode and decode exact")

    # -- 3. ragged shapes ------------------------------------------------------
    rng = np.random.default_rng(SEED)
    ragged = [(1, 8, 3, 4099, None), (2, 8, 3, 1, None), (3, 5, 6, 17, None),
              (1, 3, 9, 16 * 1000 + 7, "random"), (2, 8, 3, 4096, "offset")]
    for i, (b, k, m, c, kind) in enumerate(ragged):
        if kind == "random":
            bm_np = rng.integers(0, 2, size=(8 * m, 8 * k), dtype=np.uint8)
        else:
            bm_np = tables.expand_bitmatrix(
                rng.integers(0, 256, size=(m, k), dtype=np.uint8))
        bm = torch.as_tensor(bm_np, device="cuda")
        if kind == "offset":      # contiguous, but 1 byte off alignment
            flat = random_bytes((b * k * c + 1,), SEED + i)
            x = flat[1:].view(b, k, c)
        else:
            x = random_bytes((b, k, c), SEED + i)
        got = kernels.gf_encode(bm, x)
        plain = kernels.gf_encode_plain(bm, x)
        require(torch.equal(got, plain),
                f"ragged case B={b} k={k} m={m} C={c} {kind} differs")
    torch.cuda.synchronize()
    print(f"ragged: {len(ragged)} shapes equal the plain version")

    # -- 4. times ------------------------------------------------------------
    spec = roofline.device_spec(name)
    require(spec is not None, f"no datasheet entry for {name}")
    enc_plan = ec._encode_kernel.plan
    dec_plan = ec._decode_kernel(tuple(AVAIL), tuple(ERASED)).plan
    enc_ms = events_ms(
        lambda: kernels.encode_batch_planned(enc_plan, data), 20)
    dec_ms = events_ms(
        lambda: kernels.encode_batch_planned(dec_plan, chunks), 20)
    raw_enc_ms = events_ms(lambda: kernels.gf_encode(enc_bm, data), 20)
    raw_dec_ms = events_ms(lambda: kernels.gf_encode(dec_bm, chunks), 20)
    plain_enc_ms = events_ms(lambda: kernels.gf_encode_plain(enc_bm, data), 3)
    plain_dec_ms = events_ms(
        lambda: kernels.gf_encode_plain(dec_bm, chunks), 3)
    enc_bytes, enc_ops = roofline.gf_encode_work(B, K, M, C)
    dec_bytes, dec_ops = roofline.gf_encode_work(B, K, len(ERASED), C)
    enc_bound_s, bound_by = roofline.bound_seconds(enc_bytes, enc_ops, spec)
    dec_bound_s, _ = roofline.bound_seconds(dec_bytes, dec_ops, spec)
    timings = {
        "card": card,
        "shape": {"B": B, "k": K, "m": M, "C": C},
        "encode": {"kernel_ms": enc_ms, "raw_ms": raw_enc_ms,
                   "plain_ms": plain_enc_ms,
                   "bound_ms": enc_bound_s * 1e3, "bytes": enc_bytes,
                   "input_GiB/s": B * K * C / (enc_ms / 1e3) / 2**30},
        "decode": {"kernel_ms": dec_ms, "raw_ms": raw_dec_ms,
                   "plain_ms": plain_dec_ms,
                   "bound_ms": dec_bound_s * 1e3, "bytes": dec_bytes,
                   "read_GiB/s": B * K * C / (dec_ms / 1e3) / 2**30},
    }
    print("timings: " + json.dumps(timings))
    # the kernel alone at the six shapes of the EC paths, both entry
    # points in turns
    shapes = gf_kernel_bench.measure(gf_kernel_bench.builds(), spec,
                                     plain=False)
    for rec in shapes:
        require(not any(rec["max_abs_err"].values()),
                f"gf_encode differs from plain at {rec['shape']}")
        print(f"[{card}] gf_encode at {rec['shape']}: " + json.dumps(rec))
    flagship = ["--plugin", "jax", "--size", str(K * C), "--iterations",
                str(B), "--parameter", f"k={K}", "--parameter", f"m={M}",
                "--json"]
    enc_row = ec_benchmark.main(["--workload", "encode", *flagship])
    dec_row = ec_benchmark.main(["--workload", "decode", "--erasures", "2",
                                 *flagship])
    want_mfu = round(100 * roofline.mfu(
        K, M, enc_row["total_bytes"] / enc_row["seconds"], spec), 2)
    require(0 < enc_row.get("mfu_pct", 0) <= 47.4
            and enc_row["mfu_pct"] == want_mfu,
            f"the flagship encode row's mfu_pct is "
            f"{enc_row.get('mfu_pct')}, want {want_mfu} in (0, 47.4]")
    require("mfu_pct" not in dec_row, "a decode row carries mfu_pct")
    xor = timing.xor_anchor(parity)
    want_xor = int(np.bitwise_xor.reduce(parity.cpu().numpy().reshape(-1)))
    require(xor.device == parity.device and xor.dtype == torch.uint8
            and int(xor) == want_xor,
            f"xor_anchor of the parity is {int(xor)} on {xor.device}, "
            f"the host's XOR is {want_xor}")
    print(f"[{card}] flagship encode mfu_pct {enc_row['mfu_pct']} "
          f"(the share of the int8 tensor-core peak that the bit-plane "
          f"form of this rate would take; gf_encode uses no tensor core); "
          f"xor_anchor of the parity {int(xor)} equals the host's")
    mark("ec main path")

    with SidePhases(card) as side:
        with multiprocessing.get_context("spawn").Pool(8) as pool:
            crush = crush_phases(spec, pool)
            mark("crush")
            # everything below runs beside the side process's phases
            side.start()
            mon_launches, mon_worst = mon_path_phase(card, pool)
            mark("mon_path")
            side.check()
            cluster = osd_cluster_path_phase(card, pool)
            mark("osd_cluster_path")
            side.check()
        rbd = rbd_path_phase(card)
        fs, storm = rbd.pop("fs_rgw"), rbd.pop("storm")
        mark("storm_path")
        tail = side.result()
    md_crush, md_gf = tail["multi_device_path"]
    crush["launches_by_path"] = {"crush_main": crush["launches"],
                                 "placement_epochs": tail["placement_epochs"],
                                 "mon_path": mon_launches,
                                 "osd_cluster_path": cluster["crush"][0],
                                 "rbd_path": rbd["crush"][0],
                                 "fs_rgw_path": fs["crush"][0],
                                 "storm_path": storm["crush"][0],
                                 "multi_device_path": md_crush[0]}
    crush["launches"] = sum(crush["launches_by_path"].values())
    crush["max_abs_err"] = max(crush["max_abs_err"], mon_worst,
                               cluster["crush"][1], rbd["crush"][1],
                               fs["crush"][1], storm["crush"][1],
                               md_crush[1])
    by_path = {"encode_decode": launches}
    by_path.update(tail["plane"])
    by_path.update(tail["plugins"])
    by_path.update(tail["object"])
    by_path["ec_pg_path"] = tail["ec_pg_path"][0]
    by_path["multi_device_path"] = md_gf[0]
    by_path["osd_cluster_path"] = cluster["gf"][0]
    by_path["rbd_path"] = rbd["gf"][0]
    by_path["fs_rgw_path"] = fs["gf"][0]
    by_path["storm_path"] = storm["gf"][0]
    print(f"gf_encode launches by path: {json.dumps(by_path)}")

    # -- result ----------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "gf_encode",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_encode.cu",
        "replaces": "ceph_tpu/gf/pallas_kernels.py:168",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(err_enc, err_dec, tail["err_plane"],
                           tail["err_object"], tail["ec_pg_path"][1],
                           cluster["gf"][1], rbd["gf"][1], fs["gf"][1],
                           storm["gf"][1], md_gf[1]),
        "ms": enc_ms,
        "plain_ms": plain_enc_ms,
        "bound_ms": enc_bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
    }, crush]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def flagship_bitmatrices() -> tuple[torch.Tensor, torch.Tensor]:
    """The flagship's encode and decode bitmatrices on the card."""
    from ceph_tpu_torch.ec import matrix as rs
    from ceph_tpu_torch.gf import tables

    enc = rs.coding_matrix("reed_sol_van", K, M)
    dec = rs.decode_matrix("reed_sol_van", K, M, tuple(AVAIL), tuple(ERASED))
    return (torch.as_tensor(tables.expand_bitmatrix(enc), device="cuda"),
            torch.as_tensor(tables.expand_bitmatrix(dec), device="cuda"))


# -- the side process ---------------------------------------------------------
# The phases that share no state with the mon and the clusters run in one
# spawned process beside them, so the smoke's time is the longer of the
# two lines, not their sum (the whole smoke passed the 1,200 s limit on a
# slower host when every phase ran in turn; PERF.md section 4). The side
# runs at a lower CPU priority than every daemon (the OSDs at nice 5), so
# the clusters' heartbeats and leases keep their share of the host.
SIDE_LOG = "build/side_phases.log"     # the side process's standard output
SIDE_NICE = 10
SIDE_WAIT = 900.0      # the longest wait for its result after storm_path


class SidePhases:
    """Runs ``side_phases`` in a spawned process from ``start`` on.
    Each of its phases sets the kernels' counts to 0 just before it and
    reads them just after, in that process, as the main one does for its
    own. ``check`` raises at once if the side failed; ``result`` waits for
    it, prints its standard output (``SIDE_LOG``) whole and returns its
    record. Leaving the ``with`` block stops the process if it still
    runs."""

    def __init__(self, card: str):
        self.card = card
        self.proc = self.conn = self.msg = None
        self.log = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                SIDE_LOG)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        if self.proc is not None and self.msg is not None:
            self.proc.join(60)          # it has reported and is ending
        if self.proc is not None and self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()

    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        # the smoke's start on the wall clock, for the side's own marks
        t_start = time.time() - (time.perf_counter() - T_SMOKE)
        self.proc = ctx.Process(target=side_main, name="chip_smoke-side",
                                args=(child, self.card, self.log, t_start))
        self.proc.start()
        child.close()

    def _take(self, timeout: float):
        if self.msg is None and self.conn.poll(timeout):
            try:
                self.msg = self.conn.recv()
            except EOFError:
                self.proc.join(60)
                self.msg = ("error", f"the side process ended (exit code "
                                     f"{self.proc.exitcode}) with no result")
        if self.msg is not None and self.msg[0] != "ok":
            self.show()
            raise RuntimeError(f"chip smoke failed in the side process:\n"
                               f"{self.msg[1]}")
        return self.msg

    def check(self) -> None:
        self._take(0)

    def result(self) -> dict:
        t0 = time.perf_counter()
        msg = self._take(SIDE_WAIT)
        require(msg is not None, f"the side process gave no result within "
                                 f"{SIDE_WAIT} s of storm_path's end")
        self.proc.join(60)
        require(self.proc.exitcode == 0,
                f"the side process exited with {self.proc.exitcode}")
        print(f"smoke: the side process's result waited on for "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        self.show()
        return msg[1]

    def show(self) -> None:
        """The side's standard output, under a heading."""
        print("smoke: the side process's output follows", flush=True)
        if os.path.exists(self.log):
            with open(self.log) as f:
                print(f.read(), end="", flush=True)


def side_main(conn, card: str, log: str, t_start: float) -> None:
    """The side process: ``side_phases`` with its standard output in
    ``log``; sends ("ok", record) or ("error", traceback) on ``conn``."""
    import signal
    import traceback

    global T_SMOKE
    T_SMOKE = time.perf_counter() - (time.time() - t_start)
    # a stop from the main process unwinds, so the pools and subprocesses
    # of the running phase are stopped by their own context managers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
    os.nice(SIDE_NICE)
    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as out:
        sys.stdout.flush()
        os.dup2(out.fileno(), 1)
    try:
        msg = ("ok", side_phases(card))
    except BaseException:
        msg = ("error", traceback.format_exc())
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    sys.stdout.flush()
    conn.send(msg)
    conn.close()
    if msg[0] != "ok":
        sys.exit(1)


def side_phases(card: str) -> dict:
    """Placement across epochs, the EC data plane and plugins, the EC
    object and PG paths and the multi-device layer, in that order; returns
    each one's launches and largest difference from the plain version."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.utils import roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = roofline.device_spec(torch.cuda.get_device_name(0))
    rec = {}
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        rec["placement_epochs"] = placement_epochs_phase(card, pool)
    mark("placement_epochs")
    registry = ErasureCodePluginRegistry.instance()
    ec = registry.factory("jax", f"k={K} m={M} technique=reed_sol_van")
    enc_bm, dec_bm = flagship_bitmatrices()
    rec["plane"], rec["err_plane"] = ec_plane_phases(ec, enc_bm, dec_bm,
                                                     card, spec)
    rec["plugins"] = ec_plugin_phase(registry, card)
    mark("ec plane and plugins")
    rec["object"], rec["err_object"] = ec_object_path_phase(registry, card,
                                                            spec)
    mark("ec_object_path")
    rec["ec_pg_path"] = ec_pg_path_phase(card, spec)
    mark("ec_pg_path")
    md = multi_device_path_phase(card)
    mark("multi_device_path")
    rec["multi_device_path"] = (md["crush"], md["gf"])
    return rec


def ec_plane_phases(ec, enc_bm, dec_bm, card: str, spec):
    """The OSD's EC data plane on the card (phases 11-16); returns the
    gf_encode launches of each path and the largest byte difference from
    the kernel's plain version over every batch the paths launched."""
    from ceph_tpu_torch.bench import ec_streaming
    from ceph_tpu_torch.ec import crc as ec_crc
    from ceph_tpu_torch.ec.torch_plugin import (DeviceShardCache,
                                                StreamingEncodePipeline,
                                                to_host)
    from ceph_tpu_torch.gf import kernels, tables
    from ceph_tpu_torch.osd.ec_aggregator import ECAggregator
    from ceph_tpu_torch.osd.ec_read_aggregator import ECReadAggregator
    from ceph_tpu_torch.utils import roofline
    from ceph_tpu_torch.utils.devmon import devmon

    launches = {}
    flushes = N_OPS * OP_STRIPES // 4096   # default osd_ec_agg_max_stripes
    per_flush = N_OPS // flushes
    coeffs = ec._encode_kernel.coeffs
    worst = 0

    def vs_plain(bm, inputs, outputs, what: str) -> None:
        """The batch a path launched, rebuilt on the card from its ops in
        submission order, against the kernel's plain version."""
        nonlocal worst
        err = max_err_vs_plain(
            kernels, bm, torch.as_tensor(np.concatenate(inputs),
                                         device="cuda"),
            torch.as_tensor(np.concatenate(outputs), device="cuda"), 256)
        require(err == 0, f"{what}: differs from the plain version by {err}")
        worst = max(worst, err)
    rng = np.random.default_rng(SEED + 1)
    ops = [rng.integers(0, 256, (OP_STRIPES, K, OP_C), dtype=np.uint8)
           for _ in range(N_OPS)]

    def counted(path: str, run):
        torch.cuda.synchronize()
        kernels.gf_encode.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        launches[path] = kernels.gf_encode.launches
        return out, time.perf_counter() - t0

    # -- 11. write path ------------------------------------------------------
    wagg = ECAggregator({})

    async def writes():
        return await asyncio.gather(*[wagg.encode(ec, d, with_crc=True)
                                      for d in ops])

    written, write_s = counted("write_aggregator", lambda: asyncio.run(
        writes()))
    wd = wagg.perf.dump()
    require(launches["write_aggregator"] == flushes == wd["batches"]
            == wd["flush_full"],
            f"write path: {launches['write_aggregator']} gf_encode "
            f"launches, {wd['batches']} flushes, want {flushes}")
    for f in range(flushes):
        sl = slice(f * per_flush, (f + 1) * per_flush)
        vs_plain(enc_bm, ops[sl], [p for p, _ in written[sl]],
                 f"write path: flush {f}")
    words = []
    for i, (d, (p, c)) in enumerate(zip(ops, written)):
        require(np.array_equal(p, to_host(ec.encode_batch(d))),
                f"write path: op {i} parity differs from its own launch")
        require(c is not None and c.shape == (OP_STRIPES, K + M),
                f"write path: op {i} has no row CRCs")
        word = np.concatenate([d, p], axis=1)
        folded = ec_crc.shard_crc32(c.T, OP_C)
        want = [zlib.crc32(word[:, s].tobytes()) for s in range(K + M)]
        require([int(x) for x in folded] == want,
                f"write path: op {i} shard CRCs differ from zlib")
        words.append(word)
    print(f"[{card}] write path: {N_OPS} ops x {OP_STRIPES} stripes x "
          f"C={OP_C} through ECAggregator(with_crc) in {write_s:.3f} s "
          f"(host clock, first use included); gf_encode launches "
          f"{launches['write_aggregator']}; each flushed batch equals the "
          f"plain version, every parity its own launch; "
          f"{N_OPS * (K + M)} shard CRCs equal zlib")

    # -- 12. read path -------------------------------------------------------
    avail = tuple(range(2, 2 + K))
    survivors = [np.ascontiguousarray(w[:, 2:2 + K]) for w in words]
    ragg = ECReadAggregator({})

    async def reads():
        return await asyncio.gather(*[
            ragg.decode(ec, tuple(ERASED), avail, sv) for sv in survivors])

    rebuilt, read_s = counted("read_aggregator",
                              lambda: asyncio.run(reads()))
    rd = ragg.perf.dump()
    require(launches["read_aggregator"] == flushes == rd["batches"],
            f"read path: {launches['read_aggregator']} launches, "
            f"{rd['batches']} flushes, want {flushes}")
    for f in range(flushes):
        sl = slice(f * per_flush, (f + 1) * per_flush)
        vs_plain(dec_bm, survivors[sl], rebuilt[sl], f"read path: flush {f}")
    for i, (d, r) in enumerate(zip(ops, rebuilt)):
        require(np.array_equal(r, d[:, ERASED]),
                f"read path: op {i} did not rebuild chunks {ERASED}")
    for i in (0, N_OPS // 2, N_OPS - 1):
        require(np.array_equal(rebuilt[i], ec.decode_batch_reference(
            ERASED, avail, survivors[i])),
            f"read path: op {i} differs from decode_batch_reference")
    print(f"[{card}] read path: chunks {ERASED} of {N_OPS} ops rebuilt "
          f"from {list(avail)} through ECReadAggregator in {read_s:.3f} s "
          f"(host clock); gf_encode launches "
          f"{launches['read_aggregator']}; all equal the data and the "
          f"plain version, 3 equal decode_batch_reference")

    # -- 13. streaming -------------------------------------------------------
    batches = [np.concatenate(ops[i:i + STREAM_OPS])
               for i in range(0, N_OPS, STREAM_OPS)]
    pipe = StreamingEncodePipeline(ec)
    streamed, stream_s = counted("stream_pipeline",
                                 lambda: pipe.encode_all(batches))
    require(launches["stream_pipeline"] == len(batches),
            f"stream: {launches['stream_pipeline']} launches, want "
            f"{len(batches)}")
    for j, (b, out) in enumerate(zip(batches, streamed)):
        vs_plain(enc_bm, [b], [out], f"stream: batch {j}")
        slot = j % STREAM_OPS              # a different op slot each batch
        op = j * STREAM_OPS + slot
        got = out[slot * OP_STRIPES:(slot + 1) * OP_STRIPES]
        require(np.array_equal(got, tables.gf_matmul_np(
            coeffs, ops[op].transpose(1, 0, 2)).transpose(1, 0, 2)),
            f"stream: op {op} differs from the numpy oracle")
        require(np.array_equal(out, to_host(ec.encode_batch(b))),
                f"stream: batch {j} differs from its per-batch encode")
        require(np.array_equal(out, np.concatenate(
            [p for p, _ in written[j * STREAM_OPS:(j + 1) * STREAM_OPS]])),
            f"stream: batch {j} differs from the write path's parity")
    print(f"[{card}] stream: {len(batches)} batches of {STREAM_OPS} ops "
          f"through StreamingEncodePipeline in {stream_s:.3f} s (host "
          f"clock, first use included); equal to the plain version and "
          f"per-batch encode, {len(batches)} ops equal gf_matmul_np")

    # -- 14. scrub CRCs and residency ---------------------------------------
    rows = random_bytes((SCRUB_ROWS, OP_C), SEED + 2).cpu().numpy()
    rcs = ec_crc.device_row_crcs(rows, device="cuda")
    folded = ec_crc.shard_crc32(rcs[:, None], OP_C)
    require([int(x) for x in folded] ==
            [zlib.crc32(r.tobytes()) for r in rows],
            "scrub: device_row_crcs differ from zlib")
    cache = DeviceShardCache({})
    budget = cache.budget()
    n_put = budget // ops[0].nbytes + 16
    for i in range(n_put):
        cache.put(("1.0", f"obj{i}", 0, 1), ops[i])
    dump = cache.dump()
    require(dump["evictions"] == 16 and dump["resident_bytes"] <= budget,
            f"residency: {dump}")
    require(cache.get(("1.0", "obj0", 0, 1)) is None,
            "residency: the LRU entry was not evicted")
    hot = cache.get(("1.0", f"obj{n_put - 1}", 0, 1))
    require(hot is not None and hot.device.type == "cuda" and
            np.array_equal(to_host(hot), ops[n_put - 1]),
            "residency: the MRU entry is not the op's bytes on the card")
    src = ops[0].copy()
    cache.put(("1.0", "copy", 0, 1), src)
    src[:] = 0
    require(np.array_equal(to_host(cache.get(("1.0", "copy", 0, 1))),
                           ops[0]), "residency: put aliased its source")
    require(cache.invalidate("1.0", f"obj{n_put - 1}") == 1 and
            cache.get(("1.0", f"obj{n_put - 1}", 0, 1)) is None,
            "residency: invalidate left the entry")
    print(f"[{card}] scrub: {SCRUB_ROWS} rows x {OP_C} B, device_row_crcs "
          f"equal zlib; residency: {n_put} puts of 1 MiB under the "
          f"{budget >> 20} MiB budget: {json.dumps(cache.dump())}")

    # -- 16. times (before the ladder check: the bench's rungs count too) ---
    rec = ec_streaming.ec_streaming_section()
    rec["card"] = card
    print(f"[{card}] ec_streaming: " + json.dumps(rec))
    big = torch.as_tensor(np.concatenate(ops[:4096 // OP_STRIPES]),
                          device="cuda")
    word_rows = torch.cat([big, kernels.gf_encode(enc_bm, big)],
                          dim=1).reshape(-1, OP_C)
    enc_ms = events_ms(lambda: kernels.gf_encode(enc_bm, big), 20)
    crc_ms = events_ms(lambda: ec_crc.row_crcs_t(word_rows), 5)
    fused_ms = events_ms(lambda: ec.encode_batch_with_crc(big), 5)
    n_rows = int(word_rows.shape[0])
    crc_bytes = n_rows * OP_C + 4 * n_rows
    crc_flops = 2 * n_rows * 8 * OP_C * 32
    enc_bytes, enc_ops = roofline.gf_encode_work(int(big.shape[0]), K, M,
                                                 OP_C)
    enc_bound_s, _ = roofline.bound_seconds(enc_bytes, enc_ops, spec)
    print(f"[{card}] crc leg at the aggregated batch "
          f"({int(big.shape[0])}, {K}, {OP_C}): " + json.dumps({
              "encode_kernel_ms": enc_ms,
              "encode_bound_ms": enc_bound_s * 1e3,
              "crc_leg_ms": crc_ms, "crc_rows": n_rows,
              "crc_bytes_bound_ms": crc_bytes / spec.hbm_bytes_per_s * 1e3,
              "crc_fp32_flops": crc_flops,
              "crc_fp32_bound_ms": crc_flops / FP32_FLOPS * 1e3,
              "fused_encode_with_crc_ms": fused_ms}))

    # -- 15. ladders ---------------------------------------------------------
    rungs = {f"write.{k}": wd[k] for k in (
        "flush_failures", "per_op_retries", "fallback_ops", "crc_fallbacks")}
    rungs.update({f"read.{k}": rd[k] for k in (
        "flush_failures", "per_op_retries", "fallback_ops",
        "quarantined_ops")})
    dm = devmon().perf.dump()
    rungs.update({f"devmon.{k}": dm[k]
                  for k in ("stream_fallbacks", "faults_injected")})
    rungs.update({f"bench.{k}": v for k, v in rec["ladder"].items()})
    print(f"[{card}] ladders: " + json.dumps(rungs))
    require(not any(rungs.values()),
            f"a degrade-ladder rung engaged on the card: {rungs}")
    return launches, worst


def ec_plugin_phase(registry, card: str) -> dict:
    """One 4 MiB object through lrc, shec and clay (encode, erase,
    decode), each against its host reference; returns the gf_encode
    launches of lrc and shec (clay is host numpy)."""
    from ceph_tpu_torch.gf import kernels, tables

    payload = random_bytes((4 << 20,), SEED + 3).cpu().numpy().tobytes()
    launches = {}
    for name, prof, erase in (
            ("lrc", "k=4 m=2 l=3", [0, 5]),
            ("shec", "k=8 m=4 c=3", [0, 5]),
            ("clay", "k=4 m=2 d=5", [0, 5])):
        ec = registry.factory(name, prof)
        n = ec.get_chunk_count()
        torch.cuda.synchronize()
        kernels.gf_encode.launches = 0
        t0 = time.perf_counter()
        enc = ec.encode(range(n), payload)
        have = {i: c for i, c in enc.items() if i not in erase}
        dec = ec.decode(list(range(n)), have)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = kernels.gf_encode.launches
        data = ec.encode_prepare(payload)
        parity = np.stack([np.frombuffer(enc[i], dtype=np.uint8)
                           for i in range(ec.k, n)])
        if name == "lrc":
            want = ec.encode_batch_reference(data[None])[0]
        elif name == "shec":
            want = tables.gf_matmul_np(ec.matrix, data)
        else:
            # host numpy in both packages: rebuild the parity from the
            # data alone by the layered decode's other route
            want = np.stack([np.frombuffer(ec.decode(
                [i], {j: enc[j] for j in range(n) if j != i})[i],
                dtype=np.uint8) for i in range(ec.k, n)])
        require(np.array_equal(parity, want),
                f"{name}: parity differs from its host reference")
        require(all(dec[i] == enc[i] for i in range(n)),
                f"{name}: decode after erasing {erase} not exact")
        require(ec.decode_concat(have)[:len(payload)] == payload,
                f"{name}: payload not recovered")
        require((launches[name] > 0) == (name != "clay"),
                f"{name}: {launches[name]} gf_encode launches")
        print(f"[{card}] plugin {name} {prof}: 4 MiB object, C="
              f"{len(enc[0])}, encode + decode of {erase} in {secs:.3f} s "
              f"(host clock); gf_encode launches {launches[name]}; "
              f"parity equals the host reference; decode exact")
    return launches


class GfLaunchLog:
    """A checking hook around both entry points of the encode kernel,
    ``kernels.gf_encode`` and ``kernels.encode_batch_planned``: every
    launch is timed with CUDA events under the current ``label`` and,
    once ``drain`` runs, held against ``gf_encode_plain`` on the same
    bitmatrix (a plan's own) and batch (after the timed windows, so the
    check costs the path nothing). The batches a launch reads and writes
    are fresh tensors that nothing writes later, so holding references
    is enough. ``real.launches`` is the kernel's count of both."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.real = kernels.gf_encode
        self.real_planned = kernels.encode_batch_planned
        self.label = None
        self.pending = []
        self.launches, self.ms, self.shapes = {}, {}, {}
        self.checked = self.worst = 0

    def __enter__(self):
        self.kernels.gf_encode = self.launch
        self.kernels.encode_batch_planned = self.launch_planned
        return self

    def __exit__(self, *exc):
        self.kernels.gf_encode = self.real
        self.kernels.encode_batch_planned = self.real_planned

    def _timed(self, fn, op, bm, data):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(op, data)
        end.record()
        self.pending.append((bm, data, out, start, end, self.label))
        return out

    def launch(self, bm, data):
        return self._timed(self.real, bm, bm, data)

    def launch_planned(self, plan, data):
        return self._timed(self.real_planned, plan, plan.bitmatrix, data)

    def drain(self, what: str) -> None:
        """Check every pending launch against the plain version."""
        for bm, data, out, start, end, label in self.pending:
            end.synchronize()
            self.launches[label] = self.launches.get(label, 0) + 1
            self.ms[label] = self.ms.get(label, 0.0) + \
                start.elapsed_time(end)
            shape = "x".join(map(str, data.shape))
            by = self.shapes.setdefault(label, {})
            by[shape] = by.get(shape, 0) + 1
            err = max_err_vs_plain(self.kernels, bm, data, out, 256)
            require(err == 0, f"{what}: a gf_encode launch of "
                              f"{tuple(data.shape)} differs from its plain "
                              f"version by {err}")
            self.worst = max(self.worst, err)
            self.checked += 1
        self.pending.clear()


def reserve_allocator(large: int, small: int) -> None:
    """Fill PyTorch's caching allocator with free device memory, ``large``
    bytes in one block (served split, for batches over 1 MiB) and
    ``small`` bytes in 1 MiB tensors (the 2 MiB segments of the small
    pool). A checking hook holds every batch of a path until it drains;
    with the memory already cached, neither those batches nor a launch's
    output need a cudaMalloc inside the timed paths, as in a steady
    state that holds nothing."""
    big = torch.empty(large, dtype=torch.uint8, device="cuda")
    few = [torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
           for _ in range(small >> 20)]
    del big, few


def write_breakdown(be, rng, n_objs: int, n_rmw: int) -> dict:
    """Host seconds of a whole-object write and of a 4 KiB RMW taken
    apart on the live backend (off the main path, on fresh objects):
    the gather of the old stripes with its residency put, the encode
    call (H2D of the merged batch and the launch), the readback of the
    parity (the wait for the kernel and the D2H), and the rest (the
    merge copy and the shard stores), by timing wrappers on the
    backend's own calls."""
    from ceph_tpu_torch.osd import ec_backend as ecb

    spent = {"gather_and_pin": 0.0, "encode_call": 0.0, "readback": 0.0}

    def timing(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t0
            return out
        return run
    real_to_host = ecb.to_host
    be._resident_read = timing("gather_and_pin", be._resident_read)
    be.ec.encode_batch = timing("encode_call", be.ec.encode_batch)
    ecb.to_host = timing("readback", real_to_host)
    out = {}
    try:
        for what, ops in (
                ("write_4MiB", [(f"bd.{i}", 0, rng.integers(
                    0, 256, OBJ_SIZE, dtype=np.uint8).tobytes())
                    for i in range(n_objs)]),
                ("rmw_4KiB", [(f"bd.{int(rng.integers(0, n_objs))}",
                               int(rng.integers(0, OBJ_SIZE - RMW_BYTES)),
                               rng.integers(0, 256, RMW_BYTES,
                                            dtype=np.uint8).tobytes())
                              for _ in range(n_rmw)])):
            for key in spent:
                spent[key] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for oid, off, data in ops:
                be.write(oid, off, data)
            total = time.perf_counter() - t0
            rec = {k: v / len(ops) for k, v in spent.items()}
            rec["rest"] = total / len(ops) - sum(rec.values())
            rec["total"] = total / len(ops)
            out[what] = rec
    finally:
        del be._resident_read, be.ec.encode_batch
        ecb.to_host = real_to_host
    return out


def ec_object_path_phase(registry, card: str, spec) -> tuple[dict, int]:
    """The OSD's erasure-coded object path on the card (phases 22-29):
    ``ECBackendLite`` over the flagship plugin with residency, 256
    objects of 4 MiB. Returns the gf_encode launches of the object path
    and of ``ec_daemon_path`` (each path driven with the count set to 0
    just before it and read just after), and the largest byte difference
    of any launch from the plain version."""
    from ceph_tpu_torch.bench import ec_daemon_path
    from ceph_tpu_torch.gf import kernels
    from ceph_tpu_torch.osd.ec_backend import ECBackendLite
    from ceph_tpu_torch.utils import roofline

    ec = registry.factory("jax", f"k={K} m={M} technique=reed_sol_van")
    require(ec.device.type == "cuda", f"object path plugin on {ec.device}")
    budget = OBJ_RESIDENT_BYTES
    be = ECBackendLite(ec, chunk_size=OBJ_C, name="ec_backend_smoke",
                       config={"osd_ec_resident_bytes": budget})
    rng = np.random.default_rng(SEED + 5)
    oids = [f"rbd_data.{i:04x}" for i in range(OBJ_COUNT)]
    W = be.sinfo.stripe_width
    stripes = OBJ_SIZE // W
    host_s, rec = {}, {}
    t_phase = time.perf_counter()

    def timed(what: str, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s[what] = time.perf_counter() - t0
        return out

    reserve_allocator(OBJ_RESERVE_LARGE, OBJ_RESERVE_SMALL)
    with GfLaunchLog(kernels) as log:
        torch.cuda.synchronize()
        log.real.launches = 0
        # -- 22. write every object whole ---------------------------------
        log.label = "write"
        mirror = {}
        for oid in oids:
            mirror[oid] = bytearray(rng.integers(0, 256, OBJ_SIZE,
                                                 dtype=np.uint8).tobytes())

        def write_all():
            for oid in oids:
                be.write(oid, 0, bytes(mirror[oid]))
        timed("write", write_all)
        log.drain("write")

        # -- 23. RMW: 4 KiB random writes, then 100 KiB ones ----------------
        log.label = "rmw"
        small = []
        for j in range(RMW_OPS):
            oid = oids[int(rng.integers(0, OBJ_COUNT))]
            if j % 8 == 0:           # straddle a stripe boundary
                s = int(rng.integers(1, stripes))
                off = s * W - int(rng.integers(1, RMW_BYTES))
            else:
                off = int(rng.integers(0, OBJ_SIZE - RMW_BYTES))
            small.append((oid, off, rng.integers(
                0, 256, RMW_BYTES, dtype=np.uint8).tobytes()))
        big = [(oids[int(rng.integers(0, OBJ_COUNT))],
                int(rng.integers(0, OBJ_SIZE - RMW_BIG)),
                rng.integers(0, 256, RMW_BIG, dtype=np.uint8).tobytes())
               for _ in range(RMW_BIG_OPS)]

        def rmw(ops):
            for oid, off, data in ops:
                be.write(oid, off, data)
                mirror[oid][off:off + len(data)] = data
        straddle = sum((off // W) != ((off + RMW_BYTES - 1) // W)
                       for _, off, _ in small)
        timed("rmw", lambda: rmw(small))
        timed("rmw_100k", lambda: rmw(big))
        log.drain("rmw")
        require(straddle >= RMW_OPS // 8, f"rmw: {straddle} straddling ops")

        def read_all():
            for oid in oids:
                require(be.read(oid, 0, OBJ_SIZE) == bytes(mirror[oid]),
                        f"read-back: {oid} differs from its mirror")
        timed("read_cold", read_all)
        require(all(be.sizes[o] == OBJ_SIZE for o in oids),
                "read-back: an object size changed")

        # -- 24. recovery: one data and one parity shard on every object --
        log.label = "recover"
        lost = (2, 9)
        saved = {(s, o): be.shards[s][o].copy() for s in lost for o in oids}
        rc0 = be.perf.dump()["recover_chunks"]
        for s in lost:
            be.lose_shard(s)
        fixed = timed("recover", be.recover_all)
        log.drain("recover")
        require(fixed == {o: set(lost) for o in oids},
                f"recovery: {len(fixed)} objects recovered")
        for (s, o), arr in saved.items():
            require(np.array_equal(be.shards[s][o], arr),
                    f"recovery: shard {s} of {o} differs from its copy")
        got_chunks = be.perf.dump()["recover_chunks"] - rc0
        require(got_chunks == OBJ_COUNT * len(lost) * stripes,
                f"recovery: recover_chunks {got_chunks}")
        del saved
        timed("read_after_recovery", read_all)

        # -- 25. scrub: one flipped byte in one shard of 16 objects --------
        log.label = "scrub"
        bad = {}
        for i, oid in enumerate(oids[:SCRUB_OBJS]):
            shard = int(rng.integers(0, K)) if i < SCRUB_OBJS // 2 \
                else K + int(rng.integers(0, M))
            row, col = int(rng.integers(0, stripes)), int(
                rng.integers(0, OBJ_C))
            be.shards[shard][oid][row, col] ^= 0x5A
            bad[oid] = (shard, row, col)

        def scrub_bad():
            for oid, (shard, _, _) in bad.items():
                got = be.scrub(oid)
                require(got == [shard], f"scrub: {oid} returned {got}, "
                                        f"want [{shard}]")
        timed("scrub_corrupt", scrub_bad)
        for oid, (shard, row, col) in bad.items():
            be.shards[shard][oid][row, col] ^= 0x5A
        clean = oids[SCRUB_OBJS:2 * SCRUB_OBJS]

        def scrub_clean():
            for oid in clean:
                require(be.scrub(oid) == [], f"scrub: clean {oid} flagged")
        timed("scrub_clean", scrub_clean)
        log.drain("scrub")

        # -- 26. residency ------------------------------------------------
        log.label = "residency"
        hot = oids[-RESIDENT_OBJS:]
        d0 = be.resident.dump()

        def read_hot():
            for oid in hot:
                require(be.read(oid, 0, OBJ_SIZE) == bytes(mirror[oid]),
                        f"residency: {oid} differs from its mirror")
        timed("read_resident_first", read_hot)
        d1 = be.resident.dump()
        timed("read_resident", read_hot)
        d2 = be.resident.dump()
        require(d2["hits"] - d1["hits"] == RESIDENT_OBJS,
                f"residency: second pass hits {d2['hits'] - d1['hits']}")
        require(d2["resident_bytes"] <= budget, f"residency: {d2}")
        oid = hot[0]
        be.write(oid, 12345, b"\x42" * 4096)
        mirror[oid][12345:12345 + 4096] = b"\x42" * 4096
        d3 = be.resident.dump()
        require(d3["invalidations"] > d2["invalidations"],
                "residency: a write left its stale generation")
        require(be.read(oid, 0, OBJ_SIZE) == bytes(mirror[oid]),
                "residency: a read after the write is stale")
        require(be.resident.dump()["misses"] > d3["misses"],
                "residency: the read after a write hit a stale entry")
        log.drain("residency")
        torch.cuda.synchronize()
        obj_launches = log.real.launches

        # -- 27. parity against the independent native backend --------------
        native = registry.factory(
            "isa", f"k={K} m={M} technique=reed_sol_van")
        require(getattr(native, "independent", False) is True,
                f"isa gave {type(native).__name__}, not the native backend")
        picks = [(oids[int(rng.integers(0, OBJ_COUNT))],
                  int(rng.integers(0, stripes))) for _ in range(NATIVE_STRIPES)]
        t0 = time.perf_counter()
        for oid, s in picks:
            data = np.stack([be.shards[c][oid][s] for c in range(K)])
            stored = np.stack([be.shards[K + p][oid][s] for p in range(M)])
            require(np.array_equal(native.encode_chunks(data), stored),
                    f"native: stripe {s} of {oid} differs from the C++ "
                    f"backend's parity")
        host_s["native_check"] = time.perf_counter() - t0

        # -- 28. lrc and shec on 16 objects each ----------------------------
        log.real.launches = 0
        layered = {}
        for name, prof, shard in (("lrc", "k=4 m=2 l=3", 1),
                                  ("shec", "k=8 m=4 c=3", 5)):
            log.label = name
            lec = registry.factory(name, prof)
            lbe = ECBackendLite(lec, chunk_size=OBJ_C, name=f"ec_{name}")
            objs = {f"{name}.{i}": mirror[oids[i]] for i in range(LAYER_OBJS)}
            t0 = time.perf_counter()
            for oid, data in objs.items():
                lbe.write(oid, 0, bytes(data))
            torch.cuda.synchronize()
            w_s = time.perf_counter() - t0
            lbe.lose_shard(shard)
            _, to_read = lbe.recovery_plan(next(iter(objs)))
            require(len(to_read) < lbe.k, f"{name}: recovery reads "
                                          f"{sorted(to_read)}, not local")
            t0 = time.perf_counter()
            fixed = lbe.recover_all()
            torch.cuda.synchronize()
            r_s = time.perf_counter() - t0
            require(fixed == {o: {shard} for o in objs},
                    f"{name}: recovered {fixed}")
            for oid, data in objs.items():
                require(lbe.read(oid, 0, OBJ_SIZE) == bytes(data),
                        f"{name}: {oid} differs from its mirror")
            log.drain(name)
            layered[name] = {"profile": prof, "lost_shard": shard,
                             "reads": sorted(to_read), "write_s": w_s,
                             "recover_s": r_s,
                             "launches": log.launches.get(name, 0)}
        torch.cuda.synchronize()
        obj_launches += log.real.launches

        # -- 29. ec_daemon_path at the production shape ------------------------
        log.label = "ec_daemon_path"
        torch.cuda.synchronize()
        log.real.launches = 0
        daemon = ec_daemon_path.ec_daemon_path_section()
        torch.cuda.synchronize()
        daemon_launches = log.real.launches
        log.drain("ec_daemon_path")
        daemon["card"] = card
        print(f"[{card}] ec_daemon_path: " + json.dumps(daemon))
        require(daemon["device"] == "cuda" and daemon["n_ops"] == 256 and
                daemon["read_agg_batches"] >= 1,
                f"ec_daemon_path: {daemon}")

    breakdown = write_breakdown(be, rng, 16, 512)
    print(f"[{card}] object path breakdown (host seconds per op, "
          f"synchronised): " + json.dumps(breakdown))

    # -- the kernel alone at the object path's widths ---------------------
    # (device times from a torch.profiler trace: back-to-back launches of
    # a small batch are host-bound, so CUDA events around them time the
    # host)
    from ceph_tpu_torch.bench.gf_kernel_bench import device_ms
    bm, plan = ec._encode_kernel.bitmatrix, ec._encode_kernel.plan
    widths = {}
    for b in (stripes, 1):
        x = random_bytes((b, K, OBJ_C), SEED + 6 + b)
        nbytes, ops = roofline.gf_encode_work(b, K, M, OBJ_C)
        bound_s, bound_by = roofline.bound_seconds(nbytes, ops, spec)
        widths[f"{b}x{K}x{OBJ_C}"] = {
            "planned_kernel_device_ms": device_ms(
                lambda: kernels.encode_batch_planned(plan, x), 200),
            "planned_back_to_back_events_ms": events_ms(
                lambda: kernels.encode_batch_planned(plan, x), 50),
            "kernel_device_ms": device_ms(
                lambda: kernels.gf_encode(bm, x), 200),
            "back_to_back_events_ms": events_ms(
                lambda: kernels.gf_encode(bm, x), 50),
            "plain_ms": events_ms(lambda: kernels.gf_encode_plain(bm, x),
                                  5),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": nbytes}
    gib = 1 << 30
    record = {
        "card": card,
        "profile": f"plugin=jax k={K} m={M} technique=reed_sol_van",
        "objects": OBJ_COUNT, "object_bytes": OBJ_SIZE,
        "chunk_size": OBJ_C, "stripes_per_object": stripes,
        "resident_budget": budget,
        "host_s": host_s,
        "write_GiBs": OBJ_COUNT * OBJ_SIZE / host_s["write"] / gib,
        "rmw_4k_ops_per_s": RMW_OPS / host_s["rmw"],
        "rmw_4k_straddling": int(straddle),
        "rmw_100k_ops_per_s": RMW_BIG_OPS / host_s["rmw_100k"],
        "read_cold_GiBs": OBJ_COUNT * OBJ_SIZE / host_s["read_cold"] / gib,
        "read_resident_GiBs": RESIDENT_OBJS * OBJ_SIZE /
        host_s["read_resident"] / gib,
        "recovery_rebuilt_GiBs": OBJ_COUNT * len(lost) * stripes * OBJ_C /
        host_s["recover"] / gib,
        "recovery_objects_per_s": OBJ_COUNT / host_s["recover"],
        "scrub_s_per_object": {
            "corrupt": host_s["scrub_corrupt"] / SCRUB_OBJS,
            "clean": host_s["scrub_clean"] / SCRUB_OBJS},
        "native_stripes_checked": NATIVE_STRIPES,
        "gf_encode": {"launches_object_path": obj_launches,
                      "launches_ec_daemon_path": daemon_launches,
                      "by_operation": log.launches,
                      "cuda_event_ms_by_operation": log.ms,
                      "shapes_by_operation": log.shapes,
                      "checked_against_plain": log.checked,
                      "max_abs_err": log.worst,
                      "widths": widths},
        "residency": be.resident.dump(),
        "ec_backend": {k: be.perf.dump()[k] for k in (
            "write_bytes", "rmw_stripes", "encode_stripes",
            "recover_chunks", "scrub_errors")},
        "layered": layered,
        "breakdown": breakdown,
        "phase_s": time.perf_counter() - t_phase,
    }
    require(log.launches.get("write") == OBJ_COUNT,
            f"write: {log.launches.get('write')} launches")
    require(sum(v for k, v in log.launches.items()
                if k != "ec_daemon_path") == obj_launches and
            log.launches.get("ec_daemon_path") == daemon_launches,
            f"launch counts {log.launches} vs {obj_launches}, "
            f"{daemon_launches}")
    print("ec_object_path: " + json.dumps(record))
    return ({"ec_object_path": obj_launches,
             "ec_daemon_path": daemon_launches}, log.worst)


_M32 = 0xFFFFFFFF


def _mix32(a: int, b: int, c: int) -> tuple:
    """One crush_hashmix round on Python ints (ref: crush/hash.c)."""
    a = (a - b - c) & _M32
    a ^= c >> 13
    b = (b - c - a) & _M32
    b ^= (a << 8) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 13
    a = (a - b - c) & _M32
    a ^= c >> 12
    b = (b - c - a) & _M32
    b ^= (a << 16) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 5
    a = (a - b - c) & _M32
    a ^= c >> 3
    b = (b - c - a) & _M32
    b ^= (a << 10) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 15
    return a, b, c


def _hash32_3(a: int, b: int, c: int) -> int:
    """crush_hash32_rjenkins1_3 on Python ints."""
    from ceph_tpu_torch.crush.hash import CRUSH_HASH_SEED
    a, b, c = a & _M32, b & _M32, c & _M32
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = 231232, 1232
    a, b, h = _mix32(a, b, h)
    c, x, h = _mix32(c, x, h)
    y, a, h = _mix32(y, a, h)
    b, x, h = _mix32(b, x, h)
    y, c, h = _mix32(y, c, h)
    return h


def _scalar_spec():
    """``mapper_ref`` with its two hot spots served without numpy
    scalars, once per worker process: ``crush_ln`` from a table of all
    65,536 of its values (computed by ``crush_ln`` itself), and ``_h3``
    on Python ints, held equal to ``hash32_3`` on 4,096 random triples
    first. The same rows, ~10x sooner on the 10,240-OSD maps."""
    from ceph_tpu_torch.crush import hash as chash
    from ceph_tpu_torch.crush import ln_table, mapper_ref
    if mapper_ref._h3 is not _hash32_3:
        t = np.random.default_rng(SEED).integers(
            0, 1 << 32, (3, 4096), dtype=np.uint64).astype(np.uint32)
        fast = [_hash32_3(int(a), int(b), int(c)) for a, b, c in t.T]
        require(np.array_equal(np.asarray(fast, dtype=np.uint32),
                               chash.hash32_3(t[0], t[1], t[2])),
                "the scalar checks' hash differs from hash32_3")
        mapper_ref.crush_ln = ln_table.crush_ln(
            np.arange(1 << 16)).astype(np.int64).tolist().__getitem__
        mapper_ref._h3 = _hash32_3
    return mapper_ref


def scalar_rows(job):
    """mapper_ref.do_rule over seeds, padded to numrep (a worker of the
    scalar-check pool)."""
    from ceph_tpu_torch.crush.types import ITEM_NONE
    mapper_ref = _scalar_spec()
    m, rule, xs, numrep, weight, cargs = job
    rows = []
    for x in xs:
        got = mapper_ref.do_rule(m, rule, int(x), numrep, weight,
                                 cargs)[:numrep]
        rows.append(got + [ITEM_NONE] * (numrep - len(got)))
    return rows


def scalar_map(pool, m, rule, xs, numrep, weight=None, cargs=None):
    """mapper_ref over ``xs`` in the process pool -> (N, numrep) int64."""
    xs = [int(x) for x in xs]
    step = -(-len(xs) // 32)
    jobs = [(m, rule, xs[i:i + step], numrep, weight, cargs)
            for i in range(0, len(xs), step)]
    return np.asarray([r for rows in pool.map(scalar_rows, jobs)
                       for r in rows], dtype=np.int64)


def crush_phases(spec, pool) -> dict:
    """The CRUSH placement path on the card (``pool``: the mapper_ref
    worker processes); returns its kernel record."""
    from ceph_tpu_torch.bench import crush_sweep, crushtool
    from ceph_tpu_torch.crush import builder, kernels
    from ceph_tpu_torch.crush.mapper import Mapper
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.osd.types import PGPool, pg_t
    from ceph_tpu_torch.utils import roofline

    variants = ("uniform", "mixed_weight", "choose_args")
    maps = {v: crush_sweep.VARIANTS[v][0](10240) for v in variants}
    xs = torch.arange(CRUSH_N, dtype=torch.int64, device="cuda")
    mappers = {v: Mapper(maps[v], choose_args=crush_sweep.VARIANTS[v][1],
                         device="cuda") for v in variants}
    # -- 6. the main path --------------------------------------------------
    torch.cuda.synchronize()
    kernels.crush_straw2.launches = 0
    outs, paths = {}, {}
    for v in variants:
        outs[v], paths[v] = mappers[v].map_pgs_path(0, xs, 3)
    torch.cuda.synchronize()
    launches = kernels.crush_straw2.launches
    for v in variants:
        mp = mappers[v]
        require(paths[v] == mp.mapping_path(0, 3) == mp.last_map_path
                == "kernel", f"{v}: engine {paths[v]}, not kernel")
    require(launches == len(variants),
            f"crush_straw2 launched {launches} times, want "
            f"{len(variants)} (one 2^21-lane block per map)")
    print(f"crush main path: map_pgs of {CRUSH_N} PGs on "
          f"{', '.join(variants)}; crush_straw2 launches {launches}; "
          f"flagged lanes "
          f"{ {v: mappers[v].flagged_lanes for v in variants} }")

    # -- 7. checks ---------------------------------------------------------
    xs32 = xs.to(torch.int32)
    sample = np.linspace(0, CRUSH_N - 1, CRUSH_SAMPLE).astype(np.int64)
    worst = 0
    for v in variants:
        pt = mappers[v].kernel_plan(0)
        got, bad = kernels.crush_straw2(pt, xs32, 3)
        plain, plain_bad = kernels.crush_straw2_plain(pt, xs32, 3)
        torch.cuda.synchronize()
        diff = int((got.long() - plain.long()).abs().max())
        worst = max(worst, diff)
        require(diff == 0 and torch.equal(bad, plain_bad),
                f"{v}: kernel differs from its plain version on "
                f"{int((got != plain).any(dim=1).sum())} lanes")
        cargs = maps[v].choose_args.get(crush_sweep.VARIANTS[v][1])
        want = scalar_map(pool, maps[v], 0, sample, 3, cargs=cargs)
        require(np.array_equal(
            outs[v][torch.as_tensor(sample)].cpu().numpy(), want),
                f"{v}: map_pgs differs from mapper_ref")
        print(f"crush checks: {v}: all {CRUSH_N} lanes equal the plain "
              f"version (bad lanes {int(bad.sum())}); {CRUSH_SAMPLE} "
              f"PGs equal mapper_ref")

    # -- 8. the fallback -----------------------------------------------------
    small, root = builder.build_hierarchy(4, 2)
    builder.add_simple_rule(small, root, builder.TYPE_HOST)
    weight = [0x10000, 0x1000, 0x2000, 0x800, 0x10000, 0x100, 0x3000,
              0x10000]
    mp = Mapper(small, np.asarray(weight), device="cuda")
    few = np.arange(4096)
    got = mp.map_pgs(0, few, 4).cpu().numpy()
    require(mp.mapping_path(0, 4) == "kernel", "fallback map not kernel")
    require(mp.flagged_lanes > 0, "no lane was flagged")
    require(np.array_equal(got, scalar_map(pool, small, 0, few, 4,
                                           weight)),
            "recomputed lanes differ from mapper_ref")
    print(f"crush fallback: {mp.flagged_lanes} of {len(few)} lanes "
          f"flagged and recomputed by the VM; all equal mapper_ref")

    # -- 9. placement --------------------------------------------------------
    om = OSDMap(crush_sweep.canonical_map(10240), device="cuda")
    om.add_pool(PGPool(id=1, pg_num=PG_NUM, size=3, crush_rule=0))
    om.mark_down(17)
    om.mark_down(4242)
    om.mark_out(99)
    om.mark_out(7000)
    om.pg_upmap_items[pg_t(1, 12345)] = [(0, 1)]
    seeds = np.arange(PG_NUM, dtype=np.uint32)
    t0 = time.perf_counter()
    up, upp, acting, actp = om.pg_to_up_acting_osds(1, seeds)
    place_s = time.perf_counter() - t0
    require(up.shape == (PG_NUM, 3) and not np.isin(
        up, [17, 4242, 99, 7000]).any(), "down/out OSDs were placed")
    pool_ = om.pools[1]
    pick = np.unique(np.concatenate([
        np.linspace(0, PG_NUM - 1, 1023).astype(np.int64), [12345]]))
    pps = pool_.raw_pg_to_pps(seeds[pick])
    raw = scalar_map(pool, om.crush, 0, pps, 3,
                     om._device_weights().tolist()).astype(np.int32)
    want = om._pipeline_from_crush(pool_, seeds[pick], raw, pps)
    for a, b in zip((up, upp, acting, actp), want):
        require(np.array_equal(a[pick], b),
                "pg_to_up_acting_osds differs from the scalar pipeline")
    print(f"placement: {PG_NUM} PGs up/acting in {place_s:.3f} s "
          f"(host clock); {len(pick)} equal mapper_ref + pipeline")

    # -- 10. times -----------------------------------------------------------
    pt = mappers["uniform"].kernel_plan(0)
    ms = events_ms(lambda: kernels.crush_straw2(pt, xs32, 3), 10)
    plain_ms = events_ms(lambda: kernels.crush_straw2_plain(pt, xs32, 3), 1)
    plan = pt.plan
    table_bytes = sum(t.numel() * t.element_size() for t in (
        pt.row_start, pt.row_size, pt.slot_id, pt.slot_next, pt.slot_w,
        pt.devw, pt.ln_tables))
    nbytes, ops = roofline.crush_straw2_work(
        [lv[0] for lv in plan.level_sizes], CRUSH_N, 3,
        3 + kernels.SPEC_EXTRA, table_bytes)
    bound_s, bound_by = roofline.bound_seconds(nbytes, ops, spec,
                                               spec.int32_ops_per_s)
    rates = crush_sweep.sweep_rate_variants(10240, CRUSH_N, 3,
                                            device="cuda",
                                            variants=variants)
    # an EC pool's indep rule maps on the rule VM: its row is the VM row
    vm_map = crush_sweep.canonical_map(64)
    vm_rule = builder.add_simple_rule(vm_map, vm_map.rules[0].steps[0].arg1,
                                      builder.TYPE_HOST, indep=True)
    t0 = time.perf_counter()
    rates["indep_vm"] = crush_sweep.sweep_rate(
        Mapper(vm_map, block=1024, device="cuda"), 2048, 3, rule=vm_rule)
    vm_row_s = time.perf_counter() - t0
    plan_keys = ("fetches_per_sweep", "fetch_amortization",
                 "candidate_batched", "kernel_lanes", "candidate_fold")
    for v, r in rates.items():
        if r["path"] == "kernel":
            require(all(k in r for k in plan_keys)
                    and r["kernel_lanes"] == kernels.THREADS == 128,
                    f"{v}: a kernel sweep row lacks the plan keys: {r}")
        else:
            require(r["path"] == "vm" and not any(k in r for k in plan_keys),
                    f"{v}: a {r['path']} sweep row, or plan keys on it: {r}")
    require(rates["indep_vm"]["path"] == "vm", "the indep row is not vm")
    tool = crushtool.main(["--build", "--num-osds", "10240", "--hosts",
                           "640", "--racks", "20", "--test", "--num-rep",
                           "3", "--min-x", "0", "--max-x", "1048575",
                           "--show-statistics"])
    require(tool["path"] == "kernel" and tool["bad_mappings"] == 0,
            f"crushtool ran on {tool['path']} with "
            f"{tool['bad_mappings']} bad mappings")
    print("crush timings: " + json.dumps({
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": bound_by, "ops": ops, "bytes": nbytes,
        "int32_ops_per_s": spec.int32_ops_per_s,
        "kernel_mappings_per_s": CRUSH_N / (ms / 1e3),
        "sweep": {v: {k: r[k] for k in ("mappings_per_s", "n_pgs",
                                        "seconds_hi", "path",
                                        "flagged_lanes", *plan_keys)
                      if k in r}
                  for v, r in rates.items()},
        "indep_vm_row_s": vm_row_s,
        "crushtool": {k: tool[k] for k in ("total_x", "seconds",
                                           "mappings_per_second",
                                           "bad_mappings", "path")}}))
    return {
        "name": "crush_straw2",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_straw2.cu",
        "replaces": "ceph_tpu/crush/pallas_mapper.py:1211",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
    }


class LaunchLog:
    """A checking hook around ``kernels.crush_straw2``: every launch is
    timed with CUDA events and, once ``drain`` runs, held against
    ``crush_straw2_plain`` on the same plan and lanes (after the timed
    windows, so the check costs the updates nothing). Launches made while
    ``main`` is set belong to the main path."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.real = kernels.crush_straw2
        self.main = False
        # osdmaptool's maps have a 2,560-slot root level, which makes the
        # plain version ~40x dearer per lane: with ``sample`` set, the
        # first launch is checked on every lane, the later ones on every
        # 16th
        self.sample = False
        self.full_done = False
        self.pending = []
        self.main_lanes, self.main_ms, self.checked = [], 0.0, 0
        self.other = {}         # drain label -> [(lanes, ms)] off the path
        self.worst = 0

    def __enter__(self):
        self.kernels.crush_straw2 = self.launch
        return self

    def __exit__(self, *exc):
        self.kernels.crush_straw2 = self.real

    def launch(self, pt, xs, numrep):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        leaves, bad = self.real(pt, xs, numrep)
        end.record()
        self.pending.append((pt, xs.clone(), numrep, leaves.clone(),
                             bad.clone(), start, end, self.main))
        return leaves, bad

    def drain(self, what: str) -> None:
        """Check every pending launch against the plain version."""
        for pt, xs, numrep, leaves, bad, start, end, main in self.pending:
            end.synchronize()
            if main:
                self.main_lanes.append(int(xs.shape[0]))
                self.main_ms += start.elapsed_time(end)
            else:
                self.other.setdefault(what, []).append(
                    (int(xs.shape[0]), start.elapsed_time(end)))
            lanes = slice(None)
            if self.sample and self.full_done:
                lanes = slice(None, None, 16)
            self.full_done |= self.sample
            width = max(lv[1] for lv in pt.plan.level_sizes)
            chunk = min(1 << 16, max(1024, (1 << 27) //
                                     (width * (numrep + 2))))
            plain, plain_bad = self.kernels.crush_straw2_plain(
                pt, xs[lanes].contiguous(), numrep, chunk=chunk)
            diff = int((leaves[lanes].long() - plain.long()).abs().max()) \
                if plain.numel() else 0
            self.worst = max(self.worst, diff)
            require(diff == 0 and torch.equal(bad[lanes], plain_bad),
                    f"{what}: a crush_straw2 launch of {xs.shape[0]} lanes "
                    f"differs from its plain version")
            self.checked += 1
        self.pending.clear()


def scratch_rows(om, pid, rows):
    """The five tables' ``rows`` of pool ``pid``, swept from scratch."""
    p = om.pools[pid]
    seeds = np.asarray(rows, dtype=np.uint32)
    craw, pps = om.pg_to_crush_osds(pid, seeds)
    return (craw, *om._pipeline_from_crush(p, seeds, craw, pps))


def table_rows_vs_scratch(om, mm, pid, rows, what) -> int:
    """Require the table's ``rows`` of pool ``pid`` to equal a
    from-scratch sweep on ``om``; returns how many rows were checked."""
    rows = np.unique(np.asarray(rows, dtype=np.int64))
    t = mm._pools[pid]
    for name, want in zip(TABLES, scratch_rows(om, pid, rows)):
        require(np.array_equal(getattr(t, name)[rows], want),
                f"{what}: pool {pid} {name} differs from a from-scratch "
                f"sweep")
    return len(rows)


def touched_rows(old: dict, t, osds, named, rng) -> np.ndarray:
    """The rows an epoch update had to touch (any table changed, or the
    old or new CRUSH output names one of ``osds``), the ``named`` seeds
    and EPOCH_SAMPLE sampled rows."""
    moved = np.zeros(len(t.craw), dtype=bool)
    for n in TABLES:
        a, b = old[n], getattr(t, n)
        moved |= (a != b) if a.ndim == 1 else (a != b).any(axis=1)
    if osds:
        ol = np.asarray(sorted(osds))
        moved |= np.isin(old["craw"], ol).any(axis=1)
        moved |= np.isin(t.craw, ol).any(axis=1)
    return np.concatenate([np.flatnonzero(moved), named, rng.choice(
        len(t.craw), EPOCH_SAMPLE, replace=False)])


def _kind_parts(kind: str) -> tuple[str, str, bool]:
    """'pg_temp2_rm' -> ('pg_temp', '2', True): the change, which victim
    or pool it names (pool 2 for '2'), and whether it clears one."""
    rm = kind.endswith("_rm")
    name = kind[:-3] if rm else kind
    tag = name[-1] if name[-1] in "23" else ""
    return name.rstrip("23"), tag, rm


def _epoch_incremental(kind, om, mm, rng, st):
    """The Incremental of one EPOCH_KINDS step, from the seeded rng and
    the live table (``st`` carries the victims and overrides between
    steps)."""
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.crush.types import (WEIGHT_ONE,
                                            crush_map_from_state,
                                            crush_map_state)
    from ceph_tpu_torch.osd.osdmap import Incremental
    from ceph_tpu_torch.osd.types import pg_t

    inc = Incremental(epoch=om.epoch + 1)
    base, tag, rm = _kind_parts(kind)
    pid = 2 if tag == "2" else 1

    def fresh_osd():
        while True:
            o = int(rng.integers(0, om.max_osd))
            if o not in st.values():
                return o
    if base == "down":
        st["v" + tag] = fresh_osd()
        inc.new_down.append(st["v" + tag])
    elif base == "up":
        inc.new_up.append(st["v" + tag])
    elif base == "out":
        inc.new_weight[st["v" + tag]] = 0
    elif base == "in":
        inc.new_weight[st["v" + tag]] = WEIGHT_ONE
    elif base == "reweight":
        st["r"] = fresh_osd()
        inc.new_weight[st["r"]] = WEIGHT_ONE // 3
    elif base == "reweight_in":
        inc.new_weight[st["r"]] = WEIGHT_ONE
    elif base == "reweight_half":
        inc.new_weight[fresh_osd()] = WEIGHT_ONE // 2
    elif base == "affinity":
        if not rm:
            st["a"] = fresh_osd()
        inc.new_primary_affinity[st["a"]] = 0x10000 if rm else 0
    elif base == "pg_temp":
        pg = pg_t(pid, 7 + pid)
        inc.new_pg_temp[pg] = [] if rm else [
            int(o) for o in rng.choice(om.max_osd, om.pools[pid].size,
                                       replace=False)]
    elif base == "primary_temp":
        pg = pg_t(1, 2024)
        inc.new_primary_temp[pg] = -1 if rm else \
            int(mm._pools[1].up[2024][-1])
    elif base == "upmap":
        pg = pg_t(pid, 123 + pid)
        if rm:
            inc.old_pg_upmap_items.append(pg)
        else:
            inc.new_pg_upmap_items[pg] = [
                (int(mm._pools[pid].up[pg.seed][0]), fresh_osd())]
    elif base == "crush":
        edited = crush_map_from_state(crush_map_state(om.crush))
        st["c"] = fresh_osd()
        builder.adjust_item_weight(edited, st["c"], 2 * WEIGHT_ONE)
        inc.new_crush = edited
    else:
        raise ValueError(kind)
    return inc


def epoch_breakdown(om, mm, log, rng) -> dict:
    """The parts of an epoch update timed apart on the live map: the
    reweight's Mapper refresh and plan rebuild, the ragged re-run of a
    decrease on each engine, the post-CRUSH pipeline over those rows and
    over a whole pool, the VM over the whole k=8 m=3 pool, and the crush
    digest. Launches here are off the main path (checked, not counted)."""
    from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping

    def host(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    mp = om.serving_mapper(1)
    _, refresh_s = host(lambda: mp.set_device_weights(om._device_weights()))
    _, plan_s = host(lambda: mp.kernel_plan(0))
    out = {"mapper_refresh_s": refresh_s, "plan_build_s": plan_s}
    osd = int(rng.integers(0, om.max_osd))
    for pid, p in om.pools.items():
        t = mm._pools[pid]
        rows = np.flatnonzero((t.craw == osd).any(axis=1))
        seeds = rows.astype(np.uint32)
        n_other = len(log.other.get("breakdown", []))
        (craw, pps), crush_s = host(lambda: om.pg_to_crush_osds(pid, seeds))
        _, pipe_s = host(lambda: om._pipeline_from_crush(p, seeds, craw,
                                                         pps))
        every = np.arange(p.pg_num, dtype=np.uint32)
        _, full_pipe_s = host(lambda: om._pipeline_from_crush(
            p, every, t.craw, t.pps))
        rec = {"rows": len(rows), "crush_s": crush_s, "pipeline_s": pipe_s,
               "full_pipeline_s": full_pipe_s,
               "engine": mp.mapping_path(p.crush_rule, p.size)}
        if rec["engine"] == "vm":
            _, rec["full_vm_s"] = host(lambda: om.pg_to_crush_osds(pid,
                                                                   every))
        log.drain("breakdown")
        rec["kernel_ms"] = sum(ms for _, ms in
                               log.other["breakdown"][n_other:]) \
            if rec["engine"] == "kernel" else None
        out[f"pool{pid}"] = rec
    _, out["crush_digest_s"] = host(lambda: OSDMapMapping._digest(om))
    return out


def placement_epochs_phase(card: str, pool) -> int:
    """Placement across epochs on the card (phases 17-21): the
    OSDMapMapping table kept by delta remap over a seeded incremental
    stream, the lookup memo, osdmaptool and crushtool. Returns the
    crush_straw2 launches of the main path; any failed check raises."""
    import os
    import tempfile

    from ceph_tpu_torch.bench import crush_sweep, crushtool, osdmaptool
    from ceph_tpu_torch.crush import builder, kernels
    from ceph_tpu_torch.encoding import encode_crush_map
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
    from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
    from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool
    from ceph_tpu_torch.utils.devmon import DeviceRuntimeMonitor, devmon

    crush = crush_sweep.canonical_map(10240)
    ec_rule = builder.add_simple_rule(crush, crush.rules[0].steps[0].arg1,
                                      builder.TYPE_HOST, indep=True)
    om = OSDMap(crush, device="cuda")
    om.add_pool(PGPool(id=1, pg_num=PG_NUM, size=3, crush_rule=0,
                       name="rbd"))
    om.add_pool(PGPool(id=2, pg_num=EC_PG_NUM, size=K + M, min_size=K + 1,
                       type=POOL_TYPE_ERASURE, crush_rule=ec_rule,
                       erasure_code_profile=f"k={K} m={M}", name="ec"))
    shards = sum(p.pg_num * p.size for p in om.pools.values()) / om.max_osd
    dm = DeviceRuntimeMonitor(name="placement_epochs_devmon", register=False)
    rng = np.random.default_rng(SEED + 4)
    t_phase = time.perf_counter()

    with LaunchLog(kernels) as log:
        # -- 17. build ---------------------------------------------------
        torch.cuda.synchronize()
        log.main, log.real.launches = True, 0
        t0 = time.perf_counter()
        mm = OSDMapMapping(om, devmon=dm)
        build_s = time.perf_counter() - t0
        log.main = False
        main_launches = log.real.launches
        om.attach_mapping(mm)
        log.drain("build")
        require(main_launches == 1 and mm.last_full_sweep_pools == 2,
                f"build: {main_launches} launches, "
                f"{mm.last_full_sweep_pools} pools swept")
        print(f"[{card}] placement epochs: build of {PG_NUM} + {EC_PG_NUM}"
              f" PGs ({shards:.1f} PG shards per OSD) in {build_s:.3f} s "
              f"(host clock, first use included); engines "
              f"{om.pg_to_crush_osds_path(1, [0])[2][1]} and "
              f"{om.pg_to_crush_osds_path(2, [0])[2][1]}")
        log.drain("engines")

        # -- 18. the stream ------------------------------------------------
        st, per_kind = {}, {}
        n_full = 0
        full_at = {0, len(EPOCH_KINDS) // 2, len(EPOCH_KINDS) - 1}
        for i, kind in enumerate(EPOCH_KINDS):
            inc = _epoch_incremental(kind, om, mm, rng, st)
            old = {pid: {n: getattr(mm._pools[pid], n).copy()
                         for n in TABLES} for pid in om.pools}
            torch.cuda.synchronize()
            log.main, log.real.launches = True, 0
            t0 = time.perf_counter()
            om.apply_incremental(inc)
            mm.update(om)
            dt = time.perf_counter() - t0
            log.main = False
            ep_launches = log.real.launches
            main_launches += ep_launches
            base, _, rm = _kind_parts(kind)
            rec = per_kind.setdefault(base + "_rm" * rm, {
                "seconds": [], "rows_remapped": 0, "full_sweep_pools": 0,
                "launches": 0})
            rec["seconds"].append(dt)
            rec["rows_remapped"] += mm.last_remap_pgs
            rec["full_sweep_pools"] += mm.last_full_sweep_pools
            rec["launches"] += ep_launches
            if base in ("in", "reweight_in", "crush"):
                # both pools' rules take the root: every OSD is reachable
                require(mm.last_full_sweep_pools == len(om.pools),
                        f"epoch {i} {kind}: {mm.last_full_sweep_pools} "
                        f"pools re-swept, want {len(om.pools)}")
            else:
                require(mm.last_full_sweep_pools == 0,
                        f"epoch {i} {kind}: a delta update re-swept "
                        f"{mm.last_full_sweep_pools} pools")
            osds = set(inc.new_up) | set(inc.new_down) | \
                set(inc.new_weight) | set(inc.new_primary_affinity)
            checked = 0
            for pid, pool_ in om.pools.items():
                if mm.last_full_sweep_pools or i in full_at:
                    rows = np.arange(pool_.pg_num)
                else:
                    named = [pg.seed for d in (
                        inc.new_pg_temp, inc.new_primary_temp,
                        inc.new_pg_upmap_items) for pg in d
                        if pg.pool == pid] + [
                        pg.seed for pg in inc.old_pg_upmap_items
                        if pg.pool == pid]
                    rows = touched_rows(old[pid], mm._pools[pid], osds,
                                        named, rng)
                checked += table_rows_vs_scratch(om, mm, pid, rows,
                                                 f"epoch {i} {kind}")
            log.drain(f"epoch {i} {kind}")
            n_full += bool(mm.last_full_sweep_pools)
            print(f"[{card}] epoch {om.epoch} {kind}: update {dt:.4f} s, "
                  f"{mm.last_remap_pgs} rows re-mapped, "
                  f"{mm.last_full_sweep_pools} pools re-swept, "
                  f"{ep_launches} crush_straw2 launches; {checked} rows "
                  f"equal a from-scratch sweep")

        # the last epoch against the scalar spec
        w = om._device_weights().tolist()
        for pid, pool_ in om.pools.items():
            pick = np.linspace(0, pool_.pg_num - 1,
                               SCALAR_SAMPLE).astype(np.int64)
            seeds = pick.astype(np.uint32)
            pps = pool_.raw_pg_to_pps(seeds)
            raw = scalar_map(pool, om.crush, pool_.crush_rule, pps,
                             pool_.size, w).astype(np.int32)
            want = (raw, *om._pipeline_from_crush(pool_, seeds, raw, pps))
            t = mm._pools[pid]
            for name, wv in zip(TABLES, want):
                require(np.array_equal(getattr(t, name)[pick], wv),
                        f"last epoch: pool {pid} {name} differs from "
                        f"mapper_ref + pipeline")
        print(f"[{card}] last epoch: {SCALAR_SAMPLE} PGs per pool equal "
              f"mapper_ref + the post-CRUSH pipeline")
        breakdown = epoch_breakdown(om, mm, log, rng)
        print(f"[{card}] epoch breakdown (host clock, synchronised; "
              f"kernel by CUDA events): " + json.dumps(breakdown))

        # -- 19. the memo --------------------------------------------------
        hits0, misses0 = om.mapping_cache_hits, om.mapping_cache_misses
        log.main, log.real.launches = True, 0
        n_before = len(log.pending)
        for j in range(MEMO_LOOKUPS):
            pid = 1 + j % 2
            seed = int(rng.integers(0, om.pools[pid].pg_num))
            up, upp, act, actp = om.pg_to_up_acting_osds(pid, [seed])
            t = mm._pools[pid]
            require(np.array_equal(up[0], t.up[seed]) and
                    int(actp[0]) == int(t.acting_primary[seed]),
                    f"memo: lookup {pid}.{seed:x} differs from the table")
        log.main = False
        require(om.mapping_cache_hits - hits0 == MEMO_LOOKUPS and
                log.real.launches == 0 and len(log.pending) == n_before,
                f"memo: {om.mapping_cache_hits - hits0} hits, "
                f"{log.real.launches} launches for {MEMO_LOOKUPS} lookups")
        victim = int(mm._pools[1].up[0][0])
        om.apply_incremental(Incremental(epoch=om.epoch + 1,
                                         new_down=[victim]))
        log.main, log.real.launches = True, 0
        got = {pid: [om.pg_to_up_acting_osds(pid, [s]) for s in range(16)]
               for pid in om.pools}
        log.main = False
        memo_launches = log.real.launches
        main_launches += memo_launches
        require(om.mapping_cache_misses - misses0 == 32 and memo_launches
                == 16, f"memo: {om.mapping_cache_misses - misses0} misses, "
                       f"{memo_launches} launches after the incremental")
        for pid in om.pools:
            want = scratch_rows(om, pid, np.arange(16))[1:]   # less craw
            for s in range(16):
                for a, b in zip(got[pid][s], want):
                    require(np.array_equal(np.asarray(a)[0], b[s]),
                            f"memo: miss {pid}.{s} differs from a sweep")
        require(victim not in got[1][0][0][0], "memo: served a stale row")
        log.drain("memo")
        print(f"[{card}] memo: {MEMO_LOOKUPS} lookups from the table at "
              f"the attached epoch with no launch; after one more "
              f"incremental 32 lookups missed ({memo_launches} one-lane "
              f"launches) and equal a fresh sweep")

        # -- 20. health ----------------------------------------------------
        d, proc = dm.perf.dump(), devmon().perf.dump()
        health = {"path_checks": d["path_checks"],
                  "path_mismatch": d["path_mismatch"] +
                  proc["path_mismatch"],
                  "quarantine_entries": proc["quarantine_entries"],
                  "quarantined": [mp.kernel_quarantine_info()
                                  for mp in om._mappers.values()
                                  if mp.kernel_quarantine_info()]}
        require(health["path_checks"] > 0 and not health["path_mismatch"]
                and not health["quarantine_entries"]
                and not health["quarantined"], f"health: {health}")
        epochs_s = time.perf_counter() - t_phase

        # -- 21. osdmaptool and crushtool ------------------------------------
        out_dir = os.path.join("build", "placement_epochs")
        os.makedirs(out_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            f, g = os.path.join(tmp, "osdmap.bin"), os.path.join(tmp, "g.bin")
            log.sample, checked0 = True, log.checked
            tool = osdmaptool.main(["--createsimple", "10240", "--pg-num",
                                    str(PG_NUM), "--test-map-pgs",
                                    "--churn", "4", "--export", f])
            log.drain("osdmaptool --churn")
            back = osdmaptool.main(["--mapfn", f, "--test-map-pgs",
                                    "--export", g])
            again = osdmaptool.main(["--mapfn", g, "--test-map-pgs"])
            log.drain("osdmaptool --mapfn")
            log.sample = False
            tool_checked = log.checked - checked0
            same = {k: back["map_pgs"][k] == again["map_pgs"][k]
                    for k in ("avg", "min", "max", "stddev",
                              "degraded_pgs")}
            with open(f, "rb") as fa, open(g, "rb") as fb:
                require(fa.read() == fb.read(),
                        "osdmaptool: --mapfn --export changed the bytes")
            require(all(same.values()) and tool["churn"]["events"] > 0,
                    f"osdmaptool: distribution after the round trip "
                    f"{back['map_pgs']} vs {again['map_pgs']}")
            c0, c1 = os.path.join(tmp, "c0.bin"), os.path.join(tmp, "c1.bin")
            with open(c0, "wb") as fc:
                fc.write(encode_crush_map(crush_sweep.canonical_map(10240)))
            crushtool.main(["-i", c0, "-o", c1])
            ct = crushtool.main(["-i", c1, "--test", "--num-rep", "3",
                                 "--max-x", "65535"])
            log.drain("crushtool")
            with open(c0, "rb") as fa, open(c1, "rb") as fb:
                require(fa.read() == fb.read(),
                        "crushtool: -i/-o changed the canonical map's bytes")
            require(ct["path"] == "kernel" and ct["bad_mappings"] == 0,
                    f"crushtool -i: {ct['path']}, {ct['bad_mappings']} bad")
        print(f"[{card}] osdmaptool: --createsimple 10240 --pg-num {PG_NUM}"
              f" --test-map-pgs --churn 4 --export, then --mapfn twice: "
              f"distribution and bytes unchanged; crushtool -i/-o: the "
              f"canonical map byte for byte; osdmaptool's {tool_checked} "
              f"launches checked against the plain version (the first on "
              f"every lane, the rest on every 16th)")

    kinds = {}
    for k, rec in per_kind.items():
        secs = sorted(rec.pop("seconds"))
        kinds[k] = {"epochs": len(secs),
                    "update_s_median": secs[len(secs) // 2],
                    "update_s_max": secs[-1], **rec}
    record = {
        "card": card, "osds": om.max_osd,
        "pools": {pid: {"pg_num": p.pg_num, "size": p.size,
                        "engine": om.serving_mapper(pid).mapping_path(
                            p.crush_rule, p.size)}
                  for pid, p in om.pools.items()},
        "pg_shards_per_osd": shards,
        "build_s": build_s,
        "epochs": len(EPOCH_KINDS), "full_sweep_epochs": n_full,
        "by_kind": kinds,
        "kernel": {"launches": main_launches,
                   "lanes": log.main_lanes,
                   "cuda_event_ms": log.main_ms,
                   "checked_against_plain": log.checked,
                   "max_abs_err": log.worst},
        "mapping_cache_hits": om.mapping_cache_hits,
        "mapping_cache_misses": om.mapping_cache_misses,
        "health": health,
        "phase_s_to_health": epochs_s,
        "phase_s": time.perf_counter() - t_phase,
        "breakdown": breakdown,
        "osdmaptool": {"map_pgs": tool["map_pgs"], "churn": tool["churn"],
                       "mapfn_map_pgs": back["map_pgs"],
                       "kernel_lanes_ms": log.other.get(
                           "osdmaptool --churn", [])},
    }
    print("placement_epochs: " + json.dumps(record))
    return main_launches


# -- the monitor quorum: three mons in a process of their own --------------
#
# ``ceph-mon`` is a process of its own. A full-sweep table update holds the
# client's event loop for about a second on the card, which would starve
# the mons' leases if they shared it, so the smoke spawns the three mons
# into one process and talks to it over a pipe: it reports elections,
# commits, wire bytes and its own crush_straw2 launches (the leader's
# ``osd map``), each held against the plain version by the same hook.

MON_NAMES = ("a", "b", "c")
MON_BALANCER = 32                      # concurrent pg-upmap-items (from 64)
# `osd map` names, half per pool; cut from 256 (23 s) for time
MON_OBJECTS = 64
# the stream of map changes, each through the mon as a user would send it
# (``osd ...`` commands, an MOSDBoot for an up); the leader is stopped
# before MON_FAILOVER_AT. pg_temp and primary_temp have no command in the
# reference mon, so the stream has none.
# The affinity is restored before the failover: a tuner's lease lives in
# the leader's memory, so a new leader heals a leased affinity back to
# 1.0 on its first sweep, an epoch no command asked for.
MON_KINDS = ("down", "out", "affinity", "upmap", "reweight", "down2",
             "boot2", "upmap2", "affinity_rm", "crush", "in", "upmap_rm",
             "boot", "reweight_in", "upmap2_rm", "down3", "out3",
             "reweight_half")
MON_FAILOVER_AT = len(MON_KINDS) // 2 + 1       # before "in"
MON_FULL_SWEEP = {"crush", "in", "reweight_in"}
TUNER = {"policy": "chip_smoke", "mode": "drive", "action": "act"}


def mon_server(conn, dirs) -> None:
    """Entry point of the mon process: three ``Monitor``s on their seeded
    ``WALDB`` stores, driven by requests on ``conn`` until "shutdown"."""
    import traceback
    try:
        asyncio.run(_mon_server(conn, dirs))
    except Exception:
        conn.send(("error", traceback.format_exc()))


async def _mon_server(conn, dirs) -> None:
    from ceph_tpu_torch.crush import kernels
    from ceph_tpu_torch.mon import Monitor, MonitorDBStore, MonMap
    from ceph_tpu_torch.utils import device as devsel
    from ceph_tpu_torch.utils.config import OPTIONS
    from ceph_tpu_torch.utils.devmon import devmon

    # the process takes its device before the mons start, as a daemon
    # does at boot: the context's creation would otherwise hold the
    # leader's loop past the peons' lease at the first `osd map`
    torch.zeros(1, device=devsel.resolve())
    # the registry's timers (Monitor falls back to the same values)
    config = {k: OPTIONS[k].default
              for k in ("mon_election_timeout", "mon_lease")}
    monmap = MonMap()
    for rank, name in enumerate(MON_NAMES):
        monmap.add(name, rank, "127.0.0.1", 0)
    mons, stores, wins, commits = [], [], [], {}
    timeouts = PaxosTimeouts()

    def watch(mon):
        win, apply = mon.win_election, mon.apply_paxos_value

        async def counted_win(epoch, quorum):
            wins.append((time.monotonic(), mon.name, list(quorum), epoch))
            await win(epoch, quorum)

        def stamped_apply(version, value):
            commits.setdefault(mon.name, []).append(time.monotonic())
            apply(version, value)
        mon.win_election, mon.apply_paxos_value = counted_win, stamped_apply

    with LaunchLog(kernels) as log:
        log.main = True                # the leader's `osd map`
        for rank, (name, path) in enumerate(zip(MON_NAMES, dirs)):
            store = MonitorDBStore(path=path)
            mon = Monitor(name, monmap, store=store, config=dict(config))
            addr = await mon.msgr.bind("127.0.0.1", 0)
            monmap.mons[name] = (rank, addr.host, addr.port)
            watch(mon)
            mons.append(mon)
            stores.append(store)
        for mon in mons:
            mon._tick_task = asyncio.ensure_future(mon._tick_loop())
            mon.start_mgr_reporting()
        await asyncio.gather(*(mon.elector.start() for mon in mons))
        conn.send(("ready", monmap.encode()))

        checks = {"s": 0.0, "max_s": 0.0}

        async def drain() -> None:
            # one launch's plain check at a time, yielding between them:
            # the three mons share this loop, and 128 checks in one go
            # can hold it past the peons' 1 s lease
            pending, log.pending = log.pending, []
            for item in pending:
                t0 = time.perf_counter()
                log.pending = [item]
                log.drain("mon osd map")
                dt = time.perf_counter() - t0
                checks["s"] += dt
                checks["max_s"] = max(checks["max_s"], dt)
                await asyncio.sleep(0)

        def stats() -> dict:
            live = [m for m in mons if not m._stopped]
            leader = next((m for m in live if m.is_leader()), None)
            wire = {}
            for m in mons:
                for k, v in m.msgr.wire.items():
                    wire[k] = wire.get(k, 0) + v
            return {
                "leader": leader.name if leader else None,
                "quorum": leader.quorum if leader else [],
                "active": bool(leader and leader.paxos.active),
                "elections": wins,
                "paxos_timeouts": timeouts.n,
                "last_committed": {m.name: m.paxos.last_committed
                                   for m in live},
                "paxos_commits": {m.name: m.perf.dump()["paxos_commits"]
                                  for m in mons},
                "commit_times": commits,
                "wire": wire,
                "launches": log.real.launches,
                "lanes": sum(log.main_lanes),
                "cuda_event_ms": log.main_ms,
                "checked": log.checked,
                "max_abs_err": log.worst,
                "h2d_bytes": devmon().perf.dump()["h2d_bytes"],
                "check_s": dict(checks),
            }

        while True:
            if not conn.poll():
                await asyncio.sleep(0.005)
                continue
            op = conn.recv()
            if op == "stats":
                await drain()
                conn.send(("stats", stats()))
            elif op == "stop_leader":
                leader = next(m for m in mons if m.is_leader())
                t_stop = time.monotonic()
                await leader.stop()
                conn.send(("stopped", leader.name, t_stop))
            elif op == "getmap":
                out = {}
                for m in mons:
                    if not m._stopped:
                        _, _, out[m.name] = await m.handle_command(
                            {"prefix": "osd getmap"})
                conn.send(("getmap", out))
            elif op == "shutdown":
                for m in mons:
                    if not m._stopped:
                        await m.stop()
                for s in stores:
                    s.close()
                conn.send(("bye",))
                return


class MonProcess:
    """The parent's end of the mon process: spawn, request, stop."""

    def __init__(self, dirs):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=mon_server, args=(child, dirs),
                                daemon=True)
        self.proc.start()

    async def reply(self, timeout: float = 120.0):
        t0 = time.monotonic()
        while not self.conn.poll():
            require(self.proc.is_alive() or self.conn.poll(),
                    "mon_path: the mon process died")
            require(time.monotonic() - t0 < timeout,
                    "mon_path: the mon process did not answer")
            await asyncio.sleep(0.005)
        msg = self.conn.recv()
        require(msg[0] != "error", f"mon_path: the mon process failed:\n"
                                   f"{msg[-1]}")
        return msg

    async def ask(self, op: str, timeout: float = 120.0):
        self.conn.send(op)
        return await self.reply(timeout)

    def close(self) -> None:
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)


def seed_mon_stores(dirs, osdmap) -> None:
    """``ceph-mon --mkfs --osdmap``: epoch 1 of ``osdmap`` written into
    each mon's store before start."""
    from ceph_tpu_torch.encoding import encode_osdmap
    from ceph_tpu_torch.mon import MonitorDBStore
    osdmap.epoch = 1
    blob = encode_osdmap(osdmap)
    for path in dirs:
        store = MonitorDBStore(path=path)
        t = store.transaction()
        t.set("osdmap", f"full_{1:08x}", blob)
        store.put_u64(t, "osdmap", "last_epoch", 1)
        store.apply(t)
        store.close()


def mon_path_phase(card: str, pool) -> tuple[int, int]:
    """The monitor quorum on the card (phases 35-40): three mons commit
    map changes on the 10,240-OSD map and a tracked ``MonClient`` keeps
    its placement table on the card. Returns the crush_straw2 launches of
    the path (the client's table and the leader's ``osd map``) and the
    largest difference of any launch from the plain version."""
    import os
    import tempfile

    from ceph_tpu_torch.bench import crush_sweep
    from ceph_tpu_torch.crush import builder, kernels
    from ceph_tpu_torch.crush.types import ITEM_NONE, WEIGHT_ONE
    from ceph_tpu_torch.encoding import (decode_crush_map, encode_crush_map,
                                         encode_osdmap)
    from ceph_tpu_torch.mon import MonClient, MonMap
    from ceph_tpu_torch.mon.messages import MOSDBoot
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.osd.types import (POOL_TYPE_ERASURE, ObjectLocator,
                                          PGPool, pg_t)
    from ceph_tpu_torch.utils.devmon import DeviceRuntimeMonitor

    crush = crush_sweep.canonical_map(10240)
    ec_rule = builder.add_simple_rule(crush, crush.rules[0].steps[0].arg1,
                                      builder.TYPE_HOST, indep=True)
    seed_map = OSDMap(crush, device="cpu")         # only encoded
    seed_map.add_pool(PGPool(id=1, pg_num=PG_NUM, size=3, crush_rule=0,
                             name="rbd"))
    seed_map.add_pool(PGPool(id=2, pg_num=EC_PG_NUM, size=K + M,
                             min_size=K + 1, type=POOL_TYPE_ERASURE,
                             crush_rule=ec_rule,
                             erasure_code_profile=f"k={K} m={M}",
                             name="ec"))
    rng = np.random.default_rng(SEED + 9)
    dm = DeviceRuntimeMonitor(name="mon_path_devmon", register=False)
    out_dir = os.path.join("build", "mon_path")
    os.makedirs(out_dir, exist_ok=True)
    t_phase = time.perf_counter()

    async def drive(tmp, log):
        dirs = [os.path.join(tmp, f"mon.{n}") for n in MON_NAMES]
        seed_mon_stores(dirs, seed_map)
        mp = MonProcess(dirs)
        try:
            _, mm_blob = await mp.reply(timeout=300.0)
            t0 = time.monotonic()
            while True:
                s = (await mp.ask("stats"))[1]
                if s["active"] and len(s["quorum"]) == len(MON_NAMES):
                    break
                require(time.monotonic() - t0 < 60, f"mon_path: no quorum "
                                                    f"of three: {s}")
                await asyncio.sleep(0.05)
            rec = {"startup_elections": len(s["elections"]),
                   "quorum_formed_s": time.monotonic() - t0}
            start = {"s": rec["quorum_formed_s"],
                     "elections": rec["startup_elections"],
                     "split_epochs": split_epochs(
                         [(w[1], w[3]) for w in s["elections"]]),
                     **{f"{k}_timeouts": v
                        for k, v in s["paxos_timeouts"].items()}}
            print(f"[{card}] mon_path start: {json.dumps(start)}",
                  flush=True)
            mc = MonClient("client.admin", MonMap.decode(mm_blob))
            try:
                return await run_stream(mp, mc, s, rec, log)
            finally:
                await mc.shutdown()
        finally:
            try:
                await mp.ask("shutdown", timeout=60)
            finally:
                mp.close()

    def track(mc, log) -> list:
        """Keep the client's table on the card and log each map message
        it handles: times, epochs, the table's launches and path."""
        mc.track_mapping = True
        mc.mapping_devmon = dm
        arrivals = []
        orig = mc._handle_osdmap

        async def handled(m):
            # the table's update is the path: its launches are counted
            # here, and nothing else runs while it does (no await)
            before = mc.osdmap.epoch if mc.osdmap is not None else 0
            n0 = log.real.launches
            log.main = True
            t_in = time.monotonic()
            try:
                await orig(m)
            finally:
                log.main = False
            arrivals.append({
                "t_in": t_in, "t_out": time.monotonic(), "before": before,
                "after": mc.osdmap.epoch, "full": sorted(m.full),
                "incs": sorted(m.incrementals),
                "launches": log.real.launches - n0,
                "full_sweep_pools": mc.mapping_table.last_full_sweep_pools})
        mc._handle_osdmap = handled
        return arrivals

    def at(mc, epoch) -> bool:
        return mc.osdmap is not None and mc.osdmap.epoch >= epoch and \
            mc.mapping_table is not None and mc.mapping_table.epoch >= epoch

    async def table_at(mc, arrivals, epoch, what, timeout=120.0):
        t0 = time.monotonic()
        while not at(mc, epoch):
            require(time.monotonic() - t0 < timeout,
                    f"mon_path: {what}: the client's table never reached "
                    f"epoch {epoch}")
            await asyncio.sleep(0.002)
        return next(a for a in arrivals if a["after"] >= epoch)

    async def command(mc, cmd, inbl=b""):
        ret, rs, out = await mc.command(cmd, inbl, timeout=120.0)
        require(ret == 0, f"mon_path: {cmd} -> {ret} {rs}")
        return out

    async def run_stream(mp, mc, s0, rec, log):
        arrivals = track(mc, log)
        # -- 35. build -------------------------------------------------------
        torch.cuda.synchronize()
        log.real.launches = 0
        await mc.subscribe("osdmap", 0)
        build = await table_at(mc, arrivals, 1, "build")
        om, mm = mc.osdmap, mc.mapping_table
        require(build["full_sweep_pools"] == 2 and build["launches"] == 1,
                f"mon_path build: {build['launches']} launches, "
                f"{build['full_sweep_pools']} pools swept")
        require(encode_osdmap(om) == encode_osdmap(seed_map),
                "mon_path: the client's first map is not the seeded one")
        for pid, p in om.pools.items():
            table_rows_vs_scratch(om, mm, pid, np.arange(p.pg_num),
                                  "mon_path build")
        log.drain("mon_path build")
        rec["build_s"] = build["t_out"] - build["t_in"]
        rec["engines"] = {pid: om.serving_mapper(pid).mapping_path(
            p.crush_rule, p.size) for pid, p in om.pools.items()}
        print(f"[{card}] mon_path: quorum of {len(MON_NAMES)} in "
              f"{rec['quorum_formed_s']:.2f} s; the client built "
              f"{PG_NUM} + {EC_PG_NUM} PGs in {rec['build_s']:.3f} s "
              f"(engines {rec['engines']})")

        # -- 36. the stream of map changes -----------------------------------
        st, per_kind, failover = {}, {}, {}

        def fresh_osd():
            while True:
                o = int(rng.integers(0, om.max_osd))
                if o not in st.values():
                    return o
        full_at = {0, MON_FAILOVER_AT - 1, len(MON_KINDS) - 1}
        for i, kind in enumerate(MON_KINDS):
            om, mm = mc.osdmap, mc.mapping_table
            if i == MON_FAILOVER_AT:
                _, name, t_stop = await mp.ask("stop_leader")
                failover = {"stopped": name, "t_stop": t_stop}
            base, tag, rm = _kind_parts(kind)
            pid = 2 if tag == "2" else 1
            old = {p: {n: getattr(mm._pools[p], n).copy() for n in TABLES}
                   for p in om.pools}
            target = om.epoch + 1
            named, osds = [], set()
            t_send = time.monotonic()
            t_ack = None
            if base == "boot":
                # an OSD re-announces its boot until its map says up (a
                # peon forwards to the leader it knows, which may be gone)
                osd = st["v" + tag]
                osds.add(osd)
                while not at(mc, target):
                    require(time.monotonic() - t_send < 120, f"mon_path "
                            f"{kind}: osd.{osd}'s boot never committed")
                    await mc.send_report(MOSDBoot(
                        osd=osd, addr_host="127.0.0.1",
                        addr_port=6800 + osd, hb_port=6900 + osd,
                        boot_epoch=om.epoch))
                    t_wait = time.monotonic()
                    while not at(mc, target) and \
                            time.monotonic() - t_wait < 1.0:
                        await asyncio.sleep(0.002)
            else:
                if base in ("down", "out", "in"):
                    if base == "down":
                        st["v" + tag] = fresh_osd()
                    osd = st["v" + tag]
                    cmd = {"prefix": f"osd {base}", "id": osd}
                elif base.startswith("reweight"):
                    if base == "reweight":
                        st["r"] = osd = fresh_osd()
                        w = 1 / 3
                    elif base == "reweight_in":
                        osd, w = st["r"], 1.0
                    else:
                        osd, w = fresh_osd(), 0.5
                    cmd = {"prefix": "osd reweight", "id": osd,
                           "weight": w}
                elif base == "affinity":
                    if not rm:
                        st["a"] = fresh_osd()
                    osd = st["a"]
                    # a tuner's write (with provenance) holds; an
                    # operator's is healed back by the leader's next
                    # slow-OSD sweep (ROADMAP Queue C)
                    cmd = {"prefix": "osd primary-affinity", "id": osd,
                           "weight": 1.0 if rm else 0.0,
                           "provenance": TUNER}
                elif base == "upmap":
                    seed = 123 + pid
                    named.append((pid, seed))
                    if rm:
                        cmd = {"prefix": "osd rm-pg-upmap-items",
                               "pgid": f"{pid}.{seed:x}"}
                    else:
                        frm = int(mm._pools[pid].up[seed][0])
                        cmd = {"prefix": "osd pg-upmap-items",
                               "pgid": f"{pid}.{seed:x}",
                               "mappings": [frm, fresh_osd()]}
                    osd = None
                elif base == "crush":
                    blob = await command(mc, {"prefix": "osd getcrushmap"})
                    edited = decode_crush_map(blob)
                    st["c"] = osd = fresh_osd()
                    builder.adjust_item_weight(edited, osd, 2 * WEIGHT_ONE)
                    t_send = time.monotonic()
                    cmd = {"prefix": "osd setcrushmap"}
                    inbl = encode_crush_map(edited)
                else:
                    raise ValueError(kind)
                if osd is not None:
                    osds.add(osd)
                await command(mc, cmd, inbl if base == "crush" else b"")
                t_ack = time.monotonic()
            arr = await table_at(mc, arrivals, target, kind)
            om, mm = mc.osdmap, mc.mapping_table
            require(arr["after"] == target and arr["before"] == target - 1,
                    f"mon_path {kind}: the client went from epoch "
                    f"{arr['before']} to {arr['after']}, want {target}")
            want_full = len(om.pools) if kind in MON_FULL_SWEEP else 0
            require(arr["full_sweep_pools"] == want_full,
                    f"mon_path {kind}: {arr['full_sweep_pools']} pools "
                    f"re-swept, want {want_full}")
            checked = 0
            for p, pool_ in om.pools.items():
                rows = np.arange(pool_.pg_num) if want_full or \
                    i in full_at else touched_rows(
                        old[p], mm._pools[p], osds,
                        [s for q, s in named if q == p], rng)
                checked += table_rows_vs_scratch(om, mm, p, rows,
                                                 f"mon_path {kind}")
            log.drain(f"mon_path {kind}")
            key = base + "_rm" * rm
            r = per_kind.setdefault(key, {"to_table_s": [], "commit_s": [],
                                          "update_s": [], "launches": 0,
                                          "full_sweep_pools": 0})
            r["to_table_s"].append(arr["t_out"] - t_send)
            r["commit_s"].append((t_ack if t_ack is not None else
                                  arr["t_in"]) - t_send)
            r["update_s"].append(arr["t_out"] - arr["t_in"])
            r["launches"] += arr["launches"]
            r["full_sweep_pools"] += arr["full_sweep_pools"]
            if i == MON_FAILOVER_AT:
                failover["t_client_epoch"] = arr["t_out"]
            print(f"[{card}] mon_path epoch {target} {kind}: to the table "
                  f"{arr['t_out'] - t_send:.4f} s (update "
                  f"{arr['t_out'] - arr['t_in']:.4f} s), "
                  f"{arr['full_sweep_pools']} pools re-swept, "
                  f"{arr['launches']} launches; {checked} rows equal a "
                  f"from-scratch sweep")
        s1 = (await mp.ask("stats"))[1]
        new_leader = s1["leader"]
        require(new_leader is not None and new_leader != failover["stopped"]
                and len(s1["quorum"]) == len(MON_NAMES) - 1,
                f"mon_path failover: leader {new_leader}, quorum "
                f"{s1['quorum']}")
        after_stop = [t for t in s1["commit_times"].get(new_leader, [])
                      if t > failover["t_stop"]]
        wins_after = [w for w in s1["elections"][len(s0["elections"]):]]
        failover.update({
            "new_leader": new_leader,
            "to_new_leader_s": wins_after[0][0] - failover["t_stop"]
            if wins_after else None,
            "to_first_commit_s": after_stop[0] - failover["t_stop"],
            "to_client_epoch_s": failover["t_client_epoch"] -
            failover["t_stop"]})

        # -- 37. balancer traffic --------------------------------------------
        om, mm = mc.osdmap, mc.mapping_table
        e0 = om.epoch
        seeds = rng.choice(PG_NUM, MON_BALANCER, replace=False)
        cmds = []
        for seed in seeds:
            row = [int(o) for o in mm._pools[1].up[seed]]
            to = next(o for o in (int(x) for x in rng.integers(
                0, om.max_osd, 16)) if o not in row)
            cmds.append({"prefix": "osd pg-upmap-items",
                         "pgid": f"1.{int(seed):x}",
                         "mappings": [row[0], to]})
        t0 = time.monotonic()
        await asyncio.gather(*(command(mc, c) for c in cmds))
        t_acked = time.monotonic()
        last = await table_at(mc, arrivals, e0 + MON_BALANCER, "balancer")
        om, mm = mc.osdmap, mc.mapping_table
        require(all(om.pg_upmap_items.get(pg_t.parse(c["pgid"])) ==
                    [tuple(c["mappings"])] for c in cmds),
                "mon_path balancer: an upmap item is missing from the map")
        table_rows_vs_scratch(om, mm, 1, seeds, "mon_path balancer")
        require(all(int(mm._pools[1].up[s][0]) == c["mappings"][1]
                    for s, c in zip(seeds, cmds)),
                "mon_path balancer: a row does not hold its upmap target")
        log.drain("mon_path balancer")
        balancer = {"commands": MON_BALANCER,
                    "commits_per_s": MON_BALANCER / (t_acked - t0),
                    "to_table_s": last["t_out"] - t0,
                    "launches": sum(a["launches"] for a in arrivals
                                    if a["t_in"] >= t0)}
        print(f"[{card}] mon_path balancer: {MON_BALANCER} concurrent "
              f"pg-upmap-items at {balancer['commits_per_s']:.1f} commits/s"
              f", all in the client's table after "
              f"{balancer['to_table_s']:.3f} s")
        s2 = (await mp.ask("stats"))[1]
        require(s2["launches"] == s0["launches"] == 0 and
                s2["h2d_bytes"] == s0["h2d_bytes"],
                f"mon_path: the mons' commits launched {s2['launches']} "
                f"kernels or moved {s2['h2d_bytes'] - s0['h2d_bytes']} "
                f"bytes to the card")

        # -- 38. `osd map` from the leader -----------------------------------
        names = [f"rbd_data.{int(x):016x}" for x in
                 rng.integers(0, 1 << 62, MON_OBJECTS)]
        t0 = time.monotonic()
        for j, name in enumerate(names):
            pid = 1 + j % 2
            got = json.loads(await command(mc, {
                "prefix": "osd map", "pool": om.pools[pid].name,
                "object": name}))
            p = om.pools[pid]
            pg = om.object_locator_to_pg(name, ObjectLocator(pool=pid))
            seed = int(p.raw_pg_to_pg(np.asarray([pg.seed]), xp=np)[0])
            t = mm._pools[pid]
            want = {"pgid": f"{pid}.{seed:x}",
                    "up": [int(o) for o in t.up[seed] if o != ITEM_NONE],
                    "up_primary": int(t.up_primary[seed]),
                    "acting": [int(o) for o in t.acting[seed]
                               if o != ITEM_NONE],
                    "acting_primary": int(t.acting_primary[seed])}
            require(got == want, f"mon_path osd map {name}: the leader "
                                 f"says {got}, the client's table {want}")
        osd_map_s = time.monotonic() - t0
        s3 = (await mp.ask("stats"))[1]
        require(s3["launches"] > 0 and s3["max_abs_err"] == 0,
                f"mon_path: the leader's `osd map` launched "
                f"{s3['launches']} kernels")
        print(f"[{card}] mon_path: `osd map` of {MON_OBJECTS} names from "
              f"the leader equals the client's table ({s3['launches']} "
              f"one-lane launches on the leader, equal to the plain "
              f"version; their checks took {s3['check_s']['s']:.3f} s of "
              f"the mons' loop, {s3['check_s']['max_s']:.4f} s at most "
              f"at a time)")

        # -- 39. the last epoch ----------------------------------------------
        w = om._device_weights().tolist()
        for pid, pool_ in om.pools.items():
            table_rows_vs_scratch(om, mm, pid, np.arange(pool_.pg_num),
                                  "mon_path last epoch")
            pick = np.linspace(0, pool_.pg_num - 1,
                               SCALAR_SAMPLE).astype(np.int64)
            pseeds = pick.astype(np.uint32)
            pps = pool_.raw_pg_to_pps(pseeds)
            raw = scalar_map(pool, om.crush, pool_.crush_rule, pps,
                             pool_.size, w).astype(np.int32)
            want = (raw, *om._pipeline_from_crush(pool_, pseeds, raw, pps))
            t = mm._pools[pid]
            for name, wv in zip(TABLES, want):
                require(np.array_equal(getattr(t, name)[pick], wv),
                        f"mon_path last epoch: pool {pid} {name} differs "
                        f"from mapper_ref + pipeline")
        log.drain("mon_path last epoch")
        t0 = time.monotonic()
        while True:
            s4 = (await mp.ask("stats"))[1]
            if len(set(s4["last_committed"].values())) == 1:
                break
            require(time.monotonic() - t0 < 30, f"mon_path: the surviving "
                    f"mons disagree: {s4['last_committed']}")
            await asyncio.sleep(0.05)
        maps = (await mp.ask("getmap"))[1]
        mine = encode_osdmap(om)
        fetched = await command(mc, {"prefix": "osd getmap"})
        require(len(maps) == len(MON_NAMES) - 1 and
                all(b == mine for b in maps.values()) and fetched == mine,
                "mon_path: `osd getmap` differs between the surviving mons "
                "and the client's map")
        print(f"[{card}] mon_path: the last epoch's whole table equals a "
              f"from-scratch sweep, {SCALAR_SAMPLE} PGs per pool equal "
              f"mapper_ref + the pipeline, and `osd getmap` is the same "
              f"{len(mine)} bytes on both surviving mons and the client")

        # -- 40. epochs, elections, health -------------------------------------
        covered, jumps = set(), 0
        for a in arrivals:
            lo = a["before"]
            if a["full"] and max(a["full"]) > lo:
                jumps += lo != 0 and max(a["full"]) > lo + 1
                lo = max(a["full"])
                covered.add(lo)
            covered |= {e for e in a["incs"] if lo < e <= a["after"]}
        first, last_e = min(covered), max(covered)
        require(covered == set(range(first, last_e + 1)) and not jumps
                and last_e == om.epoch,
                f"mon_path: the client's epochs skip "
                f"{sorted(set(range(first, last_e + 1)) - covered)[:8]}")
        splits = split_epochs([(w[1], w[3]) for w in s4["elections"]])
        require(not splits, f"mon_path: epochs won by two mons: {splits}; "
                            f"{s4['elections']}")
        elections = len(s4["elections"]) - rec["startup_elections"]
        require(elections == 1, f"mon_path: {elections} elections after "
                                f"the quorum formed, want 1 (the failover):"
                                f" {s4['elections']}, leader stopped at "
                                f"{failover['t_stop']}")
        d = dm.perf.dump()
        require(d["path_checks"] > 0 and not d["path_mismatch"],
                f"mon_path: devmon {d}")
        main_launches = sum(a["launches"] for a in arrivals)
        wire = dict(s4["wire"])
        for k, v in mc.msgr.wire.items():
            wire[k] = wire.get(k, 0) + v
        kinds = {}
        for k, r in per_kind.items():
            out = {"epochs": len(r["to_table_s"]),
                   "launches": r["launches"],
                   "full_sweep_pools": r["full_sweep_pools"]}
            for part in ("to_table_s", "commit_s", "update_s"):
                v = sorted(r[part])
                out[part + "_median"] = v[len(v) // 2]
                out[part + "_max"] = v[-1]
            kinds[k] = out
        rec.update({
            "card": card, "mons": len(MON_NAMES), "osds": om.max_osd,
            "pools": {pid: {"pg_num": p.pg_num, "size": p.size,
                            "engine": rec["engines"][pid]}
                      for pid, p in om.pools.items()},
            "epochs": om.epoch, "by_kind": kinds, "failover": {
                k: v for k, v in failover.items() if not k.startswith("t_")},
            "balancer": balancer, "osd_map_s": osd_map_s,
            "elections": {"to_form_quorum": rec["startup_elections"],
                          "after": elections, "split_epochs": splits,
                          "paxos_timeouts": s4["paxos_timeouts"]},
            "paxos_commits": s4["paxos_commits"],
            "last_committed": s4["last_committed"],
            "wire": wire,
            "commit_moves_nothing": {
                "mon_launches": s2["launches"],
                "mon_h2d_bytes": s2["h2d_bytes"] - s0["h2d_bytes"],
                "commits": sum(s2["paxos_commits"].values()) -
                sum(s0["paxos_commits"].values())},
            "crush_straw2": {
                "client_launches": main_launches,
                "client_lanes": sum(log.main_lanes),
                "client_cuda_event_ms": log.main_ms,
                "mon_launches": s4["launches"],
                "mon_lanes": s4["lanes"],
                "mon_cuda_event_ms": s4["cuda_event_ms"],
                "checked_against_plain": log.checked + s4["checked"],
                "max_abs_err": max(log.worst, s4["max_abs_err"])},
            "getmap_bytes": len(mine),
        })
        return rec, main_launches + s4["launches"], \
            max(log.worst, s4["max_abs_err"])

    with LaunchLog(kernels) as log, tempfile.TemporaryDirectory(
            dir=out_dir) as tmp:
        rec, launches, worst = asyncio.run(drive(tmp, log))
    rec["phase_s"] = time.perf_counter() - t_phase
    print("mon_path: " + json.dumps(rec))
    return launches, worst


# -- the PG path's harness: one OSD facade per OSD, over one map ------------
#
# The PG reaches its daemon only through ``self.osd``. ``OSDFacade`` is that
# surface and nothing more: the daemon's own helpers (next_tid, osd_is_up,
# send_osd, request_repeer; ``ceph_tpu/osd/daemon.py:357-388``), the PG
# branch of its ms_dispatch (``:821-1070``), a messenger bound on 127.0.0.1
# in crc mode, a MemStore, its own aggregators and residency cache
# (``:212-240``), and reservers and a RecoveryThrottle. It is harness code,
# not a feature: the smoke drives the port through it, and the CPU tests
# drive both packages through it, side by side.

PG_RINGS_AGG = ("flush_failures", "per_op_retries", "fallback_ops",
                "crc_fallbacks")
PG_RINGS_READ_AGG = ("flush_failures", "per_op_retries", "fallback_ops",
                     "quarantined_ops")


def pg_modules():
    """The port's modules that the PG path reaches, and ``make_cache(config,
    device)``, the residency cache's constructor. ``PGCluster`` reaches
    the package only through this namespace."""
    from types import SimpleNamespace

    from ceph_tpu_torch import msg
    from ceph_tpu_torch.ec.torch_plugin import DeviceShardCache
    from ceph_tpu_torch.mon.messages import MOSDAlive
    from ceph_tpu_torch.os_.objectstore import MemStore
    from ceph_tpu_torch.osd import messages, recovery, scrub, types
    from ceph_tpu_torch.osd.ec_aggregator import ECAggregator
    from ceph_tpu_torch.osd.ec_pg import ECPG
    from ceph_tpu_torch.osd.ec_read_aggregator import ECReadAggregator
    from ceph_tpu_torch.osd.pg import PG
    from ceph_tpu_torch.utils.op_tracker import OpTracker
    from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder
    from ceph_tpu_torch.utils.throttle import MessageThrottle
    from ceph_tpu_torch.utils.tracing import Tracer

    def make_cache(config, device):
        return DeviceShardCache(config, device=device)
    return SimpleNamespace(
        msg=msg, M=messages, MOSDAlive=MOSDAlive, ECPG=ECPG, PG=PG, recovery=recovery, scrub=scrub, MemStore=MemStore,
        ECAggregator=ECAggregator, ECReadAggregator=ECReadAggregator,
        Tracer=Tracer, OpTracker=OpTracker, MessageThrottle=MessageThrottle,
        PerfCountersBuilder=PerfCountersBuilder, types=types,
        make_cache=make_cache)


class MonStub:
    """The monitor as the PG sees it (``osd.monc``): an MOSDAlive is
    granted by applying an Incremental with ``new_up_thru`` to the map
    and publishing it, as OSDMonitor::prepare_alive does; ``subscribe``
    has nothing to do, since every facade holds the one map."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.grants = 0

    async def send_report(self, m) -> None:
        om = self.cluster.osdmap
        if type(m).__name__ != "MOSDAlive" or \
                om.up_thru.get(m.osd, 0) >= m.epoch:
            return
        from ceph_tpu_torch.osd.osdmap import Incremental
        self.grants += 1
        self.cluster.apply(Incremental(epoch=om.epoch + 1,
                                       new_up_thru={m.osd: m.epoch}))

    async def subscribe(self, what: str, start: int) -> None:
        return None


class OSDFacade:
    """One OSD as its PGs see it (see the section comment above)."""

    def __init__(self, cluster, whoami: int):
        mods = cluster.mods
        self.cluster, self.mods, self.whoami = cluster, mods, whoami
        self.config = dict(cluster.config)
        self.store = mods.MemStore()
        self.msgr = mods.msg.Messenger(f"osd.{whoami}",
                                       keyring=cluster.keyring,
                                       mode=mods.msg.MODE_CRC)
        self.msgr.set_policy("osd", mods.msg.Policy.lossless_peer())
        self.msgr.add_dispatcher(self)
        self.tracer = mods.Tracer(f"osd.{whoami}", self.config)
        self.perf = (mods.PerfCountersBuilder(f"osd.{whoami}")
                     .add_u64_counter("ops")
                     .add_histogram("op_w_latency_hist")
                     .add_histogram("op_r_latency_hist")
                     .create_perf_counters(register=False))
        self.op_tracker = mods.OpTracker()
        # the daemon's defaults: osd_client_message_cap and _size_cap,
        # osd_max_backfills, osd_recovery_max_active
        self.client_throttle = mods.MessageThrottle(max_ops=256,
                                                    max_bytes=500 << 20)
        self.local_reserver = mods.recovery.AsyncReserver(1)
        self.remote_reserver = mods.recovery.AsyncReserver(1)
        # recovery.RecoveryThrottle stands in for the daemon's
        # SchedulerThrottle (dmClock): the same acquire/release shape
        self.recovery_throttle = mods.recovery.RecoveryThrottle(
            max_active=8)
        self.ec_agg = mods.ECAggregator(self.config)
        self.ec_read_agg = mods.ECReadAggregator(self.config)
        self.ec_resident = None
        if int(self.config.get("osd_ec_resident_bytes", 0)) > 0:
            self.ec_resident = mods.make_cache(self.config, cluster.device)
        self.monc = cluster.monc
        self.pgs: dict = {}
        self._tid = 0
        self._stopped = False

    @property
    def osdmap(self):
        return self.cluster.osdmap

    def backfill_toofull(self) -> bool:
        return False

    # -- the daemon's service facade (daemon.py:357-388) -----------------
    def next_tid(self) -> int:
        self._tid += 1
        return self._tid

    def osd_is_up(self, osd: int) -> bool:
        om = self.osdmap
        return 0 <= osd < om.max_osd and bool(om.is_up(osd))

    async def send_osd(self, osd: int, msg) -> None:
        addr = self.cluster.addrs.get(osd)
        if addr is None:
            raise ConnectionError(f"osd.{osd} has no address")
        await asyncio.wait_for(
            self.msgr.send_message(msg, addr, f"osd.{osd}"), timeout=2.0)

    def request_repeer(self, pg, delay: float = 0.5) -> None:
        async def later():
            await asyncio.sleep(delay)
            if pg.state == "peering" and pg.is_primary() and \
                    not self._stopped:
                pg.advance(pg.up, pg.acting, pg.primary, pg.epoch)
        asyncio.ensure_future(later())

    # -- map handling (daemon.py _on_osdmap, one EC pool, no split) -------
    def consume_map(self, rows: dict) -> None:
        """``rows``: pool id -> (up, acting, primary) per seed."""
        om = self.osdmap
        for pid, by_seed in rows.items():
            pool = self.cluster.pools[pid]
            for seed, (up, acting, primary) in enumerate(by_seed):
                cid = str(self.mods.types.pg_t(pid, seed))
                if cid not in self.pgs and self.whoami in up + acting:
                    self.pgs[cid] = self.mods.ECPG(
                        self, pool, self.mods.types.pg_t(pid, seed))
                pg = self.pgs.get(cid)
                if pg is not None:
                    pg.advance(list(up), list(acting), primary, om.epoch)

    def _pg_for(self, pgid_s: str, create: bool = False):
        pg = self.pgs.get(pgid_s)
        if pg is None and create:
            pgid = self.mods.types.pg_t.parse(pgid_s)
            up, acting, primary = self.cluster.placement(pgid.pool,
                                                         pgid.seed)
            pg = self.pgs[pgid_s] = self.mods.ECPG(
                self, self.cluster.pools[pgid.pool], pgid)
            pg.advance(up, acting, primary, self.osdmap.epoch)
        return pg

    # -- the PG branch of ms_dispatch (daemon.py:821-1070) ----------------
    async def ms_handle_reset(self, conn) -> None:
        return None

    async def ms_dispatch(self, msg) -> bool:
        M = self.mods.M
        if isinstance(msg, M.MOSDOp):
            pg = self._pg_for(str(self.mods.types.pg_t(msg.pool,
                                                       msg.seed)))
            if pg is None or not pg.is_primary():
                await msg.conn.send_message(M.MOSDOpReply(
                    tid=msg.tid, attempt=msg.attempt, result=-11,
                    epoch=self.osdmap.epoch, data=b"", extra=""))
                return True
            # no backoff path yet: an op that arrives while the PG peers
            # waits in its queue until the op worker starts
            await pg.queue_op(msg)
            return True
        create = isinstance(msg, (M.MOSDECSubOpWrite, M.MOSDECSubOpRead,
                                  M.MOSDPGQuery, M.MOSDPGPush,
                                  M.MOSDPGScan, M.MOSDPGBackfill,
                                  M.MBackfillReserve)) or (
            isinstance(msg, M.MOSDPGInfo) and bool(msg.notify))
        pgid = getattr(msg, "pgid", None)
        pg = self._pg_for(pgid, create=create) if pgid else None
        if pg is None:
            return True
        if isinstance(msg, M.MOSDECSubOpWrite):
            pg.handle_ec_sub_write(msg)
        elif isinstance(msg, M.MOSDECSubOpWriteReply):
            pg.handle_ec_sub_write_reply(msg)
        elif isinstance(msg, M.MOSDECSubOpRead):
            pg.handle_ec_sub_read(msg)
        elif isinstance(msg, M.MOSDECSubOpReadReply):
            pg.handle_ec_sub_read_reply(msg)
        elif isinstance(msg, M.MOSDPGQuery):
            pg.handle_pg_query(msg)
        elif isinstance(msg, M.MOSDPGInfo):
            pg.handle_pg_info(msg)
        elif isinstance(msg, M.MOSDPGPull):
            pg.handle_pg_pull(msg)
        elif isinstance(msg, M.MOSDPGPush):
            if pg.apply_push(msg):
                await self.send_osd(msg.from_osd, M.MOSDPGPushReply(
                    pgid=msg.pgid, oid=msg.oid, from_osd=self.whoami))
        elif isinstance(msg, M.MOSDPGPushReply):
            pg.handle_push_reply(msg)
        elif isinstance(msg, M.MPGCleanNotice):
            pg.handle_clean_notice(msg)
        elif isinstance(msg, M.MOSDPGScan):
            pg.handle_pg_scan(msg)
        elif isinstance(msg, M.MOSDPGScanReply):
            pg.handle_scan_reply(msg)
        elif isinstance(msg, M.MOSDPGBackfill):
            pg.handle_backfill(msg)
        elif isinstance(msg, M.MOSDPGBackfillReply):
            pg.handle_backfill_reply(msg)
        elif isinstance(msg, M.MBackfillReserve):
            pg.handle_backfill_reserve(msg)
        elif isinstance(msg, M.MOSDRepScrub):
            await msg.conn.send_message(M.MOSDRepScrubMap(
                pgid=msg.pgid, tid=msg.tid, from_osd=self.whoami,
                scrub_map=self.mods.scrub.build_scrub_map(pg)))
        elif isinstance(msg, M.MOSDRepScrubMap):
            if pg._scrubber is not None:
                pg.scrubber.handle_map(msg)
        else:
            return False
        return True

    async def stop(self) -> None:
        """The daemon dies: its PGs' tasks end, its messenger closes."""
        self._stopped = True
        for pg in self.pgs.values():
            for task in (pg._worker, pg._peering_task, pg._backfill_task,
                         getattr(pg, "_posfix_task", None)):
                if task is not None:
                    task.cancel()
        self.ec_agg.drain()
        self.ec_read_agg.drain()
        await self.msgr.shutdown()


class PGCluster:
    """``n`` OSD facades on ``n`` hosts of one CRUSH map (one OSD a host,
    straw2) and one EC pool of one PG under an ``indep`` host rule, its
    acting set from the port's ``OSDMap.pg_to_up_acting_osds`` (placement
    is the port's in either package); a client messenger sends MOSDOps
    to the primary. ``device`` is where the map's rule VM, the plugin
    and the residency caches run."""

    def __init__(self, mods, n_osds: int, profile: dict, size: int,
                 min_size: int, device: str, config: dict | None = None):
        from ceph_tpu_torch.crush import builder
        from ceph_tpu_torch.osd.osdmap import OSDMap
        from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool
        self.mods, self.device = mods, device
        self.config = dict(config or {})
        crush, root = builder.build_hierarchy(n_osds, 1)
        rule = builder.add_simple_rule(crush, root, builder.TYPE_HOST,
                                       indep=True)
        self.osdmap = OSDMap(crush, device=device)
        spec = dict(id=1, pg_num=1, size=size, min_size=min_size,
                    crush_rule=rule, name="ecpool",
                    extra={"profile": dict(profile)})
        self.osdmap.add_pool(PGPool(type=POOL_TYPE_ERASURE, **spec))
        # the PGs hold their own package's pool object
        self.pools = {1: mods.types.PGPool(
            type=mods.types.POOL_TYPE_ERASURE, **spec)}
        self.keyring = mods.msg.Keyring()
        for name in [f"osd.{i}" for i in range(n_osds)] + ["client.pg"]:
            self.keyring.add(name, bytes([len(name)]) * 32)
        self.monc = MonStub(self)
        self.osds = {i: OSDFacade(self, i) for i in range(n_osds)}
        self.addrs: dict = {}
        self.client = None

    def placement(self, pid: int, seed: int):
        """(up, acting, primary) of one PG at the map's epoch; a hole is
        -1, as the daemon writes it."""
        from ceph_tpu_torch.crush.types import ITEM_NONE
        up, _upp, acting, actp = self.osdmap.pg_to_up_acting_osds(
            pid, [seed])

        def row(r):
            return [int(o) if o != ITEM_NONE else -1 for o in r]
        return row(up[0]), row(acting[0]), int(actp[0])

    def publish(self) -> None:
        """Every live facade consumes the map (the daemon's map
        handling, for this one pool)."""
        rows = {pid: [self.placement(pid, s) for s in range(p.pg_num)]
                for pid, p in self.osdmap.pools.items()}
        for f in self.osds.values():
            if not f._stopped:
                f.consume_map(rows)

    def apply(self, inc) -> None:
        """Commit an Incremental and publish the map on the next loop
        turn (a map reaches the OSDs after the commit, never inside the
        caller's own step)."""
        self.osdmap.apply_incremental(inc)
        asyncio.get_event_loop().call_soon(self.publish)

    def pg(self, osd: int):
        return self.osds[osd].pgs.get("1.0")

    def primary(self):
        return self.pg(self.placement(1, 0)[2])

    async def start(self, deadline: float = 30.0) -> None:
        for i, f in self.osds.items():
            self.addrs[i] = await f.msgr.bind("127.0.0.1")
        self.client = PGClient(self)
        self.publish()
        await self.wait_state(("clean",), deadline)

    async def wait_state(self, states, deadline: float = 30.0):
        """Wait until the current primary's PG is in one of ``states``."""
        def ready():
            pg = self.primary()
            return pg is not None and pg.state in states
        await wait_until(ready, deadline, lambda: f"primary PG state "
                         f"{getattr(self.primary(), 'state', None)}, "
                         f"want {states}")
        return self.primary()

    async def kill(self, osds) -> None:
        """The OSDs' daemons die and the map marks them down."""
        from ceph_tpu_torch.osd.osdmap import Incremental
        for o in osds:
            await self.osds[o].stop()
        self.apply(Incremental(epoch=self.osdmap.epoch + 1,
                               new_down=list(osds)))

    def replace(self, old: int, new: int) -> None:
        """``ceph osd pg-upmap-items 1.0 old new``: ``new`` takes
        ``old``'s position in the PG's acting set, the rest stay."""
        from ceph_tpu_torch.osd.osdmap import Incremental
        from ceph_tpu_torch.osd.types import pg_t
        self.apply(Incremental(epoch=self.osdmap.epoch + 1,
                               new_pg_upmap_items={pg_t(1, 0): [(old,
                                                                 new)]}))

    def perf_sum(self, what: str, keys) -> dict:
        """A counter family summed over the live facades."""
        out = dict.fromkeys(keys, 0)
        for f in self.osds.values():
            obj = getattr(f, what)
            if obj is None:
                continue
            d = obj.perf.dump()
            for k in keys:
                out[k] += int(d.get(k, 0))
        return out

    def wire(self) -> dict:
        out = {"tx_frames": 0, "tx_bytes": 0, "rx_frames": 0,
               "rx_bytes": 0}
        for m in [f.msgr for f in self.osds.values()] + \
                [self.client.msgr]:
            for k, v in getattr(m, "wire", {}).items():
                out[k] += v
        return out

    async def stop(self) -> None:
        await self.client.msgr.shutdown()
        for f in self.osds.values():
            if not f._stopped:
                await f.stop()


class PGClient:
    """A client messenger that sends MOSDOps to the PG's primary and
    waits for each reply, resending an -EAGAIN as the objecter does,
    within a deadline."""

    def __init__(self, cluster):
        self.cluster = cluster
        mods = cluster.mods
        self.msgr = mods.msg.Messenger("client.pg", keyring=cluster.keyring,
                                       mode=mods.msg.MODE_CRC)
        self.msgr.add_dispatcher(self)
        self._tid = 0
        self._waiters: dict = {}

    async def ms_handle_reset(self, conn) -> None:
        return None

    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, self.cluster.mods.M.MOSDOpReply):
            fut = self._waiters.pop((msg.tid, msg.attempt), None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return True
        return False

    async def op(self, oid: str, ops, deadline: float = 60.0):
        """ops: (code, offset, length, name, data) tuples. Returns the
        reply; raises when no final reply arrives before the deadline."""
        c = self.cluster
        self._tid += 1
        tid = self._tid
        loop = asyncio.get_event_loop()
        end = loop.time() + deadline
        for attempt in range(1 << 30):
            fut = loop.create_future()
            self._waiters[(tid, attempt)] = fut
            primary = c.placement(1, 0)[2]
            m = c.mods.M.make_osd_op(tid, c.osdmap.epoch, 1, 0, oid, ops,
                                     attempt=attempt)
            try:
                await self.msgr.send_message(m, c.addrs[primary],
                                             f"osd.{primary}")
                reply = await asyncio.wait_for(
                    fut, max(0.01, end - loop.time()))
            finally:
                self._waiters.pop((tid, attempt), None)
            if reply.result != -11:
                return reply
            if loop.time() >= end:
                raise TimeoutError(f"{oid}: -EAGAIN until the deadline")
            await asyncio.sleep(0.05)
        raise AssertionError("unreachable")


async def wait_until(pred, deadline: float, what) -> None:
    """Poll ``pred`` every 10 ms; raise TimeoutError (with ``what()``)
    when it is still false after ``deadline`` seconds."""
    loop = asyncio.get_event_loop()
    end = loop.time() + deadline
    while not pred():
        if loop.time() >= end:
            raise TimeoutError(what())
        await asyncio.sleep(0.01)



def _timed_method(obj, name: str, spent: dict, key: str) -> None:
    """Wrap ``obj.name`` (sync or async) so its wall time adds to
    ``spent[key]``; the wrapper lives on the instance."""
    import inspect
    fn = getattr(obj, name)
    if inspect.iscoroutinefunction(fn):
        async def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return await fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
    else:
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
    setattr(obj, name, run)


async def pg_write_breakdown(mods, profile, config, rng, n_writes: int,
                             n_rmw: int) -> dict:
    """Host seconds of a 4 MiB write_full and of a 4 KiB partial write
    through a healthy PG, taken apart (off the main path, on a cluster of
    its own, one op at a time): the messenger and the event loop (the
    client round trip outside the primary's ``_execute``, and the sub-op
    round trips outside the shards' applies), the PG and its log (the
    rest of ``_execute``: the merge copy, the log entry and its meta
    transaction, the ``_hcrc`` fold of the fused pass's row CRCs, the
    sub-op messages), the gather of the old stripes, the encode call
    (``_agg_encode``: the aggregator, the launch, the readback) and the
    sub-write applies on every shard."""
    from ceph_tpu_torch.ec import crc as ec_crc
    cl = PGCluster(mods, PG_OSDS, profile, K + M, K + 1, "cuda", config)
    M_ = mods.M
    out = {}
    real_hcrc = ec_crc.hcrc_attr
    try:
        await cl.start(deadline=60.0)
        pg = cl.primary()
        spent = dict.fromkeys(("exec", "gather", "encode", "fanout",
                               "apply", "meta", "hcrc"), 0.0)
        _timed_method(pg, "_execute", spent, "exec")
        _timed_method(pg, "_meta_txn_store", spent, "meta")
        _timed_method(ec_crc, "hcrc_attr", spent, "hcrc")
        _timed_method(pg, "_gather", spent, "gather")
        _timed_method(pg, "_agg_encode", spent, "encode")
        _timed_method(pg, "_fan_out_subops", spent, "fanout")
        for f in cl.osds.values():
            if "1.0" in f.pgs:            # the spare holds no shard
                _timed_method(f.pgs["1.0"], "_apply_sub_write", spent,
                              "apply")
        writes = [(f"bd.{i}", M_.OSD_OP_WRITEFULL, 0, rng.integers(
            0, 256, OBJ_SIZE, dtype=np.uint8).tobytes())
            for i in range(n_writes)]
        rmws = [(f"bd.{int(rng.integers(0, n_writes))}", M_.OSD_OP_WRITE,
                 int(rng.integers(0, OBJ_SIZE - RMW_BYTES)),
                 rng.integers(0, 256, RMW_BYTES, dtype=np.uint8).tobytes())
                for _ in range(n_rmw)]
        for what, ops in (("write_4MiB", writes), ("rmw_4KiB", rmws)):
            for key in spent:
                spent[key] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for oid, code, off, data in ops:
                r = await cl.client.op(oid, [(code, off, len(data), "",
                                              data)])
                require(r.result == 0, f"breakdown: {oid} {r.result}")
            total = (time.perf_counter() - t0) / len(ops)
            per = {k: v / len(ops) for k, v in spent.items()}
            out[what] = {
                "total": total,
                "messenger_client_round_trip": total - per["exec"],
                "messenger_subop_round_trips": per["fanout"] -
                per["apply"],
                "pg_and_log": per["exec"] - per["gather"] -
                per["encode"] - per["fanout"],
                "pg_and_log_of_which_meta_txn": per["meta"],
                "pg_and_log_of_which_hcrc_fold": per["hcrc"],
                "gather": per["gather"],
                "encode_call": per["encode"],
                "sub_write_apply": per["apply"]}
    finally:
        ec_crc.hcrc_attr = real_hcrc
        await cl.stop()
    return out


def ec_pg_path_phase(card: str, spec) -> tuple[int, int]:
    """The erasure-coded PG path on the card (phases 30-34): one ECPG of a
    k=8 m=3 pool on 12 OSD facades, driven by a client messenger.
    Returns the gf_encode launches of the path (the count set to 0 just
    before it and read just after) and the largest byte difference of
    any launch from the plain version."""
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.gf import kernels
    from ceph_tpu_torch.osd.recovery import PERF as RECOVERY_PERF
    from ceph_tpu_torch.utils import roofline

    mods = pg_modules()
    scrub_mod = mods.scrub
    M_ = mods.M
    profile = {"plugin": "jax", "technique": "reed_sol_van", "k": str(K),
               "m": str(M), "stripe_unit": str(OBJ_C)}
    config = {"osd_ec_resident_bytes": OBJ_RESIDENT_BYTES}
    rng = np.random.default_rng(SEED + 7)
    oids = [f"rbd_data.{i:04x}" for i in range(PG_OBJS)]
    W = K * OBJ_C
    stripes = OBJ_SIZE // W
    gib = 1 << 30
    host_s, rec = {}, {}
    t_phase = time.perf_counter()
    reserve_allocator(OBJ_RESERVE_LARGE, OBJ_RESERVE_SMALL)

    async def timed(what, coro):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = await coro
        torch.cuda.synchronize()
        host_s[what] = time.perf_counter() - t0
        return out

    async def ops_all(cl, ops, what):
        """Send every op at once (the PG queues them in order) and
        require each to succeed."""
        replies = await asyncio.gather(*[
            cl.client.op(oid, [(code, off, ln, "", data)], deadline=900.0)
            for oid, code, off, ln, data in ops])
        bad = [(op[0], r.result) for op, r in zip(ops, replies)
               if r.result != 0]
        require(not bad, f"{what}: {len(bad)} ops failed, first {bad[:3]}")
        return replies

    def reads(names):
        return [(oid, M_.OSD_OP_READ, 0, 0, b"") for oid in names]

    def check_reads(replies, names, what):
        for oid, r in zip(names, replies):
            require(bytes(r.data) == bytes(mirror[oid]),
                    f"{what}: {oid} differs from its mirror")

    def resident_oids(f):
        return {key[1] for key in getattr(f.ec_resident, "_lru", {})}

    def card_failures():
        d = RECOVERY_PERF.dump()
        return (d.get("push_device_failures", 0),
                d.get("rebuild_device_failures", 0))

    async def run(log):
        failures0 = card_failures()
        cl = PGCluster(mods, PG_OSDS, profile, K + M, K + 1, "cuda",
                       config)
        await cl.start(deadline=60.0)
        pg = cl.primary()
        require(pg.ec.device.type == "cuda" and
                cl.osds[pg.osd.whoami].ec_resident.device.type == "cuda",
                "pg path: the plugin or the cache is not on the card")
        _up, acting, _primary = cl.placement(1, 0)
        require(-1 not in acting and len(set(acting)) == K + M,
                f"pg path: acting {acting}")
        spare = next(o for o in range(PG_OSDS) if o not in acting)
        agg0 = cl.perf_sum("ec_agg", ("batches", "ops", "stripes"))
        torch.cuda.synchronize()
        log.real.launches = 0

        # -- 30. write every object whole, then 4 KiB partial writes -----
        log.label = "write"
        await timed("write", ops_all(cl, [
            (oid, M_.OSD_OP_WRITEFULL, 0, OBJ_SIZE, bytes(mirror[oid]))
            for oid in oids], "write"))
        log.drain("pg write")
        agg1 = cl.perf_sum("ec_agg", ("batches", "ops", "stripes"))
        log.label = "rmw"
        small = []
        for j in range(PG_RMW_OPS):
            oid = oids[int(rng.integers(0, PG_OBJS))]
            if j % 8 == 0:           # straddle a stripe boundary
                s = int(rng.integers(1, stripes))
                off = s * W - int(rng.integers(1, RMW_BYTES))
            else:
                off = int(rng.integers(0, OBJ_SIZE - RMW_BYTES))
            data = rng.integers(0, 256, RMW_BYTES, dtype=np.uint8).tobytes()
            small.append((oid, M_.OSD_OP_WRITE, off, RMW_BYTES, data))
            mirror[oid][off:off + RMW_BYTES] = data
        await timed("rmw", ops_all(cl, small, "rmw"))
        log.drain("pg rmw")
        rec["writes"] = {"whole": {k: agg1[k] - agg0[k] for k in agg0}}
        agg2 = cl.perf_sum("ec_agg", ("batches", "ops", "stripes"))
        rec["writes"]["rmw"] = {k: agg2[k] - agg1[k] for k in agg0}

        # -- 30. read back, then the last 32 again from the cache ---------
        log.label = "read"
        got = await timed("read", ops_all(cl, reads(oids), "read"))
        check_reads(got, oids, "read")
        hot = oids[-RESIDENT_OBJS:]
        res0 = cl.perf_sum("ec_resident", ("hits", "misses"))
        got = await timed("read_resident", ops_all(cl, reads(hot),
                                                   "resident"))
        check_reads(got, hot, "read_resident")
        res1 = cl.perf_sum("ec_resident", ("hits", "misses"))
        require(res1["hits"] - res0["hits"] == RESIDENT_OBJS,
                f"residency: {res1['hits'] - res0['hits']} hits of "
                f"{RESIDENT_OBJS}")
        log.drain("pg read")

        # -- 31. a data and a parity OSD die: degraded reads -------------
        lost = [acting[2], acting[9]]
        await cl.kill(lost)
        pg = await cl.wait_state(("active",), 60.0)
        require(pg.acting[2] == -1 and pg.acting[9] == -1,
                f"degraded: acting {pg.acting}")
        log.label = "degraded_read"
        dec0 = cl.perf_sum("ec_read_agg", ("batches", "ops", "stripes"))
        got = await timed("read_degraded", ops_all(cl, reads(oids),
                                                   "degraded read"))
        check_reads(got, oids, "degraded read")
        dec1 = cl.perf_sum("ec_read_agg", ("batches", "ops", "stripes"))
        rec["degraded_decodes"] = {k: dec1[k] - dec0[k] for k in dec0}
        require(rec["degraded_decodes"]["ops"] == PG_OBJS,
                f"degraded: {rec['degraded_decodes']} decodes")
        log.drain("pg degraded read")

        # -- 32. the spare takes position 2; recovery pushes --------------
        log.label = "recovery"
        cl.replace(lost[0], spare)

        def recovered():
            p = cl.primary()
            return p is not None and p.acting[2] == spare and \
                p.state == "active" and not any(p.peer_missing.values()) \
                and len(cl.osds[spare].store.list_objects("1.0")) == \
                PG_OBJS + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        await wait_until(recovered, 600.0, lambda: (
            cl.primary().state, {o: len(v) for o, v in
                                 cl.primary().peer_missing.items()}))
        torch.cuda.synchronize()
        host_s["recovery"] = time.perf_counter() - t0
        log.drain("pg recovery")
        require(card_failures() == failures0,
                "recovery: a rebuild failed on the card")
        st = cl.osds[spare].store
        for oid in oids:
            want = np.frombuffer(bytes(mirror[oid]), dtype=np.uint8
                                 ).reshape(stripes, K, OBJ_C)[:, 2]
            got_shard = st.read("1.0", oid)
            require(got_shard == want.tobytes(),
                    f"recovery: position 2 of {oid} differs from the "
                    f"mirror's")
            attrs = st.getattrs("1.0", oid)
            require(attrs["_hcrc"] == zlib.crc32(got_shard).to_bytes(
                4, "little") and attrs["_pos"] == (2).to_bytes(
                4, "little", signed=True),
                f"recovery: {oid}'s _hcrc or _pos")
        # stored parity of 16 objects against the native C++ backend
        native = factory(f"plugin=isa k={K} m={M} technique=reed_sol_van")
        require(getattr(native, "independent", False) is True,
                f"isa gave {type(native).__name__}, not the native backend")
        t0 = time.perf_counter()
        for oid in oids[:PG_NATIVE_OBJS]:
            data = np.frombuffer(bytes(mirror[oid]), dtype=np.uint8
                                 ).reshape(stripes, K, OBJ_C)
            held = {p: np.frombuffer(cl.osds[pg.acting[p]].store.read(
                "1.0", oid), dtype=np.uint8).reshape(stripes, OBJ_C)
                for p in (K, K + 2)}
            for s in range(stripes):
                par = native.encode_chunks(data[s])
                for p, arr in held.items():
                    require(np.array_equal(par[p - K], arr[s]),
                            f"native: stripe {s} parity {p} of {oid}")
        host_s["native_check"] = time.perf_counter() - t0

        # -- 33. one shard of 16 objects corrupted: scrub, repair ---------
        pg = cl.primary()
        bad, saved = {}, {}
        live = [p for p in range(K + M) if pg.acting[p] >= 0]
        # half from the first objects written, half from the last read
        # (resident in the primary's cache): deep scrub reads the stored
        # shards either way
        half = PG_SCRUB_OBJS // 2
        for i, oid in enumerate(oids[:half] + oids[-half:]):
            pos = live[int(rng.integers(0, K))] if i % 2 == 0 else \
                (K, K + 2)[i // 2 % 2]
            obj = cl.osds[pg.acting[pos]].store._obj("1.0", oid)
            saved[oid] = (pos, bytes(obj.data))
            obj.data[int(rng.integers(0, len(obj.data)))] ^= 0x5A
            bad[oid] = pos
        rec["scrub_resident_corrupted"] = len(
            resident_oids(cl.osds[pg.osd.whoami]) & set(bad))
        require(rec["scrub_resident_corrupted"] > 0,
                "scrub: no corrupted object is resident")
        sp0 = scrub_mod.SCRUB_PERF.dump()
        log.label = "scrub"
        report = await timed("scrub_deep",
                             pg.scrubber.scrub(deep=True))
        flagged = {e.split(":")[0] for e in report["errors"]}
        require(flagged == set(bad) and report["objects"] == PG_OBJS,
                f"scrub: flagged {sorted(flagged)}")
        log.drain("pg scrub")
        log.label = "repair"
        fixed = await timed("repair", pg.scrubber.repair())
        log.drain("pg repair")
        for oid, pos in bad.items():
            want = f"{oid}: shard {pos} identified corrupt on " \
                   f"osd.{pg.acting[pos]}"
            require(want in fixed["errors_before"],
                    f"repair: no culprit line for {oid} (position {pos})")
            require(cl.osds[pg.acting[pos]].store.read("1.0", oid) ==
                    saved[oid][1], f"repair: {oid}'s shard not restored")
        require(fixed["repaired"] == PG_SCRUB_OBJS and
                fixed["errors_after"] == [], f"repair: {fixed['repaired']}"
                f" repaired, after {fixed['errors_after'][:3]}")
        sp1 = scrub_mod.SCRUB_PERF.dump()
        rec["scrub_perf"] = {k: sp1.get(k, 0) - sp0.get(k, 0) for k in (
            "device_crc_jobs", "device_crc_rows", "host_crc_objects",
            "device_crc_failures")}
        n_live = len(pg.live_acting())
        require(rec["scrub_perf"]["device_crc_jobs"] == 3 * (n_live + 1)
                and rec["scrub_perf"]["host_crc_objects"] == 0,
                f"scrub: {rec['scrub_perf']} for {n_live} live shards "
                f"(one job per sweep and per deep check)")
        f = cl.osds[pg.acting[K]]
        smap = {o: json.loads(b) for o, b in
                scrub_mod.build_scrub_map(f.pgs["1.0"]).items()}
        for oid in oids:
            require(smap[oid]["digest"] == zlib.crc32(
                f.store.read("1.0", oid)), f"scrub map: {oid}'s digest")
        got = await ops_all(cl, reads(list(bad)), "read after repair")
        check_reads(got, list(bad), "read after repair")
        log.drain("pg final reads")
        torch.cuda.synchronize()
        launches = log.real.launches

        rec["ec_agg"] = cl.perf_sum("ec_agg", ("batches", "ops", "stripes",
                                               "bypass") + PG_RINGS_AGG)
        rec["ec_read_agg"] = cl.perf_sum(
            "ec_read_agg", ("batches", "ops", "stripes", "bypass") +
            PG_RINGS_READ_AGG)
        rec["residency"] = cl.perf_sum("ec_resident", (
            "hits", "misses", "evictions", "invalidations"))
        rec["wire"] = cl.wire()
        rec["up_thru_grants"] = cl.monc.grants
        rec["epoch"] = cl.osdmap.epoch
        rec["acting_final"] = cl.primary().acting
        for name, keys in (("ec_agg", PG_RINGS_AGG),
                           ("ec_read_agg", PG_RINGS_READ_AGG)):
            rungs = {k: rec[name][k] for k in keys}
            require(not any(rungs.values()), f"{name} rungs {rungs}")
        require(rec["scrub_perf"]["device_crc_failures"] == 0,
                "scrub: a device CRC job failed")
        require(card_failures() == failures0,
                "a recovery rebuild failed on the card")
        await cl.stop()
        # -- 34. the breakdown, on a healthy PG of its own (off the path)
        log.label = "breakdown"
        rec["breakdown"] = await pg_write_breakdown(
            mods, profile, config, rng, 16, 128)
        log.drain("pg breakdown")
        return launches

    mirror = {oid: bytearray(rng.integers(0, 256, OBJ_SIZE,
                                          dtype=np.uint8).tobytes())
              for oid in oids}
    with GfLaunchLog(kernels) as log:
        launches = asyncio.run(run(log))

    # -- the kernel at the PG path's shapes --------------------------------
    from ceph_tpu_torch.bench.gf_kernel_bench import device_ms
    ec = factory(f"plugin=jax k={K} m={M} technique=reed_sol_van")
    bm, plan = ec._encode_kernel.bitmatrix, ec._encode_kernel.plan
    widths = {}
    for b in (stripes, 1):
        x = random_bytes((b, K, OBJ_C), SEED + 8 + b)
        nbytes, ops = roofline.gf_encode_work(b, K, M, OBJ_C)
        bound_s, bound_by = roofline.bound_seconds(nbytes, ops, spec)
        widths[f"{b}x{K}x{OBJ_C}"] = {
            "planned_kernel_device_ms": device_ms(
                lambda: kernels.encode_batch_planned(plan, x), 200),
            "plain_ms": events_ms(lambda: kernels.gf_encode_plain(bm, x),
                                  5),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": nbytes}
    logical = PG_OBJS * OBJ_SIZE
    record = {
        "card": card,
        "profile": "plugin=jax k=8 m=3 technique=reed_sol_van "
                   f"stripe_unit={OBJ_C}",
        "osds": PG_OSDS, "pool_size": K + M, "pool_min_size": K + 1,
        "objects": PG_OBJS, "object_bytes": OBJ_SIZE,
        "resident_budget": OBJ_RESIDENT_BYTES,
        "rmw_ops": PG_RMW_OPS, "host_s": host_s,
        "write_GiBs": logical / host_s["write"] / gib,
        "rmw_4k_ops_per_s": PG_RMW_OPS / host_s["rmw"],
        "read_GiBs": logical / host_s["read"] / gib,
        "read_resident_GiBs": RESIDENT_OBJS * OBJ_SIZE /
        host_s["read_resident"] / gib,
        "degraded_read_GiBs": logical / host_s["read_degraded"] / gib,
        "recovery_GiBs": PG_OBJS * stripes * OBJ_C / host_s["recovery"] /
        gib,
        "scrub_s": host_s["scrub_deep"], "repair_s": host_s["repair"],
        "gf_encode": {"launches": launches,
                      "by_operation": log.launches,
                      "cuda_event_ms_by_operation": log.ms,
                      "shapes_by_operation": log.shapes,
                      "checked_against_plain": log.checked,
                      "max_abs_err": log.worst, "widths": widths},
        **rec,
        "phase_s": time.perf_counter() - t_phase,
    }
    require(launches > 0 and log.launches.get("write") == PG_OBJS,
            f"pg path: {launches} launches, write "
            f"{log.launches.get('write')}")
    print("ec_pg_path: " + json.dumps(record))
    return launches, log.worst


# -- the OSD daemon and the dev cluster (osd_cluster_path) -------------------
# An erasure-coded RBD deployment as Ceph documents it: a k=8 m=3 data pool
# and a replicated size-3 pool for the image metadata (`rbd create
# --data-pool`), on 12 OSD daemons (one per host) under three mons, one
# process per daemon as a deployment runs them (`ceph-osd` per process).
CL_MONS, CL_OSDS = 3, 12
# mon_target_pg_per_osd 100 x 12 OSDs / 11 shards is 128; cut to 32, as
# clean took over 60 s on the card's host at 128 (PERF.md section 4)
CL_EC_PGS = 32
CL_REP_PGS = 32
# rados bench -b 4M; RBD headers. rados bench's 128 objects cut to 64 for
# the smoke's time limit (PERF.md section 4)
CL_OBJS, CL_HDRS, CL_HDR = 64, 128, 4096
CL_INFLIGHT = 16                            # rados bench -t 16
CL_RMW, CL_DEG_RMW = 256, 64                # 4 KiB overwrites
CL_CORRUPT = 16
CL_KILL = (2, 9)      # hard-stopped; the first revives, the second goes out
CL_DEADLINE = 300.0   # the longest wait on any one step (an upper bound)
# `pg repair` is asked of a PG at most this often, each ask waited on up
# to CL_REPAIR_WAIT s for the primary's repair scrub to report
CL_REPAIR_ASKS, CL_REPAIR_WAIT = 3, 60.0
CL_LOG = "build/osd_cluster_path.log"   # the daemons' own output
CHILD_SCRIPT = __file__                         # what each daemon runs
# over the proc backend's timers (vstart's DEFAULT_CFG with PROC_CFG)
CL_CONFIG = {"osd_ec_resident_bytes": OBJ_RESIDENT_BYTES,
             # the cell's own `osd out` (step 46) is the out: no auto-out
             # of the hard-stopped OSDs while the cell reads degraded
             "mon_osd_down_out_interval": 600.0}


class StepLaunchLog(LaunchLog):
    """``LaunchLog`` with every launch filed under the current ``label``
    (its count, lanes and CUDA-event ms by step)."""

    def __init__(self, kernels):
        super().__init__(kernels)
        self.label = None
        self.n = 0
        self.by_label = {}

    def launch(self, pt, xs, numrep):
        self.main = self.label or "unlabelled"
        self.n += 1
        return super().launch(pt, xs, numrep)

    def drain(self, what: str) -> None:
        for _pt, xs, _nr, _lv, _bad, start, end, label in self.pending:
            end.synchronize()
            ent = self.by_label.setdefault(label, {"launches": 0,
                                                   "lanes": 0, "ms": 0.0})
            ent["launches"] += 1
            ent["lanes"] += int(xs.shape[0])
            ent["ms"] += start.elapsed_time(end)
        super().drain(what)


class FlushLog:
    """Every flush of an OSD's ``ECAggregator`` and ``ECReadAggregator``:
    its ops, stripes and distinct PGs (each ``ECPG`` owns its own plugin
    instance, so the plugins an op batch came from are its PGs), filed
    under the current ``label`` as ``rows[kind][label]``."""

    def __init__(self):
        from ceph_tpu_torch.osd import ec_aggregator, ec_read_aggregator
        self.classes = (ec_aggregator.ECAggregator,
                        ec_read_aggregator.ECReadAggregator)
        self.label = None
        self.owner = {}
        self.rows = {}
        self.saved = []

    def __enter__(self):
        agg, ragg = self.classes
        owner = self.owner
        enc, dec = agg.encode, ragg.decode

        async def encode(this, ec, data, with_crc=False):
            data = np.ascontiguousarray(data, dtype=np.uint8)
            owner[id(data)] = id(ec)
            try:
                return await enc(this, ec, data, with_crc)
            finally:
                owner.pop(id(data), None)

        async def decode(this, ec, want, avail, chunks, charge_bytes=0):
            chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
            owner[id(chunks)] = id(ec)
            try:
                return await dec(this, ec, want, avail, chunks,
                                 charge_bytes)
            finally:
                owner.pop(id(chunks), None)

        def flusher(cls, kind, field):
            real = cls._flush

            def _flush(this, key, g, trigger):
                if g.entries:
                    arrs = [getattr(e, field) for e in g.entries]
                    self.rows.setdefault(kind, {}).setdefault(
                        str(self.label), []).append(
                        [len(arrs), sum(int(a.shape[0]) for a in arrs),
                         len({owner.get(id(a)) for a in arrs})])
                return real(this, key, g, trigger)
            return real, _flush

        self.saved = [(agg, "encode", enc), (ragg, "decode", dec)]
        agg.encode, ragg.decode = encode, decode
        for cls, kind, field in ((agg, "ec_agg", "data"),
                                 (ragg, "ec_read_agg", "chunks")):
            real, fl = flusher(cls, kind, field)
            self.saved.append((cls, "_flush", real))
            cls._flush = fl
        return self

    def __exit__(self, *exc):
        for cls, name, real in self.saved:
            setattr(cls, name, real)


def flush_summary(rows: dict) -> dict:
    """``FlushLog.rows`` (merged over daemons) -> per kind and step:
    flushes, ops and stripes, their means per flush, and the distinct
    PGs per flush (mean, max, and how many flushes held more than one)."""
    out = {}
    for kind, by_label in sorted(rows.items()):
        for label, rs in sorted(by_label.items()):
            pgs = [r[2] for r in rs]
            out.setdefault(kind, {})[label] = {
                "flushes": len(rs), "ops": sum(r[0] for r in rs),
                "stripes": sum(r[1] for r in rs),
                "ops_per_flush": sum(r[0] for r in rs) / len(rs),
                "stripes_per_flush": sum(r[1] for r in rs) / len(rs),
                "distinct_pgs_per_flush": sum(pgs) / len(pgs),
                "max_distinct_pgs": max(pgs),
                "flushes_with_many_pgs": sum(p > 1 for p in pgs)}
    return out


def proc_child(argv: list) -> None:
    """A daemon of the ``osd_cluster_path`` or ``rbd_path`` cluster, in a
    process of its own (``chip_smoke.py --proc-child`` +
    ``ceph_tpu_torch.cluster.proc``'s arguments). It runs the port's
    child entry point with the phase's hooks around both kernels and both
    aggregators, and adds ``smoke *`` verbs to the daemon's admin socket:
    the step label, the launches held against their plain versions,
    counters, the tracked table, a shard's bytes, every EC shard with
    its stamps and last writes, a deep scrub of the PGs it leads, and for
    a mgr its balancer ticks, promotions and demotions and its
    prometheus port."""
    import os
    # seconds from the parent's spawn (its wall clock, passed down)
    t_start = float(os.environ.get("CHIP_SMOKE_SPAWNED", time.time()))
    from ceph_tpu_torch.cluster import proc
    from ceph_tpu_torch.crush import kernels as ckern
    from ceph_tpu_torch.gf import kernels as gkern
    from ceph_tpu_torch.mon.monitor import Monitor
    from ceph_tpu_torch.os_.objectstore import Transaction
    from ceph_tpu_torch.osd import daemon, ec_pg as ec_pg_mod
    from ceph_tpu_torch.osd import pg as pg_mod
    from ceph_tpu_torch.osd import scheduler as sched_mod
    from ceph_tpu_torch.osd import scrub as scrub_mod
    from ceph_tpu_torch.osd.recovery import PERF as RECOVERY_PERF
    from ceph_tpu_torch.utils.devmon import devmon

    pushes = {"bytes": 0, "objects": 0}
    real_push = pg_mod.PG.apply_push

    def apply_push(pg, m):
        ok = real_push(pg, m)
        if ok:
            pushes["bytes"] += len(m.data)
            pushes["objects"] += 1
        return ok
    pg_mod.PG.apply_push = apply_push
    # the last writes of every EC shard this daemon holds, by (pg, oid):
    # what wrote it (a sub-write, a push, an in-place rebuild), when, in
    # which interval and slot, and the position and version it stamped
    writes = {}
    ECPG = ec_pg_mod.ECPG

    def wrote(pg, oid, kind, pos, ver, src):
        hist = writes.setdefault((str(pg.cid), oid), [])
        hist.append([round(time.time() - t_start, 3), kind, pg.epoch,
                     pg.interval_start, pg.my_shard(), pos, ver, src])
        del hist[:-6]
    real_sub_write, real_ec_push = ECPG._apply_sub_write, ECPG.apply_push
    real_rebuild = ECPG._rebuild_shard

    def sub_write(pg, m, local=False):
        out = real_sub_write(pg, m, local)
        if out == 0 and not m.remove:
            wrote(pg, m.oid, "sub_write", ECPG._pos_of(m.attrs),
                  m.attrs["_v"].hex(), [m.epoch, m.first_stripe,
                                        len(m.data) // pg.sinfo.chunk_size])
        return out

    def ec_push(pg, m):
        ok = real_ec_push(pg, m)
        if ok and m.exists:
            wrote(pg, m.oid, "push", ECPG._pos_of(m.attrs),
                  m.attrs["_v"].hex(), [m.epoch, m.from_osd])
        return ok

    async def rebuild(pg, oid, shard, ver, size, apply_local=False,
                      exclude_osds=frozenset()):
        out = await real_rebuild(pg, oid, shard, ver, size, apply_local,
                                 exclude_osds)
        if apply_local:
            landed = pg._stamps(oid) == (ec_pg_mod._vblob(ver),
                                         ECPG._pos_attr(shard))
            wrote(pg, oid, "rebuilt_in_place" if landed else
                  "rebuild_dropped", shard, ec_pg_mod._vblob(ver).hex(),
                  sorted(exclude_osds))
        return out
    ECPG._apply_sub_write, ECPG.apply_push = sub_write, ec_push
    ECPG._rebuild_shard = rebuild
    logs = {}
    lag = {"max_s": 0.0, "at": None, "over_half_s": 0, "worst": [],
           "by_step": {}}
    # the stores' fsyncs (WALStore and the mons' store sync each commit)
    fsyncs = {"n": 0, "s": 0.0, "max_s": 0.0}
    real_fsync = os.fsync

    def fsync(fd):
        t0 = time.perf_counter()
        real_fsync(fd)
        dt = time.perf_counter() - t0
        fsyncs["n"] += 1
        fsyncs["s"] += dt
        fsyncs["max_s"] = max(fsyncs["max_s"], dt)
    os.fsync = fsync

    beat = {"t": time.monotonic()}

    def stall_stacks(main_id):
        """Print the loop thread's stack once a stall passes 1 s (and
        again at 5 s), so the log says what held every loop at once."""
        import traceback
        shown = set()
        while True:
            time.sleep(0.2)
            t, late = beat["t"], time.monotonic() - beat["t"]
            for at in (1.0, 5.0):
                if late > at and (t, at) not in shown:
                    shown.add((t, at))
                    frame = sys._current_frames().get(main_id)
                    stack = "".join(traceback.format_stack(frame)[-14:])
                    print(f"[stall] pid {os.getpid()} {late:.1f} s at "
                          f"{time.time() - t_start:.1f} s, step "
                          f"{logs['gf'].label}:\n{stack}", flush=True)

    async def lag_monitor():
        """This process's event-loop stalls: what a heartbeat or a lease
        sees when the daemon's loop is busy."""
        import threading
        threading.Thread(target=stall_stacks, args=(threading.get_ident(),),
                         daemon=True).start()
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            beat["t"] = time.monotonic()
            await asyncio.sleep(0.05)
            late = loop.time() - t0 - 0.05
            lag["over_half_s"] += late > 0.5
            step = str(logs["gf"].label)
            lag["by_step"][step] = max(lag["by_step"].get(step, 0.0), late)
            if late > lag["max_s"]:
                lag["max_s"], lag["at"] = late, logs["gf"].label
            if late > 0.5:
                lag["worst"] = sorted(lag["worst"] + [
                    [round(late, 3), logs["gf"].label,
                     round(time.time() - t_start, 1)]], reverse=True)[:4]

    def register(asok, name, fn):
        """``asok.register`` with a failing verb's traceback returned as
        its answer (the parent raises it) instead of a dropped socket."""
        import traceback

        def run(*a):
            try:
                out = fn(*a)
            except Exception:
                return {"error": traceback.format_exc()}
            if not asyncio.iscoroutine(out):
                return out

            async def waited():
                try:
                    return await out
                except Exception:
                    return {"error": traceback.format_exc()}
            return waited()
        asok.register(name, (lambda cmd: run(cmd)) if
                      fn.__code__.co_argcount else (lambda: run()),
                      "osd_cluster_path probe")

    def common(asok, ready_s):
        def label(cmd):
            for lg in logs.values():
                lg.label = cmd["label"]
            return {"label": cmd["label"]}

        def drain():
            g, c = logs["gf"], logs["crush"]
            g.drain("osd cluster child")
            c.drain("osd cluster child")
            return {"gf": {"launches": g.real.launches,
                           "by_step": g.launches, "ms_by_step": g.ms,
                           "checked": g.checked, "worst": g.worst},
                    "crush": {"launches": c.real.launches,
                              "by_step": c.by_label, "checked": c.checked,
                              "worst": c.worst},
                    "flushes": logs["flush"].rows, "pushes": pushes}
        register(asok, "smoke label", label)
        register(asok, "smoke drain", drain)
        asyncio.ensure_future(lag_monitor())
        return {"ready_s": ready_s}

    # every repair scrub this daemon ran, by PG: what a `pg repair` the
    # parent sent came to (a request that found the PG not primary and
    # active, or that left errors, is asked again)
    repairs = {}
    real_repair = scrub_mod.Scrubber.repair

    async def repair(scrubber):
        out = await real_repair(scrubber)
        repairs.setdefault(str(scrubber.pg.pgid), []).append({
            "repaired": out["repaired"],
            "errors_before": len(out["errors_before"]),
            "errors_after": len(out["errors_after"]),
            "refused": out["errors_before"] == ["not primary+active"],
            "state": scrubber.pg.state, "epoch": scrubber.pg.epoch,
            "label": logs["gf"].label,
            # what a repair found and left, in the scrub's own words
            "found": out["errors_before"][:16],
            "left": out["errors_after"][:8]})
        return out
    scrub_mod.Scrubber.repair = repair
    real_boot, real_start = daemon.OSD.boot, Monitor.start

    async def boot(osd, *a, **kw):
        await real_boot(osd, *a, **kw)
        ready_s = time.time() - t_start
        base = common(osd.asok, ready_s)

        def stats():
            pgs = list(osd.pgs.values())
            return {**base,
                    "wire": [osd.msgr.wire, osd.hb_msgr.wire],
                    "devices": sorted({str(osd.device),
                                       str(osd.ec_resident.device),
                                       str(osd.monc.device)} |
                                      {str(pg.ec.device) for pg in pgs
                                       if hasattr(pg, "ec")}),
                    "ec_agg": osd.ec_agg.perf.dump(),
                    "ec_read_agg": osd.ec_read_agg.perf.dump(),
                    "ec_resident": osd.ec_resident.perf.dump(),
                    "recovery": RECOVERY_PERF.dump(),
                    "scrub": scrub_mod.SCRUB_PERF.dump(),
                    "qos": sched_mod.QOS_PERF.dump(),
                    "overload": daemon.OVERLOAD_PERF.dump(),
                    "first_launches": devmon().functions,
                    "max_reserved_MiB":
                        torch.cuda.max_memory_reserved(osd.device) / 2**20
                        if osd.device.type == "cuda" else 0,
                    "loop_lag": dict(lag), "fsync": dict(fsyncs)}

        def table():
            mm = osd.monc.mapping_table
            return {"epoch": mm.epoch, "map_epoch": osd.osdmap.epoch,
                    "pools": {str(p): {t: getattr(mm._pools[p], t).tolist()
                                       for t in TABLES}
                              for p in mm._pools}}

        def shard(cmd):
            data = bytes(osd.store.read(cmd["cid"], cmd["oid"]))
            return {"crc": zlib.crc32(data), "len": len(data)}

        def epoch():
            return {"epoch": osd.osdmap.epoch if osd.osdmap else -1,
                    "primary_not_clean": sorted(
                        k for k, pg in osd.pgs.items()
                        if pg.is_primary() and pg.state != "clean")}

        def shards():
            """Every EC shard here: its bytes' crc32 and length, its
            ``_pos`` and ``_v`` stamps and its last writes, by PG, with
            the PG's acting set, this OSD's slot and the PG's state."""
            out = {}
            for cid, pg in osd.pgs.items():
                if not isinstance(pg, ECPG):
                    continue
                objs = {}
                for oid in osd.store.list_objects(pg.cid):
                    if oid == pg_mod.PGMETA:
                        continue
                    data = bytes(osd.store.read(pg.cid, oid))
                    attrs = osd.store.getattrs(pg.cid, oid)
                    objs[oid] = {"crc": zlib.crc32(data), "len": len(data),
                                 "pos": ECPG._pos_of(attrs),
                                 "v": attrs.get("_v", b"").hex(),
                                 "hist": writes.get((str(pg.cid), oid), [])}
                posfix = getattr(pg, "_posfix_task", None)
                out[str(cid)] = {"acting": list(pg.acting),
                                 "slot": pg.my_shard(), "state": pg.state,
                                 "epoch": pg.epoch,
                                 "interval": pg.interval_start,
                                 "posfix_running": posfix is not None and
                                 not posfix.done(), "objects": objs}
            return out

        async def deep_scrub():
            """A deep scrub of every EC PG this OSD is primary of, one
            after another: the errors each found."""
            out = {}
            for cid, pg in sorted(osd.pgs.items()):
                if isinstance(pg, ECPG) and pg.is_primary():
                    res = await pg.scrubber.scrub(deep=True)
                    out[str(cid)] = res["errors"]
            return out

        def corrupt(cmd):
            cid, oid, off = cmd["cid"], cmd["oid"], int(cmd["offset"])
            data = bytes(osd.store.read(cid, oid))
            # a write under the store's own checksum: the bytes change
            # and nothing above the store learns of it
            osd.store.queue_transaction(Transaction().write(
                cid, oid, off, bytes([data[off] ^ 0x5A])))
            return {"crc": zlib.crc32(data), "len": len(data)}
        for name, fn in (("smoke stats", stats), ("smoke table", table),
                         ("smoke shard", shard),
                         ("smoke corrupt", corrupt),
                         ("smoke shards", shards),
                         ("smoke deep_scrub", deep_scrub),
                         ("smoke epoch", epoch),
                         ("smoke repairs", lambda: repairs)):
            register(osd.asok, name, fn)

    # every election this mon won: its epoch, quorum and second, so a
    # split (two mons winning one epoch) shows after it has healed; and
    # its paxos collect and begin timeouts
    wins = []
    real_win = Monitor.win_election

    async def win_election(mon, epoch, quorum):
        wins.append([epoch, sorted(quorum), round(time.time() - t_start, 3)])
        await real_win(mon, epoch, quorum)
    Monitor.win_election = win_election
    timeouts = PaxosTimeouts()
    slow_cmds = []
    real_cmd = Monitor.handle_command

    async def handle_command(mon, cmd, *a, **kw):
        t0 = time.perf_counter()
        try:
            return await real_cmd(mon, cmd, *a, **kw)
        finally:
            dt = time.perf_counter() - t0
            if dt > 0.2 and len(slow_cmds) < 64:
                slow_cmds.append([str(cmd.get("prefix")), round(dt, 4),
                                  logs["gf"].label])
    Monitor.handle_command = handle_command

    async def start(mon, *a, **kw):
        await real_start(mon, *a, **kw)
        base = common(mon.asok, time.time() - t_start)
        register(mon.asok, "smoke stats", lambda: {
            **base, "wire": [mon.msgr.wire], "devices": [str(mon.device)],
            "election_epoch": mon.elector.epoch, "wins": wins,
            "paxos_timeouts": timeouts.n,
            "leader": mon.is_leader(), "quorum": list(mon.quorum),
            "state": mon.state, "paxos": {
                "active": mon.paxos.active, "pn": mon.paxos.pn,
                "accepted_pn": mon.paxos.accepted_pn,
                "last_committed": mon.paxos.last_committed},
            "first_launches": devmon().functions, "loop_lag": dict(lag),
            "fsync": dict(fsyncs), "slow_commands": slow_cmds})
    # the mgr: every balancer tick's outcome, and each promotion and
    # demotion (a failover the phase did not ask for shows here)
    from ceph_tpu_torch.mgr import daemon as mgr_daemon
    from ceph_tpu_torch.mgr import modules as mgr_modules
    ticks, moves = [], {"promote": 0, "demote": 0}
    real_tick = mgr_modules.BalancerModule.tick

    async def balancer_tick(mod):
        out = "cancelled"
        try:
            await real_tick(mod)
            out = mod.last_changes
        except Exception as e:
            out = f"{type(e).__name__}: {e}"
            raise
        finally:
            ticks.append([time.time(), out, logs["gf"].label])
    mgr_modules.BalancerModule.tick = balancer_tick
    module_ticks = {}
    real_loop = mgr_daemon.Mgr._module_loop

    async def module_loop(mgr, mod):
        # each module's ticks, counted as they end (wrapped once, at the
        # module's first promotion)
        if "tick" not in vars(mod):
            real_mod_tick = mod.tick

            async def tick():
                await real_mod_tick()
                module_ticks[mod.NAME] = module_ticks.get(mod.NAME, 0) + 1
            mod.tick = tick
        await real_loop(mgr, mod)
    mgr_daemon.Mgr._module_loop = module_loop
    real_promote, real_demote = mgr_daemon.Mgr.promote, mgr_daemon.Mgr.demote

    async def promote(mgr):
        was = mgr.active
        await real_promote(mgr)
        moves["promote"] += mgr.active and not was

    def demote(mgr):
        was = mgr.active
        real_demote(mgr)
        moves["demote"] += was and not mgr.active
    mgr_daemon.Mgr.promote, mgr_daemon.Mgr.demote = promote, demote
    real_mgr_start = mgr_daemon.Mgr.start

    async def mgr_start(mgr, *a, **kw):
        await real_mgr_start(mgr, *a, **kw)
        base = common(mgr.asok, time.time() - t_start)

        def stats():
            prom = next((m for m in mgr.modules
                         if m.NAME == "prometheus"), None)
            return {**base, "name": mgr.name, "gid": mgr.gid,
                    "active": mgr.active, "moves": dict(moves),
                    "devices": sorted({str(mgr.device),
                                       str(mgr.monc.device)}),
                    "balancer_ticks": list(ticks),
                    "module_ticks": dict(module_ticks),
                    "prometheus_port": prom.port if prom else None,
                    "table": {"epoch": mgr._mapping.epoch,
                              "pools": sorted(mgr._mapping._pools)},
                    "wire": [mgr.monc.msgr.wire],
                    "first_launches": devmon().functions,
                    "loop_lag": dict(lag), "fsync": dict(fsyncs)}
        register(mgr.asok, "smoke stats", stats)
    mgr_daemon.Mgr.start = mgr_start
    # the MDS: seconds from the spawn to its first beacon (``ready_s``),
    # its ``create`` (connect, warm-up op) and its state; the proc backend
    # builds its admin socket after ``start_ha``, so the verbs go on there
    from ceph_tpu_torch.cephfs import mds as mds_mod
    from ceph_tpu_torch.utils import admin_socket as asok_mod
    mds_seen = {}
    real_mds_create = mds_mod.MDSDaemon.create.__func__

    async def mds_create(cls, *a, **kw):
        t0 = time.time()
        out = await real_mds_create(cls, *a, **kw)
        mds_seen["create_s"] = time.time() - t0
        return out
    mds_mod.MDSDaemon.create = classmethod(mds_create)
    real_start_ha = mds_mod.MDSDaemon.start_ha

    async def start_ha(mds, *a, **kw):
        out = await real_start_ha(mds, *a, **kw)
        mds_seen.update(mds=mds, ready_s=time.time() - t_start)
        return out
    mds_mod.MDSDaemon.start_ha = start_ha
    real_asok_start = asok_mod.AdminSocket.start

    async def asok_start(asok):
        mds = mds_seen.get("mds")
        if mds is not None and \
                os.path.basename(asok.path) == f"mds.{mds.name}.asok":
            base = common(asok, mds_seen["ready_s"])
            register(asok, "smoke stats", lambda: {
                **base, "name": mds.name, "gid": mds.gid,
                "state": mds.state, "rank": mds.rank,
                "create_s": mds_seen["create_s"],
                "devices": sorted({str(mds.device), str(mds.monc.device)}),
                "perf": mds_mod.MDS_PERF.dump(),
                "wire": [mds.msgr.wire, mds.monc.msgr.wire],
                "first_launches": devmon().functions,
                "loop_lag": dict(lag), "fsync": dict(fsyncs)})
        await real_asok_start(asok)
    asok_mod.AdminSocket.start = asok_start
    daemon.OSD.boot, Monitor.start = boot, start
    with GfLaunchLog(gkern) as glog, StepLaunchLog(ckern) as clog, \
            FlushLog() as flog:
        logs.update(gf=glog, crush=clog, flush=flog)
        # a child (re)spawned in the middle of a phase starts under the
        # parent's current step, so its first launches are filed there
        for lg in logs.values():
            lg.label = os.environ.get("CHIP_SMOKE_LABEL")
        proc.main(argv)


async def bounded(inflight: int, fns) -> list:
    """Run every coroutine factory, ``inflight`` at a time (a client's
    ops in flight); their results in order."""
    sem = asyncio.Semaphore(inflight)

    async def one(fn):
        async with sem:
            return await fn()
    return await asyncio.gather(*[one(f) for f in fns])


def smoke_cluster(child_log, here: str, on_cpu=("mon.",), clients=()):
    """The port's ``ProcCluster`` with each child started through
    ``chip_smoke.py --proc-child`` (the hooks) and its output kept in
    ``child_log``. The children whose names start with one of ``on_cpu``
    run on the CPU, as on hosts of their own without the card (the conf's
    copy with device=cpu); the rest on the conf's device. ``clients`` are
    entity names whose keys the conf carries (provisioned as vstart
    provisions ``client.admin``)."""
    import os

    from ceph_tpu_torch.cluster.proc import ProcCluster

    class SmokeCluster(ProcCluster):
        smoke_label = None      # the parent's current step

        async def start(self):
            for name in clients:
                self.keyring.add(name)
            return await super().start()

        async def _exec(self, child):
            child.argv = [sys.executable, os.path.abspath(CHILD_SCRIPT),
                          "--proc-child"] + child.argv[3:]
            if child.name.startswith(on_cpu):
                with open(self.conf_path) as f:
                    doc = json.load(f)
                cpu_conf = f"{self.conf_path}.cpu"
                with open(cpu_conf, "w") as f:
                    json.dump(dict(doc, device="cpu"), f)
                at = child.argv.index("--conf") + 1
                child.argv[at] = cpu_conf
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (here, env.get("PYTHONPATH")) if p)
            env["CHIP_SMOKE_SPAWNED"] = repr(time.time())
            if self.smoke_label:
                env["CHIP_SMOKE_LABEL"] = self.smoke_label
            # one CPU thread per daemon for torch's and numpy's host ops
            env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
            # the mons and mgrs, which a deployment runs on hosts of
            # their own, keep their share of this one host's cores: the
            # OSDs run at a lower priority (nice 5)
            nice = 5 if child.name.startswith("osd.") else 0
            child.proc = await asyncio.create_subprocess_exec(
                *child.argv, env=env, stdout=child_log,
                stderr=subprocess.STDOUT,
                preexec_fn=(lambda: os.nice(nice)) if nice else None)
            child.started_at = asyncio.get_event_loop().time()
    return SmokeCluster


async def mon_records(c) -> dict:
    """Every mon's election record from its ``smoke stats``: state,
    quorum, election epoch, the epochs it won, its paxos round and
    timeouts, its slow commands and worst loop stall."""
    record = {}
    for n in sorted(n for n in c.children if n.startswith("mon.")):
        try:
            out = await asyncio.wait_for(
                c.daemon_command(n, "smoke stats"), 5)
        except (OSError, ValueError, asyncio.TimeoutError) as e:
            record[n] = {"unanswered": repr(e)}
            continue
        record[n] = {k: out.get(k) for k in (
            "state", "quorum", "election_epoch", "wins", "paxos",
            "paxos_timeouts", "slow_commands")}
        record[n]["stalls"] = (out.get("loop_lag") or {}).get("worst")
    return record


def split_epochs(wins) -> dict:
    """``wins``: (mon, epoch) pairs. Returns each epoch that two or more
    mons won, with the mons."""
    won = {}
    for name, epoch in wins:
        won.setdefault(int(epoch), []).append(name)
    return {e: ns for e, ns in sorted(won.items()) if len(ns) > 1}


def mon_summary(record: dict) -> dict:
    """The elections of ``mon_records``' record: how many the mons won,
    the epochs won by two mons, the collect and begin timeouts, each
    mon's election epoch, slow commands and worst loop stall."""
    wins = [(n, w[0]) for n, r in record.items()
            for w in r.get("wins") or []]
    timeouts = [r.get("paxos_timeouts") or {} for r in record.values()]
    return {
        "elections": len(wins),
        "split_epochs": split_epochs(wins),
        "collect_timeouts": sum(t.get("collect", 0) for t in timeouts),
        "begin_timeouts": sum(t.get("begin", 0) for t in timeouts),
        "election_epochs": {n: r.get("election_epoch")
                            for n, r in record.items()},
        "slow_commands": {n: r.get("slow_commands")
                          for n, r in record.items()},
        "stalls": {n: r.get("stalls") for n, r in record.items()}}


def require_one_winner(record: dict, summary: dict, card: str,
                       what: str) -> None:
    """The gate: no election epoch was won by two mons, read from each
    mon's ``wins`` (``mon_records``' ``record``, ``mon_summary``'s
    ``summary``); on a split every mon's record is printed."""
    if summary["split_epochs"]:
        print(f"[{card}] {what}: the mons: {json.dumps(record)}",
              flush=True)
    require(not summary["split_epochs"],
            f"{what}: epochs won by two mons: {summary['split_epochs']}")


async def one_winner_per_epoch(c, card: str, what: str) -> dict:
    """``require_one_winner`` on ``c``'s mons now; returns
    ``mon_summary``."""
    record = await mon_records(c)
    summary = mon_summary(record)
    require_one_winner(record, summary, card, what)
    return summary


STARTS = []     # every ``start_cluster`` record of this process, in turn


async def start_cluster(c, timed, card: str, what: str) -> dict:
    """Starts ``c`` (the step ``start``) and returns the start's record
    (``mon_summary``, the start's seconds and whether it started),
    printed on a line of its own and kept in ``STARTS``. A start that
    fails prints every mon's record and raises; so does one in which two
    mons won one election epoch. Nothing is started again."""
    t0 = time.perf_counter()
    failed = None
    try:
        await timed("start", c.start())
    except Exception as e:
        failed = e
    seconds = time.perf_counter() - t0
    record = await mon_records(c)
    start = dict(mon_summary(record), what=what, s=seconds,
                 ok=failed is None)
    STARTS.append(start)
    print(f"[{card}] {what} start: {json.dumps(start)}", flush=True)
    if failed is not None:
        print(f"[{card}] {what}: the start failed; the mons: "
              f"{json.dumps(record)}", flush=True)
        raise failed
    require_one_winner(record, start, card, what)
    return start


def shard_crcs(objs: dict, device: str) -> dict:
    """oid -> the crc32 of each of the K + M shards of its bytes under
    the pool's k=8 m=3 ``reed_sol_van`` code, the parity from
    ``gf_encode_plain`` (the kernel's plain version) on ``device``."""
    from ceph_tpu_torch.ec import matrix as rs
    from ceph_tpu_torch.gf import kernels as gkern
    from ceph_tpu_torch.gf import tables
    bm = torch.as_tensor(tables.expand_bitmatrix(
        rs.coding_matrix("reed_sol_van", K, M)), device=device)
    out = {}
    for oid, data in objs.items():
        stripes = np.frombuffer(bytearray(data), dtype=np.uint8).reshape(
            -1, K, OBJ_C)
        parity = gkern.gf_encode_plain(bm, torch.as_tensor(
            stripes, device=device)).cpu().numpy()
        out[oid] = [zlib.crc32(stripes[:, j].tobytes()) for j in range(K)] \
            + [zlib.crc32(parity[:, j].tobytes()) for j in range(M)]
    return out


def shard_audit(held: dict, want: dict, where: dict) -> list:
    """Every EC shard each OSD holds against the bytes its object's
    mirror gives: ``held`` maps an OSD's name to its ``smoke shards``
    answer, ``want`` an object to ``shard_crcs``, ``where`` an object to
    its PG. A shard is right when its ``_pos`` stamp is its holder's
    slot in the PG's acting set and its bytes are that position's; each
    slot of every object must hold one. Returns what is not, each with
    the holder's record (its last writes, the PG's state)."""
    found = []
    covered = {}
    for name, pgs in sorted(held.items()):
        for cid, pg in pgs.items():
            if pg["slot"] < 0:
                continue                # a stray's leftovers, not shards
            for oid, sh in pg["objects"].items():
                if oid not in want or where.get(oid) != cid:
                    continue
                crcs = want[oid]
                covered.setdefault((cid, oid), set()).add(pg["slot"])
                if pg["slot"] == sh["pos"] and crcs[sh["pos"]] == sh["crc"]:
                    continue
                found.append({
                    "osd": name, "pg": cid, "oid": oid, "slot": pg["slot"],
                    "pos": sh["pos"], "v": sh["v"], "len": sh["len"],
                    "bytes_of": [j for j, c in enumerate(crcs)
                                 if c == sh["crc"]],
                    "hist": sh["hist"], "acting": pg["acting"],
                    "state": pg["state"], "interval": pg["interval"],
                    "posfix_running": pg["posfix_running"]})
    for oid, cid in where.items():
        slots = covered.get((cid, oid), set())
        if slots != set(range(K + M)):
            found.append({"pg": cid, "oid": oid, "absent_slots": sorted(
                set(range(K + M)) - slots)})
    return found


def osd_cluster_path_phase(card: str, pool, start_only: bool = False) -> dict:
    """The OSD daemon and the dev cluster on the card (phases 41-48): a
    ``vstart`` cluster (the proc backend: one process per daemon) of three
    mons and twelve OSD daemons serves a ``rados``-bench-style client on
    a k=8 m=3 pool and a replicated pool. Returns the launches of both
    kernels on the path (every daemon's counts start at 0 with its
    process, the client's are set to 0 just before the cluster starts,
    and all are read as the daemons end) and the largest difference of
    any launch from its plain version. ``start_only``: the cluster is
    started, its start gated and recorded, and stopped; returns the
    start's record (``start_cluster``)."""
    import os

    from ceph_tpu_torch.crush import kernels as ckern
    from ceph_tpu_torch.osd.osdmap import STATE_UP
    from ceph_tpu_torch.utils.devmon import devmon

    rng = np.random.default_rng(SEED + 41)
    gib = 1 << 30
    host_s, rec = {}, {}
    mirror, hdrs = {}, {}
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.dirname(os.path.join(here, CL_LOG)), exist_ok=True)
    child_log = open(os.path.join(here, CL_LOG), "wb")

    SmokeCluster = smoke_cluster(child_log, here)

    async def timed(what, coro):
        t0 = time.perf_counter()
        out = await coro
        host_s[what] = time.perf_counter() - t0
        print(f"[{card}] osd_cluster_path {what}: {host_s[what]:.3f} s",
              flush=True)
        return out

    async def read_all(ec_io, what):
        got = await bounded(CL_INFLIGHT, [
            lambda o=o: ec_io.read(o, timeout=CL_DEADLINE) for o in mirror])
        for oid, data in zip(mirror, got):
            require(data == bytes(mirror[oid]),
                    f"{what}: {oid} differs from its mirror")

    async def overwrite(ec_io, n):
        oids = list(mirror)
        jobs = []
        for _ in range(n):
            oid = oids[int(rng.integers(0, len(oids)))]
            off = int(rng.integers(0, OBJ_SIZE // RMW_BYTES)) * RMW_BYTES
            data = rng.integers(0, 256, RMW_BYTES, dtype=np.uint8).tobytes()
            jobs.append((oid, off, data))
        # one object's ops keep their submission order (one PG, one
        # queue), so the mirror takes them in that order
        for oid, off, data in jobs:
            mirror[oid][off:off + RMW_BYTES] = data
        await bounded(CL_INFLIGHT, [
            lambda j=j: ec_io.write(j[0], j[2], offset=j[1],
                                    timeout=CL_DEADLINE) for j in jobs])

    async def wait_for(pred, what):
        t0 = time.perf_counter()
        while not await pred():
            require(time.perf_counter() - t0 < CL_DEADLINE,
                    f"osd cluster: {what} after {CL_DEADLINE} s")
            await asyncio.sleep(0.1)

    async def run(clog):
        clog.real.launches = 0
        clog.label = "start"
        c = SmokeCluster(n_mons=CL_MONS, n_osds=CL_OSDS, config=CL_CONFIG,
                         device="cuda")
        # daemon -> one `smoke drain` and one `smoke stats` per process
        # it ran as (a revived OSD is a second process)
        children, stats = {}, {}
        dead = set()

        async def ask(name, cmd):
            out = await c.daemon_command(name, cmd)
            require("error" not in out, f"osd cluster: {name} {cmd}: {out}")
            return out

        async def label(step):
            clog.label = step
            await asyncio.gather(*[ask(n, {"prefix": "smoke label",
                                           "label": step})
                                   for n in c.children if n not in dead])

        async def collect(names):
            # one daemon at a time: each drain runs the plain versions
            for n in names:
                stats.setdefault(n, []).append(await ask(n, "smoke stats"))
                children.setdefault(n, []).append(
                    await ask(n, "smoke drain"))

        async def up_osds() -> int:
            st = await c.client.status()
            return int(st.get("osdmap", {}).get("num_up_osds", -1))

        async def election_epochs():
            mons = [n for n in c.children if n.startswith("mon.")]
            outs = await asyncio.gather(*[ask(n, "smoke stats")
                                          for n in mons])
            return {n: o["election_epoch"] for n, o in zip(mons, outs)}

        try:
            rec["start"] = await start_cluster(c, timed, card,
                                               "osd_cluster_path")
            if start_only:
                return None
            await asyncio.gather(*[c.wait_for_daemon_ready(n, 120)
                                   for n in c.children])
            cl = c.client
            require(cl.monc.device.type == "cuda",
                    "osd cluster: the client is not on the card")
            elections0 = await election_epochs()
            events, epochs = [], []
            prev = {"up": None}

            async def on_map(om):
                up = (np.asarray(om.osd_state) & STATE_UP) != 0
                if prev["up"] is not None and len(prev["up"]) == len(up):
                    for o in np.flatnonzero(prev["up"] & ~up):
                        events.append(("down", int(o), om.epoch))
                    for o in np.flatnonzero(~prev["up"] & up):
                        events.append(("up", int(o), om.epoch))
                prev["up"] = up
                epochs.append(om.epoch)
            cl.monc.map_callbacks.append(on_map)
            # the client's one-PG lookups, by epoch (trouble 3)
            lookups = {}
            objecter = cl.objecter
            real_ct = objecter._calc_target

            def calc_target(osdmap, pool_id, oid):
                m0 = osdmap.mapping_cache_misses
                v0 = devmon().perf.dump()["launches_vm"]
                k0 = clog.n
                out = real_ct(osdmap, pool_id, oid)
                e = lookups.setdefault(str(osdmap.epoch), {
                    "lookups": 0, "memo_misses": 0, "vm_runs": 0,
                    "kernel_launches": 0})
                e["lookups"] += 1
                e["memo_misses"] += osdmap.mapping_cache_misses - m0
                e["vm_runs"] += devmon().perf.dump()["launches_vm"] - v0
                e["kernel_launches"] += clog.n - k0
                return out
            objecter._calc_target = calc_target

            # -- 41. the pools ------------------------------------------------
            await label("pools")
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd erasure-code-profile set", "name": "rbd_ec",
                 "profile": [f"k={K}", f"m={M}", "technique=reed_sol_van",
                             "crush-failure-domain=host",
                             f"stripe_unit={OBJ_C}"]})
            require(ret == 0, f"osd cluster: profile: {rs}")
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd pool create", "pool": "rbd_data",
                 "pg_num": CL_EC_PGS, "pool_type": "erasure",
                 "erasure_code_profile": "rbd_ec"})
            require(ret == 0, f"osd cluster: ec pool: {rs}")
            await cl.pool_create("rbd_meta", pg_num=CL_REP_PGS, size=3)

            async def has_pools():
                om = cl.monc.osdmap
                return om is not None and {"rbd_data", "rbd_meta"} <= {
                    p.name for p in om.pools.values()}
            await wait_for(has_pools, "the client's map lacks the pools")
            await timed("to_clean_after_create",
                        c.wait_for_clean(timeout=CL_DEADLINE))
            ec_io = await cl.open_ioctx("rbd_data")
            rep_io = await cl.open_ioctx("rbd_meta")

            # -- 42. write, read ----------------------------------------------
            for i in range(CL_OBJS):
                mirror[f"rbd_data.{i:04x}"] = bytearray(rng.integers(
                    0, 256, OBJ_SIZE, dtype=np.uint8).tobytes())
            for i in range(CL_HDRS):
                hdrs[f"rbd_header.{i:04x}"] = rng.integers(
                    0, 256, CL_HDR, dtype=np.uint8).tobytes()
            await label("write")
            await timed("write", bounded(CL_INFLIGHT, [
                lambda o=o: ec_io.write_full(o, bytes(mirror[o]),
                                             timeout=CL_DEADLINE)
                for o in mirror]))

            async def header(oid, data):
                await rep_io.write_full(oid, data, timeout=CL_DEADLINE)
                await rep_io.setxattr(oid, "rbd.features", b"\x01")
                await rep_io.set_omap(oid, "size", str(OBJ_SIZE).encode())
                await rep_io.set_omap(oid, "order", b"22")
            await timed("headers", bounded(CL_INFLIGHT, [
                lambda o=o, d=d: header(o, d) for o, d in hdrs.items()]))
            await label("read")
            await timed("read", read_all(ec_io, "read"))

            # -- 43. overwrites -----------------------------------------------
            await label("overwrite")
            await timed("overwrite", overwrite(ec_io, CL_RMW))

            # -- 44. two OSDs hard-stopped ------------------------------------
            await label("failure")
            victims = [f"osd.{o}" for o in CL_KILL]
            await collect(victims)      # their launches, checked, so far
            t0 = time.perf_counter()
            for n in victims:
                c.children[n].desired = "stopped"   # no respawn
                c.kill_daemon(n)
                dead.add(n)

            async def both_down():
                return await up_osds() == CL_OSDS - len(CL_KILL)
            await wait_for(both_down, "the stopped OSDs were not marked down")
            host_s["detect"] = time.perf_counter() - t0
            print(f"[{card}] osd_cluster_path detect: "
                  f"{host_s['detect']:.3f} s", flush=True)
            for n in victims:
                await c.children[n].proc.wait()

            # -- 45. degraded reads and overwrites ----------------------------
            await label("degraded_read")
            await timed("degraded_read", read_all(ec_io, "degraded read"))
            await label("degraded_overwrite")
            await timed("degraded_overwrite", overwrite(ec_io, CL_DEG_RMW))

            # -- 46. revive one, out the other; recovery ----------------------
            t0 = time.perf_counter()
            dead.discard(victims[0])
            await c._spawn(victims[0])
            await c.wait_for_daemon_ready(victims[0], CL_DEADLINE)
            host_s["revive"] = time.perf_counter() - t0
            await label("recovery")
            ret, rs, _ = await cl.mon_command({"prefix": "osd out",
                                               "id": CL_KILL[1]})
            require(ret == 0, f"osd cluster: osd out: {rs}")
            await c.wait_for_clean(timeout=CL_DEADLINE)
            host_s["to_clean"] = time.perf_counter() - t0
            print(f"[{card}] osd_cluster_path to_clean: "
                  f"{host_s['to_clean']:.3f} s", flush=True)

            # -- 47. corrupt 16 shards, pg repair -----------------------------
            await label("repair")

            # an operator repairs a settled cluster: every live OSD and
            # the client hold the mon's last map and every PG is clean,
            # so the acting sets read here are the ones the repairs see
            async def settled():
                st = await cl.status()
                want, pgmap = st["osdmap"]["epoch"], st["pgmap"]
                if cl.monc.osdmap.epoch != want or \
                        pgmap["states"].get("clean") != pgmap["num_pgs"]:
                    return False
                outs = await asyncio.gather(*[
                    ask(n, "smoke epoch") for n in c.children
                    if n.startswith("osd.") and n not in dead])
                return all(o["epoch"] == want and not o["primary_not_clean"]
                           for o in outs)
            t0 = time.perf_counter()
            await wait_for(settled, "the cluster did not settle")
            host_s["settle"] = time.perf_counter() - t0
            om = cl.monc.osdmap
            pid = ec_io.pool_id
            seeds = np.arange(CL_EC_PGS, dtype=np.uint32)
            _u, _up, acting, actp = om.pg_to_up_acting_osds(pid, seeds)
            acting, actp = np.asarray(acting), np.asarray(actp)
            where = {oid: f"{pid}.{real_ct(om, pid, oid)[0]:x}"
                     for oid in mirror}
            live_osds = [n for n in c.children
                         if n.startswith("osd.") and n not in dead]

            async def audit(what):
                """Every stored shard against the mirror's bytes for its
                slot, then a deep scrub of every EC PG (reading the
                stored shards): both must find nothing."""
                t1 = time.perf_counter()
                held = dict(zip(live_osds, await asyncio.gather(*[
                    ask(n, "smoke shards") for n in live_osds])))
                bad = shard_audit(held, want, where)
                t2 = time.perf_counter()
                scrubs = {}
                for out in await asyncio.gather(*[
                        ask(n, "smoke deep_scrub") for n in live_osds]):
                    scrubs.update(out)
                host_s[f"deep_scrub_{what}"] = time.perf_counter() - t2
                errors = {g: e for g, e in scrubs.items() if e}
                rec[f"audit_{what}"] = {
                    "shards": sum(len(o["objects"]) for pgs in held.values()
                                  for o in pgs.values()),
                    "bad": bad[:24], "n_bad": len(bad),
                    "audit_s": t2 - t1, "scrubbed_pgs": len(scrubs),
                    "deep_scrub_s": host_s[f"deep_scrub_{what}"],
                    "scrub_errors": {g: e[:6] for g, e in errors.items()}}
                print(f"[{card}] osd_cluster_path audit {what}: "
                      f"{json.dumps(rec[f'audit_{what}'])}", flush=True)
                require(not bad, f"osd cluster: {len(bad)} stored shards "
                                 f"differ from their slot's bytes ({what})")
                require(len(scrubs) == CL_EC_PGS and not errors,
                        f"osd cluster: deep scrub of {len(scrubs)} EC PGs "
                        f"found errors in {sorted(errors)} ({what})")
            want = shard_crcs(mirror, "cuda")
            await audit("after_recovery")
            picked = rng.choice(len(mirror), CL_CORRUPT, replace=False)
            pick = [(oid, real_ct(om, pid, oid)[0]) for oid in
                    [list(mirror)[int(i)] for i in sorted(picked)]]
            saved = {}
            for oid, seed in pick:
                pos = int(rng.integers(0, K + M))
                name = f"osd.{int(acting[seed][pos])}"
                cid = f"{pid}.{seed:x}"
                out = await ask(name, {"prefix": "smoke corrupt", "cid": cid,
                                       "oid": oid, "offset": int(
                                           rng.integers(0, OBJ_SIZE // K))})
                saved[(name, cid, oid)] = out["crc"]
            rec["corrupted"] = [list(k) for k in saved]
            t0 = time.perf_counter()
            asks = rec["repair_asks"] = {}
            runs = rec["repair_runs"] = {}
            # one command at a time, as an operator's shell sends them:
            # the leader maps each PG (a rule-VM run on the `indep`
            # pool), and twelve at once held its loop past the lease
            one_at_a_time = asyncio.Lock()

            async def repair(seed):
                """`pg repair`, asked again (as an operator would) while
                the primary's repair scrub did not run (the PG was not
                primary and active) or left errors."""
                pgid, primary = f"{pid}.{seed:x}", f"osd.{int(actp[seed])}"
                for n in range(1, CL_REPAIR_ASKS + 1):
                    asks[pgid] = n
                    before = len((await ask(primary, "smoke repairs"))
                                 .get(pgid, []))
                    async with one_at_a_time:
                        ret, rs, _ = await cl.mon_command(
                            {"prefix": "pg repair", "pgid": pgid})
                    require(ret == 0, f"osd cluster: pg repair: {rs}")
                    t1 = time.perf_counter()
                    while time.perf_counter() - t1 < CL_REPAIR_WAIT:
                        runs[pgid] = (await ask(primary, "smoke repairs")
                                      ).get(pgid, [])
                        if len(runs[pgid]) > before:
                            last = runs[pgid][-1]
                            if not last["refused"] and last["repaired"] \
                                    and not last["errors_after"]:
                                return
                            break
                        await asyncio.sleep(0.25)
                require(False, f"osd cluster: pg {pgid} on {primary} not "
                               f"repaired in {CL_REPAIR_ASKS} asks: "
                               f"{runs.get(pgid)}")
            await asyncio.gather(*[repair(seed)
                                   for seed in sorted({s for _o, s in pick})])

            async def restored():
                outs = await asyncio.gather(*[
                    ask(n, {"prefix": "smoke shard", "cid": cid, "oid": o})
                    for n, cid, o in saved])
                rec["unrestored"] = [list(k) for k, x in zip(saved, outs)
                                     if x["crc"] != saved[k]]
                return not rec["unrestored"]
            await wait_for(restored, "repair did not restore every shard")
            host_s["repair"] = time.perf_counter() - t0
            print(f"[{card}] osd_cluster_path repair: "
                  f"{host_s['repair']:.3f} s", flush=True)
            rec["repaired_pgs"] = len({s for _o, s in pick})
            await audit("after_repair")

            # -- 48. read everything back -------------------------------------
            await label("final_read")
            await timed("final_read", read_all(ec_io, "final read"))
            got = await bounded(CL_INFLIGHT, [lambda o=o: rep_io.read(
                o, timeout=CL_DEADLINE) for o in hdrs])
            require(got == list(hdrs.values()),
                    "osd cluster: a header object differs")
            for oid in list(hdrs)[:8]:
                require(await rep_io.getxattr(oid, "rbd.features") ==
                        b"\x01" and await rep_io.get_omap_vals(oid) ==
                        {"order": b"22", "size": str(OBJ_SIZE).encode()},
                        f"osd cluster: {oid}'s xattr or omap")
            st = await cl.status()
            pgmap = st.get("pgmap", {})
            require(pgmap.get("num_pgs") == CL_EC_PGS + CL_REP_PGS and
                    pgmap.get("states", {}).get("clean") ==
                    pgmap.get("num_pgs"),
                    f"osd cluster: not every PG is clean: {pgmap}")
            elections1 = await election_epochs()
            # the tables: one OSD's against mapper_ref, every OSD's alike
            live = [n for n in c.children
                    if n.startswith("osd.") and n not in dead]
            final = cl.monc.osdmap.epoch

            async def tables_at_final():
                outs = await asyncio.gather(*[ask(n, "smoke table")
                                              for n in live])
                rec["_tables"] = outs
                return cl.monc.osdmap.epoch == final and all(
                    o["epoch"] == final and o["map_epoch"] == final
                    for o in outs)
            await wait_for(tables_at_final, "an OSD never reached the "
                                            "last epoch")
            tables = rec.pop("_tables")
            require(all(t["pools"] == tables[0]["pools"] for t in tables),
                    "osd cluster: the OSDs' tables differ")
            rec["markdowns"] = [e for e in events if e[0] == "down"]
            rec["markups"] = [e for e in events if e[0] == "up"]
            rec["elections_after_start"] = {
                n: (elections1[n] - elections0[n]) // 2 for n in elections0}
            rec["epochs"] = {"first": epochs[0] if epochs else None,
                             "last": final, "client_maps": len(epochs)}
            rec["client_lookups_by_epoch"] = lookups
            rec["client_wire"] = dict(cl.monc.msgr.wire)
            rec["mons_at_end"] = await one_winner_per_epoch(
                c, card, "osd_cluster_path")
            await collect([n for n in c.children if n not in dead])
            rec["child_ready_s"] = {n: [s["ready_s"] for s in v]
                                    for n, v in sorted(stats.items())}
            return om, tables[0]
        except BaseException:
            # what the daemons saw, for the failure's record
            why = {k: rec.get(k) for k in ("unrestored", "repair_asks",
                                           "repair_runs")}
            print(f"[{card}] osd_cluster_path at failure: "
                  f"{json.dumps(why)}", flush=True)
            for n in [n for n in c.children if n not in dead]:
                try:
                    out = await asyncio.wait_for(
                        c.daemon_command(n, "smoke stats"), 5)
                    print(f"[{card}] osd_cluster_path at failure: {n} "
                          f"loop lag {out.get('loop_lag')}", flush=True)
                except Exception as e:
                    print(f"[{card}] osd_cluster_path at failure: {n} "
                          f"{type(e).__name__}", flush=True)
            raise
        finally:
            await c.stop()
            child_log.close()
            rec["children"] = children
            rec["stats"] = stats

    # the earlier phases' cached blocks go back to the card before
    # twelve daemon processes share it
    torch.cuda.empty_cache()
    rec["card_free_GiB_at_start"] = torch.cuda.mem_get_info()[0] / gib
    with StepLaunchLog(ckern) as clog:
        out = asyncio.run(run(clog))
        torch.cuda.synchronize()
        c_client = clog.real.launches
        clog.drain("osd cluster client")
    if start_only:
        return rec["start"]
    om, table = out

    # -- the launches of every daemon and the client ----------------------
    children, stats = rec.pop("children"), rec.pop("stats")
    gf, crush = {"launches": 0, "by_step": {}, "ms_by_step": {},
                 "checked": 0, "worst": 0}, {
        "launches": c_client, "by_step": {"client": clog.by_label},
        "checked": clog.checked, "worst": clog.worst}
    flushes = {}
    pushed = {"bytes": 0, "objects": 0}
    for name, last in [(n, d) for n, ds in children.items() for d in ds]:
        gf["launches"] += last["gf"]["launches"]
        crush["launches"] += last["crush"]["launches"]
        for lg, part in ((gf, last["gf"]), (crush, last["crush"])):
            lg["checked"] += part["checked"]
            lg["worst"] = max(lg["worst"], part["worst"])
        require(last["gf"]["checked"] == last["gf"]["launches"] and
                last["crush"]["checked"] == last["crush"]["launches"],
                f"osd cluster: {name} checked {last['gf']['checked']} of "
                f"{last['gf']['launches']} gf_encode and "
                f"{last['crush']['checked']} of "
                f"{last['crush']['launches']} crush_straw2 launches")
        for step, n in last["gf"]["by_step"].items():
            gf["by_step"][step] = gf["by_step"].get(step, 0) + n
        for step, ms in last["gf"]["ms_by_step"].items():
            gf["ms_by_step"][step] = gf["ms_by_step"].get(step, 0.0) + ms
        for step, ent in last["crush"]["by_step"].items():
            tot = crush["by_step"].setdefault(step, {"launches": 0,
                                                     "lanes": 0, "ms": 0.0})
            for k in tot:
                tot[k] += ent[k]
        for kind, by_label in last["flushes"].items():
            for step, rows in by_label.items():
                flushes.setdefault(kind, {}).setdefault(step, []).extend(rows)
        for k in pushed:
            pushed[k] += last["pushes"][k]
    require(gf["worst"] == 0 and crush["worst"] == 0,
            "osd cluster: a launch differs from its plain version")
    require(gf["launches"] > 0 and crush["launches"] > 0,
            f"osd cluster: gf_encode {gf['launches']}, crush_straw2 "
            f"{crush['launches']} launches")
    # -- counters: devices, ladders, device failures ----------------------
    osd_stats = [(n, s) for n, v in stats.items() if n.startswith("osd.")
                 for s in v]
    for name, s in osd_stats:
        require(s["devices"] == ["cuda"] or all(
            d.startswith("cuda") for d in s["devices"]),
            f"osd cluster: {name} runs on {s['devices']}")
        for kind, keys in (("ec_agg", PG_RINGS_AGG),
                           ("ec_read_agg", PG_RINGS_READ_AGG)):
            rungs = {k: s[kind].get(k, 0) for k in keys}
            require(not any(rungs.values()),
                    f"osd cluster: {name} {kind} rungs {rungs}")
        fails = (s["recovery"].get("push_device_failures", 0),
                 s["recovery"].get("rebuild_device_failures", 0),
                 s["scrub"].get("device_crc_failures", 0))
        require(not any(fails), f"osd cluster: {name} device failures "
                                f"{fails}")

    def total(kind, keys):
        return {k: sum(int(s[kind].get(k, 0)) for _n, s in osd_stats)
                for k in keys}
    rec["ec_agg"] = total("ec_agg", ("batches", "ops", "stripes",
                                     "bypass"))
    rec["ec_read_agg"] = total("ec_read_agg", ("batches", "ops", "stripes",
                                               "bypass"))
    rec["residency"] = total("ec_resident", ("hits", "misses", "evictions",
                                             "invalidations"))
    rec["scheduler_grants"] = total("qos", (
        "dequeued_client", "dequeued_recovery", "dequeued_scrub",
        "reservation_grants", "weight_grants", "fifo_grants"))
    rec["overload"] = total("overload", ("backoffs_sent",
                                         "backoffs_released",
                                         "throttle_queued"))
    wire = {"tx_bytes": 0, "rx_bytes": 0, "tx_frames": 0, "rx_frames": 0}
    for w in [x for v in stats.values() for s in v for x in s["wire"]] + \
            [rec.pop("client_wire")]:
        for k in wire:
            wire[k] += w[k]
    rec["wire"] = wire
    rec["recovery_pushed"] = pushed
    rec["loop_lag"] = {n: [x["loop_lag"] for x in v]
                       for n, v in sorted(stats.items())}
    rec["fsync"] = {n: [x["fsync"] for x in v]
                    for n, v in sorted(stats.items())}
    rec["osd_max_reserved_MiB"] = max(x["max_reserved_MiB"]
                                      for _n, x in osd_stats)
    rec["mon_slow_commands"] = {n: v[-1]["slow_commands"]
                                for n, v in sorted(stats.items())
                                if n.startswith("mon.")}
    logical = CL_OBJS * OBJ_SIZE
    record = {
        "card": card,
        "layout": {"mons": CL_MONS, "osds": CL_OSDS, "backend": "proc",
                   "store": "WALStore",
                   "ec_pool": f"k={K} m={M} reed_sol_van host "
                              f"stripe_unit={OBJ_C} pg_num={CL_EC_PGS}",
                   "rep_pool": f"size 3 pg_num {CL_REP_PGS}",
                   "resident_budget": OBJ_RESIDENT_BYTES},
        "objects": CL_OBJS, "object_bytes": OBJ_SIZE,
        "headers": CL_HDRS, "inflight": CL_INFLIGHT,
        "host_s": host_s,
        "write_GiBs": logical / host_s["write"] / gib,
        "read_GiBs": logical / host_s["read"] / gib,
        "degraded_read_GiBs": logical / host_s["degraded_read"] / gib,
        "overwrite_ops_per_s": CL_RMW / host_s["overwrite"],
        "degraded_overwrite_ops_per_s":
            CL_DEG_RMW / host_s["degraded_overwrite"],
        "detect_s": host_s["detect"],
        "recovery_GiBs": pushed["bytes"] / host_s["to_clean"] / gib,
        "to_clean_s": host_s["to_clean"], "repair_s": host_s["repair"],
        "gf_encode": gf, "crush_straw2": crush,
        "flushes": flush_summary(flushes),
        **rec,
        "phase_s": time.perf_counter() - t_phase,
    }
    print("osd_cluster_path: " + json.dumps(record))
    # -- the markdowns and elections the cell caused, and no others -------
    downs = sorted(e[1] for e in rec["markdowns"])
    require(downs == sorted(CL_KILL), f"osd cluster: markdowns {downs}, "
                                      f"want only {sorted(CL_KILL)}")
    require([e[1] for e in rec["markups"]] == [CL_KILL[0]],
            f"osd cluster: markups {rec['markups']}")
    require(not any(rec["elections_after_start"].values()),
            f"osd cluster: elections {rec['elections_after_start']}")
    # -- one OSD's tracked table against mapper_ref + the pipeline --------
    w = om._device_weights().tolist()
    for pid, pool_ in om.pools.items():
        pick = np.unique(np.linspace(0, pool_.pg_num - 1, min(
            pool_.pg_num, SCALAR_SAMPLE)).astype(np.int64))
        pseeds = pick.astype(np.uint32)
        pps = pool_.raw_pg_to_pps(pseeds)
        raw = scalar_map(pool, om.crush, pool_.crush_rule, pps,
                         pool_.size, w).astype(np.int32)
        want = (raw, *om._pipeline_from_crush(pool_, pseeds, raw, pps))
        t = table["pools"][str(pid)]
        for name, wv in zip(TABLES, want):
            require(np.array_equal(np.asarray(t[name])[pick], wv),
                    f"osd cluster: pool {pid} {name} differs from "
                    f"mapper_ref + pipeline")
    return {"gf": (gf["launches"], gf["worst"]),
            "crush": (crush["launches"], crush["worst"])}


# -- RBD images and the mgr (rbd_path) ----------------------------------------
# PERF.md section 4's deployment with Ceph's documented RBD setup ("Erasure
# Coding with Overwrites", "Block Devices"): a 1 GiB image (order 22) on a
# k=8 m=3 pool, one with snapshots and a clone on a replicated pool, and two
# mgrs with the reference's default modules.
RBD_MONS, RBD_OSDS, RBD_MGRS = 3, 12, 2
# PGAutoscalerModule.recommend for 12 OSDs and two pools: 32 at size 11,
# 128 at size 3, so the autoscaler proposes no split
RBD_EC_PGS, RBD_REP_PGS = 32, 128
# rbd bench's 1 GiB image cut to 512 MiB (128 objects of 4 MiB) for time
RBD_IMAGE, RBD_ORDER = 1 << 29, 22
RBD_INFLIGHT = 16                           # rbd bench --io-threads 16
# rbd bench --io-size 4K; its --io-total (1 GiB) cut to 1 MiB for time
RBD_RAND_OPS, RBD_RAND_BYTES = 256, 4096
RBD_SNAP_IMAGE, RBD_SNAP_WRITES = 64 << 20, 64
RBD_MGR_MODULES = ("balancer", "pg_autoscaler", "prometheus", "tracing",
                   "progress", "tuner")     # Mgr(modules=None)'s list
# The two mgr processes run on the CPU, as on hosts of their own: on an
# H100 each one's first sweep of the `indep` pool (`Mgr.get("osd_map")`
# -> `OSDMapMapping._sweep_pool` -> `Mapper._vm_map`) stalled its loop
# 5-17 s beside the twelve OSDs' sweeps, past the 5 s beacon grace, and
# the mon failed each over in turn (PERF.md section 4).
# tests/test_torch_cuda_rbd.py holds Mgr(device="cuda")'s table and
# balancer on the card. The mons run on the CPU as in the OSD cluster path.
RBD_ON_CPU = ("mon.", "mgr.")
RBD_QUIET_TICKS = 2       # balancer ticks with no change before the I/O
RBD_CONFIG = {"osd_ec_resident_bytes": OBJ_RESIDENT_BYTES,
              "mon_osd_down_out_interval": 600.0,
              # Ceph's pg_autoscaler sleep_interval (60 s): at the
              # reference's 5 s a tick between the two pools' creation
              # saw one pool and split the EC pool to 64 (PERF.md section 4)
              "mgr_pg_autoscaler_interval": 60.0}
RBD_LOG = "build/rbd_path.log"              # the daemons' and CLIs' output

# -- the S3 gateway and CephFS (fs_rgw_path) ----------------------------------
# On rbd_path's cluster, after its mgr failover: Ceph's documented CephFS
# setup ("Create a Ceph File System": one active MDS and a standby) on a
# replicated pool of its own, and S3 through the object gateway ("Ceph
# Object Gateway") on the k=8 m=3 pool. The reference keeps a file system's
# metadata and data in one pool, and a gateway's index and payloads in one.
FS_POOL = "cephfs"
FS_PGS = 128          # PGAutoscalerModule.recommend for 12 OSDs, 3 pools, size 3
FS_MDS = 2            # one active, one standby
FS_CLIENTS = ("client.fs0", "client.fs1")   # keys provisioned in the conf
S3_USERS = {"SMOKEACCESSKEY": "smoke-secret-key"}
S3_HOST = "127.0.0.1"
S3_BUCKET = "smoke"
S3_OBJS, S3_OBJ = 32, 4 << 20        # cut from 64 for time; RGW's stripe
S3_INFLIGHT = 16                     # rados bench -t 16
S3_MP, S3_PART = 64 << 20, 8 << 20   # S3's smallest part is 5 MiB
S3_DEGRADED = 16                     # GETs after an OSD is hard-stopped
S3_KILL = 4                          # the OSD hard-stopped
# mdtest-easy files per client, cut from 512 to hold the smoke's time
# once storm_path joined it (512 files' creates and unlinks took ~100 s),
# and from 128 when the smoke passed 1,050 s
MDT_FILES = 64
MDT_AFTER_FAIL = 32                  # each client's creates after `mds fail`
# ior-easy per client (cut from 64 MiB for time), transfer
IOR_SIZE, IOR_XFER = 32 << 20, 4 << 20


def cli_child(argv: list) -> None:
    """One of the port's CLIs (``ceph_tpu_torch.bench.<argv[0]>``, the
    rest its arguments) in a process of its own, as a user runs it, with
    both kernels' hooks: every launch it makes is held against its plain
    version, and the counts go as one JSON line to the file
    ``CHIP_SMOKE_CLI_LOG`` names. Exits with the CLI's code."""
    import importlib
    import os
    from ceph_tpu_torch.crush import kernels as ckern
    from ceph_tpu_torch.gf import kernels as gkern
    tool = importlib.import_module(f"ceph_tpu_torch.bench.{argv[0]}")
    with GfLaunchLog(gkern) as glog, StepLaunchLog(ckern) as clog:
        glog.label = clog.label = argv[0]
        rc = tool.main(argv[1:])
        torch.cuda.synchronize()
        glog.drain(f"{argv[0]} process")
        clog.drain(f"{argv[0]} process")
    with open(os.environ["CHIP_SMOKE_CLI_LOG"], "a") as f:
        f.write(json.dumps(dict(launch_record(
            argv[0], os.environ.get("CHIP_SMOKE_CLI_LABEL"), glog, clog),
            rc=rc)) + "\n")
    sys.exit(rc)


def rbd_path_phase(card: str) -> dict:
    """RBD images and the mgr on the card: a ``ProcCluster`` of three mons
    (on the CPU), twelve OSDs, two mgrs and the client (on the card); an
    ``rbd bench``-style run through ``Image`` on a 1 GiB image of a k=8
    m=3 pool, snapshots, a clone and an incremental export/import on a
    replicated pool, and a mgr failover. Returns the launches of both
    kernels on the path (every daemon's and CLI's counts start at 0 with
    its process, the client's are set to 0 just before the cluster
    starts, and all are read as the processes end) and the largest
    difference of any launch from its plain version."""
    import os

    from ceph_tpu_torch.crush import kernels as ckern
    from ceph_tpu_torch.mgr.modules import PGAutoscalerModule
    from ceph_tpu_torch.osd.osdmap import STATE_UP
    from ceph_tpu_torch.rbd import RBD

    rng = np.random.default_rng(SEED + 49)
    gib = 1 << 30
    obj = 1 << RBD_ORDER
    host_s, rec = {}, {}
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.dirname(os.path.join(here, RBD_LOG)), exist_ok=True)
    child_log = open(os.path.join(here, RBD_LOG), "wb")
    cli_log = os.path.join(here, RBD_LOG + ".cli")
    if os.path.exists(cli_log):
        os.remove(cli_log)
    SmokeCluster = smoke_cluster(child_log, here, RBD_ON_CPU, FS_CLIENTS)

    class StubMgr:
        config = dict(RBD_CONFIG)        # the cluster's, as the mgr's
    auto = PGAutoscalerModule(StubMgr())
    rec["autoscaler"] = {"ec": auto.recommend(RBD_OSDS, 2, K + M),
                         "replicated": auto.recommend(RBD_OSDS, 2, 3)}
    require(rec["autoscaler"] == {"ec": RBD_EC_PGS,
                                  "replicated": RBD_REP_PGS},
            f"rbd: the autoscaler recommends {rec['autoscaler']}")
    # with fs_rgw_path's pool beside them: the same targets, so no split
    three = {"ec": auto.recommend(RBD_OSDS, 3, K + M),
             "replicated": auto.recommend(RBD_OSDS, 3, 3)}
    require(three == {"ec": RBD_EC_PGS, "replicated": FS_PGS} and
            FS_PGS == RBD_REP_PGS,
            f"fs_rgw: the autoscaler recommends {three} for three pools")

    async def timed(what, coro):
        t0 = time.perf_counter()
        out = await coro
        host_s[what] = time.perf_counter() - t0
        print(f"[{card}] rbd_path {what}: {host_s[what]:.3f} s", flush=True)
        return out

    async def wait_for(pred, what, limit=CL_DEADLINE):
        t0 = time.perf_counter()
        while not await pred():
            require(time.perf_counter() - t0 < limit,
                    f"rbd: {what} after {limit} s")
            await asyncio.sleep(0.2)

    async def run(clog):
        clog.real.launches = 0
        clog.label = "start"
        c = SmokeCluster(
            n_mons=RBD_MONS, n_osds=RBD_OSDS, n_mgrs=RBD_MGRS,
            mgr_modules=list(RBD_MGR_MODULES), config=RBD_CONFIG,
            device="cuda")
        children, stats = {}, {}
        dead = set()                    # hard-stopped children

        async def ask(name, cmd):
            out = await c.daemon_command(name, cmd)
            require("error" not in out, f"rbd: {name} {cmd}: {out}")
            return out

        async def label(step):
            clog.label = c.smoke_label = step
            await asyncio.gather(*[ask(n, {"prefix": "smoke label",
                                           "label": step})
                                   for n in c.children if n not in dead])

        async def cli(tool, *words):
            """A CLI run as a user runs it, through ``--cli-child``;
            returns its standard output."""
            env = dict(os.environ, CHIP_SMOKE_CLI_LOG=cli_log,
                       CHIP_SMOKE_CLI_LABEL=str(clog.label))
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (here, env.get("PYTHONPATH")) if p)
            t0 = time.perf_counter()
            proc = await asyncio.create_subprocess_exec(
                sys.executable, os.path.abspath(CHILD_SCRIPT),
                "--cli-child", tool, "-c", c.conf_path, "--device", "cuda",
                *words, env=env, stdout=subprocess.PIPE, stderr=child_log)
            out, _ = await proc.communicate()
            rec.setdefault("cli_s", []).append(
                [tool, " ".join(words), time.perf_counter() - t0])
            require(proc.returncode == 0,
                    f"rbd: {tool} {' '.join(words)} exited "
                    f"{proc.returncode}")
            return out.decode()

        async def mgr_stats():
            names = [n for n in c.children if n.startswith("mgr.")]
            outs = await asyncio.gather(*[ask(n, "smoke stats")
                                          for n in names])
            return dict(zip(names, outs))

        async def active_mgr():
            st = await c.client.status()
            mm = st.get("mgrmap", {})
            return f"mgr.{mm['active_name']}" if mm.get("available") \
                else None

        async def scrape(name, port):
            """A GET of the mgr's /metrics, again until its exporter has
            rendered once: seconds and bytes of the one that answered."""
            for _ in range(50):
                t0 = time.perf_counter()
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port)
                writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
                await writer.drain()
                body = await asyncio.wait_for(reader.read(), 30)
                dt = time.perf_counter() - t0
                writer.close()
                text = body.decode(errors="replace")
                if "# no scrape yet" not in text:
                    break
                await asyncio.sleep(0.2)
            require(" 200 OK" in text.split("\r\n", 1)[0] and
                    f"ceph_osd_up {RBD_OSDS}" in text and
                    "ceph_mgr_available 1" in text,
                    f"rbd: {name}'s /metrics: {text[:300]!r}")
            return {"mgr": name, "s": dt, "bytes": len(body)}

        async def collect(names):
            # one daemon at a time: each drain runs the plain versions
            for n in names:
                stats.setdefault(n, []).append(await ask(n, "smoke stats"))
                children.setdefault(n, []).append(
                    await ask(n, "smoke drain"))

        async def election_epochs():
            mons = [n for n in c.children if n.startswith("mon.")]
            outs = await asyncio.gather(*[ask(n, "smoke stats")
                                          for n in mons])
            return {n: o["election_epoch"] for n, o in zip(mons, outs)}

        try:
            # -- 49. start everything, the mgrs included ----------------------
            # returns with a mgr active
            rec["start"] = await start_cluster(c, timed, card, "rbd_path")
            await asyncio.gather(*[c.wait_for_daemon_ready(n, 120)
                                   for n in c.children])
            cl = c.client
            require(cl.monc.device.type == "cuda",
                    "rbd: the client is not on the card")
            first = await active_mgr()
            require(first is not None, "rbd: no active mgr")

            # active: the mgr the map names has promoted and its modules
            # ran their first ticks, so the autoscaler's next look comes
            # after both pools exist (a look between the two creations
            # sees one pool and splits the first)
            async def ticked_once():
                st = (await mgr_stats())[first]
                return st["active"] and st["module_ticks"].get(
                    "balancer") and st["module_ticks"].get("pg_autoscaler")
            await wait_for(ticked_once, "the active mgr never ticked")
            host_s["mgr_active"] = asyncio.get_event_loop().time() - min(
                ch.started_at for n, ch in c.children.items()
                if n.startswith("mgr."))
            elections0 = await election_epochs()
            events, epochs = [], []
            prev = {"up": None}

            async def on_map(om):
                up = (np.asarray(om.osd_state) & STATE_UP) != 0
                if prev["up"] is not None and len(prev["up"]) == len(up):
                    for o in np.flatnonzero(prev["up"] & ~up):
                        events.append(("down", int(o), om.epoch))
                prev["up"] = up
                epochs.append(om.epoch)
            cl.monc.map_callbacks.append(on_map)

            await label("pools")
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd erasure-code-profile set", "name": "rbd_ec",
                 "profile": [f"k={K}", f"m={M}", "technique=reed_sol_van",
                             "crush-failure-domain=host",
                             f"stripe_unit={OBJ_C}"]})
            require(ret == 0, f"rbd: profile: {rs}")
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd pool create", "pool": "rbd_ec",
                 "pg_num": RBD_EC_PGS, "pool_type": "erasure",
                 "erasure_code_profile": "rbd_ec"})
            require(ret == 0, f"rbd: ec pool: {rs}")
            await cl.pool_create("rbd", pg_num=RBD_REP_PGS, size=3)

            async def has_pools():
                om = cl.monc.osdmap
                return om is not None and {"rbd_ec", "rbd"} <= {
                    p.name for p in om.pools.values()}
            await wait_for(has_pools, "the client's map lacks the pools")
            t0 = time.perf_counter()
            await c.wait_for_clean(timeout=CL_DEADLINE)
            host_s["to_clean_after_create"] = time.perf_counter() - t0
            clean_at = time.time()

            # the balancer quiet (no change in its last ticks after the
            # first clean) on a clean cluster: its upmaps move PGs before
            # any image data exists
            def quiet_of(mgr, at):
                async def quiet():
                    st = (await mgr_stats())[mgr]
                    done = [t for t in st["balancer_ticks"] if t[0] >= at]
                    st_cl = await cl.status()
                    pgmap = st_cl["pgmap"]
                    return len(done) >= RBD_QUIET_TICKS and \
                        all(t[1] == 0 for t in done[-RBD_QUIET_TICKS:]) \
                        and pgmap["states"].get("clean") == pgmap["num_pgs"]
                return quiet
            await wait_for(quiet_of(first, clean_at),
                           "the balancer never went quiet")
            host_s["settle"] = time.perf_counter() - t0
            ticks = (await mgr_stats())[first]["balancer_ticks"]
            require(all(isinstance(t[1], int) for t in ticks),
                    f"rbd: a balancer tick failed: {ticks}")
            rec["upmaps_committed"] = sum(t[1] for t in ticks)
            rec["balancer_ticks_to_quiet"] = len(ticks)
            print(f"[{card}] rbd_path settle: {host_s['settle']:.3f} s, "
                  f"{rec['upmaps_committed']} upmaps", flush=True)

            # -- 50. rbd create through the CLI -------------------------------
            await label("create")
            await timed("rbd_create", cli(
                "rbd_cli", "-p", "rbd_ec", "create", "vol0", "--size",
                str(RBD_IMAGE), "--order", str(RBD_ORDER)))
            ec_io = await cl.open_ioctx("rbd_ec")
            rep_io = await cl.open_ioctx("rbd")
            img = await RBD(ec_io).open("vol0")
            require(img.size_bytes == RBD_IMAGE and img.order == RBD_ORDER,
                    f"rbd: vol0 is {img.size_bytes} bytes, order "
                    f"{img.order}")

            # -- 51. rbd bench's parameters through Image ---------------------
            mirror = bytearray(RBD_IMAGE)
            for i in range(RBD_IMAGE // obj):
                mirror[i * obj:(i + 1) * obj] = rng.bytes(obj)
            await label("seq_write")
            await timed("seq_write", bounded(RBD_INFLIGHT, [
                lambda o=o: img.write(o, bytes(mirror[o:o + obj]))
                for o in range(0, RBD_IMAGE, obj)]))
            blocks = RBD_IMAGE // RBD_RAND_BYTES
            jobs = []
            for _ in range(RBD_RAND_OPS):
                off = int(rng.integers(0, blocks)) * RBD_RAND_BYTES
                jobs.append((off, rng.bytes(RBD_RAND_BYTES)))
            # one object's ops keep their submission order (one PG, one
            # queue), so the mirror takes them in that order
            for off, data in jobs:
                mirror[off:off + RBD_RAND_BYTES] = data
            await label("rand_write")
            await timed("rand_write", bounded(RBD_INFLIGHT, [
                lambda j=j: img.write(j[0], j[1]) for j in jobs]))
            offs = [int(rng.integers(0, blocks)) * RBD_RAND_BYTES
                    for _ in range(RBD_RAND_OPS)]
            await label("rand_read")
            got = await timed("rand_read", bounded(RBD_INFLIGHT, [
                lambda o=o: img.read(o, RBD_RAND_BYTES) for o in offs]))
            for o, data in zip(offs, got):
                require(data == bytes(mirror[o:o + RBD_RAND_BYTES]),
                        f"rbd: a 4 KiB read at {o} differs from the mirror")
            await label("seq_read")

            async def seq_read():
                outs = await bounded(RBD_INFLIGHT, [
                    lambda o=o: img.read(o, obj)
                    for o in range(0, RBD_IMAGE, obj)])
                for i, data in enumerate(outs):
                    require(data == bytes(mirror[i * obj:(i + 1) * obj]),
                            f"rbd: object {i} differs from the mirror")
            await timed("seq_read", seq_read())
            del mirror

            # -- 52. snapshots, a clone, export-diff / import-diff ------------
            await label("snapshots")
            rbd = RBD(rep_io)
            await rbd.create("vol1", RBD_SNAP_IMAGE, order=RBD_ORDER)
            vol1 = await rbd.open("vol1")
            pre = bytearray(rng.bytes(RBD_SNAP_IMAGE))
            await bounded(RBD_INFLIGHT, [
                lambda o=o: vol1.write(o, bytes(pre[o:o + obj]))
                for o in range(0, RBD_SNAP_IMAGE, obj)])
            await timed("snap", vol1.snap_create("s1"))
            head = bytearray(pre)
            jobs = []
            for _ in range(RBD_SNAP_WRITES):
                off = int(rng.integers(0, RBD_SNAP_IMAGE // RBD_RAND_BYTES)) \
                    * RBD_RAND_BYTES
                jobs.append((off, rng.bytes(RBD_RAND_BYTES)))
                head[off:off + RBD_RAND_BYTES] = jobs[-1][1]
            await timed("snap_writes", bounded(RBD_INFLIGHT, [
                lambda j=j: vol1.write(*j) for j in jobs]))
            at_s1 = await rbd.open("vol1", snapshot="s1")
            require(await at_s1.read(0, RBD_SNAP_IMAGE) == bytes(pre),
                    "rbd: vol1 at s1 differs from the pre-snap mirror")
            require(await vol1.read(0, RBD_SNAP_IMAGE) == bytes(head),
                    "rbd: vol1 differs from its mirror")
            await vol1.snap_protect("s1")
            await timed("clone", rbd.clone("vol1", "s1", "vol1c"))
            kid = await rbd.open("vol1c")
            off = 5 * obj // 2
            await kid.write(off, b"\xa5" * RBD_RAND_BYTES)    # copy-up
            want = bytearray(pre)
            want[off:off + RBD_RAND_BYTES] = b"\xa5" * RBD_RAND_BYTES
            require(await kid.read(0, RBD_SNAP_IMAGE) == bytes(want),
                    "rbd: the clone differs from its mirror")
            t0 = time.perf_counter()
            full = await at_s1.export_diff()
            incr = await vol1.export_diff(from_snap="s1")
            await rbd.create("vol1r", 1 << 12, order=RBD_ORDER)
            copy = await rbd.open("vol1r")
            await copy.import_diff(full)
            await copy.import_diff(incr)
            host_s["diff"] = time.perf_counter() - t0
            rec["diff_bytes"] = {"full": len(full), "incremental": len(incr)}
            require(await copy.read(0, RBD_SNAP_IMAGE) == bytes(head) and
                    await (await rbd.open("vol1r", snapshot="s1")).read(
                        0, RBD_SNAP_IMAGE) == bytes(pre),
                    "rbd: the imported image differs from vol1")
            del pre, head, want

            # -- 53. mgr fail and the standby's takeover ----------------------
            await label("failover")
            before = await mgr_stats()
            scrapes = [await scrape(first, before[first]["prometheus_port"])]
            t0 = time.perf_counter()
            await cli("ceph_cli", "mgr", "fail")
            t1 = time.perf_counter()      # the CLI's own start-up before

            async def taken_over():
                now = await active_mgr()
                return now not in (None, first)
            await wait_for(taken_over, "no standby took over")
            second = await active_mgr()
            host_s["failover"] = time.perf_counter() - t0

            async def ticked():
                st = (await mgr_stats())[second]
                return any(t[2] == "failover"
                           for t in st["balancer_ticks"]) and \
                    st["prometheus_port"] is not None
            await wait_for(ticked, "the new active never ticked")
            # from the command's answer to the new active's first tick
            host_s["takeover"] = time.perf_counter() - t1
            after = await mgr_stats()
            tick = next(t for t in after[second]["balancer_ticks"]
                        if t[2] == "failover")
            rec["new_active_first_tick"] = tick
            require(tick[1] == 0, f"rbd: the new active's first balancer "
                                  f"tick committed {tick[1]}")
            for name in (second, first):
                port = after[name]["prometheus_port"]
                if port is not None:
                    scrapes.append(await scrape(name, port))
            rec["scrapes"] = scrapes
            progress, status = [json.loads(out) for out in (
                await asyncio.gather(cli("ceph_cli", "progress", "json"),
                                     cli("ceph_cli", "status")))]
            require("events" in progress and
                    status["mgrmap"]["active_name"] == second[4:],
                    f"rbd: progress {progress}, mgrmap "
                    f"{status.get('mgrmap')}")
            rec["progress_completed"] = len(progress.get("completed", []))

            # -- 54. what must hold at the end --------------------------------
            ret, rs, out = await cl.mon_command({"prefix": "osd pool ls"})
            pools = {p["name"]: p["pg_num"] for p in json.loads(out)}
            require(pools == {"rbd_ec": RBD_EC_PGS, "rbd": RBD_REP_PGS},
                    f"rbd: pg_num changed: {pools}")
            elections1 = await election_epochs()
            rec["elections_after_start"] = {
                n: (elections1[n] - elections0[n]) // 2 for n in elections0}
            rec["markdowns"] = [e for e in events if e[0] == "down"]
            rec["mgr_moves"] = {n: s["moves"] for n, s in after.items()}
            rec["mgrs"] = {"first": first, "second": second}
            rec["epochs"] = {"first": epochs[0] if epochs else None,
                             "last": cl.monc.osdmap.epoch,
                             "client_maps": len(epochs)}
            rec["client_wire"] = dict(cl.monc.msgr.wire)
            mark("rbd_path")

            # -- 55-61. the S3 gateway and CephFS (fs_rgw_path) ---------------
            fs_h = {"c": c, "cl": cl, "card": card,
                    "rng": np.random.default_rng(SEED + 55), "label": label,
                    "ask": ask, "cli": cli, "wait_for": wait_for,
                    "collect": collect, "dead": dead,
                    "quiet": lambda at: quiet_of(second, at)}
            rec["fs_rgw"] = await fs_rgw_steps(fs_h)
            fs = rec["fs_rgw"]
            elections2 = await election_epochs()
            fs["elections"] = {n: (elections2[n] - elections1[n]) // 2
                               for n in elections1}
            fs["markdowns"] = [e for e in events if e[0] == "down"][
                len(rec["markdowns"]):]
            fs["mgr_moves"] = {n: s["moves"]
                               for n, s in (await mgr_stats()).items()}
            fs["epochs"] = {"last": cl.monc.osdmap.epoch,
                            "client_maps": len(epochs)}
            ret, rs, out = await cl.mon_command({"prefix": "osd pool ls"})
            pools = {p["name"]: p["pg_num"] for p in json.loads(out)}
            require(pools == {"rbd_ec": RBD_EC_PGS, "rbd": RBD_REP_PGS,
                              FS_POOL: FS_PGS},
                    f"fs_rgw: pg_num changed: {pools}")
            mark("fs_rgw_path")

            # -- 62-67. loadgen and the Thrasher's storms (storm_path) -------
            rec["storm"] = await storm_steps({
                "c": c, "cl": cl, "card": card, "label": label, "ask": ask,
                "wait_for": wait_for, "collect": collect, "dead": dead,
                "events": events, "mgr_stats": mgr_stats,
                "election_epochs": election_epochs, "here": here,
                "fs_clients": fs_h["fs_clients"]})
            rec["mons_at_end"] = await one_winner_per_epoch(
                c, card, "rbd_path")
            await collect([n for n in c.children if n not in dead])
        except BaseException:
            for n in list(c.children):
                try:
                    out = await asyncio.wait_for(
                        c.daemon_command(n, "smoke stats"), 5)
                    print(f"[{card}] rbd_path at failure: {n} loop lag "
                          f"{out.get('loop_lag')} balancer "
                          f"{out.get('balancer_ticks')} moves "
                          f"{out.get('moves')}", flush=True)
                except Exception as e:
                    print(f"[{card}] rbd_path at failure: {n} "
                          f"{type(e).__name__}", flush=True)
            raise
        finally:
            await c.stop()
            child_log.close()
            rec["children"] = children
            rec["stats"] = stats

    torch.cuda.empty_cache()
    rec["card_free_GiB_at_start"] = torch.cuda.mem_get_info()[0] / gib
    with StepLaunchLog(ckern) as clog:
        asyncio.run(run(clog))
        torch.cuda.synchronize()
        c_client = clog.real.launches
        clog.drain("rbd client")

    # -- the launches of every process, by path and kind --------------------
    # storm_path's launches are those of its steps (labels storm_*), of its
    # loadgen worker and of ec_bench; fs_rgw_path's those of its steps
    # (labels fs_rgw_*) and every other launch of an MDS process
    def path_of(name, step):
        if str(step).startswith("storm"):
            return "storm_path"
        return "fs_rgw_path" if name.startswith("mds.") or \
            str(step).startswith("fs_rgw") else "rbd_path"
    paths = ("rbd_path", "fs_rgw_path", "storm_path")
    children, stats = rec.pop("children"), rec.pop("stats")
    kinds = {path: {k: {"gf_encode": {"launches": 0, "ms": 0.0},
                        "crush_straw2": {"launches": 0, "ms": 0.0}}
                    for k in ("mgr", "osd", "mds", "client", "cli",
                              "loadgen", "ec_bench")}
             for path in paths}
    for step, e in clog.by_label.items():
        k = kinds[path_of("client", step)]["client"]["crush_straw2"]
        k["launches"] += e["launches"]
        k["ms"] += e["ms"]
    require(sum(e["launches"] for e in clog.by_label.values()) == c_client,
            f"rbd: the client's launches by step {clog.by_label} do not add "
            f"up to {c_client}")
    worst = {"gf": 0, "crush": clog.worst}
    gf_by_step, flushes = {}, {}
    for name, last in [(n, d) for n, ds in children.items() for d in ds]:
        kind = name.split(".")[0]
        if name.startswith(RBD_ON_CPU):
            # its wrappers ran the plain versions on the CPU (the hook
            # checked those calls too): no kernel launch
            require(not last["gf"]["launches"] and
                    not last["crush"]["launches"],
                    f"rbd: {name} on the CPU launched a kernel")
            continue
        require(last["gf"]["checked"] == last["gf"]["launches"] and
                last["crush"]["checked"] == last["crush"]["launches"],
                f"rbd: {name} checked {last['gf']['checked']} of "
                f"{last['gf']['launches']} gf_encode and "
                f"{last['crush']['checked']} of "
                f"{last['crush']['launches']} crush_straw2 launches")
        for step, n in last["gf"]["by_step"].items():
            k = kinds[path_of(name, step)][kind]["gf_encode"]
            k["launches"] += n
            k["ms"] += last["gf"]["ms_by_step"][step]
            gf_by_step[step] = gf_by_step.get(step, 0) + n
        for step, e in last["crush"]["by_step"].items():
            k = kinds[path_of(name, step)][kind]["crush_straw2"]
            k["launches"] += e["launches"]
            k["ms"] += e["ms"]
        worst["gf"] = max(worst["gf"], last["gf"]["worst"])
        worst["crush"] = max(worst["crush"], last["crush"]["worst"])
        for fkind, by_label in last["flushes"].items():
            for step, rows in by_label.items():
                flushes.setdefault(fkind, {}).setdefault(step, []).extend(
                    rows)
    with open(cli_log) as f:
        clis = [json.loads(line) for line in f]
    storm = rec.pop("storm")
    others = [("cli", one) for one in clis] + \
        [("loadgen", storm["loadgen"]["worker"])] + \
        [("ec_bench", e["launches"]) for e in storm["ec_bench"].values()]
    for kind, one in others:
        for key, kern in (("gf", "gf_encode"), ("crush", "crush_straw2")):
            require(one[key]["checked"] == one[key]["launches"],
                    f"rbd: {one['tool']} checked {one[key]['checked']} of "
                    f"{one[key]['launches']} {kern} launches")
            k = kinds[path_of(kind, one["label"])][kind][kern]
            k["launches"] += one[key]["launches"]
            k["ms"] += one[key]["ms"]
            worst[key] = max(worst[key], one[key]["worst"])
    require(worst["gf"] == 0 and worst["crush"] == 0,
            "rbd: a launch differs from its plain version")
    totals = {path: {kern: sum(k[kern]["launches"] for k in by.values())
                     for kern in ("gf_encode", "crush_straw2")}
              for path, by in kinds.items()}
    for path, tot in totals.items():
        require(tot["gf_encode"] > 0 and tot["crush_straw2"] > 0,
                f"{path}: a kernel was launched no time: {kinds[path]}")
    require(kinds["fs_rgw_path"]["mds"]["crush_straw2"]["launches"] > 0,
            f"fs_rgw: the MDSs launched no crush_straw2: {kinds}")
    # -- devices, ladders, device failures ---------------------------------
    for name, v in stats.items():
        for s in v:
            if name.startswith(RBD_ON_CPU):
                require(all(d.startswith("cpu") for d in s["devices"]),
                        f"rbd: {name} runs on {s['devices']}")
            if not name.startswith("osd."):
                continue
            require(all(d.startswith("cuda") for d in s["devices"]),
                    f"rbd: {name} runs on {s['devices']}")
            for kind, keys in (("ec_agg", PG_RINGS_AGG),
                               ("ec_read_agg", PG_RINGS_READ_AGG)):
                rungs = {k: s[kind].get(k, 0) for k in keys}
                require(not any(rungs.values()),
                        f"rbd: {name} {kind} rungs {rungs}")
            fails = (s["recovery"].get("push_device_failures", 0),
                     s["recovery"].get("rebuild_device_failures", 0),
                     s["scrub"].get("device_crc_failures", 0))
            require(not any(fails), f"rbd: {name} device failures {fails}")
    rec["loop_lag"] = {n: [x["loop_lag"] for x in v]
                       for n, v in sorted(stats.items())}
    mgr_lag = [x["loop_lag"] for n, v in stats.items()
               if n.startswith("mgr.") for x in v]
    rec["mgr_worst_stall_s"] = max(x["max_s"] for x in mgr_lag)
    fs = rec.pop("fs_rgw")
    rec["cli"] = [one for one in clis
                  if path_of("cli", one["label"]) == "rbd_path"]
    record = {
        "card": card,
        "layout": {"mons": RBD_MONS, "osds": RBD_OSDS, "mgrs": RBD_MGRS,
                   "on_cpu": [n.rstrip(".") for n in RBD_ON_CPU],
                   "mgr_modules": list(RBD_MGR_MODULES), "backend": "proc",
                   "ec_pool": f"k={K} m={M} reed_sol_van host "
                              f"stripe_unit={OBJ_C} pg_num={RBD_EC_PGS}",
                   "rep_pool": f"size 3 pg_num {RBD_REP_PGS}",
                   "image": f"{RBD_IMAGE} bytes order {RBD_ORDER}",
                   "rand_ops": RBD_RAND_OPS, "inflight": RBD_INFLIGHT},
        "host_s": host_s,
        "seq_write_GiBs": RBD_IMAGE / host_s["seq_write"] / gib,
        "rand_write_iops": RBD_RAND_OPS / host_s["rand_write"],
        "rand_read_iops": RBD_RAND_OPS / host_s["rand_read"],
        "seq_read_GiBs": RBD_IMAGE / host_s["seq_read"] / gib,
        "snap_s": host_s["snap"], "clone_s": host_s["clone"],
        "diff_s": host_s["diff"],
        "mgr": {"active_s": host_s["mgr_active"],
                "settle_s": host_s["settle"],
                "upmaps": rec["upmaps_committed"],
                "failover_s": host_s["failover"],
                "takeover_s": host_s["takeover"],
                "scrapes": rec.pop("scrapes"),
                "worst_stall_s": rec["mgr_worst_stall_s"]},
        "launches_by_kind": kinds["rbd_path"],
        "gf_encode_by_step": {k: v for k, v in gf_by_step.items()
                              if path_of("osd", k) == "rbd_path"},
        "flushes": flush_summary({
            fk: {k: v for k, v in by.items() if path_of("osd", k) ==
                 "rbd_path"} for fk, by in flushes.items()}),
        **rec,
        "phase_s": time.perf_counter() - t_phase - fs["phase_s"] -
        storm["phase_s"],
    }
    print("rbd_path: " + json.dumps(record))
    mds_stats = fs.pop("mds_stats")
    # the MDSs' stats as fs_rgw_path left them (read at its end, before
    # storm_path's storms)
    mds_lag = {n: v["loop_lag"] for n, v in mds_stats.items()}
    fs.update({
        "mds": {"start": fs.pop("mds_start"),
                "worst_stall_s": max(x["max_s"] for x in mds_lag.values()),
                "loop_lag": mds_lag,
                "takeovers": sum(v["perf"].get("takeovers", 0)
                                 for v in mds_stats.values()),
                "reconnect_accepted": sum(
                    v["perf"].get("reconnect_accepted", 0)
                    for v in mds_stats.values()),
                "states": {n: v["state"] for n, v in mds_stats.items()}},
        "launches_by_kind": kinds["fs_rgw_path"],
        "gf_encode_by_step": {k: v for k, v in gf_by_step.items()
                              if path_of("osd", k) == "fs_rgw_path"},
        "flushes": flush_summary({
            fk: {k: v for k, v in by.items() if path_of("osd", k) ==
                 "fs_rgw_path"} for fk, by in flushes.items()}),
        "cli": [one for one in clis
                if path_of("cli", one["label"]) == "fs_rgw_path"]})
    print("fs_rgw_path: " + json.dumps(fs))
    storm.update({
        "launches_by_kind": kinds["storm_path"],
        "gf_encode_by_step": {k: v for k, v in gf_by_step.items()
                              if path_of("osd", k) == "storm_path"},
        "flushes": flush_summary({
            fk: {k: v for k, v in by.items() if path_of("osd", k) ==
                 "storm_path"} for fk, by in flushes.items()})})
    print("storm_path: " + json.dumps(storm))
    # -- the markdowns, elections and mgr failovers: only the phase's -------
    require(not rec["markdowns"], f"rbd: markdowns {rec['markdowns']}")
    require(not any(rec["elections_after_start"].values()),
            f"rbd: elections {rec['elections_after_start']}")
    moves = [m for m in rec["mgr_moves"].values()]
    require(sum(m["promote"] for m in moves) == 2 and
            sum(m["demote"] for m in moves) == 1,
            f"rbd: mgr promotions and demotions {rec['mgr_moves']}, want "
            f"the first active and the phase's one failover")
    require(fs["markdowns"] and
            {e[1] for e in fs["markdowns"]} == {S3_KILL},
            f"fs_rgw: markdowns {fs['markdowns']}, want osd.{S3_KILL}'s")
    require(not any(fs["elections"].values()),
            f"fs_rgw: elections {fs['elections']}")
    require(fs["mgr_moves"] == rec["mgr_moves"],
            f"fs_rgw: mgr promotions and demotions {fs['mgr_moves']}")
    require(fs["mds"]["takeovers"] == 2,
            f"fs_rgw: {fs['mds']['takeovers']} MDS takeovers, want the "
            f"first active's and the phase's one failover")
    return {"gf": (totals["rbd_path"]["gf_encode"], worst["gf"]),
            "crush": (totals["rbd_path"]["crush_straw2"], worst["crush"]),
            **{path[:-5]: {
                "gf": (totals[path]["gf_encode"], worst["gf"]),
                "crush": (totals[path]["crush_straw2"], worst["crush"])}
               for path in ("fs_rgw_path", "storm_path")}}


async def s3_request(port: int, method: str, target: str, body: bytes = b"",
                     headers: dict | None = None, signed: bool = True):
    """One HTTP/1.1 request to the gateway at ``port``: SigV4-signed by
    the port's ``rgw.auth`` as ``S3_USERS``' user unless ``signed`` is
    false (anonymous). Returns (status, lower-cased headers, body)."""
    from ceph_tpu_torch.rgw import auth as sigv4
    (access, secret), = S3_USERS.items()
    hdrs = {"host": S3_HOST, **(headers or {})}
    if signed:
        path, _, query = target.partition("?")
        hdrs.update(sigv4.sign(method, path, query, hdrs, body, access,
                               secret))
    reader, writer = await asyncio.open_connection(S3_HOST, port)
    try:
        lines = "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())
        writer.write(f"{method} {target} HTTP/1.1\r\n{lines}"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        status = int((await asyncio.wait_for(
            reader.readline(), CL_DEADLINE)).split()[1])
        got = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            got[k.strip().lower()] = v.strip()
        n = int(got.get("content-length", 0))
        payload = b"" if method == "HEAD" or not n else \
            await reader.readexactly(n)
        return status, got, payload
    finally:
        writer.close()


async def fs_rgw_steps(h) -> dict:
    """The S3 gateway and CephFS on ``rbd_path``'s running cluster (steps
    55-61); ``h`` carries the phase's cluster, client and helpers. Returns
    the phase's record; every check raises."""
    import hashlib

    from ceph_tpu_torch.cephfs.client import CephFSClient
    from ceph_tpu_torch.rgw import RGWGateway
    from ceph_tpu_torch.rgw import auth as sigv4

    c, cl, card, rng = h["c"], h["cl"], h["card"], h["rng"]
    label, ask, cli, wait_for = h["label"], h["ask"], h["cli"], h["wait_for"]
    host_s, rec = {}, {}
    t_phase = time.perf_counter()

    async def timed(what, coro):
        t0 = time.perf_counter()
        out = await coro
        host_s[what] = time.perf_counter() - t0
        print(f"[{card}] fs_rgw_path {what}: {host_s[what]:.3f} s",
              flush=True)
        return out

    async def fsmap():
        return (await cl.status()).get("fsmap") or {}

    async def mds_stats():
        names = [n for n in c.children if n.startswith("mds.")]
        outs = await asyncio.gather(*[ask(n, "smoke stats") for n in names])
        return dict(zip(names, outs))

    # -- 55. the fs pool and two MDS daemons --------------------------------
    await label("fs_rgw_setup")
    t0 = time.perf_counter()
    await c.start_fs(pool=FS_POOL, n_mds=FS_MDS, pg_num=FS_PGS)
    host_s["start_fs"] = time.perf_counter() - t0
    mdss = [n for n in c.children if n.startswith("mds.")]
    await asyncio.gather(*[c.wait_for_daemon_ready(n, CL_DEADLINE)
                           for n in mdss])

    async def one_standby():
        fm = await fsmap()
        return fm.get("active") and fm.get("standby_count") == FS_MDS - 1
    await wait_for(one_standby, "no active MDS with a standby")
    first_mds = (await fsmap())["active"]
    # the balancer's moves for the new pool's PGs land before the I/O
    clean_at = time.time()
    await wait_for(h["quiet"](clean_at), "the balancer never went quiet")
    host_s["settle"] = time.perf_counter() - t0
    await label("fs_rgw_setup")              # the MDSs' hooks too
    st = await mds_stats()
    rec["mds_start"] = {n: {"ready_s": v["ready_s"],
                            "create_s": v["create_s"],
                            "devices": v["devices"]} for n, v in st.items()}
    for n, v in st.items():
        require(all(d.startswith("cuda") for d in v["devices"]),
                f"fs_rgw: {n} runs on {v['devices']}")
    print(f"[{card}] fs_rgw_path MDS start-up: {json.dumps(rec['mds_start'])}",
          flush=True)

    # -- 56. S3: PUT, list, HEAD and GET at 16 in flight ---------------------
    ec_io = await cl.open_ioctx("rbd_ec")
    gw = RGWGateway(ec_io, users=S3_USERS)
    port = await gw.start(S3_HOST)
    try:
        status, _, _ = await s3_request(port, "PUT", f"/{S3_BUCKET}")
        require(status == 200, f"fs_rgw: create bucket: {status}")
        names = [f"obj{i:03d}" for i in range(S3_OBJS)]
        mirror = {n: rng.bytes(S3_OBJ) for n in names}

        async def put(n):
            status, hdrs, _ = await s3_request(
                port, "PUT", f"/{S3_BUCKET}/{n}", mirror[n])
            require(status == 200 and hdrs.get("etag") ==
                    f'"{hashlib.md5(mirror[n]).hexdigest()}"',
                    f"fs_rgw: PUT {n}: {status} {hdrs.get('etag')}")
        await label("fs_rgw_s3_put")
        await timed("s3_put", bounded(S3_INFLIGHT, [
            lambda n=n: put(n) for n in names]))
        await label("fs_rgw_s3_list")
        status, _, xml = await timed("s3_list", s3_request(
            port, "GET", f"/{S3_BUCKET}"))
        want = "".join(f"<Contents><Key>{n}</Key><Size>{S3_OBJ}</Size>"
                       f"</Contents>" for n in names)
        require(status == 200 and want.encode() in xml,
                f"fs_rgw: the listing: {status} {xml[:300]!r}")

        async def head(n):
            status, hdrs, _ = await s3_request(port, "HEAD",
                                               f"/{S3_BUCKET}/{n}")
            require(status == 200 and
                    int(hdrs.get("content-length", -1)) == S3_OBJ,
                    f"fs_rgw: HEAD {n}: {status} {hdrs}")
        await label("fs_rgw_s3_head")
        await timed("s3_head", bounded(S3_INFLIGHT, [
            lambda n=n: head(n) for n in names]))

        async def get(n, want_etag=None):
            status, hdrs, data = await s3_request(port, "GET",
                                                  f"/{S3_BUCKET}/{n}")
            require(status == 200 and data == mirror[n],
                    f"fs_rgw: GET {n}: {status}, "
                    f"{len(data)} bytes differ from the mirror")
            if want_etag is not None:
                require(hdrs.get("etag") == f'"{want_etag}"',
                        f"fs_rgw: GET {n}: ETag {hdrs.get('etag')}")
        await label("fs_rgw_s3_get")
        await timed("s3_get", bounded(S3_INFLIGHT, [
            lambda n=n: get(n) for n in names]))

        # -- 57. multipart, a presigned GET and a public-read object ---------
        await label("fs_rgw_s3_multipart")
        mp = "multipart.bin"
        mirror[mp] = rng.bytes(S3_MP)

        async def multipart():
            status, _, xml = await s3_request(
                port, "POST", f"/{S3_BUCKET}/{mp}?uploads")
            require(status == 200, f"fs_rgw: initiate: {status}")
            upload = xml.split(b"<UploadId>")[1].split(
                b"</UploadId>")[0].decode()
            parts = [mirror[mp][o:o + S3_PART]
                     for o in range(0, S3_MP, S3_PART)]

            async def part(i):
                status, hdrs, _ = await s3_request(
                    port, "PUT", f"/{S3_BUCKET}/{mp}?partNumber={i + 1}"
                                 f"&uploadId={upload}", parts[i])
                require(status == 200 and hdrs.get("etag") ==
                        f'"{hashlib.md5(parts[i]).hexdigest()}"',
                        f"fs_rgw: part {i + 1}: {status}")
            await bounded(S3_INFLIGHT, [lambda i=i: part(i)
                                        for i in range(len(parts))])
            body = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber>"
                f'<ETag>"{hashlib.md5(p).hexdigest()}"</ETag></Part>'
                for i, p in enumerate(parts)) +
                "</CompleteMultipartUpload>").encode()
            status, _, xml = await s3_request(
                port, "POST", f"/{S3_BUCKET}/{mp}?uploadId={upload}", body)
            etag = hashlib.md5(b"".join(
                hashlib.md5(p).digest() for p in parts)).hexdigest()
            etag = f"{etag}-{len(parts)}"
            require(status == 200 and f'"{etag}"'.encode() in xml,
                    f"fs_rgw: complete: {status} {xml[:300]!r}")
            return etag
        mp_etag = await timed("s3_multipart", multipart())
        await timed("s3_multipart_get", get(mp, mp_etag))
        await label("fs_rgw_s3_acl")
        qs = sigv4.presign("GET", f"/{S3_BUCKET}/{names[0]}", S3_HOST,
                           *next(iter(S3_USERS.items())), expires=600)
        status, _, data = await s3_request(
            port, "GET", f"/{S3_BUCKET}/{names[0]}?{qs}", signed=False)
        require(status == 200 and data == mirror[names[0]],
                f"fs_rgw: presigned GET: {status}")
        status, _, _ = await s3_request(
            port, "GET", f"/{S3_BUCKET}/{names[0]}", signed=False)
        require(status == 403, f"fs_rgw: anonymous GET of a private "
                               f"object: {status}")
        mirror["public"] = rng.bytes(S3_OBJ)
        status, _, _ = await s3_request(
            port, "PUT", f"/{S3_BUCKET}/public", mirror["public"],
            headers={"x-amz-acl": "public-read"})
        require(status == 200, f"fs_rgw: public-read PUT: {status}")
        status, _, data = await s3_request(
            port, "GET", f"/{S3_BUCKET}/public", signed=False)
        require(status == 200 and data == mirror["public"],
                f"fs_rgw: anonymous GET of a public-read object: {status}")

        # -- 58. CephFS: mdtest-easy, `mds fail` during the creates ----------
        await label("fs_rgw_mount")
        clients = [await CephFSClient.create(
            c.monmap, None, FS_POOL, keyring=c.keyring, name=n,
            device="cuda") for n in FS_CLIENTS]
        for fc in clients:
            require(fc.ioctx.rados.monc.device.type == "cuda",
                    "fs_rgw: a CephFS client is not on the card")
        seen = [{} for _ in clients]
        for i, fc in enumerate(clients):
            # when this client's map shows the failure, the new active and
            # its own reconnect to rank 0
            real_fsmap, real_reconnect = fc._on_fsmap, fc._reconnect_rank

            def on_fsmap(fm, i=i, real=real_fsmap):
                holder = fm.rank_holder(0)
                if holder is None or holder.name != first_mds:
                    seen[i].setdefault("failed", time.perf_counter())
                    if holder is not None and holder.state == "active":
                        seen[i].setdefault("active", time.perf_counter())
                return real(fm)

            async def reconnect(rank, real=real_reconnect, i=i):
                await real(rank)
                seen[i].setdefault("reconnected", time.perf_counter())
            fc._on_fsmap, fc._reconnect_rank = on_fsmap, reconnect
        dirs = [f"/mdtest/{i}" for i in range(len(clients))]
        await clients[0].mkdir("/mdtest")
        await clients[0].mkdir("/ior")
        for i, fc in enumerate(clients):
            await fc.mkdir(dirs[i])
            await fc.mkdir(f"/ior/{i}")
        await label("fs_rgw_mdtest_create")
        failed = asyncio.Event()
        acked = [[] for _ in clients]

        async def fail_active():
            await cli("ceph_cli", "mds", "fail", first_mds)
            failed.set()

        async def creates(i):
            for j in range(MDT_FILES):
                if j == MDT_FILES - MDT_AFTER_FAIL:
                    await failed.wait()
                fh = await clients[i].open_file(f"{dirs[i]}/f{j:05d}", "w")
                await fh.close()
                acked[i].append(f"f{j:05d}")
        t0 = time.perf_counter()
        fail = asyncio.ensure_future(fail_active())
        await asyncio.gather(*[creates(i) for i in range(len(clients))])
        host_s["mdtest_create"] = time.perf_counter() - t0
        print(f"[{card}] fs_rgw_path mdtest_create: "
              f"{host_s['mdtest_create']:.3f} s", flush=True)
        await fail

        async def taken_over():
            fm = await fsmap()
            return fm.get("active") not in (None, first_mds)
        await wait_for(taken_over, "no standby took rank 0")
        rec["mds_failover"] = {
            "failed": first_mds, "active": (await fsmap())["active"],
            "clients": [{k: v - d["failed"] for k, v in d.items()}
                        for d in seen]}
        for d in seen:
            require({"failed", "active", "reconnected"} <= set(d),
                    f"fs_rgw: a client missed the failover: {seen}")
        host_s["mds_failover"] = min(d["active"] - d["failed"] for d in seen)
        host_s["mds_reconnect"] = max(d["reconnected"] - d["failed"]
                                      for d in seen)
        print(f"[{card}] fs_rgw_path failover: {rec['mds_failover']}",
              flush=True)
        for i, fc in enumerate(clients):
            listing = await fc.ls(dirs[i])
            require(listing == sorted(set(acked[i])) and
                    len(acked[i]) == MDT_FILES,
                    f"fs_rgw: {dirs[i]} holds {len(listing)} of "
                    f"{len(acked[i])} acknowledged files")

        async def stats(i):
            for name in acked[i]:
                got = await clients[i].stat(f"{dirs[i]}/{name}")
                require(got["type"] == "file" and got["size"] == 0,
                        f"fs_rgw: stat {dirs[i]}/{name}: {got}")
        await label("fs_rgw_mdtest_stat")
        await timed("mdtest_stat", asyncio.gather(
            *[stats(i) for i in range(len(clients))]))

        async def unlinks(i):
            for name in acked[i]:
                await clients[i].unlink(f"{dirs[i]}/{name}")
        await label("fs_rgw_mdtest_unlink")
        await timed("mdtest_unlink", asyncio.gather(
            *[unlinks(i) for i in range(len(clients))]))
        for i, fc in enumerate(clients):
            require(await fc.ls(dirs[i]) == [],
                    f"fs_rgw: {dirs[i]} not empty after the unlinks")

        # -- 59. ior-easy: a file per client, sequential 4 MiB transfers -----
        data = [[rng.bytes(IOR_XFER) for _ in range(IOR_SIZE // IOR_XFER)]
                for _ in clients]

        async def ior_write(i):
            fh = await clients[i].open_file(f"/ior/{i}/data", "w")
            for k, x in enumerate(data[i]):
                await fh.write(x, offset=k * IOR_XFER)
            await fh.close()

        async def ior_read(i):
            fh = await clients[i].open_file(f"/ior/{i}/data", "r")
            for k, x in enumerate(data[i]):
                got = await fh.read(IOR_XFER, offset=k * IOR_XFER)
                require(got == x, f"fs_rgw: /ior/{i}/data transfer {k} "
                                  f"differs from the mirror")
            await fh.close()
        await label("fs_rgw_ior_write")
        await timed("ior_write", asyncio.gather(
            *[ior_write(i) for i in range(len(clients))]))
        await label("fs_rgw_ior_read")
        await timed("ior_read", asyncio.gather(
            *[ior_read(i) for i in range(len(clients))]))

        # -- 60. a snapshot before a rewrite -----------------------------------
        await label("fs_rgw_snap")
        fc = clients[0]
        await timed("snap", fc.mkdir("/ior/0/.snap/s1"))
        new = rng.bytes(IOR_XFER)
        fh = await fc.open_file("/ior/0/data", "w")
        await fh.write(new, offset=IOR_XFER)
        await fh.close()
        fh = await fc.open_file("/ior/0/.snap/s1/data", "r")
        old = await fh.read(IOR_XFER, offset=IOR_XFER)
        await fh.close()
        fh = await fc.open_file("/ior/0/data", "r")
        head = await fh.read(IOR_XFER, offset=IOR_XFER)
        await fh.close()
        require(old == data[0][1] and head == new,
                "fs_rgw: the snapshot does not read back the old bytes")
        h["fs_clients"] = clients         # storm_path's, then unmounted

        # -- 61. an OSD hard-stopped; degraded GETs ---------------------------
        await label("fs_rgw_degraded")
        victim = f"osd.{S3_KILL}"
        await h["collect"]([victim])      # its launches, checked, so far
        t0 = time.perf_counter()
        c.children[victim].desired = "stopped"      # no respawn
        c.kill_daemon(victim)
        h["dead"].add(victim)

        async def down():
            st = await cl.status()
            return st.get("osdmap", {}).get("num_up_osds") == RBD_OSDS - 1
        await wait_for(down, f"{victim} was not marked down")
        host_s["detect"] = time.perf_counter() - t0
        await c.children[victim].proc.wait()
        picks = [names[int(k)] for k in rng.choice(
            S3_OBJS, S3_DEGRADED - 1, replace=False)]
        await timed("s3_degraded_get", bounded(S3_INFLIGHT, [
            lambda n=n: get(n) for n in picks] + [
            lambda: get(mp, mp_etag)]))
    finally:
        await gw.stop()
    rec["mds_stats"] = await mds_stats()
    gib = 1 << 30
    rec.update({
        "card": card,
        "layout": {"fs_pool": f"{FS_POOL} size 3 pg_num {FS_PGS}",
                   "mds": FS_MDS, "clients": len(FS_CLIENTS),
                   "s3_pool": "rbd_ec", "s3_objects": S3_OBJS,
                   "s3_object": S3_OBJ, "multipart": [S3_MP, S3_PART],
                   "mdtest_files": MDT_FILES, "ior": [IOR_SIZE, IOR_XFER],
                   "killed": victim},
        "host_s": host_s,
        "s3": {"put_GiBs": S3_OBJS * S3_OBJ / host_s["s3_put"] / gib,
               "get_GiBs": S3_OBJS * S3_OBJ / host_s["s3_get"] / gib,
               "degraded_get_GiBs": ((S3_DEGRADED - 1) * S3_OBJ + S3_MP) /
               host_s["s3_degraded_get"] / gib,
               "head_ops": S3_OBJS / host_s["s3_head"],
               "list_s": host_s["s3_list"],
               "multipart_s": host_s["s3_multipart"]},
        "cephfs": {
            "creates_per_s": len(clients) * MDT_FILES /
            host_s["mdtest_create"],
            "stats_per_s": len(clients) * MDT_FILES / host_s["mdtest_stat"],
            "unlinks_per_s": len(clients) * MDT_FILES /
            host_s["mdtest_unlink"],
            "ior_write_GiBs": len(clients) * IOR_SIZE /
            host_s["ior_write"] / gib,
            "ior_read_GiBs": len(clients) * IOR_SIZE /
            host_s["ior_read"] / gib},
        "failover": {"mds_fail_to_active_s": host_s["mds_failover"],
                     "reconnect_s": host_s["mds_reconnect"]},
        "phase_s": time.perf_counter() - t_phase})
    return rec


# -- the load generator and the Thrasher's storms (storm_path) ----------------
# On rbd_path's cluster after fs_rgw_path: a rados-bench-like session fleet
# through the port's loadgen, a seeded SIGKILL storm (qa's thrashosds on real
# PIDs) and an MDS failover storm, then the native benchmark harness through
# the port's reverse shim.
# sessions, ops each (a write, then a read or a write); every OSD's worst
# loop stall in it is gated below the heartbeat grace (at 2,000 sessions
# an 8.8 s WAL fsync behind twelve whole-table compactions marked three
# OSDs down once, before the WAL's compaction grew with the table)
LG_SESSIONS, LG_OPS = 2000, 2
LG_BYTES, LG_READS = 4096, 0.5         # 4 KiB writes; reads after a write
LG_CLIENTS, LG_INFLIGHT = 8, 64        # Rados handles; sessions in flight
STORM_WRITE_TIMEOUT = 30.0             # each storm write's deadline
STORM_SETTLE = 180.0                   # clean again after the SIGKILLs
MDS_STORM_WRITES = 10                  # files per client across the kill
MDS_TAKEOVER = 60.0                    # a standby active on rank 0 within
SHIM_SIZE, SHIM_ITERS = 262144, 16     # ec_bench --size, --iterations
SWEEP_PGS, SWEEP_CHUNK = 1 << 22, 1 << 20   # crush_sweep --checkpoint
STORM_LOG = "build/storm_path.log"     # the loadgen worker's and shim's
# a process that a tool starts (the loadgen worker, ec_bench's embedded
# interpreter) imports this at its start as ``sitecustomize`` when
# ``storm_steps`` puts it on PYTHONPATH; ``site_hooks`` hooks it
STORM_SITE = ("import os\n"
              "if os.environ.get('CHIP_SMOKE_HOOK'):\n"
              "    import chip_smoke\n"
              "    chip_smoke.site_hooks()\n")
LOADGEN_WORKER = ["-m", "ceph_tpu_torch.sim.loadgen", "--worker"]


def launch_record(tool: str, label, glog, clog) -> dict:
    """A process's launches of both kernels (``GfLaunchLog``,
    ``StepLaunchLog``), checked, filed under the parent's step ``label``."""
    return {"tool": tool, "label": label,
            "gf": {"launches": glog.real.launches, "checked": glog.checked,
                   "worst": glog.worst, "ms": sum(glog.ms.values())},
            "crush": {"launches": clog.real.launches,
                      "checked": clog.checked, "worst": clog.worst,
                      "ms": sum(e["ms"] for e in clog.by_label.values())}}


def write_site(here: str) -> str:
    """Writes ``STORM_SITE`` as ``build/storm_site/sitecustomize.py`` and
    returns the directory. The file is replaced whole, as the side
    process's phases and the main one's each write it while the other's
    tools may be starting."""
    site_dir = os.path.join(here, "build", "storm_site")
    os.makedirs(site_dir, exist_ok=True)
    tmp = os.path.join(site_dir, f"sitecustomize.py.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(STORM_SITE)
    os.replace(tmp, os.path.join(site_dir, "sitecustomize.py"))
    return site_dir


def site_hooks() -> None:
    """Both kernels' checking hooks in a process that ``CHIP_SMOKE_HOOK``
    names (``loadgen``: the loadgen worker, and no other process that
    inherits the environment; ``multihost``: a ``parallel.multihost``
    rank; ``ec_bench``: its embedded interpreter). Launches wait, timed
    by CUDA events, until the tool is done with the port (the worker or
    rank exits; ``ec_bench`` destroys its plugin, after its timed loop
    and ``--verify``, and never finalizes the interpreter):
    then each is held against its plain version and the counts go as one
    JSON line to the file ``CHIP_SMOKE_HOOK_LOG`` names."""
    import atexit
    import os
    tool = os.environ["CHIP_SMOKE_HOOK"]
    if tool == "loadgen" and sys.orig_argv[-3:] != LOADGEN_WORKER:
        return
    from ceph_tpu_torch.crush import kernels as ckern
    from ceph_tpu_torch.gf import kernels as gkern
    glog, clog = GfLaunchLog(gkern), StepLaunchLog(ckern)
    glog.label = clog.label = os.environ["CHIP_SMOKE_LABEL"]
    glog.__enter__()
    clog.__enter__()

    def finish():
        try:
            torch.cuda.synchronize()
            glog.drain(tool)
            clog.drain(tool)
        finally:                # a launch left unchecked fails the parent
            with open(os.environ["CHIP_SMOKE_HOOK_LOG"], "a") as f:
                f.write(json.dumps(launch_record(tool, glog.label, glog,
                                                 clog)) + "\n")
    if tool in ("loadgen", "multihost"):
        atexit.register(finish)
        return
    from ceph_tpu_torch.interop import ec_shim

    class Plugin:
        """The plugin as the shim holds it: ``ec_bench``'s destroy drops
        the one reference."""

        def __init__(self, h):
            self._h = h

        def __getattr__(self, name):
            return getattr(self._h, name)

        def __del__(self):
            finish()
    real_create = ec_shim.create
    ec_shim.create = lambda profile: Plugin(real_create(profile))


def resumable_sweep_step(here: str, host_s: dict) -> dict:
    """``utils.checkpoint.resumable_sweep`` of the canonical 10,240-OSD map
    on the card, stopped after two chunks, then ``crush_sweep
    --checkpoint --profile`` resumes it from the file; the saved counts
    must equal one sweep of all the PGs. Returns the CLI's record and
    the trace's CUDA kernel events (torch.profiler through CUPTI)."""
    import os
    import shutil

    from ceph_tpu_torch.bench import crush_sweep
    from ceph_tpu_torch.crush.mapper import Mapper
    from ceph_tpu_torch.utils.checkpoint import SweepState, resumable_sweep
    ckpt = os.path.join(here, "build", "storm_sweep.json")
    trace_dir = os.path.join(here, "build", "storm_sweep_trace")
    for stale in (ckpt, ckpt + ".tmp"):
        if os.path.exists(stale):
            os.remove(stale)
    shutil.rmtree(trace_dir, ignore_errors=True)
    cmap = crush_sweep.canonical_map()
    mapper = Mapper(cmap, device="cuda")
    t0 = time.perf_counter()
    state, done = resumable_sweep(cmap, 0, SWEEP_PGS, 3, ckpt,
                                  chunk=SWEEP_CHUNK, mapper=mapper,
                                  max_chunks=2)
    require(not done and state.cursor == 2 * SWEEP_CHUNK,
            f"storm: the first run stopped at {state.cursor}")
    res = crush_sweep.main(["--num-pgs", str(SWEEP_PGS), "--chunk",
                            str(SWEEP_CHUNK), "--checkpoint", ckpt,
                            "--profile", trace_dir, "--device", "cuda"])
    host_s["sweep"] = time.perf_counter() - t0
    counts, bad = mapper.sweep(0, 0, SWEEP_PGS, 3)
    final = SweepState.load(ckpt)
    require(res["done"] and res["cursor"] == SWEEP_PGS and
            np.array_equal(final.counts, counts.cpu().numpy()) and
            final.bad == int(bad),
            f"storm: the resumed sweep {res} differs from one sweep")
    (trace,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return dict(res, trace_kernel_events=len(kernels),
                trace_crush_events=sum("crush" in k for k in kernels))


async def storm_steps(h) -> dict:
    """The load generator and the Thrasher's storms on ``rbd_path``'s
    running cluster (steps 62-67); ``h`` carries the phase's cluster,
    client and helpers. Returns the phase's record; every check raises."""
    import os
    import site

    from ceph_tpu_torch.interop import native
    from ceph_tpu_torch.sim import Thrasher
    from ceph_tpu_torch.sim.loadgen import run_sharded

    c, cl, card, label = h["c"], h["cl"], h["card"], h["label"]
    host_s, rec = {}, {}
    t_phase = time.perf_counter()
    log_path = os.path.join(h["here"], STORM_LOG)
    if os.path.exists(log_path):
        os.remove(log_path)

    async def timed(what, coro):
        t0 = time.perf_counter()
        out = await coro
        host_s[what] = time.perf_counter() - t0
        print(f"[{card}] storm_path {what}: {host_s[what]:.3f} s", flush=True)
        return out

    async def fsmap():
        return (await cl.status()).get("fsmap") or {}

    site_dir = write_site(h["here"])

    def hooked(tool: str) -> dict:
        """The environment under which ``site_hooks`` hooks a process of
        ``tool``, whose record goes to ``<STORM_LOG>.<tool>``."""
        log = f"{log_path}.{tool}"
        if os.path.exists(log):
            os.remove(log)
        return {"CHIP_SMOKE_HOOK": tool, "CHIP_SMOKE_HOOK_LOG": log,
                "CHIP_SMOKE_LABEL": f"storm_{tool}",
                "PYTHONPATH": os.pathsep.join(
                    [site_dir, h["here"], *site.getsitepackages(),
                     *filter(None, [os.environ.get("PYTHONPATH")])])}

    def hooked_record(tool: str) -> dict:
        with open(f"{log_path}.{tool}") as f:
            (one,) = [json.loads(line) for line in f]
        return one

    async def survey():
        """What the storms may change only where they mean to: the mons'
        election epochs, each mgr's promotions and demotions, the rank-0
        MDS, the markdowns so far."""
        return {"elections": await h["election_epochs"](),
                "mgr_moves": {n: s["moves"] for n, s in
                              (await h["mgr_stats"]()).items()},
                "mds": (await fsmap()).get("active"),
                "downs": [e for e in h["events"] if e[0] == "down"]}

    # -- 62. the hard-stopped OSD back; clean -------------------------------
    victim = f"osd.{S3_KILL}"
    h["dead"].discard(victim)
    c.smoke_label = "storm_revive"
    t0 = time.perf_counter()
    await c.revive_daemon(victim)
    await c.wait_for_daemon_ready(victim, CL_DEADLINE)
    await label("storm_revive")
    await c.wait_for_osds_up(RBD_OSDS, CL_DEADLINE)
    await c.wait_for_clean(CL_DEADLINE)
    host_s["revive_to_clean"] = time.perf_counter() - t0
    before = await survey()

    # -- 63. loadgen: one worker process on the k=8 m=3 pool ----------------
    await label("storm_loadgen")
    # the worker inherits this process's environment while run_sharded runs
    env = hooked("loadgen")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        report = await timed("loadgen", run_sharded(
            c, "rbd_ec", sessions=LG_SESSIONS, workers=1,
            clients=LG_CLIENTS, ops_per_session=LG_OPS,
            write_bytes=LG_BYTES, read_fraction=LG_READS,
            concurrency=LG_INFLIGHT, op_timeout=120.0, seed=SEED))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    worker = hooked_record("loadgen")
    osds = [n for n in c.children if n.startswith("osd.")]
    lags = await asyncio.gather(*[h["ask"](n, "smoke stats") for n in osds])
    stalls = {n: x["loop_lag"]["by_step"].get("storm_loadgen", 0.0)
              for n, x in zip(osds, lags)}
    grace = c.cfg["osd_heartbeat_grace"]
    print(f"[{card}] storm_path loadgen: the OSDs' worst loop stall "
          f"{max(stalls.values()):.3f} s (grace {grace} s): {stalls}",
          flush=True)
    require(max(stalls.values()) < grace,
            f"storm: an OSD's loop stalled past the {grace} s heartbeat "
            f"grace in loadgen: {stalls}")
    require(report["errors"] == 0 and
            report["ops"] == LG_SESSIONS * LG_OPS,
            f"storm: loadgen {report['ops']} ops, {report['errors']} errors "
            f"{report['error_samples']}")
    # its one-PG lookups are on the k=8 m=3 pool, whose `indep` rule the
    # rule VM maps (the kernel takes straw2 `chooseleaf firstn` only): its
    # crush_straw2 launches are those of any replicated-pool lookup
    require(worker["gf"]["checked"] == worker["gf"]["launches"] and
            worker["crush"]["checked"] == worker["crush"]["launches"],
            f"storm: the loadgen worker's launches {worker}")
    rec["loadgen"] = {k: report[k] for k in (
        "sessions", "ops", "errors", "wall_s", "ops_per_s", "p50_ms",
        "p99_ms", "max_ms")}
    rec["loadgen"]["worker"] = worker
    rec["loadgen"]["osd_worst_stall_s"] = max(stalls.values())
    rec["loadgen"]["osd_stall_s"] = stalls
    print(f"[{card}] storm_path loadgen: {json.dumps(rec['loadgen'])}",
          flush=True)

    # -- 64. proc_storm on the k=8 m=3 pool ----------------------------------
    # no gray pass: the smoke's OSD heartbeat grace (3 s) is shorter than
    # the OSD_SLOW confirm window, so a SIGSTOPped OSD is marked down before
    # it shows as slow; tests/test_torch_storm_proc.py runs it at 10 s
    await label("storm_proc")
    first = f"osd.{c.n_osds - 1}"          # the storm SIGKILLs it
    ec_io = await cl.open_ioctx("rbd_ec")
    before_proc = await survey()
    th = Thrasher(c, seed=SEED, write_timeout=STORM_WRITE_TIMEOUT)
    # its launches so far; those of the writer's 0.5 s head start before
    # the SIGKILL die with it unchecked and uncounted
    await h["collect"]([first])
    summary = await timed("proc_storm", th.proc_storm(
        ec_io, settle_timeout=STORM_SETTLE, gray=False))
    after_proc = await survey()
    require(summary["failed_writes"] == 0 and summary["acked_writes"] > 0
            and summary["killed_mons"] == 1 and
            summary["mgr_failover"] is not None and
            set(summary["restarts"]) >= {first},
            f"storm: proc_storm {summary}")
    rec["proc_storm"] = dict(summary, actions=th.actions_log)
    await asyncio.gather(*[c.wait_for_daemon_ready(n, CL_DEADLINE)
                           for n in c.children if n not in h["dead"]])
    await label("storm_proc")

    # -- 65. mds_storm with fs_rgw_path's two clients -------------------------
    # the MDS that `mds fail` removed stopped serving: a fresh incarnation
    # of it is the standby the storm's kill needs
    await label("storm_mds")
    mdss = [n for n in c.children if n.startswith("mds.")]
    st = await fsmap()
    stopped = next(n for n in mdss if n[4:] != st["active"])
    await h["collect"]([stopped])         # its launches, before it stops
    t0 = time.perf_counter()
    await c.revive_mds(stopped[4:])
    await c.wait_for_daemon_ready(stopped, CL_DEADLINE)

    async def one_standby():
        fm = await fsmap()
        return fm.get("active") and fm.get("standby_count") == 1
    await h["wait_for"](one_standby, "the revived MDS never stood by")
    host_s["mds_revive"] = time.perf_counter() - t0
    before_mds = await survey()
    mth = Thrasher(c, seed=SEED + 1)
    real_kill_mds = c.kill_mds

    async def kill_mds(name):
        # the victim's launches up to its kill (those of the zombie's
        # connect, a moment, die with it unchecked and uncounted)
        await h["collect"]([f"mds.{name}"])
        return await real_kill_mds(name)
    c.kill_mds = kill_mds
    try:
        mds = await timed("mds_storm", mth.mds_storm(
            h["fs_clients"], writes=MDS_STORM_WRITES, files_before_kill=2,
            takeover_timeout=MDS_TAKEOVER))
    finally:
        del c.kill_mds
    require(mds["errors"] == 0 and len(mds["takeover_s"]) == 1 and
            mds["acked_writes"] == len(h["fs_clients"]) * MDS_STORM_WRITES,
            f"storm: mds_storm {mds}")
    rec["mds_storm"] = dict(mds, actions=mth.actions_log)
    for fc in h["fs_clients"]:
        await fc.unmount()
    await asyncio.gather(*[c.wait_for_daemon_ready(n, CL_DEADLINE)
                           for n in mdss])
    after_mds = await survey()

    # -- 66. ec_bench through the port's reverse shim -------------------------
    await label("storm_ec_bench")
    build = await asyncio.get_running_loop().run_in_executor(
        None, native.build_native_shim)
    rec["ec_bench"] = {}
    for workload, extra in (("encode", []),
                            ("decode", ["--erasures", str(min(2, M))])):
        env = dict(os.environ, **hooked("ec_bench"))
        t0 = time.perf_counter()
        proc = await asyncio.create_subprocess_exec(
            str(build / "ec_bench"), "--plugin", "jax", "--dir", str(build),
            "--workload", workload, "--size", str(SHIM_SIZE),
            "--iterations", str(SHIM_ITERS), "--parameter", f"k={K}",
            "--parameter", f"m={M}", "--verify", *extra, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        out, err = await proc.communicate()
        host_s[f"ec_bench_{workload}"] = time.perf_counter() - t0
        err = err.decode(errors="replace")
        require(proc.returncode == 0 and "verify: ok" in err,
                f"storm: ec_bench {workload} exited {proc.returncode}: "
                f"{err[-1500:]}")
        launched = hooked_record("ec_bench")
        require(launched["gf"]["launches"] > 0 and
                launched["gf"]["checked"] == launched["gf"]["launches"],
                f"storm: ec_bench {workload} launched {launched}")
        secs, mbs = out.decode().split()
        rec["ec_bench"][workload] = {"seconds": float(secs),
                                     "MB_per_s": float(mbs),
                                     "launches": launched}
    print(f"[{card}] storm_path ec_bench: {json.dumps(rec['ec_bench'])}",
          flush=True)

    # -- 67. a resumable CRUSH sweep: two chunks, then crush_sweep resumes --
    await label("storm_sweep")
    rec["sweep"] = resumable_sweep_step(h["here"], host_s)
    print(f"[{card}] storm_path sweep: {json.dumps(rec['sweep'])}",
          flush=True)
    end = await survey()

    # -- what the storms may change, and only where they mean to -------------
    def changed(a, b):
        return {n: (b["elections"][n] - a["elections"][n]) // 2
                for n in a["elections"] if n in b["elections"]}
    killed_mon = next(a.split()[1] for a in th.actions_log
                      if a.endswith("(lead mon)"))
    killed_mgr = summary["mgr_failover"][0]
    rec["elections"] = {"before_storms": changed(before, before_proc),
                        "proc_storm": changed(before_proc, after_proc),
                        "after": changed(after_proc, end)}
    require(not any(rec["elections"]["before_storms"].values()) and
            not any(rec["elections"]["after"].values()) and
            all(v >= 1 for n, v in rec["elections"]["proc_storm"].items()
                if n != killed_mon),
            f"storm: elections {rec['elections']}, want them only in the "
            f"lead mon's SIGKILL")
    downs = end["downs"][len(before["downs"]):]
    rec["markdowns"] = downs
    require({f"osd.{e[1]}" for e in downs} <= {first},
            f"storm: markdowns {downs}, want at most {first}'s")
    moves = {n: {k: end["mgr_moves"][n][k] - before["mgr_moves"][n][k]
                 for k in ("promote", "demote")}
             for n in before["mgr_moves"] if n != killed_mgr}
    rec["mgr_moves"] = {"survivor": moves,
                        "killed": [killed_mgr, end["mgr_moves"][killed_mgr]]}
    require(all(m == {"promote": 1, "demote": 0} for m in moves.values())
            and end["mgr_moves"][killed_mgr] == {"promote": 0, "demote": 0},
            f"storm: mgr moves {rec['mgr_moves']}, want the survivor's one "
            f"promotion")
    require(before_mds["mds"] == before["mds"] and
            after_mds["mds"] not in (None, before_mds["mds"]) and
            end["mds"] == after_mds["mds"],
            f"storm: rank 0 held by {before['mds']}, {before_mds['mds']}, "
            f"{after_mds['mds']}, {end['mds']}")
    rec.update({"card": card,
                "layout": {"pool": "rbd_ec", "loadgen": {
                    "sessions": LG_SESSIONS, "ops_per_session": LG_OPS,
                    "write_bytes": LG_BYTES, "read_fraction": LG_READS,
                    "clients": LG_CLIENTS, "in_flight": LG_INFLIGHT,
                    "workers": 1},
                    "proc_storm": {"write_timeout": STORM_WRITE_TIMEOUT,
                                   "settle": STORM_SETTLE, "gray": False},
                    "mds_storm": {"writes": MDS_STORM_WRITES, "kills": 1},
                    "ec_bench": {"size": SHIM_SIZE,
                                 "iterations": SHIM_ITERS}},
                "host_s": host_s,
                "phase_s": time.perf_counter() - t_phase})
    return rec


# -- the multi-device layer (steps 68-71) --------------------------------------
MD_PGS = 100_000_000                  # bench/multichip's pod-scale target
MD_OSDS = 10240                       # the canonical map
MD_SLOTS = 4                          # slots of the card mesh in (b)
MD_MAP_N = (1 << 21) + 17             # sharded_map_pgs lanes in (b)
MD_EDGE = 1 << 16                     # lanes checked at each 100M shard edge
MD_SPEC_ROWS = 64                     # rows against the scalar spec
MD_RANKS, MD_RANK_TIMEOUT = 2, 180    # multihost ranks; each one's bound (s)
MD_LOG = "build/multi_device_path.log"


class EdgeLaunchLog(LaunchLog):
    """``LaunchLog`` for sweeps of ``MD_PGS`` PGs, where the plain version
    would take ~1.3 s for each 2^21-lane tile (over a minute a sweep):
    while ``edges`` is set, every launch is timed and counted, but only
    the first ``lanes`` lanes of a tile whose first seed starts a shard,
    and the last ``lanes`` of one whose last seed ends a shard (the seeds
    in ``edges``), are held against the plain version. Launches of at
    most ``2 * lanes`` lanes, and every launch while ``edges`` is None,
    are checked whole. A launch reads nothing back: its head and tail are
    kept on the card, and ``drain`` picks the edges among them."""

    def __init__(self, kernels, lanes: int):
        super().__init__(kernels)
        self.edges, self.lanes = None, lanes
        self.lanes_checked = self.lanes_run = 0

    def launch(self, pt, xs, numrep):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        leaves, bad = self.real(pt, xs, numrep)
        end.record()
        n, k = int(xs.shape[0]), self.lanes
        if self.edges is None or n <= 2 * k:
            parts = [(slice(None), None)]
        else:
            parts = [(slice(0, k), 0), (slice(n - k, n), -1)]
        self.lanes_run += n
        self.pending.append((pt, numrep, start, end, [
            (xs[sl].clone(), leaves[sl].clone(), bad[sl].clone(), at)
            for sl, at in parts]))
        return leaves, bad

    def drain(self, what: str) -> None:
        for pt, numrep, start, end, parts in self.pending:
            end.synchronize()
            # the plain version's temps are (lanes, candidates, widest
            # level) int64: chunk the lanes to ~256 MiB a temp (the phase
            # runs last, beside what the earlier phases hold on the card)
            width = max(lv[1] for lv in pt.plan.level_sizes)
            chunk = min(1 << 16, max(256, (1 << 25) //
                                     (width * (numrep + 2))))
            for xs, leaves, bad, at in parts:
                if at is not None and int(xs[at]) & _M32 not in self.edges:
                    continue
                plain, plain_bad = self.kernels.crush_straw2_plain(
                    pt, xs, numrep, chunk=chunk)
                diff = int((leaves.long() - plain.long()).abs().max()) \
                    if plain.numel() else 0
                self.worst = max(self.worst, diff)
                require(diff == 0 and torch.equal(bad, plain_bad),
                        f"{what}: a crush_straw2 launch differs from its "
                        f"plain version on {xs.shape[0]} lanes")
                self.lanes_checked += int(xs.shape[0])
            self.checked += 1
        self.pending.clear()


def multi_device_path_phase(card: str) -> dict:
    """The multi-device layer on the one card (steps 68-71): the 100M-PG
    aggregated sweep of the canonical map through ``bench.multichip``, the
    sharded paths on a four-slot mesh of the card, and two
    ``parallel.multihost`` ranks over gloo. Every launch of both kernels
    is held against its plain version (the 100M sweeps at their shards'
    edges, ``EdgeLaunchLog``); the counts are set to 0 just before each
    sharded path and read just after. Returns the phase's record with
    ``crush`` and ``gf`` as (launches, worst error); every check raises."""
    import gc
    import os
    import site

    from ceph_tpu_torch.bench import crush_sweep, multichip, osdmaptool
    from ceph_tpu_torch.crush import kernels as ckern
    from ceph_tpu_torch.crush.mapper import Mapper
    from ceph_tpu_torch.crush.sharded_sweep import sharded_map_pgs, \
        sharded_sweep
    from ceph_tpu_torch.ec import matrix as rs
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.gf import kernels as gkern
    from ceph_tpu_torch.gf import tables
    from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
    from ceph_tpu_torch.parallel import local_mesh, sharded_decode, \
        sharded_encode
    from ceph_tpu_torch.parallel.sharded import gather, shard_batch
    from ceph_tpu_torch.utils.devmon import devmon

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"card": card, "card_allocated_GiB_at_start":
           torch.cuda.memory_allocated() / 2**30}
    launches = {"crush": {}, "gf": {}}

    # the hooks hold the wrappers, whose counts move only at a launch
    clog = EdgeLaunchLog(ckern, MD_EDGE)
    glog = GfLaunchLog(gkern)

    def reset():
        clog.real.launches = glog.real.launches = 0

    def read(step):
        launches["crush"][step] = clog.real.launches
        launches["gf"][step] = glog.real.launches

    with clog, glog:
        # -- 68. the 100M-PG sweep of the canonical map, one slot ---------
        one = local_mesh()
        require(one.size == 1, f"local_mesh() has {one.size} slots")
        clog.edges = {0, MD_PGS - 1}      # each 100M sweep is one shard
        reset()
        t0 = time.perf_counter()
        bench = multichip.main(["--crush-pgs", str(MD_PGS), "--num-osds",
                                str(MD_OSDS)])
        mapper = Mapper(crush_sweep.canonical_map(MD_OSDS), device="cuda")
        counts, bad = sharded_sweep(one, mapper, 0, 0, MD_PGS, 3)
        read("multichip")
        rec["flagged_lanes_100M"] = mapper.flagged_lanes
        rec["multichip_host_s"] = time.perf_counter() - t0
        want, want_bad = Mapper(crush_sweep.canonical_map(MD_OSDS),
                                device="cuda").sweep(0, 0, MD_PGS, 3)
        sweep = bench["crush_multichip"]
        require(torch.equal(counts, want) and int(bad) == int(want_bad),
                "multi-device: the sharded 100M sweep's counts differ from "
                "the unsharded sweep's")
        require(sweep["extrapolated"] is False and sweep["measured"] and
                sweep["n_pgs"] == MD_PGS and sweep["n_osds"] == MD_OSDS and
                sweep["path"] == "kernel+sharded" and
                sweep["platform"] == "gpu" and
                sweep["bad_mappings"] == int(want_bad) and
                sweep["placements"] == int(want.sum()) == 3 * MD_PGS,
                f"multi-device: crush_multichip {sweep}")
        clog.drain("multichip")
        glog.drain("multichip")
        clog.edges = None
        rec["crush_multichip"] = sweep
        rec["table"] = bench["table"]
        print(f"[{card}] multi_device_path: {MD_PGS} PGs of the "
              f"{MD_OSDS}-OSD map in {sweep['seconds_wall']} s wall, "
              f"{sweep['mappings_per_s']} mappings/s (one slot; "
              f"measured, not extrapolated; the kernel flagged "
              f"{rec['flagged_lanes_100M']} lanes to the rule VM)",
              flush=True)

        # -- 69. the sharded code on a four-slot mesh of the card ---------
        mesh = local_mesh(MD_SLOTS, device="cuda:0")
        mp = Mapper(crush_sweep.canonical_map(MD_OSDS), device="cuda")
        xs = torch.arange(MD_MAP_N, dtype=torch.int64, device="cuda")
        reset()
        got = sharded_map_pgs(mesh, mp, 0, xs, 3)
        torch.cuda.synchronize()
        read("sharded_map_pgs")
        require(mp.last_map_path == "kernel+sharded" and
                launches["crush"]["sharded_map_pgs"] == MD_SLOTS and
                not mp._replicas,
                f"multi-device: sharded_map_pgs ran {mp.last_map_path}, "
                f"{launches['crush']['sharded_map_pgs']} launches, "
                f"replicas {list(mp._replicas)}")
        require(torch.equal(got, mp.map_pgs(0, xs, 3)),
                "multi-device: sharded_map_pgs differs from map_pgs")
        local_n = -(-MD_MAP_N // MD_SLOTS)
        rows = sorted({0, MD_MAP_N - 1} | {
            b for s_ in range(1, MD_SLOTS) for b in
            (s_ * local_n - 1, s_ * local_n)} | set(np.linspace(
                0, MD_MAP_N - 1, MD_SPEC_ROWS).astype(int).tolist()))
        spec_rows = scalar_rows((mp.map, 0, rows, 3, None, None))
        require(np.array_equal(got[rows].cpu().numpy(),
                               np.asarray(spec_rows)),
                "multi-device: sharded rows differ from the scalar spec")
        om = osdmaptool.create_simple(MD_OSDS, 1 << 16, 3, erasure=False)
        sharded0 = devmon().perf.dump()["launches_sharded"]
        reset()
        mm = OSDMapMapping(om, mesh=mesh, mesh_min_batch=1)
        torch.cuda.synchronize()
        read("osdmap_mapping")
        rec["launches_sharded"] = \
            devmon().perf.dump()["launches_sharded"] - sharded0
        require(mm.last_sharded_sweeps > 0 and rec["launches_sharded"] > 0,
                f"multi-device: {mm.last_sharded_sweeps} sharded sweeps, "
                f"launches_sharded {rec['launches_sharded']}")
        om.attach_mesh(None)
        plain_mm = OSDMapMapping(om)
        for pid in om.pools:
            for name in TABLES:
                require(np.array_equal(getattr(mm._pools[pid], name),
                                       getattr(plain_mm._pools[pid], name)),
                        f"multi-device: the sharded table's {name} "
                        f"differs from the mesh-less table's")
        clog.drain("sharded_crush")

        registry = ErasureCodePluginRegistry.instance()
        ec = registry.factory("jax", f"k={K} m={M} technique=reed_sol_van")
        coding = rs.coding_matrix("reed_sol_van", K, M)
        dmat = rs.decode_matrix("reed_sol_van", K, M, tuple(AVAIL),
                                tuple(ERASED))
        enc, dec = (tuple(torch.as_tensor(a, device="cuda") for a in (
            tables.expand_bitmatrix(mat), *tables.nibble_tables(mat)))
            for mat in (coding, dmat))
        data = random_bytes((B, K, C), SEED + 14)
        parts = shard_batch(mesh, data)
        reset()
        parity = sharded_encode(mesh, *enc, parts)
        full = tuple(torch.cat([d, p], dim=1) for d, p in zip(parts, parity))
        rebuilt = sharded_decode(mesh, *dec, tuple(
            f[:, AVAIL].contiguous() for f in full))
        torch.cuda.synchronize()
        read("sharded_ec")
        want_parity = ec.encode_batch(data)
        require(torch.equal(gather(parity), want_parity),
                "multi-device: sharded parity differs from encode_batch")
        chunks = torch.cat([data, want_parity], dim=1)[:, AVAIL].contiguous()
        require(torch.equal(gather(rebuilt),
                            ec.decode_batch(ERASED, AVAIL, chunks)) and
                torch.equal(gather(rebuilt), data[:, ERASED]),
                "multi-device: sharded decode differs from decode_batch")
        glog.drain("sharded_ec")
        # the encode's rate at one and four slots, timed without the hook's
        # per-launch events; every timed launch's parity is then held
        # against the plain version here
        rec["encode_GiBs"], timed = {}, []
        gkern.gf_encode = glog.real
        try:
            for slots in (1, MD_SLOTS):
                msh = local_mesh(slots, device="cuda:0")
                split = shard_batch(msh, data)
                ms = events_ms(lambda: timed.append(
                    (split, sharded_encode(msh, *enc, split))), 5)
                rec["encode_GiBs"][slots] = B * K * C / (ms / 1e3) / 2**30
        finally:
            gkern.gf_encode = glog.launch
        for split, out in timed:
            for x, y in zip(split, out):
                err = max_err_vs_plain(gkern, enc[0], x, y, 256)
                require(err == 0, "multi-device: a timed sharded encode "
                                  "differs from the plain version")
        rec["timed_encode_launches"] = sum(len(o) for _, o in timed)
        print(f"[{card}] multi_device_path: sharded encode at "
              f"({B}, {K}, {C}): " + ", ".join(
                  f"{n} slot{'s' if n > 1 else ''} {v:.2f} GiB/s"
                  for n, v in rec["encode_GiBs"].items()), flush=True)

        # -- 70. two ranks on the card (gloo) -----------------------------
        site_dir = write_site(here)
        log_path = os.path.join(here, MD_LOG)
        sock = __import__("socket").socket()
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
        sock.close()
        procs, t_spawn = [], time.perf_counter()
        try:
            for r in range(MD_RANKS):
                hook_log = f"{log_path}.{r}"
                if os.path.exists(hook_log):
                    os.remove(hook_log)
                env = dict(os.environ, CHIP_SMOKE_HOOK="multihost",
                           CHIP_SMOKE_HOOK_LOG=hook_log,
                           CHIP_SMOKE_LABEL="multi_device_ranks",
                           PYTHONPATH=os.pathsep.join(
                               [site_dir, here, *site.getsitepackages(),
                                *filter(None,
                                        [os.environ.get("PYTHONPATH")])]))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ceph_tpu_torch.parallel.multihost",
                     "--coordinator", coord, "--num-processes",
                     str(MD_RANKS), "--process-id", str(r),
                     "--local-devices", str(MD_SLOTS)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                    cwd=here))
            outs, walls = [], []
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=MD_RANK_TIMEOUT)
                walls.append(time.perf_counter() - t_spawn)
                require(p.returncode == 0,
                        f"multi-device: rank {r} exited {p.returncode}: "
                        f"{err.decode(errors='replace')[-1500:]}")
                outs.append(json.loads(out.decode().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        hooked = []
        for r in range(MD_RANKS):
            with open(f"{log_path}.{r}") as f:
                (one_rec,) = [json.loads(line) for line in f]
            hooked.append(one_rec)
            print(f"[{card}] multi_device_path rank {r}: "
                  f"{json.dumps(one_rec)}", flush=True)
        # the ranks' batch, encoded here in one launch
        bm4 = torch.as_tensor(tables.expand_bitmatrix(
            rs.coding_matrix("reed_sol_van", 4, 2)), device="cuda")
        batch = np.random.default_rng(7).integers(
            0, 256, size=(8 * MD_RANKS, 4, 4096), dtype=np.uint8)
        local_sum = int(gkern.gf_encode(bm4, torch.as_tensor(
            batch, device="cuda")).to(torch.int64).sum()) & _M32
        glog.drain("ranks_local")
        require(all(o["ok"] and o["processes"] == MD_RANKS and
                    o["global_devices"] == MD_RANKS * MD_SLOTS and
                    o["ec_checksum"] == local_sum and
                    o["crush_placements"] == 3 * 256 * MD_RANKS * MD_SLOTS
                    for o in outs),
                f"multi-device: the ranks' records {outs}, local checksum "
                f"{local_sum}")
        require(all(h["gf"]["launches"] > 0 and h["crush"]["launches"] > 0
                    and h["gf"]["checked"] == h["gf"]["launches"]
                    and h["crush"]["checked"] == h["crush"]["launches"]
                    for h in hooked),
                f"multi-device: the ranks' launches {hooked}")
        launches["crush"]["ranks"] = sum(h["crush"]["launches"]
                                         for h in hooked)
        launches["gf"]["ranks"] = sum(h["gf"]["launches"] for h in hooked)
        rec["ranks"] = {"records": outs, "launches": hooked,
                        "spawn_to_exit_s": walls,
                        "kernel_ms": [h["gf"]["ms"] + h["crush"]["ms"]
                                      for h in hooked]}
        print(f"[{card}] multi_device_path: {MD_RANKS} ranks of "
              f"{MD_SLOTS} slots, spawn to exit "
              + ", ".join(f"{w:.2f}" for w in walls) + " s (their kernels "
              + ", ".join(f"{x:.3f}" for x in rec["ranks"]["kernel_ms"])
              + " ms)", flush=True)

    # -- 71. every step launched both kernels; the record -----------------
    for kern in ("crush", "gf"):
        for step, n in launches[kern].items():
            if kern == "gf" and step in ("sharded_map_pgs",
                                         "osdmap_mapping"):
                continue
            if kern == "crush" and step == "sharded_ec":
                continue
            require(n > 0, f"multi-device: {step} launched no {kern} "
                           f"kernel")
    rec["plain_checks"] = {
        "crush_launches": clog.checked, "crush_lanes_run": clog.lanes_run,
        "crush_lanes_checked": clog.lanes_checked,
        "crush_edge_lanes": f"the first {MD_EDGE} lanes of each shard's "
                            f"first tile and the last {MD_EDGE} of its last "
                            f"in every {MD_PGS}-PG sweep; every lane of "
                            f"every other launch",
        "gf_launches": glog.checked + rec["timed_encode_launches"]}
    rec["launches"] = launches
    rec["layout"] = {"pgs": MD_PGS, "osds": MD_OSDS, "slots": MD_SLOTS,
                     "map_pgs": MD_MAP_N, "ec": [B, K, M, C],
                     "ranks": MD_RANKS}
    rec["phase_s"] = time.perf_counter() - t_phase
    print("multi_device_path: " + json.dumps(rec), flush=True)
    return dict(rec, crush=(sum(launches["crush"].values()), clog.worst),
                gf=(sum(launches["gf"].values()), glog.worst))


def osd_cluster_runs(n: int, budget: float, start_only: bool) -> None:
    """``osd_cluster_path`` alone, ``n`` times in a row (no new run
    starts after ``budget`` seconds); ``start_only``: only the cluster's
    start, gated and recorded, then its stop. Each run's outcome and
    start on a line, the daemons' log of a failed run kept as
    ``build/osd_cluster_path.<run>.log``, and at the end the starts
    together: their seconds, elections, epochs won by two mons, collect
    and begin timeouts and slow commands. Exits 1 if any run failed."""
    import shutil
    import traceback
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    from ceph_tpu_torch.utils import cuda_build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cuda_build.build(["gf_encode", "crush_straw2"])
    here = os.path.dirname(os.path.abspath(__file__))
    t0, runs = time.perf_counter(), []
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        for i in range(n):
            if time.perf_counter() - t0 > budget:
                break
            t1 = time.perf_counter()
            try:
                osd_cluster_path_phase(card, pool, start_only)
                runs.append({"run": i, "ok": True})
            except Exception as e:
                traceback.print_exc()
                runs.append({"run": i, "ok": False, "why": str(e)[:400]})
                shutil.copy(os.path.join(here, CL_LOG), os.path.join(
                    here, f"build/osd_cluster_path.{i}.log"))
            runs[-1]["s"] = time.perf_counter() - t1
            print(f"[{card}] osd_cluster_runs: {json.dumps(runs[-1])}",
                  flush=True)
    print(f"[{card}] osd_cluster_runs starts: " + json.dumps({
        "starts": len(STARTS), "started": sum(s["ok"] for s in STARTS),
        "s": [s["s"] for s in STARTS],
        "elections": [s["elections"] for s in STARTS],
        "starts_with_a_split": sum(bool(s["split_epochs"])
                                   for s in STARTS),
        "split_epochs": [s["split_epochs"] for s in STARTS
                         if s["split_epochs"]],
        "collect_timeouts": [s["collect_timeouts"] for s in STARTS],
        "begin_timeouts": [s["begin_timeouts"] for s in STARTS],
        "slow_commands": [sum(len(v or []) for v in
                              s["slow_commands"].values())
                          for s in STARTS]}), flush=True)
    print(f"[{card}] osd_cluster_runs: {sum(r['ok'] for r in runs)} of "
          f"{len(runs)} passed", flush=True)
    sys.exit(0 if runs and all(r["ok"] for r in runs) else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--proc-child"]:
        proc_child(sys.argv[2:])
    elif sys.argv[1:2] == ["--cli-child"]:
        cli_child(sys.argv[2:])
    elif sys.argv[1:2] == ["--osd-cluster-runs"]:
        # --osd-cluster-runs N [BUDGET_S] [--start-only]
        args = [a for a in sys.argv[2:] if a != "--start-only"]
        osd_cluster_runs(int(args[0]), float(args[1]) if len(args) > 1
                         else float("inf"), "--start-only" in sys.argv)
    else:
        main()
