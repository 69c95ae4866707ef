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
4. Times (CUDA events) at the flagship shape: the kernel and its plain
   version for encode and decode, the bound, and the port's benchmark.

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

Last: one JSON line listing both kernels, then the card from
nvidia-smi, then the last line ``{"ok": true, "device": {...}}``.

It exits with code 2, before any work, when no CUDA device is present.
"""

from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
B, K, M, C = 64, 8, 3, 524288          # flagship: 4 MiB objects, k=8 m=3
ERASED, AVAIL = [0, 1], list(range(2, 2 + K))
PLAIN_SLICE = 8                        # stripes per plain-version check
CRUSH_N = 1 << 21                      # PG lanes of the CRUSH main path
CRUSH_SAMPLE = 2048                    # PGs held against the scalar spec
PG_NUM = 1 << 18                       # ~100 PG replicas per OSD


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


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
                     got: torch.Tensor) -> int:
    """Largest |kernel - plain| byte difference, in stripe slices."""
    worst = 0
    for s in range(0, data.shape[0], PLAIN_SLICE):
        plain = kernels.gf_encode_plain(bm, data[s:s + PLAIN_SLICE])
        diff = (got[s:s + PLAIN_SLICE].int() - plain.int()).abs().max()
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

    from ceph_tpu_torch.bench import ec_benchmark
    from ceph_tpu_torch.ec import matrix as rs
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.gf import kernels, tables
    from ceph_tpu_torch.utils import cuda_build, roofline

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
    enc_bm = torch.as_tensor(tables.expand_bitmatrix(coeffs), device="cuda")
    dec_bm = torch.as_tensor(tables.expand_bitmatrix(
        rs.decode_matrix("reed_sol_van", K, M, tuple(AVAIL), tuple(ERASED))),
        device="cuda")
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
    enc_ms = events_ms(lambda: kernels.gf_encode(enc_bm, data), 20)
    dec_ms = events_ms(lambda: kernels.gf_encode(dec_bm, chunks), 20)
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
        "encode": {"kernel_ms": enc_ms, "plain_ms": plain_enc_ms,
                   "bound_ms": enc_bound_s * 1e3, "bytes": enc_bytes,
                   "input_GiB/s": B * K * C / (enc_ms / 1e3) / 2**30},
        "decode": {"kernel_ms": dec_ms, "plain_ms": plain_dec_ms,
                   "bound_ms": dec_bound_s * 1e3, "bytes": dec_bytes,
                   "read_GiB/s": B * K * C / (dec_ms / 1e3) / 2**30},
    }
    print("timings: " + json.dumps(timings))
    flagship = ["--plugin", "jax", "--size", str(K * C), "--iterations",
                str(B), "--parameter", f"k={K}", "--parameter", f"m={M}",
                "--json"]
    ec_benchmark.main(["--workload", "encode", *flagship])
    ec_benchmark.main(["--workload", "decode", "--erasures", "2", *flagship])

    crush = crush_phases(spec)

    # -- result ----------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "gf_encode",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_encode.cu",
        "replaces": "ceph_tpu/gf/pallas_kernels.py:168",
        "launches": launches,
        "max_abs_err": max(err_enc, err_dec),
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


def scalar_rows(job):
    """mapper_ref.do_rule over seeds, padded to numrep (a worker of the
    scalar-check pool)."""
    from ceph_tpu_torch.crush import mapper_ref
    from ceph_tpu_torch.crush.types import ITEM_NONE
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


def crush_phases(spec) -> dict:
    """The CRUSH placement path on the card; returns its kernel record."""
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
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        # -- 6. the main path ----------------------------------------------
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

        # -- 7. checks -----------------------------------------------------
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

        # -- 8. the fallback -------------------------------------------------
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

        # -- 9. placement ----------------------------------------------------
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
                                        "flagged_lanes")}
                  for v, r in rates.items()},
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


if __name__ == "__main__":
    main()
