#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``ceph_tpu_torch``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ceph_tpu_torch/csrc`` into
``build/torch_kernels/`` and runs these phases; any failure raises, so
the script exits non-zero and prints no result:

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
5. One JSON line per the kernel table, then the card from nvidia-smi,
   then the last line ``{"ok": true, "device": {...}}``.

It exits with code 2, before any work, when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
B, K, M, C = 64, 8, 3, 524288          # flagship: 4 MiB objects, k=8 m=3
ERASED, AVAIL = [0, 1], list(range(2, 2 + K))
PLAIN_SLICE = 8                        # stripes per plain-version check


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
    logs = cuda_build.build(["gf_encode"])
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

    # -- 5. result -------------------------------------------------------------
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
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
