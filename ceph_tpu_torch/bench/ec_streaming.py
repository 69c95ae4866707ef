"""The ``ec_streaming`` bench section: the EC data path at production
traffic.

The counterpart of ``ceph_tpu/bench/ec_streaming.py``. Three measured legs
over the SAME op mix (n_ops concurrent "client ops", each a
(stripes_per_op, k, C) stripe batch of host bytes), plus the resident
reference:

- ``per_op_GiBs``: the ``osd_ec_agg=off`` baseline, one kernel launch +
  readback per op;
- ``aggregated_GiBs``: the ops submitted CONCURRENTLY through the real
  ``osd/ec_aggregator.ECAggregator``, coalescing into padded batched
  launches;
- ``pipeline_GiBs``: the double-buffered H2D/D2H streaming pipeline
  (``ec/torch_plugin.StreamingEncodePipeline``): host batches in, parity
  out, the transfer of batch N+1 overlapped with the encode of batch N;
- ``resident_GiBs``: data already on the device, encoded as one deep
  batch and read back (the reference's anchoring: every leg ends in the
  parity on the host).

Every timed region ends in a readback to the host (the aggregator and
the pipeline return host arrays; the resident leg copies its parity
back), never in a bare launch. All rates count input bytes (k * C per
stripe), over the host clock, best of ``reps``.

Verdict: ``ec_agg_within_2x``, the aggregated multi-op rate lands within
2x of the resident rate. The default shape goes by device: on CUDA the
reference's production shape (256 ops x 32 stripes x C = 4096, k=8, m=3:
256 MiB of input), on the CPU a smoke size with the SAME schema.
``ladder`` sums the aggregators' degrade-ladder counters over the run:
on a healthy device every one is 0. On CUDA, ``transfers`` gives the
host<->device copy rates and the host's first-touch copy rate at the
op's size and at the whole run's size, which bound every leg but the
kernel's.

    python -m ceph_tpu_torch.bench.ec_streaming [--device cpu]

(shape overrides: ``CEPH_TPU_BENCH_ECSTREAM_{OPS,STRIPES,CHUNK}``)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time

import numpy as np
import torch

from ceph_tpu_torch.ec.torch_plugin import (ErasureCodeTorch,
                                            StreamingEncodePipeline, to_host)
from ceph_tpu_torch.osd.ec_aggregator import ECAggregator
from ceph_tpu_torch.utils import device as devsel

LADDER = ("flush_failures", "per_op_retries", "fallback_ops",
          "crc_fallbacks")


def _default_shape(dev: torch.device) -> tuple[int, int, int]:
    """(n_ops, stripes_per_op, chunk_size): the production shape on CUDA,
    a smoke shape on the CPU (env overrides win)."""
    if dev.type == "cuda":
        shape = (256, 32, 4096)      # 256 ops x 1 MiB input each
    else:
        shape = (16, 4, 1024)
    return (
        int(os.environ.get("CEPH_TPU_BENCH_ECSTREAM_OPS", shape[0])),
        int(os.environ.get("CEPH_TPU_BENCH_ECSTREAM_STRIPES", shape[1])),
        int(os.environ.get("CEPH_TPU_BENCH_ECSTREAM_CHUNK", shape[2])),
    )


def _rate(nbytes: int, seconds: float) -> float:
    return nbytes / max(seconds, 1e-9) / (1 << 30)


def transfer_rates(dev: torch.device, nbytes: int,
                   reps: int = 3) -> dict:
    """GiB/s of the copies the legs are made of, for ``nbytes`` on the
    host clock around a synchronised copy, best of ``reps``: H2D from a
    numpy array (pageable) and from pinned memory, D2H into a new
    pageable tensor (``.cpu()``) and into pinned memory, and a numpy copy
    into a new array (the host's first-touch rate)."""
    host = np.random.default_rng(1).integers(0, 256, nbytes,
                                              dtype=np.uint8)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    on_dev = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    legs = {
        "h2d_pageable": lambda: torch.as_tensor(host, device=dev),
        "h2d_pinned": lambda: on_dev.copy_(pinned, non_blocking=True),
        "d2h_pageable": lambda: on_dev.cpu(),
        "d2h_pinned": lambda: pinned.copy_(on_dev, non_blocking=True),
        "host_copy": lambda: host.copy(),
    }
    out = {}
    for name, fn in legs.items():
        best = float("inf")
        for _ in range(reps + 1):            # the first run warms
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        out[f"{name}_GiBs"] = round(_rate(nbytes, best), 4)
    return out


def ec_streaming_section(n_ops: int | None = None,
                         stripes_per_op: int | None = None,
                         chunk_size: int | None = None,
                         k: int = 8, m: int = 3,
                         resident_gibs: float | None = None,
                         reps: int = 3,
                         device: str | torch.device | None = None) -> dict:
    """Run the section, every knob defaulting per device. The returned
    record is JSON-clean and carries ``aggregated_GiBs``,
    ``per_op_GiBs``, ``pipeline_GiBs``, ``resident_GiBs``,
    ``agg_batches`` and ``ec_agg_within_2x``, plus the device."""
    dev = devsel.resolve(device)
    platform, gpu_name = devsel.describe(dev)
    d_ops, d_stripes, d_chunk = _default_shape(dev)
    n_ops = n_ops or d_ops
    stripes_per_op = stripes_per_op or d_stripes
    chunk_size = chunk_size or d_chunk
    ec = ErasureCodeTorch(f"plugin=jax k={k} m={m} technique=reed_sol_van",
                          device=dev)
    rng = np.random.default_rng(13)
    ops = [rng.integers(0, 256, (stripes_per_op, k, chunk_size),
                        dtype=np.uint8) for _ in range(n_ops)]
    op_bytes = stripes_per_op * k * chunk_size
    total_bytes = n_ops * op_bytes
    ladder = dict.fromkeys(LADDER, 0)

    def _count(agg: ECAggregator) -> None:
        d = agg.perf.dump()
        for key in LADDER:
            ladder[key] += int(d.get(key, 0))

    to_host(ec.encode_batch(ops[0]))                 # warm

    # -- per-op baseline (osd_ec_agg=off): launch+readback per op ------
    agg_off = ECAggregator({"osd_ec_agg": False})

    async def _per_op() -> float:
        t0 = time.perf_counter()
        for d in ops:
            await agg_off.encode(ec, d)
        return time.perf_counter() - t0

    per_op_s = min(asyncio.run(_per_op()) for _ in range(reps))
    _count(agg_off)

    # -- aggregated: concurrent ops through the real aggregator --------
    async def _aggregated() -> tuple[float, int]:
        agg = ECAggregator({"osd_ec_agg": True,
                            "osd_ec_agg_window_us": 2000.0,
                            "osd_ec_agg_max_stripes":
                                max(n_ops * stripes_per_op, 1)})
        # warm BOTH shapes the timed region can launch outside it: the
        # coalesced full batch's padded shape and a lone op's (an idle
        # flush racing the gather can emit a partial batch)
        agg._run(ec, np.concatenate(ops, axis=0), False)
        await agg.encode(ec, ops[0])
        warm_batches = agg.perf.dump()["batches"]
        t0 = time.perf_counter()
        await asyncio.gather(*[agg.encode(ec, d) for d in ops])
        dt = time.perf_counter() - t0
        _count(agg)
        return dt, agg.perf.dump()["batches"] - warm_batches

    # keep the batch count FROM the min-time rep
    agg_s, agg_batches = min(
        (asyncio.run(_aggregated()) for _ in range(reps)),
        key=lambda r: r[0])

    # -- double-buffered streaming pipeline ----------------------------
    pipe = StreamingEncodePipeline(ec)
    pipe.encode_all(ops[:2])                 # warm

    def _pipe_once() -> float:
        t0 = time.perf_counter()
        pipe.encode_all(ops)
        return time.perf_counter() - t0

    pipe_s = min(_pipe_once() for _ in range(reps))

    # -- resident reference (or the headline number, when passed) ------
    measured_resident = resident_gibs is None
    if measured_resident:
        resident = torch.as_tensor(np.concatenate(ops, axis=0), device=dev)
        to_host(ec.encode_batch(resident))   # warm

        def _resident_once() -> float:
            t0 = time.perf_counter()
            to_host(ec.encode_batch(resident))   # readback anchor
            return time.perf_counter() - t0

        resident_gibs = _rate(total_bytes,
                              min(_resident_once() for _ in range(reps)))

    aggregated = _rate(total_bytes, agg_s)
    return {
        "n_ops": n_ops,
        "stripes_per_op": stripes_per_op,
        "chunk_size": chunk_size,
        "k": k, "m": m,
        "op_bytes": op_bytes,
        "total_bytes": total_bytes,
        "backend": ec.backend,
        "platform": platform,
        "device": dev.type,
        "gpu_name": gpu_name if dev.type == "cuda" else None,
        "per_op_GiBs": round(_rate(total_bytes, per_op_s), 4),
        "aggregated_GiBs": round(aggregated, 4),
        "pipeline_GiBs": round(_rate(total_bytes, pipe_s), 4),
        "resident_GiBs": round(float(resident_gibs), 4),
        "resident_measured_here": bool(measured_resident),
        "agg_batches": int(agg_batches),
        "agg_speedup_vs_per_op": round(per_op_s / max(agg_s, 1e-9), 2),
        "ec_agg_within_2x": bool(aggregated * 2.0 >= float(resident_gibs)),
        "ladder": ladder,
        "transfers": ({str(n): transfer_rates(dev, n)
                       for n in (op_bytes, total_bytes)}
                      if dev.type == "cuda" else None),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    rec = ec_streaming_section(device=ap.parse_args(argv).device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
