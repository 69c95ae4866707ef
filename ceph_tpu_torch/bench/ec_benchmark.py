"""Erasure-code benchmark, flag-compatible with the reference harness.

ref: src/test/erasure-code/ceph_erasure_code_benchmark.{h,cc}
(ErasureCodeBench::setup / run / encode / decode). Same flags as
``ceph_tpu/bench/ec_benchmark.py``:

    python -m ceph_tpu_torch.bench.ec_benchmark \
        --plugin jax --workload encode --size 4194304 --iterations 1024 \
        --parameter k=8 --parameter m=3 --parameter technique=reed_sol_van

It runs on CUDA unless ``--parameter device=cpu`` asks for the CPU. The
output keeps the reference's ``<seconds>\t<MB/s>`` line (seconds per step
of ``batch`` objects), then, with ``--json``, a record whose ``device`` is
the CUDA device's name (or ``cpu``).

Iterations are tiled into stripe batches on the device, as in the
reference port: same total bytes, same per-object geometry. The device
paths are timed by ``utils.timing.measure_chained`` (each step's input
depends on the previous step's output; CUDA events; the slope between two
step counts). Every rate passes ``utils.roofline.check``. ``--stream``
adds the host-to-device copy of each batch to the loop.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ceph_tpu_torch.ec.interface import ErasureCodeProfile
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils import roofline, timing
from ceph_tpu_torch.utils.perf_counters import (PerfCountersBuilder,
                                                PerfCountersCollection)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="ceph_erasure_code_benchmark",
        description="erasure code benchmark (PyTorch/CUDA)")
    ap.add_argument("-p", "--plugin", default="jax")
    ap.add_argument("-w", "--workload", default="encode",
                    choices=["encode", "decode"])
    ap.add_argument("-s", "--size", type=int, default=1 << 20,
                    help="object bytes per operation")
    ap.add_argument("-i", "--iterations", type=int, default=1)
    ap.add_argument("-P", "--parameter", action="append", default=[],
                    help="profile key=value (repeatable)")
    ap.add_argument("-e", "--erasures", type=int, default=1,
                    help="chunks to erase for decode workload")
    ap.add_argument("--erased", action="append", type=int, default=None,
                    help="explicit chunk ids to erase (repeatable)")
    ap.add_argument("--batch", type=int, default=0,
                    help="stripes per device step (0 = auto)")
    ap.add_argument("--stream", action="store_true",
                    help="include host->device transfer per step")
    ap.add_argument("--json", action="store_true", help="emit JSON detail")
    ap.add_argument("--slope-steps", nargs=2, type=int, default=None,
                    metavar=("LO", "HI"),
                    help="step counts for the chained-slope measurement")
    ap.add_argument("--perf-dump", action="store_true",
                    help="dump perf counters after the run "
                         "(`ceph daemon ... perf dump` analog)")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap.parse_args(argv)


# Device-memory working set per input byte of each backend, computed from
# the intermediates of its ops (not measured): the kernel holds only
# input and output; bitmatmul holds int8 and float32 bit planes and the
# float32 and int32 sums; lut holds int64 nibble indices per output row.
_HBM_MULTIPLE = {"kernel": 3, "bitmatmul": 64, "lut": 200}


def _auto_batch(object_size: int, iterations: int, backend: str,
                spec: roofline.DeviceSpec | None) -> int:
    """Stripes per step: about 256 MiB of input, within half the card's
    memory for the backend's working set."""
    target = 256 << 20
    if spec is not None:
        mult = _HBM_MULTIPLE.get(backend, 64)
        target = min(target, int(spec.hbm_bytes * 0.5) // mult)
    return max(1, min(iterations, target // max(object_size, 1)))


class ErasureCodeBench:
    """ref: ErasureCodeBench (same setup/run/encode/decode split)."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        if args.iterations < 1:
            raise SystemExit("--iterations must be >= 1")
        profile = ErasureCodeProfile.parse(
            " ".join(args.parameter) or "k=2 m=2")
        profile.setdefault("plugin", args.plugin)
        self.profile = profile
        self.ec = ErasureCodePluginRegistry.instance().factory(
            args.plugin, profile)
        self.device = self.ec.device
        self.platform, self.device_name = devsel.describe(self.device)
        self.k = self.ec.k
        self.m = self.ec.m
        self.chunk = self.ec.get_chunk_size(args.size)
        self.spec = (roofline.device_spec(self.device_name)
                     if self.platform == "gpu" else None)
        self.batch = args.batch or _auto_batch(
            args.size, args.iterations, self.ec.backend, self.spec)
        self.perf = (PerfCountersBuilder("ec_bench")
                     .add_u64_counter("encode_bytes", "input bytes encoded")
                     .add_u64_counter("decode_bytes", "chunk bytes read for decode")
                     .add_u64_counter("encode_ops", "stripe encodes")
                     .add_u64_counter("decode_ops", "stripe decodes")
                     .add_time("encode_seconds", "time in timed encode region")
                     .add_time("decode_seconds", "time in timed decode region")
                     .create_perf_counters())

    # -- workloads --------------------------------------------------------
    def _make_data(self) -> np.ndarray:
        rng = np.random.default_rng(0)
        return rng.integers(0, 256, size=(self.batch, self.k, self.chunk),
                            dtype=np.uint8)

    def _slope_steps(self) -> tuple[int, int]:
        if self.args.slope_steps:
            lo, hi = self.args.slope_steps
            return int(lo), int(hi)
        return (2, 10)

    def _chained(self, fn, x: torch.Tensor) -> timing.ChainedTiming:
        """Time ``fn`` (x -> output) with each step's input carrying the
        previous output's anchor in its first byte."""
        def step(carry):
            x, acc = carry
            acc = (acc + timing.anchor(fn(x))) & 255
            x[0, 0, 0] = acc
            return x, acc

        acc0 = torch.zeros((), dtype=torch.int64, device=self.device)
        return timing.measure_chained(step, (x, acc0), self.device,
                                      steps=self._slope_steps())

    def _streamed(self, fn, host: np.ndarray) -> tuple[float, int, float]:
        """Host-to-device copy inside the loop; one synchronisation at the
        end (in-order execution: the last step done means all are)."""
        steps = max(4, -(-self.args.iterations // self.batch))
        src = torch.from_numpy(host)
        timing.anchor(fn(src.to(self.device))).item()       # warm
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn(src.to(self.device))
        timing.anchor(out).item()
        elapsed = time.perf_counter() - t0
        return elapsed / steps, steps, elapsed

    def encode(self) -> dict:
        host = self._make_data()
        if self.args.stream:
            per_step, steps, region = self._streamed(self.ec.encode_batch,
                                                     host)
            return self._result("encode", per_step, steps_run=steps,
                                region_s=region,
                                timing_detail={"method": "streamed_host_clock",
                                               "steps": steps})
        t = self._chained(self.ec.encode_batch,
                          torch.from_numpy(host).to(self.device))
        return self._result("encode", t.seconds_per_step,
                            timing_detail=t.as_dict(),
                            steps_run=t.steps_executed,
                            region_s=t.timed_region_s)

    def _decode_setup(self):
        data = torch.from_numpy(self._make_data()).to(self.device)
        full = torch.cat([data, self.ec.encode_batch(data)], dim=1)
        n = self.ec.get_chunk_count()
        if self.args.erased:
            erased = sorted(set(self.args.erased))
        else:
            erased = list(range(self.args.erasures))
        avail = [i for i in range(n) if i not in erased]
        if self.ec.is_mds():
            avail = avail[:self.k]
        return erased, avail, full[:, avail].contiguous()

    def decode(self) -> dict:
        erased, avail, chunks = self._decode_setup()

        def fn(c):
            return self.ec.decode_batch(erased, avail, c)

        if self.args.stream:
            per_step, steps, region = self._streamed(fn, chunks.cpu().numpy())
            return self._result("decode", per_step, erased=erased,
                                avail=avail, steps_run=steps, region_s=region,
                                timing_detail={"method": "streamed_host_clock",
                                               "steps": steps})
        t = self._chained(fn, chunks)
        return self._result("decode", t.seconds_per_step,
                            erased=erased, avail=avail,
                            timing_detail=t.as_dict(),
                            steps_run=t.steps_executed,
                            region_s=t.timed_region_s)

    def _result(self, workload: str, seconds_per_step: float,
                erased=None, avail=None, timing_detail=None,
                steps_run: int = 1, region_s: float = 0.0) -> dict:
        """encode bytes = input bytes (k * chunk per object); decode bytes
        = chunk bytes read (len(avail) * chunk per object), with the
        reference-comparable object rate beside it as ``object_MBps``."""
        ops = self.batch
        n_read = len(avail) if avail is not None else self.k
        if workload == "encode":
            step_bytes = ops * self.k * self.chunk
            bound = (roofline.encode_bound(self.k, self.m, self.spec)
                     if self.spec else None)
        else:
            step_bytes = ops * n_read * self.chunk
            bound = (roofline.decode_bound(len(erased), n_read, self.spec)
                     if self.spec else None)
        rate = step_bytes / seconds_per_step
        if not self.args.stream:   # streamed mode is bound by the host link
            roofline.check(rate, bound, f"{workload} throughput")
        self.perf.inc(f"{workload}_bytes", step_bytes * steps_run)
        self.perf.inc(f"{workload}_ops", ops * steps_run)
        self.perf.tinc(f"{workload}_seconds", region_s)
        res = {
            "workload": workload,
            "plugin": self.args.plugin,
            "technique": self.ec.profile.get("technique", "reed_sol_van"),
            "k": self.k, "m": self.m,
            "object_size": self.args.size,
            "chunk_size": self.chunk,
            "batch": ops,
            "seconds": seconds_per_step,      # per step of `batch` objects
            "total_bytes": step_bytes,        # accounted bytes per step
            "MB/s": rate / 1e6,
            "GiB/s": rate / (1 << 30),
            "backend": self.ec.backend,
            "stream": self.args.stream,
            "platform": self.platform,
            "device": self.device_name,
            "bound_GiB/s": (bound / (1 << 30)) if bound else None,
            "timing": timing_detail or {},
        }
        if erased is not None:
            res["erased"] = erased
            res["chunks_read"] = n_read
            res["reconstructed_bytes"] = ops * len(erased) * self.chunk
            res["object_MBps"] = ops * self.k * self.chunk \
                / seconds_per_step / 1e6
        return res

    def run(self) -> dict:
        if self.args.workload == "encode":
            return self.encode()
        return self.decode()


def main(argv=None) -> dict:
    args = parse_args(argv)
    res = ErasureCodeBench(args).run()
    # Reference-format line: elapsed seconds <tab> throughput MB/s.
    print(f"{res['seconds']:.6f}\t{res['MB/s']:.2f}")
    if args.json or args.verbose:
        print(json.dumps(res))
    if args.perf_dump:
        print(PerfCountersCollection.instance().dump_json())
    return res


if __name__ == "__main__":
    main()
