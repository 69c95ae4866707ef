"""The GF(2^8) encode kernel alone, at the shapes the port launches it at.

Times ``gf.kernels.encode_batch_planned`` (the plugin's path: a plan per
coding matrix) and ``gf.kernels.gf_encode`` (the tables derived in each
block) on the card, each beside the bound of its shape and the plain
version's time, in one process and in turns (planned, raw, raw,
planned). Each entry point's output is held byte for byte against
``gf_encode_plain`` at every shape before it is timed.

The shapes (k = 8, reed_sol_van; m = 3 unless said):

- (64, 8, 524288): the flagship encode, 64 stripes of 4 MiB objects,
  and its decode of chunks 0 and 1 from chunks 2-9 (m = 2);
- (4096, 8, 4096): the write aggregator's flush;
- (16384, 8, 4096) and (32768, 8, 4096): deep scrub;
- (128, 8, 4096): a 4 MiB object (128 stripes of 32 KiB);
- (1, 8, 4096): a 4 KiB write.

The large shapes are timed with CUDA events over back-to-back launches;
the two small ones, whose back-to-back launches are bound by the host,
by the kernel's device time in a ``torch.profiler`` trace (the launches
find their inputs in L2, as the object path's do), with the host's
microseconds per call beside it. The plain version is timed over the
batch in slices of 32 MiB of input, as it is checked.

The kernel of another tree of the repository (a parent commit unpacked
with ``git archive``) is timed by running this file with that tree's
root on PYTHONPATH; where that tree's ``gf/kernels.py`` has no plans,
its ``gf_encode`` alone is timed. Two trees are compared in one call,
in turns (parent, this tree, this tree, parent), on one card under one
power limit:

    python -m ceph_tpu_torch.bench.gf_kernel_bench [--reps N] [--out FILE]
    PYTHONPATH=TREE python ceph_tpu_torch/bench/gf_kernel_bench.py ...

It runs on the card only: without one it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from ceph_tpu_torch.ec import matrix as rs
from ceph_tpu_torch.gf import kernels, tables
from ceph_tpu_torch.utils import cuda_build, roofline

SEED = 20261016
K = 8
ERASED, AVAIL = (0, 1), tuple(range(2, 2 + K))
# (name, B, C, kind): kind "encode" is the k=8 m=3 encode matrix,
# "decode" the decode matrix of ERASED from AVAIL
SHAPES = (
    ("flagship_encode", 64, 524288, "encode"),
    ("flagship_decode", 64, 524288, "decode"),
    ("aggregated_flush", 4096, 4096, "encode"),
    ("deep_scrub_16384", 16384, 4096, "encode"),
    ("deep_scrub_32768", 32768, 4096, "encode"),
    ("object_4MiB", 128, 4096, "encode"),
    ("write_4KiB", 1, 4096, "encode"),
)
SMALL = 8 << 20         # input bytes below which the profiler times it
KERNEL_NAME = "gf_encode_kernel"
# a tree from before plans has gf_encode alone
PLANNED = hasattr(kernels, "make_plan")
CHECK_BYTES = 32 << 20  # input bytes per slice of the plain-version check


def _bitmatrix(kind: str):
    if kind == "encode":
        coeffs = rs.coding_matrix("reed_sol_van", K, 3)
    else:
        coeffs = rs.decode_matrix("reed_sol_van", K, 3, AVAIL, ERASED)
    return tables.expand_bitmatrix(coeffs)


def _operand(kind: str):
    """The plan of the shape's matrix on the card (where the tree has
    none, a stand-in that carries the bitmatrix)."""
    bm = _bitmatrix(kind)
    if PLANNED:
        return kernels.make_plan(bm, "cuda")
    return SimpleNamespace(bitmatrix=torch.as_tensor(bm, device="cuda"),
                           m=bm.shape[0] // 8)


def builds() -> dict:
    """{label: fn(plan, data)}: the kernel's planned entry point (where
    the tree has plans) and its raw one, ``gf_encode``."""
    out = {"planned": kernels.encode_batch_planned} if PLANNED else {}
    out["raw"] = lambda plan, x: kernels.gf_encode(plan.bitmatrix, x)
    return out


def events_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str = KERNEL_NAME,
              traces: int = 3) -> float | None:
    """Mean device milliseconds of the launches of the CUDA kernel whose
    name contains ``kernel``, in a profiler trace of ``reps`` runs of
    ``fn``: the trace's device events of that name, each its own
    duration. On the card a trace now and then holds none of them (or
    only some), so up to ``traces`` traces are taken until one does;
    None when none does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and kernel in ev.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def host_us(fn, reps: int) -> float:
    """Host microseconds per call, launches not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def _slices(data):
    step = max(1, CHECK_BYTES // (data.shape[1] * data.shape[2]))
    return [slice(s, s + step) for s in range(0, data.shape[0], step)]


def max_errs(plan, data, outs: dict) -> dict:
    """{label: max |out - plain|} of each entry point's output, the
    plain version computed once, slice by slice."""
    worst = dict.fromkeys(outs, 0)
    for sl in _slices(data):
        plain = kernels.gf_encode_plain(plan.bitmatrix, data[sl]).int()
        for label, got in outs.items():
            worst[label] = max(worst[label],
                               int((got[sl].int() - plain).abs().max()))
    return worst


def plain_in_slices(plan, data) -> None:
    """The plain version over the batch in slices of CHECK_BYTES of
    input (its bit planes take 32x the input's bytes)."""
    for sl in _slices(data):
        kernels.gf_encode_plain(plan.bitmatrix, data[sl])


def measure(fns: dict, spec, reps: int = 20, shapes=SHAPES,
            plain: bool = True) -> list[dict]:
    """One record per shape: each entry point's max_abs_err against the plain
    version and its times in two turns (in order, then reversed), the
    bound, and the plain version's time."""
    gen = torch.Generator(device="cuda")
    plans = {kind: _operand(kind) for kind in ("encode", "decode")}
    records = []
    for name, B, C, kind in shapes:
        plan = plans[kind]
        gen.manual_seed(SEED + B)
        x = torch.randint(0, 256, (B, K, C), dtype=torch.uint8,
                          device="cuda", generator=gen)
        small = B * K * C < SMALL
        nbytes, ops = roofline.gf_encode_work(B, K, plan.m, C)
        bound_s, bound_by = roofline.bound_seconds(nbytes, ops, spec)
        rec = {"shape": name, "B": B, "k": K, "m": plan.m, "C": C,
               "bytes": nbytes, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by, "ms": {},
               "timer": "profiler_device" if small else "cuda_events"}
        rec["max_abs_err"] = max_errs(
            plan, x, {label: fn(plan, x) for label, fn in fns.items()})
        for label, err in rec["max_abs_err"].items():
            if err:
                raise RuntimeError(f"{label} differs from the plain version "
                                   f"at {name}")
        order = list(fns)
        for turn in (order, order[::-1]):
            for label in turn:
                fn = fns[label]
                call = (lambda fn=fn: fn(plan, x))
                t = device_ms(call, 200) if small else \
                    events_ms(call, reps)
                rec["ms"].setdefault(label, []).append(t)
        if small:
            rec["host_us_per_call"] = {
                label: host_us(lambda fn=fn: fn(plan, x), 2000)
                for label, fn in fns.items()}
        if plain:
            rec["plain_ms"] = events_ms(lambda: plain_in_slices(plan, x),
                                        20 if small else 3)
        best = {label: min(v for v in ts if v is not None)
                if any(v is not None for v in ts) else None
                for label, ts in rec["ms"].items()}
        rec["share_of_bound"] = {label: (rec["bound_ms"] / t if t else None)
                                 for label, t in best.items()}
        records.append(rec)
        del x
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gf_kernel_bench: no CUDA device; this bench runs on the card",
              file=sys.stderr)
        return 2
    logs = cuda_build.build(["gf_encode"])
    for src, log in logs.items():
        print(f"[nvcc {src}]\n{log.strip()}")
    name = torch.cuda.get_device_name(0)
    spec = roofline.device_spec(name)
    if spec is None:
        print(f"gf_kernel_bench: no datasheet entry for {name}",
              file=sys.stderr)
        return 2
    records = measure(builds(), spec, args.reps)
    result = {"device": name, "kernels": kernels.__file__,
              "records": records}
    for rec in records:
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
