"""Batched CRUSH mapping rate: the ``crushtool --test`` timing harness.

ref: src/crush/CrushTester.cc CrushTester::test with --show-statistics;
the counterpart of ``ceph_tpu/bench/crush_sweep.py``. One measurement is
a ``Mapper.sweep`` over a PG range (per-device counts aggregated on the
device). The rate is the slope between two sweep sizes, each timed with
CUDA events around the sweep, so fixed costs cancel.

Maps: the canonical 10,240-OSD root -> 20 racks -> 640 hosts -> 16 OSDs
straw2 hierarchy with a 3-replica ``chooseleaf firstn 0 type host`` rule,
plus its mixed-weight, choose_args and quantized choose_args variants.

    python -m ceph_tpu_torch.bench.crush_sweep --num-pgs 2097152 --variants

Runs on CUDA unless ``--device cpu`` (where the host clock times it).
``--checkpoint PATH`` runs one resumable sweep of ``--num-pgs`` PGs in
``--chunk``-PG chunks instead (``utils/checkpoint.py``; rerun with the
same path to resume), and ``--profile DIR`` writes a ``torch.profiler``
Chrome trace of whichever run into DIR.

Each row records the engine the plan promised before the run and the one
the last sweep ran on. A difference still standing at the end (a kernel
quarantined or permanently disabled) is a ``path_expected_vs_actual``
row and a ``path_regressions`` entry; one that healed before the end (a
bit-exact probe re-promoted the kernel) is a ``path_transient``. On the
card a kernel failure raises, so only a CPU run can show either.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.builder import TYPE_HOST
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.types import WEIGHT_ONE, ChooseArg
from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("bench")


def canonical_map(n_osds: int = 10240):
    """root -> racks (32 hosts each) -> hosts (16 OSDs) + the 3-replica
    chooseleaf-host rule (rule 0)."""
    osds_per_host = 16
    n_hosts = n_osds // osds_per_host
    m, root = builder.build_hierarchy(n_hosts, osds_per_host,
                                      n_racks=max(1, n_hosts // 32))
    builder.add_simple_rule(m, root, TYPE_HOST)
    return m


def mixed_weight_map(n_osds: int = 10240):
    """The canonical hierarchy with alternating 2.0 / 1.0 disk weights
    within every host."""
    osds_per_host = 16
    n_hosts = n_osds // osds_per_host
    weights = [WEIGHT_ONE if i % 2 else 2 * WEIGHT_ONE
               for i in range(n_osds)]
    m, root = builder.build_hierarchy(n_hosts, osds_per_host,
                                      n_racks=max(1, n_hosts // 32),
                                      osd_weights=weights)
    builder.add_simple_rule(m, root, TYPE_HOST)
    return m


def choose_args_map(n_osds: int = 10240):
    """Canonical map + a balancer-style choose_args weight set under key
    0: every item's weight perturbed by a factor in [0.9, 1.1)."""
    m = canonical_map(n_osds)
    rng = np.random.default_rng(42)
    args = {}
    for bid, b in m.buckets.items():
        scale = rng.uniform(0.9, 1.1, size=b.size)
        ws = [max(1, int(w * s)) for w, s in zip(b.weights, scale)]
        args[bid] = ChooseArg(weight_set=[ws])
    m.choose_args[0] = args
    return m


def choose_args_quantized_map(n_osds: int = 10240):
    """choose_args_map with each bucket's weight set snapped to four
    levels (0.92, 0.97, 1.03, 1.08)."""
    m = canonical_map(n_osds)
    rng = np.random.default_rng(42)
    args = {}
    levels = np.array([0.92, 0.97, 1.03, 1.08])
    for bid, b in m.buckets.items():
        scale = levels[rng.integers(0, 4, size=b.size)]
        ws = [max(1, int(w * s)) for w, s in zip(b.weights, scale)]
        args[bid] = ChooseArg(weight_set=[ws])
    m.choose_args[0] = args
    return m


VARIANTS = {
    "uniform": (canonical_map, None),
    "mixed_weight": (mixed_weight_map, None),
    "choose_args": (choose_args_map, 0),
    "choose_args_quantized": (choose_args_quantized_map, 0),
}


def _timed_sweep(mapper: Mapper, rule: int, n: int, num_rep: int) -> float:
    """Seconds of one aggregated sweep of n PGs: CUDA events on the card,
    the host clock around a synchronous run on the CPU."""
    if mapper.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        counts, _ = mapper.sweep(rule, 0, n, num_rep)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    counts, _ = mapper.sweep(rule, 0, n, num_rep)
    counts.sum().item()
    return time.perf_counter() - t0


def sweep_rate(mapper: Mapper, n_pgs: int, num_rep: int = 3,
               rule: int = 0) -> dict:
    """Mappings/s by the two-size slope: sweeps of n_hi and n_hi / 4
    PGs, each quantised to whole blocks, best of two."""
    # the engine the plan promises, captured before anything runs
    expected_path = mapper.mapping_path(rule, num_rep)
    blk = mapper.effective_block(rule, num_rep)
    hi_blocks = max(2, -(-n_pgs // blk))
    lo_blocks = max(1, hi_blocks // 4)
    n_hi, n_lo = hi_blocks * blk, lo_blocks * blk
    _timed_sweep(mapper, rule, n_lo, num_rep)             # warm-up
    t_hi = min(_timed_sweep(mapper, rule, n_hi, num_rep) for _ in range(2))
    t_lo = min(_timed_sweep(mapper, rule, n_lo, num_rep) for _ in range(2))
    if t_hi > t_lo and n_hi > n_lo:
        per_pg = (t_hi - t_lo) / (n_hi - n_lo)
        method = "sweep_two_size_slope"
    else:
        per_pg = t_hi / n_hi
        method = "sweep_total"
    platform, kind = devsel.describe(mapper.device)
    actual_path = mapper.last_map_path or expected_path
    out = {
        "metric": "crush_mappings_per_s",
        "mappings_per_s": 1.0 / per_pg,
        "n_pgs": n_hi,
        "n_pgs_lo": n_lo,
        "seconds_hi": t_hi,
        "seconds_lo": t_lo,
        "num_rep": num_rep,
        "method": method,
        "timer": "cuda_events" if platform == "gpu" else "host_clock",
        "path": actual_path,
        "flagged_lanes": mapper.flagged_lanes,
        "platform": platform,
        "device": kind,
    }
    # the kernel's launch facts, only where the measured sweep ran on it:
    # a VM row has no plan, and a degraded row must not carry them
    if actual_path.startswith("kernel"):
        info = mapper.kernel_plan_info(rule, num_rep)
        if info is not None:
            out.update(info)
    if actual_path != expected_path:
        healed = (mapper.kernel_quarantine_info() is None and
                  mapper.mapping_path(rule, num_rep) == expected_path)
        if healed:
            out["path_transient"] = \
                f"{expected_path}->{actual_path} (healed)"
            log.dout(1, f"CRUSH bench transient degrade: the last sweep "
                        f"ran {actual_path}, the kernel healed back to "
                        f"{expected_path} before the end")
        else:
            out["path_expected_vs_actual"] = \
                f"{expected_path}->{actual_path}"
            log.dout(0, f"CRUSH bench path regression: the plan promised "
                        f"{expected_path}, the run executed {actual_path}")
    return out


def sweep_rate_variants(n_osds: int = 10240, n_pgs: int = 1 << 21,
                        num_rep: int = 3, device=None,
                        variants=("uniform", "mixed_weight",
                                  "choose_args")) -> dict:
    """Rates for the named map variants, each on its own Mapper."""
    out = {}
    for name in variants:
        build, key = VARIANTS[name]
        mapper = Mapper(build(n_osds), choose_args=key, device=device)
        out[name] = sweep_rate(mapper, n_pgs, num_rep)
    return out


def path_regressions(variants: dict) -> list[str]:
    """['choose_args: kernel-plain->vm', ...]: every variant row whose
    promised engine was not the one serving at the end of its run."""
    return [f"{name}: {row['path_expected_vs_actual']}"
            for name, row in sorted(variants.items())
            if isinstance(row, dict)
            and "path_expected_vs_actual" in row]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="crush_sweep", description="batched CRUSH mapping benchmark")
    ap.add_argument("--num-osds", type=int, default=10240)
    ap.add_argument("--num-pgs", type=int, default=1 << 22)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--variants", action="store_true",
                    help="also measure the mixed-weight and choose_args "
                         "maps")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="resumable full sweep with per-chunk checkpoint "
                         "(SURVEY.md §5.4); rerun with the same path to "
                         "resume after an interruption")
    ap.add_argument("--chunk", type=int, default=1 << 22,
                    help="PGs per checkpoint chunk")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the sweep")
    args = ap.parse_args(argv)
    from ceph_tpu_torch.utils.profiling import trace
    if args.checkpoint:
        from ceph_tpu_torch.utils.checkpoint import resumable_sweep
        m = canonical_map(args.num_osds)
        t0 = time.perf_counter()
        with trace(args.profile):
            state, done = resumable_sweep(
                m, 0, args.num_pgs, args.num_rep, args.checkpoint,
                chunk=args.chunk, mapper=Mapper(m, device=args.device))
        res = {
            "metric": "crush_resumable_sweep",
            "done": done,
            "cursor": state.cursor,
            "n_pgs": state.n_total,
            "bad_mappings": state.bad,
            "placements": int(state.counts.sum()),
            "seconds_this_run": round(time.perf_counter() - t0, 3),
        }
    elif args.variants:
        with trace(args.profile):
            res = sweep_rate_variants(args.num_osds, args.num_pgs,
                                      args.num_rep, device=args.device)
    else:
        mapper = Mapper(canonical_map(args.num_osds), device=args.device)
        with trace(args.profile):
            res = sweep_rate(mapper, args.num_pgs, args.num_rep)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
