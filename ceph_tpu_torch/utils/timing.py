"""Timing of a chained step loop on the device.

Each step's input depends on the previous step's full output: the caller's
``step`` folds ``anchor`` of its output back into its carry, so no step
can be skipped or overlapped with the next (the reference's anchoring
idea, ceph_tpu/bench/ec_benchmark.py). On CUDA the loop is bracketed by
CUDA events, which time the device's execution of the queued work; on the
CPU, which runs synchronously, by the host clock.

The per-step time is the slope between two step counts,
``(t(hi) - t(lo)) / (hi - lo)``, so constant costs (the first launch, the
final synchronisation) cancel; they are reported as ``overhead_s``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass
class ChainedTiming:
    seconds_per_step: float
    overhead_s: float
    steps: tuple[int, int]
    totals_s: dict[int, float]   # best-of-reps time per step count
    reps: int
    method: str
    steps_executed: int          # all steps run, warm-up included
    timed_region_s: float        # time of the timed runs

    def as_dict(self) -> dict[str, Any]:
        return {
            "seconds_per_step": self.seconds_per_step,
            "overhead_s": self.overhead_s,
            "slope_steps": list(self.steps),
            "totals_s": {str(k): v for k, v in self.totals_s.items()},
            "reps": self.reps,
            "steps_executed": self.steps_executed,
            "method": self.method,
        }


def anchor(x: torch.Tensor) -> torch.Tensor:
    """A one-element int64 tensor that depends on every byte of ``x``.

    The bytes are summed as int64 words (wrapping), one pass over the
    memory: a sum of the uint8 elements cast one by one to int64 ran at
    a fraction of the card's memory rate and cost more than the encode it
    anchored (H100, chip_smoke.py)."""
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    if flat.storage_offset() % 8:
        flat = flat.clone()            # int64 words need 8-byte alignment
    whole = flat.numel() // 8 * 8
    return (flat[:whole].view(torch.int64).sum()
            + flat[whole:].sum(dtype=torch.int64))


def _timed(run: Callable[[], Any], device: torch.device) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def measure_chained(step: Callable[[Any], Any], carry0: Any,
                    device: torch.device, *,
                    steps: tuple[int, int] = (2, 10),
                    reps: int = 3) -> ChainedTiming:
    """Time ``step`` (carry -> carry) by the slope between ``steps``."""
    lo, hi = steps
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {steps}")

    def run(n: int) -> None:
        carry = carry0
        for _ in range(n):
            carry = step(carry)

    run(lo)                                 # warm-up
    executed = lo
    region = 0.0
    totals: dict[int, float] = {}
    for n in (lo, hi):
        times = [_timed(lambda: run(n), device) for _ in range(reps)]
        totals[n] = min(times)
        region += sum(times)
        executed += n * reps
    method = ("chained_slope_cuda_events" if device.type == "cuda"
              else "chained_slope_host_clock")
    per_step = (totals[hi] - totals[lo]) / (hi - lo)
    if per_step <= 0:
        # noise swamped the slope (a tiny workload): report the total over
        # the step count, with no constant subtracted, and say so
        return ChainedTiming(totals[hi] / hi, 0.0, (lo, hi), totals, reps,
                             method.replace("slope", "total"), executed,
                             region)
    return ChainedTiming(per_step, totals[lo] - lo * per_step, (lo, hi),
                         totals, reps, method, executed, region)
