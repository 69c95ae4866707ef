"""The fused straw2 firstn rule kernel: its plan, wrapper, plain version.

``crush_straw2(plan, xs, numrep)`` computes what
``ceph_tpu/crush/pallas_mapper.py::_run_kernel`` computes on the TPU: the
whole TAKE root / CHOOSE[LEAF]_FIRSTN / EMIT rule over straw2 buckets,
for every PG seed in ``xs``, plus a ``bad`` flag for the lanes the caller
must recompute with the rule VM.

Each lane descends once per candidate ``r`` in ``[0, numrep +
SPEC_EXTRA)``: with ``chooseleaf_stable=1`` and one weight set, the
descent for replica slot ``s`` at retry ``ftotal`` depends only on
``r = s + ftotal``, so one shared candidate table serves every slot.
The leaf descent uses ``r >> (vary_r - 1)``, and a device whose reweight
is below 1.0 is rejected when ``hash2(x, leaf) & 0xFFFF >= w``. Slot
``s`` then takes the first candidate ``c >= s`` (and ``c < s + tries``)
that succeeded and whose item and leaf collide with no earlier slot.
A lane where some slot runs out of candidates is flagged ``bad``.

The draw is exact: ``bucket_straw2_choose`` of ``mapper.c`` per slot,
``crush_ln(hash3(x, id, r) & 0xFFFF) - 2^48`` divided by the weight in
int64 with truncation toward zero, ``S64_MIN`` for a zero weight, ties
to the first slot. So only candidate exhaustion flags a lane (about
1e-8 of lanes on a healthy map); the TPU kernel's approximate class and
continuous draws, and their margin flags, have no counterpart here.

On a CUDA tensor the wrapper launches the hand-written kernel
``ceph_tpu_torch/csrc/crush_straw2.cu`` (one thread per PG lane; the
source says what bounds it), or raises. On a CPU tensor it runs
``crush_straw2_plain``, the same function vectorised over lanes,
candidates and slots in int64. ``crush_straw2.launches`` counts the
kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ceph_tpu_torch.crush import hash as chash
from ceph_tpu_torch.crush.ln_table import crush_ln_t, ll_table, rh_lh_tables
from ceph_tpu_torch.crush.types import (
    ALG_STRAW2, ITEM_NONE, OP_CHOOSELEAF_FIRSTN, OP_CHOOSE_FIRSTN, OP_EMIT,
    OP_NOOP, OP_TAKE, WEIGHT_ONE, CrushMap,
)
from ceph_tpu_torch.utils import cuda_build

SPEC_EXTRA = 2      # candidates beyond numrep, as in the TPU kernel
MAX_CAND = 16       # candidates a kernel thread holds (csrc kMaxCand)
S64_MIN = -(1 << 63)
LN_ONE = 1 << 48
MAX_STRATA = 64     # deepest hierarchy a plan takes (a cycle guard)


@dataclasses.dataclass(frozen=True, eq=False)
class KernelPlan:
    """The map, cut into per-level rows for one eligible rule.

    Rows are numbered breadth first from the TAKE root (row 0); each row
    is one bucket at one descent level, its slots stored contiguously
    (CSR): ``row_start``/``row_size`` index the slot arrays.
    ``slot_next`` is the child's row at inner levels and the device id
    at the last level. ``slot_w`` holds the draw weights (the single
    choose_args weight set where the map has one). ``devw`` is the
    device reweight vector the is_out test reads."""

    row_start: np.ndarray   # (R,) int32
    row_size: np.ndarray    # (R,) int32
    slot_id: np.ndarray     # (T,) int32 item ids fed to the hash
    slot_next: np.ndarray   # (T,) int32
    slot_w: np.ndarray      # (T,) int64 16.16 draw weights
    devw: np.ndarray        # (D,) int32 reweights, clamped to <= 1.0
    level_sizes: tuple      # per level: (min slots, max slots, rows)
    l_main: int             # levels from the root to the target type
    n_levels: int           # levels down to the devices
    numrep_arg: int         # the rule's arg1 (<= 0: result_max + arg1)
    recurse: bool           # chooseleaf?
    vary_r: int
    tries: int
    target_type: int


def build_plan(m: CrushMap, ruleno: int,
               device_weights: np.ndarray | None = None,
               choose_args_key: int | None = None) -> KernelPlan | None:
    """The plan for ``ruleno``, or None when the rule is not one the
    kernel computes exactly. The conditions are the structural ones of
    ``pallas_mapper.build_plan``: modern tunables, the three-step firstn
    rule, straw2 buckets that are non-empty with a positive weight, one
    depth per level, at most one choose_args weight set and no ids.
    Added here: ``chooseleaf_descend_once`` (the kernel makes one leaf
    descent per candidate) and a target type below the root."""
    t = m.tunables
    if t.chooseleaf_stable != 1 or t.choose_local_tries or \
            t.choose_local_fallback_tries or not t.chooseleaf_descend_once:
        return None
    ca_map = None
    if choose_args_key is not None and choose_args_key in m.choose_args:
        ca_map = m.choose_args[choose_args_key]
        for ca in ca_map.values():
            if ca.ids or (ca.weight_set and len(ca.weight_set) != 1):
                return None
    rule = m.rules.get(ruleno)
    if rule is None:
        return None
    steps = [s for s in rule.steps if s.op != OP_NOOP]
    if len(steps) != 3 or steps[0].op != OP_TAKE or steps[2].op != OP_EMIT \
            or steps[1].op not in (OP_CHOOSELEAF_FIRSTN, OP_CHOOSE_FIRSTN):
        return None
    recurse = steps[1].op == OP_CHOOSELEAF_FIRSTN
    target_type = steps[1].arg2
    root = steps[0].arg1
    if (recurse and target_type == 0) or root not in m.buckets:
        return None
    draw_w: dict[int, list[int]] = {}
    strata: list[list[int]] = [[root]]
    l_main = None
    while True:
        cur = strata[-1]
        for bid in cur:
            b = m.buckets[bid]
            ws = b.weights
            if ca_map is not None and bid in ca_map and \
                    ca_map[bid].weight_set:
                ws = ca_map[bid].weight_set[0]
                if len(ws) != b.size:
                    return None
            if b.alg != ALG_STRAW2 or b.size == 0 or \
                    not any(int(w) > 0 for w in ws):
                return None
            draw_w[bid] = [int(w) for w in ws]
        types = {m.buckets[bid].type for bid in cur}
        if types == {target_type}:
            if l_main is not None:
                return None
            l_main = len(strata) - 1
        elif target_type in types:
            return None                        # mixed target level
        children: list[int] = []
        kinds = set()
        for bid in cur:
            for it in m.buckets[bid].items:
                kinds.add(it >= 0)
                if it < 0 and it not in children:
                    if it not in m.buckets:
                        return None
                    children.append(it)
        if len(kinds) > 1:
            return None                        # devices mixed with buckets
        if kinds == {True}:
            break
        if len(strata) >= MAX_STRATA:
            return None
        strata.append(children)
    n_levels = len(strata)
    if l_main is None:
        if recurse or target_type != 0:
            return None
        l_main = n_levels                      # choose firstn type 0
    if l_main == 0 or (recurse and l_main >= n_levels) or \
            (not recurse and l_main != n_levels):
        return None
    max_dev = max(it for bid in strata[-1] for it in m.buckets[bid].items)
    if device_weights is None:
        dw = np.full(m.max_devices, WEIGHT_ONE, dtype=np.int64)
    else:
        dw = np.asarray(device_weights, dtype=np.int64)
    if max_dev >= dw.shape[0]:
        return None
    # CSR rows, breadth first; a bucket gets one row per level it sits at
    base = np.cumsum([0] + [len(lvl) for lvl in strata])
    row_of = [{bid: int(base[li]) + i for i, bid in enumerate(lvl)}
              for li, lvl in enumerate(strata)]
    starts, sizes, ids, nxt, ws, level_sizes = [], [], [], [], [], []
    for li, lvl in enumerate(strata):
        lv = [m.buckets[bid].size for bid in lvl]
        level_sizes.append((min(lv), max(lv), len(lvl)))
        for bid in lvl:
            b = m.buckets[bid]
            starts.append(len(ids))
            sizes.append(b.size)
            ids.extend(b.items)
            nxt.extend(row_of[li + 1][it] if li + 1 < n_levels else it
                       for it in b.items)
            ws.extend(draw_w[bid])
    return KernelPlan(
        row_start=np.asarray(starts, dtype=np.int32),
        row_size=np.asarray(sizes, dtype=np.int32),
        slot_id=np.asarray(ids, dtype=np.int32),
        slot_next=np.asarray(nxt, dtype=np.int32),
        slot_w=np.asarray(ws, dtype=np.int64),
        devw=np.clip(dw, -1, WEIGHT_ONE).astype(np.int32),
        level_sizes=tuple(level_sizes), l_main=l_main, n_levels=n_levels,
        numrep_arg=steps[1].arg1, recurse=recurse, vary_r=t.chooseleaf_vary_r,
        tries=t.choose_total_tries, target_type=target_type)


@dataclasses.dataclass(frozen=True, eq=False)
class PlanTensors:
    """A KernelPlan's arrays on one device, plus the crush_ln tables
    (RH, LH: 129 entries each, then LL: 256; all below 2^63)."""

    plan: KernelPlan
    row_start: torch.Tensor
    row_size: torch.Tensor
    slot_id: torch.Tensor
    slot_next: torch.Tensor
    slot_w: torch.Tensor
    devw: torch.Tensor
    ln_tables: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.slot_id.device


def plan_tensors(plan: KernelPlan, device) -> PlanTensors:
    rh, lh = rh_lh_tables()
    ln = np.concatenate([rh, lh, ll_table()]).astype(np.int64)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return PlanTensors(plan, on(plan.row_start), on(plan.row_size),
                       on(plan.slot_id), on(plan.slot_next),
                       on(plan.slot_w), on(plan.devw), on(ln))


def _check(xs: torch.Tensor, numrep: int) -> None:
    if xs.dtype != torch.int32 or xs.dim() != 1:
        raise ValueError(f"xs must be (N,) int32, got {tuple(xs.shape)} "
                         f"{xs.dtype}")
    if numrep < 1:
        raise ValueError(f"numrep must be >= 1, got {numrep}")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

_LN_CACHE: dict = {}


def ln_table_t(device) -> torch.Tensor:
    """crush_ln over all 65,536 inputs, int64, cached per device."""
    key = str(device)
    if key not in _LN_CACHE:
        _LN_CACHE[key] = crush_ln_t(
            torch.arange(0x10000, dtype=torch.int64, device=device))
    return _LN_CACHE[key]


def resolve_slots(items: torch.Tensor, leaves: torch.Tensor,
                  ok: torch.Tensor, numrep: int, tries: int):
    """Scan the (N, n_cand) candidate table into (N, numrep) leaves and
    an (N,) bad flag: slot s takes the first candidate c in
    [s, s + tries) that succeeded and collides with no earlier slot."""
    n, n_cand = items.shape
    chosen_i, chosen_l = [], []
    bad = torch.zeros(n, dtype=torch.bool, device=items.device)
    for s in range(numrep):
        found = torch.zeros_like(bad)
        it_s = torch.full_like(items[:, 0], ITEM_NONE)
        lf_s = torch.full_like(leaves[:, 0], ITEM_NONE)
        for c in range(s, min(n_cand, s + tries)):
            good = ok[:, c] & ~found
            for pi, pl in zip(chosen_i, chosen_l):
                good &= (items[:, c] != pi) & (leaves[:, c] != pl)
            it_s = torch.where(good, items[:, c], it_s)
            lf_s = torch.where(good, leaves[:, c], lf_s)
            found |= good
        chosen_i.append(it_s)
        chosen_l.append(lf_s)
        bad |= ~found
    return torch.stack(chosen_l, dim=1), bad


def crush_straw2_plain(pt: PlanTensors, xs: torch.Tensor, numrep: int,
                       chunk: int = 1 << 16):
    """The kernel's plain torch version: (N,) int32 seeds -> (leaves
    (N, numrep) int32, bad (N,) bool), in chunks of ``chunk`` lanes so
    the (lanes, candidates, slots) int64 temps stay bounded."""
    _check(xs, numrep)
    p = pt.plan
    dev = xs.device
    n_cand = numrep + SPEC_EXTRA
    lnt = ln_table_t(dev)
    cand = torch.arange(n_cand, dtype=torch.int64, device=dev)
    r_leaf = cand >> (p.vary_r - 1) if p.vary_r else torch.zeros_like(cand)
    row_start = pt.row_start.to(torch.int64)
    row_size = pt.row_size.to(torch.int64)
    slot_id = pt.slot_id.to(torch.int64)
    slot_next = pt.slot_next.to(torch.int64)
    devw = pt.devw.to(torch.int64)
    out_l, out_b = [], []
    for lo in range(0, xs.shape[0], chunk):
        x = xs[lo:lo + chunk].to(torch.int64) & chash.M32
        n = x.shape[0]
        xc = x[:, None, None]
        row = torch.zeros((n, n_cand), dtype=torch.int64, device=dev)
        item = None
        for li in range(p.n_levels):
            r = (cand if li < p.l_main else r_leaf)[None, :, None]
            width = p.level_sizes[li][1]
            slot = torch.arange(width, dtype=torch.int64, device=dev)
            size = row_size[row][..., None]
            valid = slot < size
            idx = torch.where(valid, row_start[row][..., None] + slot, 0)
            w = pt.slot_w[idx]
            u = chash.hash32_3_t(xc, slot_id[idx], r) & 0xFFFF
            draw = torch.div(lnt[u] - LN_ONE, w.clamp(min=1),
                             rounding_mode="trunc")
            draw = torch.where(valid & (w != 0), draw, S64_MIN)
            win = idx.gather(2, draw.argmax(dim=2, keepdim=True))[..., 0]
            if li == p.l_main - 1:
                item = slot_id[win]
            row = slot_next[win]
        leaf = row
        if item is None:
            item = leaf
        inrange = leaf < devw.shape[0]
        w = devw[leaf.clamp(max=devw.shape[0] - 1)]
        hh = chash.hash32_2_t(x[:, None], leaf) & 0xFFFF
        out = ~inrange | ((w < WEIGHT_ONE) & ((w == 0) | (hh >= w)))
        leaves, bad = resolve_slots(item, leaf, ~out, numrep, p.tries)
        out_l.append(leaves.to(torch.int32))
        out_b.append(bad)
    if not out_l:
        return (torch.empty((0, numrep), dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev))
    return torch.cat(out_l), torch.cat(out_b)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _launcher():
    lib = cuda_build.load("crush_straw2")
    fn = lib.crush_straw2_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,              # xs, n
                   ctypes.c_void_p, ctypes.c_void_p,           # rows
                   ctypes.c_void_p, ctypes.c_void_p,           # slots
                   ctypes.c_void_p,                            # weights
                   ctypes.c_void_p, ctypes.c_int,              # devw
                   ctypes.c_void_p,                            # ln tables
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,   # levels
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,   # slots
                   ctypes.c_void_p, ctypes.c_void_p,           # outputs
                   ctypes.c_void_p]                            # stream
    fn.restype = ctypes.c_int
    lib.crush_straw2_error_string.argtypes = [ctypes.c_int]
    lib.crush_straw2_error_string.restype = ctypes.c_char_p
    return fn, lib.crush_straw2_error_string


def crush_straw2(pt: PlanTensors, xs: torch.Tensor, numrep: int):
    """(N,) int32 PG seeds -> (leaves (N, numrep) int32, bad (N,) bool).

    ``numrep + SPEC_EXTRA`` must not exceed MAX_CAND on the card: the
    kernel refuses the launch and this raises."""
    _check(xs, numrep)
    if xs.device.type == "cpu" and pt.device.type == "cpu":
        return crush_straw2_plain(pt, xs, numrep)
    if xs.device.type != "cuda" or pt.device != xs.device:
        raise ValueError(f"crush_straw2 needs the seeds and the plan on one "
                         f"CUDA device (or both on the CPU), got "
                         f"{xs.device} and {pt.device}")
    if not xs.is_contiguous():
        raise ValueError("crush_straw2 needs contiguous seeds")
    p = pt.plan
    n = xs.shape[0]
    leaves = torch.empty((numrep, n), dtype=torch.int32, device=xs.device)
    bad = torch.empty(n, dtype=torch.int32, device=xs.device)
    if n == 0:
        return leaves.t(), bad.bool()
    launch, error_string = _launcher()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = launch(xs.data_ptr(), n,
                     pt.row_start.data_ptr(), pt.row_size.data_ptr(),
                     pt.slot_id.data_ptr(), pt.slot_next.data_ptr(),
                     pt.slot_w.data_ptr(),
                     pt.devw.data_ptr(), pt.devw.shape[0],
                     pt.ln_tables.data_ptr(),
                     p.n_levels, p.l_main, p.vary_r,
                     numrep, numrep + SPEC_EXTRA, p.tries,
                     leaves.data_ptr(), bad.data_ptr(), stream)
    if err:
        raise RuntimeError(f"crush_straw2 launch failed: "
                           f"{error_string(err).decode()} (cudaError {err})")
    _counted.launches += 1
    return leaves.t(), bad.bool()


crush_straw2.launches = 0
# the count lives on this function object, so a wrapper bound to the
# name ``crush_straw2`` later (a checking hook) does not take it over
_counted = crush_straw2
