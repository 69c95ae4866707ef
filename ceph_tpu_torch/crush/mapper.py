"""Batched CRUSH placement in torch: the rule VM and the kernel path.

The port's counterpart of ``ceph_tpu/crush/mapper.py``. PG seeds are the
lane axis. Three engines serve a (rule, width):

- ``kernel`` (CUDA) / ``kernel-plain`` (CPU): the fused straw2 firstn
  rule of ``crush.kernels`` for eligible rules (``kernels.build_plan``),
  one launch per block of PGs. Lanes the kernel flags ``bad`` (a slot ran
  out of candidates) are recomputed by the rule VM, lane for lane
  exact, and scattered back; ``flagged_lanes`` counts them.
- ``vm``: the rule VM below, for every other rule with modern tunables:
  all five bucket algorithms, firstn and indep, choose_args weight sets
  per replica position and ``ids`` overrides, multi-step rules. It runs
  ``mapper_ref``'s loops with the lanes as a batch: each retry round
  works on the lanes still pending (compacted with ``nonzero``), so its
  output equals the scalar spec lane for lane.
- ``scalar``: ``mapper_ref.do_rule`` per seed, for legacy tunables
  (``chooseleaf_stable=0`` or local retries) and rules that set them.

Kernel quarantine (the reference's, ``ceph_tpu/crush/mapper.py:1088``):
on the CPU a failure of ``kernel-plain`` benches it: the rule VM serves
(the same call included) while a re-probe waits on capped exponential
backoff (``crush_kernel_reprobe_base``/``_max``); a probe runs the kernel
on 128 PGs and re-promotes it when the output equals the VM's bit for
bit, and ``crush_kernel_reprobe_disable_after`` consecutive failures make
the quarantine permanent. A Mapper on the card (``on_card``) never serves
a failing kernel from another engine: the failure is counted
(``kernel_exec_failures``, devmon ``quarantine_entries``) and raised to
the caller. Every call records the engine it ran on and the one expected
with the process devmon (``utils.devmon``), so a degrade is a counted
``path_mismatch``.

With a device mesh attached (``Mapper(mesh=)``, ``attach_mesh``),
``map_pgs`` and ``sweep`` batches of at least ``mesh_min_batch`` lanes
run sharded over its slots (``crush.sharded_sweep``; the path gains a
``+sharded`` suffix). Each device the mesh names gets its own copy of
the map tensors and kernel plans, made once and kept on this Mapper.

All arithmetic is int64: 32-bit hash values are carried masked to
32 bits (``crush.hash``), and the straw2 draw is the exact int64
truncating division. Entry points run on CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from ceph_tpu_torch.crush import kernels, sharded_sweep
from ceph_tpu_torch.crush.hash import (
    M32, hash32_2_t, hash32_3_t, hash32_4_t,
)
from ceph_tpu_torch.crush.tensors import PackedMap, pack_choose_args, pack_map
from ceph_tpu_torch.crush.types import (
    ALG_LIST, ALG_STRAW, ALG_STRAW2, ALG_TREE, ALG_UNIFORM,
    ITEM_NONE, ITEM_UNDEF,
    OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP, OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP, OP_EMIT, OP_NOOP, OP_SET_CHOOSELEAF_STABLE,
    OP_SET_CHOOSELEAF_TRIES, OP_SET_CHOOSELEAF_VARY_R,
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES, OP_SET_CHOOSE_LOCAL_TRIES,
    OP_SET_CHOOSE_TRIES, OP_TAKE,
    CrushMap, WEIGHT_ONE,
)
from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils.devmon import devmon as _devmon
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

S64_MIN = -(1 << 63)
LN_ONE = 1 << 48
KERNEL_BLOCK = 1 << 21      # PGs per kernel launch
VM_BLOCK = 1 << 16          # PGs per VM pass (bounds (N, S) temps)

PROBE_PGS = 128             # PGs of a quarantine re-probe

# descent outcomes
_OK, _SKIP, _EMPTY = 0, 1, 2

PERF = (PerfCountersBuilder("crush_mapper")
        .add_u64_counter("kernel_exec_failures",
                         "CRUSH kernel failures (on the CPU they "
                         "quarantine the kernel; on the card they are "
                         "raised to the caller)")
        .add_u64_counter("kernel_probes",
                         "quarantine re-probe attempts (backoff-paced "
                         "kernel runs compared bit-exact with the VM)")
        .add_u64_counter("kernel_repromotes",
                         "quarantined kernels re-promoted after a "
                         "bit-exact probe passed")
        .create_perf_counters())

_MAPPER_TOKEN = itertools.count(1)


# ---------------------------------------------------------------------------
# Device tensors of one packed map
# ---------------------------------------------------------------------------

class _MapTensors:
    """The packed map on one device, int64 throughout."""

    def __init__(self, p: PackedMap, device: torch.device,
                 device_weights: np.ndarray, choose_args=None):
        def on(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64),
                                   device=device)
        self.items = on(p.items)
        self.weights = on(p.weights)
        self.cumw = on(p.cumw)
        self.straws = on(p.straws.astype(np.int64))
        self.tree_nodes = on(p.tree_nodes)
        self.tree_num = on(p.tree_num)
        self.size = on(p.size)
        self.alg = on(p.alg)
        self.btype = on(p.btype)
        self.bid = on(p.bid)
        self.n_buckets = p.n_buckets
        self.max_devices = p.max_devices
        self.max_depth = p.max_depth
        self.present = p.algs_present
        self.devw = on(device_weights)
        self.cw = self.cids = None
        if choose_args is not None:
            cw, cids, _, _, _ = choose_args
            self.cw, self.cids = on(cw), on(cids)
        self.lnt = kernels.ln_table_t(device)
        # the pack's host-to-device staging, as the reference's Mapper
        # records it (the process-cached crush_ln table is left out)
        self.staged = sum(int(t.nbytes) for t in (
            self.items, self.weights, self.cumw, self.straws,
            self.tree_nodes, self.tree_num, self.size, self.alg,
            self.btype, self.bid, self.devw, self.cw, self.cids)
            if t is not None)


# ---------------------------------------------------------------------------
# Bucket choose, over lanes
# ---------------------------------------------------------------------------

def _straw2(T, rows, x, r, pos):
    """mapper.c bucket_straw2_choose, with the choose_args weight set of
    each lane's replica position and its ids override."""
    items = T.items[rows]
    S = items.shape[1]
    if T.cw is not None:
        p = pos.clamp(0, T.cw.shape[0] - 1)
        w = T.cw[p, rows]
        hid = T.cids[rows]
    else:
        w = T.weights[rows]
        hid = items
    u = hash32_3_t(x[:, None], hid, r[:, None]) & 0xFFFF
    draw = torch.div(T.lnt[u] - LN_ONE, w.clamp(min=1),
                     rounding_mode="trunc")
    valid = torch.arange(S, device=rows.device) < T.size[rows][:, None]
    draw = torch.where(valid & (w != 0), draw, S64_MIN)
    return items.gather(1, draw.argmax(dim=1, keepdim=True))[:, 0]


def _uniform(T, rows, x, r):
    """mapper.c bucket_perm_choose: the Fisher-Yates prefix up to
    r % size, driven by hash(x, bucket id, position)."""
    items = T.items[rows]
    size = T.size[rows]
    bid = T.bid[rows]
    m, S = items.shape
    pr = r % size.clamp(min=1)
    perm = torch.arange(S, device=rows.device).repeat(m, 1)
    lanes = torch.arange(m, device=rows.device)
    for p in range(S - 1):
        act = (p <= pr) & (p < size - 1)
        if not bool(act.any()):
            break
        i = hash32_3_t(x, bid, torch.full_like(x, p)) % \
            (size - p).clamp(min=1)
        j = torch.where(act, p + i, p)
        vp, vj = perm[:, p].clone(), perm[lanes, j]
        perm[:, p] = vj
        perm[lanes, j] = vp
    return items.gather(1, perm.gather(1, pr[:, None]))[:, 0]


def _list(T, rows, x, r):
    """mapper.c bucket_list_choose: tail to head, accept item i when
    hash(x, item, r, id) & 0xFFFF scaled by its prefix weight sum falls
    under its weight; items[0] when none accepts."""
    items = T.items[rows]
    S = items.shape[1]
    h = hash32_4_t(x[:, None], items, r[:, None], T.bid[rows][:, None]) \
        & 0xFFFF
    accept = ((h * T.cumw[rows]) >> 16) < T.weights[rows]
    accept &= torch.arange(S, device=rows.device) < T.size[rows][:, None]
    last = torch.where(accept, torch.arange(S, device=rows.device), -1)
    idx = last.max(dim=1).values.clamp(min=0)
    return items.gather(1, idx[:, None])[:, 0]


def _straw(T, rows, x, r):
    """mapper.c bucket_straw_choose: (hash & 0xFFFF) * straw, first max."""
    items = T.items[rows]
    S = items.shape[1]
    u = hash32_3_t(x[:, None], items, r[:, None]) & 0xFFFF
    draw = u * T.straws[rows]
    valid = torch.arange(S, device=rows.device) < T.size[rows][:, None]
    draw = torch.where(valid, draw, -1)
    return items.gather(1, draw.argmax(dim=1, keepdim=True))[:, 0]


def _mulhi32(h, w):
    """(h * w) >> 32 for h < 2^32 and w < 2^48, without int64 overflow."""
    return ((h >> 16) * w + (((h & 0xFFFF) * w) >> 16)) >> 16


def _tree(T, rows, x, r):
    """mapper.c bucket_tree_choose: weighted coin flips down the node
    tree, items at odd nodes 2i+1."""
    nodes = T.tree_nodes[rows]
    NT = nodes.shape[1]
    bid = T.bid[rows]
    n = T.tree_num[rows] >> 1
    while True:
        inner = (n & 1) == 0
        if not bool(inner.any()):
            break
        w = nodes.gather(1, n.clamp(0, NT - 1)[:, None])[:, 0]
        t = _mulhi32(hash32_4_t(x, n, r, bid), w)
        half = (n & -n) >> 1
        left = n - half
        wl = nodes.gather(1, left.clamp(0, NT - 1)[:, None])[:, 0]
        n = torch.where(inner, torch.where(t < wl, left, n + half), n)
    return T.items[rows].gather(1, (n >> 1)[:, None])[:, 0]


def _bucket_choose(T, rows, x, r, pos):
    """mapper.c crush_bucket_choose over lanes (rows: packed bucket rows,
    all non-empty)."""
    if T.present == (ALG_STRAW2,):
        return _straw2(T, rows, x, r, pos)
    out = torch.empty_like(rows)
    alg = T.alg[rows]
    for a, fn in ((ALG_STRAW2, None), (ALG_UNIFORM, _uniform),
                  (ALG_LIST, _list), (ALG_STRAW, _straw),
                  (ALG_TREE, _tree)):
        if a not in T.present:
            continue
        sel = (alg == a).nonzero()[:, 0]
        if not sel.numel():
            continue
        if fn is None:
            out[sel] = _straw2(T, rows[sel], x[sel], r[sel], pos[sel])
        else:
            out[sel] = fn(T, rows[sel], x[sel], r[sel])
    return out


def _is_out(T, item, x):
    """mapper.c is_out: out of range, zero weight, or a reweight draw."""
    D = T.devw.shape[0]
    w = T.devw[item.clamp(0, D - 1)]
    h = hash32_2_t(x, item) & 0xFFFF
    return (item >= D) | ((w < WEIGHT_ONE) & ((w == 0) | (h >= w)))


def _descend(T, start, x, r_of, type_, pos):
    """Walk from bucket ids ``start`` to an item of ``type_``.

    ``r_of(lanes, alg, size)`` gives the r of ``lanes`` (indices into
    this call's lanes) at the buckets they stand in.
    Returns (item, status, r): status _OK (item reached), _SKIP (an
    out-of-range device or a device of the wrong type: the scalar
    loop's skip_rep / break) or _EMPTY (an empty bucket on the way), and
    the r used at the last level."""
    n = start.shape[0]
    dev = start.device
    item = torch.full((n,), ITEM_NONE, dtype=torch.int64, device=dev)
    status = torch.full((n,), _SKIP, dtype=torch.int64, device=dev)
    r_used = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = start.clone()
    act = torch.arange(n, device=dev)
    for _ in range(T.max_depth + 1):
        if not act.numel():
            break
        rows = -1 - cur[act]
        size = T.size[rows]
        r = r_of(act, T.alg[rows], size)
        r_used[act] = r
        empty = size == 0
        status[act[empty]] = _EMPTY
        act, rows, r = act[~empty], rows[~empty], r[~empty]
        if not act.numel():
            break
        got = _bucket_choose(T, rows, x[act], r, pos[act])
        is_b = got < 0
        itype = torch.where(
            is_b, T.btype[(-1 - got).clamp(0, T.n_buckets - 1)], 0)
        skip = (got >= T.max_devices) | ((itype != type_) & ~is_b) | \
            (is_b & (-1 - got >= T.n_buckets))
        hit = ~skip & (itype == type_)
        item[act[hit]] = got[hit]
        status[act[hit]] = _OK
        deeper = ~skip & ~hit
        cur[act[deeper]] = got[deeper]
        act = act[deeper]
    return item, status, r_used


def _in_prefix(table, width, item):
    """Does ``item`` equal one of the first ``width`` entries of each
    lane's ``table`` row?"""
    cols = torch.arange(table.shape[1], device=table.device)
    return ((table == item[:, None]) & (cols < width[:, None])).any(dim=1)


# ---------------------------------------------------------------------------
# choose_firstn / choose_indep over lanes (mapper_ref, stable=1)
# ---------------------------------------------------------------------------

def _leaf_firstn(T, x, start, sub_r, out2, outpos, tries):
    """The chooseleaf recursion of crush_choose_firstn (numrep 1, type 0,
    stable): one device under each lane's bucket ``start`` that collides
    with no leaf in ``out2[:outpos]`` and passes is_out. Returns
    (leaf, placed)."""
    n = x.shape[0]
    dev = x.device
    leaf = torch.full((n,), ITEM_NONE, dtype=torch.int64, device=dev)
    placed = torch.zeros(n, dtype=torch.bool, device=dev)
    ftotal = torch.zeros(n, dtype=torch.int64, device=dev)
    pend = torch.arange(n, device=dev)
    while pend.numel():
        r = sub_r[pend] + ftotal[pend]
        item, st, _ = _descend(T, start[pend], x[pend],
                               lambda a, alg, size, r=r: r[a], 0,
                               outpos[pend])
        ok = st == _OK
        good = ok & ~_in_prefix(out2[pend], outpos[pend], item)
        dv = good.nonzero()[:, 0]
        out = torch.zeros_like(good)
        out[dv] = _is_out(T, item[dv], x[pend][dv])
        win = good & ~out
        leaf[pend[win]] = item[win]
        placed[pend[win]] = True
        retry = ~win & (st != _SKIP)
        ftotal[pend[retry]] += 1
        pend = pend[retry]
        pend = pend[ftotal[pend] < tries]
    return leaf, placed


def _choose_firstn(T, x, root, numrep, type_, count, tries, recurse_tries,
                   recurse, vary_r):
    """crush_choose_firstn with stable=1 and no local retries, over lanes
    rooted at bucket ids ``root``. ``count`` is each lane's room left in
    the result. Returns (out, out2, placed): items, leaves, count."""
    n = x.shape[0]
    dev = x.device
    out = torch.full((n, max(numrep, 0)), ITEM_NONE, dtype=torch.int64,
                     device=dev)
    out2 = out.clone()
    outpos = torch.zeros(n, dtype=torch.int64, device=dev)
    for rep in range(numrep):
        pend = (count - outpos > 0).nonzero()[:, 0]
        ftotal = torch.zeros(n, dtype=torch.int64, device=dev)
        while pend.numel():
            r = rep + ftotal[pend]
            item, st, _ = _descend(T, root[pend], x[pend],
                                   lambda a, alg, size, r=r: r[a], type_,
                                   outpos[pend])
            good = (st == _OK) & ~_in_prefix(out[pend], outpos[pend], item)
            reject = torch.zeros_like(good)
            leaf = item.clone()
            if recurse:
                sub = (good & (item < 0)).nonzero()[:, 0]
                if sub.numel():
                    sub_r = r[sub] >> (vary_r - 1) if vary_r \
                        else torch.zeros_like(r[sub])
                    lanes = pend[sub]
                    lf, ok = _leaf_firstn(T, x[lanes], item[sub], sub_r,
                                          out2[lanes], outpos[lanes],
                                          recurse_tries)
                    leaf[sub] = lf
                    reject[sub] = ~ok
            dv = (good & ~reject & (item >= 0)).nonzero()[:, 0]
            reject[dv] = _is_out(T, item[dv], x[pend][dv])
            win = good & ~reject
            wl = pend[win]
            out[wl, outpos[wl]] = item[win]
            out2[wl, outpos[wl]] = leaf[win]
            outpos[wl] += 1
            retry = ~win & (st != _SKIP)
            ftotal[pend[retry]] += 1
            pend = pend[retry]
            pend = pend[ftotal[pend] < tries]
    return out, out2, outpos


def _indep_r(base, ftotal, numrep):
    """crush_choose_indep's r at a bucket: the stride is numrep + 1 for
    a uniform bucket whose size numrep divides, else numrep."""
    def r_of(a, alg, size):
        stride = torch.where((alg == ALG_UNIFORM) & (size % numrep == 0),
                             numrep + 1, numrep)
        return base[a] + stride * ftotal
    return r_of


def _choose_indep(T, x, root, out_size, numrep, type_, tries, recurse_tries,
                  recurse):
    """crush_choose_indep over lanes rooted at bucket ids ``root``, each
    filling its first ``out_size`` positions. Returns (out, out2) with
    ITEM_NONE holes."""
    n = x.shape[0]
    dev = x.device
    width = int(out_size.max()) if n else 0
    cols = torch.arange(width, device=dev)
    live = cols[None, :] < out_size[:, None]
    out = torch.full((n, width), ITEM_NONE, dtype=torch.int64, device=dev)
    out[live] = ITEM_UNDEF
    out2 = out.clone()
    left = out_size.clone()
    for ftotal in range(tries):
        if not bool((left > 0).any()):
            break
        for rep in range(width):
            pend = ((left > 0) & (out[:, rep] == ITEM_UNDEF)).nonzero()[:, 0]
            if not pend.numel():
                continue
            pos = torch.full_like(pend, rep)
            item, st, r_at = _descend(
                T, root[pend], x[pend],
                _indep_r(torch.full_like(pend, rep), ftotal, numrep),
                type_, pos)
            emp = pend[st == _EMPTY]
            out[emp, rep] = ITEM_NONE
            out2[emp, rep] = ITEM_NONE
            good = (st == _OK) & ~(out[pend] == item[:, None]).any(dim=1)
            if recurse:
                sub = (good & (item < 0)).nonzero()[:, 0]
                if sub.numel():
                    lf = _leaf_indep(T, x[pend[sub]], item[sub], rep,
                                     r_at[sub], numrep, recurse_tries)
                    out2[pend[sub], rep] = lf
                    good[sub] &= lf != ITEM_NONE
                dvl = (good & (item >= 0)).nonzero()[:, 0]
                out2[pend[dvl], rep] = item[dvl]
            dv = (good & (item >= 0)).nonzero()[:, 0]
            good[dv] &= ~_is_out(T, item[dv], x[pend[dv]])
            wl = pend[good]
            out[wl, rep] = item[good]
            left[wl] -= 1
    out = torch.where(out == ITEM_UNDEF, ITEM_NONE, out)
    out2 = torch.where(out2 == ITEM_UNDEF, ITEM_NONE, out2)
    return out, out2


def _leaf_indep(T, x, start, rep, parent_r, numrep, tries):
    """The chooseleaf recursion of crush_choose_indep (left 1, type 0):
    the device for position ``rep`` under each lane's bucket, or
    ITEM_NONE."""
    n = x.shape[0]
    dev = x.device
    leaf = torch.full((n,), ITEM_UNDEF, dtype=torch.int64, device=dev)
    base = parent_r + rep
    for ftotal in range(tries):
        pend = (leaf == ITEM_UNDEF).nonzero()[:, 0]
        if not pend.numel():
            break
        item, st, _ = _descend(T, start[pend], x[pend],
                               _indep_r(base[pend], ftotal, numrep), 0,
                               torch.full_like(pend, rep))
        leaf[pend[st == _EMPTY]] = ITEM_NONE
        good = st == _OK
        dv = (good & (item >= 0)).nonzero()[:, 0]
        good[dv] &= ~_is_out(T, item[dv], x[pend[dv]])
        leaf[pend[good]] = item[good]
    return torch.where(leaf == ITEM_UNDEF, ITEM_NONE, leaf)


def _append(dst, dlen, src, slen):
    """Write each lane's first ``slen`` entries of ``src`` after its
    first ``dlen`` entries of ``dst`` (widened as needed)."""
    if not src.shape[1]:
        return dst
    need = int((dlen + slen).max()) if dlen.numel() else 0
    if need > dst.shape[1]:
        pad = torch.full((dst.shape[0], need - dst.shape[1]), ITEM_NONE,
                         dtype=dst.dtype, device=dst.device)
        dst = torch.cat([dst, pad], dim=1)
    k = torch.arange(src.shape[1], device=src.device)
    mask = k[None, :] < slen[:, None]
    lane, col = mask.nonzero(as_tuple=True)
    dst[lane, dlen[lane] + col] = src[lane, col]
    return dst


def run_rule(T, steps, tunables, x, result_max: int) -> torch.Tensor:
    """mapper_ref.do_rule over lanes (int64 seeds in [0, 2^32)), for
    chooseleaf_stable=1 and no local retries. Returns (N, result_max)
    int64, ITEM_NONE past each lane's result."""
    n = x.shape[0]
    dev = x.device
    choose_tries = tunables.choose_total_tries
    choose_leaf_tries = 0
    vary_r = tunables.chooseleaf_vary_r
    descend_once = tunables.chooseleaf_descend_once
    result = torch.full((n, result_max), ITEM_NONE, dtype=torch.int64,
                        device=dev)
    rlen = torch.zeros(n, dtype=torch.int64, device=dev)
    w = torch.empty((n, 0), dtype=torch.int64, device=dev)
    wlen = torch.zeros(n, dtype=torch.int64, device=dev)
    for op, arg1, arg2 in steps:
        if op == OP_NOOP:
            continue
        if op == OP_TAKE:
            w = torch.full((n, 1), arg1, dtype=torch.int64, device=dev)
            wlen = torch.ones(n, dtype=torch.int64, device=dev)
        elif op == OP_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
        elif op == OP_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
        elif op == OP_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
        elif op in (OP_CHOOSE_FIRSTN, OP_CHOOSE_INDEP,
                    OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP):
            recurse = op in (OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP)
            firstn = op in (OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN)
            numrep = arg1 if arg1 > 0 else arg1 + result_max
            o = torch.empty((n, 0), dtype=torch.int64, device=dev)
            c = o
            osize = torch.zeros(n, dtype=torch.int64, device=dev)
            for j in range(w.shape[1]):
                col = w[:, j]
                inw = j < wlen
                if arg2 == 0:       # a device passes through at type 0
                    d = (inw & (col >= 0)).to(torch.int64)
                    o = _append(o, osize, col[:, None], d)
                    c = _append(c, osize, col[:, None], d)
                    osize += d
                lanes = (inw & (col < 0)).nonzero()[:, 0]
                if not lanes.numel() or numrep <= 0:
                    continue
                if firstn:
                    rt = choose_leaf_tries or \
                        (1 if descend_once else choose_tries)
                    out, out2, placed = _choose_firstn(
                        T, x[lanes], col[lanes], numrep, arg2,
                        result_max - osize[lanes], choose_tries, rt,
                        recurse, vary_r)
                else:
                    placed = (result_max - osize[lanes]).clamp(
                        min=0, max=numrep)
                    out, out2 = _choose_indep(
                        T, x[lanes], col[lanes], placed, numrep, arg2,
                        choose_tries, choose_leaf_tries or 1, recurse)
                full = torch.zeros(n, dtype=torch.int64, device=dev)
                full[lanes] = placed
                for tab, blk in ((0, out), (1, out2)):
                    wide = torch.full((n, blk.shape[1]), ITEM_NONE,
                                      dtype=torch.int64, device=dev)
                    wide[lanes] = blk
                    if tab == 0:
                        o = _append(o, osize, wide, full)
                    else:
                        c = _append(c, osize, wide, full)
                osize += full
            w = c if recurse else o
            wlen = osize
        elif op == OP_EMIT:
            result = _append(result, rlen, w, wlen)
            rlen = rlen + wlen
            w = torch.empty((n, 0), dtype=torch.int64, device=dev)
            wlen = torch.zeros(n, dtype=torch.int64, device=dev)
        else:
            raise ValueError(f"unknown rule op {op}")
    return result[:, :result_max]


# ---------------------------------------------------------------------------
# The Mapper
# ---------------------------------------------------------------------------

def _scalar_reason_of(m: CrushMap, steps) -> str | None:
    t = m.tunables
    if t.chooseleaf_stable != 1:
        return "chooseleaf_stable=0"
    if t.choose_local_tries or t.choose_local_fallback_tries:
        return "legacy local retries"
    for op, arg1, _ in steps:
        if op == OP_SET_CHOOSELEAF_STABLE and arg1 >= 0 and arg1 != 1:
            return "rule sets chooseleaf_stable=0"
        if op in (OP_SET_CHOOSE_LOCAL_TRIES,
                  OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES) and arg1 > 0:
            return "rule sets local retries"
    return None


def _seeds(xs, device) -> torch.Tensor:
    """PG seeds (numpy, list or tensor; uint32 or signed) as int64 in
    [0, 2^32) on ``device``."""
    if isinstance(xs, torch.Tensor):
        t = xs.to(device=device, dtype=torch.int64)
    else:
        t = torch.as_tensor(np.asarray(xs).astype(np.int64), device=device)
    return t.reshape(-1) & M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """Seeds in [0, 2^32) as the int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def on_card(mapper) -> bool:
    """Whether a Mapper's work runs on a CUDA device. Such work is never
    handed to another engine when its kernel fails: the failure is
    counted and raised."""
    return mapper.device.type == "cuda"


class Mapper:
    """Batched CRUSH mapper for one CrushMap on one device.

        mapper = Mapper(crush_map, device="cpu")
        osds = mapper.map_pgs(ruleno, xs, numrep)   # (N, numrep) int32

    ``device_weights`` are the per-device 16.16 reweights of is_out
    (default all in); ``choose_args`` selects a weight-set key;
    ``config`` is a live dict of the ``crush_kernel_reprobe_*`` knobs
    (default: the process devmon's)."""

    def __init__(self, crush_map: CrushMap,
                 device_weights: np.ndarray | None = None,
                 block: int | None = None,
                 choose_args: int | None = None,
                 device: str | torch.device | None = None,
                 config: dict | None = None,
                 mesh=None, mesh_min_batch: int | None = None):
        self.device = devsel.resolve(device)
        self.map = crush_map
        self.packed: PackedMap = pack_map(crush_map)
        self.choose_args_key = choose_args
        self._cargs = None
        if choose_args is not None and choose_args in crush_map.choose_args:
            self._cargs = pack_choose_args(crush_map, choose_args,
                                           self.packed)
        self.block = block              # None: per engine, see below
        self.last_map_path: str | None = None
        self.flagged_lanes = 0          # kernel lanes recomputed by the VM
        self._config = config
        # devmon identity: keys this Mapper's first launches and its
        # quarantine state
        self._devmon_token = next(_MAPPER_TOKEN)
        # Set after a kernel failure: the engine this Mapper promised,
        # so under devmon_expected_engine=auto every later call keeps
        # counting a mismatch instead of the baseline re-healing to vm.
        self._degraded_from: str | None = None
        # quarantine state machine (CPU only, see the module docstring)
        self._kernel_ok = True
        self._quar_state: str | None = None  # quarantined|reprobing|permanent
        self._quar_failures = 0              # consecutive failures
        self._quar_next_probe = 0.0          # monotonic deadline
        self.mesh = None
        self.mesh_min_batch = sharded_sweep.MESH_MIN_BATCH
        self.attach_mesh(mesh, mesh_min_batch)
        self.set_device_weights(device_weights)

    def attach_mesh(self, mesh, mesh_min_batch: int | None = None) -> None:
        """Route ``map_pgs``/``sweep`` batches of at least
        ``mesh_min_batch`` lanes over ``mesh`` (None detaches)."""
        self.mesh = mesh
        if mesh_min_batch is not None:
            self.mesh_min_batch = mesh_min_batch

    def _use_mesh(self, n: int) -> bool:
        return (self.mesh is not None and self.mesh.size > 1
                and n >= self.mesh_min_batch)

    def set_device_weights(self, device_weights) -> None:
        """Replace the is_out reweight vector; kernel plans rebuild."""
        if device_weights is None:
            device_weights = np.full(self.packed.max_devices, WEIGHT_ONE,
                                     dtype=np.int64)
        self.device_weights = np.asarray(device_weights, dtype=np.int64)
        self.T = _MapTensors(self.packed, self.device, self.device_weights,
                             self._cargs)
        _devmon().record_h2d(self.T.staged)
        _devmon().note_staging(self.T.staged)
        self._plans: dict[int, kernels.PlanTensors | None] = {}
        # device -> (map tensors, plans) for each other device a mesh names
        self._replicas: dict[torch.device, tuple] = {}

    def _replica(self, device: torch.device) -> tuple:
        """(map tensors, kernel plans by rule) on ``device``: this
        Mapper's own on its device, else a copy made at the first use
        there, kept until the weights change."""
        if device == self.T.items.device:
            return self.T, self._plans
        rep = self._replicas.get(device)
        if rep is None:
            T = _MapTensors(self.packed, device, self.device_weights,
                            self._cargs)
            _devmon().record_h2d(T.staged)
            rep = self._replicas[device] = (T, {})
        return rep

    # -- engine selection ----------------------------------------------------
    def _steps(self, ruleno: int):
        return [(s.op, s.arg1, s.arg2) for s in self.map.rules[ruleno].steps]

    def kernel_plan(self, ruleno: int,
                    device: torch.device | None = None
                    ) -> kernels.PlanTensors | None:
        """The kernel's plan for this rule on ``device`` (default: this
        Mapper's), or None."""
        if device is not None and device != self.T.items.device:
            plans = self._replica(device)[1]
            if ruleno not in plans:
                own = self.kernel_plan(ruleno)
                plans[ruleno] = None if own is None else \
                    kernels.plan_tensors(own.plan, device)
            return plans[ruleno]
        if ruleno not in self._plans:
            plan = kernels.build_plan(self.map, ruleno, self.device_weights,
                                      self.choose_args_key)
            self._plans[ruleno] = None if plan is None else \
                kernels.plan_tensors(plan, self.device)
        return self._plans[ruleno]

    def _kernel_numrep(self, ruleno: int, result_max: int) -> int | None:
        pt = self.kernel_plan(ruleno)
        if pt is None:
            return None
        arg = pt.plan.numrep_arg
        numrep = min(arg if arg > 0 else arg + result_max, result_max)
        if numrep < 1 or numrep + kernels.SPEC_EXTRA > kernels.MAX_CAND:
            return None
        return numrep

    def _kernel_path(self) -> str:
        return "kernel" if on_card(self) else "kernel-plain"

    def mapping_path(self, ruleno: int, result_max: int) -> str:
        """The engine serving (rule, width): 'kernel' (the CUDA kernel),
        'kernel-plain' (its plain version, on the CPU), 'vm' or
        'scalar'. A quarantined kernel-plain leaves 'vm'."""
        if _scalar_reason_of(self.map, self._steps(ruleno)):
            return "scalar"
        if self._kernel_ok and \
                self._kernel_numrep(ruleno, result_max) is not None:
            return self._kernel_path()
        return "vm"

    def kernel_plan_info(self, ruleno: int, result_max: int
                         ) -> dict | None:
        """Facts of the kernel launch that serves (rule, width), or None
        where the VM or the scalar walk serves. Bench rows attach them
        (``crush_sweep.sweep_rate``). The reference's five keys, from
        this plan and ``kernels.kernel_geometry``:

        - ``fetches_per_sweep``: level passes of one lane (groups x
          levels);
        - ``fetch_amortization``: the per-PG reduction of level passes
          against one pass per candidate, 1.0 for this kernel;
        - ``candidate_batched``: more than one candidate per pass;
        - ``kernel_lanes`` / ``candidate_fold``: the block width and
          the candidates per pass.

        It builds or looks up the plan only: nothing is launched."""
        if not self.mapping_path(ruleno, result_max).startswith("kernel"):
            return None
        plan = self.kernel_plan(ruleno).plan
        n_cand = self._kernel_numrep(ruleno, result_max) + kernels.SPEC_EXTRA
        lanes, fold, groups = kernels.kernel_geometry(plan, n_cand)
        return {
            "fetches_per_sweep": groups * plan.n_levels,
            "fetch_amortization": round(n_cand / groups, 3),
            "candidate_batched": fold > 1,
            "kernel_lanes": lanes,
            "candidate_fold": fold,
        }

    def expected_path(self, ruleno: int, result_max: int) -> str:
        """The engine this Mapper is expected to serve (rule, width) on:
        the plan's prediction, except that a Mapper whose kernel failed
        stays pinned to the kernel it promised."""
        return self._degraded_from or \
            self.mapping_path(ruleno, result_max)

    # -- kernel quarantine -----------------------------------------------------
    def _knob(self, name: str, default):
        """crush_kernel_reprobe_* knobs, read live from this Mapper's
        config dict or the process devmon's."""
        cfg = self._config if self._config is not None \
            else _devmon().config
        try:
            return type(default)(cfg.get(name, default))
        except (TypeError, ValueError):
            return default

    def _disable_kernel(self, where: str, exc: Exception) -> None:
        """A kernel failure. On the card it is counted and ``exc`` is
        raised: no other engine serves the work. On the CPU the kernel is
        quarantined: the VM serves while a re-probe waits on capped
        exponential backoff, and after
        crush_kernel_reprobe_disable_after consecutive failures the
        quarantine is permanent."""
        PERF.inc("kernel_exec_failures")
        dm = _devmon()
        log = get_logger("crush")
        what = f"{type(exc).__name__}: {str(exc)[:200]}"
        if on_card(self):
            dm.perf.inc("quarantine_entries")
            log.dout(0, f"CRUSH kernel failed in {where} on the card "
                        f"({what}); raised to the caller")
            raise exc
        self._degraded_from = self._kernel_path()
        self._kernel_ok = False
        entering = self._quar_state is None
        self._quar_failures += 1
        disable_after = max(
            1, self._knob("crush_kernel_reprobe_disable_after", 5))
        if self._quar_failures >= disable_after:
            self._quar_state = "permanent"
            self._quar_next_probe = float("inf")
            log.dout(0, f"CRUSH kernel failed in {where} ({what}): "
                        f"{self._quar_failures} consecutive failures, "
                        f"permanently disabled for this Mapper")
        else:
            base = self._knob("crush_kernel_reprobe_base", 0.5)
            cap = self._knob("crush_kernel_reprobe_max", 30.0)
            backoff = min(base * (2 ** (self._quar_failures - 1)), cap)
            self._quar_next_probe = time.monotonic() + backoff
            self._quar_state = "quarantined" if entering else "reprobing"
            log.dout(0, f"CRUSH kernel failed in {where} ({what}): "
                        f"quarantined (the VM serves; re-probe in "
                        f"{backoff:.2f}s, failure "
                        f"{self._quar_failures}/{disable_after})")
        if entering:
            dm.record_quarantine_enter(self._devmon_token, self._quar_state)
        else:
            dm.set_quarantine_state(self._devmon_token, self._quar_state)

    def _maybe_reprobe(self, ruleno: int, result_max: int) -> None:
        """Run one backoff-paced probe when due (at the top of a fresh
        map_pgs/sweep call, never from the retry after a failure)."""
        if self._quar_state in (None, "permanent"):
            return
        if time.monotonic() < self._quar_next_probe:
            return
        self._reprobe(ruleno, result_max)

    def _reprobe(self, ruleno: int, result_max: int) -> None:
        """One probe: the kernel on PROBE_PGS seeds against the VM, bit
        for bit. Equal -> re-promote (the quarantine exits and the
        failure count resets); raise or mismatch -> back to quarantine
        with doubled backoff."""
        dm = _devmon()
        self._kernel_ok = True
        try:
            numrep = self._kernel_numrep(ruleno, result_max)
        except Exception as e:
            dm.record_probe(False)
            PERF.inc("kernel_probes")
            self._disable_kernel("reprobe", e)
            return
        if numrep is None:
            # this (rule, width) never rides the kernel: nothing to judge
            # here; probe on a kernel-eligible call instead
            self._kernel_ok = False
            return
        PERF.inc("kernel_probes")
        x = torch.arange(PROBE_PGS, dtype=torch.int64, device=self.device)
        try:
            got = self._map_block(ruleno, x, result_max, self._kernel_path())
            ref = self._vm_map(ruleno, x, result_max)
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise RuntimeError(
                    f"probe mismatch: kernel disagrees with the VM on "
                    f"{bad}/{got.numel()} slots")
        except Exception as e:
            dm.record_probe(False)
            self._disable_kernel("reprobe", e)
            return
        dm.record_probe(True)
        PERF.inc("kernel_repromotes")
        self._quar_state = None
        self._quar_failures = 0
        self._quar_next_probe = 0.0
        self._degraded_from = None
        dm.record_quarantine_exit(self._devmon_token)
        get_logger("crush").dout(
            0, f"CRUSH kernel re-promoted after quarantine (probe "
               f"bit-exact against the VM on {PROBE_PGS} PGs, rule "
               f"{ruleno})")

    def kernel_quarantine_info(self) -> dict | None:
        """The quarantine state machine's live view, or None when the
        kernel is healthy."""
        if self._quar_state is None:
            return None
        due = self._quar_next_probe - time.monotonic()
        return {"state": self._quar_state,
                "failures": self._quar_failures,
                "next_probe_in_s": (round(max(due, 0.0), 3)
                                    if self._quar_state != "permanent"
                                    else None)}

    def rule_is_firstn(self, ruleno: int) -> bool:
        return not any(s.op in (OP_CHOOSE_INDEP, OP_CHOOSELEAF_INDEP)
                       for s in self.map.rules[ruleno].steps)

    def effective_block(self, ruleno: int, result_max: int) -> int:
        """PGs per device pass for this (rule, width): the ``block``
        given to the constructor, else KERNEL_BLOCK on the kernel path
        and VM_BLOCK on the others."""
        if self.block:
            return self.block
        if self.mapping_path(ruleno, result_max).startswith("kernel"):
            return KERNEL_BLOCK
        return VM_BLOCK

    # -- mapping ---------------------------------------------------------------
    def _scalar_map(self, ruleno: int, x: torch.Tensor,
                    result_max: int) -> torch.Tensor:
        from ceph_tpu_torch.crush import mapper_ref
        weight = self.device_weights.tolist()
        cargs = self.map.choose_args.get(self.choose_args_key) \
            if self.choose_args_key is not None else None
        out = np.full((x.shape[0], result_max), ITEM_NONE, dtype=np.int64)
        for i, xi in enumerate(x.cpu().tolist()):
            got = mapper_ref.do_rule(self.map, ruleno, int(xi), result_max,
                                     weight, cargs)[:result_max]
            out[i, :len(got)] = got
        return torch.as_tensor(out, device=self.device)

    def _vm_map(self, ruleno: int, x: torch.Tensor,
                result_max: int) -> torch.Tensor:
        return run_rule(self._replica(x.device)[0], self._steps(ruleno),
                        self.map.tunables, x, result_max)

    def _engine_launch(self, ruleno, x, result_max, path):
        """One block's device work up to its first host read: for the
        kernel path the launch, giving (rows, flags) of which the flagged
        lanes are still to recompute; other engines run whole (flags
        None). Runs on the device ``x`` lies on."""
        if path == "scalar":
            return self._scalar_map(ruleno, x, result_max), None
        if not path.startswith("kernel"):
            return self._vm_map(ruleno, x, result_max), None
        numrep = self._kernel_numrep(ruleno, result_max)
        leaves, bad = kernels.crush_straw2(
            self.kernel_plan(ruleno, x.device), _as_i32(x), numrep)
        out = torch.full((x.shape[0], result_max), ITEM_NONE,
                         dtype=torch.int64, device=x.device)
        out[:, :numrep] = leaves
        return out, bad

    def _engine_finish(self, ruleno, x, result_max, out, bad):
        """The kernel's flagged lanes, recomputed by the rule VM."""
        if bad is None:
            return out
        flagged = bad.nonzero()[:, 0]
        if flagged.numel():
            self.flagged_lanes += int(flagged.numel())
            out[flagged] = self._vm_map(ruleno, x[flagged], result_max)
        return out

    def _engine_map(self, ruleno, x, result_max, path):
        return self._engine_finish(ruleno, x, result_max,
                                   *self._engine_launch(ruleno, x,
                                                        result_max, path))

    def _map_block(self, ruleno, x, result_max, path,
                   fn_name: str = "crush_map_pgs"):
        """One block through devmon's chokepoint (first-launch accounting
        and device fault injection). The key has no width: a CUDA kernel
        has no per-shape build, and delta re-runs come at ragged widths."""
        return _devmon().jit_call(
            fn_name, (path, self._devmon_token, ruleno, result_max),
            self._engine_map, ruleno, x, result_max, path)

    def _map_round(self, ruleno, xs: list, result_max, path,
                   fn_name: str) -> list:
        """One block on each of several devices (a sharded tile round):
        every block's device work is queued, through devmon's chokepoint
        under one key for all of them, before any block's flags are read
        back, so the devices run together."""
        key = (path, self._devmon_token, ruleno, result_max)
        launched = [_devmon().jit_call(fn_name, key, self._engine_launch,
                                       ruleno, x, result_max, path)
                    for x in xs]
        return [self._engine_finish(ruleno, x, result_max, out, bad)
                for x, (out, bad) in zip(xs, launched)]

    def _record_path(self, path: str, expected: str | None) -> str:
        """This call's engine: the ``last_map_path`` mirror, devmon's
        launch counter and, given an expectation, its path check."""
        self.last_map_path = path
        dm = _devmon()
        dm.record_launch(path)
        if expected is not None:
            dm.record_path_check(expected, path)
        return path

    def map_pgs(self, ruleno: int, xs, result_max: int) -> torch.Tensor:
        """crush_do_rule over seeds ``xs`` -> (N, result_max) int32 device
        ids on this Mapper's device (ITEM_NONE past each result)."""
        return self.map_pgs_path(ruleno, xs, result_max)[0]

    def map_pgs_path(self, ruleno: int, xs, result_max: int,
                     _expected: str | None = None):
        """``map_pgs`` returning ``(out, path)``, ``path`` the engine this
        call ran on. ``_expected`` is internal: the engine predicted at
        first entry, carried through the retry after a kernel failure so
        the degrade records one mismatch against the original plan."""
        x = _seeds(xs, self.device)
        scalar = _scalar_reason_of(self.map, self._steps(ruleno)) is not None
        if _expected is None and not scalar:
            self._maybe_reprobe(ruleno, result_max)
            _expected = self.expected_path(ruleno, result_max)
        path = self.mapping_path(ruleno, result_max)
        sharded = not scalar and self._use_mesh(x.shape[0])
        try:
            if sharded:
                out = sharded_sweep.sharded_map_pgs(self.mesh, self, ruleno,
                                                    x, result_max)
            else:
                out = self._map_local(ruleno, x, result_max, path)
        except Exception as e:
            if not path.startswith("kernel"):
                raise
            self._disable_kernel("sharded_map_pgs" if sharded else "map_pgs",
                                 e)                  # raises on the card
            return self.map_pgs_path(ruleno, x, result_max,
                                     _expected=_expected)
        if sharded:
            path += "+sharded"
        return out.to(torch.int32), self._record_path(path, _expected)

    def _map_local(self, ruleno, x, result_max, path) -> torch.Tensor:
        block = self.effective_block(ruleno, result_max)
        pieces = [self._map_block(ruleno, x[lo:lo + block], result_max, path)
                  for lo in range(0, x.shape[0], block)]
        return torch.cat(pieces) if pieces else torch.full(
            (0, result_max), ITEM_NONE, dtype=torch.int64, device=self.device)

    def sweep(self, ruleno: int, start_x: int, n: int, result_max: int,
              device_counts_size: int | None = None):
        """Map [start_x, start_x + n) and count placements per device on
        the device. Returns (counts int64 (devices,), bad int64 scalar):
        bad counts firstn results shorter than result_max."""
        counts, bad, _ = self.sweep_path(ruleno, start_x, n, result_max,
                                         device_counts_size)
        return counts, bad

    def sweep_path(self, ruleno: int, start_x: int, n: int,
                   result_max: int, device_counts_size: int | None = None,
                   _expected: str | None = None):
        """``sweep`` returning ``(counts, bad, path)`` (see map_pgs_path
        for the per-call path and ``_expected``)."""
        nd = device_counts_size or self.packed.max_devices
        scalar = _scalar_reason_of(self.map, self._steps(ruleno)) is not None
        if _expected is None and not scalar:
            self._maybe_reprobe(ruleno, result_max)
            _expected = self.expected_path(ruleno, result_max)
        path = self.mapping_path(ruleno, result_max)
        sharded = not scalar and device_counts_size is None and \
            self._use_mesh(n)
        try:
            if sharded:
                counts, bad = sharded_sweep.sharded_sweep(
                    self.mesh, self, ruleno, start_x, n, result_max)
            else:
                counts, bad = self._sweep_local(ruleno, start_x, n,
                                                result_max, nd, path)
        except Exception as e:
            if not path.startswith("kernel"):
                raise
            self._disable_kernel("sharded_sweep" if sharded else "sweep",
                                 e)                  # raises on the card
            return self.sweep_path(ruleno, start_x, n, result_max,
                                   device_counts_size, _expected=_expected)
        if sharded:
            path += "+sharded"
        return counts, bad, self._record_path(path, _expected)

    def _sweep_local(self, ruleno, start_x, n, result_max, nd, path):
        block = self.effective_block(ruleno, result_max)
        firstn = self.rule_is_firstn(ruleno)
        counts = torch.zeros(nd + 1, dtype=torch.int64, device=self.device)
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        for lo in range(0, n, block):
            x = (torch.arange(lo, min(n, lo + block), dtype=torch.int64,
                              device=self.device) + start_x) & M32
            w = self._map_block(ruleno, x, result_max, path, "crush_sweep")
            tally(counts, bad, w, nd, result_max, firstn)
        return counts[:nd], bad


def tally(counts: torch.Tensor, bad: torch.Tensor, w: torch.Tensor, nd: int,
          result_max: int, firstn: bool) -> None:
    """Add one block's rows ``w`` into ``counts`` ((nd + 1,): placements
    per device, slot nd for ITEM_NONE and devices past nd) and ``bad``
    (firstn rows shorter than result_max), on their device."""
    live = w != ITEM_NONE
    flat = torch.where(live & (w < nd), w, nd).reshape(-1)
    counts += torch.bincount(flat, minlength=nd + 1)
    if firstn:
        bad += (live.sum(dim=1) < result_max).sum()
