"""Scalar reference CRUSH mapper — the executable spec.

Python re-implementation of the CRUSH placement algorithm
(ref: src/crush/mapper.c: crush_do_rule, crush_choose_firstn,
crush_choose_indep, bucket_straw2_choose, bucket_perm_choose, is_out),
written for clarity, not speed. The port's rule VM and kernel
(``ceph_tpu_torch.crush.mapper``, ``crush.kernels``) are tested against
this module; the Mapper also runs it for legacy tunables.

Supported bucket algorithms: straw2 (default), uniform, list, straw(v1),
tree. choose_args weight-sets override straw2 weights/ids per replica
position (ref: mapper.c bucket_straw2_choose crush_choose_arg handling).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.crush import hash as h
from ceph_tpu_torch.crush.ln_table import crush_ln
from ceph_tpu_torch.crush.types import (
    ALG_LIST, ALG_STRAW, ALG_STRAW2, ALG_TREE, ALG_UNIFORM,
    ITEM_NONE, ITEM_UNDEF,
    OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP, OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP, OP_EMIT, OP_NOOP, OP_SET_CHOOSELEAF_STABLE,
    OP_SET_CHOOSELEAF_TRIES, OP_SET_CHOOSELEAF_VARY_R,
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES, OP_SET_CHOOSE_LOCAL_TRIES,
    OP_SET_CHOOSE_TRIES, OP_TAKE,
    Bucket, CrushMap,
)

S64_MIN = -(1 << 63)


def _m(v: int) -> int:
    """Mask a (possibly negative) python int to C uint32."""
    return v & 0xFFFFFFFF


def _h2(a: int, b: int) -> int:
    return int(h.hash32_2(_m(a), _m(b)))


def _h3(a: int, b: int, c: int) -> int:
    return int(h.hash32_3(_m(a), _m(b), _m(c)))


def _h4(a: int, b: int, c: int, d: int) -> int:
    return int(h.hash32_4(_m(a), _m(b), _m(c), _m(d)))


def _div_trunc(a: int, b: int) -> int:
    """C-style int64 division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


# ---------------------------------------------------------------------------
# Bucket choose functions
# ---------------------------------------------------------------------------

def bucket_straw2_choose(bucket: Bucket, x: int, r: int,
                         arg=None, position: int = 0) -> int:
    """argmax_i crush_ln(hash16(x, item_i, r)) / weight_i
    (ref: mapper.c bucket_straw2_choose, incl. the crush_choose_arg
    weight-set/ids override keyed by replica position)."""
    weights = bucket.weights
    ids = bucket.items
    if arg is not None:
        if arg.weight_set:
            # out-of-range positions clamp to the last set (ref: mapper.c
            # get_choose_arg_weights)
            weights = arg.weight_set[min(position, len(arg.weight_set) - 1)]
        if arg.ids:
            ids = arg.ids
    high = 0
    high_draw = 0
    for i, (hid, w) in enumerate(zip(ids, weights)):
        if w:
            u = _h3(x, hid, r) & 0xFFFF
            ln = int(crush_ln(u)) - (1 << 48)  # <= 0
            draw = _div_trunc(ln, w)
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """Legacy straw(v1): draw = hash16(x, item, r) * straw_i, keep max
    (ref: mapper.c bucket_straw_choose; straws precomputed by the
    builder's crush_calc_straw)."""
    if bucket.straws is None:
        from ceph_tpu_torch.crush.builder import calc_straws
        bucket.straws = calc_straws(bucket.weights)
    high = 0
    high_draw = 0
    for i, item in enumerate(bucket.items):
        draw = (_h3(x, item, r) & 0xFFFF) * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    """Binary descent by weighted coin flips
    (ref: mapper.c bucket_tree_choose; terminal nodes are odd, item i at
    node 2i+1, left(n) = n - 2^(h-1) with h = trailing zeros of n)."""
    if bucket.node_weights is None:
        from ceph_tpu_torch.crush.builder import make_tree_nodes
        bucket.node_weights = make_tree_nodes(bucket.weights)
    nodes = bucket.node_weights
    n = len(nodes) >> 1                      # root
    while not (n & 1):
        w = nodes[n]
        t = (_h4(x, n, r, bucket.id) * w) >> 32
        half = (n & -n) >> 1
        left = n - half
        if t < nodes[left]:
            n = left
        else:
            n = n + half
    return bucket.items[n >> 1]


def bucket_perm_choose(bucket: Bucket, x: int, r: int) -> int:
    """Pseudo-random permutation pick (uniform buckets)
    (ref: mapper.c bucket_perm_choose): Fisher-Yates prefix driven by
    hash(x, bucket_id, position), select slot r % size."""
    size = bucket.size
    pr = r % size
    perm = list(range(size))
    for p in range(pr + 1):
        if p < size - 1:
            i = _h3(x, bucket.id, p) % (size - p)
            if i:
                perm[p], perm[p + i] = perm[p + i], perm[p]
    return bucket.items[perm[pr]]


def bucket_uniform_choose(bucket: Bucket, x: int, r: int) -> int:
    return bucket_perm_choose(bucket, x, r)


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    """Walk items tail->head, accept with probability weight/cum_weight
    (ref: mapper.c bucket_list_choose)."""
    sums = np.cumsum(bucket.weights).tolist()
    for i in range(bucket.size - 1, -1, -1):
        w = _h4(x, bucket.items[i], r, bucket.id) & 0xFFFF
        w = (w * sums[i]) >> 16
        if w < bucket.weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def bucket_choose(bucket: Bucket, x: int, r: int,
                  arg=None, position: int = 0) -> int:
    """ref: mapper.c crush_bucket_choose."""
    if bucket.alg == ALG_STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    if bucket.alg == ALG_UNIFORM:
        return bucket_uniform_choose(bucket, x, r)
    if bucket.alg == ALG_LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == ALG_STRAW:
        return bucket_straw_choose(bucket, x, r)
    if bucket.alg == ALG_TREE:
        return bucket_tree_choose(bucket, x, r)
    raise ValueError(f"unknown bucket alg {bucket.alg}")


def is_out(map_: CrushMap, weight: list[int], item: int, x: int) -> bool:
    """Probabilistic rejection by device reweight (ref: mapper.c is_out).

    weight: per-device 16.16 reweight vector (the OSDMap osd_weight array,
    NOT crush weights)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (_h2(x, item) & 0xFFFF) >= w


# ---------------------------------------------------------------------------
# The choose loops
# ---------------------------------------------------------------------------

def choose_firstn(map_: CrushMap, bucket: Bucket, weight: list[int], x: int,
                  numrep: int, type_: int, out: list, outpos: int,
                  out_size: int, tries: int, recurse_tries: int,
                  local_retries: int, local_fallback_retries: int,
                  recurse_to_leaf: bool, vary_r: int, stable: int,
                  out2: list | None, parent_r: int,
                  choose_args: dict | None = None) -> int:
    """ref: mapper.c crush_choose_firstn. Returns the new outpos.

    Chooses numrep distinct items of type_ below bucket, retrying on
    collision/rejection by re-descending with r' = rep + parent_r + ftotal.
    """
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        item = None
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_ = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                r = rep + parent_r + ftotal
                if in_.size == 0:
                    reject = True
                    collide = False
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_.size >> 1)
                            and flocal > local_fallback_retries):
                        item = bucket_perm_choose(in_, x, r)
                    else:
                        item = bucket_choose(
                            in_, x, r,
                            choose_args.get(in_.id) if choose_args else None,
                            outpos)
                    if item >= map_.max_devices:
                        skip_rep = True
                        break
                    itemtype = map_.item_type(item)
                    if itemtype != type_:
                        if item >= 0 or item not in map_.buckets:
                            skip_rep = True
                            break
                        in_ = map_.buckets[item]
                        retry_bucket = True
                        continue
                    collide = any(out[i] == item for i in range(outpos))
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            placed = choose_firstn(
                                map_, map_.buckets[item], weight, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0,
                                local_retries, local_fallback_retries,
                                False, vary_r, stable, None, sub_r,
                                choose_args)
                            if placed <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(map_, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def choose_indep(map_: CrushMap, bucket: Bucket, weight: list[int], x: int,
                 left: int, numrep: int, type_: int, out: list, outpos: int,
                 tries: int, recurse_tries: int, recurse_to_leaf: bool,
                 out2: list | None, parent_r: int,
                 choose_args: dict | None = None) -> None:
    """ref: mapper.c crush_choose_indep. Fills out[outpos:outpos+left] with
    items (position-stable; failures become ITEM_NONE for EC shards)."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = ITEM_UNDEF
        if out2 is not None:
            out2[rep] = ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != ITEM_UNDEF:
                continue
            in_ = bucket
            while True:
                r = rep + parent_r
                if in_.alg == ALG_UNIFORM and in_.size % numrep == 0:
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_.size == 0:
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    break
                item = bucket_choose(
                    in_, x, r,
                    choose_args.get(in_.id) if choose_args else None, rep)
                if item >= map_.max_devices:
                    break  # stays UNDEF, retried next ftotal
                itemtype = map_.item_type(item)
                if itemtype != type_:
                    if item >= 0 or item not in map_.buckets:
                        break
                    in_ = map_.buckets[item]
                    continue
                if any(out[i] == item for i in range(outpos, endpos)):
                    break
                if recurse_to_leaf:
                    if item < 0:
                        choose_indep(map_, map_.buckets[item], weight, x,
                                     1, numrep, 0, out2, rep,
                                     recurse_tries, 0, False, None, r,
                                     choose_args)
                        if out2[rep] == ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and is_out(map_, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == ITEM_UNDEF:
            out[rep] = ITEM_NONE
        if out2 is not None and out2[rep] == ITEM_UNDEF:
            out2[rep] = ITEM_NONE


# ---------------------------------------------------------------------------
# Rule execution
# ---------------------------------------------------------------------------

def do_rule(map_: CrushMap, ruleno: int, x: int, result_max: int,
            weight: list[int] | None = None,
            choose_args: dict | None = None) -> list[int]:
    """Execute rule `ruleno` for input x (ref: mapper.c crush_do_rule).

    weight: per-device 16.16 reweights for is_out; default all-in.
    Returns the device list (may contain ITEM_NONE for indep rules).
    """
    if weight is None:
        weight = [0x10000] * map_.max_devices
    rule = map_.rules[ruleno]
    t = map_.tunables
    choose_tries = t.choose_total_tries
    choose_leaf_tries = 0
    local_retries = t.choose_local_tries
    local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    result: list[int] = []
    w: list[int] = []
    for step in rule.steps:
        op = step.op
        if op == OP_NOOP:
            continue
        if op == OP_TAKE:
            if step.arg1 >= 0 or step.arg1 in map_.buckets:
                w = [step.arg1]
            else:
                raise ValueError(f"take of unknown bucket {step.arg1}")
        elif op == OP_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == OP_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == OP_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                local_retries = step.arg1
        elif op == OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                local_fallback_retries = step.arg1
        elif op == OP_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == OP_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in (OP_CHOOSE_FIRSTN, OP_CHOOSE_INDEP,
                    OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP):
            recurse_to_leaf = op in (OP_CHOOSELEAF_FIRSTN,
                                     OP_CHOOSELEAF_INDEP)
            firstn = op in (OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN)
            o: list[int] = []
            c: list[int] = []
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                if wi >= 0:
                    # A device in the working vector passes through only if
                    # it already has the wanted type (type 0).
                    if step.arg2 == 0:
                        o.append(wi)
                        c.append(wi)
                        osize += 1
                    continue
                bucket = map_.buckets[wi]
                if firstn:
                    recurse_tries = (
                        choose_leaf_tries or
                        (1 if t.chooseleaf_descend_once else choose_tries))
                    block: list[int] = [ITEM_NONE] * result_max
                    block2: list[int] = [ITEM_NONE] * result_max
                    placed = choose_firstn(
                        map_, bucket, weight, x, numrep, step.arg2,
                        block, 0, result_max - osize,
                        choose_tries, recurse_tries,
                        local_retries, local_fallback_retries,
                        recurse_to_leaf, vary_r, stable, block2, 0,
                        choose_args)
                    o.extend(block[:placed])
                    c.extend(block2[:placed])
                    osize += placed
                else:
                    out_size = min(numrep, result_max - osize)
                    block = [ITEM_NONE] * out_size
                    block2 = [ITEM_NONE] * out_size
                    choose_indep(
                        map_, bucket, weight, x, out_size, numrep,
                        step.arg2, block, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, block2, 0, choose_args)
                    o.extend(block)
                    c.extend(block2)
                    osize += out_size
            w = c[:osize] if recurse_to_leaf else o[:osize]
        elif op == OP_EMIT:
            result.extend(w)
            w = []
        else:
            raise ValueError(f"unknown rule op {op}")
    return result
