"""Programmatic CRUSH map construction.

ref: src/crush/builder.c (crush_make_bucket/crush_add_bucket) and
src/crush/CrushWrapper.cc (add_simple_rule, insert_item). Builds the common
hierarchies (root -> rack -> host -> osd) and replicated/erasure rules.
"""

from __future__ import annotations

from ceph_tpu_torch.crush.types import (
    ALG_STRAW, ALG_STRAW2, ALG_TREE,
    OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP, OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP, OP_EMIT, OP_TAKE, WEIGHT_ONE,
    Bucket, CrushMap, Rule, RuleStep, Tunables,
)

# Conventional type ids (ref: default crushmap types in
# src/crush/CrushCompiler.cc / vstart-generated maps).
TYPE_OSD = 0
TYPE_HOST = 1
TYPE_RACK = 3
TYPE_ROOT = 10

DEFAULT_TYPE_NAMES = {TYPE_OSD: "osd", TYPE_HOST: "host", TYPE_RACK: "rack",
                      TYPE_ROOT: "root"}


def add_bucket(map_: CrushMap, bucket: Bucket, name: str | None = None) -> int:
    """ref: builder.c crush_add_bucket (id assignment when 0)."""
    if bucket.id == 0:
        bucket.id = -(len(map_.buckets) + 1)
    if bucket.id in map_.buckets:
        raise ValueError(f"bucket id {bucket.id} exists")
    map_.buckets[bucket.id] = bucket
    if name:
        map_.bucket_names[bucket.id] = name
    return bucket.id


def make_bucket(map_: CrushMap, type_: int, items: list[int],
                weights: list[int] | None = None, alg: int = ALG_STRAW2,
                name: str | None = None, bucket_id: int = 0) -> int:
    """Create + insert a bucket; child weights default to their subtree sum."""
    if weights is None:
        weights = [item_weight(map_, i) for i in items]
    b = Bucket(id=bucket_id, type=type_, alg=alg, items=list(items),
               weights=list(weights))
    finish_bucket(b)
    return add_bucket(map_, b, name)


def finish_bucket(b: Bucket) -> None:
    """(Re)build alg-specific derived state (straw lengths / tree
    nodes). MUST be called after any items/weights mutation of a
    straw/tree bucket — the reference's crush_bucket_*_adjust_item_weight
    recalculates the same state (ref: builder.c)."""
    if b.alg == ALG_STRAW:
        b.straws = calc_straws(b.weights)
    elif b.alg == ALG_TREE:
        b.node_weights = make_tree_nodes(b.weights)


def calc_straws(weights: list[int]) -> list[int]:
    """straw(v1) scaling factors (ref: src/crush/builder.c
    crush_calc_straw, straw_calc_version=1 semantics).

    Walk items by ascending weight; every item whose weight ties the
    previous keeps the same straw; at each weight step the straw grows by
    (1/pbelow)^(1/numleft) where pbelow is the probability mass already
    'below' the boundary. Float math exactly like the reference (the
    shipped straws are double-computed too). Zero-weight items get zero
    straws. Provenance: reimplemented from the published algorithm; the
    reference tree was unavailable for byte comparison (SURVEY.md)."""
    size = len(weights)
    order = sorted(range(size), key=lambda i: (weights[i], i))
    straws = [0] * size
    straw = 1.0
    numleft = size
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if weights[order[i]] == 0:
            straws[order[i]] = 0
            i += 1
            numleft -= 1
            continue
        straws[order[i]] = int(straw * 0x10000)
        i += 1
        numleft -= 1
        if i == size:
            break
        if weights[order[i]] == weights[order[i - 1]]:
            continue
        wbelow += (weights[order[i - 1]] - lastw) * (numleft + 1)
        wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= (1.0 / pbelow) ** (1.0 / numleft)
        lastw = weights[order[i - 1]]
    return straws


def tree_depth(size: int) -> int:
    """ref: builder.c calc_depth: leaves live at odd nodes 2i+1, so the
    tree needs 2*size node slots rounded up to a power of two."""
    if size <= 1:
        return 1
    return (size - 1).bit_length() + 1


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0 and n:
        h += 1
        n >>= 1
    return h


def make_tree_nodes(weights: list[int]) -> list[int]:
    """Binary-tree node weights (ref: builder.c crush_make_tree_bucket):
    item i sits at node 2i+1; each internal node holds its subtree sum."""
    size = len(weights)
    num_nodes = 1 << tree_depth(size)
    nodes = [0] * num_nodes
    for i, w in enumerate(weights):
        node = ((i + 1) << 1) - 1
        nodes[node] = w
        # propagate to ancestors: parent(t) clears height bit, sets next
        t = node
        while True:
            h = _tree_height(t)
            parent = (t & ~(1 << h)) | (1 << (h + 1))
            if parent >= num_nodes:
                break
            nodes[parent] += w
            t = parent
    return nodes


def item_weight(map_: CrushMap, item: int) -> int:
    """Subtree weight: devices default to 1.0; buckets sum their items."""
    if item >= 0:
        return WEIGHT_ONE
    return map_.buckets[item].weight


def build_flat(n_osds: int, alg: int = ALG_STRAW2,
               weights: list[int] | None = None,
               tunables: Tunables | None = None) -> tuple[CrushMap, int]:
    """One root bucket holding n devices. Returns (map, root_id)."""
    m = CrushMap(tunables=tunables or Tunables(),
                 type_names=dict(DEFAULT_TYPE_NAMES))
    m.max_devices = n_osds
    root = make_bucket(m, TYPE_ROOT, list(range(n_osds)),
                       weights or [WEIGHT_ONE] * n_osds, alg=alg, name="root")
    return m, root


def build_hierarchy(n_hosts: int, osds_per_host: int,
                    alg: int = ALG_STRAW2,
                    n_racks: int = 0,
                    osd_weights: list[int] | None = None,
                    tunables: Tunables | None = None) -> tuple[CrushMap, int]:
    """root -> [rack ->] host -> osd tree, evenly filled.

    Mirrors the shape vstart/osdmaptool generate for testing
    (ref: src/tools/osdmaptool.cc --createsimple).
    """
    m = CrushMap(tunables=tunables or Tunables(),
                 type_names=dict(DEFAULT_TYPE_NAMES))
    n = n_hosts * osds_per_host
    m.max_devices = n
    if osd_weights is None:
        osd_weights = [WEIGHT_ONE] * n
    hosts = []
    for hi in range(n_hosts):
        osds = list(range(hi * osds_per_host, (hi + 1) * osds_per_host))
        hosts.append(make_bucket(
            m, TYPE_HOST, osds, [osd_weights[o] for o in osds], alg=alg,
            name=f"host{hi}"))
    if n_racks:
        racks = []
        per = max(1, n_hosts // n_racks)
        for ri in range(n_racks):
            hs = hosts[ri * per: (ri + 1) * per] if ri < n_racks - 1 \
                else hosts[(n_racks - 1) * per:]
            racks.append(make_bucket(m, TYPE_RACK, hs, alg=alg,
                                     name=f"rack{ri}"))
        root = make_bucket(m, TYPE_ROOT, racks, alg=alg, name="root")
    else:
        root = make_bucket(m, TYPE_ROOT, hosts, alg=alg, name="root")
    return m, root


def _parents(map_: CrushMap) -> dict[int, int]:
    return {child: b.id for b in map_.buckets.values() for child in b.items}


def insert_item(map_: CrushMap, item: int, weight: int,
                bucket_id: int) -> None:
    """Add a device/bucket under `bucket_id` and propagate the weight
    delta to ancestors (ref: src/crush/CrushWrapper.cc insert_item +
    adjust_item_weight)."""
    b = map_.buckets[bucket_id]
    if item in b.items:
        raise ValueError(f"item {item} already in bucket {bucket_id}")
    b.items.append(item)
    b.weights.append(weight)
    finish_bucket(b)
    if item >= 0:
        map_.max_devices = max(map_.max_devices, item + 1)
    _adjust_ancestors(map_, bucket_id, weight)


def remove_item(map_: CrushMap, item: int) -> None:
    """Unlink a device/bucket from its parent
    (ref: CrushWrapper.cc remove_item)."""
    for b in map_.buckets.values():
        if item in b.items:
            i = b.items.index(item)
            w = b.weights[i]
            del b.items[i]
            del b.weights[i]
            finish_bucket(b)
            _adjust_ancestors(map_, b.id, -w)
            return
    raise ValueError(f"item {item} not in any bucket")


def adjust_item_weight(map_: CrushMap, item: int, weight: int) -> None:
    """Set the CRUSH weight of an item everywhere it appears
    (ref: CrushWrapper.cc adjust_item_weight)."""
    for b in map_.buckets.values():
        if item in b.items:
            i = b.items.index(item)
            delta = weight - b.weights[i]
            b.weights[i] = weight
            finish_bucket(b)
            _adjust_ancestors(map_, b.id, delta)


def _adjust_ancestors(map_: CrushMap, bucket_id: int, delta: int) -> None:
    parents = _parents(map_)
    cur = bucket_id
    while cur in parents:
        parent = map_.buckets[parents[cur]]
        i = parent.items.index(cur)
        parent.weights[i] += delta
        finish_bucket(parent)
        cur = parent.id


def add_simple_rule(map_: CrushMap, root: int, failure_domain_type: int,
                    name: str = "", rule_id: int | None = None,
                    indep: bool = False) -> int:
    """take root; chooseleaf firstn|indep 0 type <fd>; emit
    (ref: src/crush/CrushWrapper.cc add_simple_rule_at)."""
    rid = rule_id if rule_id is not None else len(map_.rules)
    op = OP_CHOOSELEAF_INDEP if indep else OP_CHOOSELEAF_FIRSTN
    if failure_domain_type == TYPE_OSD:
        op = OP_CHOOSE_INDEP if indep else OP_CHOOSE_FIRSTN
    rule = Rule(id=rid, name=name or f"rule{rid}",
                type=3 if indep else 1,
                steps=[RuleStep(OP_TAKE, root),
                       RuleStep(op, 0, failure_domain_type),
                       RuleStep(OP_EMIT)])
    map_.rules[rid] = rule
    return rid


def add_multistep_rule(map_: CrushMap, root: int, steps: list[RuleStep],
                       name: str = "", rule_id: int | None = None,
                       indep: bool = False) -> int:
    """take root; <caller steps>; emit — for rack-aware layouts like
    ``choose firstn 0 type rack; chooseleaf firstn 1 type host``."""
    rid = rule_id if rule_id is not None else len(map_.rules)
    rule = Rule(id=rid, name=name or f"rule{rid}",
                type=3 if indep else 1,
                steps=[RuleStep(OP_TAKE, root), *steps, RuleStep(OP_EMIT)])
    map_.rules[rid] = rule
    return rid


# -- choose_args weight-set discipline --------------------------------------
# The JAX package's fused TPU kernel carries at most 4 distinct positive
# weights per bucket in its class draw; quantizing a weight-set to <= 4
# classes kept balancer output on that kernel. The port's kernel draws
# exactly with any weights, so here quantizing only matches the maps the
# reference produces.
KERNEL_WEIGHT_CLASSES = 4


def choose_args_weight_classes(m: CrushMap) -> int:
    """Worst-case distinct positive weights any single weight-set
    vector carries (0 = no choose_args). Above KERNEL_WEIGHT_CLASSES
    the map leaves the fused-kernel mapping path."""
    worst = 0
    for args in m.choose_args.values():
        for arg in args.values():
            for ws in arg.weight_set:
                worst = max(worst,
                            len({int(w) for w in ws if int(w) > 0}))
    return worst


def quantize_choose_args(m: CrushMap, key: int | None = None,
                         max_classes: int = KERNEL_WEIGHT_CLASSES
                         ) -> int:
    """Snap every choose_args weight-set vector (of set ``key``, or
    all sets) to at most ``max_classes`` distinct positive weights.

    Deterministic quantile binning: the sorted positive weights are cut
    into ``max_classes`` contiguous groups and every member takes its
    group's mean (16.16 fixed point, like the raw weights). Zero/
    negative weights (drained items) are preserved exactly — class
    membership must not resurrect them. Returns the worst per-vector
    class count after quantization (<= max_classes)."""
    keys = [key] if key is not None else list(m.choose_args)
    worst = 0
    for k in keys:
        for arg in m.choose_args.get(k, {}).values():
            for ws in arg.weight_set:
                pos = sorted({int(w) for w in ws if int(w) > 0})
                if len(pos) > max_classes:
                    # contiguous quantile groups over the DISTINCT
                    # sorted weights; each maps to its group mean
                    groups: dict[int, int] = {}
                    n = len(pos)
                    for gi in range(max_classes):
                        lo = gi * n // max_classes
                        hi = (gi + 1) * n // max_classes
                        members = pos[lo:hi]
                        if not members:
                            continue
                        mean = sum(members) // len(members)
                        for w in members:
                            groups[w] = mean
                    for i, w in enumerate(ws):
                        if int(w) > 0:
                            ws[i] = groups[int(w)]
                worst = max(worst,
                            len({int(w) for w in ws if int(w) > 0}))
    return worst
