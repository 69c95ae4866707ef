"""Pack a CrushMap into padded device arrays for the vectorized mapper.

The no-dynamic-shapes rule (SURVEY.md §7 hard parts): per-bucket item lists
are padded to the map-wide max size; bucket rows are indexed by
``bno = -1 - bucket_id`` exactly like the reference's bucket table
(ref: src/crush/crush.h crush_map.buckets[-1-id]); gaps become size-0 rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ceph_tpu_torch.crush.types import (
    ALG_LIST, ALG_STRAW, ALG_STRAW2, ALG_TREE, ALG_UNIFORM, CrushMap,
)


@dataclasses.dataclass(frozen=True)
class PackedMap:
    """Device-ready map tensors + static metadata.

    Array fields are numpy here; the mapper moves them to device once.
    Hashable/static fields (shapes, tunables, flags) drive jit
    specialization.
    """

    # (B, S) padded per-bucket arrays; row = bno = -1 - bucket_id.
    items: np.ndarray          # int32 child ids (pad 0)
    weights: np.ndarray        # int64 16.16 weights (pad 0)
    cumw: np.ndarray           # int64 inclusive cumsum of weights (list alg)
    # Magic-divide tables for the straw2 draw q = neg // w (w >= 3):
    # q = ((n1*m1 + (n1*m0 + n0*m1 + (n0*m0 >> 32)) >> 32) >> sh) with
    # neg = n1*2^32 + n0, M = m1*2^32 + m0 = ceil(2^(64+sh)/w),
    # sh = max(1, ceil(log2 w) - 15). Exact for neg < 2^49 (proof: with
    # e = M*w - 2^(64+sh) < w, the error term neg*e < 2^(49+ceil(log2 w))
    # <= 2^(64+sh)). Kept from the JAX package, whose TPU has no 64-bit
    # divider; the port's draw divides in int64 and does not read them.
    wm1: np.ndarray            # uint64 M >> 32
    wm0: np.ndarray            # uint64 M & 0xffffffff
    wsh: np.ndarray            # uint64 sh
    # straw(v1): per-slot straw lengths (uint64, 0 when absent).
    straws: np.ndarray
    # tree: padded per-bucket node-weight arrays (B, NT) + node counts;
    # NT = 1 when no tree bucket exists.
    tree_nodes: np.ndarray     # int64
    tree_num: np.ndarray       # int32 num_nodes per bucket (0 = not tree)
    # (B,) per-bucket scalars.
    size: np.ndarray           # int32
    alg: np.ndarray            # int32
    btype: np.ndarray          # int32
    bid: np.ndarray            # int32 (the negative id)
    # Static metadata.
    n_buckets: int
    max_size: int
    max_devices: int
    max_depth: int
    algs_present: tuple[int, ...]
    tree_depth_max: int = 0    # deepest tree-bucket descent (static unroll)
    # type_depth[t] = uniform distance (in choose levels) from every bucket
    # of type t down to devices, or -1 when buckets of that type disagree
    # (the mapper then falls back to max_depth unrolling). Index 0 = device
    # level = 0. Lets the rule VM unroll EXACTLY the levels a descent
    # needs instead of max_depth everywhere.
    type_depth: tuple[int, ...] = ()
    # (B,) int32: 1 iff this straw2 bucket qualifies for the exact
    # uniform-weight draw shortcut — all item weights equal one value w
    # with 0 < w <= ln_gap_info().G, so post-division draw ties happen
    # exactly on ln-equality of the hashes (see ln_table.ln_gap_info).
    uniform: np.ndarray = None

    def row(self, item: int) -> int:
        return -1 - item


def pack_map(m: CrushMap) -> PackedMap:
    m.validate()
    if not m.buckets:
        raise ValueError("empty crush map")
    n_buckets = max(-bid for bid in m.buckets)
    S = max(1, m.max_bucket_size())
    items = np.zeros((n_buckets, S), dtype=np.int32)
    weights = np.zeros((n_buckets, S), dtype=np.int64)
    size = np.zeros(n_buckets, dtype=np.int32)
    alg = np.full(n_buckets, ALG_STRAW2, dtype=np.int32)
    btype = np.zeros(n_buckets, dtype=np.int32)
    bid = np.array([-(i + 1) for i in range(n_buckets)], dtype=np.int32)
    from ceph_tpu_torch.crush import builder as _builder

    straws = np.zeros((n_buckets, S), dtype=np.uint64)
    has_tree = any(b.alg == ALG_TREE for b in m.buckets.values())
    NT = 1
    if has_tree:
        for b in m.buckets.values():
            if b.alg == ALG_TREE and b.node_weights is None:
                _builder.finish_bucket(b)
        NT = max(b.num_nodes for b in m.buckets.values()
                 if b.alg == ALG_TREE)
    tree_nodes = np.zeros((n_buckets, NT), dtype=np.int64)
    tree_num = np.zeros(n_buckets, dtype=np.int32)
    tree_depth_max = 0
    # Bulk fill (round 6): one flat scatter over all (bucket, slot)
    # pairs instead of a per-bucket python loop — at 10k OSDs the
    # row-by-row assignment was a visible slice of pack_seconds.
    blist = list(m.buckets.values())
    rows_b = np.array([-1 - b.id for b in blist], dtype=np.int64)
    sizes_b = np.array([b.size for b in blist], dtype=np.int64)
    size[rows_b] = sizes_b
    alg[rows_b] = [b.alg for b in blist]
    btype[rows_b] = [b.type for b in blist]
    if sizes_b.sum():
        flat_rows = np.repeat(rows_b, sizes_b)
        flat_cols = np.concatenate(
            [np.arange(s, dtype=np.int64) for s in sizes_b])
        items[flat_rows, flat_cols] = np.concatenate(
            [np.asarray(b.items, dtype=np.int32) for b in blist])
        weights[flat_rows, flat_cols] = np.concatenate(
            [np.asarray(b.weights, dtype=np.int64) for b in blist])
    for b in m.buckets.values():          # rare legacy algs only
        r = -1 - b.id
        if b.alg == ALG_STRAW:
            if b.straws is None:
                _builder.finish_bucket(b)
            straws[r, :b.size] = b.straws
        if b.alg == ALG_TREE:
            nw = b.node_weights
            tree_nodes[r, :len(nw)] = nw
            tree_num[r] = len(nw)
            tree_depth_max = max(tree_depth_max,
                                 _builder.tree_depth(b.size))
    cumw = np.cumsum(weights, axis=1)
    if S >= 1 << 16 or btype.max(initial=0) >= 1 << 11:
        raise ValueError("bucket size/type out of packed-meta range")
    wm1, wm0, wsh = magic_divide_tables(weights)
    from ceph_tpu_torch.crush.ln_table import ln_gap_info
    G, _ = ln_gap_info()
    # uniform-shortcut flags, row-vectorized: straw2, non-empty, all
    # live slots equal to the first weight, 0 < w <= G
    posmask = np.arange(S)[None, :] < size[:, None]
    first = weights[:, 0]
    alleq = np.all(np.where(posmask, weights, first[:, None])
                   == first[:, None], axis=1)
    uniform = ((alg == ALG_STRAW2) & (size > 0) & (first > 0)
               & (first <= G) & alleq).astype(np.int32)
    return PackedMap(
        items=items, weights=weights, cumw=cumw,
        wm1=wm1, wm0=wm0, wsh=wsh,
        straws=straws, tree_nodes=tree_nodes, tree_num=tree_num,
        size=size, alg=alg,
        btype=btype, bid=bid,
        n_buckets=n_buckets, max_size=S, max_devices=m.max_devices,
        max_depth=_max_depth(m),
        algs_present=tuple(sorted({b.alg for b in m.buckets.values()})),
        type_depth=_type_depths(m),
        tree_depth_max=tree_depth_max,
        uniform=uniform)


def magic_divide_tables(weights: np.ndarray):
    """Per-slot magic constants for exact ``neg // w`` (see PackedMap).

    Slots with w < 3 get M=0 (the kernel uses a shift for w in {1,2} and
    masks w == 0).

    The big-int ceil division cannot vectorize in numpy (2^(64+s) has
    no 64-bit representation), so the python loop runs over the UNIQUE
    weights only and fancy-indexes the results back — a continuous
    choose_args volume at 10k OSDs has ~20k distinct values where the
    old per-slot loop walked the full (P, B, S) volume."""
    flat = np.asarray(weights).reshape(-1)
    uniq, inv = np.unique(flat, return_inverse=True)
    um1 = np.zeros(uniq.shape, dtype=np.uint64)
    um0 = np.zeros(uniq.shape, dtype=np.uint64)
    ush = np.ones(uniq.shape, dtype=np.uint64)
    for i, wv in enumerate(uniq):
        w = int(wv)
        if w < 3:
            continue
        ell = (w - 1).bit_length()
        s = max(1, ell - 15)
        M = -((-(1 << (64 + s))) // w)          # ceil(2^(64+s)/w) < 2^64
        um1[i] = M >> 32
        um0[i] = M & 0xFFFFFFFF
        ush[i] = s
    shape = np.asarray(weights).shape
    return (um1[inv].reshape(shape), um0[inv].reshape(shape),
            ush[inv].reshape(shape))


def pack_choose_args(m: CrushMap, key: int, packed: PackedMap):
    """Pack one choose_args weight-set for the vectorized mapper.

    Returns (cw, cids, cm1, cm0, csh): cw (P, B, S) int64 per-position
    straw2 weights (base weights where a bucket has no override), cids
    (B, S) int32 hash ids, and the magic-divide tables for cw.
    (ref: src/crush/crush.h crush_choose_arg_map; mapper.c
    bucket_straw2_choose arg handling.)
    """
    args = m.choose_args[key]
    B, S = packed.weights.shape
    P = max((len(a.weight_set) for a in args.values() if a.weight_set),
            default=1)
    cw = np.repeat(packed.weights[None], P, axis=0).copy()
    cids = packed.items.copy()
    for bid, arg in args.items():
        r = -1 - bid
        if not (0 <= r < B):
            continue
        if arg.weight_set:
            for p in range(P):
                # clamp like mapper.c get_choose_arg_weights
                ws = arg.weight_set[min(p, len(arg.weight_set) - 1)]
                cw[p, r, :len(ws)] = ws[:S]
        if arg.ids:
            cids[r, :len(arg.ids)] = arg.ids[:S]
    # magic tables in one unique-memoized pass over the whole volume
    # (magic_divide_tables walks distinct weights only, so a continuous
    # weight-set no longer pays a python loop per (P, B, S) slot)
    cm1, cm0, csh = magic_divide_tables(cw)
    return cw, cids, cm1, cm0, csh


def _type_depths(m: CrushMap) -> tuple[int, ...]:
    """Per-type uniform depth (see PackedMap.type_depth)."""
    memo: dict[int, int] = {}

    def depth(item: int) -> int:
        if item >= 0:
            return 0
        if item in memo:
            return memo[item]
        memo[item] = 0
        b = m.buckets[item]
        memo[item] = 1 + max((depth(c) for c in b.items), default=0)
        return memo[item]

    by_type: dict[int, int] = {0: 0}
    for bid, b in m.buckets.items():
        d = depth(bid)
        if by_type.setdefault(b.type, d) != d:
            by_type[b.type] = -1
    max_t = max(by_type)
    return tuple(by_type.get(t, -1) for t in range(max_t + 1))


def _max_depth(m: CrushMap) -> int:
    """Longest bucket chain from any bucket down to a device."""
    memo: dict[int, int] = {}

    def depth(item: int) -> int:
        if item >= 0:
            return 0
        if item in memo:
            return memo[item]
        memo[item] = 0  # cycle guard
        b = m.buckets[item]
        d = 1 + max((depth(c) for c in b.items), default=0)
        memo[item] = d
        return d

    return max((depth(bid) for bid in m.buckets), default=1)
