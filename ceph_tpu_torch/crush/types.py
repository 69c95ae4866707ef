"""The in-memory CRUSH map model.

ref: src/crush/crush.h (struct crush_map, crush_bucket*, crush_rule) —
re-modeled as plain dataclasses. Weights are 16.16 fixed point
(0x10000 == 1.0) exactly as in the reference; bucket ids are negative,
device ids non-negative.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace

# Bucket algorithms (ref: src/crush/crush.h enum crush_algorithm).
ALG_UNIFORM = 1
ALG_LIST = 2
ALG_TREE = 3
ALG_STRAW = 4
ALG_STRAW2 = 5

# Rule step ops (ref: src/crush/crush.h enum crush_opcodes).
OP_NOOP = 0
OP_TAKE = 1
OP_CHOOSE_FIRSTN = 2
OP_CHOOSE_INDEP = 3
OP_EMIT = 4
OP_CHOOSELEAF_FIRSTN = 6
OP_CHOOSELEAF_INDEP = 7
OP_SET_CHOOSE_TRIES = 8
OP_SET_CHOOSELEAF_TRIES = 9
OP_SET_CHOOSE_LOCAL_TRIES = 10
OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
OP_SET_CHOOSELEAF_VARY_R = 12
OP_SET_CHOOSELEAF_STABLE = 13

OP_NAMES = {
    OP_TAKE: "take", OP_CHOOSE_FIRSTN: "choose firstn",
    OP_CHOOSE_INDEP: "choose indep", OP_EMIT: "emit",
    OP_CHOOSELEAF_FIRSTN: "chooseleaf firstn",
    OP_CHOOSELEAF_INDEP: "chooseleaf indep",
    OP_SET_CHOOSE_TRIES: "set_choose_tries",
    OP_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
    OP_SET_CHOOSE_LOCAL_TRIES: "set_choose_local_tries",
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES: "set_choose_local_fallback_tries",
    OP_SET_CHOOSELEAF_VARY_R: "set_chooseleaf_vary_r",
    OP_SET_CHOOSELEAF_STABLE: "set_chooseleaf_stable",
}

# Sentinels (ref: src/crush/crush.h CRUSH_ITEM_NONE / CRUSH_ITEM_UNDEF).
ITEM_NONE = 0x7FFFFFFF
ITEM_UNDEF = 0x7FFFFFFE

WEIGHT_ONE = 0x10000  # 16.16 fixed point 1.0


@dataclass
class Bucket:
    """An interior node (ref: src/crush/crush.h struct crush_bucket).

    id: negative; type: positive hierarchy level (host/rack/...);
    items: child ids (devices >= 0 or buckets < 0);
    weights: per-item 16.16 weights (straw2/list use them; uniform uses
    item_weight for all).
    """

    id: int
    type: int
    alg: int = ALG_STRAW2
    hash: int = 0  # CRUSH_HASH_RJENKINS1
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)

    # straw(v1) only: per-item straw lengths scaled 16.16, computed by the
    # builder (ref: src/crush/builder.c crush_calc_straw); None until built.
    straws: list[int] | None = None
    # tree only: binary-tree node weights (ref: crush.h crush_bucket_tree
    # node_weights; items live at odd nodes 2i+1); None until built.
    node_weights: list[int] | None = None

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)

    @property
    def num_nodes(self) -> int:
        return len(self.node_weights) if self.node_weights else 0


@dataclass
class ChooseArg:
    """Per-bucket weight-set override (ref: src/crush/crush.h
    struct crush_choose_arg: weight_set[positions][size] + ids[size]).

    weight_set: one weight vector per replica position (16.16); the draw
    for replica slot p uses weight_set[min(p, positions-1)] (out-of-range
    positions clamp to the last set, ref: mapper.c get_choose_arg_weights).
    ids: optional substitute item ids fed to the straw2 hash.
    """

    weight_set: list[list[int]] = field(default_factory=list)
    ids: list[int] | None = None


@dataclass
class RuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    """ref: src/crush/crush.h struct crush_rule (+rule mask min/max size)."""

    id: int
    steps: list[RuleStep] = field(default_factory=list)
    type: int = 1  # pool type this serves: 1=replicated, 3=erasure
    name: str = ""


@dataclass
class Tunables:
    """ref: src/crush/crush.h crush_map tunables; defaults = jewel profile
    (ref: src/crush/CrushWrapper.h set_tunables_jewel)."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1

    @classmethod
    def legacy(cls) -> "Tunables":
        """Pre-bobtail behavior (ref: set_tunables_legacy)."""
        return cls(choose_local_tries=2, choose_local_fallback_tries=5,
                   choose_total_tries=19, chooseleaf_descend_once=0,
                   chooseleaf_vary_r=0, chooseleaf_stable=0)


@dataclass
class CrushMap:
    """ref: src/crush/crush.h struct crush_map + CrushWrapper name maps."""

    buckets: dict[int, Bucket] = field(default_factory=dict)  # id -> bucket
    rules: dict[int, Rule] = field(default_factory=dict)
    tunables: Tunables = field(default_factory=Tunables)
    max_devices: int = 0
    type_names: dict[int, str] = field(default_factory=lambda: {0: "osd"})
    bucket_names: dict[int, str] = field(default_factory=dict)
    device_classes: dict[int, str] = field(default_factory=dict)
    # Weight-sets (ref: src/crush/crush.h crush_choose_arg_map;
    # CrushWrapper choose_args): key (int id, -1 = the compat weight-set)
    # -> {bucket_id -> ChooseArg}. Only straw2 draws consult them.
    choose_args: dict[int, dict[int, "ChooseArg"]] = field(
        default_factory=dict)

    def bucket(self, item: int) -> Bucket:
        return self.buckets[item]

    def is_bucket(self, item: int) -> bool:
        return item < 0

    def item_type(self, item: int) -> int:
        """0 for devices, bucket.type for buckets."""
        return self.buckets[item].type if item < 0 else 0

    def max_bucket_size(self) -> int:
        return max((b.size for b in self.buckets.values()), default=0)

    def validate(self) -> None:
        for bid, b in self.buckets.items():
            if bid != b.id or bid >= 0:
                raise ValueError(f"bad bucket id {bid}")
            if len(b.items) != len(b.weights):
                raise ValueError(f"bucket {bid}: items/weights mismatch")
            for item in b.items:
                if item < 0 and item not in self.buckets:
                    raise ValueError(f"bucket {bid}: dangling child {item}")
                if item >= 0 and item >= self.max_devices:
                    raise ValueError(f"bucket {bid}: device {item} out of "
                                     f"range (max_devices={self.max_devices})")


def crush_map_state(m: CrushMap) -> dict:
    """The map as plain data: buckets (id, type, alg, items, weights and
    derived straw/tree state), rules, tunables and choose_args, as ints,
    lists and dicts. Its shape is ``dataclasses.asdict`` of a CrushMap,
    so a map built by any package with this model carries across."""
    return dataclasses.asdict(m)


def _ints(v) -> list[int] | None:
    return None if v is None else [int(x) for x in v]


def crush_map_from_state(d: dict) -> CrushMap:
    """Rebuild a CrushMap from ``crush_map_state`` output (lists or
    numpy arrays in the item/weight fields)."""
    buckets = {}
    for bid, b in d["buckets"].items():
        buckets[int(bid)] = Bucket(
            id=int(b["id"]), type=int(b["type"]), alg=int(b["alg"]),
            hash=int(b.get("hash", 0)), items=_ints(b["items"]),
            weights=_ints(b["weights"]), straws=_ints(b.get("straws")),
            node_weights=_ints(b.get("node_weights")))
    rules = {}
    for rid, r in d["rules"].items():
        steps = [RuleStep(int(s["op"]), int(s["arg1"]), int(s["arg2"]))
                 for s in r["steps"]]
        rules[int(rid)] = Rule(id=int(r["id"]), steps=steps,
                               type=int(r.get("type", 1)),
                               name=str(r.get("name", "")))
    choose_args = {}
    for key, args in d.get("choose_args", {}).items():
        choose_args[int(key)] = {
            int(bid): ChooseArg(
                weight_set=[_ints(ws) for ws in a.get("weight_set") or []],
                ids=_ints(a.get("ids")))
            for bid, a in args.items()}
    return CrushMap(
        buckets=buckets, rules=rules,
        tunables=Tunables(**{k: int(v) for k, v in d["tunables"].items()}),
        max_devices=int(d["max_devices"]),
        type_names={int(k): v for k, v in d.get("type_names", {}).items()},
        bucket_names={int(k): v
                      for k, v in d.get("bucket_names", {}).items()},
        device_classes={int(k): v
                        for k, v in d.get("device_classes", {}).items()},
        choose_args=choose_args)
