"""CrushTreeDumper: the `ceph osd tree` table.

ref: src/crush/CrushTreeDumper.h — depth-first walk of the crush
hierarchy producing the ID / CLASS / WEIGHT / TYPE NAME rows with
up/down + reweight columns when an OSDMap is supplied.

The port's copy of ``ceph_tpu/crush/tree_dumper.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.crush.types import WEIGHT_ONE, CrushMap


def _roots(m: CrushMap) -> list[int]:
    children = {c for b in m.buckets.values() for c in b.items}
    return sorted((b.id for b in m.buckets.values()
                   if b.id not in children), reverse=True)


def _subtree_weight(m: CrushMap, item: int) -> int:
    if item >= 0:
        return WEIGHT_ONE
    return m.buckets[item].weight


def dump_tree(m: CrushMap, osdmap=None) -> str:
    """ref: CrushTreeDumper::dump + OSDMap::print_tree."""
    rows = [f"{'ID':>5} {'CLASS':>6} {'WEIGHT':>9}  "
            f"{'TYPE NAME':<30}{'STATUS':>8} {'REWEIGHT':>9}"]

    def walk(item: int, depth: int, weight: int) -> None:
        indent = "    " * depth
        if item < 0:
            b = m.buckets[item]
            tname = m.type_names.get(b.type, str(b.type))
            name = m.bucket_names.get(item, f"bucket{item}")
            rows.append(
                f"{item:>5} {'':>6} {weight / WEIGHT_ONE:>9.5f}  "
                f"{indent}{tname} {name}")
            for child, w in zip(b.items, b.weights):
                walk(child, depth + 1, w)
        else:
            cls = m.device_classes.get(item, "")
            status = ""
            reweight = ""
            if osdmap is not None and item < osdmap.max_osd:
                import numpy as np
                status = "up" if bool(osdmap.is_up(np.asarray(item))) \
                    else "down"
                rw = osdmap.osd_weight[item] / WEIGHT_ONE
                reweight = f"{rw:.5f}"
            rows.append(
                f"{item:>5} {cls:>6} {weight / WEIGHT_ONE:>9.5f}  "
                f"{indent}osd.{item}{status:>8} {reweight:>9}")

    for root in _roots(m):
        walk(root, 0, _subtree_weight(m, root))
    return "\n".join(rows) + "\n"
