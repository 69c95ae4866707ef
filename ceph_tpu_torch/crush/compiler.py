"""CrushCompiler: crushmap text <-> CrushMap.

ref: src/crush/CrushCompiler.{h,cc} (compile/decompile). Same grammar as
``crushtool -d`` output / ``crushtool -c`` input:

    tunable <name> <value>
    device <id> osd.<id> [class <name>]
    type <id> <name>
    <typename> <bucketname> {
        id <negative int>            [# comment]
        alg uniform|list|tree|straw|straw2
        hash 0
        item <name> [weight <float>] [pos <int>]
        ...
    }
    rule <name> {
        id <int>
        type replicated|erasure
        step take <bucketname> [class <classname>]
        step set_chooseleaf_tries <n> | set_choose_tries <n> | ...
        step choose|chooseleaf firstn|indep <n> type <typename>
        step emit
    }

Device-class ``take X class Y`` is realized the reference way: shadow
hierarchies filtered per class (ref: CrushWrapper::populate_classes /
device_class_clone), built at compile time.
"""

from __future__ import annotations

from ceph_tpu_torch.crush.types import (
    ALG_LIST, ALG_STRAW, ALG_STRAW2, ALG_TREE, ALG_UNIFORM,
    OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP, OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP, OP_EMIT,
    OP_SET_CHOOSELEAF_STABLE, OP_SET_CHOOSELEAF_TRIES,
    OP_SET_CHOOSELEAF_VARY_R, OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    OP_SET_CHOOSE_LOCAL_TRIES, OP_SET_CHOOSE_TRIES, OP_TAKE,
    Bucket, CrushMap, Rule, RuleStep, Tunables, WEIGHT_ONE,
)

ALG_NAMES = {"uniform": ALG_UNIFORM, "list": ALG_LIST, "tree": ALG_TREE,
             "straw": ALG_STRAW, "straw2": ALG_STRAW2}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

RULE_TYPE_NAMES = {1: "replicated", 3: "erasure"}
RULE_TYPE_IDS = {v: k for k, v in RULE_TYPE_NAMES.items()}

SET_STEPS = {
    "set_choose_tries": OP_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": OP_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": OP_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": OP_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": OP_SET_CHOOSELEAF_STABLE,
}
SET_STEP_NAMES = {v: k for k, v in SET_STEPS.items()}

TUNABLE_FIELDS = ("choose_local_tries", "choose_local_fallback_tries",
                  "choose_total_tries", "chooseleaf_descend_once",
                  "chooseleaf_vary_r", "chooseleaf_stable")


class CompileError(ValueError):
    pass


def _strip(line: str) -> str:
    return line.split("#", 1)[0].strip()


def compile_crushmap(text: str) -> CrushMap:
    """text -> CrushMap (ref: CrushCompiler::compile)."""
    m = CrushMap(type_names={})
    name_to_id: dict[str, int] = {}
    class_of_device: dict[int, str] = {}
    rule_lines: list[tuple[str, list[str]]] = []
    lines = text.splitlines()
    i = 0

    def err(msg):
        raise CompileError(f"line {i + 1}: {msg}")

    while i < len(lines):
        line = _strip(lines[i])
        if not line:
            i += 1
            continue
        tok = line.split()
        if tok[0] == "tunable":
            if len(tok) != 3:
                err("tunable <name> <value>")
            if tok[1] in TUNABLE_FIELDS:
                setattr(m.tunables, tok[1], int(tok[2]))
            # unknown tunables (straw_calc_version etc.) are accepted
        elif tok[0] == "device":
            did = int(tok[1])
            if not tok[2].startswith("osd."):
                err(f"device name {tok[2]!r} must be osd.<id>")
            m.max_devices = max(m.max_devices, did + 1)
            name_to_id[tok[2]] = did
            if len(tok) >= 5 and tok[3] == "class":
                class_of_device[did] = tok[4]
        elif tok[0] == "type":
            m.type_names[int(tok[1])] = tok[2]
        elif tok[0] == "rule":
            name = tok[1] if len(tok) > 1 and tok[1] != "{" else ""
            body = []
            i += 1
            while i < len(lines) and _strip(lines[i]) != "}":
                if _strip(lines[i]):
                    body.append(_strip(lines[i]))
                i += 1
            rule_lines.append((name, body))
        elif tok[0] == "choose_args":
            # "choose_args <id> {" ... blocks of
            # "{ bucket_id <bid> / weight_set [ [w ...] ... ] / ids [..] }"
            # (ref: CrushCompiler::parse_choose_args / decompile format)
            if len(tok) < 2:
                err("choose_args <id> {")
            ca_id = int(tok[1])
            from ceph_tpu_torch.crush.types import ChooseArg
            args: dict[int, ChooseArg] = {}
            i += 1
            depth = 1
            cur: ChooseArg | None = None
            cur_bid: int | None = None
            while i < len(lines) and depth > 0:
                cl = _strip(lines[i])
                i += 1
                if not cl:
                    continue
                ct = cl.replace("[", " [ ").replace("]", " ] ").split()
                if ct[0] == "{":
                    depth += 1
                    cur = ChooseArg()
                    cur_bid = None
                    continue
                if ct[0] == "}":
                    depth -= 1
                    if depth == 1 and cur is not None:
                        if cur_bid is None:
                            err("choose_args block missing bucket_id")
                        args[cur_bid] = cur
                        cur = None
                    continue
                if cur is None:
                    err(f"choose_args attribute {ct[0]!r} outside a "
                        f"{{ ... }} block")
                if ct[0] == "bucket_id":
                    cur_bid = int(ct[1])
                elif ct[0] == "weight_set":
                    # flatten possibly-multiline "[ [ w w ] [ w w ] ]"
                    toks = ct[1:]
                    while i < len(lines) and toks.count("[") > \
                            toks.count("]"):
                        toks += _strip(lines[i]).replace(
                            "[", " [ ").replace("]", " ] ").split()
                        i += 1
                    vec: list[int] = []
                    depth2 = 0
                    for t in toks:
                        if t == "[":
                            depth2 += 1
                            if depth2 == 2:
                                vec = []
                        elif t == "]":
                            if depth2 == 2:
                                cur.weight_set.append(vec)
                            depth2 -= 1
                        else:
                            vec.append(int(round(float(t) * WEIGHT_ONE)))
                elif ct[0] == "ids":
                    cur.ids = [int(t) for t in ct[1:]
                               if t not in ("[", "]")]
                else:
                    err(f"unknown choose_args attribute {ct[0]!r}")
            m.choose_args[ca_id] = args
            i -= 1  # outer loop re-increments
        elif len(tok) >= 3 and tok[-1] == "{":
            # bucket: "<typename> <name> {"
            tname, bname = tok[0], tok[1]
            type_id = next((t for t, n in m.type_names.items()
                            if n == tname), None)
            if type_id is None:
                err(f"unknown bucket type {tname!r}")
            bucket = Bucket(id=0, type=type_id)
            items: list[tuple[str, int | None]] = []
            i += 1
            while i < len(lines) and _strip(lines[i]) != "}":
                bl = _strip(lines[i])
                i += 1
                if not bl:
                    continue
                bt = bl.split()
                if bt[0] == "id":
                    if len(bt) >= 4 and bt[2] == "class":
                        pass  # shadow ids regenerate at compile
                    else:
                        bucket.id = int(bt[1])
                elif bt[0] == "alg":
                    if bt[1] not in ALG_NAMES:
                        err(f"unknown alg {bt[1]!r}")
                    bucket.alg = ALG_NAMES[bt[1]]
                elif bt[0] == "hash":
                    bucket.hash = int(bt[1])
                elif bt[0] == "item":
                    w = WEIGHT_ONE
                    if "weight" in bt:
                        w = int(round(
                            float(bt[bt.index("weight") + 1]) * WEIGHT_ONE))
                    items.append((bt[1], w))
                elif bt[0] == "weight":
                    pass  # informational subtree weight comment
                else:
                    err(f"unknown bucket attribute {bt[0]!r}")
            if bucket.id == 0:
                bucket.id = min(m.buckets, default=0) - 1
            for iname, w in items:
                if iname not in name_to_id:
                    err(f"unknown item {iname!r} in bucket {bname!r}")
                bucket.items.append(name_to_id[iname])
                bucket.weights.append(w)
            m.buckets[bucket.id] = bucket
            m.bucket_names[bucket.id] = bname
            name_to_id[bname] = bucket.id
        else:
            err(f"unparsed line {line!r}")
        i += 1

    m.device_classes = class_of_device
    # rules second pass (buckets all known; class takes build shadows)
    for name, body in rule_lines:
        rule = Rule(id=len(m.rules), name=name)
        for bl in body:
            bt = bl.split()
            if bt[0] == "id":
                rule.id = int(bt[1])
            elif bt[0] == "type":
                rule.type = RULE_TYPE_IDS.get(bt[1], 1)
            elif bt[0] in ("min_size", "max_size"):
                pass  # legacy mask fields, ignored (removed upstream)
            elif bt[0] == "step":
                rule.steps.append(
                    _compile_step(m, name_to_id, bt[1:]))
            else:
                raise CompileError(f"rule {name!r}: bad line {bl!r}")
        m.rules[rule.id] = rule
    return m


def _compile_step(m: CrushMap, name_to_id: dict[str, int],
                  tok: list[str]) -> RuleStep:
    op = tok[0]
    if op == "take":
        if tok[1] not in name_to_id:
            raise CompileError(f"take of unknown bucket {tok[1]!r}")
        target = name_to_id[tok[1]]
        if len(tok) >= 4 and tok[2] == "class":
            target = class_shadow(m, target, tok[3])
        return RuleStep(OP_TAKE, target)
    if op == "emit":
        return RuleStep(OP_EMIT)
    if op in SET_STEPS:
        return RuleStep(SET_STEPS[op], int(tok[1]))
    if op in ("choose", "chooseleaf"):
        mode = tok[1]
        num = int(tok[2])
        if len(tok) < 5 or tok[3] != "type":
            raise CompileError(f"step {' '.join(tok)!r}: expected "
                               "'type <name>'")
        type_id = next((t for t, n in m.type_names.items()
                        if n == tok[4]), None)
        if type_id is None:
            raise CompileError(f"unknown type {tok[4]!r}")
        ops = {("choose", "firstn"): OP_CHOOSE_FIRSTN,
               ("choose", "indep"): OP_CHOOSE_INDEP,
               ("chooseleaf", "firstn"): OP_CHOOSELEAF_FIRSTN,
               ("chooseleaf", "indep"): OP_CHOOSELEAF_INDEP}
        return RuleStep(ops[(op, mode)], num, type_id)
    raise CompileError(f"unknown step {op!r}")


def class_shadow(m: CrushMap, bucket_id: int, klass: str) -> int:
    """Build (or reuse) the per-class filtered copy of a subtree
    (ref: CrushWrapper::device_class_clone). Devices not of `klass` are
    dropped; empty subtrees pruned; weights re-summed."""
    name = f"{m.bucket_names.get(bucket_id, bucket_id)}~{klass}"
    for bid, bname in m.bucket_names.items():
        if bname == name:
            return bid
    src = m.buckets[bucket_id]
    items: list[int] = []
    weights: list[int] = []
    for item, w in zip(src.items, src.weights):
        if item >= 0:
            if m.device_classes.get(item) == klass:
                items.append(item)
                weights.append(w)
        else:
            sub = class_shadow(m, item, klass)
            if m.buckets[sub].items:
                items.append(sub)
                weights.append(m.buckets[sub].weight)
    shadow = Bucket(id=min(m.buckets, default=0) - 1, type=src.type,
                    alg=src.alg, hash=src.hash, items=items,
                    weights=weights)
    m.buckets[shadow.id] = shadow
    m.bucket_names[shadow.id] = name
    return shadow.id


def decompile_crushmap(m: CrushMap) -> str:
    """CrushMap -> text (ref: CrushCompiler::decompile)."""
    out = ["# begin crush map"]
    for f in TUNABLE_FIELDS:
        out.append(f"tunable {f} {getattr(m.tunables, f)}")
    out.append("")
    out.append("# devices")
    for d in range(m.max_devices):
        klass = m.device_classes.get(d)
        suffix = f" class {klass}" if klass else ""
        out.append(f"device {d} osd.{d}{suffix}")
    out.append("")
    out.append("# types")
    for tid in sorted(m.type_names):
        out.append(f"type {tid} {m.type_names[tid]}")
    out.append("")
    out.append("# buckets")

    def item_name(i: int) -> str:
        if i >= 0:
            return f"osd.{i}"
        return m.bucket_names.get(i, f"bucket{-i}")

    # children before parents (ref: decompile emits leaves-up)
    emitted: set[int] = set()

    def emit_bucket(bid: int) -> None:
        if bid in emitted:
            return
        b = m.buckets[bid]
        for c in b.items:
            if c < 0:
                emit_bucket(c)
        emitted.add(bid)
        name = m.bucket_names.get(bid, f"bucket{-bid}")
        if "~" in name:
            return  # class shadows are regenerated, not serialized
        out.append(f"{m.type_names.get(b.type, b.type)} {name} {{")
        out.append(f"\tid {b.id}")
        out.append(f"\t# weight {b.weight / WEIGHT_ONE:.5f}")
        out.append(f"\talg {ALG_IDS[b.alg]}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for it, w in zip(b.items, b.weights):
            out.append(f"\titem {item_name(it)} weight "
                       f"{w / WEIGHT_ONE:.5f}")
        out.append("}")
    for bid in sorted(m.buckets, reverse=True):
        emit_bucket(bid)
    out.append("")
    out.append("# rules")
    for rid in sorted(m.rules):
        r = m.rules[rid]
        out.append(f"rule {r.name or f'rule{rid}'} {{")
        out.append(f"\tid {rid}")
        out.append(f"\ttype {RULE_TYPE_NAMES.get(r.type, 'replicated')}")
        for s in r.steps:
            if s.op == OP_TAKE:
                name = item_name(s.arg1)
                if "~" in name:
                    base, klass = name.split("~", 1)
                    out.append(f"\tstep take {base} class {klass}")
                else:
                    out.append(f"\tstep take {name}")
            elif s.op == OP_EMIT:
                out.append("\tstep emit")
            elif s.op in SET_STEP_NAMES:
                out.append(f"\tstep {SET_STEP_NAMES[s.op]} {s.arg1}")
            else:
                verb = {OP_CHOOSE_FIRSTN: "choose firstn",
                        OP_CHOOSE_INDEP: "choose indep",
                        OP_CHOOSELEAF_FIRSTN: "chooseleaf firstn",
                        OP_CHOOSELEAF_INDEP: "chooseleaf indep"}[s.op]
                out.append(f"\tstep {verb} {s.arg1} type "
                           f"{m.type_names.get(s.arg2, s.arg2)}")
        out.append("}")
    if m.choose_args:
        out.append("")
        out.append("# choose_args")
        for ca_id in sorted(m.choose_args):
            out.append(f"choose_args {ca_id} {{")
            for bid in sorted(m.choose_args[ca_id], reverse=True):
                arg = m.choose_args[ca_id][bid]
                out.append("  {")
                out.append(f"    bucket_id {bid}")
                if arg.weight_set:
                    out.append("    weight_set [")
                    for ws in arg.weight_set:
                        row = " ".join(f"{w / WEIGHT_ONE:.5f}" for w in ws)
                        out.append(f"      [ {row} ]")
                    out.append("    ]")
                if arg.ids:
                    row = " ".join(str(i) for i in arg.ids)
                    out.append(f"    ids [ {row} ]")
                out.append("  }")
            out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"
