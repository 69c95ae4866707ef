"""Unified messenger-level fault injection: named, composable fault
sets per peer-pair.

ref: the `ms inject socket failures` / `ms inject delay` config knobs
plus qa/tasks/ceph_manager.py's blackhole helpers — generalized into
one runtime-installable layer. A ``FaultInjector`` hangs off any
number of ``Messenger``s (``msgr.faults = injector``); the messenger
consults it at three choke points:

- **connect** (``Messenger._client_handshake``): a partitioned or
  fully-dropped pair refuses new TCP sessions (the SYN never lands);
- **frame send** (``Connection._send_frame``): partitions abort the
  connection like an injected socket failure (both ends observe
  resets and retry), one-way drops are silent blackholes (the sender
  believes the frame left);
- **message send** (``Connection.send_message``): delay, duplication
  and reorder act *before* the sequence number is assigned, so the
  receiver's in-order dedup machinery sees a consistent stream and
  the upper layers (objecter resend, PG reqid dedup, lossless
  replay) are what absorbs the chaos — exactly the property the
  thrash suites exist to prove.

Fault semantics per kind:

- ``partition(a, b)`` — bidirectional: every frame between entities
  matching patterns ``a`` and ``b`` (either direction) aborts its
  connection; new connections are refused. Heals when cleared.
- ``drop(src, dst, prob)`` — one-way blackhole with probability
  ``prob``: the frame is swallowed, the sender is not told. On
  lossless sessions swallowed frames sit in the replay queue until
  the next reconnect; ``prob=1.0`` also refuses src->dst connects.
- ``delay(src, dst, min_s, max_s)`` — each message sleeps a fixed
  (min==max) or uniform-random time before the send lock, so later
  messages may overtake it (a mild reorder in itself).
- ``duplicate(src, dst, prob)`` — the message is sent twice with
  distinct seqs; end-to-end dedup (PG reqid table, waiter pop) must
  make it exactly-once.
- ``reorder(src, dst, prob, hold_s)`` — the message is held until
  the next message to the same peer overtakes it (or ``hold_s``
  elapses, so a lone message is never lost).

Device fault kinds reuse the same rule table but fire at a
different choke point: ``utils.devmon.jit_call``, the one entry every
device call (CRUSH map/sweep kernels, EC encode/decode) already passes
through. For these kinds ``a`` is an fnmatch pattern
over the call's ``fn_name`` (``crush_map_pgs``, ``crush_sweep``,
``ec_encode``, ``ec_encode_crc``, ``ec_decode``,
``ec_stream_encode``) and ``b`` is a pattern over ``str(key)`` — the
jit cache key, whose kernel-path form starts with ``('kern', ...)``,
so ``b="*'kern'*"`` targets only kernel-path launches and leaves the
rule VM alone:

- ``jit_fail(fn, key, prob, count)`` — the call raises RuntimeError
  before dispatch (a failed compile/launch as the caller sees it).
- ``jit_stall(fn, min_s, max_s, key, prob, count)`` — the call sleeps
  before dispatch (a recompile storm / contended-device stall).
- ``bad_result(fn, key, prob, count)`` — the call completes but its
  returned array comes back corrupted (one flipped element — the
  silent-wrong-answer case bit-exact probes must catch).

``count`` bounds total firings per rule (0 = unlimited); a spent rule
stops firing but stays installed until its set is cleared. Device
kinds never match the messenger hooks, and messenger kinds never
match ``jit_call``.

Rules compose: every matching rule applies. Sets are named and can be
installed/cleared at runtime on a served cluster (the vstart --serve
admin socket exposes ``fault install/clear/ls``); the Thrasher
drives the same API from a seeded schedule. Determinism: a seeded injector draws all probabilities from
its own ``random.Random``, so a fixed seed and a fixed message
sequence reproduce the same fault decisions.

The port's copy of ``ceph_tpu/sim/faults.py``; the port's Thrasher
(``sim/thrasher.py``) drives it.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from fnmatch import fnmatch

# kinds consulted by utils.devmon.jit_call instead of the messenger
DEVICE_KINDS = ("jit_fail", "jit_stall", "bad_result")


@dataclass(frozen=True)
class FaultRule:
    """One fault between entity-name patterns (fnmatch syntax, e.g.
    ``osd.1``, ``osd.*``, ``client.*``). ``a``/``b`` are src/dst for
    one-way kinds and unordered endpoints for ``partition``. For
    device kinds ``a`` matches the jit ``fn_name`` and ``b`` matches
    ``str(key)`` (the jit cache key)."""

    kind: str       # partition|drop|delay|duplicate|reorder|DEVICE_KINDS
    a: str
    b: str
    prob: float = 1.0
    min_s: float = 0.0
    max_s: float = 0.0
    hold_s: float = 0.05
    count: int = 0             # max firings, 0 = unlimited

    def matches(self, src: str, dst: str) -> bool:
        if self.kind in DEVICE_KINDS:
            return False
        if self.kind == "partition":
            return (fnmatch(src, self.a) and fnmatch(dst, self.b)) or \
                   (fnmatch(src, self.b) and fnmatch(dst, self.a))
        return fnmatch(src, self.a) and fnmatch(dst, self.b)

    def matches_device(self, fn_name: str, key_s: str) -> bool:
        return self.kind in DEVICE_KINDS and \
            fnmatch(fn_name, self.a) and fnmatch(key_s, self.b)

    def describe(self) -> dict:
        d = {"kind": self.kind, "a": self.a, "b": self.b}
        if self.kind in ("drop", "duplicate", "reorder") or \
                self.kind in DEVICE_KINDS:
            d["prob"] = self.prob
        if self.kind in ("delay", "jit_stall"):
            d["min_s"], d["max_s"] = self.min_s, self.max_s
        if self.kind == "reorder":
            d["hold_s"] = self.hold_s
        if self.kind in DEVICE_KINDS and self.count:
            d["count"] = self.count
        return d


def partition(a: str, b: str) -> FaultRule:
    """Bidirectional partition between entities matching a and b."""
    return FaultRule("partition", a, b)


def drop(src: str, dst: str, prob: float = 1.0) -> FaultRule:
    """One-way silent frame blackhole src -> dst."""
    return FaultRule("drop", src, dst, prob=prob)


def delay(src: str, dst: str, min_s: float,
          max_s: float | None = None) -> FaultRule:
    """Fixed (max_s=None) or uniform-random per-message delay."""
    return FaultRule("delay", src, dst, min_s=min_s,
                     max_s=min_s if max_s is None else max_s)


def duplicate(src: str, dst: str, prob: float = 1.0) -> FaultRule:
    """Send matching messages twice (distinct seqs)."""
    return FaultRule("duplicate", src, dst, prob=prob)


def reorder(src: str, dst: str, prob: float = 1.0,
            hold_s: float = 0.05) -> FaultRule:
    """Hold a message until the next one to the same peer overtakes
    it (bounded by hold_s so a lone message is never lost)."""
    return FaultRule("reorder", src, dst, prob=prob, hold_s=hold_s)


def jit_fail(fn: str, key: str = "*", prob: float = 1.0,
             count: int = 0) -> FaultRule:
    """Device calls matching (fn_name, key) patterns raise before
    dispatch — a failed compile/launch as the caller observes it."""
    return FaultRule("jit_fail", fn, key, prob=prob, count=count)


def jit_stall(fn: str, min_s: float, max_s: float | None = None,
              key: str = "*", prob: float = 1.0,
              count: int = 0) -> FaultRule:
    """Device calls matching the patterns sleep a fixed (max_s=None)
    or uniform-random time before dispatch."""
    return FaultRule("jit_stall", fn, key, prob=prob, min_s=min_s,
                     max_s=min_s if max_s is None else max_s,
                     count=count)


def bad_result(fn: str, key: str = "*", prob: float = 1.0,
               count: int = 0) -> FaultRule:
    """Device calls matching the patterns complete, but the returned
    array has one element flipped — the silent-corruption case."""
    return FaultRule("bad_result", fn, key, prob=prob, count=count)


_BUILDERS = {"partition": partition, "drop": drop, "delay": delay,
             "duplicate": duplicate, "reorder": reorder,
             "jit_fail": jit_fail, "jit_stall": jit_stall,
             "bad_result": bad_result}


def rule_from_dict(d: dict) -> FaultRule:
    """Build a rule from its ``describe()`` form (the admin-socket /
    CLI install path)."""
    kind = d.get("kind")
    if kind not in _BUILDERS:
        raise ValueError(f"unknown fault kind {kind!r}")
    kw = {k: d[k] for k in ("prob", "min_s", "max_s", "hold_s", "count")
          if k in d}
    return FaultRule(kind, d["a"], d["b"], **kw)


@dataclass
class _FaultSet:
    name: str
    rules: list[FaultRule] = field(default_factory=list)


class FaultInjector:
    """The runtime fault table. Install on messengers via
    ``msgr.faults = injector`` (the Cluster helper does every daemon);
    install/clear named sets at any time — messengers observe the new
    table on their next send."""

    def __init__(self, seed: int | None = None):
        self._rng = random.Random(seed)
        self._sets: dict[str, _FaultSet] = {}
        # (src, dst) -> event used by reorder: a held message waits on
        # it; the next message through the pair sets it
        self._holds: dict[tuple[str, str], asyncio.Event] = {}
        # per-rule firing counts for count-bounded rules
        self._spent: dict[int, int] = {}
        # device-rule fast path: jit_call (a hot chokepoint) only pays
        # for str(key) + rule iteration when a device rule is installed
        self._n_device = 0

    # -- set management ----------------------------------------------------
    def _recount(self) -> None:
        live = set()
        n = 0
        for s in self._sets.values():
            for r in s.rules:
                live.add(id(r))
                if r.kind in DEVICE_KINDS:
                    n += 1
        self._n_device = n
        self._spent = {k: v for k, v in self._spent.items() if k in live}

    def install(self, name: str, rules: list[FaultRule]) -> None:
        """Install (or replace) a named fault set."""
        self._sets[name] = _FaultSet(name, list(rules))
        self._recount()

    def clear(self, name: str) -> bool:
        """Remove one named set (heal those faults)."""
        hit = self._sets.pop(name, None) is not None
        if hit:
            self._recount()
        return hit

    def clear_all(self) -> None:
        self._sets.clear()
        self._recount()
        # release any held reorder messages immediately
        for ev in self._holds.values():
            ev.set()
        self._holds.clear()

    def describe(self) -> dict:
        """Admin-socket / CLI view of the installed table."""
        return {name: [r.describe() for r in s.rules]
                for name, s in sorted(self._sets.items())}

    def _rules(self, src: str, dst: str):
        for s in self._sets.values():
            for r in s.rules:
                if r.matches(src, dst):
                    yield r

    # -- messenger hooks ---------------------------------------------------
    def blocks_connect(self, src: str, dst: str) -> bool:
        """New-session gate (client handshake)."""
        for r in self._rules(src, dst):
            if r.kind == "partition":
                return True
            if r.kind == "drop" and r.prob >= 1.0:
                return True
        return False

    def on_frame(self, src: str, dst: str) -> str:
        """Frame-send verdict: 'ok' | 'drop' (silent blackhole) |
        'cut' (abort the connection, both ends see a reset)."""
        verdict = "ok"
        for r in self._rules(src, dst):
            if r.kind == "partition":
                return "cut"
            if r.kind == "drop" and self._rng.random() < r.prob:
                verdict = "drop"
        return verdict

    async def on_message(self, src: str, dst: str) -> bool:
        """Message-send shaping (delay/reorder), run BEFORE the seq is
        assigned. Returns True when the message should additionally be
        sent a second time (duplication)."""
        dup = False
        total_delay = 0.0
        held = None
        for r in self._rules(src, dst):
            if r.kind == "delay":
                total_delay += (r.min_s if r.max_s <= r.min_s else
                                self._rng.uniform(r.min_s, r.max_s))
            elif r.kind == "duplicate":
                dup = dup or self._rng.random() < r.prob
            elif r.kind == "reorder" and held is None and \
                    self._rng.random() < r.prob:
                held = r.hold_s
        if total_delay > 0:
            await asyncio.sleep(total_delay)
        key = (src, dst)
        if held is not None and key not in self._holds:
            # hold until the NEXT message to this peer passes (or the
            # bound elapses) — the later message overtakes this one
            ev = self._holds[key] = asyncio.Event()
            try:
                await asyncio.wait_for(ev.wait(), timeout=held)
            except asyncio.TimeoutError:
                pass
            finally:
                if self._holds.get(key) is ev:
                    del self._holds[key]
        else:
            ev = self._holds.get(key)
            if ev is not None:
                ev.set()
        return dup

    # -- device hooks (utils.devmon.jit_call) ------------------------------
    def has_device_rules(self) -> bool:
        """Cheap gate jit_call checks before paying for str(key)."""
        return self._n_device > 0

    def _fires(self, r: FaultRule) -> bool:
        """Probability + count gate; a firing consumes budget."""
        if r.count > 0 and self._spent.get(id(r), 0) >= r.count:
            return False
        if r.prob < 1.0 and self._rng.random() >= r.prob:
            return False
        if r.count > 0:
            self._spent[id(r)] = self._spent.get(id(r), 0) + 1
        return True

    def device_verdicts(self, fn_name: str,
                        key_s: str) -> tuple[float, bool, bool]:
        """The jit_call verdict for one device call: (stall seconds,
        raise-before-dispatch, corrupt-the-result). Every matching
        rule applies; stalls add."""
        stall, fail, corrupt = 0.0, False, False
        for s in self._sets.values():
            for r in s.rules:
                if not r.matches_device(fn_name, key_s) or \
                        not self._fires(r):
                    continue
                if r.kind == "jit_stall":
                    stall += (r.min_s if r.max_s <= r.min_s else
                              self._rng.uniform(r.min_s, r.max_s))
                elif r.kind == "jit_fail":
                    fail = True
                elif r.kind == "bad_result":
                    corrupt = True
        return stall, fail, corrupt
