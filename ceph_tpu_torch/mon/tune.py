"""Mon-side state for the mgr TunerModule (round 17).

The tuner is an ACTIVE-MGR module; everything it needs to survive a
mgr failover lives here on the mon instead of in mgr RAM:

- **audit ring** — every committed actuator command carrying a
  ``provenance`` dict (the tuner stamps policy + sensor readings on
  the command it commits) is appended on success, and observe-mode
  would-be actions arrive via ``tune record``. Bounded by
  ``mon_tune_audit_max``; served by ``ceph tune log``.
- **owned table** — which actuator targets the tuner currently holds
  (``affinity:<osd>``, ``profile:<entity>``). A promoted standby's
  tuner reads it back through ``tune status`` and resumes level-based
  control without double-committing an in-flight action; the mon's
  own slow-OSD dampening sweep defers to active ``affinity:*``
  leases (the round-17 single-writer guard).

The table is leader-local (like the slow-OSD verdicts): a mon leader
change loses it, and the tuner's level-based policies rebuild it from
the MAP on the next act/revert. Leases expire after
``mon_tune_affinity_lease_s`` so a dead tuner can never pin the mon
sweep out of the affinity business forever.

The port's copy of ``ceph_tpu/mon/tune.py``.
"""

from __future__ import annotations

import collections
import time


def tuner_lease_filter(to_damp: list[int], to_heal: list[int],
                       owned: dict, now: float,
                       lease_s: float) -> tuple[list[int], list[int],
                                                list[int]]:
    """The single-writer guard's decision, pure: split the mon
    dampening sweep's candidates into (kept_damp, kept_heal,
    deferred) — an OSD whose primary affinity a tuner committed
    within its lease is the TUNER's to dampen and to heal, so the
    sweep must not touch it in either direction (healing a
    tuner-dampened OSD the mon never saw as slow would undo the
    gray-OSD responder every tick)."""
    leased = set()
    for key, ent in owned.items():
        if not key.startswith("affinity:"):
            continue
        if now - float(ent.get("since", 0.0)) > lease_s:
            continue
        try:
            leased.add(int(key.split(":", 1)[1]))
        except ValueError:
            continue
    deferred = sorted((set(to_damp) | set(to_heal)) & leased)
    return ([t for t in to_damp if t not in leased],
            [t for t in to_heal if t not in leased],
            deferred)


class TuneState:
    """The mon's bounded tuner audit log + actuator-ownership table."""

    def __init__(self, config: dict | None = None):
        self.config = config if config is not None else {}
        self.audit: collections.deque = collections.deque(
            maxlen=int(self.config.get("mon_tune_audit_max", 256)))
        # "affinity:<osd>" | "profile:<entity>" -> {policy, mode,
        # since, cmd}
        self.owned: dict[str, dict] = {}
        self.committed = 0
        self.reverted = 0
        self.observed = 0

    # -- ownership keys ----------------------------------------------------
    @staticmethod
    def target_key(cmd: dict) -> str | None:
        """The ownership key an actuator command acquires (or
        releases), None for commands that carry no per-target
        ownership (e.g. ``config set`` — the config db has one
        writer path already)."""
        prefix = cmd.get("prefix", "")
        if prefix == "osd primary-affinity":
            return f"affinity:{int(cmd.get('id', -1))}"
        if prefix == "osd client-profile" and \
                cmd.get("op") in ("set", "rm"):
            return f"profile:{cmd.get('entity', '')}"
        return None

    @staticmethod
    def _releases(cmd: dict) -> bool:
        """True when the command RETURNS its target to the untuned
        state (affinity back to default / profile removed) — the
        revert half of an act/revert pair."""
        prefix = cmd.get("prefix", "")
        if prefix == "osd primary-affinity":
            try:
                return float(cmd.get("weight", 1.0)) >= 1.0
            except (TypeError, ValueError):
                return False
        if prefix == "osd client-profile":
            return cmd.get("op") == "rm"
        return False

    # -- recording ---------------------------------------------------------
    def record_commit(self, cmd: dict, prov: dict) -> dict:
        """A provenance-carrying command succeeded: append the audit
        entry and update ownership. Returns the entry."""
        clean = {k: v for k, v in cmd.items() if k != "provenance"}
        entry = {
            "at": time.time(),
            "policy": str(prov.get("policy", "?")),
            "mode": str(prov.get("mode", "drive")),
            "action": str(prov.get("action", "act")),
            "sensors": prov.get("sensors", {}),
            "cmd": clean,
            "committed": True,
        }
        self.audit.append(entry)
        key = self.target_key(clean)
        if key is not None:
            if self._releases(clean):
                self.owned.pop(key, None)
            else:
                self.owned[key] = {
                    "policy": entry["policy"], "mode": entry["mode"],
                    "since": entry["at"], "cmd": clean}
        if entry["action"] == "revert":
            self.reverted += 1
        else:
            self.committed += 1
        return entry

    def record_operator(self, cmd: dict) -> None:
        """A provenance-LESS (operator) command touched a target the
        tuner owned: the operator wins, ownership is released — the
        tuner's level-based policies observe the new map state and
        stand down instead of fighting a human."""
        key = self.target_key(cmd)
        if key is not None:
            self.owned.pop(key, None)

    def record_observation(self, entry: dict) -> dict:
        """An observe-mode would-be action (``tune record``): logged
        with ``committed: false``, never touches ownership."""
        out = {
            "at": time.time(),
            "policy": str(entry.get("policy", "?")),
            "mode": "observe",
            "action": str(entry.get("action", "act")),
            "sensors": entry.get("sensors", {}),
            "cmd": entry.get("cmd", {}),
            "committed": False,
        }
        self.audit.append(out)
        self.observed += 1
        return out

    # -- reads -------------------------------------------------------------
    def affinity_owned(self, now: float | None = None) -> dict[str,
                                                               dict]:
        """Active (non-expired) affinity leases, key -> entry."""
        now = time.time() if now is None else now
        lease_s = float(self.config.get("mon_tune_affinity_lease_s",
                                        600.0))
        return {k: v for k, v in self.owned.items()
                if k.startswith("affinity:") and
                now - float(v.get("since", 0.0)) <= lease_s}

    def status(self, mode: str) -> dict:
        return {
            "mode": mode,
            "committed": self.committed,
            "reverted": self.reverted,
            "observed": self.observed,
            "audit_entries": len(self.audit),
            "audit_max": self.audit.maxlen,
            "owned": {k: {kk: vv for kk, vv in v.items()
                          if kk != "cmd"}
                      for k, v in sorted(self.owned.items())},
        }

    def log(self, num: int | None = None) -> list[dict]:
        entries = list(self.audit)
        if num is not None and num > 0:
            entries = entries[-num:]
        return entries
