"""AuthMonitor: the paxos-backed keyring — key lifecycle + fencing.

ref: src/mon/AuthMonitor.{h,cc} (`ceph auth get-or-create/ls/rm/caps`)
— entity secrets live in the paxos store instead of static conf, so
key provisioning, rotation and revocation are committed cluster
decisions:

- ``auth get-or-create`` mints (or returns) an entity's secret and
  caps; the secret lands in every mon's live ``Keyring`` on refresh,
  so the messenger's cephx-lite handshake consumes it immediately;
- ``auth rotate`` replaces the secret; ``Keyring.set_key`` notifies
  its messenger observers, which re-key the entity's LIVE sessions via
  the in-band REKEY frame (the cephx ticket-renewal analog — see
  msg/auth.py). Honest limitation, documented in mon/README.md: an
  established session's base key derives from the handshake, so
  rotation re-keys frames and gates NEW handshakes on the new secret,
  but does not retroactively re-authenticate live sessions;
- ``auth rm`` revokes: the key is removed and tombstoned,
  ``Keyring.revoke`` FENCES the entity — its open sessions are
  dropped by every observing messenger and, with no key to look up,
  every future handshake fails. A removed key can therefore neither
  authenticate nor keep riding an old session.

Key distribution: mons share state through paxos refresh. Daemons and
clients may subscribe ``keyring``; commits publish MAuthUpdate with a
per-subscriber-filtered table (daemons get everything, a client only
its own entry). In the in-process vstart cluster every daemon shares
one Keyring object, so a commit fences cluster-wide instantly; the
subscription keeps standalone (copy_for) keyrings converging too.

Cap ENFORCEMENT, first slice (round 7, ROADMAP elastic follow-up a):
mon command handling checks the CALLER's stored caps before routing
(Monitor._handle_command_msg -> :meth:`check_command_caps`). The
policy gates MUTATIONS: a mutating mon command (anything not in the
read-only table — `mon add/rm`, pool edits, fs/mds changes...)
requires a ``mon`` cap granting ``w`` (or ``*``); auth KEY operations
(get-or-create/rm/rotate/caps) require ``auth: *`` and auth reads
``auth: r``. Entities with NO caps configured stay unrestricted (the
boot keyring imports with empty caps — legacy admin behavior, and
per-op OSD/MDS enforcement is still out of scope); read-only commands
are never blocked. In-process service calls (tests, daemons driving
handle_command directly) bypass the check — it guards the WIRE
surface.

The port's copy of ``ceph_tpu/mon/auth_monitor.py``.
"""

from __future__ import annotations

import asyncio
import json
import time

from ceph_tpu_torch.mon.service import PaxosService
from ceph_tpu_torch.msg import Keyring
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")

PFX = "auth"

# commands any authenticated entity may issue (observability — the
# enforcement slice gates mutations; see the module docstring)
READONLY_COMMANDS = frozenset((
    "status", "health", "quorum_status", "mon dump", "log last",
    "config get", "config dump", "osd dump", "osd tree", "osd df",
    "osd pool ls", "osd getmap", "osd getcrushmap", "osd map",
    "osd blocklist ls", "pg dump", "pg map", "fs status", "fs dump",
    "fs subtree ls", "mds dump",
    "trace dump", "trace ls", "trace show", "osd slow ls",
    # telemetry plane (round 12): digest-backed observability reads
    "osd perf", "progress ls", "progress json", "mgr dump", "mgr stat",
    # device-runtime plane (round 14): kernel-path health + crash
    # evidence reads (crash archive MUTATES the ack bit and stays
    # behind `mon w`)
    "device-runtime status", "crash ls", "crash info",
    # tuner plane (round 17): audit/ownership reads (`tune record`
    # MUTATES the audit ring and stays behind `mon w`)
    "tune status", "tune log",
    # snap plane (round 20): the registry listing is a read (`fs snap
    # create`/`fs snap rm` MUTATE the registry + removed_snaps and
    # stay behind `mon w`)
    "fs snap ls",
))
AUTH_READS = frozenset(("auth get", "auth ls"))


# the spec grammar lives with the Keyring now (round 11): the OSD's
# per-op admission check shares it — re-exported here for callers
from ceph_tpu_torch.msg.auth import cap_allows  # noqa: E402,F401


class AuthMonitor(PaxosService):
    prefix = PFX

    def __init__(self, mon) -> None:
        super().__init__(mon)
        # entity -> (secret, caps dict); rebuilt from the store
        self.keys: dict[str, tuple[bytes, dict]] = {}
        # entity -> revocation wall-stamp (tombstones; feed the
        # AUTH_KEY_REVOKED health visibility window)
        self.revoked: dict[str, float] = {}
        self.version = 0
        self._lock = asyncio.Lock()
        self.refresh()

    # -- state -------------------------------------------------------------
    def num_keys(self) -> int:
        return len(self.keys)

    def refresh(self) -> None:
        ver = self.store.get_u64(PFX, "version")
        if ver <= self.version:
            return
        keys: dict[str, tuple[bytes, dict]] = {}
        revoked: dict[str, float] = {}
        for k, v in self.store.iterate(PFX):
            if k.startswith("key/"):
                ent = json.loads(v)
                keys[k[4:]] = (bytes.fromhex(ent["key"]),
                               ent.get("caps", {}))
            elif k.startswith("revoked/"):
                revoked[k[8:]] = float(v.decode() or 0)
        self.keys = keys
        self.revoked = revoked
        self.version = ver
        self._sync_keyring()

    def _sync_keyring(self) -> None:
        """Drive the mon's LIVE Keyring from the committed table: new/
        rotated secrets install (observers re-key), revoked entities
        fence (observers drop sessions). Idempotent — set_key dedupes
        same-value installs and revoke() dedupes replays."""
        kr: Keyring | None = self.mon.keyring
        if kr is None:
            return
        for name, (secret, caps) in self.keys.items():
            kr.set_key(name, secret)
            # caps ride along so the OSD's per-op admission check sees
            # the committed table (vstart shares ONE keyring object;
            # standalone daemons converge via the MAuthUpdate caps
            # field on their `keyring` subscription)
            kr.set_caps(name, caps)
        for name in self.revoked:
            if name not in self.keys:
                kr.revoke(name)

    async def on_active(self) -> None:
        if self.store.get_u64(PFX, "version") == 0 and \
                self.mon.keyring is not None and \
                self.mon.keyring.keys:
            await self._bootstrap_import()

    async def _bootstrap_import(self) -> None:
        """First activation: import the boot keyring into the paxos
        store (ref: the initial keyring a fresh mon store is seeded
        with) — from here on the committed table is authoritative."""
        t = self.store.transaction()
        for name, secret in sorted(self.mon.keyring.keys.items()):
            t.set(PFX, f"key/{name}", json.dumps(
                {"key": secret.hex(), "caps": {}}).encode())
        self.store.put_u64(t, PFX, "version", 1)
        if await self.mon.propose_txn(t):
            log.dout(1, f"auth: imported {len(self.mon.keyring.keys)} "
                        f"boot keys")

    def publishable_for(self, peer_name: str | None) -> dict[str, bytes]:
        """The MAuthUpdate table one subscriber may see: daemons get
        the full table, a client only its own entry. Revoked entities
        ride along with an EMPTY secret so the subscriber fences."""
        peer = peer_name or ""
        is_daemon = peer.split(".", 1)[0] in ("mon", "osd", "mds",
                                              "mgr")
        out: dict[str, bytes] = {}
        for name, (secret, _caps) in self.keys.items():
            if is_daemon or name == peer:
                out[name] = secret
        for name in self.revoked:
            if name not in self.keys and (is_daemon or name == peer):
                out[name] = b""
        return out

    def caps_for(self, peer_name: str | None) -> dict[str, str]:
        """The MAuthUpdate ``caps`` companion table (same filtering as
        publishable_for): entity -> JSON cap dict, feeding the
        subscribers' Keyring.set_caps so per-op OSD enforcement works
        off the committed table. Entities whose caps were CLEARED ride
        along with an empty blob — the subscriber must drop its stale
        table, not keep enforcing it."""
        peer = peer_name or ""
        is_daemon = peer.split(".", 1)[0] in ("mon", "osd", "mds",
                                              "mgr")
        return {name: (json.dumps(caps) if caps else "")
                for name, (_secret, caps) in self.keys.items()
                if is_daemon or name == peer}

    # -- cap enforcement (first slice; see module docstring) ---------------
    def check_command_caps(self, entity: str,
                           cmd: dict) -> tuple[int, str]:
        """(0, "") when ``entity`` may issue ``cmd``; (-EACCES, why)
        otherwise. Entities without a configured cap table are
        unrestricted (legacy boot keys); read-only commands always
        pass."""
        prefix = str(cmd.get("prefix", ""))
        have = self.keys.get(entity)
        caps = have[1] if have is not None else {}
        if not caps:
            return 0, ""
        if prefix.startswith("auth"):
            need = ("auth", "r") if prefix in AUTH_READS \
                else ("auth", "*")
        elif prefix in READONLY_COMMANDS:
            return 0, ""
        else:
            need = ("mon", "w")
        svc, lvl = need
        spec = caps.get(svc, "")
        if spec and cap_allows(spec, lvl):
            return 0, ""
        return -13, (f"permission denied: {entity} (caps {caps}) "
                     f"lacks '{svc} {lvl}' required for "
                     f"'{prefix}'")                        # -EACCES

    # -- commits -----------------------------------------------------------
    async def _commit(self, build) -> tuple[bool, object]:
        """``build() -> (mutations, result) | None`` where mutations is
        a list of ("set", entity, secret, caps) | ("rm", entity)."""
        async with self._lock:
            out = build()
            if out is None:
                return False, None
            muts, result = out
            t = self.store.transaction()
            for m in muts:
                if m[0] == "set":
                    _, name, secret, caps = m
                    t.set(PFX, f"key/{name}", json.dumps(
                        {"key": secret.hex(), "caps": caps}).encode())
                    t.rmkey(PFX, f"revoked/{name}")
                else:
                    _, name = m
                    t.rmkey(PFX, f"key/{name}")
                    t.set(PFX, f"revoked/{name}",
                          str(time.time()).encode())
            self.store.put_u64(t, PFX, "version", self.version + 1)
            ok = await self.mon.propose_txn(t)
            return ok, result

    # -- commands ----------------------------------------------------------
    async def handle_command(self, cmd, inbl=b""):
        prefix = cmd.get("prefix", "")
        handler = {
            "auth get-or-create": self._cmd_get_or_create,
            "auth get": self._cmd_get,
            "auth ls": self._cmd_ls,
            "auth rm": self._cmd_rm,
            "auth del": self._cmd_rm,
            "auth caps": self._cmd_caps,
            "auth rotate": self._cmd_rotate,
        }.get(prefix)
        if handler is None:
            return -22, f"unknown command {prefix!r}", b""
        return await handler(cmd)

    @staticmethod
    def _caps_of(cmd) -> dict:
        caps = cmd.get("caps", {})
        if isinstance(caps, str):
            try:
                caps = json.loads(caps)
            except json.JSONDecodeError:
                caps = {"_": caps}
        return caps if isinstance(caps, dict) else {}

    def _entity(self, cmd) -> str:
        return str(cmd.get("entity", cmd.get("name", "")))

    async def _cmd_get_or_create(self, cmd):
        entity = self._entity(cmd)
        if not entity:
            return -22, "usage: auth get-or-create <entity>", b""
        have = self.keys.get(entity)
        if have is not None:
            return 0, "", json.dumps(
                {"entity": entity, "key": have[0].hex(),
                 "caps": have[1]}).encode()
        caps = self._caps_of(cmd)
        secret = Keyring.generate_key()

        def build():
            if entity in self.keys:
                return None        # raced another create: re-read below
            return [("set", entity, secret, caps)], None
        ok, _ = await self._commit(build)
        have = self.keys.get(entity)
        if have is None:
            return -11, "proposal failed", b""
        self.mon.clog("INF", f"auth: created key for {entity}")
        return 0, "", json.dumps(
            {"entity": entity, "key": have[0].hex(),
             "caps": have[1]}).encode()

    async def _cmd_get(self, cmd):
        entity = self._entity(cmd)
        have = self.keys.get(entity)
        if have is None:
            return -2, f"no key for {entity!r}", b""       # -ENOENT
        return 0, "", json.dumps(
            {"entity": entity, "key": have[0].hex(),
             "caps": have[1]}).encode()

    async def _cmd_ls(self, cmd):
        out = {
            "version": self.version,
            "keys": {name: {"caps": caps}
                     for name, (_s, caps) in sorted(self.keys.items())},
            "revoked": sorted(n for n in self.revoked
                              if n not in self.keys),
        }
        return 0, "", json.dumps(out).encode()

    async def _cmd_rm(self, cmd):
        entity = self._entity(cmd)
        if entity not in self.keys:
            return -2, f"no key for {entity!r}", b""

        def build():
            if entity not in self.keys:
                return None
            return [("rm", entity)], None
        ok, _ = await self._commit(build)
        if not ok and entity in self.keys:
            return -11, "proposal failed", b""
        self.mon.clog("WRN", f"auth: revoked key of {entity} "
                             f"(sessions fenced)")
        return 0, f"removed {entity} (key revoked, sessions " \
                  f"fenced)", b""

    async def _cmd_caps(self, cmd):
        entity = self._entity(cmd)
        have = self.keys.get(entity)
        if have is None:
            return -2, f"no key for {entity!r}", b""
        caps = self._caps_of(cmd)

        def build():
            cur = self.keys.get(entity)
            if cur is None:
                return None
            return [("set", entity, cur[0], caps)], None
        ok, _ = await self._commit(build)
        if not ok:
            return -11, "proposal failed", b""
        return 0, f"updated caps for {entity}", b""

    async def _cmd_rotate(self, cmd):
        """`auth rotate <entity>`: mint a NEW secret for the entity.
        Live sessions are re-keyed in-band (Keyring observers); new
        handshakes require the new secret, so a stale keyring file
        stops authenticating at the next connect."""
        entity = self._entity(cmd)
        have = self.keys.get(entity)
        if have is None:
            return -2, f"no key for {entity!r}", b""
        secret = Keyring.generate_key()

        def build():
            cur = self.keys.get(entity)
            if cur is None:
                return None
            return [("set", entity, secret, cur[1])], None
        ok, _ = await self._commit(build)
        new = self.keys.get(entity)
        if not ok or new is None or new[0] == have[0]:
            return -11, "proposal failed", b""
        self.mon.clog("INF", f"auth: rotated key of {entity}")
        return 0, f"rotated key of {entity}", json.dumps(
            {"entity": entity, "key": new[0].hex()}).encode()
