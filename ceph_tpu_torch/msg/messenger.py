"""Async messenger: connections, dispatch, policies — msgr2-lite.

ref: src/msg/async/AsyncMessenger.{h,cc} + ProtocolV2.{h,cc}. Same
architecture mapped onto asyncio instead of epoll threads:

- ``Messenger`` owns a listening socket plus a connection table keyed by
  peer address; ``Dispatcher``s get ms_dispatch/ms_handle_reset
  callbacks (ref: src/msg/Dispatcher.h).
- The wire protocol performs a banner + cephx-lite auth exchange, then
  length-prefixed frames carrying MSG/ACK/KEEPALIVE tags with a crc32
  trailer ('crc' mode) or an HMAC trailer ('secure' mode)
  (ref: ProtocolV2 banner/auth frames, crc vs secure modes).
- ``Policy`` decides lossy vs lossless: lossless client connections
  keep unacked messages and resend them after a reconnect (the
  stateful-session half of ProtocolV2's reconnect/replay); lossy
  connections drop state on failure (ref: Messenger::Policy).
- Fault injection: ``inject_socket_failures=N`` kills roughly one in N
  frame sends/receives (ref: 'ms inject socket failures' config used by
  the qa suites).

The reference's throttles (Policy::throttler_bytes) become a bytes
semaphore gating dispatch of incoming messages.

The port's copy of ``ceph_tpu/msg/messenger.py``, with three changes:
each ``Messenger`` counts the frames and bytes it sends and receives
after the handshake (``Messenger.wire``); a handshake that finishes
after ``shutdown`` began is closed instead of registered (the
reference's registers it, and the session outlives its messenger); and
a peer that closes the connection during the client's handshake raises
``ConnectionError_``, which callers retry, where the reference lets
``IncompleteReadError`` through. The wire format is the reference's, so
the two packages' messengers talk to each other.
"""

from __future__ import annotations

import asyncio
import hmac
import random
import traceback
import zlib
from dataclasses import dataclass

from ceph_tpu_torch.msg.auth import Authenticator, AuthError, Keyring
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("ms")

# the reference messenger's banner: the two packages speak one wire
BANNER = b"ceph_tpu msgr2.1\n"

TAG_MSG = 1
TAG_ACK = 2
TAG_KEEPALIVE = 3
TAG_REKEY = 4   # secure mode: sender announces its next tx key epoch

MODE_CRC = 1
MODE_SECURE = 2


class ConnectionError_(Exception):
    pass


@dataclass(frozen=True)
class EntityAddr:
    """ref: src/msg/msg_types.h entity_addr_t (host:port; the nonce that
    distinguishes daemon restarts is the messenger's session id)."""

    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass
class Policy:
    """ref: Messenger::Policy — lossy connections are dropped on error
    (client->osd); lossless ones resend (osd->osd, mon peers)."""

    lossy: bool = True
    throttler_bytes: int = 0     # 0 = unthrottled

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False)


class Throttle:
    """Byte-budget gate (ref: src/common/Throttle.{h,cc})."""

    def __init__(self, limit: int):
        self.limit = limit
        self._used = 0
        self._cond = asyncio.Condition()

    async def acquire(self, n: int) -> None:
        if not self.limit:
            return
        n = min(n, self.limit)
        async with self._cond:
            while self._used + n > self.limit:
                await self._cond.wait()
            self._used += n

    async def release(self, n: int) -> None:
        if not self.limit:
            return
        n = min(n, self.limit)
        async with self._cond:
            self._used -= n
            self._cond.notify_all()


class _Session:
    """Per-peer-address lossless session state shared by every TCP
    connection to that peer (ref: ProtocolV2 session cookies/out_queue:
    the logical session outlives individual sockets)."""

    def __init__(self) -> None:
        self.out_seq = 0
        self.unacked: list[tuple[int, bytes]] = []


class Connection:
    """One established session (ref: AsyncConnection). Owned by a
    Messenger; users only call send_message / close."""

    def __init__(self, msgr: "Messenger", reader, writer,
                 peer_name: str, peer_addr: EntityAddr | None,
                 auth: Authenticator | None, policy: Policy,
                 peer_session: int = 0):
        self.msgr = msgr
        self.reader = reader
        self.writer = writer
        self.peer_name = peer_name
        self.peer_addr = peer_addr        # set for outgoing connections
        self.peer_session = peer_session  # peer's messenger instance nonce
        self.auth = auth
        self.policy = policy
        self.out_seq = 0
        self.in_seq = 0
        self.unacked: list[tuple[int, bytes]] = []   # lossless replay queue
        # outgoing lossless conns share per-peer-address session state
        # (seq counter + replay queue) across reconnects
        self.session: "_Session | None" = None
        self.closed = False
        self._send_lock = asyncio.Lock()
        self._reader_task: asyncio.Task | None = None
        # secure mode: AEAD key epochs, one per direction. The client
        # side of the socket encrypts with direction byte 0, the server
        # side with 1 (the epoch key is shared, the nonce is not).
        self.is_client = peer_addr is not None
        self._tx_epoch = 0
        self._rx_epoch = 0
        self._tx_frames = 0

    def _secure(self) -> bool:
        return self.msgr.mode == MODE_SECURE and self.auth is not None

    # -- framing -----------------------------------------------------------
    def _trailer(self, seq: int, body: bytes) -> bytes:
        return zlib.crc32(body).to_bytes(4, "little")

    async def _send_frame(self, tag: int, seq: int, body: bytes) -> None:
        inj = self.msgr.faults
        if inj is not None:
            act = inj.on_frame(self.msgr.name, self.peer_name)
            if act == "drop":          # one-way blackhole: swallow
                return
            if act == "cut":           # partition: like a socket reset
                self._abort()
                raise ConnectionError_("injected partition (send)")
        if self.msgr._inject_failure():
            self._abort()
            raise ConnectionError_("injected socket failure (send)")
        head = tag.to_bytes(1, "little") + seq.to_bytes(8, "little")
        if self._secure():
            # AEAD: header authenticated as AAD, body encrypted; no
            # separate trailer (the GCM tag rides in the ciphertext)
            ct = self.auth.seal(0 if self.is_client else 1,
                                self._tx_epoch, tag, seq, head, body)
            wire = head + ct
            trailer = b""
        else:
            wire = head + body
            trailer = self._trailer(seq, wire)
        try:
            self.writer.write(len(wire).to_bytes(4, "little") + wire +
                              trailer)
            await self.writer.drain()
        except (ConnectionError, OSError) as e:
            self._abort()
            raise ConnectionError_(str(e)) from e
        self.msgr.wire["tx_frames"] += 1
        self.msgr.wire["tx_bytes"] += 4 + len(wire) + len(trailer)

    async def _recv_frame(self) -> tuple[int, int, bytes]:
        try:
            ln = int.from_bytes(await self.reader.readexactly(4), "little")
            if ln < 9 or ln > self.msgr.max_frame:
                raise ConnectionError_(f"bad frame length {ln}")
            frame = await self.reader.readexactly(ln)
            trailer = b"" if self._secure() \
                else await self.reader.readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            raise ConnectionError_(str(e)) from e
        self.msgr.wire["rx_frames"] += 1
        self.msgr.wire["rx_bytes"] += 4 + ln + len(trailer)
        if self.msgr._inject_failure():
            self._abort()
            raise ConnectionError_("injected socket failure (recv)")
        tag = frame[0]
        seq = int.from_bytes(frame[1:9], "little")
        if self._secure():
            from ceph_tpu_torch.msg.auth import AuthError as _AE
            try:
                body = self.auth.open(0 if not self.is_client else 1,
                                      self._rx_epoch, tag, seq,
                                      frame[:9], frame[9:])
            except _AE as e:
                raise ConnectionError_(str(e)) from e
            return tag, seq, body
        if not hmac.compare_digest(self._trailer(seq, frame), trailer):
            raise ConnectionError_("frame integrity check failed")
        return tag, seq, frame[9:]

    def _rekey_material(self, new_epoch: int
                        ) -> tuple[bytes, bytes | None]:
        """REKEY frame body + the secret to install after sending.

        Round 18 (rotation re-auth): the body carries the announced
        epoch PLUS a session-ticket — a MAC under the CURRENT keyring
        secret of this connection's authenticating entity (the client
        side's name: that's whose key both handshake directions used).
        The receiver verifies it against its own keyring, so a key
        rotation re-proves possession on the live session instead of
        just relabeling epochs. Appended after the legacy 4-byte
        epoch, zero-fill discipline: an old peer reads the epoch and
        ignores the tail. Falls back to the ticketless legacy body
        when the entity's key is gone (a racing revoke — the fence is
        already in flight)."""
        ep = new_epoch.to_bytes(4, "little")
        entity = self.msgr.name if self.is_client else self.peer_name
        kr = self.msgr.keyring
        try:
            secret = kr.get(entity) if kr is not None else None
        except Exception:
            secret = None
        if secret is None:
            return ep, None
        return ep + self.auth.rekey_ticket(secret, new_epoch), secret

    async def _maybe_rekey(self) -> None:
        """In-band tx-key rotation (the cephx ticket-renewal analog):
        after ms_rekey_frames frames, announce epoch+1 under the old
        key, then switch. The receiver flips its rx epoch on the REKEY
        frame; TCP ordering makes the cutover exact."""
        n = self.msgr.rekey_frames
        if not self._secure() or not n or self._tx_frames < n:
            return
        new_epoch = self._tx_epoch + 1
        body, secret = self._rekey_material(new_epoch)
        await self._send_frame(TAG_REKEY, 0, body)
        if secret is not None:
            self.auth.install_secret(0 if self.is_client else 1,
                                     secret, new_epoch)
        self._tx_epoch = new_epoch
        self._tx_frames = 0

    # -- public ------------------------------------------------------------
    async def send_message(self, msg: Message) -> None:
        """Queue-and-send with at-least-once semantics on outgoing
        lossless connections (resent after reconnect until acked).
        Server-side (accepted) connections cannot reconnect — a failed
        send raises so the caller knows the reply was lost and the peer
        must re-request (ref: OSD replies on reset client sessions).

        Message-level fault shaping (sim/faults.py) runs BEFORE the
        send lock and the seq assignment: a delayed/reordered message
        is overtaken by later sends and still gets an in-order seq, so
        the receiver's dedup machinery stays coherent; a duplicated
        message goes out twice under distinct seqs (end-to-end reqid
        dedup makes it exactly-once)."""
        inj = self.msgr.faults
        if inj is not None and \
                await inj.on_message(self.msgr.name, self.peer_name):
            await self._send_message_once(msg)    # injected duplicate
        await self._send_message_once(msg)

    async def _send_message_once(self, msg: Message) -> None:
        async with self._send_lock:
            sess = self.session
            if sess is not None:
                sess.out_seq += 1
                seq = sess.out_seq
            else:
                self.out_seq += 1
                seq = self.out_seq
            msg.seq = seq
            body = msg.encode()
            if not self.policy.lossy:
                (sess.unacked if sess is not None
                 else self.unacked).append((seq, body))
            try:
                await self._maybe_rekey()
                self._tx_frames += 1
                await self._send_frame(TAG_MSG, seq, body)
            except ConnectionError_:
                if self.policy.lossy or sess is None:
                    raise
                await self.msgr._reconnect_and_replay(self.peer_addr,
                                                      self.peer_name)

    async def _ack(self, seq: int) -> None:
        # under _send_lock: in secure mode the reader task's ACKs must
        # serialize with send_message's rekey cutover, or an ACK sealed
        # under the old epoch can hit the wire AFTER the REKEY frame
        # and fail decryption on a peer that already flipped rx_epoch
        async with self._send_lock:
            await self._send_frame(TAG_ACK, seq, b"")

    def _handle_ack(self, seq: int) -> None:
        if self.session is not None:
            self.session.unacked = [
                (s, b) for s, b in self.session.unacked if s > seq]
        else:
            self.unacked = [(s, b) for s, b in self.unacked if s > seq]

    def _abort(self) -> None:
        self.closed = True
        try:
            self.writer.close()
        except Exception:
            pass

    async def force_rekey(self) -> None:
        """Rotate this connection's tx frame key NOW (the AuthMonitor
        rotation hook): announce epoch+1 under the old key, then
        switch — exactly Connection._maybe_rekey without the frame-
        count gate. No-op outside secure mode (crc frames carry no
        key)."""
        if not self._secure() or self.closed:
            return
        async with self._send_lock:
            new_epoch = self._tx_epoch + 1
            body, secret = self._rekey_material(new_epoch)
            try:
                await self._send_frame(TAG_REKEY, 0, body)
            except ConnectionError_:
                return               # dead conn: nothing left to rekey
            if secret is not None:
                self.auth.install_secret(0 if self.is_client else 1,
                                         secret, new_epoch)
            self._tx_epoch = new_epoch
            self._tx_frames = 0

    async def close(self) -> None:
        self._abort()
        if self._reader_task:
            self._reader_task.cancel()


class Dispatcher:
    """ref: src/msg/Dispatcher.h — implement in daemons."""

    async def ms_dispatch(self, msg: Message) -> bool:
        raise NotImplementedError

    async def ms_handle_reset(self, conn: Connection) -> None:
        pass


class Messenger:
    """ref: Messenger::create + AsyncMessenger. One per daemon."""

    def __init__(self, name: str, keyring: Keyring | None = None,
                 mode: int = MODE_CRC,
                 default_policy: Policy | None = None,
                 inject_socket_failures: int = 0,
                 max_frame: int = 64 << 20,
                 seed: int | None = None,
                 rekey_frames: int = 4096):
        self.name = name                  # entity name, e.g. "osd.3"
        self.keyring = keyring
        if mode == MODE_SECURE and keyring is None:
            raise ValueError("secure mode requires a keyring "
                             "(frame MACs need a session key)")
        self.mode = mode
        # secure mode: rotate each connection's tx key after this many
        # frames (0 = never); see Connection._maybe_rekey
        self.rekey_frames = rekey_frames
        self.handshake_timeout = 5.0
        self.policy = default_policy or Policy()
        self.peer_policies: dict[str, Policy] = {}  # entity type -> policy
        self.max_frame = max_frame
        self.inject_socket_failures = inject_socket_failures
        # richer per-peer-pair fault table (sim/faults.FaultInjector):
        # partitions/drops/delays/dup/reorder, installed at runtime
        self.faults = None
        self._rng = random.Random(seed)
        # instance nonce: distinguishes this daemon incarnation so peers
        # reset replay-dedup state after a restart (ref: entity_addr_t
        # nonce + ProtocolV2 session cookies)
        self.session_id = random.SystemRandom().getrandbits(63)
        # lossless replay dedup survives TCP reconnects: peer name ->
        # [peer session_id, last delivered seq]
        self._peer_in_seq: dict[str, list[int]] = {}
        self.dispatchers: list[Dispatcher] = []
        self.conns: dict[EntityAddr, Connection] = {}
        # peer name -> live connections: the 10k-session fix for the
        # connection-table scans key events used to do (key_rotated/
        # key_revoked iterated EVERY connection per event — O(sessions)
        # per auth change). Maintained at attach/accept/close.
        self._by_peer: dict[str, set[Connection]] = {}
        self._sessions: dict[EntityAddr, _Session] = {}
        self._conn_locks: dict[EntityAddr, asyncio.Lock] = {}
        self._server: asyncio.AbstractServer | None = None
        self.addr: EntityAddr | None = None
        self.throttle: Throttle | None = None
        self._accepted: set[Connection] = set()
        # set by shutdown(): a handshake still in flight when the
        # listener closes must not register a session afterwards
        self._shut = False
        # frames and bytes this messenger put on and took off the wire
        # after the handshake (length prefix, header, body, trailer)
        self.wire = {"tx_frames": 0, "tx_bytes": 0,
                     "rx_frames": 0, "rx_bytes": 0}
        # AuthMonitor lifecycle: a live keyring notifies us on
        # rotation (re-key live sessions) and revocation (fence)
        if keyring is not None:
            keyring.add_observer(self)

    # -- setup -------------------------------------------------------------
    def add_dispatcher(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    def set_policy(self, entity_type: str, policy: Policy) -> None:
        """Per-peer-type policy (ref: Messenger::set_policy)."""
        self.peer_policies[entity_type] = policy

    def _policy_for(self, peer_name: str) -> Policy:
        etype = peer_name.split(".", 1)[0]
        return self.peer_policies.get(etype, self.policy)

    def _restore_in_seq(self, conn: Connection) -> None:
        """Lossless replay dedup across TCP reconnects: the same peer
        incarnation resumes at its last delivered seq; a restarted peer
        (new session id) starts fresh."""
        if conn.policy.lossy:
            return
        state = self._peer_in_seq.get(conn.peer_name)
        if state is None or state[0] != conn.peer_session:
            state = [conn.peer_session, 0]
            self._peer_in_seq[conn.peer_name] = state
        conn.in_seq = state[1]

    def _banner_flags(self) -> int:
        return (1 if self.keyring is not None else 0) | \
            (2 if self.mode == MODE_SECURE else 0)

    def _inject_failure(self) -> bool:
        n = self.inject_socket_failures
        return bool(n) and self._rng.randrange(n) == 0

    # -- key lifecycle (Keyring observer; ref: cephx ticket rotation /
    # session killing on auth removal) ------------------------------------
    def _index_conn(self, conn: Connection) -> None:
        self._by_peer.setdefault(conn.peer_name, set()).add(conn)

    def _unindex_conn(self, conn: Connection) -> None:
        peers = self._by_peer.get(conn.peer_name)
        if peers is not None:
            peers.discard(conn)
            if not peers:
                self._by_peer.pop(conn.peer_name, None)

    def _conns_of(self, name: str) -> list[Connection]:
        return [c for c in self._by_peer.get(name, ())
                if not c.closed]

    def key_rotated(self, name: str) -> None:
        """The entity's secret changed: bump the frame-key epoch on its
        live sessions (in-band REKEY; new handshakes pick up the new
        secret from the keyring automatically). Rotating OUR OWN key
        re-keys every connection we originate."""
        conns = list(self.conns.values()) + list(self._accepted) \
            if name == self.name else self._conns_of(name)
        for conn in conns:
            asyncio.ensure_future(conn.force_rekey())

    def key_revoked(self, name: str) -> None:
        """The entity's key is GONE: fence it — drop its open sessions
        and their replay state. Handshakes for it now fail at the
        keyring lookup, so the entity cannot come back until a new key
        is provisioned. Our own key revoked = we are fenced: every
        session drops."""
        if name == self.name:
            victims = list(self.conns.items()) + \
                [(None, c) for c in self._accepted]
        else:
            victims = [(a, c) for a, c in self.conns.items()
                       if c.peer_name == name] + \
                [(None, c) for c in self._accepted
                 if c.peer_name == name]
        for addr, conn in victims:
            if addr is not None:
                self.conns.pop(addr, None)
                self._sessions.pop(addr, None)
            asyncio.ensure_future(conn.close())
        if name != self.name:
            self._peer_in_seq.pop(name, None)

    async def bind(self, host: str = "127.0.0.1",
                   port: int = 0) -> EntityAddr:
        self._shut = False
        self._server = await asyncio.start_server(self._accept, host, port)
        sock = self._server.sockets[0]
        self.addr = EntityAddr(*sock.getsockname()[:2])
        if self.policy.throttler_bytes:
            self.throttle = Throttle(self.policy.throttler_bytes)
        return self.addr

    # -- handshake ---------------------------------------------------------
    async def _accept(self, reader, writer) -> None:
        try:
            conn = await asyncio.wait_for(
                self._server_handshake(reader, writer),
                timeout=self.handshake_timeout)
        except (AuthError, ConnectionError_, ConnectionError, OSError,
                asyncio.IncompleteReadError, asyncio.TimeoutError) as e:
            log.dout(5, f"accept failed: {e}")
            writer.close()
            return
        if self._shut:
            # the handshake finished after shutdown() began: a session
            # registered now would outlive the messenger and answer its
            # peers (a dead OSD's heartbeat replies)
            await conn.close()
            return
        self._accepted.add(conn)
        self._index_conn(conn)
        conn._reader_task = asyncio.ensure_future(self._reader_loop(conn))

    async def _server_handshake(self, reader, writer) -> Connection:
        # banner carries auth+mode flags so a mismatch fails fast
        # instead of deadlocking/desyncing mid-stream
        writer.write(BANNER + bytes([self._banner_flags()]))
        await writer.drain()
        if await reader.readexactly(len(BANNER)) != BANNER:
            raise ConnectionError_("bad banner")
        peer_flags = (await reader.readexactly(1))[0]
        if peer_flags != self._banner_flags():
            raise AuthError("auth/mode mismatch with peer")
        # client hello: name + session id + nonce
        nlen = int.from_bytes(await reader.readexactly(2), "little")
        peer_name = (await reader.readexactly(nlen)).decode()
        peer_session = int.from_bytes(await reader.readexactly(8), "little")
        client_nonce = await reader.readexactly(16)
        auth = None
        if self.keyring is not None:
            auth = Authenticator(self.name, self.keyring.get(peer_name))
            # send our nonce + server proof
            proof = auth.server_respond(client_nonce)
            writer.write(auth.nonce + proof)
            await writer.drain()
            client_proof = await reader.readexactly(32)
            auth.verify_client(client_nonce, client_proof)
            writer.write(b"OK")
        else:
            writer.write(b"NA")
        await writer.drain()
        conn = Connection(self, reader, writer, peer_name, None, auth,
                          self._policy_for(peer_name),
                          peer_session=peer_session)
        self._restore_in_seq(conn)
        return conn

    async def _client_handshake(self, addr: EntityAddr,
                                peer_name: str) -> Connection:
        if self.faults is not None and \
                self.faults.blocks_connect(self.name, peer_name):
            # partitioned pair: the SYN never lands
            raise ConnectionError_(
                f"injected partition: {self.name} -> {peer_name}")
        reader, writer = await asyncio.open_connection(addr.host, addr.port)
        try:
            return await asyncio.wait_for(
                self._client_handshake_inner(reader, writer, addr,
                                             peer_name),
                timeout=self.handshake_timeout)
        except asyncio.IncompleteReadError as e:
            # the peer closed mid-handshake (its own handshake timed out
            # on a busy loop): a connection failure its callers retry.
            # The reference lets the EOF through, and an objecter op
            # that meets it fails (ROADMAP Queue C)
            writer.close()
            raise ConnectionError_(
                f"{peer_name} closed the connection during the "
                f"handshake") from e
        except BaseException:
            writer.close()
            raise

    async def _client_handshake_inner(self, reader, writer,
                                      addr: EntityAddr,
                                      peer_name: str) -> Connection:
        if await reader.readexactly(len(BANNER)) != BANNER:
            raise ConnectionError_("bad banner")
        peer_flags = (await reader.readexactly(1))[0]
        if peer_flags != self._banner_flags():
            raise AuthError("auth/mode mismatch with peer")
        writer.write(BANNER + bytes([self._banner_flags()]))
        name_b = self.name.encode()
        hello = len(name_b).to_bytes(2, "little") + name_b + \
            self.session_id.to_bytes(8, "little")
        auth = None
        if self.keyring is not None:
            auth = Authenticator(self.name, self.keyring.get(self.name))
            writer.write(hello + auth.nonce)
            await writer.drain()
            server_nonce = await reader.readexactly(16)
            server_proof = await reader.readexactly(32)
            auth.verify_server(server_nonce, server_proof)
            writer.write(auth.client_prove(server_nonce))
            await writer.drain()
        else:
            writer.write(hello + b"\x00" * 16)
            await writer.drain()
        status = await reader.readexactly(2)
        if status not in (b"OK", b"NA"):
            raise AuthError("handshake rejected")
        return Connection(self, reader, writer, peer_name, addr, auth,
                          self._policy_for(peer_name))

    # -- connection table --------------------------------------------------
    def _attach(self, addr: EntityAddr, conn: Connection) -> None:
        if not conn.policy.lossy:
            conn.session = self._sessions.setdefault(addr, _Session())
        self.conns[addr] = conn
        self._index_conn(conn)
        conn._reader_task = asyncio.ensure_future(self._reader_loop(conn))

    async def connect(self, addr: EntityAddr,
                      peer_name: str = "?") -> Connection:
        conn = self.conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self.conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
            if conn is not None and not conn.policy.lossy:
                # the logical session (seq + unacked) outlives sockets:
                # resume it so the peer's dedup state stays coherent
                await self._reconnect_locked(addr, conn.peer_name)
                return self.conns[addr]
            conn = await self._client_handshake(addr, peer_name)
            self._attach(addr, conn)
            return conn

    async def send_message(self, msg: Message, addr: EntityAddr,
                           peer_name: str = "?") -> None:
        conn = await self.connect(addr, peer_name)
        await conn.send_message(msg)

    async def _reconnect_and_replay(self, addr: EntityAddr,
                                    peer_name: str) -> None:
        lock = self._conn_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            await self._reconnect_locked(addr, peer_name)

    async def _reconnect_locked(self, addr: EntityAddr,
                                peer_name: str) -> None:
        """Lossless reconnect: fresh socket, same session; replay the
        session's unacked queue in order (ref: ProtocolV2 session
        reconnect + out_queue replay). Acks prune the queue between
        attempts, so retries shrink under fault injection."""
        sess = self._sessions.setdefault(addr, _Session())
        for attempt in range(40):
            conn = self.conns.get(addr)
            if conn is None or conn.closed:
                try:
                    conn = await self._client_handshake(addr, peer_name)
                except (ConnectionError_, ConnectionError, OSError,
                        asyncio.IncompleteReadError):
                    await asyncio.sleep(0.05 * (attempt + 1))
                    continue
                self._attach(addr, conn)
            try:
                # under the connection's send lock: replay on a LIVE
                # conn must serialize with send_message's secure-mode
                # rekey cutover (same reasoning as Connection._ack), or
                # a replayed frame sealed under the old epoch can land
                # after the REKEY frame and kill the session
                async with conn._send_lock:
                    for seq, body in list(sess.unacked):
                        await conn._send_frame(TAG_MSG, seq, body)
                return
            except ConnectionError_:
                continue
        raise ConnectionError_(
            f"reconnect to {addr} failed after retries")

    # -- dispatch ----------------------------------------------------------
    async def _reader_loop(self, conn: Connection) -> None:
        try:
            await self._reader_loop_inner(conn)
        finally:
            self._accepted.discard(conn)
            self._unindex_conn(conn)

    async def _reader_loop_inner(self, conn: Connection) -> None:
        while not conn.closed:
            try:
                tag, seq, body = await conn._recv_frame()
            except asyncio.CancelledError:
                return
            except Exception:           # ConnectionError_ or corrupt peer
                conn._abort()
                for d in self.dispatchers:
                    await d.ms_handle_reset(conn)
                return
            if tag == TAG_ACK:
                conn._handle_ack(seq)
                continue
            if tag == TAG_KEEPALIVE:
                continue
            if tag == TAG_REKEY:
                epoch = int.from_bytes(body[:4], "little")
                if conn._secure() and len(body) >= 36:
                    # session-ticket re-auth (round 18): the announcer
                    # must prove it holds the entity's CURRENT secret
                    # per OUR keyring. Mismatch = rotation skew or a
                    # revoked key — fence; the reconnect path runs
                    # full mutual auth against whatever keys then hold
                    entity = self.name if conn.is_client \
                        else conn.peer_name
                    secret = None
                    try:
                        secret = self.keyring.get(entity) \
                            if self.keyring is not None else None
                    except Exception:
                        secret = None
                    ok = secret is not None and hmac.compare_digest(
                        conn.auth.rekey_ticket(secret, epoch),
                        bytes(body[4:36]))
                    if not ok:
                        log.dout(1, f"rekey ticket from "
                                    f"{conn.peer_name} failed "
                                    f"verification: fencing session")
                        conn._abort()
                        for d in self.dispatchers:
                            await d.ms_handle_reset(conn)
                        return
                    conn.auth.install_secret(
                        1 if conn.is_client else 0, secret, epoch)
                conn._rx_epoch = epoch
                continue
            if not conn.policy.lossy:
                # ack even duplicates so a replaying peer can prune
                try:
                    await conn._ack(seq)
                except ConnectionError_:
                    pass
            if seq <= conn.in_seq:
                continue        # duplicate after replay
            conn.in_seq = seq
            if not conn.policy.lossy:
                state = self._peer_in_seq.get(conn.peer_name)
                if state is not None and state[0] == conn.peer_session:
                    state[1] = seq
            try:
                msg = Message.decode(body)
            except Exception as e:
                log.dout(1, f"undecodable message from {conn.peer_name}: {e}")
                continue
            msg.src = conn.peer_name
            msg.conn = conn
            if self.throttle:
                await self.throttle.acquire(len(body))
            try:
                handled = False
                for d in self.dispatchers:
                    if await d.ms_dispatch(msg):
                        handled = True
                        break
                if not handled:
                    log.dout(10, f"unhandled {msg!r} from {conn.peer_name}")
            except Exception:
                log.error(f"dispatch of {type(msg).__name__} failed: "
                          f"{traceback.format_exc()}")
            finally:
                if self.throttle:
                    await self.throttle.release(len(body))

    # -- teardown ----------------------------------------------------------
    async def shutdown(self) -> None:
        self._shut = True
        if self.keyring is not None:
            self.keyring.remove_observer(self)
        if self._server:
            self._server.close()           # stop accepting first
        for conn in list(self.conns.values()) + list(self._accepted):
            await conn.close()
        self.conns.clear()
        self._accepted.clear()
        if self._server:
            # Python 3.12 wait_closed blocks until every handler's
            # transport is gone; bound it — sockets are already closed
            try:
                await asyncio.wait_for(self._server.wait_closed(),
                                       timeout=0.5)
            except Exception:
                pass
