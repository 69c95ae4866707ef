"""The messenger, ceph_tpu_torch against ceph_tpu.

The port's loopback cases follow ``tests/test_messenger.py``: auth in crc
and secure mode, lossless replay under injected socket failures, the
dispatch throttle, in-band rekey and key rotation. Secure mode runs over
AES-GCM when ``cryptography`` is installed and over the reference's
encrypt-then-MAC construction otherwise, as the reference's own cases do
(``msg/auth.py``: ``HAVE_AESGCM``); both ends of a session must use the
same one, and in one process they do.

Then the two packages on one wire: a ``ceph_tpu`` messenger and a
``ceph_tpu_torch`` one exchange real OSD messages both ways, in crc and
in secure mode, and each side decodes exactly what the other encoded.

Tolerance: exact. Every delivered message equals the one sent, field for
field, in order; the port's wire counters equal the frames' bytes.
"""

from __future__ import annotations

import asyncio

import pytest

import ceph_tpu.msg as ref_msg
import ceph_tpu.osd.messages as ref_m
import ceph_tpu_torch.msg as port_msg
import ceph_tpu_torch.osd.messages as port_m
from ceph_tpu_torch.msg import (
    MODE_CRC, MODE_SECURE, AuthError, Dispatcher, Keyring, Message,
    Messenger, Policy, register,
)
from ceph_tpu_torch.msg.messenger import ConnectionError_

_REFUSED = (AuthError, ConnectionError_, OSError, asyncio.IncompleteReadError)


# type codes of their own: the reference's loopback file registers 900
# and 901 in ceph_tpu's registry, and these live in the port's
@register
class MPing(Message):
    TYPE = 960
    FIELDS = [("x", "u64"), ("note", "str")]


@register
class MData(Message):
    TYPE = 961
    FIELDS = [("oid", "str"), ("data", "blob"), ("osds", "list:s32")]


class Collector(Dispatcher):
    def __init__(self):
        self.got = []
        self.resets = 0

    async def ms_dispatch(self, msg):
        self.got.append(msg)
        return True

    async def ms_handle_reset(self, conn):
        self.resets += 1


async def _wait(pred, timeout=5.0):
    loop = asyncio.get_event_loop()
    end = loop.time() + timeout
    while not pred():
        if loop.time() > end:
            raise TimeoutError
        await asyncio.sleep(0.01)


def _keyring(*names):
    kr = Keyring()
    for n in names:
        kr.add(n, n.encode().ljust(32, b"k"))
    return kr


async def _pair(mode=MODE_CRC, server_kw=None, client_kw=None,
                names=("osd.0", "osd.1"), lossless=False):
    kr = _keyring(*names)
    server = Messenger(names[1], keyring=kr, mode=mode, **(server_kw or {}))
    client = Messenger(names[0], keyring=kr, mode=mode, **(client_kw or {}))
    if lossless:
        server.set_policy("osd", Policy.lossless_peer())
        client.set_policy("osd", Policy.lossless_peer())
    sink = Collector()
    server.add_dispatcher(sink)
    addr = await server.bind()
    return server, client, sink, addr


async def _close(*msgrs):
    for m in msgrs:
        await m.shutdown()


@pytest.mark.parametrize("mode", [MODE_CRC, MODE_SECURE],
                         ids=["crc", "secure"])
def test_roundtrip_with_auth_and_reply(mode):
    async def go():
        server, client, sink, addr = await _pair(
            mode, names=("client.a", "osd.1"))
        await client.send_message(
            MData(oid="obj1", data=b"\x01\x02", osds=[3, -1]), addr,
            "osd.1")
        await _wait(lambda: sink.got)
        m = sink.got[0]
        assert (m.oid, m.data, m.osds, m.src) == ("obj1", b"\x01\x02",
                                                  [3, -1], "client.a")
        reply = Collector()
        client.add_dispatcher(reply)
        await m.conn.send_message(MPing(x=7, note="reply"))
        await _wait(lambda: reply.got)
        assert reply.got[0].x == 7
        await _close(client, server)
    asyncio.run(go())


@pytest.mark.parametrize("case", ["wrong_key", "unknown_entity",
                                  "auth_mismatch", "mode_mismatch"])
def test_handshake_refusals(case):
    async def go():
        if case == "wrong_key":
            server = Messenger("mon.a", keyring=_keyring("mon.a",
                                                         "client.x"))
            kr = _keyring("mon.a", "client.x")
            kr.add("client.x")                       # a different secret
            client = Messenger("client.x", keyring=kr)
        elif case == "unknown_entity":
            server = Messenger("mon.a", keyring=_keyring("mon.a"))
            client = Messenger("client.ghost",
                               keyring=_keyring("mon.a", "client.ghost"))
        elif case == "auth_mismatch":
            server = Messenger("mon.a")
            client = Messenger("client.x",
                               keyring=_keyring("mon.a", "client.x"))
        else:
            kr = _keyring("mon.a", "client.x")
            server = Messenger("mon.a", keyring=kr, mode=MODE_SECURE)
            client = Messenger("client.x", keyring=kr)
        await server.bind()
        with pytest.raises(_REFUSED):
            await client.send_message(MPing(x=1, note=""), server.addr,
                                      "mon.a")
        await _close(client, server)
    asyncio.run(go())


def test_secure_mode_no_plaintext_on_wire_and_rekeys():
    async def go():
        server, client, sink, addr = await _pair(
            MODE_SECURE, {"rekey_frames": 3}, {"rekey_frames": 3})
        captured = []
        orig = client._client_handshake_inner

        async def tapped(reader, writer, a, peer):
            w = writer.write
            writer.write = lambda d: (captured.append(bytes(d)), w(d))[1]
            return await orig(reader, writer, a, peer)
        client._client_handshake_inner = tapped
        marker = b"TOP-SECRET-PAYLOAD-0123456789"
        for i in range(12):
            await client.send_message(MData(oid=f"o{i}", data=marker,
                                            osds=[i]), addr, "osd.1")
        await _wait(lambda: len(sink.got) == 12)
        assert [m.osds for m in sink.got] == [[i] for i in range(12)]
        assert all(m.data == marker for m in sink.got)
        assert marker not in b"".join(captured)
        assert next(iter(client.conns.values()))._tx_epoch >= 3
        await _close(client, server)
    asyncio.run(go())


def test_lossless_replay_exactly_once_under_injection():
    async def go():
        server, client, sink, addr = await _pair(
            client_kw={"inject_socket_failures": 12, "seed": 7},
            lossless=True)
        for i in range(40):
            await client.send_message(MPing(x=i, note="inj"), addr,
                                      "osd.1")
        client.inject_socket_failures = 0
        await _wait(lambda: len(sink.got) >= 40, timeout=15)
        assert [m.x for m in sink.got] == list(range(40))
        await _close(client, server)
    asyncio.run(go())


def test_lossy_connection_raises_on_failure():
    async def go():
        server, client, _sink, addr = await _pair(
            client_kw={"inject_socket_failures": 1, "seed": 3},
            names=("client.a", "osd.1"))
        with pytest.raises(ConnectionError_):
            for _ in range(50):
                await client.send_message(MPing(x=0, note=""), addr,
                                          "osd.1")
        await _close(client, server)
    asyncio.run(go())


def test_throttled_dispatch_and_concurrent_first_sends():
    async def go():
        server, client, sink, addr = await _pair(
            server_kw={"default_policy": Policy(lossy=True,
                                                throttler_bytes=256)},
            names=("client.a", "osd.1"))
        await asyncio.gather(*[client.send_message(
            MData(oid=f"o{i}", data=b"x" * 100, osds=[]), addr, "osd.1")
            for i in range(20)])
        await _wait(lambda: len(sink.got) == 20)
        assert sorted(m.oid for m in sink.got) == \
            sorted(f"o{i}" for i in range(20))
        assert len(client.conns) == 1
        await _close(client, server)
    asyncio.run(go())


def test_lossless_resumes_after_reader_side_abort():
    async def go():
        server, client, sink, addr = await _pair(lossless=True)
        await client.send_message(MPing(x=1, note=""), addr, "osd.1")
        await _wait(lambda: len(sink.got) == 1)
        client.conns[addr]._abort()
        await client.send_message(MPing(x=2, note=""), addr, "osd.1")
        await _wait(lambda: len(sink.got) == 2)
        assert [m.x for m in sink.got] == [1, 2]
        await _close(client, server)
    asyncio.run(go())


@pytest.mark.parametrize("skew", [False, True], ids=["both", "skew"])
def test_key_rotation(skew):
    """Both ends rotate: the live session re-keys in band. Only one
    does: the peer fences the session."""
    async def go():
        master = _keyring("osd.0", "osd.1")
        kr_srv = master.copy_for("osd.0", "osd.1")
        kr_cli = master.copy_for("osd.0", "osd.1")
        server = Messenger("osd.1", keyring=kr_srv, mode=MODE_SECURE)
        sink = Collector()
        server.add_dispatcher(sink)
        addr = await server.bind()
        client = Messenger("osd.0", keyring=kr_cli, mode=MODE_SECURE)
        await client.send_message(MPing(x=1, note=""), addr, "osd.1")
        await _wait(lambda: len(sink.got) == 1)
        conn = client.conns[addr]
        epoch0 = conn._tx_epoch
        newkey = master.generate_key()
        kr_cli.set_key("osd.0", newkey)
        if not skew:
            kr_srv.set_key("osd.0", newkey)
            await _wait(lambda: conn._tx_epoch > epoch0)
            for i in range(2, 5):
                await client.send_message(MPing(x=i, note=""), addr,
                                          "osd.1")
            await _wait(lambda: len(sink.got) == 4)
            assert [m.x for m in sink.got] == [1, 2, 3, 4]
            assert sink.resets == 0 and not conn.closed
        else:
            await _wait(lambda: sink.resets >= 1 and conn.closed)
            with pytest.raises(_REFUSED):
                await client.send_message(MPing(x=2, note=""), addr,
                                          "osd.1")
                await client.send_message(MPing(x=3, note=""), addr,
                                          "osd.1")
            assert len(sink.got) == 1
        await _close(client, server)
    asyncio.run(go())


def test_registry_and_secure_mode_guards():
    with pytest.raises(ValueError):
        @register
        class Clash(Message):
            TYPE = 960
            FIELDS = []
    with pytest.raises(ValueError):
        Messenger("osd.0", mode=MODE_SECURE)


def test_wire_counters_count_every_frame():
    async def go():
        server, client, sink, addr = await _pair(lossless=True)
        for i in range(5):
            await client.send_message(MData(oid="o", data=b"z" * (100 * i),
                                            osds=[i]), addr, "osd.1")
        await _wait(lambda: len(sink.got) == 5)
        await _wait(lambda: client.wire["rx_frames"] == 5)   # the acks
        body = sum(len(MData(oid="o", data=b"z" * (100 * i),
                             osds=[i]).encode()) for i in range(5))
        # length prefix, tag + seq header, crc trailer around each body
        assert server.wire["rx_frames"] == 5
        assert server.wire["rx_bytes"] == body + 5 * (4 + 9 + 4)
        assert client.wire["tx_bytes"] == server.wire["rx_bytes"]
        assert server.wire["tx_bytes"] == client.wire["rx_bytes"]
        await _close(client, server)
    asyncio.run(go())


# -- the two packages on one wire -------------------------------------------

def _ops_message(pkg_m, i: int):
    return pkg_m.make_osd_op(
        tid=i + 1, epoch=7, pool=1, seed=i, oid=f"rbd_data.{i:04x}",
        ops=[(pkg_m.OSD_OP_WRITE, 4096 * i, 4096, "", bytes([i]) * 4096),
             (pkg_m.OSD_OP_SETXATTR, 0, 2, "user.k", b"v%d" % i)],
        attempt=i % 2)


def _subop_message(pkg_m, i: int):
    return pkg_m.MOSDECSubOpWrite(
        tid=i, epoch=3, pgid="1.0", oid=f"o{i}", first_stripe=i,
        data=bytes(range(256)) * 8, truncate_stripes=i + 1, size=2048 * i,
        remove=False, attrs={"_v": b"\x01" * 12, "_pos": b"\x02\0\0\0"},
        omap={"k": b"v"}, omap_rm=["gone"], log_entry=b"\x05" * 13)


def _fields(m) -> dict:
    """A message's fields, with decoded memoryviews (``blob_view``) as
    bytes."""
    def plain(v):
        if isinstance(v, memoryview):
            return bytes(v)
        if isinstance(v, list):
            return [plain(x) for x in v]
        return v
    return {n: plain(getattr(m, n)) for n, _ in type(m).FIELDS}


@pytest.mark.parametrize("mode", ["crc", "secure"])
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_reference_and_port_messengers_talk(mode, direction):
    async def go():
        sides = {"port": (port_msg, port_m), "ref": (ref_msg, ref_m)}
        src, dst = direction.split("_to_")
        (s_msg, s_m), (d_msg, d_m) = sides[src], sides[dst]
        names = ("osd.0", "osd.1")
        kr_s, kr_d = s_msg.Keyring(), d_msg.Keyring()
        for n in names:
            kr_s.add(n, n.encode().ljust(32, b"k"))
            kr_d.add(n, n.encode().ljust(32, b"k"))
        md = {"crc": "MODE_CRC", "secure": "MODE_SECURE"}[mode]
        server = d_msg.Messenger("osd.1", keyring=kr_d,
                                 mode=getattr(d_msg, md))
        client = s_msg.Messenger("osd.0", keyring=kr_s,
                                 mode=getattr(s_msg, md))
        server.set_policy("osd", d_msg.Policy.lossless_peer())
        client.set_policy("osd", s_msg.Policy.lossless_peer())
        got, back = [], []

        class Sink:
            def __init__(self, into):
                self.into = into

            async def ms_dispatch(self, msg):
                self.into.append(msg)
                return True

            async def ms_handle_reset(self, conn):
                return None
        server.add_dispatcher(Sink(got))
        client.add_dispatcher(Sink(back))
        addr = await server.bind()
        sent = []
        for i in range(4):
            for make in (_ops_message, _subop_message):
                m = make(s_m, i)
                sent.append(m)
                await client.send_message(m, addr, "osd.1")
        await _wait(lambda: len(got) == len(sent))
        for a, b in zip(sent, got):
            assert type(b).__module__.startswith(d_m.__name__)
            assert type(a).__name__ == type(b).__name__
            assert _fields(a) == _fields(b)
            assert b.src == "osd.0"
        # and back over the accepted connection, in the other package
        for i, m in enumerate(got):
            await m.conn.send_message(d_m.MOSDOpReply(
                tid=m.tid, attempt=0, result=-i, epoch=9,
                data=bytes([i]) * 3, extra='{"version": "9\'%d"}' % i))
        await _wait(lambda: len(back) == len(got))
        assert [(r.tid, r.result, r.data, r.extra) for r in back] == [
            (m.tid, -i, bytes([i]) * 3, '{"version": "9\'%d"}' % i)
            for i, m in enumerate(got)]
        assert all(isinstance(r, s_m.MOSDOpReply) for r in back)
        await client.shutdown()
        await server.shutdown()
    asyncio.run(go())


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_a_handshake_that_ends_after_shutdown(pkg):
    """A session whose server-side handshake finishes after ``shutdown``
    began: the reference registers it, so it outlives its messenger (a
    hard-stopped OSD's heartbeat messenger went on answering pings and
    was never marked down); the port closes it. The handshake is held
    open until shutdown has run, so the order is fixed."""
    mod = ref_msg if pkg == "reference" else port_msg

    async def go():
        server = mod.Messenger("osd.7")
        addr = await server.bind()
        held, release = asyncio.Event(), asyncio.Event()
        real = server._server_handshake

        async def slow(reader, writer):
            held.set()
            await release.wait()
            return await real(reader, writer)
        server._server_handshake = slow
        client = mod.Messenger("client.z")
        task = asyncio.ensure_future(client.connect(addr, "osd.7"))
        await asyncio.wait_for(held.wait(), 5)
        await server.shutdown()
        release.set()
        try:
            await asyncio.wait_for(task, 5)
        except Exception:
            pass
        for _ in range(20):
            await asyncio.sleep(0.01)
        registered = len(server._accepted)
        await client.shutdown()
        await server.shutdown()
        return registered
    got = asyncio.run(go())
    assert got == (1 if pkg == "reference" else 0)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_a_peer_that_closes_during_the_handshake(pkg):
    """A server whose own handshake times out (its loop busy, as an OSD's
    under a burst of new clients) closes the socket while the client
    still waits for its banner. The port's client raises
    ``ConnectionError_``, which the objecter and the MonClient retry; the
    reference's lets ``IncompleteReadError`` through, and an objecter op
    that meets it fails (the errors of ``storm_path``'s first loadgen
    run on the card)."""
    mod = ref_msg if pkg == "reference" else port_msg

    async def go():
        server = mod.Messenger("osd.7")
        server.handshake_timeout = 0.2
        addr = await server.bind()

        async def busy(reader, writer):
            await asyncio.sleep(30)
        server._server_handshake = busy
        client = mod.Messenger("client.z")
        try:
            await asyncio.wait_for(client.connect(addr, "osd.7"), 5)
        except Exception as e:
            return e
        finally:
            await client.shutdown()
            await server.shutdown()
    err = asyncio.run(go())
    if pkg == "reference":
        assert isinstance(err, asyncio.IncompleteReadError), repr(err)
    else:
        assert isinstance(err, ConnectionError_), repr(err)
        assert isinstance(err.__cause__, asyncio.IncompleteReadError)
