"""The port's S3 gateway (``ceph_tpu_torch/rgw``) side by side with
``ceph_tpu``'s.

- SigV4: ``sign``, ``canonical_request``, ``verify``, ``presign`` and
  ``verify_presigned`` of both packages on fixed inputs (dates and
  expiries through the functions' own parameters), byte for byte, and
  the port's signer against the independent oracle of
  ``tests/test_rgw_cephfs.py``;
- tests/test_rgw_cephfs.py's four gateway cases (bucket and object
  lifecycle, multipart, SigV4 header auth, presigned URLs and canned
  ACLs), each a script run through a reference ``Cluster`` (JAX on the
  CPU) and a port ``Cluster(device="cpu")``: every response's status,
  body and ETag, and the pool's objects with their bytes and omap, are
  equal once the upload ids (``uuid4``) are mapped to their order of
  appearance;
- a bucket the reference's gateway wrote, served by the port's on the
  same cluster, and the other way round.

Tolerance: exact bytes everywhere.
"""

import asyncio
import hashlib
import hmac
import re

import pytest

from ceph_tpu.rgw import auth as ref_auth
from ceph_tpu_torch.rgw import auth as port_auth


RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


def _pkg(which: str) -> dict:
    if which == "ref":
        from ceph_tpu.cluster.vstart import Cluster
        from ceph_tpu.rados import ObjectOperationError
        from ceph_tpu.rgw import RGWGateway
        return {"Cluster": Cluster, "RGWGateway": RGWGateway,
                "auth": ref_auth, "Error": ObjectOperationError, "kw": {}}
    from ceph_tpu_torch.cluster.vstart import Cluster
    from ceph_tpu_torch.rados import ObjectOperationError
    from ceph_tpu_torch.rgw import RGWGateway
    return {"Cluster": Cluster, "RGWGateway": RGWGateway,
            "auth": port_auth, "Error": ObjectOperationError,
            "kw": {"device": "cpu"}}


# -- SigV4 on fixed inputs ----------------------------------------------------

AMZDATE = "20260731T120000Z"
SIGN_CASES = [
    ("GET", "/b/k", "", {"host": "x"}, b"payload"),
    ("PUT", "/photos/a b/c.jpg", "", {"host": "127.0.0.1:8000",
                                      "x-amz-acl": "public-read"},
     bytes(range(256)) * 17),
    ("POST", "/vids/movie.bin", "uploads", {"host": "x"}, b""),
    ("PUT", "/vids/movie.bin", "partNumber=3&uploadId=abc%2Fd",
     {"Host": "x", "Content-Type": "application/octet-stream"}, b"zz"),
    ("DELETE", "/~user/k-_.~", "z=1&a=2&a=1", {"host": "h"}, b"\x00"),
]


def _sigv4_oracle(method, path, query, amzdate, payload, access, secret,
                  region="us-east-1"):
    """tests/test_rgw_cephfs.py's independent SigV4 (no shared code)."""
    phash = hashlib.sha256(payload).hexdigest()
    headers = {"host": "x", "x-amz-date": amzdate,
               "x-amz-content-sha256": phash}
    names = sorted(headers)
    canon = (method + "\n" + path + "\n" + query + "\n"
             + "".join(f"{n}:{headers[n]}\n" for n in names) + "\n"
             + ";".join(names) + "\n" + phash)
    date = amzdate[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    sts = ("AWS4-HMAC-SHA256\n" + amzdate + "\n" + scope + "\n"
           + hashlib.sha256(canon.encode()).hexdigest())
    key = ("AWS4" + secret).encode()
    for piece in (date, region, "s3", "aws4_request"):
        key = hmac.new(key, piece.encode(), hashlib.sha256).digest()
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return (f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
            f"SignedHeaders={';'.join(names)}, Signature={sig}")


def _clock(now):
    """A stand-in for the ``datetime`` module that ``rgw/auth.py`` reads
    its clock from: ``datetime.datetime.now()`` is ``now``."""
    import datetime as dt
    import types

    class Clock(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return now
    return types.SimpleNamespace(datetime=Clock, timezone=dt.timezone)


@pytest.mark.parametrize("case", range(len(SIGN_CASES)))
def test_sign_and_verify_equal_the_reference(case, monkeypatch):
    method, path, query, headers, body = SIGN_CASES[case]
    for region in ("us-east-1", "eu-west-2"):
        args = (method, path, query, headers, body, "AK", "SK")
        got = port_auth.sign(*args, region=region, amzdate=AMZDATE)
        assert got == ref_auth.sign(*args, region=region, amzdate=AMZDATE)
        assert port_auth.signing_key("SK", AMZDATE[:8], region) == \
            ref_auth.signing_key("SK", AMZDATE[:8], region)
    lower = {k.lower(): v for k, v in headers.items()}
    signed = sorted(lower)
    assert port_auth.canonical_request(method, path, query, lower, signed,
                                       "UNSIGNED-PAYLOAD") == \
        ref_auth.canonical_request(method, path, query, lower, signed,
                                   "UNSIGNED-PAYLOAD")
    assert port_auth.canonical_query(query) == \
        ref_auth.canonical_query(query)
    # verify: the same verdicts and reasons, the clock pinned at AMZDATE
    # and then 20 minutes later (outside the replay window)
    req = {**lower, **port_auth.sign(method, path, query, headers, body,
                                     "AK", "SK", amzdate=AMZDATE)}
    import datetime as dt

    for now in (dt.datetime(2026, 7, 31, 12, 0, 30, tzinfo=dt.timezone.utc),
                dt.datetime(2026, 7, 31, 12, 20, tzinfo=dt.timezone.utc)):
        verdicts = []
        for mod in (port_auth, ref_auth):
            monkeypatch.setattr(mod, "datetime", _clock(now))
            verdicts.append([
                mod.verify(method, path, query, req, body, {"AK": "SK"}),
                mod.verify(method, path, query, req, body + b"!",
                           {"AK": "SK"}),
                mod.verify(method, path, query, req, body, {"AK": "bad"}),
                mod.verify(method, path, query, req, body, {}),
                mod.verify(method, path, query,
                           dict(req, authorization="AWS x"), body,
                           {"AK": "SK"})])
            monkeypatch.undo()
        assert verdicts[0] == verdicts[1]
        assert verdicts[0][0] == ((True, "AK") if now.minute == 0 else (
            False, "request time outside the replay window"))


def test_the_signer_equals_the_independent_oracle():
    """tests/test_rgw_cephfs.py::test_sigv4_signer_matches_independent_oracle
    on the port, at several payloads and paths."""
    for path, payload in (("/b/k", b"payload"), ("/bucket/key.txt", b""),
                          ("/a/b/c", bytes(range(200)))):
        ours = port_auth.sign("GET", path, "", {"host": "x"}, payload,
                              "AK", "SK", amzdate=AMZDATE)
        assert ours["authorization"] == _sigv4_oracle(
            "GET", path, "", AMZDATE, payload, "AK", "SK")


@pytest.mark.parametrize("expires", [1, 120, 604800, 0, -5, 604801])
def test_presign_and_verify_presigned_equal_the_reference(expires,
                                                          monkeypatch):
    import datetime as dt

    kw = dict(expires=expires, amzdate=AMZDATE, query="versionId=7")
    qs = port_auth.presign("GET", "/b/o", "host1", "AK", "sk", **kw)
    assert qs == ref_auth.presign("GET", "/b/o", "host1", "AK", "sk", **kw)
    now = dt.datetime(2026, 7, 31, 12, 0, 1, tzinfo=dt.timezone.utc)
    out = []
    for mod in (port_auth, ref_auth):
        monkeypatch.setattr(mod, "datetime", _clock(now))
        out.append([
            mod.verify_presigned("GET", "/b/o", qs, {"host": "host1"},
                                 {"AK": "sk"}),
            mod.verify_presigned("GET", "/b/o", qs + "&evil=1",
                                 {"host": "host1"}, {"AK": "sk"}),
            mod.verify_presigned("GET", "/b/o", qs.replace(
                "X-Amz-SignedHeaders=host", "X-Amz-SignedHeaders=x-amz-date"),
                {"host": "host1"}, {"AK": "sk"}),
            mod.verify_presigned("GET", "/b/o", qs, {"host": "host2"},
                                 {"AK": "sk"}),
            mod.verify_presigned("GET", "/b/o", qs, {"host": "host1"}, {})])
        monkeypatch.undo()
    assert out[0] == out[1]
    assert out[0][0][0] == (0 < expires <= 604800 and expires >= 1)


# -- the gateway, side by side --------------------------------------------------

async def _http(port: int, method: str, path: str, body: bytes = b"",
                headers: dict | None = None):
    """One request (tests/test_rgw_cephfs.py's ``_http``); (status,
    body, the ETag header or None)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n{extra}"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        status = int((await asyncio.wait_for(reader.readline(),
                                             timeout=60)).split()[1])
        hdrs = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            hdrs[k.strip().lower()] = v.strip()
        n = int(hdrs.get("content-length", 0))
        payload = b"" if method == "HEAD" or not n else \
            await reader.readexactly(n)
        return status, payload, hdrs.get("etag"), hdrs.get(
            "content-length")
    finally:
        writer.close()


async def _dump(io, Error) -> list:
    """Every object of the pool with its bytes and omap, sorted."""
    out = []
    for oid in sorted(await io.list_objects()):
        try:
            data = await io.read(oid)
        except Error:
            data = None
        try:
            omap = await io.get_omap_vals(oid)
        except Error:
            omap = None
        out.append((oid, data, omap))
    return out


async def _lifecycle(P, port, rec):
    async def q(*a, **kw):
        rec.append(await _http(port, *a, **kw))
        return rec[-1]
    assert (await q("PUT", "/photos"))[0] == 200
    st, xml, _, _ = await q("GET", "/")
    assert st == 200 and b"<Name>photos</Name>" in xml
    assert (await q("PUT", "/photos/cat.jpg", b"\xff\xd8meow"))[0] == 200
    assert (await q("GET", "/photos/cat.jpg"))[1] == b"\xff\xd8meow"
    assert (await q("HEAD", "/photos/cat.jpg"))[0] == 200
    xml = (await q("GET", "/photos"))[1]
    assert b"<Key>cat.jpg</Key>" in xml and b"<Size>6</Size>" in xml
    assert (await q("PUT", "/photos/a/b.txt", b"hi"))[0] == 200
    assert (await q("GET", "/photos/a/b.txt"))[1] == b"hi"
    assert (await q("GET", "/photos/nope"))[0] == 404
    assert (await q("PUT", "/nobucket/x", b"1"))[0] == 404
    assert (await q("DELETE", "/photos"))[0] == 409
    assert (await q("DELETE", "/photos/cat.jpg"))[0] == 204
    assert (await q("PUT", "/photos/keep", b"k" * 5000))[0] == 200
    assert (await q("DELETE", "/photos/a/b.txt"))[0] == 204
    await q("GET", "/photos")


async def _multipart(P, port, rec):
    async def q(*a, **kw):
        rec.append(await _http(port, *a, **kw))
        return rec[-1]

    def upload_id(xml):
        return xml.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    await q("PUT", "/vids")
    st, xml, _, _ = await q("POST", "/vids/movie.bin?uploads")
    up = upload_id(xml)
    parts = [b"AA" * 700, b"BB" * 900, b"CC" * 500]
    etags = []
    for i, p in enumerate(parts, start=1):
        st, _, etag, _ = await q(
            "PUT", f"/vids/movie.bin?partNumber={i}&uploadId={up}", p)
        etags.append(etag.strip('"'))
        assert etags[-1] == hashlib.md5(p).hexdigest()
    assert up.encode() in (await q("GET", "/vids?uploads"))[1]
    xml = (await q("GET", f"/vids/movie.bin?uploadId={up}"))[1]
    assert xml.count(b"<PartNumber>") == 3
    body = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for i, e in enumerate(etags, start=1)) +
        "</CompleteMultipartUpload>").encode()
    st, xml, _, _ = await q("POST", f"/vids/movie.bin?uploadId={up}", body)
    want = hashlib.md5(b"".join(bytes.fromhex(e) for e in etags)
                       ).hexdigest() + "-3"
    assert st == 200 and f'"{want}"'.encode() in xml
    st, data, etag, _ = await q("GET", "/vids/movie.bin")
    assert data == b"".join(parts) and etag.strip('"') == want
    await q("GET", "/vids")
    assert (await q("GET", f"/vids/movie.bin?uploadId={up}"))[0] == 404
    up2 = upload_id((await q("POST", "/vids/tmp?uploads"))[1])
    await q("PUT", f"/vids/tmp?partNumber=1&uploadId={up2}", b"zz")
    assert (await q("DELETE", f"/vids/tmp?uploadId={up2}"))[0] == 204
    assert (await q("GET", f"/vids/tmp?uploadId={up2}"))[0] == 404
    st, _, _, clen = await q("HEAD", "/vids/movie.bin")
    assert int(clen) == sum(map(len, parts))
    up3 = upload_id((await q("POST", "/vids/x?uploads"))[1])
    st, xml, _, _ = await q(
        "POST", f"/vids/x?uploadId={up3}",
        b"<CompleteMultipartUpload><Part><PartNumber>7</PartNumber>"
        b"</Part></CompleteMultipartUpload>")
    assert st == 400 and b"InvalidPart" in xml
    await q("PUT", f"/vids/x?partNumber=1&uploadId={up3}", b"p1")
    await q("PUT", f"/vids/x?partNumber=2&uploadId={up3}", b"p2")
    st, xml, _, _ = await q(
        "POST", f"/vids/x?uploadId={up3}",
        b"<CompleteMultipartUpload><Part><PartNumber>2</PartNumber></Part>"
        b"<Part><PartNumber>1</PartNumber></Part>"
        b"</CompleteMultipartUpload>")
    assert st == 400 and b"InvalidPartOrder" in xml
    st, xml, _, _ = await q(
        "POST", f"/vids/x?uploadId={up3}",
        b"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
        b'<ETag>"deadbeefdeadbeefdeadbeefdeadbeef"</ETag></Part>'
        b"</CompleteMultipartUpload>")
    assert st == 400 and b"InvalidPart" in xml
    st, xml, _, _ = await q(
        "PUT", f"/vids/x?partNumber=abc&uploadId={up3}", b"zz")
    assert st == 400 and b"InvalidPartNumber" in xml
    assert (await q("DELETE", f"/vids/OTHER?uploadId={up3}"))[0] == 404
    assert (await q("GET", f"/vids/x?uploadId={up3}"))[0] == 200
    # a multipart upload over a plain object, then the plain one back
    await q("PUT", "/vids/swap", b"plain")
    up4 = upload_id((await q("POST", "/vids/swap?uploads"))[1])
    await q("PUT", f"/vids/swap?partNumber=1&uploadId={up4}", b"S" * 3000)
    await q("PUT", f"/vids/swap?partNumber=2&uploadId={up4}", b"T" * 100)
    await q("POST", f"/vids/swap?uploadId={up4}", b"")
    await q("GET", "/vids/swap")
    assert (await q("DELETE", "/vids/movie.bin"))[0] == 204
    assert (await q("GET", "/vids/movie.bin"))[0] == 404


async def _sigv4(P, port, rec):
    sigv4 = P["auth"]

    async def q(*a, **kw):
        rec.append(await _http(port, *a, **kw))
        return rec[-1]

    def signed(method, target, body=b"", secret="secretkey"):
        path, _, query = target.partition("?")
        return sigv4.sign(method, path, query, {"host": "x"}, body,
                          "AKIDEXAMPLE", secret)
    st, xml, _, _ = await q("PUT", "/secure")
    assert st == 403 and b"AccessDenied" in xml
    assert (await q("PUT", "/secure",
                    headers=signed("PUT", "/secure")))[0] == 200
    assert (await q("PUT", "/secure/doc", b"data!",
                    headers=signed("PUT", "/secure/doc", b"data!")))[0] == 200
    st, data, _, _ = await q("GET", "/secure/doc",
                             headers=signed("GET", "/secure/doc"))
    assert st == 200 and data == b"data!"
    assert (await q("GET", "/secure/doc", headers=signed(
        "GET", "/secure/doc", secret="wrong")))[0] == 403
    assert (await q("PUT", "/secure/doc", b"EVIL!", headers=signed(
        "PUT", "/secure/doc", b"data!")))[0] == 403
    st, xml, _, _ = await q("POST", "/secure/big?uploads",
                            headers=signed("POST", "/secure/big?uploads"))
    assert st == 200 and b"<UploadId>" in xml
    stale = sigv4.sign("GET", "/secure/doc", "", {"host": "x"}, b"",
                       "AKIDEXAMPLE", "secretkey",
                       amzdate="20200101T000000Z")
    assert (await q("GET", "/secure/doc", headers=stale))[0] == 403
    assert (await q("GET", "/", headers=signed("GET", "/")))[0] == 200
    assert (await q("GET", "/"))[0] == 403


async def _acls(P, port, rec):
    sigv4 = P["auth"]

    async def q(*a, **kw):
        rec.append(await _http(port, *a, **kw))
        return rec[-1]

    def signed(method, target, body=b"", access="OWNER", secret="sk1",
               amzacl=None):
        path, _, query = target.partition("?")
        h = {"host": "x"}
        if amzacl:
            h["x-amz-acl"] = amzacl
        out = sigv4.sign(method, path, query, h, body, access, secret)
        if amzacl:
            out["x-amz-acl"] = amzacl
        return out
    assert (await q("PUT", "/priv", headers=signed("PUT", "/priv")))[0] \
        == 200
    assert (await q("PUT", "/priv/doc", b"secret", headers=signed(
        "PUT", "/priv/doc", b"secret")))[0] == 200
    assert (await q("GET", "/priv/doc"))[0] == 403
    assert (await q("GET", "/priv/doc", headers=signed(
        "GET", "/priv/doc", access="OTHER", secret="sk2")))[0] == 403
    assert (await q("PUT", "/priv/doc2", b"x", headers=signed(
        "PUT", "/priv/doc2", b"x", access="OTHER", secret="sk2")))[0] == 403
    assert (await q("PUT", "/priv/doc?acl", headers=signed(
        "PUT", "/priv/doc?acl", amzacl="public-read")))[0] == 200
    assert (await q("GET", "/priv/doc"))[1] == b"secret"
    assert (await q("GET", "/priv"))[0] == 403
    st, xml, _, _ = await q("GET", "/priv/doc?acl",
                            headers=signed("GET", "/priv/doc?acl"))
    assert st == 200 and b"AllUsers" in xml
    assert (await q("PUT", "/priv?acl", headers=signed(
        "PUT", "/priv?acl", amzacl="public-read")))[0] == 200
    assert b"doc" in (await q("GET", "/priv"))[1]
    assert (await q("PUT", "/priv?acl", headers=signed(
        "PUT", "/priv?acl", amzacl="private")))[0] == 200
    assert (await q("PUT", "/priv/doc", b"v2", headers=signed(
        "PUT", "/priv/doc", b"v2")))[0] == 200
    assert (await q("GET", "/priv/doc"))[0] == 403
    qs = sigv4.presign("GET", "/priv/doc", "x", "OWNER", "sk1", expires=120)
    st, data, _, _ = await q("GET", f"/priv/doc?{qs}")
    assert st == 200 and data == b"v2"
    assert (await q("GET", f"/priv/doc?{qs}&evil=1"))[0] == 403
    old = sigv4.presign("GET", "/priv/doc", "x", "OWNER", "sk1",
                        expires=60, amzdate="20200101T000000Z")
    assert (await q("GET", f"/priv/doc?{old}"))[0] == 403
    bad = sigv4.presign("GET", "/priv/doc", "x", "NOBODY", "sk1",
                        expires=120)
    assert (await q("GET", f"/priv/doc?{bad}"))[0] == 403
    assert (await q("PUT", "/pub", headers=signed(
        "PUT", "/pub", amzacl="public-read")))[0] == 200
    assert (await q("PUT", "/pub/o", b"open", headers=signed(
        "PUT", "/pub/o", b"open")))[0] == 200
    assert (await q("GET", "/pub/o"))[1] == b"open"
    assert (await q("DELETE", "/pub/o"))[0] == 403


SCENARIOS = {"lifecycle": (_lifecycle, None),
             "multipart": (_multipart, None),
             "sigv4": (_sigv4, {"AKIDEXAMPLE": "secretkey"}),
             "acls": (_acls, {"OWNER": "sk1", "OTHER": "sk2"})}


def _mask(obj, ids: dict):
    """Upload ids (32 hex digits from uuid4) -> their order of
    appearance, in every str and bytes of ``obj``."""
    pat = re.compile(r"[0-9a-f]{32}")

    def sub(text: str) -> str:
        def one(m):
            # an md5 ETag is hex too: only ids the gateway handed out
            return ids.get(m.group(0), m.group(0))
        return pat.sub(one, text)
    if isinstance(obj, bytes):
        return sub(obj.decode("latin-1")).encode("latin-1")
    if isinstance(obj, str):
        return sub(obj)
    if isinstance(obj, dict):
        return {_mask(k, ids): _mask(v, ids) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_mask(x, ids) for x in obj)
    return obj


async def _scenario(which: str, name: str):
    P = _pkg(which)
    fn, users = SCENARIOS[name]
    c = await P["Cluster"](n_mons=1, n_osds=3, **P["kw"]).start()
    try:
        await c.client.pool_create("rgw", pg_num=8, size=3)
        await c.wait_for_clean(timeout=90)
        io = await c.client.open_ioctx("rgw")
        gw = P["RGWGateway"](io, users=users)
        port = await gw.start()
        rec = []
        try:
            await fn(P, port, rec)
        finally:
            await gw.stop()
        dump = await _dump(io, P["Error"])
    finally:
        await c.stop()
    ids = {}
    for _, body, _, _ in rec:
        for m in re.findall(rb"<UploadId>([0-9a-f]{32})</UploadId>", body):
            ids.setdefault(m.decode(), f"UPLOAD{len(ids):026d}")
    # sorted again once masked: the raw ids set the listing's order
    return _mask(rec, ids), sorted(_mask(dump, ids),
                                   key=lambda d: d[0]), len(ids)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gateway_script_equals_the_reference(name):
    ref, ref_dump, ref_ids = run(_scenario("ref", name))
    port, port_dump, port_ids = run(_scenario("port", name))
    assert ref_ids == port_ids
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, (i, a[:2], b[:2])
    assert [d[0] for d in port_dump] == [d[0] for d in ref_dump]
    assert port_dump == ref_dump


def test_buckets_are_served_across_packages():
    """On a reference cluster: what the reference's gateway wrote (a
    plain object, a multipart object, an ACL) reads through the port's
    gateway over a port ``Rados``, and the port's writes through the
    reference's."""
    from ceph_tpu.cluster.vstart import Cluster as RefCluster
    from ceph_tpu.rgw import RGWGateway as RefGateway
    from ceph_tpu_torch.mon.monitor import MonMap as PortMonMap
    from ceph_tpu_torch.msg import Keyring as PortKeyring
    from ceph_tpu_torch.rados import Rados as PortRados
    from ceph_tpu_torch.rgw import RGWGateway

    async def go():
        c = await RefCluster(n_mons=1, n_osds=3).start()
        rados = None
        try:
            await c.client.pool_create("rgw", pg_num=8, size=3)
            await c.wait_for_clean(timeout=90)
            monmap = PortMonMap(fsid=c.monmap.fsid)
            for name, (rank, host, p) in c.monmap.mons.items():
                monmap.add(name, rank, host, p)
            rados = PortRados(monmap,
                              keyring=PortKeyring(dict(c.keyring.keys)),
                              config=c.cfg, device="cpu")
            await rados.connect()
            ref_gw = RefGateway(await c.client.open_ioctx("rgw"))
            port_gw = RGWGateway(await rados.open_ioctx("rgw"))
            rp, pp = await ref_gw.start(), await port_gw.start()
            try:
                await _http(rp, "PUT", "/b")
                await _http(rp, "PUT", "/b/plain", b"p" * 3000,
                            headers={"x-amz-acl": "public-read"})
                xml = (await _http(rp, "POST", "/b/mp?uploads"))[1]
                up = xml.split(b"<UploadId>")[1].split(
                    b"</UploadId>")[0].decode()
                for i, part in enumerate((b"1" * 5000, b"2" * 7), 1):
                    await _http(rp, "PUT",
                                f"/b/mp?partNumber={i}&uploadId={up}", part)
                done = await _http(rp, "POST", f"/b/mp?uploadId={up}")
                for target in ("/b", "/b/plain", "/b/mp", "/b/plain?acl",
                               "/"):
                    assert await _http(pp, "GET", target) == \
                        await _http(rp, "GET", target), target
                assert (await _http(pp, "GET", "/b/mp"))[2] == \
                    done[1].split(b"<ETag>")[1].split(
                        b"</ETag>")[0].decode()
                await _http(pp, "PUT", "/b/from_port", b"q" * 999)
                await _http(pp, "DELETE", "/b/plain")
                for target in ("/b", "/b/from_port", "/b/plain"):
                    assert await _http(rp, "GET", target) == \
                        await _http(pp, "GET", target), target
                assert (await _http(rp, "GET", "/b/plain"))[0] == 404
            finally:
                await ref_gw.stop()
                await port_gw.stop()
        finally:
            if rados is not None:
                await rados.shutdown()
            await c.stop()
    run(go())
