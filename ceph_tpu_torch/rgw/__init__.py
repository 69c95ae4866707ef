"""RGW-lite: an S3-subset HTTP object gateway over RADOS.

ref: src/rgw/ (RGWRados + the beast frontend + RGWOp hierarchy) —
rebuilt small: an asyncio HTTP frontend translating the core S3
operations onto one backing pool. Buckets are omap *bucket index*
objects (ref: RGW bucket index shards); object payloads live in
``<bucket>/<key>`` RADOS objects. XML response shapes follow S3's
ListAllMyBucketsResult / ListBucketResult so s3-style clients parse
them.

Multipart uploads follow RGW's manifest design: parts stay
as their own RADOS objects and Complete writes a *manifest* into the
bucket index (ref: RGWObjManifest) — GET streams the parts in order;
nothing is ever re-concatenated at rest. The multipart ETag is the S3
convention md5(concat(binary part md5s))-N.

Auth: AWS Signature V4 header auth (``rgw/auth.py``).
Construct the gateway with ``users={access: secret}`` to require a
valid signature on every request (403 AccessDenied otherwise); omit
it for anonymous mode.

Presigned URLs (SigV4 query auth — ``auth.presign`` issues,
the gateway verifies and expires them) and canned ACLs (``private`` /
``public-read`` at bucket and object level via ``x-amz-acl`` and the
``?acl`` sub-resource; writes are owner-only, public-read admits
anonymous GETs — ref: RGWAccessControlPolicy reduced to the two
grants that matter).

Supported: PUT/DELETE bucket, GET / (list buckets), PUT/GET/HEAD/
DELETE object, GET bucket (list objects), multipart
initiate/upload-part/list-parts/list-uploads/complete/abort, SigV4
header + presigned query auth, canned ACLs.
Not built: versioning, multisite replication, full grantee lists.

The port's copy of ``ceph_tpu/rgw/__init__.py``. The gateway holds no
device state of its own: its buckets and objects live on the ``IoCtx``
it is given, and the ``Rados`` that opened it owns the device
(``Rados(device=)``, CUDA unless ``"cpu"``). Index rows, object names,
manifests and ETags are the reference's, so either package's gateway
serves the other's buckets.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import re
import uuid
from urllib.parse import parse_qsl, unquote
from xml.sax.saxutils import escape

from ceph_tpu_torch.rados import IoCtx, ObjectOperationError
from ceph_tpu_torch.rgw import auth as sigv4
from ceph_tpu_torch.utils.locks import KeyedLocks
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("rgw")

BUCKETS_ROOT = ".rgw.buckets"          # omap: bucket name -> b"1"


def _index(bucket: str) -> str:
    return f".bucket.{bucket}"


def _obj(bucket: str, key: str) -> str:
    return f"{bucket}/{key}"


def _part_obj(bucket: str, upload_id: str, n: int) -> str:
    return f".mp.{bucket}.{upload_id}.{n}"


class RGWGateway:
    """ref: RGWHTTPFrontend + RGWOp dispatch."""

    def __init__(self, ioctx: IoCtx,
                 users: dict[str, str] | None = None):
        self.ioctx = ioctx
        self.users = users or {}
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None
        # Serialize mutations of one (bucket, key): object PUT/DELETE,
        # part uploads, and multipart complete/abort are
        # read-modify-write sequences over the bucket-index manifest
        # row — racing them can leave a manifest referencing part
        # objects the other path just removed (GET then 500s) or
        # orphan parts. Single-process gateway, so in-memory locks
        # suffice (the reference shards this through the bucket-index
        # OSD class ops).
        self._key_locks = KeyedLocks()

    def _key_lock(self, bucket: str, key: str):
        return self._key_locks.hold((bucket, key))

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> int:
        self._server = await asyncio.start_server(self._serve, host,
                                                  port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.dout(1, f"rgw listening on :{self.port}")
        return self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()

    # -- http plumbing -----------------------------------------------------
    async def _serve(self, reader, writer) -> None:
        try:
            req = await asyncio.wait_for(reader.readline(), timeout=10)
            if not req:
                return
            method, target, _ = req.decode().split(" ", 2)
            headers: dict[str, str] = {}
            while True:
                line = await asyncio.wait_for(reader.readline(),
                                              timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", 0))
            if n:
                body = await asyncio.wait_for(reader.readexactly(n),
                                              timeout=30)
            raw_path, _, query = target.partition("?")
            status, ctype, payload, extra = await self._dispatch(
                method.upper(), unquote(raw_path), query, headers, body)
            # HEAD handlers advertise the real object size via an
            # explicit Content-Length override (body stays empty)
            clen = extra.pop("Content-Length", len(payload))
            hdr_lines = "".join(f"{k}: {v}\r\n" for k, v in extra.items())
            writer.write(
                f"HTTP/1.1 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {clen}\r\n{hdr_lines}"
                f"Connection: close\r\n\r\n".encode() + payload)
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError, OSError, ValueError) as e:
            log.dout(5, f"rgw client error: {e}")
        finally:
            writer.close()

    # -- authn/authz (ref: RGWHandler_REST auth + RGWAccessControlPolicy) --
    _DENIED = ("403 Forbidden", "application/xml",
               b"<Error><Code>AccessDenied</Code></Error>", {})

    async def _bucket_meta(self, bucket: str) -> dict | None:
        """Owner + canned ACL of a bucket ({'owner':..., 'acl':...}),
        or None when the bucket does not exist. Legacy b'1' rows read
        as ownerless/private (any authenticated principal passes)."""
        try:
            rows = await self.ioctx.get_omap_vals(BUCKETS_ROOT,
                                                  prefix=bucket)
        except ObjectOperationError:
            return None                  # no bucket root object yet
        raw = rows.get(bucket)
        if raw is None:
            return None
        if raw == b"1":
            return {"owner": "", "acl": "private"}
        return json.loads(raw)

    async def _authz(self, ident: str | None, bucket: str, key: str,
                     write: bool, meta: dict | None) -> bool:
        """Canned-ACL policy check (only when auth is configured):
        writes are owner-only; reads pass for the owner or when the
        bucket (or, for objects, the object) is public-read — which
        also admits anonymous principals, the presigned-URL
        complement. ``meta`` is the bucket meta the dispatcher already
        resolved (one read per request, shared with the acl
        handlers)."""
        if meta is None:
            return True                  # let handlers return NoSuchBucket
        owner = meta.get("owner", "")
        if ident is not None and (not owner or ident == owner):
            return True
        if write:
            return False
        if meta.get("acl") == "public-read":
            return True
        if key:
            try:
                oacl = await self.ioctx.get_omap_vals(
                    _index(bucket), prefix=f"a:{key}")
            except ObjectOperationError:
                return False
            if oacl.get(f"a:{key}") == b"public-read":
                return True
        return False

    # -- op dispatch (ref: RGWOp subclasses) --------------------------------
    async def _dispatch(self, method: str, path: str, query: str,
                        headers: dict[str, str],
                        body: bytes) -> tuple[str, str, bytes, dict]:
        q = dict(parse_qsl(query, keep_blank_values=True))
        ident: str | None = None
        if self.users:
            if "X-Amz-Signature" in q:
                ok, who = sigv4.verify_presigned(method, path, query,
                                                 headers, self.users)
            elif "authorization" in headers:
                ok, who = sigv4.verify(method, path, query, headers,
                                       body, self.users)
            else:
                ok, who = True, None     # anonymous: ACLs gate below
            if not ok:
                log.dout(5, f"sigv4 reject: {who}")
                return self._DENIED
            ident = who
        parts = [p for p in path.split("/") if p]
        try:
            if not parts:
                if method == "GET":
                    if self.users and ident is None:
                        return self._DENIED  # service op: no anonymous
                    return await self._list_buckets()   # bucket survey
                return "405 Method Not Allowed", "text/plain", b"", {}
            bucket = parts[0]
            key = "/".join(parts[1:])
            meta = None
            if self.users or "acl" in q:
                meta = await self._bucket_meta(bucket)
            if self.users:
                write = method not in ("GET", "HEAD")
                if not await self._authz(ident, bucket, key, write,
                                         meta):
                    return self._DENIED
            if not key:
                # ?acl sub-resource FIRST: a plain-PUT match would
                # turn PUT /bucket?acl into bucket creation
                if method == "GET" and "acl" in q:
                    return await self._get_acl(bucket, "", meta)
                if method == "PUT" and "acl" in q:
                    return await self._put_acl(
                        bucket, "", headers.get("x-amz-acl", "private"),
                        meta)
                if method == "PUT":
                    return await self._create_bucket(
                        bucket, ident,
                        headers.get("x-amz-acl", "private"))
                if method == "DELETE":
                    return await self._delete_bucket(bucket)
                if method == "GET" and "uploads" in q:
                    return await self._list_uploads(bucket)
                if method == "GET":
                    return await self._list_objects(bucket)
                return "405 Method Not Allowed", "text/plain", b"", {}
            if method == "GET" and "acl" in q:
                return await self._get_acl(bucket, key, meta)
            if method == "PUT" and "acl" in q:
                return await self._put_acl(
                    bucket, key, headers.get("x-amz-acl", "private"),
                    meta)
            if method == "POST" and "uploads" in q:
                return await self._initiate_multipart(bucket, key)
            if method == "POST" and "uploadId" in q:
                async with self._key_lock(bucket, key):
                    return await self._complete_multipart(
                        bucket, key, q["uploadId"], body)
            if method == "PUT" and "uploadId" in q:
                pn = q.get("partNumber", "")
                if not pn.isdigit():
                    return ("400 Bad Request", "application/xml",
                            b"<Error><Code>InvalidPartNumber</Code>"
                            b"</Error>", {})
                # under the key lock: a part landing after a racing
                # abort removed the upload meta would re-create the
                # part object + index row with nothing left to ever
                # clean them up
                async with self._key_lock(bucket, key):
                    return await self._put_part(
                        bucket, key, q["uploadId"], int(pn), body)
            if method == "DELETE" and "uploadId" in q:
                async with self._key_lock(bucket, key):
                    return await self._abort_multipart(bucket, key,
                                                       q["uploadId"])
            if method == "GET" and "uploadId" in q:
                return await self._list_parts(bucket, key,
                                              q["uploadId"])
            if method == "PUT":
                async with self._key_lock(bucket, key):
                    return await self._put_object(
                        bucket, key, body,
                        acl=headers.get("x-amz-acl"))
            if method == "GET":
                return await self._get_object(bucket, key)
            if method == "HEAD":
                return await self._get_object(bucket, key, head=True)
            if method == "DELETE":
                async with self._key_lock(bucket, key):
                    return await self._delete_object(bucket, key)
            return "405 Method Not Allowed", "text/plain", b"", {}
        except ObjectOperationError as e:
            if e.errno == -2:
                return "404 Not Found", "application/xml", \
                    b"<Error><Code>NoSuchKey</Code></Error>", {}
            return "500 Internal Server Error", "text/plain", \
                str(e).encode(), {}

    async def _bucket_exists(self, bucket: str) -> bool:
        try:
            omap = await self.ioctx.get_omap_vals(BUCKETS_ROOT)
        except ObjectOperationError:
            return False
        return bucket in omap

    async def _list_buckets(self):
        try:
            omap = await self.ioctx.get_omap_vals(BUCKETS_ROOT)
        except ObjectOperationError:
            omap = {}
        items = "".join(
            f"<Bucket><Name>{escape(b)}</Name></Bucket>"
            for b in sorted(omap))
        xml = (f'<?xml version="1.0"?><ListAllMyBucketsResult>'
               f"<Buckets>{items}</Buckets>"
               f"</ListAllMyBucketsResult>")
        return "200 OK", "application/xml", xml.encode(), {}

    async def _create_bucket(self, bucket: str, owner: str | None = None,
                             acl: str = "private"):
        if self.users and owner is None:
            return self._DENIED          # anonymous cannot own a bucket
        if acl not in ("private", "public-read"):
            acl = "private"
        meta = json.dumps({"owner": owner or "", "acl": acl}).encode()
        await self.ioctx.set_omap(BUCKETS_ROOT, bucket, meta)
        await self.ioctx.set_omap(_index(bucket), "_created", b"1")
        return "200 OK", "application/xml", b"", {}

    async def _key_exists(self, bucket: str, key: str) -> bool:
        try:
            rows = await self.ioctx.get_omap_vals(_index(bucket),
                                                  prefix=f"k:{key}")
        except ObjectOperationError:
            return False
        return f"k:{key}" in rows

    async def _get_acl(self, bucket: str, key: str,
                       meta: dict | None = None):
        if meta is None:
            meta = await self._bucket_meta(bucket)
        if meta is None:
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchBucket</Code></Error>", {}
        acl = meta.get("acl", "private")
        if key:
            if not await self._key_exists(bucket, key):
                return "404 Not Found", "application/xml", \
                    b"<Error><Code>NoSuchKey</Code></Error>", {}
            rows = await self.ioctx.get_omap_vals(_index(bucket),
                                                  prefix=f"a:{key}")
            oacl = rows.get(f"a:{key}")
            if oacl is not None:
                acl = oacl.decode()
        grants = ('<Grant><Grantee>owner</Grantee>'
                  '<Permission>FULL_CONTROL</Permission></Grant>')
        if acl == "public-read":
            grants += ('<Grant><Grantee>AllUsers</Grantee>'
                       '<Permission>READ</Permission></Grant>')
        xml = (f'<?xml version="1.0"?><AccessControlPolicy>'
               f"<Owner><ID>{escape(meta.get('owner', ''))}</ID></Owner>"
               f"<AccessControlList>{grants}</AccessControlList>"
               f"</AccessControlPolicy>")
        return "200 OK", "application/xml", xml.encode(), {}

    async def _put_acl(self, bucket: str, key: str, acl: str,
                       meta: dict | None = None):
        if meta is None:
            meta = await self._bucket_meta(bucket)
        if meta is None:
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchBucket</Code></Error>", {}
        if acl not in ("private", "public-read"):
            return ("400 Bad Request", "application/xml",
                    b"<Error><Code>InvalidArgument</Code></Error>", {})
        if key:
            if not await self._key_exists(bucket, key):
                return "404 Not Found", "application/xml", \
                    b"<Error><Code>NoSuchKey</Code></Error>", {}
            await self.ioctx.set_omap(_index(bucket), f"a:{key}",
                                      acl.encode())
        else:
            meta["acl"] = acl
            await self.ioctx.set_omap(BUCKETS_ROOT, bucket,
                                      json.dumps(meta).encode())
        return "200 OK", "application/xml", b"", {}

    async def _delete_bucket(self, bucket: str):
        if not await self._bucket_exists(bucket):
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchBucket</Code></Error>", {}
        idx = await self.ioctx.get_omap_vals(_index(bucket))
        if any(k.startswith("k:") for k in idx):
            return "409 Conflict", "application/xml", \
                b"<Error><Code>BucketNotEmpty</Code></Error>", {}
        await self.ioctx.remove(_index(bucket))
        await self.ioctx.rm_omap_key(BUCKETS_ROOT, bucket)
        return "204 No Content", "application/xml", b"", {}

    async def _list_objects(self, bucket: str):
        if not await self._bucket_exists(bucket):
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchBucket</Code></Error>", {}
        idx = await self.ioctx.get_omap_vals(_index(bucket))
        items = "".join(
            f"<Contents><Key>{escape(k[2:])}</Key>"
            f"<Size>{int.from_bytes(v, 'little')}</Size></Contents>"
            for k, v in sorted(idx.items())
            if k.startswith("k:"))
        xml = (f'<?xml version="1.0"?><ListBucketResult>'
               f"<Name>{escape(bucket)}</Name>{items}"
               f"</ListBucketResult>")
        return "200 OK", "application/xml", xml.encode(), {}

    async def _put_object(self, bucket: str, key: str, body: bytes,
                          acl: str | None = None):
        if not await self._bucket_exists(bucket):
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchBucket</Code></Error>", {}
        await self._drop_manifest(bucket, key)
        await self.ioctx.write_full(_obj(bucket, key), body)
        # "k:" prefix keeps user keys out of the index meta namespace
        await self.ioctx.set_omap(_index(bucket), f"k:{key}",
                                  len(body).to_bytes(8, "little"))
        if acl in ("private", "public-read"):
            await self.ioctx.set_omap(_index(bucket), f"a:{key}",
                                      acl.encode())
        else:                    # overwrite clears any stale object acl
            try:
                await self.ioctx.rm_omap_key(_index(bucket), f"a:{key}")
            except ObjectOperationError:
                pass
        etag = hashlib.md5(body).hexdigest()
        return "200 OK", "application/xml", b"", {"ETag": f'"{etag}"'}

    async def _manifest(self, bucket: str, key: str,
                        idx: dict | None = None) -> dict | None:
        if idx is None:
            # prefix fetch: the OSD ships only this key's manifest row,
            # not the whole bucket index (hot GET path)
            idx = await self.ioctx.get_omap_vals(_index(bucket),
                                                 prefix=f"m:{key}")
        raw = idx.get(f"m:{key}")
        return json.loads(raw) if raw else None

    async def _drop_manifest(self, bucket: str, key: str,
                             idx: dict | None = None) -> None:
        """Overwriting / deleting a multipart object must free its
        part objects (ref: RGWRados gc on manifest replace)."""
        try:
            man = await self._manifest(bucket, key, idx)
        except ObjectOperationError:
            return
        if not man:
            return
        for part_oid, _ in man["parts"]:
            try:
                await self.ioctx.remove(part_oid)
            except ObjectOperationError:
                pass
        await self.ioctx.rm_omap_key(_index(bucket), f"m:{key}")

    async def _get_object(self, bucket: str, key: str,
                          head: bool = False):
        try:
            man = await self._manifest(bucket, key)
        except ObjectOperationError:
            man = None
        if man:
            if head:
                total = sum(s for _, s in man["parts"])
                return ("200 OK", "application/octet-stream", b"",
                        {"ETag": f'"{man["etag"]}"',
                         "Content-Length": total})
            chunks = [await self.ioctx.read(oid)
                      for oid, _ in man["parts"]]
            return ("200 OK", "application/octet-stream",
                    b"".join(chunks), {"ETag": f'"{man["etag"]}"'})
        if head:     # stat, don't transfer (HEAD of a large object)
            size = await self.ioctx.stat(_obj(bucket, key))
            return ("200 OK", "application/octet-stream", b"",
                    {"Content-Length": size})
        data = await self.ioctx.read(_obj(bucket, key))
        return "200 OK", "application/octet-stream", data, {}

    async def _delete_object(self, bucket: str, key: str):
        await self._drop_manifest(bucket, key)
        try:
            await self.ioctx.remove(_obj(bucket, key))
        except ObjectOperationError:
            pass
        for row in (f"k:{key}", f"a:{key}"):
            try:
                await self.ioctx.rm_omap_key(_index(bucket), row)
            except ObjectOperationError:
                pass
        return "204 No Content", "application/xml", b"", {}

    # -- multipart (ref: RGWPutObjProcessor_Multipart + RGWObjManifest) ----
    async def _initiate_multipart(self, bucket: str, key: str):
        if not await self._bucket_exists(bucket):
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchBucket</Code></Error>", {}
        upload_id = uuid.uuid4().hex
        await self.ioctx.set_omap(
            _index(bucket), f"u:{upload_id}",
            json.dumps({"key": key}).encode())
        xml = (f'<?xml version="1.0"?><InitiateMultipartUploadResult>'
               f"<Bucket>{escape(bucket)}</Bucket>"
               f"<Key>{escape(key)}</Key>"
               f"<UploadId>{upload_id}</UploadId>"
               f"</InitiateMultipartUploadResult>")
        return "200 OK", "application/xml", xml.encode(), {}

    async def _upload_meta(self, bucket: str, upload_id: str):
        idx = await self.ioctx.get_omap_vals(_index(bucket))
        raw = idx.get(f"u:{upload_id}")
        return (json.loads(raw) if raw else None), idx

    async def _put_part(self, bucket: str, key: str, upload_id: str,
                        part_num: int, body: bytes):
        meta, _ = await self._upload_meta(bucket, upload_id)
        if meta is None or meta["key"] != key:
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchUpload</Code></Error>", {}
        if part_num < 1 or part_num > 10000:
            return "400 Bad Request", "application/xml", \
                b"<Error><Code>InvalidPartNumber</Code></Error>", {}
        etag = hashlib.md5(body).hexdigest()
        await self.ioctx.write_full(_part_obj(bucket, upload_id,
                                              part_num), body)
        await self.ioctx.set_omap(
            _index(bucket), f"up:{upload_id}:{part_num:05d}",
            json.dumps({"etag": etag, "size": len(body)}).encode())
        return "200 OK", "application/xml", b"", {"ETag": f'"{etag}"'}

    async def _list_parts(self, bucket: str, key: str, upload_id: str):
        meta, idx = await self._upload_meta(bucket, upload_id)
        if meta is None or meta["key"] != key:
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchUpload</Code></Error>", {}
        pfx = f"up:{upload_id}:"
        rows = []
        for k, v in sorted(idx.items()):
            if k.startswith(pfx):
                info = json.loads(v)
                rows.append(
                    f"<Part><PartNumber>{int(k[len(pfx):])}</PartNumber>"
                    f'<ETag>"{info["etag"]}"</ETag>'
                    f"<Size>{info['size']}</Size></Part>")
        xml = (f'<?xml version="1.0"?><ListPartsResult>'
               f"<Bucket>{escape(bucket)}</Bucket>"
               f"<Key>{escape(key)}</Key>"
               f"<UploadId>{upload_id}</UploadId>{''.join(rows)}"
               f"</ListPartsResult>")
        return "200 OK", "application/xml", xml.encode(), {}

    async def _list_uploads(self, bucket: str):
        if not await self._bucket_exists(bucket):
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchBucket</Code></Error>", {}
        idx = await self.ioctx.get_omap_vals(_index(bucket))
        rows = []
        for k, v in sorted(idx.items()):
            if k.startswith("u:"):
                meta = json.loads(v)
                rows.append(
                    f"<Upload><Key>{escape(meta['key'])}</Key>"
                    f"<UploadId>{k[2:]}</UploadId></Upload>")
        xml = (f'<?xml version="1.0"?><ListMultipartUploadsResult>'
               f"<Bucket>{escape(bucket)}</Bucket>{''.join(rows)}"
               f"</ListMultipartUploadsResult>")
        return "200 OK", "application/xml", xml.encode(), {}

    async def _complete_multipart(self, bucket: str, key: str,
                                  upload_id: str, body: bytes):
        meta, idx = await self._upload_meta(bucket, upload_id)
        if meta is None or meta["key"] != key:
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchUpload</Code></Error>", {}
        # The client's CompleteMultipartUpload body lists the parts it
        # wants in order with their ETags; parse <Part> blocks loosely
        # like rgw does for dialect tolerance, falling back to "all
        # uploaded parts" when the body names none.
        text = body.decode(errors="replace")
        listed = []
        for blk in re.findall(r"<Part>(.*?)</Part>", text, re.S):
            pn = re.search(r"<PartNumber>\s*(\d+)\s*</PartNumber>", blk)
            et = re.search(r"<ETag>\s*\"?([0-9a-fA-F]+)\"?\s*</ETag>",
                           blk)
            if pn:
                listed.append((int(pn.group(1)),
                               et.group(1).lower() if et else None))
        pfx = f"up:{upload_id}:"
        have = {int(k[len(pfx):]): json.loads(v)
                for k, v in idx.items() if k.startswith(pfx)}
        order = [n for n, _ in listed] or sorted(have)
        if not order or any(n not in have for n in order):
            return "400 Bad Request", "application/xml", \
                b"<Error><Code>InvalidPart</Code></Error>", {}
        # a client-supplied ETag must match the stored part's
        if any(e is not None and e != have[n]["etag"]
               for n, e in listed):
            return "400 Bad Request", "application/xml", \
                b"<Error><Code>InvalidPart</Code></Error>", {}
        # parts must be listed in strictly ascending order, no dups
        if any(b <= a for a, b in zip(order, order[1:])):
            return "400 Bad Request", "application/xml", \
                b"<Error><Code>InvalidPartOrder</Code></Error>", {}
        parts = [[_part_obj(bucket, upload_id, n), have[n]["size"]]
                 for n in order]
        total = sum(s for _, s in parts)
        md5s = b"".join(bytes.fromhex(have[n]["etag"]) for n in order)
        etag = f"{hashlib.md5(md5s).hexdigest()}-{len(order)}"
        await self._drop_manifest(bucket, key, idx)  # overwrite semantics
        try:
            # a simple object previously at this key is replaced by the
            # manifest — free its base RADOS object too
            await self.ioctx.remove(_obj(bucket, key))
        except ObjectOperationError:
            pass
        await self.ioctx.set_omap(
            _index(bucket), f"m:{key}",
            json.dumps({"parts": parts, "etag": etag}).encode())
        await self.ioctx.set_omap(_index(bucket), f"k:{key}",
                                  total.to_bytes(8, "little"))
        try:     # like plain PUT: replacing the object clears any
            await self.ioctx.rm_omap_key(     # stale per-object acl
                _index(bucket), f"a:{key}")
        except ObjectOperationError:
            pass
        # drop upload bookkeeping (parts live on, referenced by the
        # manifest); unlisted parts are garbage-collected now
        for n in sorted(have):
            if n not in order:
                try:
                    await self.ioctx.remove(
                        _part_obj(bucket, upload_id, n))
                except ObjectOperationError:
                    pass
            await self.ioctx.rm_omap_key(_index(bucket),
                                         f"up:{upload_id}:{n:05d}")
        await self.ioctx.rm_omap_key(_index(bucket), f"u:{upload_id}")
        xml = (f'<?xml version="1.0"?><CompleteMultipartUploadResult>'
               f"<Bucket>{escape(bucket)}</Bucket>"
               f"<Key>{escape(key)}</Key>"
               f'<ETag>"{etag}"</ETag>'
               f"</CompleteMultipartUploadResult>")
        return "200 OK", "application/xml", xml.encode(), {}

    async def _abort_multipart(self, bucket: str, key: str,
                               upload_id: str):
        meta, idx = await self._upload_meta(bucket, upload_id)
        if meta is None or meta["key"] != key:
            return "404 Not Found", "application/xml", \
                b"<Error><Code>NoSuchUpload</Code></Error>", {}
        pfx = f"up:{upload_id}:"
        for k in idx:
            if k.startswith(pfx):
                n = int(k[len(pfx):])
                try:
                    await self.ioctx.remove(
                        _part_obj(bucket, upload_id, n))
                except ObjectOperationError:
                    pass
                await self.ioctx.rm_omap_key(_index(bucket), k)
        await self.ioctx.rm_omap_key(_index(bucket), f"u:{upload_id}")
        return "204 No Content", "application/xml", b"", {}
