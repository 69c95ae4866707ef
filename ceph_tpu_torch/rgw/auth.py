"""AWS Signature Version 4 for the RGW gateway.

ref: the role of src/rgw/rgw_auth_s3.cc (AWSv4ComplMulti /
rgw_create_s3_v4_canonical_request) — request signing and verification
per the published SigV4 algorithm: canonical request -> string to sign
-> HMAC chain over (date, region, service, "aws4_request").

Header-based auth (``Authorization: AWS4-HMAC-SHA256 ...``) and
presigned query auth (``X-Amz-Signature=...`` — the shareable-URL
form) are implemented; chunked payload signing is not.
Payload integrity: the ``x-amz-content-sha256`` header is required on
header-signed requests and checked against the body unless it is
``UNSIGNED-PAYLOAD``; presigned requests are UNSIGNED-PAYLOAD by
definition and carry their own expiry (``X-Amz-Expires``).

The port's copy of ``ceph_tpu/rgw/auth.py`` (the standard library only):
signatures and presigned query strings are the reference's, byte for
byte.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
from urllib.parse import parse_qsl, quote

SERVICE = "s3"
UNSIGNED = "UNSIGNED-PAYLOAD"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def signing_key(secret: str, date: str, region: str) -> bytes:
    """The AWS4 key derivation chain (date is YYYYMMDD)."""
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, SERVICE)
    return _hmac(k, "aws4_request")


def canonical_query(query: str) -> str:
    pairs = parse_qsl(query, keep_blank_values=True)
    enc = sorted((quote(k, safe="-_.~"), quote(v, safe="-_.~"))
                 for k, v in pairs)
    return "&".join(f"{k}={v}" for k, v in enc)


def canonical_request(method: str, path: str, query: str,
                      headers: dict[str, str],
                      signed_headers: list[str],
                      payload_hash: str) -> str:
    ch = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([
        method.upper(),
        quote(path, safe="/-_.~"),
        canonical_query(query),
        ch,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(amzdate: str, scope: str, creq: str) -> str:
    return "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                      _sha256(creq.encode())])


def sign(method: str, path: str, query: str, headers: dict[str, str],
         payload: bytes, access: str, secret: str,
         region: str = "us-east-1",
         amzdate: str | None = None) -> dict[str, str]:
    """Client side: returns the headers to add (x-amz-date,
    x-amz-content-sha256, authorization). ``headers`` must already
    contain everything to be signed (at least ``host``)."""
    if amzdate is None:
        amzdate = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
    date = amzdate[:8]
    payload_hash = _sha256(payload)
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = amzdate
    hdrs["x-amz-content-sha256"] = payload_hash
    signed = sorted(hdrs)
    creq = canonical_request(method, path, query, hdrs, signed,
                             payload_hash)
    scope = f"{date}/{region}/{SERVICE}/aws4_request"
    sig = hmac.new(signing_key(secret, date, region),
                   string_to_sign(amzdate, scope, creq).encode(),
                   hashlib.sha256).hexdigest()
    auth = (f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return {"x-amz-date": amzdate, "x-amz-content-sha256": payload_hash,
            "authorization": auth}


def verify(method: str, path: str, query: str, headers: dict[str, str],
           payload: bytes, secrets: dict[str, str],
           max_skew_s: float = 900.0) -> tuple[bool, str]:
    """Server side: (ok, reason). ``headers`` keys must be lower-case
    (the gateway's parser lower-cases them). Requests whose
    ``x-amz-date`` is more than ``max_skew_s`` from now are rejected —
    the replay window (ref: rgw's RGW_AUTH_GRACE clock-skew check)."""
    auth = headers.get("authorization", "")
    if not auth.startswith("AWS4-HMAC-SHA256 "):
        return False, "missing or non-SigV4 Authorization"
    fields = {}
    for part in auth[len("AWS4-HMAC-SHA256 "):].split(","):
        k, _, v = part.strip().partition("=")
        fields[k] = v
    try:
        cred = fields["Credential"].split("/")
        access, date, region, service, terminal = cred
        signed = fields["SignedHeaders"].split(";")
        given = fields["Signature"]
    except (KeyError, ValueError):
        return False, "malformed Authorization"
    if service != SERVICE or terminal != "aws4_request":
        return False, "bad credential scope"
    secret = secrets.get(access)
    if secret is None:
        return False, "unknown access key"
    amzdate = headers.get("x-amz-date", "")
    if amzdate[:8] != date:
        return False, "x-amz-date does not match credential date"
    try:
        when = datetime.datetime.strptime(
            amzdate, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=datetime.timezone.utc)
    except ValueError:
        return False, "malformed x-amz-date"
    now = datetime.datetime.now(datetime.timezone.utc)
    if abs((now - when).total_seconds()) > max_skew_s:
        return False, "request time outside the replay window"
    payload_hash = headers.get("x-amz-content-sha256", "")
    if not payload_hash:
        return False, "missing x-amz-content-sha256"
    if payload_hash != UNSIGNED and payload_hash != _sha256(payload):
        return False, "payload hash mismatch"
    creq = canonical_request(method, path, query, headers, signed,
                             payload_hash)
    scope = f"{date}/{region}/{SERVICE}/aws4_request"
    want = hmac.new(signing_key(secret, date, region),
                    string_to_sign(amzdate, scope, creq).encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, given):
        return False, "signature mismatch"
    return True, access


def presign(method: str, path: str, host: str, access: str,
            secret: str, expires: int = 3600,
            region: str = "us-east-1", query: str = "",
            amzdate: str | None = None) -> str:
    """Client side: the full query string of a presigned URL (ref: the
    GET-object sharing flow rgw serves for radosgw-admin-issued keys).
    Signs method+path+query with the payload pinned UNSIGNED-PAYLOAD
    and only ``host`` in SignedHeaders, per the SigV4 query spec."""
    if amzdate is None:
        amzdate = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
    date = amzdate[:8]
    scope = f"{date}/{region}/{SERVICE}/aws4_request"
    q = list(parse_qsl(query, keep_blank_values=True))
    q += [("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
          ("X-Amz-Credential", f"{access}/{scope}"),
          ("X-Amz-Date", amzdate),
          ("X-Amz-Expires", str(int(expires))),
          ("X-Amz-SignedHeaders", "host")]
    qs = "&".join(f"{quote(k, safe='-_.~')}={quote(v, safe='-_.~')}"
                  for k, v in q)
    creq = canonical_request(method, path, qs, {"host": host},
                             ["host"], UNSIGNED)
    sig = hmac.new(signing_key(secret, date, region),
                   string_to_sign(amzdate, scope, creq).encode(),
                   hashlib.sha256).hexdigest()
    return qs + f"&X-Amz-Signature={sig}"


def verify_presigned(method: str, path: str, query: str,
                     headers: dict[str, str],
                     secrets: dict[str, str]) -> tuple[bool, str]:
    """Server side for X-Amz-Signature query auth: (ok, access|reason).

    The canonical request re-signs every query pair EXCEPT
    X-Amz-Signature itself; expiry comes from X-Amz-Date +
    X-Amz-Expires rather than the fixed clock-skew window."""
    pairs = parse_qsl(query, keep_blank_values=True)
    params = dict(pairs)
    given = params.get("X-Amz-Signature")
    if not given:
        return False, "missing X-Amz-Signature"
    if params.get("X-Amz-Algorithm") != "AWS4-HMAC-SHA256":
        return False, "unsupported X-Amz-Algorithm"
    try:
        access, date, region, service, terminal = \
            params["X-Amz-Credential"].split("/")
        amzdate = params["X-Amz-Date"]
        expires = int(params["X-Amz-Expires"])
        signed = params["X-Amz-SignedHeaders"].split(";")
    except (KeyError, ValueError):
        return False, "malformed presigned parameters"
    if service != SERVICE or terminal != "aws4_request":
        return False, "bad credential scope"
    # SigV4 query-auth bounds: expiry must be positive and at most 7
    # days (ref: rgw's X-Amz-Expires validation) — otherwise a key
    # holder can mint effectively never-expiring URLs
    if expires <= 0 or expires > 604800:
        return False, "X-Amz-Expires out of range (0, 604800]"
    # a presigned signature not bound to the host header could be
    # replayed against another endpoint sharing the key
    if "host" not in signed:
        return False, "SignedHeaders must include host"
    if amzdate[:8] != date:
        return False, "X-Amz-Date does not match credential date"
    secret = secrets.get(access)
    if secret is None:
        return False, "unknown access key"
    try:
        when = datetime.datetime.strptime(
            amzdate, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=datetime.timezone.utc)
    except ValueError:
        return False, "malformed X-Amz-Date"
    now = datetime.datetime.now(datetime.timezone.utc)
    age = (now - when).total_seconds()
    if age > expires or age < -900:
        return False, "presigned URL expired"
    qs = "&".join(f"{quote(k, safe='-_.~')}={quote(v, safe='-_.~')}"
                  for k, v in pairs if k != "X-Amz-Signature")
    creq = canonical_request(method, path, qs, headers, signed,
                             UNSIGNED)
    scope = f"{date}/{region}/{SERVICE}/aws4_request"
    want = hmac.new(signing_key(secret, date, region),
                    string_to_sign(amzdate, scope, creq).encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, given):
        return False, "signature mismatch"
    return True, access
