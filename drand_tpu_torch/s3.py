"""Minimal S3 REST client — pure stdlib, AWS Signature V4.

The reference ships an S3 relay built on the AWS SDK
(cmd/relay-s3/main.go:43-199).  boto3 is not available in this
environment, so the backend speaks the S3 REST API directly over
urllib with SigV4 request signing: PUT/GET/HEAD object is all the relay
needs.  The endpoint is configurable, so the same code path serves AWS,
any S3-compatible store, and the in-suite fake server.

The port's copy of drand_tpu/s3.py, unchanged.
"""

import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class SigV4Signer:
    """AWS Signature Version 4 for the S3 service (single-chunk payloads)."""

    def __init__(self, access_key: str, secret_key: str, region: str):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def sign(self, method: str, url: str, headers: Dict[str, str],
             payload: bytes, now: Optional[datetime.datetime] = None
             ) -> Dict[str, str]:
        """Returns `headers` + Authorization/x-amz-* for the request."""
        u = urllib.parse.urlsplit(url)
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amzdate = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = _sha256(payload)
        hdrs = dict(headers)
        hdrs["host"] = u.netloc
        hdrs["x-amz-date"] = amzdate
        hdrs["x-amz-content-sha256"] = payload_hash

        signed = sorted(k.lower() for k in hdrs)
        canonical_headers = "".join(
            f"{k}:{hdrs[_orig(hdrs, k)].strip()}\n" for k in signed)
        signed_headers = ";".join(signed)
        canonical_query = "&".join(
            f"{k}={urllib.parse.quote(v, safe='~')}"
            for k, v in sorted(urllib.parse.parse_qsl(
                u.query, keep_blank_values=True)))
        # S3 canonical URIs must NOT be double-encoded: u.path is already
        # percent-encoded by _url(), so it goes in verbatim (re-quoting
        # would corrupt keys containing space/%/non-ASCII).
        canonical = "\n".join([
            method, u.path or "/",
            canonical_query, canonical_headers, signed_headers, payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                             _sha256(canonical.encode())])
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        hdrs["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={sig}")
        return hdrs


def _orig(hdrs: Dict[str, str], lower: str) -> str:
    for k in hdrs:
        if k.lower() == lower:
            return k
    raise KeyError(lower)


class S3Client:
    """PUT/GET/HEAD object against an S3(-compatible) endpoint.

    Credentials default to the standard AWS_* environment variables; the
    endpoint defaults to the AWS virtual-hosted S3 URL for the region."""

    def __init__(self, bucket: str, region: str = "us-east-1",
                 endpoint: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None):
        self.bucket = bucket
        self.region = region
        self.endpoint = (endpoint or
                         f"https://{bucket}.s3.{region}.amazonaws.com")
        self._path_style = endpoint is not None
        self.signer = SigV4Signer(
            access_key or os.environ.get("AWS_ACCESS_KEY_ID", ""),
            secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", ""),
            region)

    def _url(self, key: str) -> str:
        base = self.endpoint.rstrip("/")
        if self._path_style:
            return f"{base}/{self.bucket}/{urllib.parse.quote(key)}"
        return f"{base}/{urllib.parse.quote(key)}"

    def _request(self, method: str, key: str, payload: bytes = b"",
                 headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, bytes]:
        url = self._url(key)
        hdrs = self.signer.sign(method, url, headers or {}, payload)
        req = urllib.request.Request(url, data=payload or None,
                                     headers=hdrs, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def put_object(self, key: str, data: bytes, content_type: str,
                   acl: str = "public-read",
                   cache_control: Optional[str] = None) -> None:
        hdrs = {"content-type": content_type, "x-amz-acl": acl}
        if cache_control:
            hdrs["cache-control"] = cache_control
        status, body = self._request("PUT", key, data, hdrs)
        if status not in (200, 201):
            raise IOError(f"S3 PUT {key}: HTTP {status}: {body[:200]!r}")

    def get_object(self, key: str) -> Optional[bytes]:
        status, body = self._request("GET", key)
        if status == 404:
            return None
        if status != 200:
            raise IOError(f"S3 GET {key}: HTTP {status}")
        return body

    def head_object(self, key: str) -> bool:
        status, _ = self._request("HEAD", key)
        if status == 200:
            return True
        if status in (403, 404):
            return False
        raise IOError(f"S3 HEAD {key}: HTTP {status}")
