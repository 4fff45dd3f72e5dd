"""REST auth providers: bearer tokens and DLF-style HMAC request signing.

reference: paimon-api/.../rest/auth/AuthProvider.java (SPI),
BearTokenAuthProvider.java, DLFAuthProvider.java + DLFDefaultSigner.java
(the "DLF4-HMAC-SHA256" aliyun-V4-style signing protocol: canonical
request -> string-to-sign -> 4-step derived HMAC key chain ->
`Authorization: DLF4-HMAC-SHA256 Credential=.../...,Signature=...`).

The signing protocol is a public wire format; this module implements it
from the spec so a client of ours can talk to a DLF-signed endpoint and
our server can enforce signatures. Verification (server side) has no
counterpart in the reference (its server is a cloud service) — we
recompute the signature under each allowed key and compare, with a
bounded clock-skew window.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
from typing import Dict, Mapping, Optional

__all__ = [
    "AuthProvider", "BearerAuthProvider", "DLFAuthProvider",
    "verify_dlf_request",
]

_ALGORITHM = "DLF4-HMAC-SHA256"
_PRODUCT = "DlfNext"
_REQUEST_TYPE = "aliyun_v4_request"
_VERSION = "v1"
_UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
_MEDIA_TYPE = "application/json"

H_DATE = "x-dlf-date"
H_SHA256 = "x-dlf-content-sha256"
H_VERSION = "x-dlf-version"
H_TOKEN = "x-dlf-security-token"
H_MD5 = "content-md5"
H_CTYPE = "content-type"

# headers participating in the canonical request, lowercase
_SIGNED_HEADERS = (H_MD5, H_CTYPE, H_SHA256, H_DATE, H_VERSION, H_TOKEN)


class AuthProvider:
    """SPI: produce the auth headers for one request."""

    def auth_headers(self, method: str, path: str,
                     params: Optional[Mapping[str, str]],
                     body: Optional[str]) -> Dict[str, str]:
        raise NotImplementedError


class BearerAuthProvider(AuthProvider):
    def __init__(self, token: str):
        self.token = token

    def auth_headers(self, method, path, params, body):
        return {"Authorization": f"Bearer {self.token}"}


def _hmac256(key: bytes, data: str) -> bytes:
    return hmac.new(key, data.encode("utf-8"), hashlib.sha256).digest()


def _sha256_hex(data: str) -> str:
    return hashlib.sha256(data.encode("utf-8")).hexdigest()


def _canonical_request(method: str, path: str,
                       params: Optional[Mapping[str, str]],
                       headers: Mapping[str, str]) -> str:
    lines = [method, path]
    query = "&".join(
        f"{k.strip()}={v.strip()}" if v else k.strip()
        for k, v in sorted((params or {}).items()))
    lines.append(query)
    lines.extend(f"{k}:{headers[k]}" for k in sorted(_SIGNED_HEADERS)
                 if headers.get(k))
    lines.append(headers.get(H_SHA256, _UNSIGNED_PAYLOAD))
    return "\n".join(lines)


def _signature(secret: str, region: str, date: str, string_to_sign: str
               ) -> str:
    key = _hmac256(("aliyun_v4" + secret).encode("utf-8"), date)
    for part in (region, _PRODUCT, _REQUEST_TYPE):
        key = _hmac256(key, part)
    return _hmac256(key, string_to_sign).hex()


def _sign(method: str, path: str, params: Optional[Mapping[str, str]],
          body: Optional[str], access_key_id: str, secret: str,
          security_token: Optional[str], region: str, date_time: str
          ) -> Dict[str, str]:
    """Full DLF4 signature: returns ALL headers to send (sign headers +
    Authorization)."""
    headers = {H_DATE: date_time, H_SHA256: _UNSIGNED_PAYLOAD,
               H_VERSION: _VERSION}
    if body:
        headers[H_CTYPE] = _MEDIA_TYPE
        headers[H_MD5] = base64.b64encode(
            hashlib.md5(body.encode("utf-8")).digest()).decode("ascii")
    if security_token:
        headers[H_TOKEN] = security_token
    date = date_time[:8]
    scope = f"{date}/{region}/{_PRODUCT}/{_REQUEST_TYPE}"
    string_to_sign = "\n".join([
        _ALGORITHM, date_time, scope,
        _sha256_hex(_canonical_request(method, path, params, headers))])
    sig = _signature(secret, region, date, string_to_sign)
    headers["Authorization"] = (
        f"{_ALGORITHM} Credential={access_key_id}/{scope},Signature={sig}")
    return headers


def _utc_datetime(ts: Optional[float] = None) -> str:
    return time.strftime("%Y%m%dT%H%M%SZ",
                         time.gmtime(time.time() if ts is None else ts))


class DLFAuthProvider(AuthProvider):
    """Signs each request with DLF4-HMAC-SHA256 (DLFDefaultSigner.java).

    `token_loader` (optional) is a callable returning
    (access_key_id, secret, security_token_or_None) — the role of the
    reference's DLFTokenLoader (ECS metadata / local file) for rotated
    STS credentials; called per request, so rotation is picked up
    immediately."""

    def __init__(self, access_key_id: Optional[str] = None,
                 access_key_secret: Optional[str] = None,
                 security_token: Optional[str] = None,
                 region: str = "cn-hangzhou",
                 token_loader=None, now_fn=None):
        if token_loader is None and access_key_id is None:
            raise ValueError("need access_key_id or token_loader")
        self._static = (access_key_id, access_key_secret, security_token)
        self.token_loader = token_loader
        self.region = region
        self._now_fn = now_fn or time.time

    def auth_headers(self, method, path, params, body):
        if self.token_loader is not None:
            ak, sk, st = self.token_loader()
        else:
            ak, sk, st = self._static
        return _sign(method, path, params, body, ak, sk, st,
                     self.region, _utc_datetime(self._now_fn()))


def verify_dlf_request(headers: Mapping[str, str], method: str, path: str,
                       params: Optional[Mapping[str, str]],
                       body: Optional[str],
                       secrets: Mapping[str, str],
                       region: str = "cn-hangzhou",
                       max_skew_s: float = 900.0,
                       now_fn=None) -> bool:
    """Server-side check: recompute the DLF4 signature under the access
    key named in the Authorization header. `secrets` maps
    access_key_id -> secret. Rejects unknown keys, stale timestamps
    (|skew| > max_skew_s) and any signature mismatch."""
    lower = {k.lower(): v for k, v in headers.items()}
    auth = lower.get("authorization", "")
    if not auth.startswith(_ALGORITHM + " "):
        return False
    try:
        fields = dict(part.split("=", 1)
                      for part in auth[len(_ALGORITHM) + 1:].split(","))
        access_key_id, date, req_region, product, req_type = \
            fields["Credential"].split("/")
    except (ValueError, KeyError):
        return False
    if product != _PRODUCT or req_type != _REQUEST_TYPE or \
            req_region != region:
        return False
    secret = secrets.get(access_key_id)
    if secret is None:
        return False
    date_time = lower.get(H_DATE, "")
    if not date_time or date_time[:8] != date:
        return False
    try:
        import calendar
        ts = calendar.timegm(time.strptime(date_time, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        return False
    now = (now_fn or time.time)()
    if abs(now - ts) > max_skew_s:
        return False
    expect = _sign(method, path, params, body, access_key_id, secret,
                   lower.get(H_TOKEN), region, date_time)
    return hmac.compare_digest(expect["Authorization"], auth)
