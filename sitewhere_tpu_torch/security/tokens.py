"""JWT issuance + validation (HMAC-SHA256).

Reference: sitewhere-microservice security/TokenManagement.java — issues JWTs
carrying username + granted authorities, validated by JwtServerInterceptor on
every gRPC call and TokenAuthenticationFilter on REST. Same claim shape here:
``sub`` (username), ``auth`` (authority list), ``iat``/``exp``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Dict, List, Optional


class InvalidTokenError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


class TokenManagement:
    """Issue + validate HS256 JWTs (TokenManagement.java:
    generateToken/getClaimsForToken)."""

    # bound on the validated-claims cache; parse+HMAC per request is cheap
    # but not free, and the cache is what user-mutation replication
    # invalidates (multitenant/replication.py)
    _CACHE_MAX = 4096

    def __init__(self, secret: Optional[bytes] = None,
                 expiration_minutes: int = 60, issuer: str = "sitewhere"):
        self.secret = secret or os.urandom(32)
        self.expiration_minutes = expiration_minutes
        self.issuer = issuer
        self._cache: Dict[str, Dict] = {}
        # username -> revocation cut (ms): tokens issued at or before the
        # cut are rejected — a DELETED user's tokens die cluster-wide
        # instead of riding out their expiry window
        self._revoked: Dict[str, int] = {}

    def invalidate_user(self, username: str, revoke: bool = False) -> None:
        """Drop cached auth state for `username`; with `revoke`, also
        reject every token issued up to now (user deletion). Called on
        local AND replicated user mutations (instance wiring)."""
        if not username:
            return
        import time as _time

        self._cache = {tok: claims for tok, claims in self._cache.items()
                       if claims.get("sub") != username}
        if revoke:
            cut = int(_time.time() * 1000)
            self._revoked[username] = max(self._revoked.get(username, 0),
                                          cut)

    def _sign(self, signing_input: bytes) -> bytes:
        return hmac.new(self.secret, signing_input, hashlib.sha256).digest()

    def generate_token(self, username: str,
                       authorities: Optional[List[str]] = None,
                       expiration_minutes: Optional[int] = None) -> str:
        now = int(time.time())
        minutes = (expiration_minutes if expiration_minutes is not None
                   else self.expiration_minutes)
        header = _b64url(json.dumps(
            {"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode())
        payload = _b64url(json.dumps({
            "sub": username, "iss": self.issuer,
            "auth": authorities or [], "iat": now,
            "exp": now + minutes * 60}, separators=(",", ":")).encode())
        signing_input = f"{header}.{payload}".encode("ascii")
        return f"{header}.{payload}.{_b64url(self._sign(signing_input))}"

    def get_claims(self, token: str) -> Dict:
        claims = self._cache.get(token)
        if claims is None:
            try:
                header, payload, signature = token.split(".")
            except ValueError:
                raise InvalidTokenError("malformed token")
            signing_input = f"{header}.{payload}".encode("ascii")
            if not hmac.compare_digest(_unb64url(signature),
                                       self._sign(signing_input)):
                raise InvalidTokenError("bad signature")
            claims = json.loads(_unb64url(payload))
            if len(self._cache) >= self._CACHE_MAX:
                self._cache.clear()  # bounded; rebuilt on demand
            self._cache[token] = claims
        # exp + revocation checked on EVERY read, cached or not
        if claims.get("exp", 0) < time.time():
            self._cache.pop(token, None)
            raise InvalidTokenError("token expired")
        cut = self._revoked.get(claims.get("sub", ""))
        if cut is not None and int(claims.get("iat", 0)) * 1000 <= cut:
            self._cache.pop(token, None)
            raise InvalidTokenError("user credentials revoked")
        return claims

    def get_username(self, token: str) -> str:
        return self.get_claims(token)["sub"]

    def get_authorities(self, token: str) -> List[str]:
        return list(self.get_claims(token).get("auth", []))
