"""Password hashing: salted PBKDF2-HMAC-SHA256.

Replaces the reference's Spring Security BCrypt encoder
(service-user-management persistence; sitewhere-core security/). Format:
``pbkdf2$<iterations>$<salt-hex>$<hash-hex>``.
"""

from __future__ import annotations

import hashlib
import hmac
import os

_ITERATIONS = 100_000


def hash_password(password: str, iterations: int = _ITERATIONS) -> str:
    salt = os.urandom(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt,
                                 iterations)
    return f"pbkdf2${iterations}${salt.hex()}${digest.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, iterations_s, salt_hex, hash_hex = stored.split("$")
        if scheme != "pbkdf2":
            return False
        digest = hashlib.pbkdf2_hmac(
            "sha256", password.encode("utf-8"), bytes.fromhex(salt_hex),
            int(iterations_s))
        return hmac.compare_digest(digest.hex(), hash_hex)
    except (ValueError, TypeError):
        return False
