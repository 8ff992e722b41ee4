"""Error model of the port: the subset of `sitewhere_tpu.errors` the hot path
raises, with the same numeric codes (reference: SiteWhereException.java and
spi/error/ErrorCode.java)."""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    DUPLICATE_TOKEN = 600
    CAPACITY_EXCEEDED = 805
    GENERIC = 9999


class SiteWhereError(Exception):
    """Base framework error (reference: SiteWhereException.java)."""

    def __init__(self, message: str, code: ErrorCode = ErrorCode.GENERIC,
                 http_status: int = 400):
        super().__init__(message)
        self.code = code
        self.http_status = http_status


class LifecycleError(SiteWhereError):
    """A component failed a lifecycle transition (reference: lifecycle error
    states)."""


class DuplicateTokenError(SiteWhereError):
    def __init__(self, message: str,
                 code: ErrorCode = ErrorCode.DUPLICATE_TOKEN):
        super().__init__(message, code, http_status=409)
