"""Framework error model.

Mirrors the reference's SiteWhereException / SiteWhereSystemException + ErrorCode
surface (reference: sitewhere-core-api/src/main/java/com/sitewhere/spi/
SiteWhereException.java and spi/error/ErrorCode.java) as a Python exception
hierarchy with stable numeric codes for API responses.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Stable numeric error codes exposed over the REST API.

    Subset of the reference's spi/error/ErrorCode.java enum, keeping the same
    semantic groupings (1xx auth, 5xx invalid ids, 8xx invalid state).
    """

    INVALID_USERNAME = 100
    INVALID_PASSWORD = 101
    DUPLICATE_USER = 102
    NOT_AUTHORIZED = 103
    INVALID_TENANT_TOKEN = 104

    INVALID_DEVICE_TOKEN = 500
    INVALID_DEVICE_TYPE_TOKEN = 501
    INVALID_AREA_TOKEN = 502
    INVALID_ZONE_TOKEN = 503
    INVALID_CUSTOMER_TOKEN = 504
    INVALID_ASSET_TOKEN = 505
    INVALID_ASSIGNMENT_TOKEN = 506
    INVALID_EVENT_ID = 507
    INVALID_COMMAND_TOKEN = 508
    INVALID_GROUP_TOKEN = 509
    INVALID_SCHEDULE_TOKEN = 510
    INVALID_BATCH_OPERATION_TOKEN = 511
    INVALID_STREAM_ID = 512

    DUPLICATE_TOKEN = 600
    DUPLICATE_STREAM_ID = 601

    DEVICE_ALREADY_ASSIGNED = 800
    DEVICE_NOT_ASSIGNED = 801
    DEVICE_TYPE_IN_USE = 802
    REGISTRATION_DISABLED = 803
    MALFORMED_EVENT = 804
    CAPACITY_EXCEEDED = 805

    GENERIC = 9999


class SiteWhereError(Exception):
    """Base framework error (reference: SiteWhereException.java)."""

    def __init__(self, message: str, code: ErrorCode = ErrorCode.GENERIC,
                 http_status: int = 400):
        super().__init__(message)
        self.code = code
        self.http_status = http_status


class NotFoundError(SiteWhereError):
    def __init__(self, message: str, code: ErrorCode):
        super().__init__(message, code, http_status=404)


class DuplicateTokenError(SiteWhereError):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.DUPLICATE_TOKEN):
        super().__init__(message, code, http_status=409)


class AuthError(SiteWhereError):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.NOT_AUTHORIZED):
        super().__init__(message, code, http_status=401)


class InvalidStateError(SiteWhereError):
    pass


class LifecycleError(SiteWhereError):
    """A component failed a lifecycle transition (reference: lifecycle error states)."""
    pass
