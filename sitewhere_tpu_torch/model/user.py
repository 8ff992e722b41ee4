"""User/authority model (sitewhere-core-api spi/user/IUser.java,
IGrantedAuthority.java). Passwords are stored as salted PBKDF2 hashes
(api/auth.py), replacing the reference's BCrypt."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from sitewhere_tpu_torch.model.common import PersistentEntity


class ACCOUNT_STATUS:
    ACTIVE = "Active"
    EXPIRED = "Expired"
    LOCKED = "Locked"


class SiteWhereRoles:
    """Well-known authorities (reference: SiteWhereRoles.java / SiteWhereAuthority)."""

    REST = "REST"
    ADMINISTER_USERS = "ADMINISTER_USERS"
    ADMINISTER_TENANTS = "ADMINISTER_TENANTS"
    ADMINISTER_TENANT_SELF = "ADMINISTER_TENANT_SELF"
    VIEW_SERVER_INFO = "VIEW_SERVER_INFO"
    ADMINISTER_SCHEDULES = "ADMINISTER_SCHEDULES"

    ALL = [REST, ADMINISTER_USERS, ADMINISTER_TENANTS, ADMINISTER_TENANT_SELF,
           VIEW_SERVER_INFO, ADMINISTER_SCHEDULES]


@dataclass
class GrantedAuthority:
    """Named permission (IGrantedAuthority)."""

    authority: str = ""
    description: str = ""
    parent: str = ""
    group: bool = False


@dataclass
class User(PersistentEntity):
    """Platform user (IUser). `token` holds the username."""

    username: str = ""
    hashed_password: str = ""
    first_name: str = ""
    last_name: str = ""
    status: str = ACCOUNT_STATUS.ACTIVE
    last_login_date: Optional[int] = None
    authorities: List[str] = field(default_factory=list)
