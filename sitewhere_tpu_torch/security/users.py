"""User management: users + granted authorities, authentication.

Reference: service-user-management — IUserManagement CRUD, BCrypt password
checks backing JWT issuance, authority hierarchy
(GrantedAuthorityHierarchy); global (not multitenant) like the reference.

Cluster story: the collection-level mutation feed (`add_mutation_listener`)
is what `multitenant/replication.py` broadcasts to peer hosts; replicated
applies run under `replication()` so stamps adopt the writer's.
`last_login_date` is a PER-HOST observation (recorded quietly, never
emitted) — replicating it would re-stamp the user on every login and let
a login race shadow a concurrent password change under last-writer-wins.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.common import (
    SearchCriteria, SearchResults, now_ms, page)
from sitewhere_tpu_torch.model.user import (
    ACCOUNT_STATUS, GrantedAuthority, SiteWhereRoles, User)
from sitewhere_tpu_torch.registry.store import InMemoryStore, _Collection
from sitewhere_tpu_torch.security.auth import hash_password, verify_password


class UserManagement:
    """IUserManagement: users keyed by username (stored in `token`)."""

    def __init__(self, store=None):
        store = store or InMemoryStore()
        self._replication = threading.local()
        self._mutation_listeners: List[Callable] = []
        self.users: _Collection[User] = _Collection(
            "user", User, store, ErrorCode.INVALID_USERNAME,
            replicating=self._replicating,
            on_mutation=self._emit_mutation)
        self._authorities: Dict[str, GrantedAuthority] = {}
        for role in SiteWhereRoles.ALL:
            self._authorities[role] = GrantedAuthority(
                authority=role, description=role.replace("_", " ").title())

    # -- replication context ----------------------------------------------
    def _replicating(self) -> bool:
        return getattr(self._replication, "active", False)

    @contextmanager
    def replication(self):
        """Mark this thread as applying peer-replicated mutations
        (multitenant/replication.py): creates become idempotent and
        updates adopt the writer's stamp instead of re-touching."""
        prev = getattr(self._replication, "active", False)
        self._replication.active = True
        try:
            yield
        finally:
            self._replication.active = prev

    # -- mutation feed (cluster replication publish side) -----------------
    def add_mutation_listener(self, callback: Callable) -> None:
        """Subscribe to the COMPLETE (kind, op, entity) mutation feed:
        kind "user" for collection mutations, "authority" for granted-
        authority creates."""
        self._mutation_listeners.append(callback)

    def _emit_mutation(self, kind: str, op: str, entity) -> None:
        for callback in list(self._mutation_listeners):
            callback(kind, op, entity)

    # -- users -------------------------------------------------------------
    def create_user(self, user: User, password: str = "") -> User:
        if not user.username:
            raise SiteWhereError("username required", ErrorCode.INVALID_USERNAME)
        if not self._replicating() \
                and not self.users.claimable_replica(user.username) \
                and self.users.get_by_token(user.username) is not None:
            # a claimable replica (peer create arrived first) merges in
            # _Collection.create instead of raising — boot provisioning
            # races stay idempotent cluster-wide
            raise SiteWhereError(f"user '{user.username}' exists",
                                 ErrorCode.DUPLICATE_USER)
        user.token = user.username
        if password:
            user.hashed_password = hash_password(password)
        return self.users.create(user)

    def get_user_by_username(self, username: str) -> Optional[User]:
        return self.users.get_by_token(username)

    def update_user(self, username: str, updates: Dict,
                    password: Optional[str] = None) -> User:
        user = self.users.require_by_token(username)
        if password:
            updates = {**updates, "hashed_password": hash_password(password)}
        return self.users.update(user.id, updates)

    def delete_user(self, username: str) -> User:
        user = self.users.require_by_token(username)
        return self.users.delete(user.id)

    def list_users(self, criteria: Optional[SearchCriteria] = None
                   ) -> SearchResults[User]:
        return self.users.list(criteria)

    # -- authentication ----------------------------------------------------
    def authenticate(self, username: str, password: str,
                     update_last_login: bool = True) -> User:
        """Password check backing JWT issuance (reference
        UserManagementImpl.authenticate)."""
        user = self.users.get_by_token(username)
        if user is None or not verify_password(password, user.hashed_password):
            raise SiteWhereError("invalid credentials",
                                 ErrorCode.INVALID_PASSWORD, http_status=401)
        if user.status != ACCOUNT_STATUS.ACTIVE:
            raise SiteWhereError(f"account {user.status}",
                                 ErrorCode.NOT_AUTHORIZED, http_status=401)
        if update_last_login:
            # quiet per-host observation: no touch(), no mutation emit —
            # a login must not re-stamp the replicated user record
            user.last_login_date = now_ms()
            self.users.persist_quietly(user)
        return user

    # -- authorities -------------------------------------------------------
    def create_granted_authority(self, authority: GrantedAuthority
                                 ) -> GrantedAuthority:
        self._authorities[authority.authority] = authority
        self._emit_mutation("authority", "create", authority)
        return authority

    def get_granted_authority(self, name: str) -> Optional[GrantedAuthority]:
        return self._authorities.get(name)

    def list_granted_authorities(self) -> List[GrantedAuthority]:
        return sorted(self._authorities.values(), key=lambda a: a.authority)

    def get_user_authorities(self, username: str) -> List[str]:
        user = self.users.require_by_token(username)
        return list(user.authorities)
