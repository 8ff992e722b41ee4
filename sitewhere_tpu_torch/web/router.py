"""Minimal HTTP routing core for the REST gateway.

Reference: service-web-rest uses Spring MVC annotations
(`rest/controllers/*.java`, e.g. Assignments.java:98-160) + a JWT filter
(security/jwt/TokenAuthenticationFilter.java). This replaces that stack with
an explicit route table: `{token}`-style path templates, per-route authority
requirements, and a Request object carrying parsed query/body/claims.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from sitewhere_tpu_torch.errors import AuthError, SiteWhereError
from sitewhere_tpu_torch.model.common import DateRangeCriteria, SearchCriteria


@dataclass
class Request:
    """One parsed HTTP request, handed to controller functions."""

    method: str = "GET"
    path: str = "/"
    params: Dict[str, str] = field(default_factory=dict)
    query: Dict[str, List[str]] = field(default_factory=dict)
    body: Any = None
    raw_body: Optional[bytes] = None       # undecoded bytes (binary uploads)
    headers: Dict[str, str] = field(default_factory=dict)
    claims: Optional[Dict] = None          # JWT claims once authenticated
    tenant: Optional[str] = None           # resolved tenant token
    context: Any = None                    # per-request controller context

    @property
    def username(self) -> str:
        return (self.claims or {}).get("sub", "")

    @property
    def authorities(self) -> List[str]:
        return (self.claims or {}).get("auth", [])

    def query_one(self, name: str, default: Optional[str] = None
                  ) -> Optional[str]:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def query_int(self, name: str, default: int) -> int:
        val = self.query_one(name)
        return int(val) if val is not None else default

    def query_bool(self, name: str, default: bool = False) -> bool:
        val = self.query_one(name)
        if val is None:
            return default
        return val.lower() in ("1", "true", "yes")

    def criteria(self) -> SearchCriteria:
        """Paging params (reference: RestControllerBase paging args)."""
        return SearchCriteria(page_number=self.query_int("page", 1),
                              page_size=self.query_int("pageSize", 100))

    def date_criteria(self) -> DateRangeCriteria:
        crit = DateRangeCriteria(page_number=self.query_int("page", 1),
                                 page_size=self.query_int("pageSize", 100))
        start = self.query_one("startDate")
        end = self.query_one("endDate")
        if start is not None:
            crit.start_date = int(start)
        if end is not None:
            crit.end_date = int(end)
        return crit


@dataclass
class _Route:
    method: str
    segments: Tuple[str, ...]
    handler: Callable[[Request], Any]
    auth: bool
    authority: Optional[str]


class Router:
    """Explicit route table with `{param}` path templates."""

    def __init__(self) -> None:
        self._routes: List[_Route] = []

    def add(self, method: str, pattern: str,
            handler: Callable[[Request], Any], auth: bool = True,
            authority: Optional[str] = None) -> None:
        segments = tuple(s for s in pattern.strip("/").split("/") if s)
        self._routes.append(_Route(method.upper(), segments, handler, auth,
                                   authority))

    # convenience registrars
    def get(self, pattern, handler, **kw):
        self.add("GET", pattern, handler, **kw)

    def post(self, pattern, handler, **kw):
        self.add("POST", pattern, handler, **kw)

    def put(self, pattern, handler, **kw):
        self.add("PUT", pattern, handler, **kw)

    def delete(self, pattern, handler, **kw):
        self.add("DELETE", pattern, handler, **kw)

    @staticmethod
    def _match(route: _Route, parts: Tuple[str, ...]
               ) -> Optional[Dict[str, str]]:
        if len(route.segments) != len(parts):
            return None
        params: Dict[str, str] = {}
        for seg, part in zip(route.segments, parts):
            if seg.startswith("{") and seg.endswith("}"):
                params[seg[1:-1]] = part
            elif seg != part:
                return None
        return params

    def resolve(self, method: str, path: str
                ) -> Tuple[_Route, Dict[str, str]]:
        parts = tuple(s for s in path.strip("/").split("/") if s)
        found_path = False
        for route in self._routes:
            params = self._match(route, parts)
            if params is None:
                continue
            found_path = True
            if route.method == method.upper():
                return route, params
        if found_path:
            raise SiteWhereError("method not allowed", http_status=405)
        raise SiteWhereError(f"no route for {path}", http_status=404)

    def dispatch(self, request: Request) -> Any:
        route, params = self.resolve(request.method, request.path)
        request.params = params
        if route.auth:
            if request.claims is None:
                raise AuthError("authentication required")
            if route.authority and route.authority not in request.authorities:
                raise SiteWhereError(
                    f"missing authority {route.authority}", http_status=403)
        return route.handler(request)

    def parse_query(self, raw_query: str) -> Dict[str, List[str]]:
        return parse_qs(raw_query, keep_blank_values=True)
