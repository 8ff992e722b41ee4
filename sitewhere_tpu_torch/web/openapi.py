"""OpenAPI 3.0 document generated from the live route table.

Reference: service-web-rest ships Swagger (RestMvcConfiguration swagger bean,
the admin UI's API explorer). Here the router IS the source of truth: every
registered route contributes a path item with its method, path/query
parameters, auth requirement, and a tag derived from the collection segment,
so the document can never drift from the actual surface.
"""

from __future__ import annotations

from typing import Any, Dict

from sitewhere_tpu_torch.web.router import Router


def _tag_of(segments) -> str:
    # /api/<collection>/... -> collection; /authapi/... -> auth
    if segments and segments[0] == "api" and len(segments) > 1:
        return segments[1]
    return segments[0] if segments else "root"


def generate_openapi(router: Router, title: str = "sitewhere-tpu REST API",
                     version: str = "1.0") -> Dict[str, Any]:
    paths: Dict[str, Dict[str, Any]] = {}
    tags = set()
    for route in router._routes:
        path = "/" + "/".join(route.segments)
        tag = _tag_of(route.segments)
        tags.add(tag)
        params = [{
            "name": seg[1:-1], "in": "path", "required": True,
            "schema": {"type": "string"},
        } for seg in route.segments if seg.startswith("{")]
        # derived from the full path so re-registered handlers (e.g. script
        # routes under both /api and /api/tenants/{token}) stay unique
        op_id = route.method.lower() + "_" + "_".join(
            seg.strip("{}") for seg in route.segments)
        op: Dict[str, Any] = {
            "tags": [tag],
            "operationId": op_id,
            "parameters": params,
            "responses": {"200": {"description": "success"},
                          "400": {"description": "invalid request"},
                          "404": {"description": "not found"}},
        }
        if route.auth:
            op["security"] = [{"bearerAuth": []}]
            op["responses"]["401"] = {"description": "unauthenticated"}
            if route.authority:
                op["x-required-authority"] = str(route.authority)
                op["responses"]["403"] = {"description": "forbidden"}
        if route.method in ("POST", "PUT"):
            op["requestBody"] = {"content": {"application/json": {
                "schema": {"type": "object"}}}}
        paths.setdefault(path, {})[route.method.lower()] = op
    return {
        "openapi": "3.0.3",
        "info": {"title": title, "version": version},
        "tags": [{"name": t} for t in sorted(tags)],
        "components": {"securitySchemes": {"bearerAuth": {
            "type": "http", "scheme": "bearer", "bearerFormat": "JWT"}}},
        "paths": dict(sorted(paths.items())),
    }
