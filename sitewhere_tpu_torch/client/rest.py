"""Python REST client for the sitewhere_tpu_torch gateway.

Reference: sitewhere-client/src/main/java/com/sitewhere/rest/client/
SiteWhereClient.java:91 (ISiteWhereClient surface: authenticate, device/
assignment/event CRUD against the REST gateway). Dependency-free: stdlib
urllib with JWT bearer auth and the X-SiteWhere-Tenant header.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional


class SiteWhereClientError(Exception):
    def __init__(self, status: int, payload: Any):
        super().__init__(f"HTTP {status}: {payload}")
        self.status = status
        self.payload = payload


class SiteWhereClient:
    """Authenticated client bound to one instance + tenant."""

    def __init__(self, base_url: str, tenant: str = "default",
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.tenant = tenant
        self.timeout = timeout
        self.token: Optional[str] = None

    # -- transport ---------------------------------------------------------
    def _request(self, method: str, path: str, body: Any = None,
                 params: Optional[Dict[str, Any]] = None,
                 headers: Optional[Dict[str, str]] = None) -> Any:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None})
        data = None
        req_headers = {"Accept": "application/json"}
        if isinstance(body, bytes):
            data = body
            req_headers["Content-Type"] = "application/octet-stream"
        elif body is not None:
            data = json.dumps(body).encode("utf-8")
            req_headers["Content-Type"] = "application/json"
        if self.token:
            req_headers["Authorization"] = f"Bearer {self.token}"
        if self.tenant:
            req_headers["X-SiteWhere-Tenant"] = self.tenant
        if headers:
            req_headers.update(headers)
        request = urllib.request.Request(url, data=data, method=method,
                                         headers=req_headers)
        try:
            with urllib.request.urlopen(request,
                                        timeout=self.timeout) as resp:
                raw = resp.read()
                ctype = resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as err:
            raw = err.read()
            try:
                payload = json.loads(raw)
            except Exception:
                payload = raw.decode("utf-8", "replace")
            raise SiteWhereClientError(err.code, payload)
        if "json" in ctype:
            return json.loads(raw) if raw else None
        return raw  # binary endpoints: empty body is b"", not None

    def get(self, path: str, **params) -> Any:
        return self._request("GET", path, params=params or None)

    def post(self, path: str, body: Any = None) -> Any:
        return self._request("POST", path, body=body)

    def put(self, path: str, body: Any = None) -> Any:
        return self._request("PUT", path, body=body)

    def delete(self, path: str) -> Any:
        return self._request("DELETE", path)

    # -- auth --------------------------------------------------------------
    def authenticate(self, username: str, password: str) -> str:
        creds = base64.b64encode(f"{username}:{password}".encode()).decode()
        result = self._request("POST", "/authapi/jwt",
                               headers={"Authorization": f"Basic {creds}"})
        self.token = result["token"]
        return self.token

    # -- system ------------------------------------------------------------
    def get_version(self) -> Dict:
        return self.get("/api/system/version")

    def get_topology(self) -> Dict:
        return self.get("/api/instance/topology")

    # -- tenants -----------------------------------------------------------
    def create_tenant(self, body: Dict) -> Dict:
        return self.post("/api/tenants", body)

    def list_tenants(self) -> Dict:
        return self.get("/api/tenants")

    def get_tenant(self, token: str) -> Dict:
        return self.get(f"/api/tenants/{token}")

    # -- users -------------------------------------------------------------
    def create_user(self, body: Dict) -> Dict:
        return self.post("/api/users", body)

    def list_users(self) -> Dict:
        return self.get("/api/users")

    # -- device types ------------------------------------------------------
    def create_device_type(self, body: Dict) -> Dict:
        return self.post("/api/devicetypes", body)

    def get_device_type(self, token: str) -> Dict:
        return self.get(f"/api/devicetypes/{token}")

    def list_device_types(self) -> Dict:
        return self.get("/api/devicetypes")

    def create_device_command(self, device_type_token: str,
                              body: Dict) -> Dict:
        return self.post(f"/api/devicetypes/{device_type_token}/commands",
                         body)

    # -- devices -----------------------------------------------------------
    def create_device(self, body: Dict) -> Dict:
        return self.post("/api/devices", body)

    def get_device(self, token: str) -> Dict:
        return self.get(f"/api/devices/{token}")

    def list_devices(self, **params) -> Dict:
        return self.get("/api/devices", **params)

    def delete_device(self, token: str) -> Dict:
        return self.delete(f"/api/devices/{token}")

    def add_device_event_batch(self, device_token: str, batch: Dict) -> Dict:
        return self.post(f"/api/devices/{device_token}/events", batch)

    # -- labels (reference: sitewhere-client label endpoints) --------------
    def list_label_generators(self) -> Dict:
        return self.get("/api/labels/generators")

    def get_label(self, entity_path: str, token: str,
                  generator_id: str = "qrcode") -> bytes:
        """PNG label for an entity; entity_path is the REST collection name
        (devices, devicetypes, assignments, areas, customers, assets)."""
        return self.get(f"/api/{entity_path}/{token}/label/{generator_id}")

    def get_device_label(self, token: str,
                         generator_id: str = "qrcode") -> bytes:
        return self.get_label("devices", token, generator_id)

    def list_device_events(self, device_token: str, **params) -> Dict:
        return self.get(f"/api/devices/{device_token}/events", **params)

    # -- assignments -------------------------------------------------------
    def create_assignment(self, body: Dict) -> Dict:
        return self.post("/api/assignments", body)

    def get_assignment(self, token: str) -> Dict:
        return self.get(f"/api/assignments/{token}")

    def release_assignment(self, token: str) -> Dict:
        return self.post(f"/api/assignments/{token}/end")

    def add_measurements(self, assignment_token: str, *events: Dict) -> Any:
        return self.post(f"/api/assignments/{assignment_token}/measurements",
                         list(events))

    def add_locations(self, assignment_token: str, *events: Dict) -> Any:
        return self.post(f"/api/assignments/{assignment_token}/locations",
                         list(events))

    def add_alerts(self, assignment_token: str, *events: Dict) -> Any:
        return self.post(f"/api/assignments/{assignment_token}/alerts",
                         list(events))

    def list_measurements(self, assignment_token: str, **params) -> Dict:
        return self.get(f"/api/assignments/{assignment_token}/measurements",
                        **params)

    def list_locations(self, assignment_token: str, **params) -> Dict:
        return self.get(f"/api/assignments/{assignment_token}/locations",
                        **params)

    def list_alerts(self, assignment_token: str, **params) -> Dict:
        return self.get(f"/api/assignments/{assignment_token}/alerts",
                        **params)

    def invoke_command(self, assignment_token: str, body: Dict) -> Dict:
        return self.post(f"/api/assignments/{assignment_token}/invocations",
                         body)

    # -- areas / zones -----------------------------------------------------
    def create_area(self, body: Dict) -> Dict:
        return self.post("/api/areas", body)

    def create_zone(self, area_token: str, body: Dict) -> Dict:
        return self.post(f"/api/areas/{area_token}/zones", body)

    # -- assets ------------------------------------------------------------
    def create_asset_type(self, body: Dict) -> Dict:
        return self.post("/api/assettypes", body)

    def create_asset(self, body: Dict) -> Dict:
        return self.post("/api/assets", body)

    # -- batch / schedules -------------------------------------------------
    def create_batch_command_invocation(self, body: Dict) -> Dict:
        return self.post("/api/batch/command", body)

    def get_batch_operation(self, token: str) -> Dict:
        return self.get(f"/api/batch/{token}")

    def create_schedule(self, body: Dict) -> Dict:
        return self.post("/api/schedules", body)

    def create_scheduled_job(self, body: Dict) -> Dict:
        return self.post("/api/jobs", body)

    # -- device streams ----------------------------------------------------
    def create_device_stream(self, assignment_token: str, stream_id: str,
                             content_type: str = "application/octet-stream"
                             ) -> Dict:
        return self.post(f"/api/assignments/{assignment_token}/streams",
                         {"stream_id": stream_id,
                          "content_type": content_type})

    def add_stream_data(self, assignment_token: str, stream_id: str,
                        sequence: int, data: bytes) -> Dict:
        return self._request(
            "POST", f"/api/assignments/{assignment_token}/streams/"
                    f"{stream_id}/data/{sequence}", body=data)

    def get_stream_data(self, assignment_token: str, stream_id: str,
                        sequence: int) -> bytes:
        return self.get(f"/api/assignments/{assignment_token}/streams/"
                        f"{stream_id}/data/{sequence}")

    def get_stream_content(self, assignment_token: str,
                           stream_id: str) -> bytes:
        return self.get(f"/api/assignments/{assignment_token}/streams/"
                        f"{stream_id}/content")

    # -- event search ------------------------------------------------------
    def search_events(self, provider_id: str = "columnar", **params) -> Dict:
        return self.get(f"/api/search/{provider_id}/events", **params)

    # -- device state ------------------------------------------------------
    def get_device_state(self, device_token: str) -> Dict:
        return self.get(f"/api/devicestates/{device_token}")
