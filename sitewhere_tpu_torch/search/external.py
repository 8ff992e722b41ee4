"""Federated EXTERNAL event search over HTTP/JSON (counterpart of
`sitewhere_tpu/search/external.py`).

Reference: service-event-search federates queries to an external engine —
SolrSearchProvider.java sends the query to a Solr server and maps result
documents back to device events (executeQuery :125, raw passthrough
executeQueryWithRawResponse :149, geo getLocationsNear :175). The rebuild
keeps the in-process columnar provider as the default (providers.py), and
this provider fills the EXTERNAL slot: criteria become query parameters on
a configured HTTP endpoint, responses are JSON documents mapped to typed
events. stdlib urllib only — no client library to gate on.

Wire contract (the stub-server shape the tests pin):

  GET {base_url}/events?eventType=&device=&assignment=&measurement=
      &startDate=&endDate=&page=&pageSize=
    -> {"results": [<event doc>...], "total": N}
  GET {base_url}/raw?q=<query>           (raw passthrough, any JSON back)
  GET {base_url}/locations?latitude=&longitude=&distance=&pageSize=
    -> {"results": [<location doc>...], "total": N}

Event docs use the platform's own to_dict() form ("eventType" name or
"event_type" code); unknown fields are dropped (event_from_dict).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.common import SearchResults
from sitewhere_tpu_torch.model.event import (
    DeviceEvent, DeviceEventType, DeviceLocation, event_from_dict)
from sitewhere_tpu_torch.search.providers import (
    SearchCriteriaSpec, SearchProvider)


def _event_from_doc(doc: Dict[str, Any]) -> DeviceEvent:
    """External doc -> typed event: accept the enum NAME ("MEASUREMENT")
    or the packed integer code, like the platform's own payloads."""
    data = dict(doc)
    if "event_type" not in data:
        name = str(data.get("eventType", "MEASUREMENT")).upper()
        try:
            data["event_type"] = DeviceEventType[name].value
        except KeyError:
            raise SiteWhereError(
                f"external search document has unknown eventType {name!r}",
                ErrorCode.GENERIC, http_status=502)
    return event_from_dict(data)


class HttpSearchProvider(SearchProvider):
    """Named external search engine behind an HTTP/JSON endpoint (the
    SolrSearchProvider role, engine-agnostic)."""

    def __init__(self, provider_id: str, base_url: str, name: str = "",
                 timeout_s: float = 10.0,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(provider_id,
                         name=name or f"External search ({base_url})")
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.headers = dict(headers or {})

    # -- transport ---------------------------------------------------------
    def _get(self, path: str, params: Dict[str, Any]) -> Any:
        query = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v not in (None, "")})
        url = f"{self.base_url}{path}"
        if query:
            url = f"{url}?{query}"
        req = urllib.request.Request(url, headers=self.headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as rsp:
                return json.loads(rsp.read().decode("utf-8"))
        except urllib.error.HTTPError as err:
            raise SiteWhereError(
                f"external search provider '{self.provider_id}' returned "
                f"HTTP {err.code}", ErrorCode.GENERIC,
                http_status=502) from err
        except (urllib.error.URLError, OSError, ValueError) as err:
            raise SiteWhereError(
                f"external search provider '{self.provider_id}' "
                f"unreachable: {err}", ErrorCode.GENERIC,
                http_status=502) from err

    # -- ISearchProvider operations ---------------------------------------
    def search(self, spec: SearchCriteriaSpec) -> SearchResults[DeviceEvent]:
        data = self._get("/events", {
            "eventType": spec.event_type.name if spec.event_type else None,
            "device": spec.device_token,
            "assignment": spec.assignment_token,
            "measurement": spec.measurement_name,
            "startDate": spec.start_date,
            "endDate": spec.end_date,
            "page": spec.page_number,
            "pageSize": spec.page_size,
        })
        docs = list(data.get("results", []))
        events = [_event_from_doc(d) for d in docs]
        return SearchResults(results=events,
                             num_results=int(data.get("total", len(events))))

    def raw_query(self, query: str) -> Any:
        """Engine-native query passthrough with the raw JSON response
        (executeQueryWithRawResponse parity)."""
        return self._get("/raw", {"q": query})

    def locations_near(self, latitude: float, longitude: float,
                       distance: float,
                       page_size: int = 100) -> List[DeviceLocation]:
        """Geo query (getLocationsNear parity)."""
        data = self._get("/locations", {
            "latitude": latitude, "longitude": longitude,
            "distance": distance, "pageSize": page_size})
        out: List[DeviceLocation] = []
        for doc in data.get("results", []):
            doc = dict(doc)
            doc.setdefault("eventType", "LOCATION")
            event = _event_from_doc(doc)
            if isinstance(event, DeviceLocation):
                out.append(event)
        return out
