"""Search provider SPI + the built-in columnar provider (counterpart of
`sitewhere_tpu/search/providers.py`).

Reference: service-event-search federates queries over external providers
behind ISearchProvider/IDeviceEventSearchProvider (search/solr/
SolrSearchProvider.java sends raw Solr queries). Here the SPI is the same
shape — named providers, criteria in, events out — but the shipped provider
queries the in-process columnar event log directly (no Solr sidecar), so
search is index-free and consistent with the hot path's storage. External
engines slot in as additional SearchProvider implementations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from sitewhere_tpu_torch.errors import ErrorCode, NotFoundError
from sitewhere_tpu_torch.model.common import SearchCriteria, SearchResults
from sitewhere_tpu_torch.model.event import DeviceEvent, DeviceEventType
from sitewhere_tpu_torch.persist.eventlog import EventFilter
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent


@dataclass
class SearchCriteriaSpec:
    """Declarative event-search criteria (the REST query surface of the
    reference's searchDeviceEvents endpoint)."""

    event_type: Optional[DeviceEventType] = None
    device_token: Optional[str] = None
    assignment_token: Optional[str] = None
    measurement_name: Optional[str] = None
    start_date: Optional[int] = None
    end_date: Optional[int] = None
    page_number: int = 1
    page_size: int = 100

    def to_filter(self) -> EventFilter:
        return EventFilter(event_type=self.event_type,
                           device_token=self.device_token or None,
                           assignment_token=self.assignment_token or None,
                           mm_name=self.measurement_name or None,
                           start_date=self.start_date,
                           end_date=self.end_date)

    def to_criteria(self) -> SearchCriteria:
        return SearchCriteria(page_number=self.page_number,
                              page_size=self.page_size)

    @classmethod
    def from_query(cls, request) -> "SearchCriteriaSpec":
        """Build from a web Request's query params. Malformed values are the
        client's fault → 400, not 500."""
        from sitewhere_tpu_torch.errors import SiteWhereError
        try:
            etype = request.query_one("eventType")
            dates = request.date_criteria()  # shared paging + date parsing
            return cls(
                event_type=(DeviceEventType[etype.upper()] if etype
                            else None),
                device_token=request.query_one("device"),
                assignment_token=request.query_one("assignment"),
                measurement_name=request.query_one("measurement"),
                start_date=dates.start_date,
                end_date=dates.end_date,
                page_number=dates.page_number,
                page_size=dates.page_size)
        except (KeyError, ValueError) as err:
            raise SiteWhereError(f"invalid search criteria: {err}",
                                 http_status=400)


class SearchProvider(LifecycleComponent):
    """Named search backend (ISearchProvider)."""

    def __init__(self, provider_id: str, name: str = ""):
        super().__init__(f"search-provider:{provider_id}")
        self.provider_id = provider_id
        self.provider_name = name or provider_id

    def search(self, spec: SearchCriteriaSpec) -> SearchResults[DeviceEvent]:
        raise NotImplementedError


class ColumnarSearchProvider(SearchProvider):
    """Event search straight off the columnar log (replaces the reference's
    Solr round-trip; same storage the hot path writes)."""

    def __init__(self, event_log, tenant: str = "default",
                 provider_id: str = "columnar"):
        super().__init__(provider_id, name="Columnar event search")
        self.log = event_log
        self.tenant = tenant

    def search(self, spec: SearchCriteriaSpec) -> SearchResults[DeviceEvent]:
        return self.log.query(self.tenant, spec.to_filter(),
                              spec.to_criteria())


class SearchProvidersManager(LifecycleComponent):
    """Registry of search providers for one tenant
    (SearchProvidersManager in the reference)."""

    def __init__(self, name: str = "search-providers"):
        super().__init__(name)
        self._providers: Dict[str, SearchProvider] = {}

    def register(self, provider: SearchProvider) -> SearchProvider:
        self._providers[provider.provider_id] = provider
        self.add_nested(provider)
        return provider

    def get_provider(self, provider_id: str) -> SearchProvider:
        provider = self._providers.get(provider_id)
        if provider is None:
            raise NotFoundError(f"unknown search provider: {provider_id}",
                                ErrorCode.GENERIC)
        return provider

    def list_providers(self) -> List[Dict[str, str]]:
        return [{"id": p.provider_id, "name": p.provider_name}
                for p in self._providers.values()]

    def search(self, provider_id: str, spec: SearchCriteriaSpec
               ) -> SearchResults[DeviceEvent]:
        return self.get_provider(provider_id).search(spec)
