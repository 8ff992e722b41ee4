"""Federated event search (reference: service-event-search)."""

from sitewhere_tpu_torch.search.external import HttpSearchProvider
from sitewhere_tpu_torch.search.providers import (
    ColumnarSearchProvider, SearchCriteriaSpec, SearchProvider,
    SearchProvidersManager)

__all__ = ["ColumnarSearchProvider", "HttpSearchProvider",
           "SearchCriteriaSpec", "SearchProvider", "SearchProvidersManager"]
