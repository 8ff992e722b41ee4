"""Shared model base types: persistent entities, paging, search.

Reference surface: sitewhere-core-api spi/common/IPersistentEntity.java,
spi/search/ISearchCriteria.java, spi/search/ISearchResults.java.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Generic, Iterable, List, Optional, Sequence, TypeVar

T = TypeVar("T")


def new_id() -> str:
    return str(uuid.uuid4())


_now_ms_override = None  # test hook: deterministic replication-algebra clocks


def now_ms() -> int:
    if _now_ms_override is not None:
        return _now_ms_override()
    return int(time.time() * 1000)


@dataclass
class PersistentEntity:
    """Base for all persisted domain objects (IPersistentEntity + IMetadataProvider)."""

    id: str = field(default_factory=new_id)
    token: str = ""
    created_date: int = field(default_factory=now_ms)
    created_by: str = ""
    updated_date: Optional[int] = None
    updated_by: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)

    def touch(self, username: str = "") -> None:
        # monotonic past the current stamp: a host whose clock trails a
        # replicated update it already applied must still produce a NEWER
        # last-writer-wins stamp, or its local edit would lose everywhere
        # else while winning locally (cluster registry replication)
        self.updated_date = max(now_ms(),
                                (self.updated_date or self.created_date) + 1)
        self.updated_by = username

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)


@dataclass
class BrandedEntity(PersistentEntity):
    """Entity with branding (IBrandedEntity): admin-UI presentation fields."""

    name: str = ""
    description: str = ""
    image_url: str = ""
    icon: str = ""
    background_color: str = ""
    foreground_color: str = ""
    border_color: str = ""


@dataclass(frozen=True)
class Location:
    """Geo point (ILocation)."""

    latitude: float
    longitude: float
    elevation: float = 0.0


@dataclass
class SearchCriteria:
    """Paging criteria (ISearchCriteria). Pages are 1-based like the reference."""

    page_number: int = 1
    page_size: int = 100

    @property
    def offset(self) -> int:
        return max(0, (self.page_number - 1) * self.page_size)


@dataclass
class DateRangeCriteria(SearchCriteria):
    """Paging + time window (IDateRangeSearchCriteria), ms epoch, inclusive."""

    start_date: Optional[int] = None
    end_date: Optional[int] = None

    def in_range(self, ts: int) -> bool:
        if self.start_date is not None and ts < self.start_date:
            return False
        if self.end_date is not None and ts > self.end_date:
            return False
        return True


@dataclass
class SearchResults(Generic[T]):
    """Page of results + total count (ISearchResults)."""

    results: List[T]
    num_results: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "numResults": self.num_results,
            "results": [_asdict(r) for r in self.results],
        }


class Pager(Generic[T]):
    """Applies SearchCriteria paging while counting total matches.

    Reference: sitewhere-core Pager.java — process every match, keep only the
    requested page.
    """

    def __init__(self, criteria: SearchCriteria):
        self._criteria = criteria
        self._matched = 0
        self._page: List[T] = []

    def process(self, item: T) -> None:
        self._matched += 1
        start = self._criteria.offset
        if start < self._matched <= start + self._criteria.page_size:
            self._page.append(item)

    def process_all(self, items: Iterable[T]) -> "Pager[T]":
        for item in items:
            self.process(item)
        return self

    def results(self) -> SearchResults[T]:
        return SearchResults(results=self._page, num_results=self._matched)


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _asdict(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    if isinstance(obj, (str, int, float, bool, bytes)) or obj is None:
        return obj  # bytes pass through: msgpack handles them natively
    if hasattr(obj, "value"):  # enums
        return obj.value
    return str(obj)


def page(items: Sequence[T], criteria: SearchCriteria) -> SearchResults[T]:
    """Page a pre-filtered sequence."""
    return Pager[T](criteria).process_all(items).results()
