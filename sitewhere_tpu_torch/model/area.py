"""Location hierarchy model: customers, areas, zones.

Reference surface: sitewhere-core-api spi/area/ (IArea, IAreaType, IZone) and
spi/customer/ (ICustomer, ICustomerType).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from sitewhere_tpu_torch.model.common import BrandedEntity, Location


@dataclass
class CustomerType(BrandedEntity):
    """Class of customers (ICustomerType)."""

    contained_customer_type_ids: List[str] = field(default_factory=list)


@dataclass
class Customer(BrandedEntity):
    """Customer in the containment hierarchy (ICustomer)."""

    customer_type_id: str = ""
    parent_customer_id: str = ""


@dataclass
class AreaType(BrandedEntity):
    """Class of areas (IAreaType)."""

    contained_area_type_ids: List[str] = field(default_factory=list)


@dataclass
class Area(BrandedEntity):
    """Physical/logical area devices are assigned to (IArea). The bounds
    polygon drives map display; zones within the area drive geofencing."""

    area_type_id: str = ""
    parent_area_id: str = ""
    bounds: List[Location] = field(default_factory=list)


@dataclass
class Zone(BrandedEntity):
    """Geofence polygon within an area (IZone).

    Zones are compiled into the padded vertex tensor consumed by the
    point-in-polygon kernel (ops/geofence.py, csrc/geofence.cu) — the JTS
    poly.contains() of the reference's ZoneTestRuleProcessor.java:47-52 becomes
    a crossing-number test over all zones at once.
    """

    area_id: str = ""
    bounds: List[Location] = field(default_factory=list)
    border_color: str = "#000000"
    fill_color: str = "#dddddd"
    opacity: float = 0.3
