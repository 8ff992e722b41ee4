"""Device-indexed registry lookup tensors: the device-side mirror of the
registry.

Counterpart of `sitewhere_tpu/registry/tensors.py`. Validation inside the
fused step is a gather + compare against these columns instead of a
per-event registry lookup. The mirror is fed two ways: `attach` mirrors a
tenant's control-plane store (`registry/store.py` DeviceManagement) and
follows its mutations through a listener, as the reference does; and rows
can be written directly, `mirror_devices` in bulk and `mirror_zone` per
zone (the full-size worlds of chip_smoke.py and the tests). Each device row
remembers the token it was written for, so `rebuild` can move the rows to
the device interner's indices after a checkpoint restore replaced them.

Columns (capacity D = max_devices, index = device interner index, row 0 =
UNKNOWN sentinel, always status 0):
  assignment_status  int32[D]  0 = unregistered/no active assignment,
                               1 = ACTIVE (DeviceAssignmentStatus)
  tenant_idx         int32[D]  interned tenant
  area_idx           int32[D]  interned area of the active assignment
  device_type_idx    int32[D]  interned device type
  assignment_idx     int32[D]  interned assignment token
Zone geometry for the geofence kernel:
  zone_vertices f32[Z, V, 2]  (lat, lon), padded by repeating the last vertex
  zone_nvert    int32[Z]      actual vertex count
  zone_tenant   int32[Z], zone_area int32[Z], zone_active bool[Z]
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from sitewhere_tpu_torch.registry.interning import TokenInterner

ASSIGNMENT_ACTIVE = 1
# the device-indexed columns (the rest are zone-indexed)
_DEVICE_COLUMNS = ("assignment_status", "tenant_idx", "area_idx",
                   "device_type_idx", "assignment_idx")


@dataclass
class RegistrySnapshot:
    """Frozen numpy view handed to the engine's params refresh."""

    assignment_status: np.ndarray
    tenant_idx: np.ndarray
    area_idx: np.ndarray
    device_type_idx: np.ndarray
    assignment_idx: np.ndarray
    zone_vertices: np.ndarray
    zone_nvert: np.ndarray
    zone_tenant: np.ndarray
    zone_area: np.ndarray
    zone_active: np.ndarray
    version: int


def _per_row(value, n: int) -> list:
    """A scalar (str/int) repeated n times, or a length-n sequence."""
    if isinstance(value, (str, int, np.integer)):
        return [value] * n
    value = list(value)
    if len(value) != n:
        raise ValueError(f"expected {n} values, got {len(value)}")
    return value


class RegistryTensors:
    """Host-side columns of the registry mirror plus the interners that
    assign their rows. `snapshot()` returns a consistent copy with a version
    counter the engine compares to decide when to refresh its device
    params."""

    def __init__(self, max_devices: int, max_zones: int,
                 max_zone_vertices: int, shard_classes: int = 1):
        # shard_classes = the sharded engine's shard count: device indices
        # allocate within crc32(token) % S congruence classes, so shard
        # ownership (idx % S) depends only on the token
        self.devices = TokenInterner(max_devices, "devices",
                                     shard_classes=shard_classes)
        self.tenants = TokenInterner(64, "tenants")
        self.areas = TokenInterner(4096, "areas")
        self.device_types = TokenInterner(4096, "device_types")
        self.assignments = TokenInterner(max_devices, "assignments")
        self.zones_interner = TokenInterner(max_zones + 1, "zones")
        self.max_zones = max_zones
        self.max_zone_vertices = max_zone_vertices

        D = max_devices
        self._assignment_status = np.zeros(D, np.int32)
        self._tenant_idx = np.zeros(D, np.int32)
        self._area_idx = np.zeros(D, np.int32)
        self._device_type_idx = np.zeros(D, np.int32)
        self._assignment_idx = np.zeros(D, np.int32)
        # the device token each row was mirrored for (None = no row)
        self._row_token = np.full(D, None, object)

        Z, V = max_zones, max_zone_vertices
        self._zone_vertices = np.zeros((Z, V, 2), np.float32)
        self._zone_nvert = np.zeros(Z, np.int32)
        self._zone_tenant = np.zeros(Z, np.int32)
        self._zone_area = np.zeros(Z, np.int32)
        self._zone_active = np.zeros(Z, bool)

        self._version = 0
        self._lock = threading.Lock()
        # attached control-plane stores by tenant token, and device entity
        # id -> row, to retire a renamed token's row
        self._managements: Dict[str, object] = {}
        self._idx_by_device_id: Dict[str, int] = {}

    # -- attached stores ------------------------------------------------------

    def attach(self, management, tenant_token: str) -> None:
        """Mirror a tenant's DeviceManagement and follow its mutations."""
        tenant_idx = self.tenants.intern(tenant_token)
        self._managements[tenant_token] = management
        management.add_listener(
            lambda kind, entity: self._on_change(management, tenant_idx,
                                                 kind, entity))
        self._full_rebuild(management, tenant_idx)

    def _on_change(self, management, tenant_idx: int, kind: str,
                   entity) -> None:
        if kind in ("device", "assignment"):
            with self._lock:
                if kind == "assignment":
                    device = management.devices.get(entity.device_id)
                else:
                    device = (entity if entity.id in management.devices.by_id
                              else None)
                    if device is None:  # deleted device
                        idx = self.devices.lookup(entity.token)
                        if idx:
                            self._assignment_status[idx] = 0
                        self._idx_by_device_id.pop(entity.id, None)
                        self._version += 1
                        return
                if device is not None:
                    self._mirror_device(management, tenant_idx, device)
                self._version += 1
        elif kind == "zone":
            with self._lock:
                self._mirror_zone(tenant_idx, entity,
                                  active=entity.id in management.zones.by_id)
                self._version += 1

    def _mirror_device(self, management, tenant_idx: int, device) -> None:
        idx = self.devices.intern(device.token)
        self._row_token[idx] = device.token
        prior = self._idx_by_device_id.get(device.id)
        if prior is not None and prior != idx:
            # token renamed: the retired token's row must stop validating
            self._assignment_status[prior] = 0
            self._assignment_idx[prior] = 0
        self._idx_by_device_id[device.id] = idx
        assignment = management.get_active_assignment(device.id)
        if assignment is None:
            self._assignment_status[idx] = 0
            self._tenant_idx[idx] = tenant_idx
            self._assignment_idx[idx] = 0
            return
        self._assignment_status[idx] = int(assignment.status)
        self._tenant_idx[idx] = tenant_idx
        area = management.areas.get(assignment.area_id)
        self._area_idx[idx] = self.areas.intern(area.token) if area else 0
        dtype = management.device_types.get(device.device_type_id)
        self._device_type_idx[idx] = (
            self.device_types.intern(dtype.token) if dtype else 0)
        self._assignment_idx[idx] = self.assignments.intern(assignment.token)

    def _mirror_zone(self, tenant_idx: int, zone, active: bool = True) -> None:
        zidx = self.zones_interner.intern(zone.token) - 1  # row 0 = zone idx 1
        if not (0 <= zidx < self.max_zones):
            return
        verts = [(b.latitude, b.longitude) for b in zone.bounds]
        n = min(len(verts), self.max_zone_vertices)
        self._zone_active[zidx] = active and n >= 3
        self._zone_nvert[zidx] = n
        self._zone_tenant[zidx] = tenant_idx
        if verts:
            arr = np.asarray(verts[:n], np.float32)
            self._zone_vertices[zidx, :n] = arr
            self._zone_vertices[zidx, n:] = arr[-1]
        management = self._managements.get(
            self.tenants.token_of(tenant_idx) or "")
        if management is not None:
            area = management.areas.get(zone.area_id)
            self._zone_area[zidx] = self.areas.intern(area.token) if area else 0

    def _full_rebuild(self, management, tenant_idx: int) -> None:
        with self._lock:
            for device in management.devices.all():
                self._mirror_device(management, tenant_idx, device)
            for zone in management.zones.all():
                self._mirror_zone(tenant_idx, zone)
            self._version += 1

    # -- mirroring ------------------------------------------------------------

    def mirror_devices(self, tokens: Sequence[str],
                       tenant: Union[str, Sequence[str]],
                       device_type: Union[str, Sequence[str]] = "",
                       status: Union[int, Sequence[int]] = ASSIGNMENT_ACTIVE,
                       area: Union[str, Sequence[str]] = ""
                       ) -> np.ndarray:
        """Mirror many devices at once; returns their int32 indices.

        `tenant`, `device_type`, `status` and `area` are one value for all
        rows or one per row; "" leaves a token column at 0 (no area, no
        type). A status of 0 marks the device registered without an active
        assignment: events for it are flagged unregistered, and its area,
        type and assignment columns are not written (as the reference
        mirrors a device without an assignment). An active device's
        assignment token is "as-<token>"."""
        n = len(tokens)
        tenants = _per_row(tenant, n)
        dtypes = _per_row(device_type, n)
        statuses = _per_row(status, n)
        areas = _per_row(area, n)
        idx = np.empty(n, np.int32)
        with self._lock:
            for i, token in enumerate(tokens):
                d = self.devices.intern(token)
                idx[i] = d
                self._row_token[d] = token
                st = int(statuses[i])
                self._assignment_status[d] = st
                self._tenant_idx[d] = self.tenants.intern(tenants[i])
                if not st:
                    self._assignment_idx[d] = 0
                    continue
                self._area_idx[d] = (self.areas.intern(areas[i])
                                     if areas[i] else 0)
                self._device_type_idx[d] = (
                    self.device_types.intern(dtypes[i]) if dtypes[i] else 0)
                self._assignment_idx[d] = self.assignments.intern(
                    f"as-{token}")
            self._version += 1
        return idx

    def mirror_zone(self, token: str, tenant: str,
                    bounds: Sequence[Tuple[float, float]], area: str = "",
                    active: bool = True) -> int:
        """Mirror one zone polygon given as (lat, lon) vertices; returns its
        table row. Bounds beyond `max_zone_vertices` are cut, and a zone
        with fewer than 3 vertices stays inactive."""
        with self._lock:
            zidx = self.zones_interner.intern(token) - 1  # row 0 = zone idx 1
            verts = [(float(lat), float(lon)) for lat, lon in bounds]
            n = min(len(verts), self.max_zone_vertices)
            self._zone_active[zidx] = active and n >= 3
            self._zone_nvert[zidx] = n
            self._zone_tenant[zidx] = self.tenants.intern(tenant)
            self._zone_area[zidx] = self.areas.intern(area) if area else 0
            if verts:
                arr = np.asarray(verts[:n], np.float32)
                self._zone_vertices[zidx, :n] = arr
                # pad by repeating the last vertex: degenerate edges never
                # toggle the crossing-number parity in the geofence kernel
                self._zone_vertices[zidx, n:] = arr[-1]
            self._version += 1
            return zidx

    # -- reads ----------------------------------------------------------------

    def tenant_of_device(self, token: str) -> Optional[str]:
        """Tenant token owning a device token (host-side reverse lookup)."""
        idx = self.devices.lookup(token)
        if idx <= 0:
            return None
        with self._lock:
            tenant_idx = int(self._tenant_idx[idx])
        return self.tenants.token_of(tenant_idx)

    @property
    def version(self) -> int:
        return self._version

    def snapshot(self) -> RegistrySnapshot:
        with self._lock:
            return RegistrySnapshot(
                assignment_status=self._assignment_status.copy(),
                tenant_idx=self._tenant_idx.copy(),
                area_idx=self._area_idx.copy(),
                device_type_idx=self._device_type_idx.copy(),
                assignment_idx=self._assignment_idx.copy(),
                zone_vertices=self._zone_vertices.copy(),
                zone_nvert=self._zone_nvert.copy(),
                zone_tenant=self._zone_tenant.copy(),
                zone_area=self._zone_area.copy(),
                zone_active=self._zone_active.copy(),
                version=self._version,
            )

    def load_snapshot(self, arrays: dict) -> None:
        """Replace every column with the given arrays (keys: the
        RegistrySnapshot field names; shapes must match this mirror)."""
        with self._lock:
            for name in _DEVICE_COLUMNS + (
                    "zone_vertices", "zone_nvert", "zone_tenant",
                    "zone_area", "zone_active"):
                dst = getattr(self, "_" + name)
                src = np.asarray(arrays[name]).astype(dst.dtype, copy=False)
                if src.shape != dst.shape:
                    raise ValueError(
                        f"registry column {name}: got shape {src.shape}, "
                        f"mirror holds {dst.shape}")
                dst[...] = src
            self._row_token[:] = None
            tokens = self.devices.snapshot()[:len(self._row_token)]
            self._row_token[:len(tokens)] = tokens
            self._version += 1

    def rebuild(self) -> None:
        """Re-mirror every device row under the device interner's CURRENT
        index of its token (interning tokens it no longer holds). Needed
        after a checkpoint restore replaced the interner's assignment —
        a snapshot of another layout (a sharded engine's shard-congruent
        one) moves tokens to other indices; rows of no token clear."""
        with self._lock:
            old = np.array([i for i, t in enumerate(self._row_token)
                            if t is not None], np.int64)
            new = np.array([self.devices.intern(self._row_token[i])
                            for i in old], np.int64)
            for name in _DEVICE_COLUMNS:
                col = getattr(self, "_" + name)
                moved = np.zeros_like(col)
                moved[new] = col[old]
                col[...] = moved
            tokens = self._row_token[old]
            self._row_token[:] = None
            self._row_token[new] = tokens
            self._idx_by_device_id.clear()
            self._version += 1
        # attached stores re-mirror as the reference's rebuild does
        for tenant_token, management in self._managements.items():
            self._full_rebuild(management, self.tenants.intern(tenant_token))
