"""Recovery epochs, write fencing, leased ownership, and the replay
output barrier — the cluster-grade recovery semantics layered over the
crash-safe artifacts from persist/.

Counterpart of `sitewhere_tpu/runtime/recovery.py`, pure Python: the
checkpointer stamps its epoch into every manifest, and the command fan-out
(actuation/dispatcher.py) consults GLOBAL_REPLAY_BARRIER.

Reference: the platform this reproduces leans on ZooKeeper for exactly
this job — ephemeral ownership znodes with monotonic zxid fencing so a
partitioned microservice that comes back cannot keep writing with
pre-partition state. Here the same three primitives are host-local and
explicit:

  epoch     a monotonic integer minted on every engine boot/takeover
            (durable in ``recovery-epoch.json`` under data_dir), stamped
            into checkpoint manifests, gossip/replication envelopes, and
            busnet RPCs
  fence     per-resource epoch floors; a write carrying an epoch below
            the floor is rejected with a counted StaleEpochError — the
            zombie/split-brain guard
  lease     TTL ownership renewed over the existing heartbeat edges;
            expiry (or a `failed` health ladder) triggers a takeover by
            the deterministic successor (lowest healthy peer rank)

The replay barrier makes checkpoint replay exactly-once in its
*effects*: the instance checkpoint captures per-tenant eventlog
high-watermarks, so on restore the rows already durable beyond the
checkpoint are a known per-tenant budget; while the budget lasts,
replayed inbound records rebuild device/rule/model state but are
suppressed from re-persisting and re-firing alert fan-out, command
delivery, and analytics increments (`replay.suppressed_effects`).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

LOGGER = logging.getLogger("sitewhere.recovery")

EPOCH_FILE = "recovery-epoch.json"

# process-wide fallback when there is no data_dir (in-memory instances):
# still monotonic within the process, which is all a non-durable
# instance can promise anyway
_mem_epoch = 0
_mem_lock = threading.Lock()


class StaleEpochError(Exception):
    """A write carried an epoch below the fenced floor for its resource.

    Structured (resource/epoch/floor ride the exception) so receivers
    can reject without string-matching, and counted on
    ``fencing.rejected`` at every rejection site.
    """

    def __init__(self, resource: str, epoch: int, floor: int):
        super().__init__(
            f"stale epoch {epoch} < fenced floor {floor} for "
            f"'{resource}'")
        self.resource = resource
        self.epoch = epoch
        self.floor = floor


def stored_epoch(data_dir: Optional[str]) -> int:
    """Read the durable epoch without minting (0 when never minted)."""
    if not data_dir:
        return _mem_epoch
    path = os.path.join(data_dir, EPOCH_FILE)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return int(json.load(fh).get("epoch", 0))
    except (OSError, ValueError):
        return 0


def mint_epoch(data_dir: Optional[str]) -> int:
    """Mint the next recovery epoch: read, increment, fsync, rename.

    Called once per engine boot or takeover. Durable under data_dir so a
    restarted host always comes back ABOVE any floor it was fenced at
    (floor = last_seen + 1 == restarted mint), re-admitting it without
    operator action.
    """
    global _mem_epoch
    if not data_dir:
        with _mem_lock:
            _mem_epoch += 1
            return _mem_epoch
    os.makedirs(data_dir, exist_ok=True)
    epoch = stored_epoch(data_dir) + 1
    path = os.path.join(data_dir, EPOCH_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({"epoch": epoch}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return epoch


class EpochFence:
    """Per-resource epoch floors. ``observe`` learns floors from traffic
    (a resource's own newer epoch fences its older incarnations);
    ``fence`` raises a floor explicitly (the takeover broadcast);
    ``check`` rejects stale writers with a counted StaleEpochError."""

    def __init__(self, metrics=GLOBAL_METRICS):
        self._floors: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._rejected = metrics.counter("fencing.rejected")

    def floor(self, resource: str) -> int:
        with self._lock:
            return self._floors.get(resource, 0)

    def observe(self, resource: str, epoch: int) -> None:
        """Learn: a resource's highest seen epoch becomes its floor."""
        with self._lock:
            if epoch > self._floors.get(resource, 0):
                self._floors[resource] = int(epoch)

    def fence(self, resource: str, epoch: int) -> int:
        """Raise the floor to at least `epoch`; returns the floor."""
        with self._lock:
            floor = max(self._floors.get(resource, 0), int(epoch))
            self._floors[resource] = floor
        LOGGER.info("fenced '%s' at epoch %d", resource, floor)
        return floor

    def admit(self, resource: str, epoch: int) -> bool:
        """True when the write may proceed; counts rejections."""
        with self._lock:
            floor = self._floors.get(resource, 0)
            if epoch < floor:
                self._rejected.inc()
                return False
            if epoch > floor:
                self._floors[resource] = int(epoch)
            return True

    def check(self, resource: str, epoch: int) -> None:
        if not self.admit(resource, epoch):
            raise StaleEpochError(resource, epoch, self.floor(resource))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._floors)

    @property
    def rejected(self) -> int:
        return self._rejected.value


@dataclass
class Lease:
    resource: str
    owner: str
    epoch: int
    ttl_s: float
    renewed_at: float  # monotonic seconds

    def expired(self, now: float) -> bool:
        return now - self.renewed_at > self.ttl_s

    def to_json(self, now: float) -> Dict:
        return {"resource": self.resource, "owner": self.owner,
                "epoch": self.epoch, "ttl_s": self.ttl_s,
                "age_s": round(now - self.renewed_at, 3),
                "expired": self.expired(now)}


class LeaseTable:
    """TTL ownership records judged on a monotonic clock (injectable for
    deterministic tests). Acquire succeeds against a free, expired, or
    own lease — or steals a live one only with a strictly higher epoch
    (the takeover path: the successor fenced the old epoch first, so the
    steal and the fence are one decision). Renewals are counted
    (`lease.renewals`) and only the current owner with a current-or-newer
    epoch renews, so two hosts can never both hold a live lease."""

    def __init__(self, metrics=GLOBAL_METRICS,
                 clock: Callable[[], float] = time.monotonic):
        self._leases: Dict[str, Lease] = {}
        self._lock = threading.Lock()
        self._clock = clock
        self._renewals = metrics.counter("lease.renewals")

    def acquire(self, resource: str, owner: str, epoch: int,
                ttl_s: float, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(resource)
            if (lease is not None and not lease.expired(now)
                    and lease.owner != owner and epoch <= lease.epoch):
                return False  # live lease held elsewhere, no fencing steal
            self._leases[resource] = Lease(resource, owner, int(epoch),
                                           float(ttl_s), now)
            return True

    def renew(self, resource: str, owner: str, epoch: int,
              now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(resource)
            if lease is None or lease.owner != owner \
                    or epoch < lease.epoch:
                return False
            lease.renewed_at = now
            lease.epoch = max(lease.epoch, int(epoch))
            self._renewals.inc()
            return True

    def release(self, resource: str, owner: str) -> bool:
        """Drop the lease if `owner` holds it (takeover handback when the
        original owner returns above its fenced floor)."""
        with self._lock:
            lease = self._leases.get(resource)
            if lease is None or lease.owner != owner:
                return False
            del self._leases[resource]
            return True

    def holder(self, resource: str,
               now: Optional[float] = None) -> Optional[str]:
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(resource)
            if lease is None or lease.expired(now):
                return None
            return lease.owner

    def expired(self, resource: str,
                now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(resource)
            return lease is not None and lease.expired(now)

    def get(self, resource: str) -> Optional[Lease]:
        with self._lock:
            return self._leases.get(resource)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Dict]:
        now = self._clock() if now is None else now
        with self._lock:
            return {r: lease.to_json(now)
                    for r, lease in self._leases.items()}


def elect_successor(healthy_by_rank: Dict[int, bool],
                    exclude: Optional[int] = None) -> Optional[int]:
    """Deterministic successor: the lowest healthy peer rank. Every host
    computes the same answer from the same health view, so no election
    round-trip is needed — at most one host believes it is the
    successor."""
    candidates = sorted(rank for rank, healthy in healthy_by_rank.items()
                        if healthy and rank != exclude)
    return candidates[0] if candidates else None


class ReplayBarrier:
    """Output barrier for checkpoint replay: per-tenant budgets of rows
    already durable beyond the restored checkpoint. While a tenant's
    budget lasts, replayed inbound records rebuild state but are
    suppressed from re-persisting and re-firing effects — `take`
    consumes budget and counts `replay.suppressed_effects`. Disarmed
    (`active()` False) the hot-path check is one dict read under no
    contention."""

    def __init__(self, metrics=GLOBAL_METRICS):
        self._budgets: Dict[str, int] = {}
        self._marks: Dict[str, Dict[str, int]] = {}
        self._lock = threading.Lock()
        self._armed = False
        self._suppressed = metrics.counter("replay.suppressed_effects")

    def arm(self, budgets: Dict[str, int],
            watermarks: Optional[Dict[str, Dict[str, int]]] = None) -> None:
        with self._lock:
            self._budgets = {t: int(n) for t, n in budgets.items()
                             if int(n) > 0}
            # the per-tenant (id_prefix -> max id_seq) watermarks behind
            # the budgets: the straggler deduplicator seeds from these
            self._marks = {t: dict(m)
                           for t, m in (watermarks or {}).items()}
            self._armed = bool(self._budgets)
        if self._armed:
            LOGGER.info("replay barrier armed: %s", self._budgets)

    def disarm(self) -> None:
        with self._lock:
            self._budgets = {}
            self._marks = {}
            self._armed = False

    def watermarks(self, tenant: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._marks.get(tenant, {}))

    def active(self, tenant: Optional[str] = None) -> bool:
        if not self._armed:
            return False
        with self._lock:
            if tenant is None:
                return bool(self._budgets)
            return self._budgets.get(tenant, 0) > 0

    def remaining(self, tenant: str) -> int:
        with self._lock:
            return self._budgets.get(tenant, 0)

    def take(self, tenant: str, n: int) -> int:
        """Consume up to `n` rows of the tenant's budget; returns how
        many of the `n` are replay duplicates to suppress."""
        if not self._armed or n <= 0:
            return 0
        with self._lock:
            budget = self._budgets.get(tenant, 0)
            if budget <= 0:
                return 0
            took = min(budget, int(n))
            left = budget - took
            if left:
                self._budgets[tenant] = left
            else:
                del self._budgets[tenant]
                if not self._budgets:
                    self._armed = False
        self._suppressed.inc(took)
        return took

    @property
    def suppressed(self) -> int:
        return self._suppressed.value


# module singletons, mirroring GLOBAL_METRICS / GLOBAL_ADMISSION: the
# inbound hot path and the checkpoint manager must agree on one barrier
# without threading it through every constructor
GLOBAL_REPLAY_BARRIER = ReplayBarrier()
GLOBAL_FENCE = EpochFence()

# checkpointed AlternateIdDeduplicator windows, stashed at boot restore
# and claimed when each event source starts: restore_on_boot runs before
# tenant engines exist (and sources are registered even later), so the
# hand-off has to cross that lifecycle gap
_dedup_seeds: Dict[tuple, list] = {}
_seed_lock = threading.Lock()


def stash_dedup_seeds(windows: Dict[str, Dict[str, list]]) -> None:
    """Stage `{tenant: {source_id: [alternate ids, oldest first]}}` for
    event sources that have not started yet."""
    with _seed_lock:
        for tenant, per_source in (windows or {}).items():
            for source_id, ids in (per_source or {}).items():
                _dedup_seeds[(str(tenant), str(source_id))] = list(ids)


def take_dedup_seed(tenant: str, source_id: str) -> Optional[list]:
    """Claim (pop) a staged window; None when nothing was checkpointed."""
    with _seed_lock:
        return _dedup_seeds.pop((str(tenant), str(source_id)), None)
