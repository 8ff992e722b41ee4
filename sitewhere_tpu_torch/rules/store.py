"""Durable install registries: scripted rules and rule programs.

Counterpart of `sitewhere_tpu/rules/store.py` (and, through `SpecStore`,
of `sitewhere_tpu/ml/store.py` and `sitewhere_tpu/actuation/store.py`).
Reference: scripted (Groovy) rule processors exist cluster-wide and
survive restarts because their configuration lives in ZooKeeper and syncs
to every node's disk (ScriptSynchronizer.java:32,
ZookeeperScriptManagement.java). Here every INSTALL — (tenant, token) ->
payload — lives in one JSON file under the instance data_dir, with a
last-writer-wins stamp per install so cluster gossip converges the same
way the registry does, and removal tombstones. The file format is the
reference's, so either package reads the other's store.

`InstallStore` holds the algebra once; a store names its file, its
payload field and its LWW tiebreak on equal stamps:
  ScriptedRuleStore   {"script": script_id}; tiebreak: the script id
  SpecStore           {"spec": normalized spec}; tiebreak: the spec's
                      canonical JSON (the payload IS the identity, so
                      appliers are idempotent and order-free)
  RuleProgramStore    a SpecStore of rule programs (rules/compiler.py)
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.model.event import now_ms


class InstallStore:
    """(tenant, token) -> {FIELD: payload, "stamp"}; JSON-durable, LWW,
    with removal tombstones."""

    FILE = ""            # file name under data_dir
    FIELD = ""           # payload field of an install row
    WHAT = ""            # what the store holds, for log lines
    LOGGER = logging.getLogger("sitewhere.rules.store")

    def __init__(self, data_dir: Optional[str] = None):
        self._path = (os.path.join(data_dir, self.FILE)
                      if data_dir else None)
        self._lock = threading.Lock()
        # (tenant, token) -> {FIELD: payload, "stamp": int}
        self._installs: Dict[tuple, Dict] = {}
        self._tombstones: Dict[tuple, int] = {}
        self._listeners: List[Callable] = []
        self._load()

    # -- payload hooks -----------------------------------------------------
    @staticmethod
    def _copy(payload):
        return payload

    @staticmethod
    def _tiebreak(payload):
        return payload

    def _row(self, payload, stamp: int) -> Dict:
        return {self.FIELD: self._copy(payload), "stamp": stamp}

    # -- durability --------------------------------------------------------
    def _load(self) -> None:
        if not self._path or not os.path.exists(self._path):
            return
        try:
            with open(self._path, encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            self.LOGGER.exception("unreadable %s store %s", self.WHAT,
                                  self._path)
            return
        for row in data.get("installs", []):
            self._installs[(row["tenant"], row["token"])] = {
                self.FIELD: row[self.FIELD],
                "stamp": int(row.get("stamp", 0))}
        for row in data.get("tombstones", []):
            self._tombstones[(row["tenant"], row["token"])] = int(
                row.get("stamp", 0))

    def _sync(self) -> None:
        if not self._path:
            return
        data = {
            "installs": [{"tenant": t, "token": k, **v}
                         for (t, k), v in sorted(self._installs.items())],
            "tombstones": [{"tenant": t, "token": k, "stamp": s}
                           for (t, k), s in sorted(self._tombstones.items())],
        }
        tmp = f"{self._path}.{os.getpid()}.tmp"
        os.makedirs(os.path.dirname(self._path), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(data, fh)
        os.replace(tmp, self._path)

    # -- replication surface ----------------------------------------------
    def add_listener(self, fn: Callable) -> None:
        """fn(op: "add"|"remove", tenant, token, payload) — fired on LOCAL
        mutations only (record/erase, not apply_*)."""
        self._listeners.append(fn)

    def _notify(self, op: str, tenant: str, token: str, payload) -> None:
        for fn in list(self._listeners):
            try:
                fn(op, tenant, token, payload)
            except Exception:
                self.LOGGER.exception("%s listener failed (%s %s/%s)",
                                      self.WHAT, op, tenant, token)

    # -- mutations ---------------------------------------------------------
    def record(self, tenant: str, token: str, payload,
               notify: bool = True) -> Dict:
        """Local install; returns the row the gossip side publishes.
        ``notify=False`` defers the listener fire to the caller (via
        `emit`) — for callers holding an outer lock who must not publish
        to peers inside their critical section."""
        with self._lock:
            stamp = max(now_ms(),
                        self._tombstones.get((tenant, token), -1) + 1,
                        self._installs.get((tenant, token),
                                           {"stamp": -1})["stamp"] + 1)
            row = self._row(payload, stamp)
            self._installs[(tenant, token)] = row
            self._tombstones.pop((tenant, token), None)
            self._sync()
        if notify:
            self._notify("add", tenant, token, row)
        return row

    def erase(self, tenant: str, token: str,
              notify: bool = True) -> Optional[int]:
        """Local removal; returns the tombstone stamp (None if unknown)."""
        with self._lock:
            existing = self._installs.pop((tenant, token), None)
            if existing is None:
                return None
            stamp = max(now_ms(), existing["stamp"] + 1)
            self._tombstones[(tenant, token)] = stamp
            self._sync()
        if notify:
            self._notify("remove", tenant, token, stamp)
        return stamp

    def emit(self, op: str, tenant: str, token: str, payload) -> None:
        """Fire the deferred listener notification for a record/erase done
        with ``notify=False`` — call OUTSIDE any lock (listeners publish
        to peer bus edges). The stamp in the payload is what peers order
        by."""
        self._notify(op, tenant, token, payload)

    def _add_wins_locked(self, key: tuple, payload, stamp: int) -> bool:
        if stamp <= self._tombstones.get(key, -1):
            return False
        local = self._installs.get(key)
        return local is None or (
            (local["stamp"], self._tiebreak(local[self.FIELD]))
            < (stamp, self._tiebreak(payload)))

    def would_apply_add(self, tenant: str, token: str, payload,
                        stamp: int) -> bool:
        """Non-mutating LWW check: would `apply_add` win right now? Lets a
        caller attach the live install BEFORE committing the store (an
        attach that fails must leave the store unchanged so redelivery
        retries cleanly)."""
        with self._lock:
            return self._add_wins_locked((tenant, token), payload, stamp)

    def apply_add(self, tenant: str, token: str, payload,
                  stamp: int) -> bool:
        """Replicated install: LWW against local install/tombstone;
        idempotent, never notifies. Returns True when it newly wins."""
        with self._lock:
            key = (tenant, token)
            if not self._add_wins_locked(key, payload, stamp):
                return False
            self._installs[key] = self._row(payload, stamp)
            self._tombstones.pop(key, None)
            self._sync()
            return True

    def apply_remove(self, tenant: str, token: str, stamp: int) -> bool:
        with self._lock:
            key = (tenant, token)
            local = self._installs.get(key)
            if local is not None and local["stamp"] > stamp:
                return False
            self._tombstones[key] = max(stamp,
                                        self._tombstones.get(key, -1))
            if local is None:
                # no install to remove, but the tombstone must still be
                # DURABLE: a remove that arrives before its add (cross-host
                # reorder) otherwise vanishes on restart and the
                # redelivered older add resurrects the install here
                self._sync()
                return False
            del self._installs[key]
            self._sync()
            return True

    # -- reads -------------------------------------------------------------
    def installs_for(self, tenant: str) -> List[Dict]:
        with self._lock:
            return [{"token": token, self.FIELD: self._copy(v[self.FIELD]),
                     "stamp": v["stamp"]}
                    for (t, token), v in sorted(self._installs.items())
                    if t == tenant]

    def all_installs(self) -> List[Dict]:
        with self._lock:
            return [{"tenant": t, "token": token,
                     self.FIELD: self._copy(v[self.FIELD]),
                     "stamp": v["stamp"]}
                    for (t, token), v in sorted(self._installs.items())]

    def get(self, tenant: str, token: str) -> Optional[Dict]:
        with self._lock:
            v = self._installs.get((tenant, token))
            return self._row(v[self.FIELD], v["stamp"]) if v else None

    def export_state(self) -> Dict:
        """Checkpoint payload (installs only; tombstones are a gossip
        convergence aid, not durable state worth moving cross-topology)."""
        with self._lock:
            return {"installs": [{"tenant": t, "token": k, **v}
                                 for (t, k), v in
                                 sorted(self._installs.items())]}


class ScriptedRuleStore(InstallStore):
    """(tenant, token) -> {script, stamp}: scripted-rule installs."""

    FILE, FIELD, WHAT = "scripted_rules.json", "script", "scripted-rule"


class SpecStore(InstallStore):
    """(tenant, token) -> {spec, stamp}: installs of compiled specs; the
    LWW tiebreak on equal stamps compares the spec's canonical JSON so
    every host converges on the same winner."""

    FIELD = "spec"

    @staticmethod
    def _copy(payload):
        return dict(payload)

    @staticmethod
    def _tiebreak(payload):
        return json.dumps(payload, sort_keys=True, separators=(",", ":"))


class RuleProgramStore(SpecStore):
    """Durable rule-program installs (rules/compiler.py)."""

    FILE, WHAT = "rule_programs.json", "rule-program"
