"""Script management: named, versioned user scripts with live activation.

Reference: the Groovy scripting stack — GroovyComponent.java:32 (script
host), ScriptSynchronizer.java (ZK -> local-disk sync),
ZookeeperScriptManagement.java (versioned script storage), and the REST
surface at Instance.java:304-560 (create/list scripts, versioned content,
clone, activate, delete; global and per-tenant scopes).

The TPU rebuild keeps the shape but swaps Groovy for Python source: a script
is versioned text whose ACTIVE version is compiled into a module namespace;
`resolve(scope, id, entry)` hands components a stable proxy callable that
always dispatches to the active version, so activating a new version
hot-swaps behavior without rebinding decoders/connectors (the reference
restarts components on ZK script-change events; the proxy makes that
unnecessary). With a data_dir, scripts sync to disk as .py + meta.json and
reload on start (the ScriptSynchronizer role).

Scripts are an operator extension point: like Groovy in the reference they
execute with full interpreter privileges — deployment trust model, not a
sandbox.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.common import now_ms
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent

GLOBAL_SCOPE = "global"
LOGGER = logging.getLogger("sitewhere.scripts")
# filesystem- and route-safe: single path segment, no traversal
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


@dataclass
class ScriptVersion:
    version_id: str
    comment: str = ""
    created_ms: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"versionId": self.version_id, "comment": self.comment,
                "createdDate": self.created_ms}


@dataclass
class ScriptInfo:
    script_id: str
    name: str = ""
    description: str = ""
    active_version: Optional[str] = None
    versions: List[ScriptVersion] = field(default_factory=list)
    # last-writer-wins stamp for cross-host replication (cluster gossip);
    # bumped on every mutation, adopted from the winner on apply
    updated_ms: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"scriptId": self.script_id, "name": self.name,
                "description": self.description,
                "activeVersion": self.active_version,
                "updatedMs": self.updated_ms,
                "versions": [v.to_json() for v in self.versions]}


class _ScriptProxy:
    """Stable callable bound to (manager, scope, script_id, entry): always
    dispatches to the active version's compiled namespace."""

    def __init__(self, manager: "ScriptManager", scope: str, script_id: str,
                 entry: str):
        self._m = manager
        self._key = (scope, script_id)
        self._entry = entry

    def __call__(self, *args, **kwargs):
        fn = self._m._active_entry(self._key, self._entry)
        return fn(*args, **kwargs)


class ScriptManager(LifecycleComponent):
    """Versioned script registry, scoped (GLOBAL_SCOPE or a tenant token)."""

    def __init__(self, data_dir: Optional[str] = None):
        super().__init__("script-manager")
        self._data_dir = data_dir
        self._lock = threading.RLock()
        # (scope, script_id) -> ScriptInfo
        self._scripts: Dict[tuple, ScriptInfo] = {}
        # (scope, script_id, version_id) -> source text
        self._content: Dict[tuple, str] = {}
        # (scope, script_id) -> compiled namespace of the active version
        self._namespaces: Dict[tuple, Dict[str, Any]] = {}
        # (scope, script_id) -> deletion stamp: an upsert older than the
        # tombstone stays dead; a NEWER one resurrects (same contract as
        # the registry gossip tombstones, parallel/cluster.py). DURABLE
        # (tombstones.json): a checkpoint restore or a post-restart gossip
        # redelivery replays stale upserts, and without the persisted
        # stamp a deleted script would come back on this host alone.
        self._tombstones: Dict[tuple, int] = {}
        # mutation listeners: fn(op: "upsert"|"delete", scope, script_id,
        # state_or_stamp) — called AFTER the mutation, outside the lock
        # (cluster gossip replicates through this)
        self._listeners: List[Callable] = []

    # -- lifecycle / disk sync ---------------------------------------------

    def on_start(self, monitor) -> None:
        if self._data_dir:
            self._load_tombstones()
            self._load_from_disk()

    def _tombstones_path(self) -> str:
        return os.path.join(self._data_dir, "scripts", "tombstones.json")

    def _load_tombstones(self) -> None:
        path = self._tombstones_path()
        if not os.path.exists(path):
            return
        try:
            with open(path, encoding="utf-8") as fh:
                rows = json.load(fh)
            for row in rows:
                self._tombstones[(row["scope"], row["scriptId"])] = int(
                    row.get("stamp", 0))
        except (OSError, ValueError, TypeError, KeyError):
            # corrupt tombstones must not block startup (same contract as
            # _load_from_disk for corrupt script dirs)
            LOGGER.exception("unreadable script tombstones %s", path)

    def _sync_tombstones_locked(self) -> None:
        if not self._data_dir:
            return
        rows = [{"scope": s, "scriptId": sid, "stamp": stamp}
                for (s, sid), stamp in sorted(self._tombstones.items())]
        os.makedirs(os.path.join(self._data_dir, "scripts"), exist_ok=True)
        self._atomic_write(self._tombstones_path(), json.dumps(rows))

    def _scope_dir(self, scope: str) -> str:
        # Percent-encode: collision-free for arbitrary scopes ("a/b" vs
        # "a_b" previously mapped to the same directory and one scope's
        # meta.json silently overwrote the other's). Reload is unaffected
        # either way — meta.json records the true scope.
        from urllib.parse import quote
        return os.path.join(self._data_dir, "scripts",
                            quote(scope, safe=""))

    def _sync_to_disk(self, scope: str, info: ScriptInfo) -> None:
        if not self._data_dir:
            return
        d = os.path.join(self._scope_dir(scope), info.script_id)
        os.makedirs(d, exist_ok=True)
        # versions first, meta last, each atomically: a crash can leave
        # stray .py files but never a meta.json naming a missing version.
        # Always rewrite — apply_replicated can REPLACE content under an
        # existing version id (per-host version counters collide), and a
        # skip-if-exists here would persist the losing content, diverging
        # hosts after the next restart.
        for v in info.versions:
            path = os.path.join(d, f"{v.version_id}.py")
            self._atomic_write(
                path, self._content[(scope, info.script_id, v.version_id)])
        # drop version files the winning state no longer names
        keep = {f"{v.version_id}.py" for v in info.versions} | {"meta.json"}
        for name in os.listdir(d):
            if name.endswith(".py") and name not in keep:
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    pass
        self._atomic_write(os.path.join(d, "meta.json"),
                           json.dumps({"scope": scope, **info.to_json()}))

    @staticmethod
    def _atomic_write(path: str, content: str) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            fh.write(content)
        os.replace(tmp, path)

    def _load_from_disk(self) -> None:
        from urllib.parse import quote

        root = os.path.join(self._data_dir, "scripts")
        if not os.path.isdir(root):
            return
        # Canonical scope dirs (percent-encoded) load AFTER legacy ones
        # (pre-encoding underscore-replacement), so on a (scope, script_id)
        # conflict the canonical copy wins; legacy dirs then migrate.
        entries = []
        for scope_name in os.listdir(root):
            scope_dir = os.path.join(root, scope_name)
            if not os.path.isdir(scope_dir):
                continue  # tombstones.json lives beside the scope dirs
            for script_id in os.listdir(scope_dir):
                entries.append((scope_name, scope_dir, script_id))
        loaded = []
        for scope_name, scope_dir, script_id in sorted(
                entries, key=lambda e: self._is_canonical_dir(
                    e[0], e[1], e[2])):
            try:
                scope = self._load_one(scope_name, scope_dir, script_id)
                if scope is not None:
                    loaded.append((scope_name, scope_dir, script_id, scope))
            except Exception:
                # one corrupt script directory must not block startup
                LOGGER.exception("skipping unreadable script %s/%s",
                                 scope_name, script_id)
        # migrate legacy-named dirs to the canonical encoding
        import shutil
        for scope_name, scope_dir, script_id, scope in loaded:
            if scope_name == quote(scope, safe=""):
                continue
            try:
                info = self._scripts.get((scope, script_id))
                if info is not None:
                    self._sync_to_disk(scope, info)
                shutil.rmtree(os.path.join(scope_dir, script_id))
                if not os.listdir(scope_dir):
                    os.rmdir(scope_dir)
                LOGGER.info("migrated script dir %s/%s to canonical "
                            "scope encoding", scope_name, script_id)
            except OSError:
                LOGGER.exception("could not migrate legacy script dir "
                                 "%s/%s", scope_name, script_id)

    @staticmethod
    def _is_canonical_dir(scope_name: str, scope_dir: str,
                          script_id: str) -> bool:
        from urllib.parse import quote

        meta_path = os.path.join(scope_dir, script_id, "meta.json")
        try:
            with open(meta_path) as fh:
                scope = json.load(fh).get("scope", scope_name)
        except (OSError, ValueError):
            return False
        return scope_name == quote(scope, safe="")

    def _load_one(self, scope_name: str, scope_dir: str,
                  script_id: str) -> Optional[str]:
        """Returns the script's true scope, or None if nothing loaded."""
        meta_path = os.path.join(scope_dir, script_id, "meta.json")
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as fh:
            meta = json.load(fh)
        scope = meta.get("scope", scope_name)
        # a crash between tombstone persist and file removal leaves both:
        # the tombstone outranks the stale files, finish the delete here
        tomb = self._tombstones.get((scope, meta["scriptId"]), -1)
        if int(meta.get("updatedMs", 0)) <= tomb:
            import shutil
            shutil.rmtree(os.path.join(scope_dir, script_id),
                          ignore_errors=True)
            return None
        info = ScriptInfo(
            script_id=meta["scriptId"], name=meta.get("name", ""),
            description=meta.get("description", ""),
            active_version=meta.get("activeVersion"),
            updated_ms=meta.get("updatedMs", 0),
            versions=[ScriptVersion(v["versionId"], v.get("comment", ""),
                                    v.get("createdDate", 0))
                      for v in meta.get("versions", [])])
        key = (scope, info.script_id)
        for v in info.versions:
            path = os.path.join(scope_dir, script_id, f"{v.version_id}.py")
            with open(path) as fh:
                self._content[key + (v.version_id,)] = fh.read()
        if info.active_version:
            self._compile(key, info.active_version)
        self._scripts[key] = info  # registered only after a clean load
        return scope

    # -- replication surface ------------------------------------------------

    def add_listener(self, fn: Callable) -> None:
        """Register a mutation listener `fn(op, scope, script_id, payload)`
        — op "upsert" carries the full exported script state, op "delete"
        carries the tombstone stamp. Fired after every LOCAL mutation
        (apply_replicated/apply_delete do NOT fire it: appliers are the
        receive side)."""
        self._listeners.append(fn)

    def _notify(self, op: str, scope: str, script_id: str, payload) -> None:
        for fn in list(self._listeners):
            try:
                fn(op, scope, script_id, payload)
            except Exception:
                LOGGER.exception("script listener failed for %s %s/%s",
                                 op, scope, script_id)

    def export_script(self, scope: str, script_id: str) -> Dict[str, Any]:
        """Full replicable state of one script: metadata + every version's
        content. Scripts are small text; whole-state transfer keeps the
        applier idempotent and order-free (same reasoning as the registry
        gossip's by-token entity payloads)."""
        with self._lock:
            info = self.get_script(scope, script_id)
            return {"scope": scope, **info.to_json(),
                    "contents": {v.version_id:
                                 self._content[(scope, script_id,
                                                v.version_id)]
                                 for v in info.versions}}

    def export_state(self) -> List[Dict[str, Any]]:
        """Every script's exported state (instance checkpoint payload)."""
        with self._lock:
            return [self.export_script(scope, script_id)
                    for (scope, script_id) in sorted(self._scripts)]

    @staticmethod
    def _state_digest(state: Dict[str, Any]) -> str:
        import hashlib

        blob = json.dumps({k: v for k, v in state.items()
                           if k != "updatedMs"}, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()

    def _lww_key(self, key: tuple) -> tuple:
        info = self._scripts.get(key)
        if info is None:
            return (self._tombstones.get(key, -1), "")
        return (info.updated_ms,
                self._state_digest(self.export_script(*key)))

    def apply_replicated(self, state: Dict[str, Any]) -> bool:
        """Upsert a replicated script if it wins last-writer-wins against
        the local copy (stamp, then host-independent digest — every host
        compares the same keys and picks the same winner). Idempotent;
        never fires listeners. Returns True when applied."""
        scope, script_id = state["scope"], state["scriptId"]
        # same path-safety contract as create_script: the id becomes a
        # filesystem component in _sync_to_disk, and a replicated payload
        # must not be able to write (or later rmtree) outside the scope
        # directory
        if not _ID_RE.match(script_id):
            raise SiteWhereError(
                f"replicated script id {script_id!r} invalid: must match "
                f"{_ID_RE.pattern}", http_status=400)
        incoming = (int(state.get("updatedMs", 0)),
                    self._state_digest(state))
        with self._lock:
            key = (scope, script_id)
            if incoming[0] <= self._tombstones.get(key, -1):
                return False  # deleted with a newer stamp: stays dead
            if self._scripts.get(key) is not None \
                    and incoming <= self._lww_key(key):
                return False
            info = ScriptInfo(
                script_id=script_id, name=state.get("name", ""),
                description=state.get("description", ""),
                active_version=state.get("activeVersion"),
                updated_ms=incoming[0],
                versions=[ScriptVersion(v["versionId"],
                                        v.get("comment", ""),
                                        v.get("createdDate", 0))
                          for v in state.get("versions", [])])
            # stage content + compile BEFORE replacing the local copy so a
            # broken payload cannot take down a working script
            contents = dict(state.get("contents", {}))
            for v in info.versions:
                if v.version_id not in contents:
                    raise SiteWhereError(
                        f"replicated script '{script_id}' missing content "
                        f"for {v.version_id}", http_status=400)
            old_content = {k: v for k, v in self._content.items()
                           if k[:2] == key}
            # the winner's version set REPLACES the local one: drop every
            # old content key first so versions absent from the winning
            # state don't linger readable through get_content
            for k in old_content:
                del self._content[k]
            for vid, text in contents.items():
                self._content[key + (vid,)] = text
            try:
                if info.active_version:
                    self._compile(key, info.active_version)
                else:
                    self._namespaces.pop(key, None)
            except Exception:
                for k in [k for k in self._content if k[:2] == key]:
                    del self._content[k]
                self._content.update(old_content)
                raise
            self._scripts[key] = info
            if self._tombstones.pop(key, None) is not None:
                self._sync_tombstones_locked()
            self._sync_to_disk(scope, info)
            return True

    def apply_delete(self, scope: str, script_id: str, stamp: int) -> bool:
        """Replicated deletion: applies when the local copy is not newer;
        always records the tombstone. Never fires listeners."""
        with self._lock:
            key = (scope, script_id)
            info = self._scripts.get(key)
            if info is not None and info.updated_ms > stamp:
                return False  # local write is newer: delete loses
            self._tombstones[key] = max(stamp,
                                        self._tombstones.get(key, -1))
            self._sync_tombstones_locked()
            if info is None:
                return False
            self._delete_locked(scope, script_id)
            return True

    # -- CRUD ---------------------------------------------------------------

    def create_script(self, scope: str, script_id: str, content: str,
                      name: str = "", description: str = "",
                      activate: bool = True) -> ScriptInfo:
        if not _ID_RE.match(script_id):
            raise SiteWhereError(
                f"invalid script id {script_id!r}: must match "
                f"{_ID_RE.pattern}", http_status=400)
        with self._lock:
            key = (scope, script_id)
            if key in self._scripts:
                raise SiteWhereError(f"script '{script_id}' already exists",
                                     ErrorCode.DUPLICATE_TOKEN)
            if activate:
                self._check_compiles(key, content)  # before registering
            # stamp PAST any local tombstone (delete-then-recreate in the
            # same millisecond must still replicate) and clear it
            info = ScriptInfo(script_id=script_id, name=name or script_id,
                              description=description,
                              updated_ms=max(now_ms(),
                                             self._tombstones.get(key, -1)
                                             + 1))
            if self._tombstones.pop(key, None) is not None:
                self._sync_tombstones_locked()
            self._scripts[key] = info
            version = self._add_version_locked(key, content, "initial")
            if activate:
                self._activate_locked(key, version.version_id)
            self._sync_to_disk(scope, info)
        self._notify("upsert", scope, script_id,
                     self.export_script(scope, script_id))
        return info

    def list_scripts(self, scope: str) -> List[ScriptInfo]:
        with self._lock:
            return [i for (s, _), i in sorted(self._scripts.items())
                    if s == scope]

    def get_script(self, scope: str, script_id: str) -> ScriptInfo:
        info = self._scripts.get((scope, script_id))
        if info is None:
            raise SiteWhereError(f"unknown script '{script_id}'",
                                 ErrorCode.GENERIC, http_status=404)
        return info

    def delete_script(self, scope: str, script_id: str) -> None:
        with self._lock:
            info = self.get_script(scope, script_id)
            key = (scope, script_id)
            # stamp past the script's last write so a concurrent remote
            # update with an older stamp cannot resurrect it
            stamp = max(now_ms(), info.updated_ms + 1)
            self._tombstones[key] = stamp
            # tombstone durable BEFORE the files go: a crash in between
            # leaves dir + tombstone, which _load_one reconciles at boot
            self._sync_tombstones_locked()
            self._delete_locked(scope, script_id)
        self._notify("delete", scope, script_id, stamp)

    def _delete_locked(self, scope: str, script_id: str) -> None:
        key = (scope, script_id)
        info = self._scripts.pop(key)
        self._namespaces.pop(key, None)
        for v in info.versions:
            self._content.pop(key + (v.version_id,), None)
        if self._data_dir:
            d = os.path.join(self._scope_dir(scope), script_id)
            if os.path.isdir(d):
                for f in os.listdir(d):
                    os.unlink(os.path.join(d, f))
                os.rmdir(d)

    # -- versions -----------------------------------------------------------

    def _add_version_locked(self, key: tuple, content: str,
                            comment: str) -> ScriptVersion:
        info = self._scripts[key]
        version = ScriptVersion(
            version_id=f"v{len(info.versions) + 1}", comment=comment,
            created_ms=now_ms())
        info.versions.append(version)
        self._content[key + (version.version_id,)] = content
        return version

    def add_version(self, scope: str, script_id: str, content: str,
                    comment: str = "", activate: bool = False
                    ) -> ScriptVersion:
        with self._lock:
            info = self.get_script(scope, script_id)
            key = (scope, script_id)
            version = self._add_version_locked(key, content, comment)
            if activate:
                self._activate_locked(key, version.version_id)
            # monotonic past the previous write: same-millisecond
            # mutations must still order under last-writer-wins
            info.updated_ms = max(now_ms(), info.updated_ms + 1)
            self._sync_to_disk(scope, info)
        self._notify("upsert", scope, script_id,
                     self.export_script(scope, script_id))
        return version

    def clone_version(self, scope: str, script_id: str, version_id: str,
                      comment: str = "") -> ScriptVersion:
        # read under the manager's internal locking, then delegate OUTSIDE
        # any held lock: add_version's listener notification does network
        # publishes in a cluster and must not run under self._lock
        content = self.get_content(scope, script_id, version_id)
        return self.add_version(scope, script_id, content,
                                comment or f"clone of {version_id}")

    def get_content(self, scope: str, script_id: str,
                    version_id: Optional[str] = None) -> str:
        info = self.get_script(scope, script_id)
        vid = version_id or info.active_version
        content = self._content.get((scope, script_id, vid))
        if content is None:
            raise SiteWhereError(f"unknown version '{vid}'",
                                 ErrorCode.GENERIC, http_status=404)
        return content

    # -- activation / execution --------------------------------------------

    @staticmethod
    def _check_compiles(key: tuple, source: str) -> None:
        try:
            compile(source, f"<script {key[1]}>", "exec")
        except SyntaxError as exc:
            raise SiteWhereError(f"script does not compile: {exc}",
                                 http_status=400) from exc

    def _compile(self, key: tuple, version_id: str) -> Dict[str, Any]:
        source = self._content[key + (version_id,)]
        namespace: Dict[str, Any] = {"__name__":
                                     f"swtpu_script_{key[1]}_{version_id}"}
        try:
            code = compile(source, f"<script {key[1]}:{version_id}>", "exec")
            exec(code, namespace)  # operator extension point (see module doc)
        except SiteWhereError:
            raise
        except Exception as exc:
            raise SiteWhereError(
                f"script '{key[1]}:{version_id}' failed to load: {exc}",
                http_status=400) from exc
        self._namespaces[key] = namespace
        return namespace

    def _activate_locked(self, key: tuple, version_id: str) -> None:
        info = self._scripts[key]
        if version_id not in {v.version_id for v in info.versions}:
            raise SiteWhereError(f"unknown version '{version_id}'",
                                 ErrorCode.GENERIC, http_status=404)
        self._compile(key, version_id)  # compile FIRST: bad scripts do not
        info.active_version = version_id  # replace a working active version

    def activate_version(self, scope: str, script_id: str,
                         version_id: str) -> ScriptInfo:
        with self._lock:
            info = self.get_script(scope, script_id)
            self._activate_locked((scope, script_id), version_id)
            info.updated_ms = max(now_ms(), info.updated_ms + 1)
            self._sync_to_disk(scope, info)
        self._notify("upsert", scope, script_id,
                     self.export_script(scope, script_id))
        return info

    def _active_entry(self, key: tuple, entry: str) -> Callable:
        ns = self._namespaces.get(key)
        if ns is None:
            raise SiteWhereError(
                f"script '{key[1]}' has no active version", ErrorCode.GENERIC)
        fn = ns.get(entry)
        if not callable(fn):
            raise SiteWhereError(
                f"script '{key[1]}' defines no callable '{entry}'",
                ErrorCode.GENERIC)
        return fn

    def resolve(self, scope: str, script_id: str, entry: str,
                require_entry: bool = False) -> Callable:
        """A stable callable dispatching to the ACTIVE version's `entry`
        function — survives later activations (hot swap).
        ``require_entry`` additionally fail-fasts when the CURRENT active
        version does not define a callable `entry` (callers installing
        long-lived consumers want a 4xx at install time, not a silently
        dead component)."""
        self.get_script(scope, script_id)  # fail fast on unknown id
        if require_entry:
            self._active_entry((scope, script_id), entry)
        return _ScriptProxy(self, scope, script_id, entry)
