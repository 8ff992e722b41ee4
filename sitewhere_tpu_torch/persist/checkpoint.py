"""Checkpoint/restore of the engine's device state + replay recovery.

Counterpart of `sitewhere_tpu/persist/checkpoint.py`, in its format, byte
for byte in layout: either package restores the other's checkpoints.
Reference: SiteWhere has *no* snapshotting — durable truth lives in the
datastores and Kafka offsets, and a restarted service replays from
committed offsets (SURVEY.md §5; offset commit at
DecodedEventsConsumer.java:194-199). The device-state tensors on the card
are exactly such a rebuildable cache: the checkpointer snapshots them
(plus the interner tables and packer epoch that give the indices meaning,
plus the bus committed offsets) so recovery is
  restore latest checkpoint -> replay bus records past the saved offsets
instead of a full-history replay.

Format: a directory per checkpoint (`ckpt-<n>/`) holding one
`np.savez_compressed` state.npz of every state array (keys `state.`,
`rulestate.`, `modelstate.`, `actstate.`, `overflow.`), a JSON manifest
and a digest file; written to a temp dir and atomically renamed, so a crash
mid-write never corrupts the latest checkpoint.

The card's side: a save reads every state group out of the card once
(`canonical_*_state`, one device-to-host copy per field); a restore copies
INTO the engine-owned buffers the captured steps read
(`load_canonical_*`), so the graphs stay valid and the next replay sees the
restored state. Families re-install (pinned slot/epoch) before their state
loads, so a family that goes empty -> non-empty reallocates its group
first. The port's device interner is sequential: any snapshot — a JAX
single-chip engine's, or a sharded engine's shard-congruent one — restores
verbatim, and the registry mirror re-mirrors its rows under the restored
indices (`RegistryTensors.rebuild`).

The per-host `host-shards` layout (a multi-host save) needs the sharded
engine, which the port does not have yet: a restore refuses it with
SiteWhereCheckpointError before touching the engine. `assemble_canonical`
turns a cluster's per-host checkpoints into a canonical one that restores
here.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
import shutil
import threading
import time
import typing
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.model.event import DeviceAlert
from sitewhere_tpu_torch.ops.actuate import ActuationStateTensors
from sitewhere_tpu_torch.ops.anomaly import ModelStateTensors
from sitewhere_tpu_torch.ops.pack import EventBatch
from sitewhere_tpu_torch.ops.slab import pack_state_slab_np
from sitewhere_tpu_torch.ops.stateful import RuleStateTensors
from sitewhere_tpu_torch.persist.atomic import (
    fsync_dir, verify_digest_manifest, write_digest_manifest)
from sitewhere_tpu_torch.pipeline.state_tensors import (
    DeviceStateTensors, init_device_state)
from sitewhere_tpu_torch.runtime.faults import FaultError, fault_point
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

_log = logging.getLogger("sitewhere.checkpoint")

_TENANT_FIELDS = ("tenant_event_count", "tenant_alert_count")
# rebased-int32 timestamp fields (EventPacker.epoch_base_ms); -2^31 = never
_TS_FIELDS = ("last_interaction", "presence_missing_since",
              "last_location_ts", "last_measurement_ts", "last_alert_ts")
_NEG = -(2 ** 31)
# the stateful groups: npz key prefix, engine group name, tensors class,
# manifest key of the family's (slot, epoch) pins, engine installer
_GROUPS = (
    ("rulestate.", "rule", RuleStateTensors, "rule_programs",
     "upsert_rule_program"),
    ("modelstate.", "model", ModelStateTensors, "anomaly_models",
     "upsert_anomaly_model"),
    ("actstate.", "actuation", ActuationStateTensors, "actuation_policies",
     "upsert_actuation_policy"),
)
# pre-slab checkpoints name each group's flag column
_FLAG_FIELD = {"rule": "root_prev", "model": "score_prev"}


class SiteWhereCheckpointError(SiteWhereError):
    pass


def _alert_to_dict(alert: DeviceAlert) -> Dict[str, Any]:
    """DeviceAlert -> manifest dict (enum fields as their values)."""
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(alert).items()}


def _alert_from_dict(d: Dict[str, Any]) -> DeviceAlert:
    """Manifest dict -> DeviceAlert (enum fields coerced by annotation;
    fields this model does not carry are dropped)."""
    hints = typing.get_type_hints(DeviceAlert)
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(DeviceAlert):
        if f.name not in d:
            continue
        val = d[f.name]
        t = hints.get(f.name)
        if (isinstance(t, type) and issubclass(t, enum.Enum)
                and val is not None and not isinstance(val, t)):
            val = t(val)
        kwargs[f.name] = val
    return DeviceAlert(**kwargs)


def _init_device_state_np(D: int, M: int, T: int) -> Dict[str, np.ndarray]:
    state = init_device_state(D, M, T, device="cpu")
    return {f.name: getattr(state, f.name).numpy()
            for f in dataclasses.fields(state)}


def _shift_ts(array: np.ndarray, delta_ms: int) -> np.ndarray:
    """Shift rebased timestamps between epoch bases; the 'never' sentinel
    stays put."""
    if delta_ms == 0:
        return array
    return np.where(array == _NEG, _NEG,
                    array + np.int32(delta_ms)).astype(array.dtype)


def _migrate_state_cols(cols: Dict[str, np.ndarray], *, flag_field: str
                        ) -> Dict[str, np.ndarray]:
    """Fuse a pre-slab checkpoint's separate state columns
    (value/aux/ts/counter + flag + row_gen) into the fused-slab layout
    (ops/slab.py pack_state_slab_np). Slab-era checkpoints (or empty column
    sets) pass through untouched. float planes travel as raw IEEE bits, so
    restored state is bit-identical."""
    if not cols or "slab" in cols or "value" not in cols:
        return cols
    fused = {"slab": pack_state_slab_np(
        cols["value"], cols["aux"], cols["ts"], cols["counter"],
        cols[flag_field], cols["row_gen"])}
    for key, array in cols.items():
        if key not in ("value", "aux", "ts", "counter", flag_field,
                       "row_gen"):
            fused[key] = array
    return fused


def _install_overflow(engine, overflow_cols: Dict[str, np.ndarray]) -> None:
    """Fold a restored overflow backlog into the engine in batch-size
    chunks (zero-padded), stashing any fired alerts on the engine's pending
    list — drained at the head of the next materialize_alerts, never
    silently lost."""
    cols = {f.name: np.asarray(overflow_cols[f.name])
            for f in dataclasses.fields(EventBatch)}
    n = cols["device_idx"].shape[0]
    B = engine.batch_size
    for start in range(0, n, B):
        chunk = {}
        for name, col in cols.items():
            col = col[start:start + B]
            if col.shape[0] < B:
                pad = np.zeros((B - col.shape[0],) + col.shape[1:],
                               col.dtype)
                col = np.concatenate([col, pad])
            chunk[name] = torch.from_numpy(np.ascontiguousarray(col))
        routed, outputs = engine.submit_routed(EventBatch(**chunk))
        # materialize first: it drains the pending list (earlier alerts
        # at its head) and rebinds it, so the extend must follow it
        alerts = engine.materialize_alerts(routed, outputs)
        engine._pending_alerts.extend(alerts)


def _checkpoint_names(directory: str) -> List[str]:
    return sorted(n for n in os.listdir(directory)
                  if n.startswith("ckpt-") and not n.endswith(".tmp")
                  and not n.endswith(".quarantine"))


def _write_checkpoint_dir(directory: str, arrays: Dict[str, np.ndarray],
                          manifest: Dict[str, Any]) -> str:
    """Write one `ckpt-<seq>/` directory (state.npz + manifest.json +
    digest.json) with the next sequence number, atomically via fsync +
    tmp-dir rename — the single writer behind PipelineCheckpointer.save
    and write_assembled. The digest lets restore verify completeness and
    fall back to the last good checkpoint instead of trusting the rename
    alone (a torn write inside a renamed dir is the failure the
    `checkpoint_torn_write` drill injects)."""
    existing = [int(n.split("-")[1]) for n in _checkpoint_names(directory)]
    seq = (max(existing) + 1) if existing else 0
    final = os.path.join(directory, f"ckpt-{seq:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez_compressed(os.path.join(tmp, "state.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w",
              encoding="utf-8") as fh:
        json.dump(manifest, fh)
    write_digest_manifest(tmp)
    try:
        fault_point("checkpoint_torn_write")
    except FaultError:
        # simulate the dangerous case: the rename lands but the payload
        # is torn — digest verification is what must catch this
        state_path = os.path.join(tmp, "state.npz")
        size = os.path.getsize(state_path)
        with open(state_path, "r+b") as fh:
            fh.truncate(max(1, size // 2))
        os.replace(tmp, final)
        return final
    os.replace(tmp, final)
    fsync_dir(directory)
    return final


def _union_tokens(per_host: List[List[Optional[str]]]):
    """Union sequential interner snapshots by token; returns the merged
    table plus one old-index -> merged-index array per host."""
    tokens: List[Optional[str]] = [None]
    index: Dict[str, int] = {}
    remaps = []
    for snapshot in per_host:
        snapshot = snapshot or [None]
        remap = np.zeros(max(len(snapshot), 1), np.int32)
        for i, token in enumerate(snapshot):
            if i == 0 or token is None:
                continue
            if token not in index:
                index[token] = len(tokens)
                tokens.append(token)
            remap[i] = index[token]
        remaps.append(remap)
    return tokens, remaps


def _merge_congruent_tokens(per_host: List[List[Optional[str]]]):
    """Merge shard-congruent DEVICE tables: the index of a token is a pure
    function of the token, so hosts must agree wherever they overlap."""
    size = max(len(s) for s in per_host)
    out: List[Optional[str]] = [None] * size
    for snapshot in per_host:
        for i, token in enumerate(snapshot):
            if i == 0 or token is None:
                continue
            if out[i] is None:
                out[i] = token
            elif out[i] != token:
                raise SiteWhereCheckpointError(
                    f"device interner disagreement at index {i}: "
                    f"{out[i]!r} vs {token!r} — per-host checkpoints were "
                    f"not taken from one converged cluster")
    return out


def _union_specs(loads, key: str) -> List[Dict]:
    """A family's manifest rows unioned by spec token across hosts, with
    slot/epoch STRIPPED: per-host slot assignment is host-local, so an
    assembled restore re-installs fresh (windows restart; the per-host
    state arrays are intentionally not merged)."""
    rows: List[Dict] = []
    seen = set()
    for manifest, _ in loads:
        for row in manifest.get(key, []):
            token = (row.get("spec") or {}).get("token")
            if token and token not in seen:
                seen.add(token)
                rows.append({"spec": dict(row["spec"])})
    return rows


def assemble_canonical(paths: List[str]):
    """Merge one per-host shard checkpoint from EVERY host of a cluster
    into a single canonical (topology-independent) snapshot: returns
    (manifest, state_arrays, overflow_cols-or-None).

    Per-host checkpoints alone restore only onto the same topology; the
    assembled canonical form restores onto any engine — another mesh, or
    one card — through the canonical restore path. Host-local divergences
    are normalized: measurement/alert-type/tenant interner tables union
    (state columns, values and counter rows remap), and rebased timestamps
    shift onto one epoch base. Bus offsets do NOT travel (they name
    per-host bus logs); a restored instance replays its retained log from
    the start — at-least-once, the reference's recovery semantics."""
    loads = []
    for path in paths:
        with open(os.path.join(path, "manifest.json"),
                  encoding="utf-8") as fh:
            manifest = json.load(fh)
        with np.load(os.path.join(path, "state.npz")) as data:
            arrays = {key: np.asarray(data[key]) for key in data.files}
        loads.append((manifest, arrays))

    for manifest, _ in loads:
        if manifest.get("layout") != "host-shards":
            raise SiteWhereCheckpointError(
                "assemble_canonical expects per-host shard checkpoints "
                "(layout=host-shards); canonical checkpoints already "
                "restore anywhere")
    n_shards = {m["n_shards"] for m, _ in loads}
    if len(n_shards) != 1:
        raise SiteWhereCheckpointError(
            f"checkpoints disagree on n_shards: {sorted(n_shards)}")
    S = n_shards.pop()
    covered: List[int] = []
    for manifest, _ in loads:
        covered.extend(manifest["shard_ids"])
    if sorted(covered) != list(range(S)):
        raise SiteWhereCheckpointError(
            f"shard coverage {sorted(covered)} != 0..{S - 1} — need "
            f"exactly one checkpoint per host of the full cluster")

    base = min(m["epoch_base_ms"] for m, _ in loads)
    device_tokens = _merge_congruent_tokens(
        [m["interners"]["devices"] for m, _ in loads])
    mm_tokens, mm_remaps = _union_tokens(
        [m["interners"]["measurements"] for m, _ in loads])
    at_tokens, at_remaps = _union_tokens(
        [m["interners"]["alert_types"] for m, _ in loads])
    tenant_tokens, tenant_remaps = _union_tokens(
        [m["interners"].get("tenants") or [None] for m, _ in loads])

    sample = loads[0][1]["state.last_measurement"]
    L, M = sample.shape[1], sample.shape[2]
    T = loads[0][1]["state.tenant_event_count"].shape[-1]
    canonical = _init_device_state_np(S * L, M, T)
    overflow_parts: List[Dict[str, np.ndarray]] = []
    pending_alerts: List[Dict] = []

    for host, (manifest, arrays) in enumerate(loads):
        delta = manifest["epoch_base_ms"] - base
        mm_remap, at_remap = mm_remaps[host], at_remaps[host]
        for name in canonical:
            block = np.array(arrays[f"state.{name}"])
            if name in _TS_FIELDS:
                block = _shift_ts(block, delta)
            if name in ("last_measurement", "last_measurement_ts"):
                # slot column = interned measurement index: remap columns
                # host-local -> union (columns past capacity M drop);
                # untouched slots keep init semantics (0 value, NEVER ts)
                remapped = (np.zeros(block.shape, block.dtype)
                            if name == "last_measurement"
                            else np.full(block.shape, _NEG, block.dtype))
                for old_col in range(1, min(block.shape[-1],
                                            len(mm_remap))):
                    new_col = mm_remap[old_col]
                    if 0 < new_col < M:
                        remapped[..., new_col] = block[..., old_col]
                block = remapped
            if name == "last_alert_type":
                block = np.where(
                    (block > 0) & (block < len(at_remap)),
                    at_remap[np.clip(block, 0, len(at_remap) - 1)],
                    np.where(block > 0, 0, block)).astype(block.dtype)
            if name in _TENANT_FIELDS:
                remap = tenant_remaps[host]
                rows = block.sum(0, dtype=block.dtype) \
                    if block.ndim == 2 else block
                for old_row in range(1, min(rows.shape[-1], len(remap))):
                    new_row = remap[old_row]
                    if 0 < new_row < T:
                        canonical[name][new_row] += rows[old_row]
                canonical[name][0] += rows[0]
                continue
            # global device d lives at (d % S, d // S): shard s's row l is
            # device l*S + s
            for si, shard in enumerate(manifest["shard_ids"]):
                canonical[name][shard::S] = block[si]
        part = {key[len("overflow."):]: np.array(val)
                for key, val in arrays.items()
                if key.startswith("overflow.")}
        if part:
            part["ts"] = _shift_ts(part["ts"], delta)

            def _remap_values(col, remap):
                return np.where(
                    col < len(remap),
                    remap[np.clip(col, 0, len(remap) - 1)],
                    0).astype(np.int32)

            part["mm_idx"] = _remap_values(part["mm_idx"], mm_remap)
            part["alert_type_idx"] = _remap_values(part["alert_type_idx"],
                                                   at_remap)
            part["tenant_idx"] = _remap_values(part["tenant_idx"],
                                               tenant_remaps[host])
            overflow_parts.append(part)
        pending_alerts.extend(manifest.get("pending_alerts", []))

    overflow_cols = None
    if overflow_parts:
        overflow_cols = {
            key: np.concatenate([p[key] for p in overflow_parts])
            for key in overflow_parts[0]
        }
    rules: List[Dict] = []
    seen_rules = set()
    for manifest, _ in loads:
        for rule in manifest.get("rules", []):
            if rule.get("token") not in seen_rules:
                seen_rules.add(rule.get("token"))
                rules.append(rule)
    out_manifest: Dict[str, Any] = {
        "epoch_base_ms": base,
        "interners": {"devices": device_tokens,
                      "measurements": mm_tokens,
                      "alert_types": at_tokens,
                      "tenants": tenant_tokens},
        "offsets": {},
        "pending_alerts": pending_alerts,
        "rules": rules,
        "rule_programs": _union_specs(loads, "rule_programs"),
        "anomaly_models": _union_specs(loads, "anomaly_models"),
        "actuation_policies": _union_specs(loads, "actuation_policies"),
        "assembled_from": [os.path.basename(p) for p in paths],
    }
    return out_manifest, canonical, overflow_cols


def write_assembled(paths: List[str], out_dir: str) -> str:
    """assemble_canonical + write the result as a regular canonical
    checkpoint directory under `out_dir` (ready for
    PipelineCheckpointer.restore on any engine). Returns the path."""
    manifest, canonical, overflow_cols = assemble_canonical(paths)
    os.makedirs(out_dir, exist_ok=True)
    arrays = {f"state.{name}": arr for name, arr in canonical.items()}
    if overflow_cols:
        arrays.update({f"overflow.{name}": arr
                       for name, arr in overflow_cols.items()})
    return _write_checkpoint_dir(out_dir, arrays, manifest)


def _group_arrays(group) -> Dict[str, np.ndarray]:
    return {f.name: getattr(group, f.name).numpy()
            for f in dataclasses.fields(group)}


class PipelineCheckpointer:
    """Snapshot/restore a PipelineEngine's recoverable state.

    `last_timings` holds the host-clock split of the last save
    (`d2h_s`: reading the state groups off the engine's device; `write_s`:
    compress, write, digest, rename; `bytes`: the checkpoint on disk) and
    of the last restore (`read_s`: verify, read and decompress; `h2d_s`:
    copying the state into the engine's buffers; `total_s`)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        # save() has multiple callers (periodic thread + REST POST):
        # racing saves would compute the same sequence and interleave
        # writes into one tmp dir, promoting a mixed-snapshot checkpoint
        self._save_lock = threading.Lock()
        # recovery epoch of the process that owns this checkpointer;
        # stamped into every manifest so a later incarnation (or a
        # takeover successor) can fence a zombie writer's stale saves
        self.recovery_epoch = 0
        self.last_restore_epoch: Optional[int] = None
        self.last_timings: Dict[str, float] = {}
        os.makedirs(directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, engine, bus=None,
             consumer_groups: Optional[List] = None,
             extra_manifest: Optional[Dict] = None) -> str:
        """Write a new checkpoint; returns its path.

        `consumer_groups` are bus ConsumerGroup objects whose committed
        offsets should be captured (the replay cursor). `extra_manifest`
        merges additional instance-level payloads into the manifest.

        Offsets are captured BEFORE the state arrays: a commit racing the
        snapshot then yields offsets <= state, i.e. at worst a duplicate
        replay (at-least-once, like the reference's Kafka semantics);
        offsets ahead of state would silently LOSE events."""
        with self._save_lock:
            return self._save_locked(engine, consumer_groups,
                                     extra_manifest)

    def _save_locked(self, engine, consumer_groups: Optional[List],
                     extra_manifest: Optional[Dict] = None) -> str:
        t0 = time.perf_counter()
        self._fence_stale_save()
        captured_offsets = {
            f"{g.topic.name}@{g.group_id}": list(g.committed)
            for g in consumer_groups or []
        }
        # canonical flat layout: topology-independent, so a checkpoint
        # taken here restores onto any other engine or mesh size. The
        # stateful groups (rule-program windows, anomaly feature state,
        # actuation debounce rows) travel with it and re-join their
        # families through the manifest's pinned slot/epoch assignment
        arrays = {f"state.{name}": arr for name, arr in
                  _group_arrays(engine.canonical_state()).items()}
        for prefix, group, *_ in _GROUPS:
            state = getattr(engine, f"canonical_{group}_state")()
            if state is not None:
                arrays.update({f"{prefix}{name}": arr for name, arr in
                               _group_arrays(state).items()})
        t_d2h = time.perf_counter()
        packer = engine.packer
        manifest: Dict[str, Any] = {
            "epoch_base_ms": packer.epoch_base_ms,
            "interners": {
                "devices": packer.devices.snapshot(),
                "measurements": packer.measurements.snapshot(),
                "alert_types": packer.alert_types.snapshot(),
                # tenant table gives tenant_* counter rows meaning when a
                # checkpoint moves across hosts/topologies (assemble)
                "tenants": engine.registry.tenants.snapshot(),
            },
            "offsets": captured_offsets,
            # alerts stashed by an overflow fold travel WITH the
            # checkpoint: their events' offsets are committed, so replay
            # will not re-fire them. Not cleared here (a live process
            # still delivers them; a restore may duplicate — at-least-once)
            "pending_alerts": [_alert_to_dict(a)
                               for a in engine._pending_alerts],
            # rules are config, but REST-added ones exist only in the
            # engine — a restart must not silently drop them
            "rules": self._rules_manifest(engine),
            # each family with its runtime (slot, epoch) assignment:
            # restore re-pins per-device state to its entry mid-window
            "rule_programs": engine.rule_program_manifest(),
            "anomaly_models": engine.anomaly_model_manifest(),
            "actuation_policies": engine.actuation_policy_manifest(),
            # fencing stamp: a successor that took over minted a higher
            # epoch; its checkpoints outrank ours and _fence_stale_save
            # refuses to let a zombie clobber them
            "recovery_epoch": int(self.recovery_epoch),
            **(extra_manifest or {}),
        }
        final = _write_checkpoint_dir(self.directory, arrays, manifest)
        self._gc()
        t_end = time.perf_counter()
        self.last_timings = {
            "d2h_s": t_d2h - t0, "write_s": t_end - t_d2h,
            "total_s": t_end - t0,
            "bytes": sum(os.path.getsize(os.path.join(final, n))
                         for n in os.listdir(final))}
        return final

    def _fence_stale_save(self) -> None:
        """Refuse to write a checkpoint below the newest on-disk epoch.

        After a takeover the successor restores from this directory and
        saves with a higher recovery_epoch; a paused-then-resumed old
        owner (zombie) that still holds a checkpointer must not promote
        a snapshot of pre-takeover state over the successor's."""
        latest = self.latest()
        if latest is None:
            return
        try:
            with open(os.path.join(latest, "manifest.json"),
                      encoding="utf-8") as fh:
                disk_epoch = int(json.load(fh).get("recovery_epoch", 0))
        except (OSError, ValueError):
            return  # unreadable manifest: latest() already quarantines
        if disk_epoch > int(self.recovery_epoch):
            GLOBAL_METRICS.counter("fencing.rejected").inc()
            raise SiteWhereCheckpointError(
                f"checkpoint save fenced: on-disk epoch {disk_epoch} > "
                f"writer epoch {self.recovery_epoch} (stale owner)")

    def _gc(self) -> None:
        for stale in _checkpoint_names(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, stale),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def _quarantine(self, path: str) -> None:
        """Move a checkpoint that failed verification aside (never delete
        forensic evidence) so the next latest() scan skips it."""
        dest = path + ".quarantine"
        try:
            os.replace(path, dest)
        except OSError:
            dest = path  # couldn't move: the verify gate still skips it
        _log.error("checkpoint %s failed digest verification; quarantined "
                   "at %s", path, dest)

    def latest(self) -> Optional[str]:
        """Newest checkpoint that passes digest verification. Corrupt
        ones (torn writes that survived the rename) are quarantined and
        the scan falls back to the previous good checkpoint — restore
        degrades to older state instead of crashing. Pre-digest legacy
        checkpoints (no digest.json) are trusted as before."""
        for name in reversed(_checkpoint_names(self.directory)):
            path = os.path.join(self.directory, name)
            if verify_digest_manifest(path) is False:
                self._quarantine(path)
                continue
            return path
        return None

    def restore(self, engine, path: Optional[str] = None
                ) -> Dict[str, List[int]]:
        """Load a checkpoint into the engine; returns the saved bus offsets
        keyed `topic@group` so the caller can seed replay consumers."""
        t0 = time.perf_counter()
        explicit = path is not None
        path = path or self.latest()
        if path is None:
            return {}
        try:
            with open(os.path.join(path, "manifest.json"),
                      encoding="utf-8") as fh:
                manifest = json.load(fh)
            with np.load(os.path.join(path, "state.npz")) as data:
                arrays = {key: np.asarray(data[key]) for key in data.files}
            state_cols = {f.name: arrays[f"state.{f.name}"]
                          for f in dataclasses.fields(DeviceStateTensors)}
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as err:
            # a pre-digest checkpoint torn some other way (np.load raises
            # ValueError, EOFError or BadZipFile): same treatment as a
            # digest mismatch — quarantine, fall back to last-good.
            # Explicit paths propagate: the operator asked for THAT one.
            if explicit:
                raise SiteWhereCheckpointError(
                    f"checkpoint {path} is unreadable: {err}") from err
            self._quarantine(path)
            return self.restore(engine)
        if manifest.get("layout") == "host-shards":
            raise SiteWhereCheckpointError(
                f"checkpoint {path} is a per-host shard checkpoint "
                f"(layout=host-shards), which only a sharded engine on the "
                f"same cluster topology restores; assemble the cluster's "
                f"per-host checkpoints with write_assembled first")
        t_read = time.perf_counter()
        groups = {}
        for prefix, group, *_ in _GROUPS:
            cols = {key[len(prefix):]: arr for key, arr in arrays.items()
                    if key.startswith(prefix)}
            # pre-slab checkpoints saved the state quads as separate
            # columns: fuse them into the slab layout in place
            if group in _FLAG_FIELD:
                cols = _migrate_state_cols(cols,
                                           flag_field=_FLAG_FIELD[group])
            groups[group] = cols
        overflow_cols = {key[len("overflow."):]: arr
                         for key, arr in arrays.items()
                         if key.startswith("overflow.")}
        # families re-install FIRST (they only mutate host lists): the
        # restored state's per-slot generations must meet their matching
        # table epochs on the next compile, or the stale-slot check would
        # wipe the mid-window state they pin
        for _, _, _, key, installer in _GROUPS:
            self._restore_family(engine, manifest.get(key), installer)
        self._restore_devices(engine, manifest["interners"]["devices"])
        engine.load_canonical_state(DeviceStateTensors(
            **{name: torch.from_numpy(arr)
               for name, arr in state_cols.items()}))
        h2d_s = time.perf_counter() - t_read
        for _, group, cls, *_ in _GROUPS:
            cols = groups[group]
            if not cols:
                continue
            state = cls(**{name: torch.from_numpy(arr)
                           for name, arr in cols.items()})
            mismatch = engine.canonical_group_mismatch(group, state)
            if mismatch is not None:
                # the family's buckets changed since the save: its
                # windows restart fresh, as the reference's do
                _log.error("%s state did not restore (%s); its windows "
                           "restart fresh", group, mismatch)
                continue
            t_load = time.perf_counter()
            getattr(engine, f"load_canonical_{group}_state")(state)
            h2d_s += time.perf_counter() - t_load
        packer = engine.packer
        packer.epoch_base_ms = manifest["epoch_base_ms"]
        packer.measurements.restore(manifest["interners"]["measurements"])
        packer.alert_types.restore(manifest["interners"]["alert_types"])
        self._remap_tenant_rows(engine,
                                manifest["interners"].get("tenants"))
        engine._pending_alerts.extend(
            _alert_from_dict(d) for d in manifest.get("pending_alerts", []))
        self._restore_rules(engine, manifest.get("rules", []))
        if overflow_cols:
            # fold LAST: the overflow's indices/timestamps only mean
            # something under the restored interners + epoch base, and
            # its events must fire the restored rules, not an empty set
            _install_overflow(engine, overflow_cols)
        self.last_restore_epoch = int(manifest.get("recovery_epoch", 0))
        t_end = time.perf_counter()
        self.last_timings = {"read_s": t_read - t0, "h2d_s": h2d_s,
                             "total_s": t_end - t0}
        return manifest.get("offsets", {})

    @staticmethod
    def _restore_devices(engine, tokens) -> None:
        """Restore the device interner verbatim (sequential here, so any
        snapshot layout loads as it is); when that moves any token's index,
        the registry mirror re-mirrors its rows under the new indices."""
        devices = engine.packer.devices
        before = devices.snapshot()
        devices.restore(tokens)
        if devices.snapshot() != before:
            engine.registry.rebuild()

    @staticmethod
    def _remap_tenant_rows(engine, tenant_tokens) -> None:
        """Move tenant_* counter rows from the checkpoint's tenant table to
        the LIVE engine's (tenant interning order differs across
        hosts/boots), copying into the engine's resident state. Old
        checkpoints without a tenant table keep rows as-is."""
        if not tenant_tokens:
            return
        live = engine.registry.tenants
        mapping = []
        for old_idx, token in enumerate(tenant_tokens):
            if old_idx == 0 or token is None:
                continue
            mapping.append((old_idx, live.intern(token)))
        if all(old == new for old, new in mapping):
            return
        with engine._state_lock:
            for name in _TENANT_FIELDS:
                ref = getattr(engine.state, name)
                rows = ref.cpu().numpy()
                out = np.zeros_like(rows)
                out[..., 0] = rows[..., 0]  # unknown-tenant bucket stays
                for old_idx, new_idx in mapping:
                    if old_idx < rows.shape[-1] and new_idx < out.shape[-1]:
                        out[..., new_idx] += rows[..., old_idx]
                ref.copy_(torch.from_numpy(out))

    @staticmethod
    def _rules_manifest(engine) -> List[Dict]:
        from sitewhere_tpu_torch.pipeline.engine import rule_to_dict

        return [rule_to_dict(kind, rule)
                for kind, rule_list in engine.list_rules().items()
                for rule in rule_list]

    @staticmethod
    def _restore_rules(engine, rules: List[Dict]) -> None:
        from sitewhere_tpu_torch.pipeline.engine import rule_from_dict

        for data in rules:
            kind, rule = rule_from_dict(dict(data))
            engine.upsert_rule(kind, rule)

    @staticmethod
    def _restore_family(engine, rows: Optional[List[Dict]],
                        installer: str) -> None:
        """Re-install one family's checkpointed specs, each pinned to its
        saved (slot, epoch) so the restored state's generations line up
        and windows resume mid-flight. A spec this engine's buckets cannot
        hold logs and is skipped (its slot's state resets) rather than
        failing the whole restore."""
        for row in rows or ():
            spec = dict(row.get("spec") or {})
            try:
                getattr(engine, installer)(spec, slot=row.get("slot"),
                                           epoch=row.get("epoch"))
            except SiteWhereError:
                _log.exception("checkpointed %r did not restore (%s)",
                               spec.get("token"), installer)

    # -- recovery ----------------------------------------------------------
    def recover(self, engine, bus, topic: str, group_id: str,
                replay_handler, max_records: int = 4096) -> int:
        """Restore the latest checkpoint, then replay every bus record past
        the checkpointed offsets through `replay_handler(records)` until
        caught up. Returns the number of replayed records.

        This is the crash-recovery contract of SURVEY.md §5: device state
        is a cache; checkpoint + at-least-once replay rebuilds it."""
        offsets = self.restore(engine)
        consumer = bus.consumer(topic, group_id)
        saved = offsets.get(f"{topic}@{group_id}")
        if saved is None:
            # Checkpoint carries no cursor for this group: the only safe
            # at-least-once choice is a full replay of the retained log —
            # the bus's own committed offsets may be AHEAD of the
            # checkpointed state (committed after save), which would lose
            # those events.
            consumer.seek_to_beginning()
        else:
            n = len(consumer.topic.partitions)
            consumer.committed = (list(saved) + [0] * n)[:n]
            consumer.seek_to_committed()
        replayed = 0
        while True:
            batch = consumer.poll(max_records)
            if not batch:
                break
            replay_handler(batch)
            bus.commit(consumer)
            replayed += len(batch)
        return replayed
