"""Interner replicas + remote packing: the feeder's half of bit-identity.

Counterpart of `sitewhere_tpu/feeders/replica.py`. The decode and the
replicas' batched lookups run on the native host library (`native.py`),
which raises when it cannot be built: there is no Python fallback.

A feeder packs with REPLICAS of the landing host's three interners, kept
in lockstep through the append-only token journal
(registry/interning.py): ``sync()`` pulls the journal delta since the
replica's position (``feeder_journal``), and NEW measurement/alert-type
tokens are allocated authoritatively on the landing host
(``feeder_intern`` — one round trip per new TOKEN, never per event).
Replaying the journal reproduces the authoritative table slot-for-slot
(congruence gaps included: a sharded engine's device interner places a
token in its shard's class, `dev_shard_classes` in the hello), so a
replica lookup returns the same index the landing host's would — the
whole bit-identity argument.

Device tokens are never interned by ingest on either side: an unknown
device must stay index 0 so the pipeline flags it unregistered
(pipeline/step.py stage 1). A device MISS on the replica is ambiguous —
genuinely unregistered, or registered since the last sync — so the
packer re-syncs the device journal once per miss batch before
conceding UNKNOWN; replica lag then costs one catch-up round trip, not
a divergent pack.

A checkpoint restore on the landing host swaps interner contents wholesale;
the journal epoch bumps and the replica rebuilds from zero on the next
sync (``journal_epoch`` mismatch).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch import native
from sitewhere_tpu_torch.feeders.protocol import OP_INTERN, OP_JOURNAL
from sitewhere_tpu_torch.ops.pack import EventBatch, EventPacker
from sitewhere_tpu_torch.registry.interning import TokenInterner
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS


class ReplicaPacker:
    """Decode raw wire frames and pack EventBatches with replica
    interners — the remote twin of sources/fastlane.py FastWireIngest,
    bit-identical to it by construction (same decode, same lookup/intern
    contract against journal-synced tables, same EventPacker with the
    landing host's ``epoch_base_ms``)."""

    _NAMES = ("devices", "measurements", "alert_types")

    def __init__(self, hello: dict, client, metrics=GLOBAL_METRICS):
        self.client = client
        self.hello = dict(hello)
        self._metrics = metrics
        self._sync_counter = metrics.counter("feeder.journal_syncs")
        self._intern_counter = metrics.counter("feeder.interned_tokens")
        # server journal epochs as of the replica's last sync; a mismatch
        # means the authoritative table was checkpoint-restored — rebuild
        self._epochs: Dict[str, Optional[int]] = {n: None
                                                  for n in self._NAMES}
        self._build_interners()
        self.packer = EventPacker(
            int(hello["batch_size"]), self.devices,
            max_measurement_names=int(hello["mm_capacity"]),
            max_alert_types=int(hello["at_capacity"]),
            epoch_base_ms=int(hello["epoch_base_ms"]))
        # swap the packer's private meta interners for the replicas
        self.packer.measurements = self.measurements
        self.packer.alert_types = self.alert_types
        # the native library is built (or raises) here, before any poll
        native.lib()

    def _build_interners(self) -> None:
        h = self.hello
        self.devices = TokenInterner(
            int(h["dev_capacity"]), "devices",
            shard_classes=int(h.get("dev_shard_classes", 1)))
        self.measurements = TokenInterner(
            int(h["mm_capacity"]), "measurements")
        self.alert_types = TokenInterner(
            int(h["at_capacity"]), "alert_types")

    def _interner(self, name: str) -> TokenInterner:
        return {"devices": self.devices, "measurements": self.measurements,
                "alert_types": self.alert_types}[name]

    # -- journal sync -------------------------------------------------------

    def _rebuild(self, name: str) -> TokenInterner:
        h = self.hello
        if name == "devices":
            self.devices = TokenInterner(
                int(h["dev_capacity"]), "devices",
                shard_classes=int(h.get("dev_shard_classes", 1)))
            self.packer.devices = self.devices
            return self.devices
        if name == "measurements":
            self.measurements = TokenInterner(
                int(h["mm_capacity"]), "measurements")
            self.packer.measurements = self.measurements
            return self.measurements
        self.alert_types = TokenInterner(int(h["at_capacity"]),
                                         "alert_types")
        self.packer.alert_types = self.alert_types
        return self.alert_types

    def _apply(self, name: str, resp: dict) -> TokenInterner:
        """Fold one feeder_journal/feeder_intern reply into the replica,
        rebuilding from zero on a journal-epoch change (the server-side
        interner was checkpoint-restored)."""
        interner = self._interner(name)
        epoch = int(resp["journal_epoch"])
        if self._epochs[name] is not None and self._epochs[name] != epoch:
            interner = self._rebuild(name)
            resp = self.client.call(OP_JOURNAL, interner=name, since=0)
            epoch = int(resp["journal_epoch"])
        self._epochs[name] = epoch
        base = int(resp["base"])
        if base != interner.journal_len():
            # positional drift (e.g. replica rebuilt above): refetch flat
            resp = self.client.call(OP_JOURNAL, interner=name,
                                    since=interner.journal_len())
            base = int(resp["base"])
        interner.apply_delta(
            [(int(i), t) for i, t in resp["entries"]], base)
        return interner

    def sync(self, names: Optional[Tuple[str, ...]] = None) -> None:
        """Pull journal deltas for the named replicas (all by default)."""
        for name in names or self._NAMES:
            interner = self._interner(name)
            resp = self.client.call(OP_JOURNAL, interner=name,
                                    since=interner.journal_len())
            self._apply(name, resp)
            self._sync_counter.inc()

    # -- token resolution ---------------------------------------------------

    def _resolve_meta(self, name: str, buf: bytes, off: np.ndarray
                      ) -> np.ndarray:
        """measurement/alert-type indices: replica lookup, then one
        authoritative allocation round trip for tokens the replica has
        never seen (new-token-mid-stream). Empty tokens stay UNKNOWN."""
        interner = self._interner(name)
        idx = interner.lookup_offsets(buf, off)
        nonempty = np.asarray(off[1:]) > np.asarray(off[:-1])
        miss_rows = np.nonzero((idx == 0) & nonempty)[0]
        if len(miss_rows) == 0:
            return idx
        seen = set()
        tokens: List[str] = []
        for r in miss_rows:
            t = buf[int(off[r]):int(off[r + 1])].decode(
                errors="surrogateescape")
            if t not in seen:
                seen.add(t)
                tokens.append(t)
        resp = self.client.call(OP_INTERN, interner=name, tokens=tokens,
                                since=interner.journal_len())
        interner = self._apply(name, resp)
        self._intern_counter.inc(len(tokens))
        return interner.lookup_offsets(buf, off)

    def _resolve_devices(self, buf: bytes, off: np.ndarray) -> np.ndarray:
        """Device indices: lookup-only (ingest NEVER allocates devices),
        but a miss re-syncs the journal once — replica lag must not turn
        a freshly registered device into an unregistered event when the
        inline path would have packed its real index."""
        idx = self.devices.lookup_offsets(buf, off)
        nonempty = np.asarray(off[1:]) > np.asarray(off[:-1])
        if np.any((idx == 0) & nonempty):
            self.sync(("devices",))
            idx = self.devices.lookup_offsets(buf, off)
        return idx

    # -- decode + pack ------------------------------------------------------

    def pack_bytes(self, data: bytes) -> Tuple[List[EventBatch], int, bytes]:
        """Raw concatenated wire frames -> packed batches. Returns
        (batches, n_events, undecodable remainder). Control frames are
        dropped here — feeders carry the hot-event stream; control
        traffic stays on the standard source path."""
        cols = native.decode_hot_frames(data)
        rest = data[cols.consumed:]
        if cols.n == 0:
            return [], 0, rest
        tok_buf, tok_off = cols.tokens
        device_idx = self._resolve_devices(tok_buf, tok_off)
        name_buf, name_off = cols.names
        mm_idx = self._resolve_meta("measurements", name_buf, name_off)
        at_buf, at_off = cols.alert_types
        alert_type_idx = self._resolve_meta("alert_types", at_buf, at_off)
        batches = self._pack(
            device_idx, cols.event_type, cols.ts_ms, mm_idx, cols.value,
            cols.lat, cols.lon, cols.elevation, alert_type_idx,
            cols.alert_level)
        return batches, int(cols.n), rest

    def _pack(self, device_idx, event_type, ts_ms, mm_idx, value, lat, lon,
              elevation, alert_type_idx, alert_level) -> List[EventBatch]:
        B = self.packer.batch_size
        out: List[EventBatch] = []
        for s in range(0, len(device_idx), B):
            e = s + B
            out.append(self.packer.pack_columns(
                device_idx[s:e], event_type[s:e], ts_ms[s:e],
                mm_idx=mm_idx[s:e], value=value[s:e], lat=lat[s:e],
                lon=lon[s:e], elevation=elevation[s:e],
                alert_type_idx=alert_type_idx[s:e],
                alert_level=alert_level[s:e]))
        return out
