"""Replay analytics engine: event log / bus -> windowed stat grids.

Counterpart of `sitewhere_tpu/analytics/engine.py` (BASELINE.md config 4,
"Kafka-replay windowed batch analytics"): the columnar event log
(persist/eventlog.py) yields raw column arrays with no per-event
materialization, the host compacts keys and rebases timestamps, and one
pass of the device ops (analytics/windows.py) on the engine's device
produces the grids, which come back to the host in one copy.

Two replay sources:
  * `ColumnarEventLog` (or a wide-row store) — vectorized scan;
  * an `EventBus` topic — decodes enriched payloads per record and feeds
    the same ops; the literal Kafka-replay flavor.

The sharded path (the JAX package's `parallel/distributed.py`
`sharded_windowed_stats`) is not ported yet: a mesh, given or chosen by
the planner, raises rather than being answered on one device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch.analytics.windows import (
    WindowedStats, compact_keys, dense_key_span, event_type_histogram,
    to_device, to_host, windowed_stats)
from sitewhere_tpu_torch.device import DeviceLike, own_stream, resolve_device
from sitewhere_tpu_torch.model.event import DeviceEventType
from sitewhere_tpu_torch.persist.eventlog import EventFilter

_N_EVENT_TYPES = 8  # DeviceEventType codes fit comfortably


def _pad_pow2(n: int, floor: int = 8) -> int:
    """Round a grid dimension up to a power of two so replays of similar
    size share one grid shape (the reference's static-shape bucketing)."""
    out = floor
    while out < n:
        out *= 2
    return out


def _host(t) -> np.ndarray:
    """A grid as a host numpy array (a device tensor is copied over)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _sync(device: torch.device) -> None:
    """Wait for the work queued on `device`'s current stream, which is the
    calling thread's own (device.py `own_stream`): never for other
    threads' work, the engine's step included."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclass
class WindowReport:
    """Host-side result of one windowed replay. `timings` holds the host
    seconds of its parts (scan, compact, h2d, device, d2h, report) where
    the engine measured them."""

    t0_ms: int
    window_ms: int
    n_windows: int
    key_ids: np.ndarray        # raw key per grid row (device_idx or hash id)
    key_tokens: List[str]      # resolved tokens when available ("" otherwise)
    stats: WindowedStats       # [K_padded, W] — rows past len(key_ids) unused
    type_counts: Optional[np.ndarray] = None  # int32 [n_types, W]
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def num_keys(self) -> int:
        return len(self.key_ids)

    def window_starts(self) -> np.ndarray:
        return self.t0_ms + np.arange(self.n_windows, dtype=np.int64) * \
            self.window_ms

    def series(self, row: int) -> Dict[str, np.ndarray]:
        """One key's per-window series as numpy arrays."""
        return {name: _host(getattr(self.stats, name)[row, :self.n_windows])
                for name in ("count", "sum", "mean", "min", "max")}

    def totals(self) -> Dict[str, float]:
        count = _host(self.stats.count)[:self.num_keys, :self.n_windows]
        vsum = _host(self.stats.sum)[:self.num_keys, :self.n_windows]
        n = int(count.sum())
        return {"events": n,
                "mean": float(vsum.sum() / n) if n else float("nan")}


def _empty_stats() -> WindowedStats:
    return WindowedStats(*(torch.zeros((0, 0), dtype=d) for d in (
        torch.int32, torch.float32, torch.float32, torch.float32,
        torch.float32)))


class WindowedAnalyticsEngine:
    """Windowed replay over the columnar event log, on `device`.

    With a `planner` (serving/planner.py) attached, `mesh=None` means
    "planner-decided"; a planner that chooses a mesh, like an explicit
    mesh, raises (the sharded path is not ported)."""

    def __init__(self, event_log, planner=None, device: DeviceLike = "cuda"):
        self.event_log = event_log
        self.planner = planner
        self.device = resolve_device(device)

    def measurement_windows(self, tenant: str, *, window_ms: int = 60_000,
                            mm_name: Optional[str] = None,
                            start_ms: Optional[int] = None,
                            end_ms: Optional[int] = None,
                            area_id: Optional[str] = None,
                            max_windows: int = 4096,
                            with_type_histogram: bool = False,
                            mesh=None) -> WindowReport:
        """Per-device windowed stats over measurement values: filter ->
        column scan -> one pass of the device ops."""
        flt = EventFilter(event_type=DeviceEventType.MEASUREMENT,
                          mm_name=mm_name, area_id=area_id,
                          start_date=start_ms, end_date=end_ms)
        if mesh is None and self.planner is not None:
            mesh = self.planner.choose_mesh(tenant, flt)
        if mesh is not None:
            # never answer a mesh query on one device instead
            raise NotImplementedError(
                "mesh-sharded windowed replay (sharded_windowed_stats, the "
                "sharded path) is not ported to sitewhere_tpu_torch yet; "
                "this engine serves single-device queries only")
        t_scan = time.perf_counter()
        # key on the int32 device_idx column, not the token strings; tokens
        # resolve afterwards, once per unique key, from each key's first
        # occurrence row
        names = ["device_idx", "device_token", "event_date", "value"]
        all_flt = (EventFilter(start_date=start_ms, end_date=end_ms,
                               area_id=area_id)
                   if with_type_histogram else None)
        cols = self.event_log.query_columns(tenant, flt, names)
        device_idx = cols["device_idx"].astype(np.int64, copy=True)
        # control-plane appends may lack an interned index (device_idx 0):
        # those rows get synthetic negative ids per distinct token, so
        # distinct devices never collapse into one key
        unindexed = np.nonzero(device_idx == 0)[0]
        if len(unindexed):
            token_col = cols["device_token"]
            # a device whose rows arrive via both paths stays one key: map
            # idx-0 rows to the real index when this result set has one
            real_rows = np.nonzero(device_idx > 0)[0]
            by_token: Dict[object, int] = {}
            if len(real_rows):
                uniq_real, first_real = np.unique(device_idx[real_rows],
                                                  return_index=True)
                for real_idx, row in zip(uniq_real.tolist(),
                                         real_rows[first_real].tolist()):
                    by_token.setdefault(token_col[row], int(real_idx))
            synthetic: Dict[object, int] = {}
            for row in unindexed:
                token = token_col[row]
                known = by_token.get(token)
                device_idx[row] = (known if known is not None
                                   else synthetic.setdefault(
                                       token, -1 - len(synthetic)))
        hist_cols = (self.event_log.query_columns(
            tenant, all_flt, ["event_type", "event_date"])
            if all_flt is not None else None)
        timings = {"scan": time.perf_counter() - t_scan}
        report = self._build_report(
            device_idx, cols["event_date"], cols["value"],
            window_ms=window_ms, start_ms=start_ms, end_ms=end_ms,
            max_windows=max_windows, hist_cols=hist_cols,
            device=self.device, timings=timings)
        t_tokens = time.perf_counter()
        if report.num_keys and len(device_idx):
            # first-occurrence row per key id: a reversed fancy assignment
            # makes the first occurrence's row index win
            key_ids = np.asarray(report.key_ids, np.int64)
            token_col = cols["device_token"]
            regime = dense_key_span(device_idx)
            if regime is not None:
                lo, span = regime
                first_row = np.full(span, -1, np.int64)
                first_row[(device_idx - lo)[::-1]] = np.arange(
                    len(device_idx) - 1, -1, -1, dtype=np.int64)
                rows = first_row[key_ids - lo].tolist()
            else:  # tiny result sets / huge key spans: dict fallback
                lookup: Dict[int, int] = {}
                for row, k in enumerate(device_idx.tolist()):
                    lookup.setdefault(k, row)
                rows = [lookup.get(int(k), -1) for k in key_ids]
            report.key_tokens = [
                "" if row < 0 or token_col[row] is None
                else str(token_col[row]) for row in rows]
        report.timings["report"] += time.perf_counter() - t_tokens
        return report

    @staticmethod
    def _build_report(key_raw: np.ndarray, event_date: np.ndarray,
                      value: np.ndarray, *, window_ms: int,
                      start_ms: Optional[int], end_ms: Optional[int],
                      max_windows: int, device: DeviceLike,
                      hist_cols: Optional[Dict[str, np.ndarray]] = None,
                      tokens: Optional[List[str]] = None,
                      timings: Optional[Dict[str, float]] = None
                      ) -> WindowReport:
        device = resolve_device(device)
        timings = {} if timings is None else timings
        t = time.perf_counter()
        n = len(event_date)
        # windows come from whatever rows exist: measurement rows normally,
        # histogram rows when the measurement filter matched none
        span_dates = event_date
        if n == 0 and hist_cols is not None and len(hist_cols["event_date"]):
            span_dates = hist_cols["event_date"]
        if len(span_dates) == 0:
            timings.update(compact=0.0, h2d=0.0, device=0.0, d2h=0.0,
                           report=0.0)
            return WindowReport(t0_ms=start_ms or 0, window_ms=window_ms,
                                n_windows=0, key_ids=np.array([], object),
                                key_tokens=[], stats=_empty_stats(),
                                timings=timings)
        t0 = int(start_ms if start_ms is not None else span_dates.min())
        t_end = int(end_ms if end_ms is not None else span_dates.max())
        n_windows = max(1, min(max_windows, (t_end - t0) // window_ms + 1))

        def buckets(dates: np.ndarray) -> np.ndarray:
            """int64-safe host bucketing: the bucket index (small, capped
            by max_windows) is computed here and fed to the ops with
            window_ms=1."""
            rel = dates.astype(np.int64) - t0
            b = rel // window_ms
            return np.where((rel >= 0) & (b < n_windows), b,
                            -1).astype(np.int32)

        valid = (event_date >= t0) & (event_date <= t_end)
        dense, uniq = compact_keys(key_raw, valid)
        K = _pad_pow2(max(len(uniq), 1))
        W = _pad_pow2(int(n_windows))
        host = [dense, buckets(event_date),
                np.asarray(value, np.float32), valid]
        h_host = None
        if hist_cols is not None and len(hist_cols["event_date"]):
            h_dates = hist_cols["event_date"]
            h_host = [np.asarray(hist_cols["event_type"], np.int32),
                      buckets(h_dates), (h_dates >= t0) & (h_dates <= t_end)]
        timings["compact"] = time.perf_counter() - t
        with own_stream(device):
            t = time.perf_counter()
            on_dev = [to_device(a, device) for a in host]
            h_dev = (None if h_host is None else
                     [to_device(a, device) for a in h_host])
            _sync(device)
            timings["h2d"] = time.perf_counter() - t
            t = time.perf_counter()
            stats = windowed_stats(*on_dev, window_ms=1, num_keys=K,
                                   n_windows=W, device=device)
            hist = (None if h_dev is None else event_type_histogram(
                *h_dev, window_ms=1, n_types=_N_EVENT_TYPES, n_windows=W,
                device=device))
            _sync(device)
            timings["device"] = time.perf_counter() - t
            t = time.perf_counter()
            stats = stats.to("cpu")
            type_counts = (None if hist is None
                           else to_host(hist).numpy()[:, :n_windows])
            timings["d2h"] = time.perf_counter() - t
        t = time.perf_counter()
        if tokens is not None:
            key_tokens = tokens
        elif uniq.dtype == object:
            key_tokens = [str(u) for u in uniq]
        else:
            key_tokens = [""] * len(uniq)
        report = WindowReport(t0_ms=t0, window_ms=window_ms,
                              n_windows=int(n_windows),
                              key_ids=np.asarray(uniq),
                              key_tokens=key_tokens, stats=stats,
                              type_counts=type_counts, timings=timings)
        timings["report"] = time.perf_counter() - t
        return report


def _decode_measurement_chunk(batch):
    """One poll batch -> (tokens, dates, values) preallocated columns.

    Reads the three scalars replay needs straight out of the msgpack dict
    (no dataclass per row); a record whose shape surprises it retries
    through the full decoder before being dropped. Returns None when the
    batch holds no measurements."""
    import msgpack

    m = len(batch)
    tokens = np.empty(m, object)
    dates = np.empty(m, np.int64)
    values = np.empty(m, np.float32)
    k = 0
    measurement = int(DeviceEventType.MEASUREMENT)
    for record in batch:
        try:
            event = msgpack.unpackb(record.value, raw=False)["event"]
            etype = event["event_type"]
            edate = event["event_date"]
            evalue = event.get("value", 0.0)
            token = event.get("device_id") or ""
        except Exception:
            try:  # slow-path retry: the full decode
                from sitewhere_tpu_torch.pipeline.enrichment import (
                    unpack_enriched)
                _, ev = unpack_enriched(record.value)
                etype, edate = int(ev.event_type), ev.event_date
                evalue = getattr(ev, "value", 0.0)
                token = ev.device_id or ""
            except Exception:
                continue
        if etype != measurement:
            continue
        tokens[k] = token
        dates[k] = int(edate)
        values[k] = float(evalue or 0.0)
        k += 1
    if k == 0:
        return None
    return tokens[:k], dates[:k], values[:k]


class BusReplayAnalytics:
    """The literal Kafka-replay flavor: re-consume an enriched topic from
    offset zero into columns, then run the same windowed ops on `device`."""

    def __init__(self, bus, naming=None, device: DeviceLike = "cuda"):
        from sitewhere_tpu_torch.runtime.bus import TopicNaming
        self.bus = bus
        self.naming = naming or TopicNaming()
        self.device = resolve_device(device)

    def replay_measurements(self, tenant: str, *, window_ms: int = 60_000,
                            group_id: str = "analytics-replay",
                            max_windows: int = 4096) -> WindowReport:
        topic = self.naming.inbound_enriched_events(tenant)
        consumer = self.bus.consumer(topic, group_id)
        consumer.seek_to_beginning()
        token_chunks: List[np.ndarray] = []
        date_chunks: List[np.ndarray] = []
        value_chunks: List[np.ndarray] = []
        while True:
            batch = consumer.poll(8192)
            if not batch:
                break
            chunk = _decode_measurement_chunk(batch)
            if chunk is not None:
                token_chunks.append(chunk[0])
                date_chunks.append(chunk[1])
                value_chunks.append(chunk[2])
        if not token_chunks:
            return WindowedAnalyticsEngine._build_report(
                np.array([], np.int64), np.array([], np.int64),
                np.array([], np.float32), window_ms=window_ms,
                start_ms=None, end_ms=None, max_windows=max_windows,
                device=self.device, tokens=[])
        all_tokens = np.concatenate(token_chunks)
        # one np.unique pass, then a rank remap so key ids keep the
        # first-appearance numbering (np.unique sorts lexically)
        uniq, first, inverse = np.unique(all_tokens, return_index=True,
                                         return_inverse=True)
        rank = np.empty(len(uniq), np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(
            len(uniq), dtype=np.int64)
        keys = rank[inverse]
        tokens_arr = np.empty(len(uniq), object)
        tokens_arr[rank] = uniq
        return WindowedAnalyticsEngine._build_report(
            keys, np.concatenate(date_chunks),
            np.concatenate(value_chunks), window_ms=window_ms,
            start_ms=None, end_ms=None, max_windows=max_windows,
            device=self.device, tokens=[str(t) for t in tokens_arr])
