#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sitewhere_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure prints its error and exits non-zero, with no result):
  1. card: the GPU's name and power limit, torch/CUDA versions, and the
     build of every CUDA kernel of the path (nvcc, in parallel, at first use);
  2. kernel vs plain: each kernel held bit for bit against its plain torch
     version on the card at the main path's shapes (and on adversarial
     geometry), with CUDA-event timings beside the bound computed from the
     inputs, on KERNEL_WORLDS: the main path's zones (Z=256), a quarter of
     them (Z=64), zones wide enough that y-rejection almost never fires,
     and the main path's zones with 32 vertices (the registry's default
     max_zone_vertices);
  3. main path at full size: a 100k-device registry (131072 rows), 256
     zones x 16 vertices, 16 threshold + 64 geofence rules, batches of
     131072 events in the 60/30/10 measurement/location/alert mix, driven
     through `PipelineEngine.submit` + `materialize_alerts` and one
     `presence_sweep`; every kernel launch counted. The same trace then
     runs through a second engine that takes the plain geofence version:
     alerts, canonical state and presence transitions must be identical;
  4. where the time goes: CUDA-event split of one step's stages;
  5. stateful path at full size: the world of phase 3 with the engine's
     stateful buckets at the JAX engine's defaults (32 rule programs x 16
     nodes x 8 state slots, 8 anomaly models x 4 features x 2 layers x
     width 8, 8 actuation policies, a 64-slot command lane), rule programs
     that run every ProgramOp, MLP and autoencoder models and two
     actuation policies, under traffic whose measurements spread over m1
     and m2; both kernels' launches counted (B1 and the rule-program
     kernel once per step, counted per replay, one capture), CUDA-event
     spans of the stateful stages and a profile. The first
     STATEFUL_CPU_STEPS batches then run through the same engine built on
     the CPU: alerts, command fires, every state group (f32 as bit
     patterns) and every counter must be identical, the per-row anomaly
     scores within rtol=1e-4, atol=1e-5. Then the rule-program kernel
     (csrc/rule_programs.cu) against its plain version on the card: a
     fresh engine over the same steps beside an eager twin that runs the
     plain version (every slab lane, counter and program output, each
     step), the adversarial RULE_WORLDS, and the kernel alone at the last
     step's rows, timed beside its plain version and the bound of the
     attach rows' bytes;
  6. the host runtime: the pipelined feeder against serial submission on
     both worlds, a seeded h2d/dispatch/lane-fetch fault drill, the flight
     rollups and the device-memory ledger;
  7. durable state (persist/checkpoint.py and the families' host side) at
     full size: the main world saves after DURABLE_CUT steps fed from an
     in-process EventBus and restores into a fresh card engine and into one
     that has captured its graph; both continue beside the uninterrupted
     engine with identical alerts, presence transitions and state, and no
     new capture; `recover` replays exactly the records past the saved
     offsets. The stateful world saves with debounce, for-duration and
     hysteresis windows open and restores into a fresh card engine and the
     same engine on the CPU, which continue with identical fires and state
     groups (scores within the tolerance above). A seeded
     `command_delivery_error` drill through CommandFanout delivers the
     fires a twin's take_command_fires gives, DriftRefitter on the card
     gives the CPU engine's refit, and one DevicePresenceManager sweep
     equals a twin's presence_sweep. Save, restore and recover wall times,
     their device<->host parts and the bytes on disk are printed;
  8. the ingest host tier at full size, on phase 3's world with its
     control plane (a DeviceManagement of the same 100k devices attached
     to the mirror): INGEST_WARMUP + INGEST_DELIVERIES deliveries of BATCH
     events in the same mix as wire frames (INGEST_UNKNOWN of them from
     unknown tokens, INGEST_CONTROL REGISTER frames each, every delivery
     cut a few bytes into a frame so the remainder path runs) through
     `BulkWireIngestService`: native decode, batched interning, the native
     pack into the pinned staging buffer, the captured step (B1 counted),
     alert materialization and persistence, the columnar event log, once
     appended inline and once on the persistence worker. Alerts, canonical
     state and presence transitions must equal a second card engine fed
     the decoded batches through `submit`; the log's rows the batches'
     valid rows; the unregistered topic the unknown tokens; the control
     frames forwarded. Then the native decoder against the plain one on one
     delivery, the native pack against the plain numpy pack into a pinned
     buffer on each wire layout (byte-equal, then timed in alternation),
     and an object-path drill (~1024 events from the bus through
     `InboundProcessingService`, persistence triggers and
     `PayloadEnrichment`) on the card against the same drill on the CPU.
     Per-delivery host ms of its parts and events/s from bytes to
     persisted rows are printed;
  9. the read side of the event log at full size (the JAX package's query
     and serving fixtures, bench.py `_build_query_10m`, `_build_serving`):
     a ColumnarEventLog of phase 3's batches, each chunk shifted one minute
     forward and sealed, until it holds READ_ROWS rows (77 chunks, a
     [131072, 128] grid). The path, with the segment-sum kernel's count
     set to 0 before and read after: (b) `measurement_windows` with the
     histogram on a card engine and a CPU engine: keys, tokens, every
     grid's bits and the histogram equal; the host split of the query.
     (c) the serving tier (QueryExecutor, QueryPlanner, WindowGridCache):
     cold, warm and a one-segment delta query, each held against the
     monolithic query under the reference's tolerance, then READ_CLIENTS
     synchronous clients, each sending at least READ_MIN_QUERIES queries,
     against a writer sealing a chunk every READ_WRITER_PERIOD_S: query
     p50/p99 with their sample counts, queries/s over the wall from the
     first send to the last completion, cache hits, sheds, no torn read,
     spot results equal to a cold query at their watermark. Then (a) the
     device ops at that query's own inputs on the card against the CPU
     (every cell's bits), timed with CUDA events beside the bound of their
     bytes, the segment-sum kernel against its plain version, then the
     adversarial fixture with a hot cell of HOT_ROWS rows, where the
     kernel's time stands beside the floor of its chain of dependent adds
     (rows x FADD_LATENCY_CYCLES at the card's highest SM clock). (d) a fresh
     phase 3 engine captures and steps beside querying clients: alerts and
     state equal, one capture, its graph pool unchanged, its wall beside
     its wall alone. (e) bus replay on the card equals the CPU and the
     per-record loop. (f) a wide-row tenant's query on the card equals the
     CPU. Last, hourly windows over CHATTY_DEVICES chatty devices (thousands
     of rows a cell), card equal to CPU.
The last lines are the kernels' JSON line, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

SEED = 20260101
# BASELINE config 3 at the repo's headline batch shape
BATCH = 131072
MAX_DEVICES = 131072
N_REGISTERED = 100_000
N_ZONES, N_VERTS = 256, 16
N_THRESHOLD, N_GEOFENCE = 16, 64
MEASUREMENT_SLOTS, MAX_TENANTS, MAX_RULES = 32, 16, 64
WARMUP, STEPS, TIMED_REPS = 3, 20, 20
QUEUED_LAUNCHES = 10
SPIN_CYCLES_PER_LAUNCH = 200_000   # ~0.1 ms of card clock per queued call
# traffic is dated within 1 s of an epoch base set 10 s before the run; a
# 1 s presence interval makes the sweep's transitions (every device seen)
# independent of when it runs
PRESENCE_MS = 1000
EPOCH_LAG_MS = 10_000
LAT_LON_BOX = (-5.0, 15.0)
ZONE_RADIUS = (0.5, 3.0)      # the main path's zones
WIDE_RADIUS = (20.0, 30.0)    # zones as wide as the box: little rejection
# phase 5: the card engine's first STATEFUL_CPU_STEPS steps are held
# against the same engine on the CPU; anomaly scores carry the JAX
# package's own tolerance (tanh/exp differ in the last bits)
STATEFUL_CPU_STEPS = 4
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5
# phase 7: steps before the save and after the restore
DURABLE_CUT, DURABLE_AFTER = 3, 3
# phase 8: deliveries of BATCH events (warm-up, timed), the share of events
# from unknown tokens, REGISTER frames per delivery, pack timing calls per
# layout, devices of the object-path drill
INGEST_WARMUP, INGEST_DELIVERIES = 3, 10
INGEST_UNKNOWN = 0.001
INGEST_CONTROL = 4
INGEST_PACK_REPS = 20
OBJECT_DEVICES = 64
# phase 9: the read side at the JAX package's serving and query fixtures
# (bench.py _build_query_10m, _build_serving): a log of at least READ_ROWS
# rows in one-minute chunks sealed one segment each; the served range spans
# READ_WINDOWS minutes (the log's and the chunks a writer seals after it);
# the executor, cache and client counts of the serving tier; the bus
# replay's records and devices; the adversarial fixture's rows and hot cell;
# the chatty tenant: CHATTY_DEVICES devices over CHATTY_CHUNKS chunks of
# phase 3's batches spread over one hour, queried in hourly windows
# (thousands of rows per cell)
READ_TENANT = "tenant-1"
READ_ROWS = 10_000_000
READ_SEGMENT_ROWS = 65536
READ_WINDOW_MS = 60_000
READ_WINDOWS = 128
READ_WORKERS, READ_DEPTH = 8, 512
READ_CACHE_BYTES = 64 << 20
# 64 clients at >= 3 queries each took 91 s on the H100 at ~2.9 queries/s
# served (PERF.md): cut, so that phase 9 stays near its time
READ_CLIENTS = (1, 16)
READ_MIN_QUERIES = 3          # each client's least number of queries
READ_WRITER_PERIOD_S = 0.5
READ_BESIDE_CLIENTS, READ_BESIDE_STEPS = 16, 6
REPLAY_RECORDS, REPLAY_DEVICES = 24_000, 64
ADVERSARIAL_ROWS, ADVERSARIAL_KEYS, HOT_ROWS = 1_000_000, 1024, 100_000
CHATTY_TENANT, CHATTY_DEVICES, CHATTY_CHUNKS = "tenant-chatty", 256, 12
HOUR_MS = 3_600_000
H100_F32_FLOPS = 67e12        # NVIDIA H100 SXM data sheet, non-tensor f32
# the latency of one dependent f32 add on the H100's SMs, in SM clock cycles
# (the floor of a bit-equal row-order fold: one add after the other)
FADD_LATENCY_CYCLES = 4
# operations one node of a rule program takes on one (row, program): loads
# of its table fields and row values, the compare or combinator, the state
# read and write (a count for the bound, not a measurement)
RULE_NODE_OPS = 10
H100_HBM_BYTES_S = 3.35e12    # NVIDIA H100 SXM data sheet, HBM3
# phase 2's worlds of B=BATCH points: (name, seed, Z, V, zone radius)
KERNEL_WORLDS = [
    ("main_z64", SEED + 64, 64, N_VERTS, ZONE_RADIUS),
    ("main_z256", SEED + N_ZONES, N_ZONES, N_VERTS, ZONE_RADIUS),
    ("wide_z256", SEED + N_ZONES + 1, N_ZONES, N_VERTS, WIDE_RADIUS),
    ("main_z256_v32", SEED + N_ZONES + 2, N_ZONES, 32, ZONE_RADIUS),
]


# -- seeded geometry and traffic ------------------------------------------------

def random_world(seed, B, Z, V, box=(-70.0, 70.0), radius=(2.0, 12.0)):
    """Points [B] and convex-ish polygons [Z, V, 2] (lat, lon), each with
    3..V vertices padded by repeating the last one."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(box[0], box[1], (Z, 2))
    verts = np.zeros((Z, V, 2), np.float32)
    for z in range(Z):
        nv = int(rng.integers(3, V + 1))
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        r = rng.uniform(radius[0], radius[1], nv)
        pts = centers[z] + np.stack([r * np.sin(ang), r * np.cos(ang)], 1)
        verts[z, :nv] = pts
        verts[z, nv:] = pts[-1]
    lat = rng.uniform(box[0], box[1], B).astype(np.float32)
    lon = rng.uniform(box[0], box[1], B).astype(np.float32)
    return lat, lon, verts


def adversarial_world():
    """Points exactly on vertices, on horizontal edges, one ulp either side
    of edges and vertices, denormal and NaN/inf coordinates, against an
    axis-aligned square, a slanted quadrilateral, a padded triangle, a zone
    collapsed to one point, an all-zero zone and a zone whose coordinate
    products are denormal; zones with a NaN y vertex, a NaN x vertex, +inf
    and -inf vertices, a flat zone (all y equal) and a zone whose ymin is
    -0.0, with points exactly at every zone's ymin and ymax, one ulp either
    side of each, and at +0.0 beside the -0.0 zone."""
    V = 6
    square = [(0, 0), (0, 10), (10, 10), (10, 0)]
    slanted = [(1.25, -3.5), (7.75, 2.125), (3.3, 9.1), (-2.2, 4.4)]
    tri = [(-4, -4), (-1, -2), (-3, 1)]
    tiny = [(1e-20, 1e-20), (3e-20, 2e-20), (2e-20, 4e-20)]
    nan_y = [(0, 0), (np.nan, 5), (10, 10), (10, 0)]
    nan_x = [(0, 0), (5, np.nan), (10, 10), (10, 0)]
    pos_inf = [(0, 0), (np.inf, 5), (10, 10), (5, np.inf)]
    neg_inf = [(-np.inf, 0), (4, -np.inf), (8, 8), (2, 6)]
    flat = [(3, 0), (3, 10), (3, 5)]
    neg_zero = [(-0.0, 0), (-0.0, 10), (6, 5)]
    zones = []
    for poly in (square, slanted, tri, [(5.5, 5.5)], [], tiny, nan_y, nan_x,
                 pos_inf, neg_inf, flat, neg_zero):
        arr = np.zeros((V, 2), np.float32)
        if poly:
            p = np.asarray(poly, np.float32)
            arr[:len(p)] = p
            arr[len(p):] = p[-1]
        zones.append(arr)
    verts = np.stack(zones)
    pts = []
    for z in verts[:3]:
        for v in range(V):
            (y1, x1), (y2, x2) = z[v], z[(v + 1) % V]
            pts.append((y1, x1))                       # on a vertex
            for ty in (0.25, 0.5, 0.75):               # on / beside edges
                y = np.float32(y1 + (y2 - y1) * ty)
                if y2 != y1:
                    x = np.float32(x1 + (x2 - x1) * (y - y1) / (y2 - y1))
                else:
                    x = np.float32(x1 + (x2 - x1) * ty)
                for dx in (-np.inf, 0, np.inf):
                    xx = x if dx == 0 else np.nextafter(x, np.float32(dx))
                    pts.append((y, xx))
                for dy in (-np.inf, np.inf):
                    pts.append((np.nextafter(y, np.float32(dy)), x))
            for d in (-np.inf, np.inf):
                pts.append((np.nextafter(y1, np.float32(d)), x1))
                pts.append((y1, np.nextafter(x1, np.float32(d))))
    for z in verts:   # at each zone's y bounds (NaN ignored), ulps beside
        ys, xs = z[:, 0], z[:, 1][np.isfinite(z[:, 1])]
        xmid = np.float32((xs.min() + xs.max()) / 2) if xs.size else 0.0
        for y0 in (np.nanmin(ys), np.nanmax(ys)):
            for y in (np.nextafter(y0, np.float32(-np.inf)), y0,
                      np.nextafter(y0, np.float32(np.inf))):
                pts += [(y, xmid), (y, xmid - 20), (y, xmid + 20)]
    pts += [(0.0, 5.0), (0.0, -1.0), (0.0, 11.0), (1.0, 5.0)]  # by -0.0
    rng = np.random.default_rng(5)
    pts += [(y, x) for y, x in rng.uniform(0.5e-20, 4.5e-20, (40, 2))]
    pts += [(np.nan, 1.0), (1.0, np.nan), (np.inf, 5.0), (5.0, -np.inf),
            (-np.inf, 5.0), (5.0, np.inf), (np.nan, np.nan),
            (5.5, 5.5), (0.0, 0.0), (-0.0, -0.0)]
    p = np.asarray(pts, np.float32)
    return p[:, 0].copy(), p[:, 1].copy(), verts


def synthetic_batch(packer, n_registered, batch, seed,
                    p_types=(0.6, 0.3, 0.1), mm_slots=(1,), t_off_ms=0):
    """One batch of the headline traffic: registered devices, the 60/30/10
    measurement/location/alert mix, values U(0,100), lat/lon in the box, ts
    within 1 s of the packer's epoch base plus `t_off_ms`. Measurements go
    to slot 1 (m1), or uniformly over `mm_slots`."""
    rng = np.random.default_rng(seed)
    now = packer.epoch_base_ms + t_off_ms
    cols = (rng.integers(1, n_registered + 1, batch).astype(np.int32),
            rng.choice([0, 1, 2], size=batch, p=list(p_types))
            .astype(np.int32),
            (now + rng.integers(0, 1000, batch)).astype(np.int64))
    kw = dict(value=rng.uniform(0, 100, batch).astype(np.float32),
              lat=rng.uniform(*LAT_LON_BOX, batch).astype(np.float32),
              lon=rng.uniform(*LAT_LON_BOX, batch).astype(np.float32))
    mm = (np.full(batch, mm_slots[0], np.int32) if len(mm_slots) == 1
          else rng.choice(mm_slots, batch).astype(np.int32))
    return packer.pack_columns(*cols, mm_idx=mm, **kw)


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


# values that hit every special case of the window ops: signed zeros, quiet
# and signalling NaNs of both signs, infinities, near-overflow, denormals,
# the smallest normals (whose sums cancel into denormals) and tiny normals
WINDOW_SPECIALS = np.array(
    [0.0, -0.0, np.nan, np.inf, -np.inf, 3e38, -3e38, 1e-40, -1e-40,
     1.2e-38, -1.19e-38, 1e-30, 5e-39]
    + [_f32(b) for b in (0x00800001, 0x80800001, 0x7FC00001, 0xFFC00002,
                         0x7F800001, 0xFF800003, 0x00000001)], np.float32)


def adversarial_window_rows(seed, n, num_keys, n_windows, window_ms,
                            hot_rows=0):
    """(keys int32, ts_rel int64, value f32, valid bool) for the window ops:
    a quarter of the values from WINDOW_SPECIALS, keys and buckets reaching
    below 0 and past the grid, ~5% invalid rows, window 0 of keys 0-3 made
    only of near-FLT_MIN normals of both signs (partial sums that cancel
    into denormals), and `hot_rows` rows of one key in window 1, spread
    through the rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, num_keys + 2, n).astype(np.int32)
    ts = rng.integers(-2 * window_ms, (n_windows + 2) * window_ms, n)
    value = np.where(rng.random(n) < 0.25, rng.choice(WINDOW_SPECIALS, n),
                     rng.normal(0, 10, n)).astype(np.float32)
    valid = rng.random(n) > 0.05
    ts[(keys >= 0) & (keys < 4) & (ts // window_ms == 0)] += 2 * window_ms
    near = rng.random(n) < 0.05
    keys[near] = rng.integers(0, min(num_keys, 4), int(near.sum()))
    ts[near] = 0
    value[near] = (rng.choice([-1.0, 1.0], int(near.sum()))
                   * rng.uniform(1.0, 1.3, int(near.sum())) * 1.1754944e-38)
    if hot_rows:
        # the hot cell holds only the hot rows (finite values), so its sum
        # is a long row-order fold, not a NaN
        hot_key = num_keys // 2
        ts[(keys == hot_key) & (ts // window_ms == 1)] += window_ms
        hot = np.sort(rng.choice(n + hot_rows, hot_rows, replace=False))
        keys = np.insert(keys, hot - np.arange(hot_rows), hot_key)
        ts = np.insert(ts, hot - np.arange(hot_rows), window_ms + 1)
        value = np.insert(value, hot - np.arange(hot_rows),
                          rng.uniform(0, 100, hot_rows).astype(np.float32))
        valid = np.insert(valid, hot - np.arange(hot_rows), True)
    return keys, ts.astype(np.int64), value, valid


_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
# f32 bit patterns of the rule worlds' value, aux and constant draws: signed
# zeros, NaNs with payloads and signs, infinities, denormals, the smallest
# normals, and values near the programs' thresholds
RULE_SPECIALS = np.array(
    [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-45, 3e-39, -5e-39,
     1.1754944e-38, -1.1754944e-38, 3e38, -3e38, 50.0, 50.000004, 49.999996,
     1000.0, -1000.0]
    + [_f32(b) for b in (0x7FC00001, 0xFFC00002, 0x7F800001, 0x00800001)],
    np.float32)
# the rule-program worlds of phase 5 and tests/test_torch_rule_kernel.py:
# (name, seed, B rows, D devices, P programs, N nodes, S slots, M slots,
#  node_limit, one attach row with a device index >= D)
RULE_WORLDS = [
    ("mixed", 7, 512, 96, 32, 16, 8, 8, 0, False),
    ("p256", 8, 256, 48, 256, 12, 8, 6, 0, True),
    ("n40", 9, 384, 80, 32, 40, 8, 8, 0, False),
    ("n40_limit23", 10, 384, 80, 32, 40, 8, 8, 23, True),
    ("n80_wide_bits", 11, 256, 64, 8, 80, 4, 8, 0, False),
    ("odd_p7_s3", 12, 200, 40, 7, 12, 3, 5, 0, True),
    ("records_in_global", 13, 96, 12, 256, 6, 64, 4, 0, False),
]
RULE_WORLD_STEPS = 3


def _rule_floats(rng, shape, special=0.35, scale=100.0):
    vals = rng.uniform(-scale, scale, shape).astype(np.float32)
    pick = rng.random(shape) < special
    vals[pick] = rng.choice(RULE_SPECIALS, int(pick.sum()))
    return vals


def adversarial_rule_world(seed, B, D, P, N, S, M, node_limit=0,
                           attach_over_d=False, steps=RULE_WORLD_STEPS):
    """A seeded rule-program world for `eval_rule_programs`, as numpy: the
    program table (every opcode, unknown opcodes and compare ops,
    out-of-range mm/lhs/rhs/root slots that clamp, children at lower and
    higher slots, NaN/inf/-0.0/denormal constants and alphas, iparams at
    the int32 ends and at the debounce cap), the state (value and aux bits
    from RULE_SPECIALS, ts at NEG, NEG+1 and INT32_MAX, counters at 0, 1,
    2^30 - 1, 2^30, INT32_MAX and INT32_MIN, flags not 0/1, generations
    that lag, match or lead the epochs, counters whose generation moved)
    and `steps` batches of device-sorted rows (device indices >= D that
    read row D-1, one attach row per ticking device, timestamps near NEG
    that wrap, NaN/denormal measurements). Between steps some programs'
    epochs move. With `attach_over_d`, one row of a device index >= D is an
    attach row (and device D-1 has none), so it ticks without writing."""
    rng = np.random.default_rng(seed)
    L = 4 * S + 2
    ops = np.arange(-1, 12)          # -1, 0 (NOP), 1..9, 10, 11 unknown
    weights = np.array([1, 3] + [6] * 9 + [1, 1], float)
    opcode = rng.choice(ops, (P, N), p=weights / weights.sum())
    lhs = np.empty((P, N), np.int64)
    rhs = np.empty((P, N), np.int64)
    for j in range(N):
        lo = rng.integers(0, max(j, 1), (P, 2))
        wild = rng.integers(-2, N + 3, (P, 2))
        pick = rng.random((P, 2)) < 0.15
        both = np.where(pick, wild, lo)
        lhs[:, j], rhs[:, j] = both[:, 0], both[:, 1]
    iparam_pool = np.array([-3, 0, 1, 2, 3, 5, 40, 500, 2 ** 30 - 1,
                            2 ** 30, _I32_MAX, _I32_MIN], np.int64)
    n_eff = min(N, node_limit) if node_limit else N
    table = {
        "active": rng.random(P) < 0.9,
        "tenant_idx": rng.choice([0, 0, 1, 2], P).astype(np.int32),
        "device_type_idx": rng.choice([0, 0, 0, 1, 2], P).astype(np.int32),
        "alert_level": rng.integers(-3, 16, P).astype(np.int32),
        "alert_type_idx": rng.integers(0, 9, P).astype(np.int32),
        "root": np.where(rng.random(P) < 0.8, rng.integers(
            max(n_eff - 4, 0), n_eff, P), rng.integers(-1, N + 2, P))
        .astype(np.int32),
        "epoch": rng.integers(1, 6, P).astype(np.int32),
        "opcode": opcode.astype(np.int32),
        "mm_idx": np.where(rng.random((P, N)) < 0.1,
                           rng.integers(-2, M + 3, (P, N)),
                           rng.integers(0, M, (P, N))).astype(np.int32),
        "lhs": lhs.astype(np.int32), "rhs": rhs.astype(np.int32),
        "cmp_op": rng.integers(0, 8, (P, N)).astype(np.int32),
        "fconst": _rule_floats(rng, (P, N)),
        "falpha": np.where(rng.random((P, N)) < 0.7,
                           rng.choice(np.array([0.3, 0.7, 0.05, 1.0, 0.0],
                                               np.float32), (P, N)),
                           _rule_floats(rng, (P, N), 0.6, 1.0))
        .astype(np.float32),
        "iparam": np.where(rng.random((P, N)) < 0.5,
                           rng.choice(iparam_pool, (P, N)),
                           rng.integers(-2, 6, (P, N))).astype(np.int32),
        "state_slot": rng.integers(0, S, (P, N)).astype(np.int32),
    }
    slab = np.empty((D, P, L), np.int32)
    slab[:, :, 0:2 * S] = _rule_floats(rng, (D, P, 2 * S), 0.5).view(np.int32)
    ts_pool = np.array([_I32_MIN, _I32_MIN + 1, _I32_MIN + 7, _I32_MAX,
                        _I32_MAX - 3, -5, 0, 990, 1000, 1010], np.int64)
    slab[:, :, 2 * S:3 * S] = rng.choice(ts_pool, (D, P, S))
    ctr_pool = np.array([0, 0, 1, 2, 3, 2 ** 30 - 1, 2 ** 30, _I32_MAX,
                         _I32_MIN, -1], np.int64)
    slab[:, :, 3 * S:4 * S] = rng.choice(ctr_pool, (D, P, S))
    slab[:, :, 4 * S] = rng.choice([0, 1, 1, 7, -1], (D, P))
    slab[:, :, 4 * S + 1] = table["epoch"][None, :] + rng.choice(
        [0, 0, 0, -1, 1, 100], (D, P))
    state = {"slab": slab,
             "gen": table["epoch"] + rng.choice([0, 0, 1], P).astype(
                 np.int32),
             "fire_count": rng.integers(0, 50, P).astype(np.int32),
             "suppress_count": rng.integers(0, 50, P).astype(np.int32)}

    batches = []
    for step in range(steps):
        devs, counts = [], []
        while sum(counts) < B:
            devs.append(int(rng.integers(0, D + 6)))
            counts.append(int(rng.integers(1, 5)))
        devs = np.asarray(devs)
        order = np.argsort(devs, kind="stable")
        dev = np.repeat(devs[order], np.asarray(counts)[order])[:B]
        attach = np.zeros(B, bool)
        uniq = np.unique(dev[dev < D])
        last = {d: np.nonzero(dev == d)[0][-1] for d in uniq}
        for d, row in last.items():
            attach[row] = rng.random() < 0.75
        if attach_over_d and (dev >= D).any():
            attach[dev == D - 1] = False
            attach[np.nonzero(dev >= D)[0][0]] = True
        base = int(rng.choice([1000, _I32_MIN + 20, _I32_MAX - 20]))
        now_d = (base + rng.integers(-15, 15, D + 6)).astype(np.int64)
        now_d[rng.random(D + 6) < 0.1] = _I32_MIN
        now_row = ((now_d[dev] + 2 ** 31) % 2 ** 32 - 2 ** 31)
        lmts = now_row[:, None] + rng.integers(-30, 30, (B, M))
        lmts[rng.random((B, M)) < 0.2] = _I32_MIN
        lmts = (lmts + 2 ** 31) % 2 ** 32 - 2 ** 31
        batches.append({
            "dev": dev.astype(np.int32), "attach": attach,
            "obs_row": rng.random((B, M)) < 0.6,
            "now_row": now_row.astype(np.int32),
            "lm_row": _rule_floats(rng, (B, M)),
            "lmts_row": lmts.astype(np.int32),
            "tenant_row": rng.integers(0, 3, B).astype(np.int32),
            "dtype_row": rng.integers(0, 3, B).astype(np.int32),
            "epoch": (table["epoch"] + step * (rng.random(P) < 0.2))
            .astype(np.int32)})
    return {"table": table, "state": state, "batches": batches,
            "node_limit": node_limit}


def rule_world_tensors(world, device, table_cls, state_cls):
    """A world's table (`table_cls`), state (`state_cls`) and batches as
    tensors on `device`; each batch's "epoch" is the table's epoch column
    for that step."""
    table = table_cls(**{k: torch.from_numpy(np.array(v)).to(device)
                         for k, v in world["table"].items()})
    state = state_cls(**{k: torch.from_numpy(np.array(v)).to(device)
                         for k, v in world["state"].items()})
    batches = [{k: torch.from_numpy(np.array(v)).to(device)
                for k, v in b.items()} for b in world["batches"]]
    return table, state, batches


# -- measurement helpers --------------------------------------------------------

def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz():
    """The card's highest SM clock in MHz (`nvidia-smi` clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return int(out.stdout.strip().splitlines()[0])


def time_cuda(fn, reps=TIMED_REPS, warmup=3):
    """Median ms of `fn()` over `reps` runs, each between two CUDA events:
    the call as a caller sees it, the host's launch latency included (the
    kernels' `ms`, comparable across versions of this script)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_cuda_queued(fn, reps=TIMED_REPS, warmup=3,
                     launches=QUEUED_LAUNCHES):
    """Median device ms of one `fn()` over `reps` samples. A sample is the
    CUDA-event interval around `launches` back-to-back calls, divided by
    their number; the card first spins (torch.cuda._sleep) while the host
    enqueues them, so the host's launch latency stays out of the interval
    (the kernels' `queued_ms`)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES_PER_LAUNCH * launches)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def geofence_bound_ms(B, Z, V, p_in):
    """(bound_ms, bound_by, bound_dense_ms): the least time of the work
    these inputs need, the larger of bytes over the HBM rate and f32
    operations over the f32 peak. Bytes: lat/lon read (8B), vertex tables
    (16VZ), bool output written (BZ). Operations: 2 compares for each of
    the B*Z pairs, and 8 f32 ops per edge (the JAX package's own cost
    estimate, ops/pallas_geofence.py) for the p_in pairs whose point lies
    in the zone's y-range. The dense bound counts 8 ops for every one of
    the B*Z*V edge tests."""
    bytes_ms = (8 * B + 16 * V * Z + B * Z) / H100_HBM_BYTES_S * 1e3
    ops_ms = (2.0 * B * Z + 8.0 * V * p_in) / H100_F32_FLOPS * 1e3
    dense_ms = max(bytes_ms, 8.0 * B * Z * V / H100_F32_FLOPS * 1e3)
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", dense_ms
    return bytes_ms, "bytes", dense_ms


# -- phases ---------------------------------------------------------------------

def phase_card():
    """The card line and name; builds every kernel; returns (card, name)."""
    from sitewhere_tpu_torch.ops import cuda_build

    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | device {name} x{torch.cuda.device_count()}")
    sources = ["geofence", "segsum", "rule_programs"]
    fresh = [s for s in sources if not cuda_build.library_path(s).exists()]
    t0 = time.perf_counter()
    cuda_build.build(sources)
    log(f"[card] kernels {fresh} built in parallel in "
        f"{time.perf_counter() - t0:.2f} s; {len(sources) - len(fresh)} "
        f"found built")
    for src in sources:
        for line in cuda_build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[card] ptxas {src}: {line.strip()}")
    return card, name


def phase_kernel_vs_plain(dev, card):
    """The geofence kernel bit for bit against the plain version on the
    adversarial fixture and on KERNEL_WORLDS; per world the share of
    (point, zone) pairs y-rejection drops, the kernel's CUDA-event medians
    per call (`kernel_ms`) and queued (`kernel_queued_ms`), the plain
    version's, and the bounds of geofence_bound_ms."""
    from sitewhere_tpu_torch.ops.geofence import (
        points_in_zones, zone_reject_mask)
    from sitewhere_tpu_torch.ops.geofence_kernel import (
        launch_plan, points_in_zones_kernel)

    results = []

    def mismatches(got, ref):
        diff = got.to(torch.int8) - ref.to(torch.int8)
        return int((diff != 0).sum()), \
            int(diff.abs().max()) if diff.numel() else 0

    def compare(lat, lon, verts):
        args = [torch.from_numpy(a).to(dev) for a in (lat, lon, verts)]
        got = points_in_zones_kernel(*args)
        ref = points_in_zones(*args)
        torch.cuda.synchronize()
        return (args, ref, *mismatches(got, ref))

    _, _, mism, err = compare(*adversarial_world())
    log(f"[kernel] adversarial fixture: mismatches={mism}")
    if mism:
        raise AssertionError(f"geofence kernel differs from plain on the "
                             f"adversarial fixture ({mism} cells)")
    for world, seed, Z, V, radius in KERNEL_WORLDS:
        lat, lon, verts = random_world(seed, BATCH, Z, V, box=LAT_LON_BOX,
                                       radius=radius)
        args, ref, mism, err = compare(lat, lon, verts)
        p_in = int((~zone_reject_mask(*args)).sum())
        row = {"world": world, "B": BATCH, "Z": Z, "V": V,
               "mismatches": mism, "max_abs_err": float(err), "P_in": p_in,
               "rejected_share": 1.0 - p_in / (BATCH * Z),
               "plan": launch_plan(BATCH, Z, V, dev.index)}
        row["kernel_ms"] = time_cuda(lambda: points_in_zones_kernel(*args))
        row["kernel_queued_ms"] = time_cuda_queued(
            lambda: points_in_zones_kernel(*args))
        row["plain_ms"] = time_cuda(lambda: points_in_zones(*args), reps=5)
        row["bound_ms"], row["bound_by"], row["bound_dense_ms"] = \
            geofence_bound_ms(BATCH, Z, V, p_in)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        log(f"[kernel] points_in_zones {json.dumps(row)} on {card}")
        if mism:
            raise AssertionError(f"geofence kernel differs from plain on "
                                 f"{world} ({mism} cells)")
        results.append(row)
    return results


def build_world(dev, geofence_impl, epoch_base_ms=None, *,
                max_devices=MAX_DEVICES, n_registered=N_REGISTERED,
                n_zones=N_ZONES, n_verts=N_VERTS, batch=BATCH, **engine_kw):
    """Phase 3's world (the sizes are keywords so the card tests can build
    it small): registry, zones, threshold and geofence rules, a started
    engine on `dev`."""
    from sitewhere_tpu_torch.model import AlertLevel
    from sitewhere_tpu_torch.pipeline import (
        GeofenceRule, PipelineEngine, ThresholdRule)
    from sitewhere_tpu_torch.registry import RegistryTensors

    rng = np.random.default_rng(SEED)
    reg = RegistryTensors(max_devices=max_devices, max_zones=n_zones,
                          max_zone_vertices=n_verts)
    reg.mirror_devices([f"dev-{i}" for i in range(1, n_registered + 1)],
                       tenant="tenant-1", device_type="sensor",
                       area="area-1")
    _, _, verts = random_world(SEED, 1, n_zones, n_verts, box=LAT_LON_BOX,
                               radius=ZONE_RADIUS)
    for z in range(n_zones):
        reg.mirror_zone(f"zone-{z}", "tenant-1",
                        [tuple(v) for v in verts[z]], area="area-1")
    engine = PipelineEngine(
        reg, batch_size=batch, measurement_slots=MEASUREMENT_SLOTS,
        max_tenants=MAX_TENANTS, max_threshold_rules=MAX_RULES,
        max_geofence_rules=MAX_RULES,
        presence_missing_interval_ms=PRESENCE_MS,
        geofence_impl=geofence_impl,
        device=dev, **engine_kw)
    engine.packer.epoch_base_ms = (
        epoch_base_ms if epoch_base_ms is not None
        else int(time.time() * 1000) - EPOCH_LAG_MS)
    engine.packer.measurements.intern("m1")
    for i in range(N_THRESHOLD):
        engine.add_threshold_rule(ThresholdRule(
            token=f"thr-{i}", measurement_name="m1", operator=">",
            threshold=95.0 + i, alert_level=AlertLevel.WARNING))
    zones = rng.permutation(n_zones)[:min(N_GEOFENCE, n_zones)]
    for g, z in enumerate(zones):
        engine.add_geofence_rule(GeofenceRule(
            token=f"fence-{g}", zone_token=f"zone-{z}",
            condition="inside" if g % 2 == 0 else "outside",
            alert_level=AlertLevel(g % 4)))
    engine.start()
    return engine


def _alert_keys(alerts):
    return [(a.device_id, int(a.source), int(a.level), a.type, a.message,
             a.event_date) for a in alerts]


def run_trace(engine, batches, twin=None):
    """submit + materialize_alerts over `batches`; per-step wall seconds
    (each ends in the lanes' host copy, which waits for the card) and the
    materialized alert keys. With an EagerTwin of the engine, each step's
    outputs are held against the twin's step (outside the walls)."""
    walls, alerts = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        out = engine.submit(batch)
        got = engine.materialize_alerts(batch, out)
        walls.append(time.perf_counter() - t0)
        alerts.append(_alert_keys(got))
        if twin is not None:
            assert_tree_bits_equal(twin.step(batch), out, f"step {i}")
    return walls, alerts


def flight_stage_ms(engine, steps):
    """Mean ms per stage over the engine's last `steps` flight records,
    and the mean sum of stages per step (the engine's own attribution of
    its host time)."""
    records = engine.flight.export(last_n=steps)["records"]
    totals = {}
    for rec in records:
        for stage, seg in rec["stages"].items():
            totals[stage] = totals.get(stage, 0.0) + seg["ms"]
    out = {k: v / len(records) for k, v in totals.items()}
    out["sum_of_stages"] = sum(r["sum_ms"] for r in records) / len(records)
    return out


def reset_launch_counts(*engines):
    """Set every count of kernel launches to 0: the wrappers' own (eager
    launches) and the engines' (launches made by replays of captured
    steps)."""
    from sitewhere_tpu_torch.pipeline.graph import STEP_KERNELS

    for wrapper in STEP_KERNELS.values():
        wrapper.launches = 0
    for engine in engines:
        engine.graph_kernel_launches.clear()


def launch_counts(*engines):
    """Kernel name -> launches since reset_launch_counts: the wrapper's
    eager launches plus every replay's, counted per replay."""
    from sitewhere_tpu_torch.pipeline.graph import STEP_KERNELS

    return {name: wrapper.launches + sum(
                e.graph_kernel_launches.get(name, 0) for e in engines)
            for name, wrapper in STEP_KERNELS.items()}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_tree_bits_equal(a, b, what):
    """Raise unless two dataclass trees hold the same tensors (f32 as bit
    patterns)."""
    from sitewhere_tpu_torch.tree import tree_leaves

    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if hasattr(x, "__dataclass_fields__"):
            assert_tree_bits_equal(x, y, f"{what}.{f}")
        elif not torch.equal(_bits(x), _bits(y.to(x.device))):
            raise AssertionError(f"{what}.{f} differs")
    assert len(tree_leaves(a)) == len(tree_leaves(b))


class EagerTwin:
    """The engine's step run eagerly, op by op, with `process_batch` on
    copies of the engine's params and state groups taken at construction:
    the reference its captured step is held to on the card."""

    def __init__(self, engine):
        from sitewhere_tpu_torch.tree import tree_map

        self.engine = engine
        clone = lambda group: tree_map(torch.clone, group)  # noqa: E731
        self.params = clone(engine._ensure_params())
        self.groups = [clone(g) for g in (
            engine._state, engine._rule_state, engine._model_state,
            engine._actuation_state)]

    def step(self, batch):
        from sitewhere_tpu_torch.ops.pack import batch_to_blob, blob_to_batch
        from sitewhere_tpu_torch.pipeline.step import process_batch

        eng = self.engine
        blob = torch.from_numpy(batch_to_blob(batch)).to(eng.device)
        *self.groups, out = process_batch(
            self.params, *self.groups, blob_to_batch(blob),
            geofence_impl=eng.geofence_impl,
            alert_lane_capacity=eng.alert_lane_capacity,
            command_lane_capacity=eng.command_lane_capacity,
            **eng._step_flags)
        return out

    def assert_state_equal(self, engine):
        for mine, theirs, name in zip(self.groups, (
                engine._state, engine._rule_state, engine._model_state,
                engine._actuation_state),
                ("state", "rule", "model", "actuation")):
            assert_tree_bits_equal(mine, theirs, name)


def phase_main_path(dev, card):
    from sitewhere_tpu_torch.runtime.flight import FlightRecorder

    t0 = time.perf_counter()
    engine = build_world(dev, "auto")
    engine.flight = FlightRecorder(capacity=64)
    batches = [synthetic_batch(engine.packer, N_REGISTERED, BATCH, SEED + s)
               for s in range(WARMUP + STEPS)]
    log(f"[main] world + {len(batches)} batches built in "
        f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(engine)
    walls, alerts = run_trace(engine, batches)
    state_before_sweep = engine.canonical_state()
    t_sweep = time.perf_counter()
    missing = engine.presence_sweep()
    sweep_s = time.perf_counter() - t_sweep
    launches = launch_counts(engine)
    peak = torch.cuda.max_memory_allocated()
    if launches["points_in_zones"] != len(batches):
        raise AssertionError(f"geofence kernel launched "
                             f"{launches['points_in_zones']} times over "
                             f"{len(batches)} steps; expected one per step")
    if engine.graph_captures != 1:
        raise AssertionError(f"{engine.graph_captures} captures of one "
                             f"static configuration")

    timed = walls[WARMUP:]
    events = BATCH * STEPS
    stats = engine.stats()
    summary = {
        "events_per_s": events / sum(timed),
        "step_ms_p50": float(np.percentile(timed, 50) * 1e3),
        "step_ms_p99": float(np.percentile(timed, 99) * 1e3),
        "steps": STEPS, "batch": BATCH,
        "alerts_materialized": sum(len(a) for a in alerts[WARMUP:]),
        "alerts_dropped": engine.alerts_dropped,
        "tenant_events": stats["tenant_event_count"][1],
        "presence_missing": len(missing), "presence_sweep_ms": sweep_s * 1e3,
        "max_memory_allocated_bytes": peak,
        "kernel_launches": launches["points_in_zones"],
        "graph_captures": engine.graph_captures,
    }
    log(f"[main] {json.dumps(summary)} on {card}")
    log(f"[main] flight, mean ms per timed step: "
        f"{json.dumps(flight_stage_ms(engine, STEPS))} on {card}")
    if stats["tenant_event_count"][1] != BATCH * len(batches):
        raise AssertionError(f"tenant event count {stats} != "
                             f"{BATCH * len(batches)}")
    if not missing or summary["alerts_materialized"] == 0:
        raise AssertionError("main path fired no alerts or no presence "
                             "transition")

    # the captured step against the same step run op by op on the card,
    # in lockstep on a second engine of the same world
    graphed = build_world(dev, "auto", engine.packer.epoch_base_ms)
    twin = EagerTwin(graphed)
    _, twin_alerts = run_trace(graphed, batches, twin)
    twin.assert_state_equal(graphed)
    if twin_alerts != alerts or graphed.graph_captures != 1:
        raise AssertionError("a second graph engine differs from the first")
    del twin, graphed
    log(f"[main] graph engine vs eager process_batch on the card: "
        f"identical outputs and lanes over {len(batches)} steps "
        f"(1 eager + {len(batches) - 1} replays) and identical state")

    plain = build_world(dev, "plain", engine.packer.epoch_base_ms)
    _, plain_alerts = run_trace(plain, batches)
    plain_state = plain.canonical_state()
    plain_missing = plain.presence_sweep()
    if plain_alerts != alerts:
        bad = next(i for i, (a, b) in enumerate(zip(alerts, plain_alerts))
                   if a != b)
        raise AssertionError(f"kernel and plain engines materialized "
                             f"different alerts at step {bad}")
    # the sweep stamps each engine's own wall clock into
    # presence_missing_since, so the state is compared before the sweeps
    # and the sweeps by their transitions and presence bits
    assert_tree_bits_equal(state_before_sweep, plain_state,
                           "canonical state")
    if plain_missing != missing or not torch.equal(
            engine.state.present, plain.state.present):
        raise AssertionError("presence transitions differ")
    log(f"[main] plain-geofence engine: identical alerts "
        f"({summary['alerts_materialized']} timed), canonical state and "
        f"presence transitions ({len(missing)})")
    return engine, batches, summary, launches, alerts, state_before_sweep


def phase_breakdown(engine, batches, card, reps=10):
    """Where one step's time goes, three ways:
      - host split of engine steps (host clock): submit() until it returns
        (pack, H2D, enqueue of every op), the wait for the card after it,
        and materialize_alerts after the card is done;
      - device spans of the step's stages (CUDA events between the stage
        functions of pipeline/step.py, run one after the other; a span
        includes any wait of the card for the host's launches);
      - the profiler over engine steps: device busy time (kernels and
        copies) against the wall, and the ops that take the device time."""
    from sitewhere_tpu_torch.ops.compact import compact_alert_lanes
    from sitewhere_tpu_torch.ops.geofence import eval_geofence_rules
    from sitewhere_tpu_torch.ops.pack import batch_to_blob, blob_to_batch
    from sitewhere_tpu_torch.ops.segments import count_by_key
    from sitewhere_tpu_torch.ops.threshold import eval_threshold_rules
    from sitewhere_tpu_torch.pipeline.step import (
        _placeholders, fold_device_state, validate_batch)

    host = {"submit": [], "wait_for_card": [], "materialize": []}
    for i in range(reps):
        batch = batches[i % len(batches)]
        t0 = time.perf_counter()
        out = engine.submit(batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        engine.materialize_alerts(batch, out)
        t3 = time.perf_counter()
        for key, dt in (("submit", t1 - t0), ("wait_for_card", t2 - t1),
                        ("materialize", t3 - t2)):
            host[key].append(dt * 1e3)
    host_ms = {k: statistics.median(v) for k, v in host.items()}
    log(f"[breakdown] engine step host split, ms (median of {reps}): "
        f"{json.dumps(host_ms)} on {card}")

    params, state = engine._ensure_params(), engine.state
    names = ("h2d", "unpack", "rules", "geofence", "fold", "compact",
             "fetch")
    samples = {n: [] for n in names}
    pack_ms = []
    batch = batches[-1]
    for _ in range(reps + 2):
        t0 = time.perf_counter()
        blob_np = batch_to_blob(batch)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        blob = torch.from_numpy(blob_np).to(engine.device)
        ev[1].record()
        b = blob_to_batch(blob)
        ev[2].record()
        b, dtype, _ = validate_batch(params, b, state.num_devices)
        thr = eval_threshold_rules(b, params.threshold, dtype)
        ev[3].record()
        geo = eval_geofence_rules(b, params.zones, params.geofence)
        ev[4].record()
        fold_device_state(state, b)
        ev[5].record()
        prog, model = _placeholders(b.valid.shape[0], b.valid.device)
        count_by_key(b.tenant_idx, b.valid, MAX_TENANTS)
        lanes = compact_alert_lanes(thr, geo, engine.alert_lane_capacity,
                                    prog, model)
        ev[6].record()
        lanes.cpu()
        ev[7].record()
        ev[7].synchronize()
        for i, n in enumerate(names):
            samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    spans = {n: statistics.median(v[2:]) for n, v in samples.items()}
    spans["host_pack"] = statistics.median(pack_ms[2:])
    log(f"[breakdown] stage spans, ms (median of {reps}): "
        f"{json.dumps(spans)} on {card}")

    prof_out = profile_engine(engine, batches)
    log(f"[breakdown] profiler: {json.dumps(prof_out)} on {card}")
    return host_ms, spans, prof_out


def profile_engine(engine, batches, n_prof=5):
    """The profiler over `n_prof` engine steps (submit + materialize): the
    device's busy time against the wall, its idle share, the device events
    (kernels, copies, memsets) launched, and the ops that take the device
    time, per step. Busy time sums the device events once each. The
    profiler also books each kernel's time under the op that launched it,
    so a sum over all events counts it twice; earlier versions of this
    script reported that sum as busy time, and it is printed beside as
    `all_events_sum_ms_per_step` for comparison with their records. Under
    the captured step the launching op is the graph replay, so the device
    kernels are also listed by their own names, and the geofence kernel's
    device events are counted (`b1_device_events_per_step`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[:n_prof]:
            engine.materialize_alerts(batch, engine.submit(batch))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    engine.take_command_fires()
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_device)
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    kernels = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "steps": n_prof, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": (device_us / 1e3 / n_prof
                                    if device_us else "not measured"),
        "device_idle_share": (1 - device_us / 1e3 / n_prof / wall_ms
                              if device_us else "not measured"),
        "device_events_per_step": sum(e.count for e in on_device) / n_prof,
        "all_events_sum_ms_per_step": sum(
            e.self_device_time_total for e in events) / 1e3 / n_prof,
        "top_device_ops_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / n_prof
            for e in top if e.self_device_time_total},
        "top_device_kernels_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / n_prof
            for e in kernels if e.self_device_time_total},
        "b1_device_events_per_step": sum(
            e.count for e in on_device
            if "points_in_zones" in e.key) / n_prof,
    }


# -- phase 5: the stateful stages ------------------------------------------------

# the bench tier's programs (bench.py), then programs that between them run
# every other ProgramOp; each fires only now and then on this traffic
STATEFUL_PROGRAMS = [
    {"token": "bench-composite", "alert_level": "WARNING",
     "when": {"all": [
         {"pred": "value", "measurement": "m1", "op": ">", "value": 98.0},
         {"debounce": {"pred": "value", "measurement": "m1", "op": ">",
                       "value": 60.0}, "count": 3}]}},
    {"token": "bench-hyst", "alert_level": "ERROR",
     "when": {"hysteresis": {
         "arm": {"pred": "value", "measurement": "m1", "op": ">",
                 "value": 99.5},
         "disarm": {"pred": "value", "measurement": "m1", "op": "<",
                    "value": 5.0}}}},
    {"token": "ewma-hot", "alert_level": "WARNING",
     "when": {"pred": "ewma", "measurement": "m1", "op": ">", "value": 85.0,
              "alpha": 0.2}},
    {"token": "rate-spike", "alert_level": "ERROR",
     "when": {"pred": "rate", "measurement": "m2", "op": ">",
              "value": 300.0}},
    {"token": "hot-and-dry", "alert_level": "CRITICAL",
     "when": {"for_duration": {"all": [
         {"pred": "value", "measurement": "m1", "op": ">", "value": 90.0},
         {"pred": "value", "measurement": "m2", "op": "<", "value": 10.0}]},
         "ms": 500}},
    {"token": "edge-band", "alert_level": "INFO",
     "when": {"all": [
         {"not": {"pred": "value", "measurement": "m1", "op": ">=",
                  "value": 2.0}},
         {"any": [
             {"pred": "value", "measurement": "m2", "op": ">",
              "value": 99.0},
             {"pred": "value", "measurement": "m2", "op": "<",
              "value": 1.0}]}]}},
]
# bench.py's two models, and an autoencoder over a value and a rate feature
STATEFUL_MODELS = [
    {"token": "bench-hot", "kind": "mlp", "threshold": 0.5,
     "alert_level": "WARNING", "alert_type": "anomaly.bench.hot",
     "features": [{"feature": "value", "measurement": "m1",
                   "mean": 50.0, "std": 25.0}],
     "layers": [{"weights": [[1.0]], "bias": [0.0]}],
     "output": {"weights": [40.0], "bias": -38.3}},
    {"token": "bench-drift", "kind": "mlp", "threshold": 0.5,
     "alert_level": "ERROR", "alert_type": "anomaly.bench.drift",
     "features": [{"feature": "ewma", "measurement": "m1",
                   "alpha": 0.1, "mean": 50.0, "std": 25.0}],
     "layers": [{"weights": [[1.0]], "bias": [0.0]}],
     "output": {"weights": [40.0], "bias": -38.3}},
    {"token": "ae-m2", "kind": "autoencoder", "threshold": 2.5,
     "alert_level": "CRITICAL", "alert_type": "anomaly.ae",
     "features": [{"feature": "value", "measurement": "m2",
                   "mean": 50.0, "std": 30.0},
                  {"feature": "rate", "measurement": "m1",
                   "mean": 0.0, "std": 100.0}],
     "layers": [{"weights": [[0.7, 0.2], [-0.3, 0.9], [0.5, 0.5]],
                 "bias": [0.0, 0.1, -0.1]},
                {"weights": [[0.9, -0.2, 0.3], [0.1, 0.8, -0.4]],
                 "bias": [0.05, -0.05]}]},
]
# bench.py's policy (threshold fires, no debounce), and one on program
# fires with a debounce window
STATEFUL_POLICIES = [
    {"token": "bench-act", "source": "threshold", "min_level": "WARNING",
     "debounce_ms": 0, "command": "bench-cmd", "params": []},
    {"token": "on-program", "source": "program", "min_level": "INFO",
     "debounce_ms": 20000, "command": "inspect", "params": [1, 2]},
]


def build_stateful_world(dev, epoch_base_ms=None, **world_kw):
    """Phase 3's world with the stateful families installed; the engine's
    stateful buckets are its defaults, the JAX engine's."""
    engine = build_world(dev, "auto", epoch_base_ms, **world_kw)
    engine.packer.measurements.intern("m2")
    for spec in STATEFUL_PROGRAMS:
        engine.upsert_rule_program(dict(spec))
    for spec in STATEFUL_MODELS:
        engine.upsert_anomaly_model(dict(spec))
    for spec in STATEFUL_POLICIES:
        engine.upsert_actuation_policy(dict(spec))
    engine._ensure_params()   # the installed families compiled now
    return engine


def stateful_snapshot(engine):
    """Every state group (CPU copies) and every per-family counter."""
    return {"state": engine.canonical_state(),
            "rule": engine.canonical_rule_state(),
            "model": engine.canonical_model_state(),
            "actuation": engine.canonical_actuation_state(),
            "counters": (engine.rule_program_counters(),
                         engine.anomaly_model_counters(),
                         engine.actuation_policy_counters())}


class PlainRuleTwin(EagerTwin):
    """The engine's step run eagerly on copies of its groups (EagerTwin),
    with the rule-program stage's plain torch version in place of its
    kernel: after each engine step, `check` holds the engine's rule state
    (every slab lane, the generation, both counters) and the step's program
    outputs to the twin's, bit for bit. The twin's own geofence launches
    are not the main path's: `check` leaves every launch count as it found
    it."""

    def check(self, engine, batch, out):
        import sitewhere_tpu_torch.pipeline.step as step_mod
        from sitewhere_tpu_torch.ops.stateful import eval_rule_programs_plain
        from sitewhere_tpu_torch.pipeline.graph import STEP_KERNELS

        counts = {n: w.launches for n, w in STEP_KERNELS.items()}
        kernel = step_mod.eval_rule_programs
        step_mod.eval_rule_programs = eval_rule_programs_plain
        try:
            ref = self.step(batch)
        finally:
            step_mod.eval_rule_programs = kernel
            for n, w in STEP_KERNELS.items():
                w.launches = counts[n]
        bad = {name: int((_bits(getattr(ref, name))
                          != _bits(getattr(out, name))).sum())
               for name in ("program_fired", "program_first_rule",
                            "program_alert_level")}
        mine, theirs = self.groups[1], engine._rule_state
        for name in ("slab", "gen", "fire_count", "suppress_count"):
            bad[name] = int((getattr(mine, name)
                             != getattr(theirs, name)).sum())
        fired = int(ref.program_fired.sum())
        return bad, fired


def run_stateful_trace(engine, batches, n_check, rule_twin=None):
    """submit + materialize_alerts + take_command_fires over `batches`.
    Returns per-step walls and materialized-alert counts, then for the
    first `n_check` steps the alert keys, command fires and per-row anomaly
    scores, the snapshot after step `n_check`, and the per-family
    fired-row counts of all steps (on the device, summed after each step's
    wall). With `rule_twin` (a PlainRuleTwin of the engine as it was before
    the first batch), each step is then held against the twin outside its
    wall, the card idle again before the next step; the mismatches per
    step come last."""
    walls, counts, alerts, fires, scores, snap = [], [], [], [], [], None
    checks = []
    families = torch.zeros(4, dtype=torch.int64, device=engine.device)
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        out = engine.submit(batch)
        got = engine.materialize_alerts(batch, out)
        fired = engine.take_command_fires()
        walls.append(time.perf_counter() - t0)
        if rule_twin is not None:
            checks.append(rule_twin.check(engine, batch, out))
            torch.cuda.synchronize()
        counts.append(len(got))
        families += torch.stack([out.threshold_fired.sum(),
                                 out.geofence_fired.sum(),
                                 out.program_fired.sum(),
                                 out.model_fired.sum()])
        if i < n_check:
            alerts.append(_alert_keys(got))
            fires.append(fired)
            scores.append(out.model_score.cpu())
        if i + 1 == n_check:
            snap = stateful_snapshot(engine)
    return (walls, counts, alerts, fires, scores, snap,
            families.cpu().tolist(), checks)


def compare_snapshots(card, cpu):
    """Raise unless two stateful snapshots are identical (f32 as bit
    patterns)."""
    for group in ("state", "rule", "model", "actuation"):
        a, b = card[group], cpu[group]
        for name in a.__dataclass_fields__:
            if not torch.equal(_bits(getattr(a, name)),
                               _bits(getattr(b, name))):
                raise AssertionError(f"card and CPU engines differ in "
                                     f"{group} state field {name}")
    if card["counters"] != cpu["counters"]:
        raise AssertionError(f"card and CPU counters differ: "
                             f"{card['counters']} != {cpu['counters']}")


def stateful_spans(engine, batch, card, reps=10):
    """CUDA-event spans of one step's stages on the stateful path: stages
    1-3 (unpack, validate, rules, geofence, fold), the shared sorted row
    view, 3b rule programs, 3c anomaly models, 3d actuation, 4 lanes. The
    stages run one after the other on copies of the engine's state groups
    (they update slabs in place), so a span includes any wait of the card
    for the host's launches."""
    from sitewhere_tpu_torch.ops.actuate import eval_actuation_policies
    from sitewhere_tpu_torch.ops.anomaly import eval_anomaly_models
    from sitewhere_tpu_torch.ops.compact import compact_alert_lanes
    from sitewhere_tpu_torch.ops.geofence import eval_geofence_rules
    from sitewhere_tpu_torch.ops.pack import batch_to_blob, blob_to_batch
    from sitewhere_tpu_torch.ops.stateful import eval_rule_programs
    from sitewhere_tpu_torch.ops.threshold import eval_threshold_rules
    from sitewhere_tpu_torch.pipeline.step import (
        fold_device_state, stateful_rows, validate_batch)
    from sitewhere_tpu_torch.tree import tree_map

    params, state = engine._ensure_params(), engine.state
    node_limit = engine._step_flags["program_node_limit"]
    rs, ms, acts = (tree_map(torch.clone, g) for g in (
        engine._rule_state, engine._model_state, engine._actuation_state))
    blob = torch.from_numpy(batch_to_blob(batch)).to(engine.device)
    names = ("stages_1_3", "sorted_rows", "3b_programs", "3c_models",
             "3d_actuation", "4_lanes")
    samples = {n: [] for n in names}
    for _ in range(reps + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        b, dtype, _ = validate_batch(params, blob_to_batch(blob),
                                     state.num_devices)
        thr = eval_threshold_rules(b, params.threshold, dtype)
        geo = eval_geofence_rules(b, params.zones, params.geofence)
        folded = fold_device_state(state, b)
        ev[1].record()
        rows, now_row, inv = stateful_rows(params, folded, b)
        ev[2].record()
        rs, prog = eval_rule_programs(params.programs, rs, now_row=now_row,
                                      node_limit=node_limit, **rows)
        prog = {k: v[inv] for k, v in prog.items()}
        ev[3].record()
        ms, model = eval_anomaly_models(params.models, ms, **rows)
        model = {k: v[inv] for k, v in model.items()}
        ev[4].record()
        acts, _ = eval_actuation_policies(
            params.policies, acts, dev=b.device_idx, ts=b.ts,
            tenant_row=b.tenant_idx, thr=thr, geo=geo, prog=prog,
            model=model, capacity=engine.command_lane_capacity)
        ev[5].record()
        compact_alert_lanes(thr, geo, engine.alert_lane_capacity, prog,
                            model)
        ev[6].record()
        ev[6].synchronize()
        for i, n in enumerate(names):
            samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    spans = {n: statistics.median(v[2:]) for n, v in samples.items()}
    log(f"[stateful] stage spans, ms (median of {reps}): "
        f"{json.dumps(spans)} on {card}")
    return spans


def rule_step_rows(engine, batch):
    """The rule-program stage's inputs at one step of `engine` on `batch`
    (its current params and device state), as the step computes them:
    (table, row keywords with now_row, node_limit)."""
    from sitewhere_tpu_torch.ops.pack import batch_to_blob, blob_to_batch
    from sitewhere_tpu_torch.pipeline.step import (
        fold_device_state, stateful_rows, validate_batch)

    params, state = engine._ensure_params(), engine.state
    blob = torch.from_numpy(batch_to_blob(batch)).to(engine.device)
    b, _, _ = validate_batch(params, blob_to_batch(blob), state.num_devices)
    rows, now_row, _ = stateful_rows(params, fold_device_state(state, b), b)
    return (params.programs, dict(rows, now_row=now_row),
            engine._step_flags["program_node_limit"])


def rule_bound_ms(table, rows, node_limit, S):
    """(bound_ms, bound_by, bytes, operations, attach rows): the least time
    of the rule-program pass on these rows. Bytes: every row's attach flag
    (1 B) and outputs (9 B); each attach row's device index, newest ts,
    tenant and type (16 B), its P records read and written once
    (2 * P * (4S+2) * 4 B) and, for each measurement slot the table's
    VALUE/EWMA/RATE nodes read, its value, ts and observed flag (9 B); the
    table once. Operations: RULE_NODE_OPS for each (attach row, program,
    node slot in use), at the f32 peak."""
    B = rows["dev"].shape[0]
    P, N = table.num_programs, table.num_nodes
    n_eff = min(N, node_limit) if node_limit else N
    attach = int(rows["attach"].sum())
    ops = table.opcode[:, :n_eff]
    reads_m = (ops >= 1) & (ops <= 3)
    m_used = int(torch.unique(table.mm_idx[:, :n_eff][reads_m]).numel())
    moved = (B * 10 + attach * (16 + 2 * P * (4 * S + 2) * 4 + m_used * 9)
             + P * n_eff * 9 * 4 + P * 6 * 4)
    operations = RULE_NODE_OPS * attach * P * n_eff
    bytes_ms = moved / H100_HBM_BYTES_S * 1e3
    ops_ms = operations / H100_F32_FLOPS * 1e3
    if ops_ms > bytes_ms:
        return ops_ms, "operations", moved, operations, attach
    return bytes_ms, "bytes", moved, operations, attach


def rule_worlds_on_the_card(dev):
    """The kernel against the plain version on the card on RULE_WORLDS
    (RULE_WORLD_STEPS steps each): mismatching elements per world over
    every slab lane, the generation, both counters and the row outputs."""
    from sitewhere_tpu_torch.ops.stateful import (
        RuleStateTensors, eval_rule_programs, eval_rule_programs_plain)
    from sitewhere_tpu_torch.rules.compiler import RuleProgramTable

    out = {}
    for name, seed, B, D, P, N, S, M, limit, over in RULE_WORLDS:
        world = adversarial_rule_world(seed, B, D, P, N, S, M,
                                       node_limit=limit, attach_over_d=over)
        runs = []
        for fn in (eval_rule_programs, eval_rule_programs_plain):
            table, state, steps = rule_world_tensors(
                world, dev, RuleProgramTable, RuleStateTensors)
            trace = []
            for rows in steps:
                rows = dict(rows)
                table = dataclasses.replace(table, epoch=rows.pop("epoch"))
                state, res = fn(table, state, node_limit=limit, **rows)
                trace.append([_bits(state.slab).clone(), state.gen,
                              state.fire_count, state.suppress_count,
                              res["fired"], res["first_rule"],
                              res["alert_level"]])
            runs.append(trace)
        out[name] = sum(int((a != b).sum())
                        for ka, kb in zip(*runs) for a, b in zip(ka, kb))
    return out


def rule_kernel_vs_plain(dev, engine, batches, card):
    """The rule-program kernel on the card: (i) a fresh engine over phase
    5's batches beside a PlainRuleTwin, every step's rule state and
    program outputs bit-equal; (ii) the adversarial RULE_WORLDS, kernel
    against plain; (iii) the kernel alone at the last batch's rows of the
    timed engine, timed between CUDA events (a call, and queued), beside
    its plain version and the bound of these rows' attach records."""
    from sitewhere_tpu_torch.ops import cuda_build
    from sitewhere_tpu_torch.ops.stateful import (
        eval_rule_programs, eval_rule_programs_plain, rule_programs_plan)
    from sitewhere_tpu_torch.tree import tree_map

    t0 = time.perf_counter()
    checked = build_stateful_world(dev, engine.packer.epoch_base_ms)
    twin = PlainRuleTwin(checked)
    reset_launch_counts(checked)
    checks = run_stateful_trace(checked, batches, 0, rule_twin=twin)[-1]
    step_bad = {k: sum(c[0][k] for c in checks) for k in checks[0][0]}
    fired = sum(c[1] for c in checks)
    path = launch_counts(checked)["eval_rule_programs"]
    del twin, checked
    worlds = rule_worlds_on_the_card(dev)
    mismatches = sum(step_bad.values()) + sum(worlds.values())
    if mismatches or not fired or path != len(batches):
        raise AssertionError(f"rule-program kernel != its plain version: "
                             f"per field over {len(batches)} steps "
                             f"{step_bad} (program fires {fired}, launches "
                             f"{path}); worlds {worlds}")

    table, rows, limit = rule_step_rows(engine, batches[-1])
    S = engine._rule_state.num_state_slots
    rs = tree_map(torch.clone, engine._rule_state)
    call = lambda fn: fn(table, rs, node_limit=limit, **rows)  # noqa: E731
    bound_ms, bound_by, moved, operations, attach = rule_bound_ms(
        table, rows, limit, S)
    B, P = rows["dev"].shape[0], table.num_programs
    n_eff = min(table.num_nodes, limit) if limit else table.num_nodes
    res = {
        "rows": B, "attach_rows": attach, "programs": P, "nodes": n_eff,
        "state_slots": S, "mismatches": mismatches, "max_abs_err": 0.0,
        "steps_checked": len(batches), "program_fires_checked": fired,
        "step_mismatches": step_bad, "world_mismatches": worlds,
        "ms": time_cuda(lambda: call(eval_rule_programs)),
        "queued_ms": time_cuda_queued(lambda: call(eval_rule_programs)),
        "plain_ms": time_cuda(lambda: call(eval_rule_programs_plain),
                              reps=5),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
        "operations": operations, "library_ms": None,
        "plan": rule_programs_plan(B, P, n_eff, S, dev.index or 0),
        "ptxas": [line.strip() for line in
                  cuda_build.build_log("rule_programs").splitlines()
                  if "registers" in line or "spill" in line],
        "seconds": time.perf_counter() - t0}
    log(f"[stateful] rule-program kernel: {json.dumps(res)} on {card}")
    return res


def phase_stateful(dev, card, main_summary):
    t_phase = time.perf_counter()
    engine = build_stateful_world(dev)
    batches = [synthetic_batch(engine.packer, N_REGISTERED, BATCH,
                               SEED + 500 + s, mm_slots=(1, 2),
                               t_off_ms=1000 * s)
               for s in range(WARMUP + STEPS)]
    log(f"[stateful] world + {len(batches)} batches built in "
        f"{time.perf_counter() - t_phase:.2f} s; programs "
        f"{len(STATEFUL_PROGRAMS)}, models {len(STATEFUL_MODELS)}, "
        f"policies {len(STATEFUL_POLICIES)}; program node slots in use "
        f"{engine._program_nodes_in_use}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(engine)
    walls, counts, alerts, fires, scores, snap, families, _ = \
        run_stateful_trace(engine, batches, STATEFUL_CPU_STEPS)
    path_launches = launch_counts(engine)
    launches = path_launches["points_in_zones"]
    peak = torch.cuda.max_memory_allocated()
    for name, n in path_launches.items():
        if n != len(batches):
            raise AssertionError(f"kernel {name} launched {n} times over "
                                 f"{len(batches)} stateful steps; expected "
                                 f"one per step")
    if engine.graph_captures != 1:
        raise AssertionError(f"{engine.graph_captures} captures of one "
                             f"static configuration")
    timed = walls[WARMUP:]
    counters = {"programs": engine.rule_program_counters(),
                "models": engine.anomaly_model_counters(),
                "policies": engine.actuation_policy_counters()}
    summary = {
        "events_per_s": BATCH * STEPS / sum(timed),
        "step_ms_p50": float(np.percentile(timed, 50) * 1e3),
        "step_ms_p99": float(np.percentile(timed, 99) * 1e3),
        "marginal_step_ms_p50_vs_main": float(
            np.percentile(timed, 50) * 1e3 - main_summary["step_ms_p50"]),
        "steps": STEPS, "batch": BATCH,
        "max_memory_allocated_bytes": peak,
        "fired_rows_by_family": dict(zip(
            ("threshold", "geofence", "program", "model"), families)),
        "alerts_materialized": sum(counts[WARMUP:]),
        "alerts_dropped": engine.alerts_dropped,
        "commands_fired": engine.commands_fired,
        "commands_debounced": engine.commands_debounced,
        "commands_dropped": engine.commands_dropped,
        "kernel_launches": launches,
        "rule_kernel_launches": path_launches["eval_rule_programs"],
        "graph_captures": engine.graph_captures,
    }
    log(f"[stateful] {json.dumps(summary)} on {card}")
    log(f"[stateful] counters {json.dumps(counters)}")
    if not (families[2] and families[3] and engine.commands_fired):
        raise AssertionError("stateful path fired no program or model "
                             "alert, or no command")

    t_cpu = time.perf_counter()
    cpu = build_stateful_world(torch.device("cpu"),
                               engine.packer.epoch_base_ms)
    _, _, c_alerts, c_fires, c_scores, c_snap, _, _ = run_stateful_trace(
        cpu, batches[:STATEFUL_CPU_STEPS], STATEFUL_CPU_STEPS)
    cpu_s = time.perf_counter() - t_cpu
    if c_alerts != alerts:
        raise AssertionError("card and CPU engines materialized different "
                             "alerts")
    if c_fires != fires:
        raise AssertionError("card and CPU engines fired different "
                             "commands")
    compare_snapshots(snap, c_snap)
    worst = 0.0
    for got, ref in zip(scores, c_scores):
        torch.testing.assert_close(got, ref, rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)
        worst = max(worst, float((got - ref).abs().max()))
    log(f"[stateful] card vs CPU engine over {STATEFUL_CPU_STEPS} steps: "
        f"identical alerts ({sum(len(a) for a in alerts)}), command fires "
        f"({sum(len(f) for f in fires)}), state groups and counters; "
        f"anomaly scores max |diff| {worst:.3g}; CPU run {cpu_s:.1f} s")
    del cpu

    summary["rule_kernel"] = rule_kernel_vs_plain(dev, engine, batches, card)
    spans = stateful_spans(engine, batches[-1], card)
    prof = profile_engine(engine, batches)
    log(f"[stateful] profiler: {json.dumps(prof)} on {card}")
    log(f"[stateful] phase took {time.perf_counter() - t_phase:.1f} s")
    reference = {"batches": batches, "alerts": alerts, "fires": fires,
                 "snapshot": snap, "epoch_base_ms": engine.packer.epoch_base_ms}
    return summary, launches, prof, reference


# -- phase 6: the host runtime (pipelined feeder, staging ring, drill) ---------

# h2d_error, dispatch_error and lane_fetch_error each fire twice in a row
# (a retry loop has three attempts, so each is absorbed) in the serial half
# of the run, and a third time in the pipelined half
DRILL_PLAN = {"seed": SEED, "rules": [
    {"point": "h2d_error", "times": 2, "after": 2},
    {"point": "dispatch_error", "times": 2, "after": 3},
    {"point": "lane_fetch_error", "times": 2, "after": 1},
    {"point": "h2d_error", "times": 1, "after": 16},
    {"point": "dispatch_error", "times": 1, "after": 16}]}
PIPE_DEPTH, PIPE_STAGERS = 3, 2


def run_pipelined(engine, batches, take_fires=False):
    """Feed `batches` through a PipelinedSubmitter(PIPE_DEPTH,
    PIPE_STAGERS) from a producer thread while this thread materializes
    each step in order as its future resolves. Returns the host clock at
    each step's end (its alerts materialized), the alert keys and, with
    `take_fires`, the command fires per step."""
    import threading

    from sitewhere_tpu_torch.pipeline.feed import PipelinedSubmitter

    sub = PipelinedSubmitter(engine, depth=PIPE_DEPTH, stagers=PIPE_STAGERS)
    futures = [None] * len(batches)
    submitted = [threading.Event() for _ in batches]
    errors = []

    def produce():
        try:
            for i, batch in enumerate(batches):
                futures[i] = sub.submit(batch)
                submitted[i].set()
        except Exception as exc:   # surfaces below, on the caller's thread
            errors.append(exc)
            for event in submitted:
                event.set()

    producer = threading.Thread(target=produce, name="smoke-producer")
    t0 = time.perf_counter()
    producer.start()
    ends, alerts, fires = [], [], []
    try:
        for i, batch in enumerate(batches):
            submitted[i].wait(timeout=300)
            if errors:
                raise errors[0]
            out = futures[i].result(timeout=300)
            alerts.append(_alert_keys(engine.materialize_alerts(batch, out)))
            if take_fires:
                fires.append(engine.take_command_fires())
            ends.append(time.perf_counter())
    finally:
        producer.join(timeout=300)
        sub.close()
    return [t0] + ends, alerts, fires


def _rates(ends, warmup):
    """events/s and step p50/p99 (ms) of a pipelined run from its step
    end times: a step's time is the gap since the previous step's end."""
    gaps = np.diff(ends)[warmup:]
    return {"events_per_s": BATCH * len(gaps) / float(np.sum(gaps)),
            "step_ms_p50": float(np.percentile(gaps, 50) * 1e3),
            "step_ms_p99": float(np.percentile(gaps, 99) * 1e3),
            "steps": len(gaps)}


def phase_pipelined(dev, card, main_ref, stateful_ref, runs):
    """The pipelined feeder against serial submission at full size, a
    fault drill on the card, and the host runtime's readings."""
    from sitewhere_tpu_torch.runtime import faults, hbmledger
    from sitewhere_tpu_torch.runtime.flight import FlightRecorder

    t_phase = time.perf_counter()
    batches = main_ref["batches"]
    # main path: pipelined == serial (phase 3), alerts and state
    engine = build_world(dev, "auto", main_ref["epoch_base_ms"])
    engine.flight = FlightRecorder(capacity=64)
    ends, alerts, _ = run_pipelined(engine, batches)
    if alerts != main_ref["alerts"]:
        raise AssertionError("pipelined and serial submission materialized "
                             "different alerts on the main path")
    assert_tree_bits_equal(main_ref["state"], engine.canonical_state(),
                           "pipelined main-path state")
    main_pipe = _rates(ends, WARMUP)
    flight = engine.flight.export(last_n=STEPS)["rollups"]
    flight["stage_ms"] = flight_stage_ms(engine, STEPS)
    ledger = hbmledger.ledger(engine)
    allocated = torch.cuda.memory_allocated()
    log(f"[pipelined] main path: pipelined == serial over {len(batches)} "
        f"steps (alerts, canonical state); graph_captures "
        f"{engine.graph_captures}, ring {engine.staging_ring.state()}")
    del engine

    # the drill: serial, then pipelined, under one seeded plan
    engine = build_world(dev, "auto", main_ref["epoch_base_ms"])
    retries0 = engine._retry_counter.value
    plan = faults.FaultPlan.from_json(DRILL_PLAN)
    half = len(batches) // 2
    faults.arm(plan)
    try:
        _, drill_alerts = run_trace(engine, batches[:half])
        _, more, _ = run_pipelined(engine, batches[half:])
    finally:
        faults.disarm()
    fires = {}
    for rule in plan.report()["rules"]:
        fires[rule["point"]] = fires.get(rule["point"], 0) + rule["fires"]
    drill = {"fires": fires,
             "step_retries": engine._retry_counter.value - retries0,
             "health": engine.health.to_json()["state"],
             "health_transitions": engine.health.transitions,
             "graph_captures": engine.graph_captures}
    if drill_alerts + more != main_ref["alerts"]:
        raise AssertionError("the fault drill changed the alerts")
    assert_tree_bits_equal(main_ref["state"], engine.canonical_state(),
                           "state after the fault drill")
    if not all(drill["fires"].values()) or drill["step_retries"] != sum(
            drill["fires"].values()):
        raise AssertionError(f"drill not absorbed as planned: {drill}")
    log(f"[pipelined] drill absorbed (identical alerts and state): "
        f"{json.dumps(drill)}")
    del engine

    # stateful path: the first STATEFUL_CPU_STEPS steps pipelined ==
    # serial (phase 5); then the rest pipelined, for its rates
    sbatches = stateful_ref["batches"]
    engine = build_stateful_world(dev, stateful_ref["epoch_base_ms"])
    n = STATEFUL_CPU_STEPS
    _, s_alerts, s_fires = run_pipelined(engine, sbatches[:n],
                                         take_fires=True)
    if s_alerts != stateful_ref["alerts"] or s_fires != stateful_ref["fires"]:
        raise AssertionError("pipelined and serial submission differ on the "
                             "stateful path")
    compare_snapshots(stateful_ref["snapshot"], stateful_snapshot(engine))
    ends, _, _ = run_pipelined(engine, sbatches[n:], take_fires=True)
    stateful_pipe = _rates(ends, WARMUP)
    stateful_ledger = hbmledger.ledger(engine)
    stateful_allocated = torch.cuda.memory_allocated()
    log(f"[pipelined] stateful path: pipelined == serial over {n} steps "
        f"(alerts, command fires, state groups, counters); graph_captures "
        f"{engine.graph_captures}")
    del engine

    for path, serial, pipe in (("main", runs["main"], main_pipe),
                               ("stateful", runs["stateful"],
                                stateful_pipe)):
        log(f"[pipelined] {path} rates: " + json.dumps({
            "serial": {k: serial[k] for k in ("events_per_s", "step_ms_p50",
                                              "step_ms_p99", "steps")},
            "pipelined": pipe}) + f" on {card}")
    for path, prof in (("main", runs["main_profile"]),
                       ("stateful", runs["stateful_profile"])):
        log(f"[pipelined] {path} under the graph: " + json.dumps({
            "graph_captures": runs[path]["graph_captures"],
            "device_events_per_step": prof["device_events_per_step"],
            "device_idle_share": prof["device_idle_share"],
            "b1_device_events_per_step":
                prof["b1_device_events_per_step"]}) + f" on {card}")
    log(f"[pipelined] main host split, ms: {json.dumps(runs['host_ms'])} "
        f"on {card}")
    log(f"[pipelined] main flight rollups: " + json.dumps({
        k: flight.get(k) for k in ("h2d_overlap_fraction",
                                   "stage_occupancy", "staging_ring",
                                   "sync_total_ms", "stage_ms",
                                   "critical_stage_counts")}))
    log(f"[pipelined] main HBM ledger: {json.dumps(ledger)}; "
        f"torch.cuda.memory_allocated {allocated}")
    log(f"[pipelined] stateful HBM ledger: {json.dumps(stateful_ledger)}; "
        f"torch.cuda.memory_allocated {stateful_allocated}")
    log(f"[pipelined] phase took {time.perf_counter() - t_phase:.1f} s")


# -- phase 7: durable state ------------------------------------------------------

def _blob_record(blob):
    """A bus value: the blob's row count, then its int32 rows."""
    return np.int32(blob.shape[0]).tobytes() + blob.tobytes()


def _record_blob(record):
    rows = int(np.frombuffer(record.value[:4], np.int32)[0])
    return np.frombuffer(record.value[4:], np.int32).reshape(rows, -1).copy()


def run_blob(engine, blob):
    """submit_blob + materialize_alerts of one packed blob; alert keys."""
    from sitewhere_tpu_torch.ops.pack import blob_to_batch

    out = engine.submit_blob(blob)
    batch = blob_to_batch(torch.from_numpy(blob))
    return _alert_keys(engine.materialize_alerts(batch, out))


def timed_sync(fn):
    """fn() between two synchronizes of the card; (result, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def open_windows(engine):
    """Per-device windows open in the stateful world's state: rule-program
    rows with a running counter (debounce, for-duration), rows whose
    program output latched (hysteresis and every held condition), and
    (device, policy) rows inside a debounce window."""
    from sitewhere_tpu_torch.ops.slab import unpack_state_slab_np

    rule = unpack_state_slab_np(engine.canonical_rule_state().slab.numpy())
    act = engine.canonical_actuation_state().slab.numpy()
    return {"rule_counters": int((rule["counter"] > 0).sum()),
            "rule_latched": int((rule["flag"] != 0).sum()),
            "debounce_rows": int((act[..., 2] != -(2 ** 31)).sum())}


def phase_durable(dev, card, main_ref, stateful_ref):
    """Checkpoint, restore and recover on both worlds; the command fan-out,
    drift refit and presence manager on the card. Returns the readings and
    the geofence kernel's launches on this path."""
    from sitewhere_tpu_torch.actuation.dispatcher import CommandFanout
    from sitewhere_tpu_torch.actuation.refit import DriftRefitter
    from sitewhere_tpu_torch.ops.pack import batch_to_blob
    from sitewhere_tpu_torch.persist.checkpoint import PipelineCheckpointer
    from sitewhere_tpu_torch.pipeline.presence import DevicePresenceManager
    from sitewhere_tpu_torch.runtime import faults
    from sitewhere_tpu_torch.runtime.bus import EventBus

    t_phase = time.perf_counter()
    readings = {}
    cut, n = DURABLE_CUT, DURABLE_CUT + DURABLE_AFTER
    epoch = main_ref["epoch_base_ms"]
    blobs = [batch_to_blob(b) for b in main_ref["batches"][:n]]
    workdir = tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-")
    engines = []
    # every engine's replay counts (the dicts outlive their engines)
    replay_counts = []

    def track(engine):
        replay_counts.append(engine.graph_kernel_launches)
        engines.append(engine)
        return engine

    reset_launch_counts()
    try:
        # -- main world: bus-fed steps, save, restore x2, continue, recover
        bus = EventBus(partitions=1)
        for i, blob in enumerate(blobs):
            bus.publish("events", f"b{i}".encode(), _blob_record(blob))
        ref = track(build_world(dev, "auto", epoch))
        consumer = bus.consumer("events", "pipeline")
        ref_alerts = [run_blob(ref, _record_blob(r))
                      for r in consumer.poll(cut)]
        bus.commit(consumer)
        ckpt = PipelineCheckpointer(f"{workdir.name}/main")
        _, save_s = timed_sync(lambda: ckpt.save(
            ref, bus, consumer_groups=[consumer]))
        readings["main_save"] = dict(ckpt.last_timings, wall_s=save_s)
        fresh = track(build_world(dev, "auto", epoch + 1))
        captured = track(build_world(dev, "auto", epoch + 2))
        for blob in blobs[-2:]:                # its own traffic, captured
            run_blob(captured, blob)
        if captured.graph_captures != 1:
            raise AssertionError("the captured engine did not capture")
        for name, engine in (("main_restore_fresh", fresh),
                             ("main_restore_captured", captured)):
            _, wall = timed_sync(lambda: ckpt.restore(engine))
            readings[name] = dict(ckpt.last_timings, wall_s=wall)
        ref_alerts += [run_blob(ref, _record_blob(r))
                       for r in consumer.poll(DURABLE_AFTER)]
        for engine in (fresh, captured):
            got = [run_blob(engine, blob) for blob in blobs[cut:]]
            if got != ref_alerts[cut:]:
                raise AssertionError("a restored main-world engine "
                                     "materialized other alerts")
            assert_tree_bits_equal(ref.canonical_state(),
                                   engine.canonical_state(),
                                   "restored main-world state")
        if captured.graph_captures != 1 or fresh.graph_captures != 1:
            raise AssertionError(
                f"restores recaptured: {captured.graph_captures} / "
                f"{fresh.graph_captures} captures")
        # a crash after the save: recover replays the uncommitted records
        recovered = track(build_world(dev, "auto", epoch + 3))
        replayed = []

        def replay(records):
            replayed.extend(run_blob(recovered, _record_blob(r))
                            for r in records)

        n_replayed, wall = timed_sync(lambda: ckpt.recover(
            recovered, bus, "events", "pipeline", replay))
        readings["main_recover"] = dict(ckpt.last_timings, wall_s=wall,
                                        replayed=n_replayed)
        if n_replayed != DURABLE_AFTER or replayed != ref_alerts[cut:]:
            raise AssertionError(f"recover replayed {n_replayed} records "
                                 f"with other alerts")
        assert_tree_bits_equal(ref.canonical_state(),
                               recovered.canonical_state(),
                               "recovered state")
        # presence: the manager's sweep against a twin's presence_sweep
        manager = DevicePresenceManager(fresh)
        missing = manager.sweep()
        twin_missing = captured.presence_sweep()
        if not missing or missing != twin_missing or not torch.equal(
                fresh.state.present, captured.state.present):
            raise AssertionError("presence manager sweep differs from the "
                                 "twin's presence_sweep")
        readings["presence_missing"] = len(missing)
        log(f"[durable] main world: 2 restores + recover ({n_replayed} "
            f"records) continue bit-equal to the uninterrupted engine over "
            f"{DURABLE_AFTER} steps (alerts, canonical state), no new "
            f"capture; presence manager == twin ({len(missing)} missing)")
        del ref, fresh, captured, recovered
        engines.clear()

        # -- stateful world: save mid-window, restore on card and CPU
        sbatches = stateful_ref["batches"][:n]
        sepoch = stateful_ref["epoch_base_ms"]
        ref = track(build_stateful_world(dev, sepoch))
        ref_steps = []
        for batch in sbatches[:cut]:
            out = ref.submit(batch)
            ref_steps.append((_alert_keys(ref.materialize_alerts(batch, out)),
                              ref.take_command_fires(), out.model_score.cpu()))
        windows = open_windows(ref)
        if not all(windows.values()):
            raise AssertionError(f"no window open at the save: {windows}")
        ckpt = PipelineCheckpointer(f"{workdir.name}/stateful")
        _, save_s = timed_sync(lambda: ckpt.save(ref))
        readings["stateful_save"] = dict(ckpt.last_timings, wall_s=save_s)
        card_engine = track(build_stateful_world(dev, sepoch + 1))
        cpu_engine = track(build_stateful_world(torch.device("cpu"),
                                                sepoch + 2))
        for name, engine in (("stateful_restore_card", card_engine),
                             ("stateful_restore_cpu", cpu_engine)):
            _, wall = timed_sync(lambda: ckpt.restore(engine))
            readings[name] = dict(ckpt.last_timings, wall_s=wall)
        worst = 0.0
        for batch in sbatches[cut:]:
            out = ref.submit(batch)
            want = (_alert_keys(ref.materialize_alerts(batch, out)),
                    ref.take_command_fires())
            ref_steps.append((*want, out.model_score.cpu()))
            for engine in (card_engine, cpu_engine):
                got_out = engine.submit(batch)
                got = (_alert_keys(engine.materialize_alerts(batch, got_out)),
                       engine.take_command_fires())
                if got != want:
                    raise AssertionError(f"restored stateful engine on "
                                         f"{engine.device} fired otherwise")
                score = got_out.model_score.cpu()
                if engine is card_engine:
                    if not torch.equal(_bits(score),
                                       _bits(out.model_score.cpu())):
                        raise AssertionError("card scores differ")
                else:
                    torch.testing.assert_close(
                        score, out.model_score.cpu(), rtol=SCORE_RTOL,
                        atol=SCORE_ATOL)
                    worst = max(worst, float(
                        (score - out.model_score.cpu()).abs().max()))
        snap = stateful_snapshot(ref)
        compare_snapshots(snap, stateful_snapshot(card_engine))
        compare_snapshots(snap, stateful_snapshot(cpu_engine))
        log(f"[durable] stateful world, saved with windows open "
            f"{json.dumps(windows)}: card and CPU restores continue with "
            f"identical alerts, fires, state groups and counters over "
            f"{DURABLE_AFTER} steps; CPU scores max |diff| {worst:.3g}")

        # refit: the card engine's against the CPU engine's
        refits = {}
        for spec in STATEFUL_MODELS:
            token = spec["token"]
            (report, wall) = timed_sync(
                lambda: DriftRefitter(card_engine).refit(token))
            cpu_report = DriftRefitter(cpu_engine).refit(token)
            if report != cpu_report or card_engine.get_anomaly_model(
                    token) != cpu_engine.get_anomaly_model(token):
                raise AssertionError(f"refit of {token} differs between "
                                     f"the card and the CPU")
            refits[token] = {"devices": report and report["devices"],
                             "wall_s": wall}
        readings["refit"] = refits
        log(f"[durable] DriftRefitter on the card == on the CPU engine: "
            f"{json.dumps(refits)}")
        del cpu_engine, card_engine
        engines[1:] = []

        # the command fan-out under a seeded delivery-fault drill, against
        # the fires the uninterrupted engine parked (its twin)
        drilled = track(build_stateful_world(dev, sepoch))
        fan = CommandFanout(max_retries=2)
        drilled.command_dispatcher = fan
        faults.arm(faults.FaultPlan.from_json({"seed": SEED, "rules": [
            {"point": "command_delivery_error", "p": 0.3}]}))
        try:
            for batch in sbatches:
                drilled.materialize_alerts(batch, drilled.submit(batch))
        finally:
            faults.disarm()
        stats = dict(fan.stats())
        redelivered = fan.redeliver_parked()
        wanted = [f for _, fires, _ in ref_steps for f in fires]
        key = lambda f: json.dumps(f, sort_keys=True)  # noqa: E731
        if (sorted(map(key, fan.sent)) != sorted(map(key, wanted))
                or stats["delivered"] + stats["parked"] != len(wanted)
                or not stats["retries"]):
            raise AssertionError(f"fan-out drill not absorbed: {stats}")
        readings["fanout"] = dict(stats, redelivered=redelivered,
                                  fires=len(wanted))
        log(f"[durable] fan-out drill absorbed: {json.dumps(readings['fanout'])}")
    finally:
        faults.disarm()
        del engines[:]
        workdir.cleanup()
    launches = launch_counts()["points_in_zones"] + sum(
        c.get("points_in_zones", 0) for c in replay_counts)
    if not launches:
        raise AssertionError("the durable path launched no geofence kernel")
    readings["phase_s"] = time.perf_counter() - t_phase
    log(f"[durable] readings {json.dumps(readings)} on {card}")
    return readings, launches


# -- phase 8: the ingest host tier --------------------------------------------

def encode_delivery(rng, epoch, n_registered, batch, n_control):
    """One delivery's wire bytes: `batch` hot frames of the headline traffic
    (the 60/30/10 mix, values U(0,100), lat/lon in the box, ts within 1 s
    of the epoch, INGEST_UNKNOWN of them from tokens the registry does not
    hold) and `n_control` REGISTER frames spread among them. Returns
    (frame byte lengths in order, the bytes, the unknown tokens in order,
    the REGISTER frames)."""
    from sitewhere_tpu_torch.transport.wire import (
        MessageType, WireCodec, encode_frame)

    kind = rng.choice(3, size=batch, p=[0.6, 0.3, 0.1])
    dev = rng.integers(1, n_registered + 1, batch)
    unknown = rng.random(batch) < INGEST_UNKNOWN
    ts = epoch + rng.integers(0, 1000, batch)
    value = rng.uniform(0, 100, batch)
    lat = rng.uniform(*LAT_LON_BOX, batch)
    lon = rng.uniform(*LAT_LON_BOX, batch)
    level = rng.integers(0, 4, batch)
    control_at = set(rng.choice(batch, n_control, replace=False).tolist())
    frames, ghosts, controls = [], [], []
    M, L, A = MessageType.MEASUREMENT, MessageType.LOCATION, MessageType.ALERT
    for i in range(batch):
        if i in control_at:
            reg = encode_frame(MessageType.REGISTER, WireCodec.encode_register(
                f"new-{len(controls)}-{int(dev[i])}", "sensor",
                area_token="area-1"))
            frames.append(reg)
            controls.append(reg)
        token = f"dev-{int(dev[i])}"
        if unknown[i]:
            token = f"ghost-{int(dev[i])}"
            ghosts.append(token)
        k = kind[i]
        if k == 0:
            frames.append(encode_frame(M, WireCodec.encode_measurement(
                token, int(ts[i]), "m1", float(value[i]))))
        elif k == 1:
            frames.append(encode_frame(L, WireCodec.encode_location(
                token, int(ts[i]), float(lat[i]), float(lon[i]))))
        else:
            frames.append(encode_frame(A, WireCodec.encode_alert(
                token, int(ts[i]), "overheat", int(level[i]), "hot")))
    return [len(f) for f in frames], b"".join(frames), ghosts, controls


def build_registry_store(n_registered):
    """The control plane of phase 3's world: a DeviceManagement holding the
    same registered devices (type "sensor", area "area-1", assignment
    "as-<token>"), so the bulk lane persists rule alerts through the event
    management as a deployment does."""
    from sitewhere_tpu_torch.model import (
        Area, Device, DeviceAssignment, DeviceType)
    from sitewhere_tpu_torch.registry.store import DeviceManagement

    dm = DeviceManagement()
    dtype = dm.create_device_type(DeviceType(token="sensor"))
    area = dm.create_area(Area(token="area-1"))
    for i in range(1, n_registered + 1):
        d = dm.create_device(Device(token=f"dev-{i}", device_type_id=dtype.id))
        dm.create_device_assignment(DeviceAssignment(
            token=f"as-dev-{i}", device_id=d.id, area_id=area.id))
    return dm


def _timed(obj, name, sink, keep=None):
    """Wrap obj.name (an instance attribute shadows the method) so each call
    appends its host seconds to `sink` (and its result to `keep`)."""
    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sink.append(time.perf_counter() - t0)
        if keep is not None:
            keep.append(out)
        return out

    setattr(obj, name, wrapper)


def run_bulk_lane(engine, dm, deliveries, worker):
    """The deliveries through BulkWireIngestService (inline append, or the
    persistence worker); per-delivery host seconds of its parts, the
    decoded batches, the materialized alerts, and the log, bus and control
    frames to check."""
    from sitewhere_tpu_torch.persist.event_management import (
        DeviceEventManagement)
    from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog
    from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming
    from sitewhere_tpu_torch.sources.fastlane import BulkWireIngestService

    naming = TopicNaming()
    bus = EventBus(partitions=1)
    elog = ColumnarEventLog(segment_rows=BATCH)
    controls = []
    svc = BulkWireIngestService(
        engine, eventlog=elog, bus=bus, tenant="tenant-1", naming=naming,
        registry=dm, events=DeviceEventManagement(elog, registry=dm,
                                                  tenant="tenant-1"),
        control_sink=lambda frame, meta: controls.append(frame),
        persist_async=worker)
    t = {k: [] for k in ("ingest", "submit", "materialize", "append",
                         "delivery")}
    results, alerts = [], []
    _timed(svc.lane, "ingest", t["ingest"], results)
    _timed(engine, "submit_routed", t["submit"])
    _timed(engine, "materialize_alerts", t["materialize"], alerts)
    _timed(elog, "append_batch", t["append"])
    svc.start()
    try:
        t0 = None
        for i, data in enumerate(deliveries):
            if i == INGEST_WARMUP:
                if worker:
                    svc.persister.flush()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            ts = time.perf_counter()
            svc.on_encoded_event_received(data)
            t["delivery"].append(time.perf_counter() - ts)
        if worker:
            svc.persister.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        svc.stop()
        for name in ("submit_routed", "materialize_alerts"):
            del engine.__dict__[name]
    if svc.failed_counter.value or svc._remainder:
        raise AssertionError("the bulk lane failed a decode or kept bytes")
    batches = [b for r in results for b in r.batches]
    return {"t": t, "wall": wall, "batches": batches, "alerts": alerts,
            "log": elog, "bus": bus, "naming": naming, "controls": controls,
            "n_events": sum(r.n_events for r in results)}


def check_log_rows(elog, batches, epoch):
    """The log's hot rows (in append order, the persisted rule alerts left
    out) equal the batches' valid rows, column by column."""
    names = ["id_seq", "alert_source", "device_idx", "event_type",
             "event_date", "mm_idx", "value", "latitude", "longitude",
             "elevation", "alert_level", "alert_type_idx"]
    cols = elog.query_columns("tenant-1", _event_filter(), names)
    order = np.argsort(cols["id_seq"], kind="stable")
    hot = order[cols["alert_source"][order] != 1]
    valid = [np.asarray(b.valid) for b in batches]
    want = {
        "device_idx": "device_idx", "event_type": "event_type",
        "mm_idx": "mm_idx", "value": "value", "latitude": "lat",
        "longitude": "lon", "elevation": "elevation",
        "alert_level": "alert_level", "alert_type_idx": "alert_type_idx"}
    for col, field in want.items():
        got = cols[col][hot]
        exp = np.concatenate([np.asarray(getattr(b, field))[v]
                              for b, v in zip(batches, valid)])
        if got.dtype == np.float32:
            got, exp = got.view(np.int32), exp.view(np.int32)
        if not np.array_equal(got, exp):
            raise AssertionError(f"event log column {col} differs from the "
                                 f"batches' rows")
    exp_dates = np.concatenate([np.asarray(b.ts)[v].astype(np.int64) + epoch
                                for b, v in zip(batches, valid)])
    if not np.array_equal(cols["event_date"][hot], exp_dates):
        raise AssertionError("event log dates differ from the batches'")
    return len(hot)


def _event_filter():
    from sitewhere_tpu_torch.persist.eventlog import EventFilter

    return EventFilter()


def pack_vs_plain(dev_batches, card):
    """The native pack against the plain numpy pack into a pinned buffer at
    the full batch, on each layout: byte-equal blobs, then INGEST_PACK_REPS
    calls of each in alternation."""
    from sitewhere_tpu_torch.ops.pack import (
        WIRE_ROWS, batch_to_blob, batch_to_blob_plain)

    pinned = torch.empty((WIRE_ROWS, BATCH), dtype=torch.int32,
                         pin_memory=True).numpy()
    out = {}
    for layout, batch in dev_batches.items():
        blob = batch_to_blob(batch, out=pinned).copy()
        plain = batch_to_blob_plain(batch)
        if blob.shape[0] != {"full": 5, "compact": 4, "packed": 3}[layout] \
                or blob.tobytes() != plain.tobytes():
            raise AssertionError(f"native pack != plain pack on {layout}")
        native_ms, plain_ms = [], []
        for _ in range(INGEST_PACK_REPS):
            for fn, sink in ((batch_to_blob, native_ms),
                             (batch_to_blob_plain, plain_ms)):
                t0 = time.perf_counter()
                fn(batch, out=pinned)
                sink.append((time.perf_counter() - t0) * 1e3)
        out[layout] = {"native_ms": statistics.median(native_ms),
                       "plain_ms": statistics.median(plain_ms),
                       "rows": blob.shape[0]}
    log(f"[ingest] pack into the pinned buffer, B={BATCH}, median of "
        f"{INGEST_PACK_REPS} each in alternation: {json.dumps(out)} on "
        f"{card}")
    return out


def layout_batches(packer, seed):
    """Three full-size host batches, one per wire layout: the main path's
    traffic (compact: no elevation), the same with elevations (full), and
    measurements and alerts only within 1 s (packed)."""
    compact = synthetic_batch(packer, N_REGISTERED, BATCH, seed)
    full = synthetic_batch(packer, N_REGISTERED, BATCH, seed)
    full.elevation = torch.from_numpy(np.random.default_rng(seed).uniform(
        1, 50, BATCH).astype(np.float32))
    packed = synthetic_batch(packer, N_REGISTERED, BATCH, seed,
                             p_types=(0.9, 0.0, 0.1))
    return {"full": full, "compact": compact, "packed": packed}


def object_drill(dev, dm, epoch, records):
    """~1024 events as decoded requests from the bus through the port's
    InboundProcessingService, persistence triggers and PayloadEnrichment on
    a small engine on `dev`; returns what was persisted, enriched and
    routed unregistered, with the random parts (received dates, a rule
    alert's id) left out."""
    from sitewhere_tpu_torch.persist.event_management import (
        DeviceEventManagement, EventPersistenceTriggers)
    from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog
    from sitewhere_tpu_torch.pipeline.enrichment import (
        PayloadEnrichment, unpack_enriched)
    from sitewhere_tpu_torch.pipeline.inbound import InboundProcessingService
    from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming

    engine = build_object_engine(dev, dm, epoch)
    naming, bus = TopicNaming(), EventBus(partitions=1)
    elog = ColumnarEventLog()
    events = DeviceEventManagement(elog, registry=dm, tenant="tenant-1",
                                   device_interner=engine.packer.devices)
    EventPersistenceTriggers(bus, naming, "tenant-1").attach(events)
    inbound = InboundProcessingService(bus, dm, events=events, engine=engine,
                                       tenant="tenant-1", naming=naming)
    enrich = PayloadEnrichment(bus, dm, tenant="tenant-1", naming=naming)
    decoded = naming.event_source_decoded_events("tenant-1")
    for value in records:
        bus.publish(decoded, b"k", value)
    inbound.process(bus.consumer(decoded, "drill").poll(max_records=10_000))
    enrich._process(bus.consumer(naming.inbound_persisted_events(
        "tenant-1"), "drill").poll(max_records=10_000))

    def normal(ev):
        d = dataclasses.asdict(ev)
        d.pop("received_date")
        if d.get("source") == 1:
            d.pop("id")
        return d

    persisted = [normal(e) for e in elog.query(
        "tenant-1", _event_filter(), _criteria(10_000)).results]
    enriched = []
    for part in bus.topic(naming.inbound_enriched_events(
            "tenant-1")).partitions:
        for _, _, value, _ in part.read(0, 10_000):
            ctx, ev = unpack_enriched(value)
            enriched.append((dataclasses.asdict(ctx), normal(ev)))
    unregistered = [v for part in bus.topic(
        naming.inbound_unregistered_device_events("tenant-1")).partitions
        for _, _, v, _ in part.read(0, 10_000)]
    if inbound.failed_counter.value:
        raise AssertionError("the inbound service failed records")
    return persisted, enriched, unregistered, engine


def _criteria(n):
    from sitewhere_tpu_torch.model.common import SearchCriteria

    return SearchCriteria(page_size=n)


def object_world(n_devices=OBJECT_DEVICES):
    """The object drill's control plane: registered devices and two zones
    of phase 3's geometry."""
    from sitewhere_tpu_torch.model import Zone
    from sitewhere_tpu_torch.model.common import Location

    dm = build_registry_store(n_devices)
    area = dm.get_area_by_token("area-1")
    _, _, verts = random_world(SEED, 1, 2, N_VERTS, box=LAT_LON_BOX,
                               radius=(4.0, 8.0))
    for z in range(2):
        dm.create_zone(Zone(token=f"zone-{z}", area_id=area.id, bounds=[
            Location(float(a), float(b)) for a, b in verts[z]]))
    return dm


def object_records(epoch, n_devices=OBJECT_DEVICES, n_requests=256):
    """The drill's decoded requests (sources/manager's msgpack form): 4
    events each with fixed ids, every 16th from an unknown device."""
    import msgpack

    from sitewhere_tpu_torch.model.common import _asdict
    from sitewhere_tpu_torch.model.event import (
        DeviceAlert, DeviceEventBatch, DeviceLocation, DeviceMeasurement)

    rng = np.random.default_rng(SEED + 8)
    out = []
    for k in range(n_requests):
        token = (f"ghost-{k}" if k % 16 == 5
                 else f"dev-{int(rng.integers(1, n_devices + 1))}")
        ts = epoch + int(rng.integers(0, 1000))
        batch = DeviceEventBatch(
            device_token=token,
            measurements=[DeviceMeasurement(
                id=f"m{j}-{k}", name=f"m{j + 1}",
                value=float(rng.uniform(80, 100)), event_date=ts,
                received_date=ts) for j in range(2)],
            locations=[DeviceLocation(
                id=f"l-{k}", latitude=float(rng.uniform(*LAT_LON_BOX)),
                longitude=float(rng.uniform(*LAT_LON_BOX)), event_date=ts,
                received_date=ts)],
            alerts=[DeviceAlert(id=f"a-{k}", type="door", level=2,
                                message="open", event_date=ts,
                                received_date=ts)])
        out.append(msgpack.packb({
            "sourceId": "chip-smoke", "deviceToken": token,
            "kind": "DeviceEventBatch", "request": _asdict(batch),
            "metadata": {}}, use_bin_type=True))
    return out


def build_object_engine(dev, dm, epoch):
    from sitewhere_tpu_torch.model import AlertLevel
    from sitewhere_tpu_torch.pipeline import (
        GeofenceRule, PipelineEngine, ThresholdRule)
    from sitewhere_tpu_torch.registry import RegistryTensors

    reg = RegistryTensors(max_devices=1024, max_zones=4,
                          max_zone_vertices=N_VERTS)
    reg.attach(dm, "tenant-1")
    engine = PipelineEngine(reg, batch_size=256, measurement_slots=8,
                            max_tenants=4, max_threshold_rules=8,
                            max_geofence_rules=8, alert_lane_capacity=64,
                            name=f"chip-smoke-object-{dev.type}", device=dev)
    engine.packer.epoch_base_ms = epoch
    engine.packer.measurements.intern("m1")
    engine.add_threshold_rule(ThresholdRule(
        token="thr", measurement_name="m1", operator=">", threshold=95.0,
        alert_level=AlertLevel.WARNING))
    engine.add_geofence_rule(GeofenceRule(
        token="fence-in", zone_token="zone-0", condition="inside",
        alert_level=AlertLevel.CRITICAL))
    engine.add_geofence_rule(GeofenceRule(
        token="fence-out", zone_token="zone-1", condition="outside"))
    engine.start()
    return engine


def phase_ingest(dev, card, main_ref):
    """The ingest host tier at full size: wire bytes -> native decode ->
    batched interning -> native pack into the pinned staging buffer -> the
    captured step (kernel B1) -> alert materialization -> the columnar event
    log, inline and on the persistence worker; checked against a second card
    engine fed the decoded batches through submit. Then the native pack
    and decoder against their plain versions, and the object path on the
    card against the CPU. Returns the readings and B1's launches on the
    bulk lane."""
    from sitewhere_tpu_torch import native
    from sitewhere_tpu_torch.ops.pack import EventPacker
    from sitewhere_tpu_torch.registry.interning import TokenInterner
    from sitewhere_tpu_torch.runtime.flight import FlightRecorder
    from sitewhere_tpu_torch.transport.wire import (
        decode_event_frames_to_columns, decode_frames)

    t_phase = time.perf_counter()
    readings = {}
    epoch = main_ref["epoch_base_ms"]
    n = INGEST_WARMUP + INGEST_DELIVERIES
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 80)
    lengths, datas, ghosts, controls = [], [], [], []
    for _ in range(n):
        lens, data, g, c = encode_delivery(rng, epoch, N_REGISTERED, BATCH,
                                           INGEST_CONTROL)
        lengths.append(lens)
        datas.append(data)
        ghosts += g
        controls += c
    stream = b"".join(datas)
    # cut each delivery a few bytes into its first hot frame: every
    # delivery but the first starts with the previous one's remainder
    starts = np.cumsum([0] + [len(d) for d in datas])
    cuts = [0] + [int(s) + 3 for s in starts[1:-1]] + [len(stream)]
    deliveries = [stream[a:b] for a, b in zip(cuts, cuts[1:])]
    log(f"[ingest] {n} deliveries of {BATCH} events + {INGEST_CONTROL} "
        f"REGISTER frames encoded in {time.perf_counter() - t0:.2f} s "
        f"({len(stream)} bytes, {len(ghosts)} unknown tokens)")
    t0 = time.perf_counter()
    dm = build_registry_store(N_REGISTERED)
    log(f"[ingest] control plane ({N_REGISTERED} devices + assignments) "
        f"built in {time.perf_counter() - t0:.2f} s")

    engines = {}
    for name in ("inline", "worker", "reference"):
        engine = build_world(dev, "auto", epoch)
        engine.flight = FlightRecorder(capacity=64)
        if name != "reference":
            engine.registry.attach(dm, "tenant-1")
        engines[name] = engine
    ref_snap = engines["reference"].registry.snapshot()
    for name in ("inline", "worker"):
        snap = engines[name].registry.snapshot()
        for f in dataclasses.fields(snap):
            if f.name != "version" and not np.array_equal(
                    getattr(snap, f.name), getattr(ref_snap, f.name)):
                raise AssertionError(f"the attached store's mirror differs "
                                     f"from phase 3's rows: {f.name}")
    torch.cuda.synchronize()
    reset_launch_counts(engines["inline"], engines["worker"])
    runs = {name: run_bulk_lane(engines[name], dm, deliveries,
                                worker=(name == "worker"))
            for name in ("inline", "worker")}
    launches = launch_counts(engines["inline"], engines["worker"])[
        "points_in_zones"]
    if not launches:
        raise AssertionError("the bulk lane launched no geofence kernel")

    # -- checks: the reference engine fed the decoded batches via submit
    ref = engines["reference"]
    batches = runs["inline"]["batches"]
    if len(batches) != n or runs["inline"]["n_events"] != n * BATCH:
        raise AssertionError(f"{len(batches)} batches of "
                             f"{runs['inline']['n_events']} events from "
                             f"{n} deliveries")
    for a, b in zip(batches, runs["worker"]["batches"]):
        assert_tree_bits_equal(a, b, "worker lane batch")
    ref_alerts = []
    for batch in batches:
        ref_alerts.append(_alert_keys(ref.materialize_alerts(
            batch, ref.submit(batch))))
    ref_state = ref.canonical_state()
    ref_missing = ref.presence_sweep()
    for name, run in runs.items():
        engine = engines[name]
        if [_alert_keys(a) for a in run["alerts"]] != ref_alerts:
            raise AssertionError(f"{name} bulk lane materialized other "
                                 f"alerts than submit")
        assert_tree_bits_equal(ref_state, engine.canonical_state(),
                               f"{name} canonical state")
        if engine.presence_sweep() != ref_missing or not torch.equal(
                engine.state.present, ref.state.present):
            raise AssertionError(f"{name} presence transitions differ")
        rows = check_log_rows(run["log"], run["batches"], epoch)
        valid = sum(int(np.asarray(b.valid).sum()) for b in batches)
        if rows != valid:
            raise AssertionError(f"{name} log holds {rows} hot rows, the "
                                 f"batches {valid}")
        topic = run["naming"].inbound_unregistered_device_events("tenant-1")
        unreg = [v.decode() for part in run["bus"].topic(topic).partitions
                 for _, _, v, _ in part.read(0, 10 ** 7)]
        if unreg != ghosts:
            raise AssertionError(f"{name}: the unregistered topic holds "
                                 f"{len(unreg)} tokens, not the "
                                 f"{len(ghosts)} unknown ones")
        if run["controls"] != controls:
            raise AssertionError(f"{name}: control frames not forwarded")
        t = run["t"]
        timed = slice(INGEST_WARMUP, None)
        readings[name] = {
            "events_per_s_bytes_to_rows": INGEST_DELIVERIES * BATCH
            / run["wall"],
            "delivery_ms": statistics.median(t["delivery"][timed]) * 1e3,
            "decode_intern_pack_columns_ms":
                statistics.median(t["ingest"][timed]) * 1e3,
            "submit_ms": statistics.median(t["submit"][timed]) * 1e3,
            "materialize_ms": statistics.median(t["materialize"][timed])
            * 1e3,
            "append_batch_ms": statistics.median(t["append"][timed]) * 1e3,
            "flight_pack_ms": flight_stage_ms(engine, INGEST_DELIVERIES)
            .get("pack"),
            "alerts": sum(len(a) for a in run["alerts"]),
            "log_rows": run["log"].count("tenant-1"),
        }
        log(f"[ingest] bulk lane ({name}): {n} deliveries == submit of the "
            f"decoded batches on a second card engine (alerts, canonical "
            f"state, presence transitions {len(ref_missing)}); log rows == "
            f"batch rows ({rows}); {len(unreg)} unknown tokens routed; "
            f"{len(controls)} control frames forwarded; "
            f"{json.dumps(readings[name])} on {card}")
    del runs, engines, ref, batches

    # -- the native decoder against the plain one, on one delivery
    one = datas[1]
    cols = native.decode_hot_frames(one)
    frames, rest = decode_frames(one)
    plain = decode_event_frames_to_columns(frames)
    same = (cols.token_list() == plain["tokens"] and cols.n == BATCH
            and cols.consumed == len(one) and rest == b""
            and len(cols.others) == INGEST_CONTROL)
    for k in ("event_type", "ts_ms", "value", "lat", "lon", "elevation",
              "alert_level"):
        a, b = np.asarray(getattr(cols, k)), np.asarray(plain[k])
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        same = same and np.array_equal(a, b)
    for name in ("names", "alert_types"):
        buf, off = getattr(cols, name)
        same = same and [buf[off[i]:off[i + 1]].decode()
                         for i in range(cols.n)] == plain[name]
    if not same:
        raise AssertionError("native decoder columns != plain decoder's")
    log(f"[ingest] native decoder == plain decoder on one delivery "
        f"({cols.n} events, {len(cols.others)} control frames)")

    # -- the native pack against the plain one, per layout
    packer = EventPacker(BATCH, TokenInterner(MAX_DEVICES, "devices"),
                         epoch_base_ms=epoch)
    readings["pack"] = pack_vs_plain(layout_batches(packer, SEED + 81), card)

    # -- the object path on the card against the CPU
    odm = object_world()
    records = object_records(epoch)
    card_out = object_drill(dev, odm, epoch, records)
    cpu_out = object_drill(torch.device("cpu"), odm, epoch, records)
    for what, a, b in zip(("persisted events", "enriched records",
                           "unregistered records"), card_out, cpu_out):
        if a != b:
            raise AssertionError(f"object path: {what} differ between the "
                                 f"card and the CPU")
    persisted, enriched, unreg, _ = card_out
    rule_alerts = sum(1 for e in persisted if e.get("source") == 1)
    if not rule_alerts or len(enriched) != len(persisted) or not unreg:
        raise AssertionError("object drill persisted no rule alert")
    readings["object_path"] = {"persisted": len(persisted),
                               "rule_alerts": rule_alerts,
                               "enriched": len(enriched),
                               "unregistered": len(unreg)}
    log(f"[ingest] object path (inbound -> persist -> step -> alerts -> "
        f"enrichment) on the card == on the CPU: "
        f"{json.dumps(readings['object_path'])}")
    readings["phase_s"] = time.perf_counter() - t_phase
    log(f"[ingest] readings {json.dumps(readings)} on {card}")
    return readings, launches


# -- phase 9: the read side of the event log -------------------------------------

def read_side_packer(epoch):
    """Phase 3's packer without its engine: the same device interner
    (dev-1.. dev-N at indices 1..N, as the registry mirror interns them),
    the same epoch, m1 at measurement slot 1."""
    from sitewhere_tpu_torch.ops.pack import EventPacker
    from sitewhere_tpu_torch.registry.interning import TokenInterner

    interner = TokenInterner(MAX_DEVICES, "devices")
    for i in range(1, N_REGISTERED + 1):
        interner.intern(f"dev-{i}")
    packer = EventPacker(BATCH, interner, epoch_base_ms=epoch)
    packer.measurements.intern("m1")
    return packer


class ReadLog:
    """The log of phase 9: phase 3's batches, chunk i shifted i minutes
    forward (modulo READ_WINDOWS: later chunks land in earlier windows, as
    late data does) and sealed as one segment; `cum[i]` is the measurement
    rows of chunks 0..i-1 (every chunk's rows are valid and in the served
    range)."""

    def __init__(self, batches, packer):
        from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog

        self.batches, self.packer = batches, packer
        self.log = ColumnarEventLog(segment_rows=READ_SEGMENT_ROWS)
        self.rows = 0
        self.cum = [0]
        self.devices = np.zeros(MAX_DEVICES + 1, bool)  # with measurements
        self.lock = threading.Lock()

    def chunk(self, i):
        b = self.batches[i % len(self.batches)]
        return dataclasses.replace(
            b, ts=b.ts + (i % READ_WINDOWS) * READ_WINDOW_MS)

    def seal_next(self):
        """Append and seal the next chunk; returns its index."""
        with self.lock:
            i = len(self.cum) - 1
            batch = self.chunk(i)
            self.rows += self.log.append_batch(READ_TENANT, batch,
                                               self.packer)
            self.log.flush_tenant(READ_TENANT)
            is_meas = ((batch.event_type == 0) & batch.valid).numpy()
            self.devices[batch.device_idx.numpy()[is_meas]] = True
            self.cum.append(self.cum[-1] + int(is_meas.sum()))
            return i

    def segments(self):
        return self.log.tenant(READ_TENANT).sealed_snapshot()[1]


def _f32_bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def stats_mismatches(a, b):
    """Cells whose bits differ, per grid, between two WindowedStats."""
    return {f: int((_f32_bits(getattr(a, f).cpu())
                    != _f32_bits(getattr(b, f).cpu())).sum())
            for f in ("count", "sum", "mean", "min", "max")}


def assert_reports_bits_equal(got, ref, what):
    """Keys, tokens, every grid as bit patterns and the histogram."""
    if (got.t0_ms, got.n_windows) != (ref.t0_ms, ref.n_windows) or \
            not np.array_equal(np.asarray(got.key_ids, object),
                               np.asarray(ref.key_ids, object)) or \
            got.key_tokens != ref.key_tokens:
        raise AssertionError(f"{what}: keys, tokens or geometry differ")
    bad = stats_mismatches(got.stats, ref.stats)
    if any(bad.values()):
        raise AssertionError(f"{what}: grids differ {bad}")
    if (got.type_counts is None) != (ref.type_counts is None) or (
            got.type_counts is not None and
            not np.array_equal(got.type_counts, ref.type_counts)):
        raise AssertionError(f"{what}: histograms differ")


def assert_matches_oracle(got, ref, what):
    """tests/test_serving.py's `_assert_matches_oracle` (rtol=1e-6,
    atol=1e-6 per cell; the cache merges partial sums), by token; returns
    the sum cells whose bits differ and their largest difference in ulps."""
    if (got.t0_ms, got.window_ms, got.n_windows) != \
            (ref.t0_ms, ref.window_ms, ref.n_windows):
        raise AssertionError(f"{what}: geometry differs")
    gt, rt = (np.asarray(r.key_tokens, object) for r in (got, ref))
    g, r = np.argsort(gt, kind="stable"), np.argsort(rt, kind="stable")
    if not np.array_equal(gt[g], rt[r]):
        raise AssertionError(f"{what}: key tokens differ")
    n = got.n_windows
    for f in ("count", "sum", "mean", "min", "max"):
        a = getattr(got.stats, f).numpy()[g, :n]
        b = getattr(ref.stats, f).numpy()[r, :n]
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=f"{what} {f}")
    a = got.stats.sum.numpy()[g, :n].view(np.int32).astype(np.int64)
    b = ref.stats.sum.numpy()[r, :n].view(np.int32).astype(np.int64)
    return int((a != b).sum()), int(np.abs(a - b).max()) if a.size else 0


def segsum_vs_plain(dev, call, plain_reps=5, plain_warmup=3):
    """The segment-sum kernel at the inputs the main path gave it, against
    its plain version on the card (bit for bit), timed with CUDA events
    beside its bound and beside `index_add_` (one PyTorch call that sums
    the same segments, in no fixed order)."""
    from sitewhere_tpu_torch.ops.segsum import (
        segment_row_sum, segment_row_sum_plain)

    (values, offsets), _ = call
    got = segment_row_sum(values, offsets)
    ref = segment_row_sum_plain(values, offsets)
    differ = got.view(torch.int32) != ref.view(torch.int32)
    mism = int(differ.sum())
    err = float((got - ref)[differ].abs().max()) if mism else 0.0
    S, n = offsets.numel() - 1, values.numel()
    counts = (offsets[1:] - offsets[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(S, device=dev), counts,
                                  output_size=n)
    moved = n * 4 + (S + 1) * offsets.element_size() + S * 4
    bytes_ms = moved / H100_HBM_BYTES_S * 1e3
    ops_ms = n / H100_F32_FLOPS * 1e3
    longest = int(counts.max())
    clock_mhz = sm_clock_mhz()
    return {
        "rows": n, "segments": S, "offset_bytes": offsets.element_size(),
        "longest_segment": longest,
        # a bit-equal fold adds a segment's rows one after another
        "chain_floor_ms": longest * FADD_LATENCY_CYCLES / clock_mhz / 1e3,
        "chain_floor_basis": f"{longest} adds x {FADD_LATENCY_CYCLES} "
                             f"cycles at {clock_mhz} MHz (clocks.max.sm)",
        "mismatches": mism, "max_abs_err": err,
        "ms": time_cuda(lambda: segment_row_sum(values, offsets)),
        "plain_ms": time_cuda(lambda: segment_row_sum_plain(values, offsets),
                              reps=plain_reps, warmup=plain_warmup),
        "library_ms": time_cuda(lambda: torch.zeros(
            S, device=dev).index_add_(0, seg, values)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": moved}


def window_ops_vs_plain(dev, calls, card):
    """(a): the device ops at the monolithic query's own inputs, on the card
    against the CPU (every cell bit-equal), timed with CUDA events beside
    the bound of their bytes; the segment-sum kernel of the sum grid
    against its plain version; then the adversarial fixture with a hot cell
    of HOT_ROWS rows, where the kernel is timed again."""
    import sitewhere_tpu_torch.analytics.windows as windows_mod
    from sitewhere_tpu_torch.analytics.windows import (
        event_type_histogram, windowed_stats)

    out = {}
    for name, fn, (args, kw) in (("windowed_stats", windowed_stats,
                                  calls["windowed_stats"]),
                                 ("event_type_histogram",
                                  event_type_histogram,
                                  calls["event_type_histogram"])):
        got = fn(*args, **kw)
        t0 = time.perf_counter()
        ref = fn(*(a.cpu() for a in args), **{**kw, "device": "cpu"})
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if name == "windowed_stats":
            bad = stats_mismatches(got, ref)
            cells = got.count.numel()
        else:
            bad = {"count": int((got.cpu() != ref).sum())}
            cells = got.numel()
        if any(bad.values()):
            raise AssertionError(f"{name} on the card differs from the CPU "
                                 f"at the query's shapes: {bad}")
        rows = args[0].numel()
        in_bytes = sum(a.element_size() for a in args) * rows
        out_bytes = cells * (20 if name == "windowed_stats" else 4)
        ms = time_cuda(lambda: fn(*args, **kw), reps=10, warmup=2)
        bound_ms = (in_bytes + out_bytes) / H100_HBM_BYTES_S * 1e3
        out[name] = {"rows": rows, "cells": cells, "ms": ms,
                     "cpu_ms": cpu_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "bound_share": bound_ms / ms,
                     "bytes": in_bytes + out_bytes, "library_ms": None,
                     "mismatches": sum(bad.values())}
    keys, ts, value, valid = adversarial_window_rows(
        SEED + 90, ADVERSARIAL_ROWS, ADVERSARIAL_KEYS, READ_WINDOWS,
        READ_WINDOW_MS, hot_rows=HOT_ROWS)
    kw = dict(window_ms=READ_WINDOW_MS, num_keys=ADVERSARIAL_KEYS,
              n_windows=READ_WINDOWS)
    dev_args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (keys, ts.astype(np.int32), value, valid)]
    t0 = time.perf_counter()
    with _Wrapped(windows_mod, ("segment_row_sum",)) as kernels:
        got = windowed_stats(*dev_args, device=dev, **kw)
        torch.cuda.synchronize()
        adv_ms = (time.perf_counter() - t0) * 1e3
        hot_call = kernels.first["segment_row_sum"]
    ref = windowed_stats(keys, ts, value, valid, device="cpu", **kw)
    bad = stats_mismatches(got, ref)
    hist_kw = dict(window_ms=READ_WINDOW_MS, n_types=8,
                   n_windows=READ_WINDOWS)
    hbad = int((event_type_histogram(dev_args[0], dev_args[1], dev_args[3],
                                     device=dev, **hist_kw).cpu()
                != event_type_histogram(keys, ts, valid, device="cpu",
                                        **hist_kw)).sum())
    hot = int(ref.count.max())
    if any(bad.values()) or hbad or hot < HOT_ROWS:
        raise AssertionError(f"adversarial fixture: card != CPU {bad}, "
                             f"histogram {hbad}, hot cell {hot} rows")
    out["segment_row_sum"] = segsum_vs_plain(dev, calls["segment_row_sum"])
    # the plain version takes one step per row of the hot cell: timed once
    hot_kernel = segsum_vs_plain(dev, hot_call, plain_reps=1, plain_warmup=0)
    if out["segment_row_sum"]["mismatches"] or hot_kernel["mismatches"]:
        raise AssertionError(f"segment-sum kernel != its plain version: "
                             f"{out['segment_row_sum']}, hot {hot_kernel}")
    out["adversarial"] = {"rows": len(keys), "hot_cell_rows": hot,
                          "nan_sums": int(torch.isnan(ref.sum).sum()),
                          "card_ms_host_clock": adv_ms,
                          "segment_row_sum": hot_kernel,
                          "mismatches": 0}
    log(f"[read] (a) device ops on the card == the CPU, every cell's bits "
        f"(sum and mean by the row-order fold: route 'bits'): "
        f"{json.dumps(out)} on {card}")
    return out


class _Wrapped:
    """While installed, module functions (by name) record their summed host
    seconds (`seconds`) and their first call's arguments (`first`)."""

    def __init__(self, module, names):
        self.module = module
        self.fns = {n: getattr(module, n) for n in names}
        self.seconds = {n: 0.0 for n in names}
        self.first = {}

    def __enter__(self):
        for name, fn in self.fns.items():
            def wrapper(*args, _fn=fn, _name=name, **kw):
                self.first.setdefault(_name, (args, kw))
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0

            setattr(self.module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, fn in self.fns.items():
            setattr(self.module, name, fn)
        self.first.clear()


def monolithic_query(dev, rlog, card):
    """(b): measurement_windows with the histogram over the whole log on a
    card engine (2 timed runs after one) and a CPU engine; every output
    bit-equal. Returns the card report, the ops' captured calls and the
    readings."""
    import sitewhere_tpu_torch.analytics.engine as engine_mod
    import sitewhere_tpu_torch.analytics.windows as windows_mod
    from sitewhere_tpu_torch.analytics import WindowedAnalyticsEngine

    kw = dict(window_ms=READ_WINDOW_MS, with_type_histogram=True)
    card_engine = WindowedAnalyticsEngine(rlog.log, device=dev)
    with _Wrapped(engine_mod, ("windowed_stats", "event_type_histogram")) \
            as ops, _Wrapped(windows_mod, ("segment_row_sum",)) as kernels:
        card_engine.measurement_windows(READ_TENANT, **kw)
        calls = {**ops.first, **kernels.first}
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        report = card_engine.measurement_windows(READ_TENANT, **kw)
        runs.append({"wall_s": time.perf_counter() - t0,
                     **{k + "_s": v for k, v in report.timings.items()}})
    t0 = time.perf_counter()
    ref = WindowedAnalyticsEngine(rlog.log, device="cpu") \
        .measurement_windows(READ_TENANT, **kw)
    cpu = {"wall_s": time.perf_counter() - t0,
           **{k + "_s": v for k, v in ref.timings.items()}}
    assert_reports_bits_equal(report, ref, "monolithic query card vs CPU")
    totals = report.totals()
    if totals["events"] != rlog.cum[-1] or \
            report.num_keys != int(rlog.devices.sum()):
        raise AssertionError(f"monolithic query: {totals['events']} events "
                             f"over {report.num_keys} keys; expected "
                             f"{rlog.cum[-1]} over {int(rlog.devices.sum())}")
    readings = {"rows": rlog.rows, "measurements": rlog.cum[-1],
                "keys": report.num_keys, "K": report.stats.num_keys,
                "W": report.stats.num_windows,
                "n_windows": report.n_windows, "card_runs": runs,
                "cpu_run": cpu,
                "hist_rows": int(report.type_counts.sum())}
    log(f"[read] (b) monolithic query, card == CPU (keys, tokens, every "
        f"grid's bits, histogram): {json.dumps(readings)} on {card}")
    return report, calls, readings


class _SnapshotView:
    """A tenant log frozen at a watermark: the first `w` sealed segments,
    and the tail a reader saw (or none)."""

    def __init__(self, epoch, segments, pending):
        self.snap = (epoch, segments, pending)

    def sealed_snapshot(self):
        return self.snap


def run_clients(ex, query, n_clients, min_queries, rlog=None, queries=None,
                hold=None):
    """`n_clients` synchronous clients sending `query` (client c sends
    queries[c % len(queries)] when given) until every client has finished
    `min_queries` queries (and `hold` is set, when given), while a writer
    seals a chunk every READ_WRITER_PERIOD_S when `rlog` is given. Queries
    in flight when the last client reaches its count finish and count.
    Returns per-client samples (latency, route, cache hit, watermark,
    measurements), sheds, the chunks sealed, client 0's last result, and
    the wall from the first send to the last completion."""
    from sitewhere_tpu_torch.serving.executor import QueryShedError

    stop = threading.Event()
    errors, sheds, sealed = [], [0], []
    samples = [[] for _ in range(n_clients)]
    keep = {}
    short = [n_clients]
    lock = threading.Lock()
    ends = []

    def client(c):
        q = queries[c % len(queries)] if queries else query
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    out = ex.query(q, timeout=600.0)
                except QueryShedError:
                    sheds[0] += 1
                    continue
                done = time.perf_counter()
                info = out["info"]
                total = int(out["report"].stats.count.sum())
                samples[c].append((done - t0, out["span"]["route"],
                                   bool(info.get("cache_hit")),
                                   info.get("watermark"), total))
                if c == 0 and rlog is not None:
                    keep["last"] = (info["watermark"], total, out["report"])
                out = None
                with lock:
                    ends.append(done)
                    if len(samples[c]) == min_queries:
                        short[0] -= 1
                        if short[0] == 0:
                            everyone.set()
        except Exception as exc:
            errors.append(exc)
            everyone.set()

    def writer():
        try:
            while not stop.wait(READ_WRITER_PERIOD_S):
                sealed.append(rlog.seal_next())
        except Exception as exc:
            errors.append(exc)
            everyone.set()

    everyone = threading.Event()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    if rlog is not None:
        threads.append(threading.Thread(target=writer, daemon=True))
    t_first = time.perf_counter()
    for t in threads:
        t.start()
    everyone.wait(900.0)
    if hold is not None:
        hold.wait(600.0)
    stop.set()
    for t in threads:
        t.join(900.0)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a serving client or the writer did not stop")
    if errors:
        raise errors[0]
    if not everyone.is_set():
        raise AssertionError(f"{n_clients} clients: {short[0]} did not "
                             f"finish {min_queries} queries")
    return samples, sheds[0], sealed, keep, max(ends) - t_first


def check_no_tears(rlog, samples):
    """Per client: watermarks never go down, and every result holds whole
    chunks: the measurements of its first `w` sealed chunks, or of those
    and the chunk a writer had appended but not yet sealed."""
    for obs in samples:
        marks = [s[3] for s in obs]
        if marks != sorted(marks):
            raise AssertionError("a client's watermark went down")
        for *_, w, total in obs:
            if total not in (rlog.cum[w], rlog.cum[min(w + 1,
                                                        len(rlog.cum) - 1)]):
                raise AssertionError(f"torn read: {total} measurements at "
                                     f"watermark {w}")


def serving_tier(dev, rlog, card):
    """(c): the executor, planner and cache over the log: cold, warm and a
    one-segment delta, each against the monolithic engine under the
    reference's tolerance; then READ_CLIENTS clients against a sealing
    writer, with spot checks of results against a cold query at their
    watermark."""
    from sitewhere_tpu_torch.analytics import WindowedAnalyticsEngine
    from sitewhere_tpu_torch.serving import (
        QueryExecutor, QueryPlanner, WindowGridCache, WindowQuery)
    from sitewhere_tpu_torch.serving import wincache

    epoch = rlog.packer.epoch_base_ms
    lo, hi = epoch, epoch + READ_WINDOWS * READ_WINDOW_MS - 1
    query = WindowQuery(tenant=READ_TENANT, window_ms=READ_WINDOW_MS,
                        start_ms=lo, end_ms=hi)
    planner = QueryPlanner(rlog.log)
    cache = WindowGridCache(max_bytes=READ_CACHE_BYTES)
    engine = WindowedAnalyticsEngine(rlog.log, planner=planner, device=dev)
    ex = QueryExecutor(engine, planner, cache, workers=READ_WORKERS,
                       queue_depth_budget=READ_DEPTH)
    readings = {}

    def mono():
        return engine.measurement_windows(
            READ_TENANT, window_ms=READ_WINDOW_MS, start_ms=lo, end_ms=hi)

    try:
        oracle = mono()
        for step in ("cold", "warm", "delta"):
            if step == "cold":
                cache.invalidate()
            if step == "delta":
                rlog.seal_next()
                oracle = mono()
            with _Wrapped(wincache, ("_gather", "_fold_rows", "_merge",
                                     "_finalize")) as parts:
                t0 = time.perf_counter()
                out = ex.query(query)
                wall = time.perf_counter() - t0
            bits, ulps = assert_matches_oracle(out["report"], oracle,
                                               f"{step} query")
            readings[step] = {"wall_s": wall, "route": out["span"]["route"],
                              "parts_s": parts.seconds,
                              "sum_cells_not_bit_equal": bits,
                              "sum_max_ulps": ulps, **out["info"]}
        if (readings["cold"]["cache_hit"], readings["warm"]["cache_hit"],
                readings["delta"]["cache_hit"]) != (False, True, True) or \
                readings["delta"]["delta_segments"] != 1 or \
                readings["delta"]["delta_rows"] != \
                rlog.cum[-1] - rlog.cum[-2]:
            raise AssertionError(f"cache steps: {readings}")
        log(f"[read] (c) serving, each == the monolithic query (rtol=1e-6, "
            f"atol=1e-6): {json.dumps(readings)} on {card}")

        load = {}
        spot = []
        for n_clients in READ_CLIENTS:
            shed0 = ex.shed_counter.value
            samples, sheds, sealed, keep, wall = run_clients(
                ex, query, n_clients, READ_MIN_QUERIES, rlog=rlog)
            check_no_tears(rlog, samples)
            lat = [s[0] for obs in samples for s in obs]
            load[n_clients] = {
                "queries": len(lat),
                "least_per_client": min(len(obs) for obs in samples),
                "wall_s": wall, "qps": len(lat) / wall,
                "p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3),
                "p99_of_samples": len(lat),
                "cache_hit_pct": 100.0 * sum(s[2] for obs in samples
                                             for s in obs) / len(lat),
                "sheds": sheds, "shed_counter": ex.shed_counter.value - shed0,
                "chunks_sealed": len(sealed)}
            log(f"[read] (c) {n_clients} clients: "
                f"{json.dumps(load[n_clients])} on {card}")
            spot.append(keep["last"])
        segments = rlog.segments()
        for w, total, report in spot:
            pending = segments[w] if total != rlog.cum[w] else None
            cold = WindowGridCache().query(
                _SnapshotView(0, segments[:w], pending), tenant=READ_TENANT,
                flt=query.filter(), window_ms=READ_WINDOW_MS, start_ms=lo,
                end_ms=hi, max_windows=query.max_windows, device=dev)[0]
            assert_matches_oracle(report, cold, f"result at watermark {w}")
        log(f"[read] (c) clients against a writer sealing a chunk every "
            f"{READ_WRITER_PERIOD_S} s, each client at least "
            f"{READ_MIN_QUERIES} queries, qps over the wall from the first "
            f"send to the last completion: no torn read, watermarks "
            f"monotonic, {len(spot)} spot results == a cold query at their "
            f"watermark: {json.dumps(load)} on {card}")
        readings["clients"] = load
        readings["cache"] = ex.report()["cache"]
        return ex, query, readings
    except Exception:
        ex.stop()
        raise


def reads_beside_the_step(dev, ex, query, main_ref, card):
    """(d): while READ_BESIDE_CLIENTS clients query (half the dashboard
    query, half an open-range query that runs the device ops on the card),
    a fresh phase 3 engine runs phase 3's first READ_BESIDE_STEPS batches:
    its first steps capture its graph. Its alerts equal phase 3's, its
    canonical state that of phase 3's world run alone on the same batches;
    one capture, B1 once per step, and its graph's pool as large as the
    alone engine's."""
    from sitewhere_tpu_torch.runtime import hbmledger
    from sitewhere_tpu_torch.serving import WindowQuery

    batches = main_ref["batches"][:READ_BESIDE_STEPS]
    alone = build_world(dev, "auto", main_ref["epoch_base_ms"])
    t0 = time.perf_counter()
    run_trace(alone, batches)
    alone_wall_s = time.perf_counter() - t0
    pool_alone = hbmledger.table_bytes(alone)["step_graphs"]
    state_alone = alone.canonical_state()
    del alone
    open_range = WindowQuery(tenant=READ_TENANT, window_ms=READ_WINDOW_MS)
    box, done = {}, threading.Event()

    def step_side():
        try:
            engine = build_world(dev, "auto", main_ref["epoch_base_ms"])
            reset_launch_counts(engine)
            t0 = time.perf_counter()
            _, alerts = run_trace(engine, batches)
            box.update(engine=engine, alerts=alerts,
                       wall_s=time.perf_counter() - t0,
                       launches=launch_counts(engine)["points_in_zones"])
        except Exception as exc:
            box["error"] = exc
        finally:
            done.set()

    # the world build takes seconds: the clients are querying by the time
    # the engine's first steps run and capture
    stepper = threading.Thread(target=step_side, daemon=True)
    ex_queries0 = ex.report()["queries"]
    stepper.start()
    samples, sheds, _, _, _ = run_clients(
        ex, query, READ_BESIDE_CLIENTS, 1, queries=[query, open_range],
        hold=done)
    stepper.join(600.0)
    if "error" in box:
        raise box["error"]
    if stepper.is_alive() or "engine" not in box:
        raise AssertionError("the stepping engine did not finish")
    engine = box["engine"]
    if box["alerts"] != main_ref["alerts"][:len(batches)]:
        raise AssertionError("alerts differ from phase 3's beside reads")
    assert_tree_bits_equal(state_alone, engine.canonical_state(),
                           "state beside reads")
    pool = hbmledger.table_bytes(engine)["step_graphs"]
    readings = {
        "graph_captures": engine.graph_captures,
        "b1_launches": box["launches"], "steps": len(batches),
        "step_wall_s": box["wall_s"], "step_wall_alone_s": alone_wall_s,
        "graph_pool_bytes": pool,
        "graph_pool_bytes_alone": pool_alone,
        "queries_during": ex.report()["queries"] - ex_queries0,
        "open_range_queries": sum(len(obs) for obs in samples[1::2]),
        "sheds": sheds}
    if engine.graph_captures != 1 or box["launches"] != len(batches) or \
            pool != pool_alone or not readings["open_range_queries"]:
        raise AssertionError(f"reads beside the step: {readings}")
    log(f"[read] (d) a fresh engine captured and stepped beside "
        f"{READ_BESIDE_CLIENTS} querying clients: alerts and state == "
        f"phase 3's: {json.dumps(readings)} on {card}")
    return readings


def _replay_loop_oracle(bus, naming, tenant, group_id, device):
    """bench.py's `_replay_loop_oracle` on the port: unpack_enriched per
    record, per-row dict interning and list appends, then the same
    `_build_report`."""
    from sitewhere_tpu_torch.analytics.engine import WindowedAnalyticsEngine
    from sitewhere_tpu_torch.model.event import DeviceEventType
    from sitewhere_tpu_torch.pipeline.enrichment import unpack_enriched

    consumer = bus.consumer(naming.inbound_enriched_events(tenant), group_id)
    consumer.seek_to_beginning()
    key_of, keys, dates, values = {}, [], [], []
    while True:
        batch = consumer.poll(8192)
        if not batch:
            break
        for record in batch:
            try:
                _, event = unpack_enriched(record.value)
            except Exception:
                continue
            if event.event_type != DeviceEventType.MEASUREMENT:
                continue
            token = event.device_id or ""
            keys.append(key_of.setdefault(token, len(key_of)))
            dates.append(event.event_date)
            values.append(getattr(event, "value", 0.0) or 0.0)
    return WindowedAnalyticsEngine._build_report(
        np.asarray(keys, np.int64), np.asarray(dates, np.int64),
        np.asarray(values, np.float32), window_ms=60_000, start_ms=None,
        end_ms=None, max_windows=4096, device=device, tokens=list(key_of))


def bus_replay(dev, epoch, card):
    """(e): REPLAY_RECORDS enriched measurements of REPLAY_DEVICES devices
    on a 2-partition bus (bench.py _build_serving) replayed on the card ==
    on the CPU, and its totals and tokens == the per-record loop's."""
    from sitewhere_tpu_torch.analytics import BusReplayAnalytics
    from sitewhere_tpu_torch.model.event import (
        DeviceEventContext, DeviceMeasurement)
    from sitewhere_tpu_torch.pipeline.enrichment import pack_enriched
    from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming

    bus, naming = EventBus(partitions=2), TopicNaming()
    topic = naming.inbound_enriched_events(READ_TENANT)
    values = np.random.default_rng(77).uniform(0, 100, REPLAY_RECORDS)
    context = DeviceEventContext(device_id="d", device_token="d",
                                 tenant_id=READ_TENANT)
    for i in range(REPLAY_RECORDS):
        token = f"dev-{i % REPLAY_DEVICES}"
        bus.publish(topic, token.encode(), pack_enriched(
            context, DeviceMeasurement(name="m1", value=float(values[i]),
                                       device_id=token, event_date=epoch + i)))
    replay = BusReplayAnalytics(bus, naming, device=dev)
    replay.replay_measurements(READ_TENANT, group_id="warm")
    t0 = time.perf_counter()
    got = replay.replay_measurements(READ_TENANT, group_id="card")
    card_s = time.perf_counter() - t0
    ref = BusReplayAnalytics(bus, naming, device="cpu").replay_measurements(
        READ_TENANT, group_id="cpu")
    assert_reports_bits_equal(got, ref, "bus replay card vs CPU")
    t0 = time.perf_counter()
    oracle = _replay_loop_oracle(bus, naming, READ_TENANT, "oracle", dev)
    loop_s = time.perf_counter() - t0
    if got.totals() != oracle.totals() or \
            got.key_tokens != oracle.key_tokens or \
            got.totals()["events"] != REPLAY_RECORDS:
        raise AssertionError("bus replay differs from the per-record loop")
    readings = {"records": REPLAY_RECORDS, "keys": got.num_keys,
                "replay_s": card_s, "events_per_s": REPLAY_RECORDS / card_s,
                "loop_oracle_s": loop_s,
                "loop_events_per_s": REPLAY_RECORDS / loop_s}
    log(f"[read] (e) bus replay on the card == on the CPU, totals and tokens "
        f"== the per-record loop: {json.dumps(readings)} on {card}")
    return readings


def widerow_query(dev, rlog, card):
    """(f): a tenant on WideRowEventStore (sqlite in a temp directory): one
    batch through append_batch, then measurement_windows on the card ==
    on the CPU."""
    import os

    from sitewhere_tpu_torch.analytics import WindowedAnalyticsEngine
    from sitewhere_tpu_torch.persist.widerow import WideRowEventStore

    with tempfile.TemporaryDirectory() as tmp:
        store = WideRowEventStore(db_path=os.path.join(tmp, "events.db"))
        try:
            t0 = time.perf_counter()
            n = store.append_batch(READ_TENANT, rlog.chunk(0), rlog.packer)
            append_s = time.perf_counter() - t0
            kw = dict(window_ms=READ_WINDOW_MS, with_type_histogram=True)
            WindowedAnalyticsEngine(store, device=dev).measurement_windows(
                READ_TENANT, **kw)
            t0 = time.perf_counter()
            got = WindowedAnalyticsEngine(store, device=dev) \
                .measurement_windows(READ_TENANT, **kw)
            query_s = time.perf_counter() - t0
            ref = WindowedAnalyticsEngine(store, device="cpu") \
                .measurement_windows(READ_TENANT, **kw)
        finally:
            store.stop()
    assert_reports_bits_equal(got, ref, "wide-row query card vs CPU")
    if n != BATCH or got.totals()["events"] != rlog.cum[1]:
        raise AssertionError(f"wide-row store: {n} rows appended, "
                             f"{got.totals()['events']} measurements read")
    readings = {"rows": n, "append_s": append_s, "query_s": query_s,
                "keys": got.num_keys, **{k + "_s": v for k, v in
                                         got.timings.items()}}
    log(f"[read] (f) wide-row tenant, card == CPU: {json.dumps(readings)} "
        f"on {card}")
    return readings


def chatty_query(dev, rlog, card):
    """An hourly dashboard over chatty devices: CHATTY_CHUNKS of phase 3's
    batches, each chunk's device indices folded onto 1..CHATTY_DEVICES and
    the chunks spread over one hour, queried in hourly windows, so that a
    cell holds thousands of rows. measurement_windows on the card == on
    the CPU (every grid's bits); walls and the longest cell."""
    from sitewhere_tpu_torch.analytics import WindowedAnalyticsEngine
    from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog

    chatty = ColumnarEventLog(segment_rows=READ_SEGMENT_ROWS)
    for i in range(CHATTY_CHUNKS):
        b = rlog.batches[i % len(rlog.batches)]
        chatty.append_batch(CHATTY_TENANT, dataclasses.replace(
            b, device_idx=torch.where(
                b.device_idx > 0, (b.device_idx - 1) % CHATTY_DEVICES + 1,
                b.device_idx),
            ts=b.ts + i * (HOUR_MS // CHATTY_CHUNKS)), rlog.packer)
        chatty.flush_tenant(CHATTY_TENANT)
    kw = dict(window_ms=HOUR_MS, with_type_histogram=True)
    engine = WindowedAnalyticsEngine(chatty, device=dev)
    engine.measurement_windows(CHATTY_TENANT, **kw)
    t0 = time.perf_counter()
    got = engine.measurement_windows(CHATTY_TENANT, **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = WindowedAnalyticsEngine(chatty, device="cpu").measurement_windows(
        CHATTY_TENANT, **kw)
    cpu_s = time.perf_counter() - t0
    assert_reports_bits_equal(got, ref, "hourly chatty query card vs CPU")
    longest = int(got.stats.count.max())
    if got.num_keys != CHATTY_DEVICES or got.n_windows != 1:
        raise AssertionError(f"chatty query: {got.num_keys} keys, longest "
                             f"cell {longest} rows")
    readings = {"measurements": got.totals()["events"],
                "keys": got.num_keys, "n_windows": got.n_windows,
                "longest_cell_rows": longest, "card_wall_s": card_s,
                "cpu_wall_s": cpu_s,
                **{k + "_s": v for k, v in got.timings.items()}}
    log(f"[read] hourly windows over {CHATTY_DEVICES} chatty devices, card "
        f"== CPU: {json.dumps(readings)} on {card}")
    return readings


def phase_read_side(dev, card, main_ref):
    """The read side at full size. Its main path is the monolithic query
    (b) and the serving tier (c), driven with the segment-sum kernel's
    count set to 0 just before and read just after; then the device ops
    and the kernel against their plain versions (a), reads beside a
    capturing engine (d), the bus replay (e), a wide-row tenant (f) and an
    hourly query over chatty devices."""
    from sitewhere_tpu_torch.ops.segsum import segment_row_sum

    t_phase = time.perf_counter()
    rlog = ReadLog(main_ref["batches"],
                   read_side_packer(main_ref["epoch_base_ms"]))
    while rlog.rows < READ_ROWS:
        rlog.seal_next()
    cols = rlog.log.query_columns(READ_TENANT, _event_filter(),
                                  ["device_idx", "device_token"])
    if any(t != f"dev-{i}" for i, t in zip(cols["device_idx"][:1000],
                                          cols["device_token"][:1000])):
        raise AssertionError("the log's tokens are not phase 3's")
    log(f"[read] log: {len(rlog.cum) - 1} chunks sealed, {rlog.rows} rows, "
        f"{rlog.cum[-1]} measurements, in "
        f"{time.perf_counter() - t_phase:.1f} s")
    readings = {}
    segment_row_sum.launches = 0
    _, calls, readings["monolithic"] = monolithic_query(dev, rlog, card)
    ex, query, readings["serving"] = serving_tier(dev, rlog, card)
    readings["segment_row_sum_launches"] = segment_row_sum.launches
    if not segment_row_sum.launches:
        ex.stop()
        raise AssertionError("the read side's main path never launched the "
                             "segment-sum kernel")
    try:
        readings["ops"] = window_ops_vs_plain(dev, calls, card)
        readings["beside_step"] = reads_beside_the_step(dev, ex, query,
                                                        main_ref, card)
    finally:
        ex.stop()
    readings["bus_replay"] = bus_replay(dev, main_ref["epoch_base_ms"], card)
    readings["widerow"] = widerow_query(dev, rlog, card)
    readings["chatty"] = chatty_query(dev, rlog, card)
    readings["phase_s"] = time.perf_counter() - t_phase
    log(f"[read] phase took {readings['phase_s']:.1f} s")
    return readings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script measures "
              "the card and does not run on the CPU", file=sys.stderr)
        return 2
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, name = phase_card()
        shapes = phase_kernel_vs_plain(dev, card)
        engine, batches, summary, launches, alerts, state = \
            phase_main_path(dev, card)
        host_ms, _, main_prof = phase_breakdown(engine, batches, card)
        main_ref = {"batches": batches, "alerts": alerts, "state": state,
                    "epoch_base_ms": engine.packer.epoch_base_ms}
        del engine
        stateful, stateful_launches, stateful_prof, stateful_ref = \
            phase_stateful(dev, card, summary)
        phase_pipelined(dev, card, main_ref, stateful_ref, {
            "main": summary, "stateful": stateful, "host_ms": host_ms,
            "main_profile": main_prof, "stateful_profile": stateful_prof})
        _, durable_launches = phase_durable(dev, card, main_ref,
                                            stateful_ref)
        _, ingest_launches = phase_ingest(dev, card, main_ref)
        read = phase_read_side(dev, card, main_ref)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    main_shape = next(r for r in shapes if r["world"] == "main_z256")
    kernels = [{
        "name": "points_in_zones",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/geofence.cu",
        "replaces": "sitewhere_tpu/ops/pallas_geofence.py:63",
        "launches": launches["points_in_zones"],
        "launches_stateful_path": stateful_launches,
        "launches_durable_path": durable_launches,
        "launches_ingest_path": ingest_launches,
        "mismatches": sum(r["mismatches"] for r in shapes),
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": main_shape["kernel_ms"],
        "kernel_ms": main_shape["kernel_ms"],
        "queued_ms": main_shape["kernel_queued_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "bound_dense_ms": main_shape["bound_dense_ms"],
        "P_in": main_shape["P_in"],
        "library_ms": None,
        "shapes": shapes,
    }]
    segsum = read["ops"]["segment_row_sum"]
    kernels.append({
        "name": "segment_row_sum",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/segsum.cu",
        "replaces": "sitewhere_tpu/analytics/windows.py:63",
        "launches": read["segment_row_sum_launches"],
        **{k: segsum[k] for k in ("mismatches", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "rows", "segments",
                                  "longest_segment")},
        "hot_cell": {k: read["ops"]["adversarial"]["segment_row_sum"][k]
                     for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                               "chain_floor_ms", "chain_floor_basis",
                               "longest_segment")},
    })
    rule = stateful["rule_kernel"]
    kernels.append({
        "name": "eval_rule_programs",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/rule_programs.cu",
        "replaces": "sitewhere_tpu/ops/stateful.py:148",
        "launches": stateful["rule_kernel_launches"],
        **{k: rule[k] for k in ("mismatches", "max_abs_err", "ms",
                                "queued_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "rows",
                                "attach_rows", "programs", "nodes",
                                "state_slots", "steps_checked")},
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
