#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sitewhere_tpu_torch) on the card.

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
     of rows a cell), card equal to CPU. (g), after (c): the mesh route
     (parallel/distributed.py), the monolithic query with a SHARDS-shard
     mesh on the card under each combine ("psum", "ring"): counts, min and
     max equal the host route's (b), sums and means within the reference's
     rtol=1e-5, atol=1e-5; bit-equal to the same call with the segment
     sum's plain version and to the CPU on the first MESH_CPU_WINDOWS
     windows; an open-range query through an executor whose planner's
     provider answers the mesh routes "mesh" and is counted; then
     MESH_LOAD's 1 and 16 clients send it at once through READ_WORKERS
     workers, with the one-replay-a-card gate (latency, queries/s, peak
     device memory; the ungated run is cut); the segment-sum kernel's
     launches counted from
     0; the query's wall and split, the fold and each combine by CUDA
     events beside their byte bounds, and the peak device memory.
     `python3 chip_smoke.py --read-only` runs phase 3 and phase 9 (no
     result line).
 10. the instance behind `serve`, built by the CLI's config builder with
     the default configuration (capacity 131072, 256 zones x 32 vertices,
     batch 8192, 8 slots, 16 tenants) and a data dir: (a) 100,000 devices
     registered through the tenant's DeviceManagement, 64 more and an area
     of 256 zones, 16 threshold and 64 geofence rules, 32 rule programs, 8
     models and 8 policies over REST, on the card instance and on a CPU
     instance (no data dir), each with an MQTT command destination; (b)
     INSTANCE_PAYLOADS wire payloads of phase 3's traffic published over
     the in-process MQTT broker to an event source, back to back, the
     inbound consumer polling all along as under `serve`: the first
     INSTANCE_POLLED beside INSTANCE_CLIENTS REST pollers, the last ones
     under the profiler (launch counts from 0, one capture per static
     configuration); the CPU instance processes the card's decoded records
     in the card's step groups and must equal it (counts, alerts, counters,
     state and groups bit for bit; the same commands delivered, none
     parked); (c) a checkpoint, one payload past it,
     a restart on the data dir that restores and replays it: bit-equal, no
     duplicate rows; (d) `check` and `serve --port 0` in subprocesses as a
     user runs them. `python3 chip_smoke.py --instance-only` runs phase 10
     alone (no result line).
 11. the feeder fleet landing on the card and the control-plane cluster:
     FEEDER_RECORDS records of wire frames, one full batch of phase 3's
     traffic each (record r holds only devices of class r % FEEDER_CLASSES,
     so every device's events keep their order in any partitioning), on
     fresh phase 3 engines: (a) inline FastWireIngest + submit; (b) 1, 2
     and 4 FeederWorker threads over a busnet loopback into a
     FeederService (the first beside threads syncing their own streams,
     then FEEDER_PROFILED more blobs under the profiler); (c) two
     `python -m sitewhere_tpu_torch serve --feeder` processes; (d) a worker
     that dies between a blob's ack and its commit, and a successor at a
     higher epoch that replays the partition. Every landing: each record
     stepped exactly once with the inline run's blob and alerts
     (materialized in an on_outputs hook), one capture, B1 launched once a
     blob (counts set to 0 before each run and read after), flight records
     of h2d/dispatch/stage_wait/guard only, canonical state and presence
     transitions equal the inline run's; (d) counts replayed blobs dropped
     and a takeover. events/s, mesh_host_cpu_ms_per_step ("not
     measured" where the thread CPU clock's tick could be a tenth of it),
     step_ms_per_blob and handoff_ms_per_blob (bench.py's names, from the
     service's accounting less the hook's part) and the walls are
     printed. Then three `serve --cluster-peers ... --supervise`
     processes, each with its engine on the card in the default
     configuration, through tests/test_provisioning_cluster.py's drill,
     and host 0's cluster telemetry; boot walls, convergence times, the
     restart wall and the card's compute processes are printed.
     `python3 chip_smoke.py --feeders-only` runs phase 11 alone (no result
     line).
 12. the sharded path (parallel/engine.py ShardedPipelineEngine): SHARDS
     shards of phase 3's world on the card (per-shard batch BATCH //
     SHARDS), flat batches of SHARD_EVENTS events of phase 3's traffic in
     each wire layout (compact, full, packed), SHARD_WARMUP + SHARD_STEPS
     each, the first step of each layout first. (a) Host routing and
     device routing (the route inside the captured step, ops/route.py):
     each layout's first step held against the same engine on the CPU
     (outputs and state), every launch counted from 0 (B1 once a shard a
     step), one capture a static configuration, the route counters, and
     the whole run's alerts (sorted), state and presence transitions
     against phase 3's single engine on the card fed the same steps (alert
     lanes of SHARD_LANES a shard, which hold every fire); step p50/p99
     (submit until the card is done), the materialize time, events/s, the
     profiler's busy and idle share beside the single engine's, and the
     routing prologue alone (CUDA events). (b) phase 5's world sharded,
     SHARD_STATEFUL_STEPS steps, card == CPU (scores within the
     tolerance), the rule-program kernel once a shard a step. (c) an
     elastic checkpoint: SHARDS shards save, 4 shards and a single engine
     restore and continue equal. (d) the host router at its micro-bench's
     shape (native and numpy route_blob, route_columns, route_batch). (e)
     `serve --shards SERVE_SHARDS --feeders` in a subprocess: boot,
     SERVE_DEVICES events over the bus edge through the sharded step,
     every device's state read back over REST; then one `serve --feeder`
     process lands a wire frame a device (every state shows it), and a
     window query over REST (`serving.mesh_row_threshold` 1) takes the
     mesh route and answers what the port on the CPU answers. (f) the
     feeders' sharded landing: FeederWorker threads (LANDING_THREADS)
     over a busnet loopback into a FeederService over a device-routing
     sharded engine, FEEDER_RECORDS records of SHARD_EVENTS wire frames
     (classes of devices by d // SHARDS, so each shard's share stays
     even), then one skewed record (SHARD_SKEW_EVENTS frames of one
     device) that the worker's guard sends down the counted spill: each
     record stepped once with the inline run's flat blob and lanes, one
     capture a static configuration, B1 SHARDS launches a record (counts
     from 0), state and presence transitions equal the inline run's;
     events/s and the handoff a blob under phase 11's names.
     `python3 chip_smoke.py --sharded-only` runs phase 12 alone (no
     result line).
 13. the multi-host data plane (parallel/cluster.py, the engine on a
     multi-process mesh): two child processes (`--cluster-child`, every
     kernel built by the parent first, each child killed at its deadline)
     join a world over a TCP store on 127.0.0.1, SHARDS shards of phase
     12's world, SHARDS / 2 a process, laid out by the visible cards
     (`cluster_layout`): with four or more, each child sees two of them
     (CUDA_VISIBLE_DEVICES) and holds its shards in two card blocks, and
     the collectives go over NCCL; with two or three, one card each, NCCL;
     with one, both on cuda:0 in two blocks each, over gloo (a line says
     NCCL was not exercised). Each child prints its cards and backend.
     (a) Each feeds its ClusterStepLoop CLUSTER_EVENTS events a tick
     (CLUSTER_WARMUP + CLUSTER_TICKS + CLUSTER_PROFILED ticks) of the
     devices whose rows enter through it ((d // S) % 2: for half of them
     not the owner); the other host's rows come back through
     take_foreign, go over the bus edge and fold on their owner; then the
     drain and the stop vote. Each host's local blocks are bit-equal to a
     single-process SHARDS-shard engine (host route, full layout) fed
     every tick's whole batch, the alerts of both set-equal to its,
     `processed` the same global total on both and equal to the rows fed,
     every forwarded row folded once, B1 S/2 launches a tick a host and
     S/(2K) on each of its K cards (counted from the loop's start to its
     stop), one capture a card a host. The tick walls, the all_reduce and
     vote times and `processed` come from the loop's, the control's and
     the engine's own counters (`CollectiveClock`: the all_reduce by card
     events over NCCL, by the host clock over gloo; the vote by the host
     clock). Printed: tick wall p50/p99, events/s over both, the
     all_reduce and the vote a tick (mean, p50, p99), rows forwarded and
     the lag from the forwarding tick to the folding one, host 0's device
     busy and idle per card over the profiled ticks and the host copies
     inside its all_reduces of the sums (none over NCCL, or the phase
     fails). (d) Both call
     sharded_windowed_stats on CLUSTER_QUERY_ROWS rows (K, W =
     CLUSTER_QUERY_K, CLUSTER_QUERY_W) under psum and ring: identical
     grids on both, equal to the single-process call on the card and to it
     with the segment sum's plain version; the fold (per card), the
     all-gather and the combine beside their byte bounds. (c) Each saves
     its host-shards checkpoint, then folds records past it from its bus;
     over NCCL host 0 then enters its next tick, which blocks in the
     collective; host 1 is
     killed and host 0's watchdog must exit 13 within CLUSTER_FAIL_AFTER_S
     of the kill (plus its CLUSTER_WATCHDOG_CHECK_S check and the last
     heartbeat's delivery): it fires that long after the last heartbeat it
     received; both boot again, restore
     (blocks bit-equal to the save) and replay (blocks bit-equal to
     before the kill); write_assembled of the two checkpoints restores
     onto a single-process engine bit-equal to (a)'s reference. (b) Two
     `serve --cluster-coordinator` processes of SHARDS shards, each seeing
     the cards of its (a) child (the one card when only one is visible;
     each banner's cards and backend checked), the same world provisioned
     on each over REST, SERVE_CLUSTER_RECORDS records
     published to each host's edge for its peer's devices: each folds on
     its owner, its threshold alert persists there and reads back over the
     owner's REST API; both exit 0 on SIGTERM. `python3 chip_smoke.py
     --cluster-only` runs phase 13 alone (no result line).
 14. the shard axis over several cards (parallel/mesh.py card blocks,
     parallel/engine.py one captured step a card, ops/route.py's exchange
     between cards): phase 12's world on a mesh of K cards, every visible
     card when there are two or more, else K = 2 blocks on cuda:0
     (`devices=("cuda:0", "cuda:0")`, said on its own line; peer copies
     and launches on a second card are then not exercised). (a) The
     K-card engine and the one-card SHARDS-shard engine over phase 12's
     schedule, host route then device route: every step's outputs, every
     block of every state group, the alerts (set-equal, or the lanes'
     digest) and `processed` bit-equal; step p50 / p99 and events/s of
     both; B1 S/K replay launches a card a step and one capture a card a
     layout; the exchange's copies and the sums' gather alone (host ms,
     the cards waited for); device busy and idle per card over
     MULTI_PROFILED steps (profiler); peak memory per card. (b) Phase 5's
     world over the cards beside the one-card engine, MULTI_STATEFUL_STEPS
     steps: alerts, fires, every group equal; rule-program launches per
     card. (c) The K-card save restored on one card, that engine's save
     restored on K fresh cards, bit-equal. (d) Phase 9 (g)'s mesh query
     at its size over the cards beside the one-card mesh, both combines:
     counts and the sum, mean, min, max bits equal; each card's fold, the
     gather and the combine; segment-sum launches per card. (e) With two
     or more visible cards, `serve --shards 8` over them takes a few
     payloads and answers device-state reads. `python3 chip_smoke.py
     --multicard-only` runs phase 14 alone (no result line).
The last lines are the kernels' JSON line, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import pickle
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
# (g): the mesh route's tolerance against the host route (the reference's
# own, tests/test_distributed.py), and the windows of its CPU check
MESH_TOL = 1e-5
MESH_CPU_WINDOWS = 2
# (g)'s load: (clients, whether the one-replay-a-card gate is on), each
# client at least one open-range query through READ_WORKERS workers. The
# ungated 16-client run is cut, so that the script with phase 13 stays
# inside its time (its finding, the gate cut the peak 3.2-4.1x, is in
# PERF.md §6)
MESH_LOAD = ((1, True), (16, True))
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
                n_zones=N_ZONES, n_verts=N_VERTS, batch=BATCH, shards=0,
                mesh=None, **engine_kw):
    """Phase 3's world (the sizes are keywords so the card tests can build
    it small): registry, zones, threshold and geofence rules, a started
    engine on `dev`. With `shards`, the engine is a ShardedPipelineEngine
    of that many shards on `dev`, `batch` events a flat batch
    (per-shard batch `batch // shards`), over `mesh` when one is given
    (a multi-process mesh: this process's block of its shards)."""
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
    kw = dict(measurement_slots=MEASUREMENT_SLOTS,
              max_tenants=MAX_TENANTS, max_threshold_rules=MAX_RULES,
              max_geofence_rules=MAX_RULES,
              presence_missing_interval_ms=PRESENCE_MS,
              geofence_impl=geofence_impl, **engine_kw)
    if shards:
        from sitewhere_tpu_torch.parallel import (
            ShardedPipelineEngine, make_mesh)
        engine = ShardedPipelineEngine(
            reg, mesh=mesh if mesh is not None
            else make_mesh(shards, device=dev),
            per_shard_batch=batch // shards, **kw)
    else:
        engine = PipelineEngine(reg, batch_size=batch, device=dev, **kw)
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


def device_profile(fn):
    """Run fn() under the profiler, the card synchronized before and after:
    (wall ms, the profiler's key averages, those of device events, device
    busy ms, idle share). Busy time sums the device events (kernels,
    copies, memsets) once each; without device events busy and idle are
    "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    if not busy_ms:
        return wall_ms, events, on_device, "not measured", "not measured"
    return wall_ms, events, on_device, busy_ms, 1 - busy_ms / wall_ms


def profile_engine(engine, batches, n_prof=5):
    """The profiler over `n_prof` engine steps (submit + materialize): the
    device's busy time against the wall, its idle share, the device events
    (kernels, copies, memsets) launched, and the ops that take the device
    time, per step. The profiler also books each kernel's time under the
    op that launched it, so a sum over all events counts it twice; earlier
    versions of this script reported that sum as busy time, and it is
    printed beside as `all_events_sum_ms_per_step` for comparison with
    their records. Under the captured step the launching op is the graph
    replay, so the device kernels are also listed by their own names, and
    the geofence kernel's device events are counted
    (`b1_device_events_per_step`)."""
    from torch.autograd import DeviceType

    def steps():
        for batch in batches[:n_prof]:
            engine.materialize_alerts(*engine.submit_routed(batch))

    wall_ms, events, on_device, busy_ms, idle = device_profile(steps)
    engine.take_command_fires()
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    kernels = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "steps": n_prof, "wall_ms_per_step": wall_ms / n_prof,
        "device_busy_ms_per_step": (busy_ms / n_prof
                                    if busy_ms != "not measured" else busy_ms),
        "device_idle_share": idle,
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
        view, out = engine.submit_routed(batch)
        got = engine.materialize_alerts(view, out)
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

def encode_delivery(rng, epoch, n_registered, batch, n_control,
                    device_class=None, class_stride=1):
    """One delivery's wire bytes: `batch` hot frames of the headline traffic
    (the 60/30/10 mix, values U(0,100), lat/lon in the box, ts within 1 s
    of the epoch, INGEST_UNKNOWN of them from tokens the registry does not
    hold) and `n_control` REGISTER frames spread among them. With
    `device_class` c, every device index d is moved to its neighbour whose
    (d // class_stride) is c modulo FEEDER_CLASSES (phase 11 with stride 1;
    phase 12's landing with stride SHARDS, which keeps every shard's share
    of a record uniform). Returns (frame byte lengths in
    order, the bytes, the unknown tokens in order, the REGISTER frames)."""
    from sitewhere_tpu_torch.transport.wire import (
        MessageType, WireCodec, encode_frame)

    kind = rng.choice(3, size=batch, p=[0.6, 0.3, 0.1])
    dev = rng.integers(1, n_registered + 1, batch)
    if device_class is not None:
        block = FEEDER_CLASSES * class_stride
        dev = dev - dev % block + device_class * class_stride \
            + dev % class_stride
        dev[dev < 1] += block
        dev[dev > n_registered] -= block
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

    from sitewhere_tpu_torch.client.rest import SiteWhereClientError
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


def assert_mesh_matches_host(got, host, what):
    """A mesh report against the host route's: keys, tokens, geometry and
    the histogram equal, counts, min and max bit for bit, sums and means
    within the reference's rtol=1e-5, atol=1e-5 (tests/test_distributed.py:
    the combine adds in another order). Returns the sum cells whose bits
    differ and their largest difference in ulps."""
    if (got.t0_ms, got.n_windows) != (host.t0_ms, host.n_windows) or \
            not np.array_equal(np.asarray(got.key_ids, object),
                               np.asarray(host.key_ids, object)) or \
            got.key_tokens != host.key_tokens or not np.array_equal(
                got.type_counts, host.type_counts):
        raise AssertionError(f"{what}: keys, tokens, geometry or histogram "
                             f"differ from the host route's")
    bad = {f: n for f, n in stats_mismatches(got.stats, host.stats).items()
           if f in ("count", "min", "max") and n}
    if bad:
        raise AssertionError(f"{what}: grids differ from the host route's "
                             f"{bad}")
    for f in ("sum", "mean"):
        np.testing.assert_allclose(
            getattr(got.stats, f).numpy(), getattr(host.stats, f).numpy(),
            rtol=MESH_TOL, atol=MESH_TOL, equal_nan=True,
            err_msg=f"{what} {f}")
    a = got.stats.sum.numpy().view(np.int32).astype(np.int64)
    b = host.stats.sum.numpy().view(np.int32).astype(np.int64)
    return int((a != b).sum()), int(np.abs(a - b).max())


def mesh_load(dev, ex, query, want_total):
    """(g)'s load: MESH_LOAD clients sending the open-range `query` (never
    cached, so every one takes the mesh route) through the executor's
    READ_WORKERS workers, the log fixed; every result holds `want_total`
    measurements. A run marked ungated lifts the one-replay-a-card gate
    (parallel/distributed.py `_replay_gate`) to show what it holds back.
    Each run: latency percentiles, queries/s, and the peak device memory
    above what was resident."""
    import contextlib

    import sitewhere_tpu_torch.parallel.distributed as dist_mod

    gate = dist_mod._replay_gate
    runs = {}
    for n_clients, gated in MESH_LOAD:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        if not gated:
            dist_mod._replay_gate = lambda device: contextlib.nullcontext()
        try:
            samples, sheds, _, _, wall = run_clients(ex, query, n_clients, 1)
        finally:
            dist_mod._replay_gate = gate
        lat = [s[0] for obs in samples for s in obs]
        if any(s[1] != "mesh" or s[4] != want_total
               for obs in samples for s in obs):
            raise AssertionError("(g) a loaded query left the mesh route "
                                 "or lost rows")
        runs[f"{n_clients}_{'gated' if gated else 'ungated'}"] = {
            "queries": len(lat), "wall_s": wall, "qps": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "p99_of_samples": len(lat), "sheds": sheds,
            "peak_above_resident_bytes":
                torch.cuda.max_memory_allocated(dev) - resident}
    return runs


def mesh_route(dev, rlog, card):
    """(g): the mesh route over the whole log: the monolithic query with an
    explicit SHARDS-shard mesh on the card under each combine, against the
    host route over the same rows (see assert_mesh_matches_host; (c)'s
    writer sealed more chunks since (b)), against the same
    call with the segment sum's plain version (bits), and against the CPU
    on the first MESH_CPU_WINDOWS windows (bits); one open-range query
    through an executor whose planner's provider answers the mesh, routed
    "mesh" and counted, then concurrent clients through it (mesh_load).
    The segment-sum kernel's launches count from 0 over the path up to the
    load. Then the fold and the combine at the query's inputs by
    CUDA events, each beside the bound of its bytes."""
    import sitewhere_tpu_torch.analytics.windows as windows_mod
    import sitewhere_tpu_torch.parallel.distributed as dist_mod
    from sitewhere_tpu_torch.analytics import WindowedAnalyticsEngine
    from sitewhere_tpu_torch.ops.segsum import (
        segment_row_sum, segment_row_sum_plain)
    from sitewhere_tpu_torch.parallel.mesh import make_mesh
    from sitewhere_tpu_torch.serving import (
        QueryExecutor, QueryPlanner, WindowQuery)

    mesh = make_mesh(SHARDS, device=dev)
    engine = WindowedAnalyticsEngine(rlog.log, device=dev)
    kw = dict(window_ms=READ_WINDOW_MS, with_type_histogram=True)
    out, reports = {"shards": SHARDS}, {}
    t0 = time.perf_counter()
    host = engine.measurement_windows(READ_TENANT, **kw)
    out["host"] = {"wall_s": time.perf_counter() - t0,
                   **{k + "_s": v for k, v in host.timings.items()},
                   "rows": rlog.rows, "measurements": rlog.cum[-1]}
    torch.cuda.synchronize()
    segment_row_sum.launches = 0
    for combine in ("psum", "ring"):
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        with _Wrapped(dist_mod, ("block_partials", f"_combine_{combine}")) \
                as parts:
            t0 = time.perf_counter()
            report = engine.measurement_windows(READ_TENANT, mesh=mesh,
                                                combine=combine, **kw)
            wall = time.perf_counter() - t0
            calls = dict(parts.first)
        peak = torch.cuda.max_memory_allocated(dev)
        bits, ulps = assert_mesh_matches_host(report, host,
                                              f"(g) mesh {combine}")
        reports[combine] = (report, calls)
        out[combine] = {
            "wall_s": wall,
            **{k + "_s": v for k, v in report.timings.items()},
            "peak_device_bytes": peak,
            "peak_above_resident_bytes": peak - resident,
            "sum_cells_not_bit_equal_to_host": bits,
            "sum_max_ulps_from_host": ulps}
    planner = QueryPlanner(rlog.log, mesh_provider=lambda: mesh)
    ex = QueryExecutor(WindowedAnalyticsEngine(rlog.log, planner=planner,
                                               device=dev), planner,
                       workers=READ_WORKERS, queue_depth_budget=READ_DEPTH)
    try:
        routed = ex.report()["mesh_routed_total"]
        query = WindowQuery(tenant=READ_TENANT, **kw)
        served = ex.query(query, timeout=600.0)
        if served["span"]["route"] != "mesh" or \
                ex.report()["mesh_routed_total"] != routed + 1:
            raise AssertionError(f"(g) the executor's query took "
                                 f"{served['span']['route']}, not the mesh")
        assert_reports_bits_equal(served["report"], reports["psum"][0],
                                  "(g) executor's mesh query vs explicit")
        out["launches"] = segment_row_sum.launches
        out["load"] = mesh_load(dev, ex, query,
                                int(host.stats.count.sum()))
    finally:
        ex.stop()
    if not out["launches"]:
        raise AssertionError("(g) the mesh route never launched the "
                             "segment-sum kernel")
    out["executor_route"] = served["span"]["route"]
    plain = {}
    windows_mod.segment_row_sum = segment_row_sum_plain
    try:
        for combine in ("psum", "ring"):
            plain[combine] = engine.measurement_windows(
                READ_TENANT, mesh=mesh, combine=combine, **kw)
    finally:
        windows_mod.segment_row_sum = segment_row_sum
    for combine, got in plain.items():
        assert_reports_bits_equal(reports[combine][0], got,
                                  f"(g) mesh {combine}, kernel vs plain")
    epoch = rlog.packer.epoch_base_ms
    small = dict(window_ms=READ_WINDOW_MS, start_ms=epoch,
                 end_ms=epoch + MESH_CPU_WINDOWS * READ_WINDOW_MS - 1)
    cpu_engine = WindowedAnalyticsEngine(rlog.log, device="cpu")
    cpu_mesh = make_mesh(SHARDS, device="cpu")
    for combine in ("psum", "ring"):
        got = engine.measurement_windows(READ_TENANT, mesh=mesh,
                                         combine=combine, **small)
        t0 = time.perf_counter()
        ref = cpu_engine.measurement_windows(READ_TENANT, mesh=cpu_mesh,
                                             combine=combine, **small)
        out[f"cpu_{combine}_s"] = time.perf_counter() - t0
        assert_reports_bits_equal(got, ref, f"(g) mesh {combine} card vs "
                                  f"CPU on {MESH_CPU_WINDOWS} windows")
    out["cpu_check"] = {"windows": MESH_CPU_WINDOWS,
                        "rows": int(got.totals()["events"]),
                        "keys": got.num_keys, "K": got.stats.num_keys,
                        "W": got.stats.num_windows}
    del plain, got, ref, host
    # the fold and each combine at the monolithic query's own inputs
    (args, fold_kw), = [reports["psum"][1]["block_partials"]]
    rows = args[0].numel()
    cells = SHARDS * reports["psum"][0].stats.count.numel()
    fold_bytes = rows * sum(a.element_size() for a in args) + cells * 16
    fold_ms = time_cuda(lambda: dist_mod.block_partials(*args, **fold_kw),
                        reps=10, warmup=2)
    out["fold"] = {"rows": rows, "cells": cells, "ms": fold_ms,
                   "bytes": fold_bytes,
                   "bound_ms": fold_bytes / H100_HBM_BYTES_S * 1e3,
                   "bound_by": "bytes"}
    out["fold"]["bound_share"] = out["fold"]["bound_ms"] / fold_ms
    combine_bytes = cells * 16 + cells // SHARDS * 20
    for combine in ("psum", "ring"):
        (cargs, ckw), = [reports[combine][1][f"_combine_{combine}"]]
        fn = getattr(dist_mod, f"_combine_{combine}")
        ms = time_cuda(lambda: fn(*cargs, **ckw), reps=10, warmup=2)
        bound = combine_bytes / H100_HBM_BYTES_S * 1e3
        out[f"combine_{combine}"] = {
            "ms": ms, "bytes": combine_bytes, "bound_ms": bound,
            "bound_by": "bytes", "bound_share": bound / ms}
    del reports, args, cargs
    torch.cuda.empty_cache()
    log(f"[read] (g) mesh route, {SHARDS} shards on the card, each combine "
        f"== the host route (counts, min, max bits; sums and means rtol="
        f"{MESH_TOL}, atol={MESH_TOL}) == the plain segment sum's bits == "
        f"the CPU's bits on {MESH_CPU_WINDOWS} windows; the executor's "
        f"open-range query routed mesh: {json.dumps(out)} on {card}")
    return out


def phase_read_side(dev, card, main_ref):
    """The read side at full size. Its main path is the monolithic query
    (b) and the serving tier (c), driven with the segment-sum kernel's
    count set to 0 just before and read just after; then the mesh route
    (g, its own count from 0), the device ops and the kernel against their
    plain versions (a), reads beside a capturing engine (d), the bus
    replay (e), a wide-row tenant (f) and an hourly query over chatty
    devices."""
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
        readings["mesh"] = mesh_route(dev, rlog, card)
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


# -- phase 10: the instance behind `serve` -----------------------------------------

INSTANCE_REST_DEVICES = 64
# 24 payloads of 4,096 events: 98,304 events, 12 batches of the default
# configuration, sent back to back to the running instance as a gateway
# sends them. Cut from 40 payloads, 4 of them beside the pollers, so that
# the script with phase 13 stays inside its time on a slower host (the
# ingest and the CPU twin's replay scale with the payloads, and 4 beside
# the pollers took 81-218 s)
INSTANCE_PAYLOADS = 24
INSTANCE_PAYLOAD_EVENTS = 4096        # events a wire payload
INSTANCE_POLLED = 2                   # payloads sent beside the REST pollers
INSTANCE_CLIENTS = 8                  # REST pollers beside the ingest
# each poller's pause between requests, a dashboard's refresh: pollers in
# a tight loop hold the interpreter lock so much that the inbound consumer
# all but stops
INSTANCE_POLL_PERIOD_S = 0.25
INSTANCE_SAMPLE_DEVICES = 256         # devices the pollers read
INSTANCE_PROFILED = 3                 # payloads under the profiler
INSTANCE_AFTER_SAVE = 1               # payloads past the checkpoint
# a window's payloads must be in by then (4 payloads beside the pollers
# took 218 s on the slowest host seen)
INSTANCE_STREAM_TIMEOUT_S = 450.0
INSTANCE_PROGRAMS, INSTANCE_MODELS, INSTANCE_POLICIES = 32, 8, 8
INSTANCE_ZONE_VERTS = 16
INSTANCE_COMMANDS = ("bench-cmd", "inspect")


def instance_config(data_dir, device):
    """The default configuration (runtime/config.py DEFAULTS) as `serve`
    builds it, with a data directory and the engine's device."""
    from sitewhere_tpu_torch.__main__ import _build_config

    cfg = _build_config(None)
    cfg.set("persist.data_dir", data_dir)
    cfg.set("pipeline.device", device)
    return cfg


def boot_instance(cfg, epoch_base_ms):
    """`serve`'s instance and REST gateway (port 0); boot wall seconds."""
    from sitewhere_tpu_torch.__main__ import _build_instance
    from sitewhere_tpu_torch.web.server import RestServer

    t0 = time.perf_counter()
    inst = _build_instance(cfg)
    inst.pipeline_engine.packer.epoch_base_ms = epoch_base_ms
    inst.start()
    rest = RestServer(inst, port=0)
    rest.start()
    return inst, rest, time.perf_counter() - t0


class _OneTransaction:
    """A sqlite connection whose commits wait for the caller's one commit
    (every other attribute is the connection's)."""

    def __init__(self, conn):
        self._conn = conn

    def __getattr__(self, name):
        return getattr(self._conn, name)

    def commit(self):
        pass


def register_devices(inst, n):
    """`n` devices with assignments in tenant default through the tenant
    engine's DeviceManagement, as the device controller creates them. The
    store commits each entity; a fleet registered here is set-up, not a
    measured path, so a sqlite store takes it in one transaction."""
    from sitewhere_tpu_torch.model import (
        Area, Device, DeviceAssignment, DeviceType)

    dm = inst.get_tenant_engine("default").registry
    conn = getattr(dm.store, "_conn", None)
    if conn is not None:
        dm.store._conn = _OneTransaction(conn)
    try:
        dtype = dm.create_device_type(DeviceType(token="sensor",
                                                 name="sensor"))
        area = dm.create_area(Area(token="area-1", name="area-1"))
        for i in range(1, n + 1):
            d = dm.create_device(Device(token=f"dev-{i}",
                                        device_type_id=dtype.id))
            dm.create_device_assignment(DeviceAssignment(
                token=f"as-dev-{i}", device_id=d.id, area_id=area.id))
    finally:
        if conn is not None:
            dm.store._conn = conn
            with dm.store._lock:
                conn.commit()


def instance_specs():
    """Phase 5's programs, models and policies, cloned to fill the default
    buckets (32 programs, 8 models, 8 policies)."""
    def fill(specs, n):
        return [dict(specs[i % len(specs)],
                     token=f"{specs[i % len(specs)]['token']}-{i}")
                for i in range(n)]
    return (fill(STATEFUL_PROGRAMS, INSTANCE_PROGRAMS),
            fill(STATEFUL_MODELS, INSTANCE_MODELS),
            fill(STATEFUL_POLICIES, INSTANCE_POLICIES))


def provision_over_rest(rest, zones):
    """The operator's REST script: 64 devices, an area with the zones, 16
    threshold and 64 geofence rules, the stateful families."""
    for command in INSTANCE_COMMANDS:
        rest.post("/api/devicetypes/sensor/commands",
                  {"token": command, "name": command})
    for i in range(INSTANCE_REST_DEVICES):
        rest.post("/api/devices", {"token": f"rest-{i}",
                                   "device_type_token": "sensor"})
        rest.post("/api/assignments", {"token": f"as-rest-{i}",
                                       "device_token": f"rest-{i}"})
    rest.post("/api/areas", {"token": "zones", "name": "zones"})
    for z, verts in enumerate(zones):
        rest.post("/api/areas/zones/zones", {
            "token": f"zone-{z}", "name": f"zone-{z}",
            "bounds": [{"latitude": float(v[0]), "longitude": float(v[1])}
                       for v in verts]})
    for i in range(N_THRESHOLD):
        rest.post("/api/rules", {
            "type": "threshold", "token": f"thr-{i}",
            "measurement_name": "m1", "operator": ">",
            "threshold": 95.0 + i, "alert_level": "WARNING"})
    order = np.random.default_rng(SEED).permutation(len(zones))
    for g in range(N_GEOFENCE):
        rest.post("/api/rules", {
            "type": "geofence", "token": f"fence-{g}",
            "zone_token": f"zone-{int(order[g])}",
            "condition": "inside" if g % 2 == 0 else "outside",
            "alert_level": ("INFO", "WARNING", "ERROR", "CRITICAL")[g % 4]})
    programs, models, policies = instance_specs()
    for path, specs in (("ruleprograms", programs), ("models", models),
                        ("actuations", policies)):
        for spec in specs:
            rest.post(f"/api/tenants/default/{path}", spec)


def instance_payloads(epoch_ms, tokens, seed=SEED + 10):
    """INSTANCE_PAYLOADS wire payloads of phase 3's traffic,
    INSTANCE_PAYLOAD_EVENTS frames each: the 60/30/10
    measurement/location/alert mix, measurements over m1 and m2, values
    U(0, 100), lat/lon in the box, each payload 200 ms after the last.
    Returns [(payload bytes, events, distinct devices)]."""
    from sitewhere_tpu_torch.transport.wire import (
        MessageType, WireCodec, encode_frame)

    rng = np.random.default_rng(seed)
    n = INSTANCE_PAYLOADS
    M, L, A = MessageType.MEASUREMENT, MessageType.LOCATION, MessageType.ALERT
    out = []
    for k in range(n):
        m = INSTANCE_PAYLOAD_EVENTS
        kind = rng.choice(3, size=m, p=[0.6, 0.3, 0.1])
        dev = rng.integers(0, len(tokens), m)
        ts = epoch_ms + 200 * k + np.sort(rng.integers(0, 200, m))
        value = rng.uniform(0, 100, m)
        mm = rng.integers(1, 3, m)
        lat = rng.uniform(*LAT_LON_BOX, m)
        lon = rng.uniform(*LAT_LON_BOX, m)
        level = rng.integers(0, 4, m)
        frames = []
        for i in range(m):
            token = tokens[int(dev[i])]
            if kind[i] == 0:
                frames.append(encode_frame(M, WireCodec.encode_measurement(
                    token, int(ts[i]), f"m{int(mm[i])}", float(value[i]))))
            elif kind[i] == 1:
                frames.append(encode_frame(L, WireCodec.encode_location(
                    token, int(ts[i]), float(lat[i]), float(lon[i]))))
            else:
                frames.append(encode_frame(A, WireCodec.encode_alert(
                    token, int(ts[i]), "overheat", int(level[i]), "hot")))
        out.append((b"".join(frames), m, len(set(dev.tolist()))))
    return out


def attach_command_destination(inst, port, loop):
    """An MQTT command destination on tenant default, as an operator
    configures one beside actuation policies: the policies' commands go
    out to the devices' command topics on the broker at `port`. Without
    one, every fire is retried and then dead-lettered."""
    from sitewhere_tpu_torch.commands import (
        CommandDestination, MqttDeliveryProvider)

    destination = CommandDestination("mqtt", MqttDeliveryProvider(
        "127.0.0.1", port, loop_thread=loop))
    inst.get_tenant_engine("default").command_delivery.add_destination(
        destination)
    destination.start()


def command_counts(inst):
    """(delivered, parked, retries) of the instance's command fan-out."""
    fanout = inst.pipeline_engine.command_dispatcher
    return (fanout.delivered_count, fanout.parked_count, fanout.retry_count)


class StepGroups:
    """Records the decoded records each call of a tenant's inbound handler
    took (one poll of its consumer, packed into the steps of that call),
    and the seconds each call took, so that a second instance can process
    the same records in the same groups: the alert lanes hold at most 128
    alerts a step and the rule programs tick once a step, so what is
    persisted depends on which rows share a step, and a consumer's polls
    cut a stream where its timing falls."""

    def __init__(self, inst):
        inbound = inst.get_tenant_engine("default").inbound
        self.host = inbound._host
        self.handler = self.host._handler
        self.groups = []
        self.seconds = []
        self.host._handler = self._record

    def _record(self, records):
        t0 = time.perf_counter()
        self.handler(records)
        self.seconds.append(time.perf_counter() - t0)
        self.groups.append(list(records))

    def sizes(self, first=0):
        return [len(g) for g in self.groups[first:]]

    def replay_into(self, inst):
        """Process every recorded group, in order, through `inst`'s
        inbound handler (its own consumer stopped)."""
        inbound = inst.get_tenant_engine("default").inbound
        inbound.stop()
        for records in self.groups:
            inbound.process(records)


def _decoded_topic(inst):
    return inst.bus.topic(inst.naming.event_source_decoded_events("default"))


def stream(inst, send, payloads, groups, what,
           timeout_s=INSTANCE_STREAM_TIMEOUT_S):
    """Send `payloads` back to back to the running instance, as a gateway
    does, its inbound consumer polling all along as under `serve`, and
    wait until the consumer has committed every decoded request: (seconds
    from the first send to the last committed request, events). Logs the
    backlog and the consumer's polls every 10 s."""
    topic = _decoded_topic(inst)
    expected = sum(topic.end_offsets()) + sum(p[2] for p in payloads)
    first = len(groups.groups)
    t0 = time.perf_counter()
    for payload, _, _ in payloads:
        send(payload)
    sent_s = time.perf_counter() - t0
    deadline, report = t0 + timeout_s, t0 + 10.0
    while sum(topic.end_offsets()) < expected or inst._ingest_backlog() > 0:
        now = time.perf_counter()
        if now > deadline or now > report:
            sizes = groups.sizes(first)
            state = (f"{what}: {now - t0:.0f} s, sent in {sent_s:.1f} s, "
                     f"{sum(topic.end_offsets())} of {expected} requests "
                     f"on the bus, backlog {inst._ingest_backlog()}, "
                     f"{len(sizes)} polls, last sizes {sizes[-8:]}")
            if now > deadline:
                raise RuntimeError(f"not ingested in {timeout_s} s: {state}")
            log(f"[instance] {state}")
            report = now + 10.0
        time.sleep(0.005)
    return time.perf_counter() - t0, sum(p[1] for p in payloads)


def paced(inst, send, payload, n_requests, timeout_s=120.0):
    """One payload taken by the inbound consumer in one poll: the consumer
    is stopped while the payload's decoded requests go onto the bus, then
    started. Only for the payload past the checkpoint: a restart replays
    it in one poll, so the instance must have taken it in one step before
    it stopped as well."""
    topic = _decoded_topic(inst)
    inbound = inst.get_tenant_engine("default").inbound
    expected = sum(topic.end_offsets()) + n_requests
    inbound.stop()
    send(payload)
    deadline = time.time() + timeout_s
    while sum(topic.end_offsets()) < expected:
        if time.time() > deadline:
            raise RuntimeError(f"payload not decoded in {timeout_s} s")
        time.sleep(0.001)
    inbound.start()
    while inst._ingest_backlog() > 0:
        if time.time() > deadline:
            raise RuntimeError(f"payload not ingested in {timeout_s} s")
        time.sleep(0.001)


def instance_observation(inst):
    """What the card and CPU instances must agree on: persisted event
    counts by type, the alerts (ids and wall stamps left out), every
    family's counters, the canonical state and state groups."""
    from sitewhere_tpu_torch.model.event import DeviceEventType
    from sitewhere_tpu_torch.persist.eventlog import EventFilter

    inst.event_log.flush()
    names = ["event_type", "device_token", "alert_source", "alert_level",
             "alert_type", "event_date", "alert_message"]
    cols = inst.event_log.query_columns("default", EventFilter(), names)
    types, counts = np.unique(cols["event_type"], return_counts=True)
    is_alert = cols["event_type"] == int(DeviceEventType.ALERT)
    alerts = sorted(zip(*(cols[n][is_alert].tolist() for n in names[1:])))
    engine = inst.pipeline_engine
    return {
        "rows": int(len(cols["event_type"])),
        "events": dict(zip(types.tolist(), counts.tolist())),
        "alerts": alerts,
        "counters": (engine.rule_program_counters(),
                     engine.anomaly_model_counters(),
                     engine.actuation_policy_counters()),
        "state": engine.canonical_state(),
        "groups": (engine.canonical_rule_state(),
                   engine.canonical_model_state(),
                   engine.canonical_actuation_state()),
    }


def assert_observations_equal(ref, got, what):
    assert got["events"] == ref["events"], \
        f"{what}: event counts {got['events']} != {ref['events']}"
    assert got["alerts"] == ref["alerts"], \
        f"{what}: {len(got['alerts'])} alerts != {len(ref['alerts'])}"
    assert got["counters"] == ref["counters"], f"{what}: counters differ"
    assert_tree_bits_equal(ref["state"], got["state"], f"{what} state")
    for name, r, g in zip(("rule", "model", "actuation"), ref["groups"],
                          got["groups"]):
        assert_tree_bits_equal(r, g, f"{what} {name} group")


def rest_pollers(rest, tokens, stop):
    """INSTANCE_CLIENTS threads polling the read routes until `stop`, each
    pausing INSTANCE_POLL_PERIOD_S between requests; returns the threads
    and {route class: [ms]}."""
    from sitewhere_tpu_torch.client import SiteWhereClientError

    samples = {k: [] for k in ("events", "devicestate", "topology", "flight",
                               "metrics", "windows")}
    errors = []
    lock = threading.Lock()

    def client(i):
        rng = np.random.default_rng(SEED + 100 + i)
        classes = list(samples)
        while not stop.is_set():
            kind = classes[int(rng.integers(0, len(classes)))]
            token = tokens[int(rng.integers(0, len(tokens)))]
            path, query = {
                "events": (f"/api/assignments/as-{token}/events",
                           {"pageSize": 20}),
                "devicestate": (f"/api/devicestates/{token}", None),
                "topology": ("/api/instance/topology", None),
                "flight": ("/api/instance/flight", {"last": 16}),
                "metrics": ("/metrics", None),
                "windows": ("/api/analytics/windows",
                            {"window_ms": 1000, "keys": 16}),
            }[kind]
            t0 = time.perf_counter()
            try:
                rest.get(path, **(query or {}))
            except SiteWhereClientError as exc:
                if exc.status != 404:   # a device not seen yet: 404
                    errors.append(f"{kind}: HTTP {exc.status} "
                                  f"{str(exc.payload)[:500]}")
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"{kind}: {exc!r}")
                continue
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                samples[kind].append(ms)
            stop.wait(INSTANCE_POLL_PERIOD_S)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(INSTANCE_CLIENTS)]
    for t in threads:
        t.start()
    return threads, samples, errors


def rest_client(base_url):
    """The port's REST client with a JWT for admin:password (a window
    query beside the ingest may take seconds)."""
    from sitewhere_tpu_torch.client import SiteWhereClient

    client = SiteWhereClient(base_url, timeout=120.0)
    client.authenticate("admin", "password")
    return client


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else "not measured"


def cli_as_a_user(card_name, data_dir):
    """`check` exits 0 naming the card; `serve --port 0` answers
    /api/system/version and /api/instance/topology (which names the CUDA
    device) and exits 0 on SIGTERM."""
    import os
    import re
    import signal

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    chk = subprocess.run([sys.executable, "-m", "sitewhere_tpu_torch",
                          "check"], capture_output=True, text=True,
                         timeout=300, env=env)
    assert chk.returncode == 0, chk.stdout + chk.stderr
    assert card_name in chk.stdout, chk.stdout
    proc = subprocess.Popen(
        [sys.executable, "-m", "sitewhere_tpu_torch", "serve", "--port", "0",
         "--data-dir", data_dir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
    try:
        t0, url, lines = time.perf_counter(), None, []
        while url is None and time.perf_counter() - t0 < 300:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"REST gateway : (http://\S+)", line)
            url = m.group(1) if m else None
        assert url, "serve did not come up:\n" + "".join(lines)
        boot_s = time.perf_counter() - t0
        rest = rest_client(url)
        version = rest.get("/api/system/version")
        topology = rest.get("/api/instance/topology")
        assert topology["device"]["type"] == "cuda", topology.get("device")
        assert topology["device"]["name"] == card_name
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        assert rc == 0, f"serve exited {rc}:\n{proc.stdout.read()}"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return {"serve_boot_s": boot_s, "version": version["version"],
            "check_lines": [ln for ln in chk.stdout.splitlines()
                            if ln.startswith(("cuda", "kernel", "nvcc"))]}


def phase_instance(dev, card, name):
    """Phase 10: the default-configuration instance behind `serve`, on the
    card, against the same instance on the CPU. Returns the readings and
    the instance path's launches."""
    from sitewhere_tpu_torch.ops import segsum
    from sitewhere_tpu_torch.sources import InboundEventSource, WireDecoder
    from sitewhere_tpu_torch.sources.receivers import (
        EventLoopThread, MqttEventReceiver)
    from sitewhere_tpu_torch.transport.mqtt import MqttBroker, MqttClient

    import logging

    # the instance sends its logs to its bus; a failing REST call's
    # traceback goes to stderr as well
    errlog = logging.StreamHandler(sys.stderr)
    errlog.setLevel(logging.ERROR)
    logging.getLogger("sitewhere").addHandler(errlog)
    out = {}
    # `serve` runs in a process of its own: start from a card whose
    # caching allocator holds none of the earlier phases' blocks
    reserved = torch.cuda.memory_reserved(dev)
    torch.cuda.empty_cache()
    log(f"[instance] earlier phases' cached blocks released: "
        f"{reserved} -> {torch.cuda.memory_reserved(dev)} B reserved")
    epoch = int(time.time() * 1000) - EPOCH_LAG_MS
    tmp = tempfile.TemporaryDirectory(prefix="swt-instance-")
    data_dir = f"{tmp.name}/card"
    loop = EventLoopThread.shared()
    broker = MqttBroker()
    loop.run(broker.start())
    insts = []
    try:
        # (a) boot: the card instance with its data dir, the CPU twin
        # without one; 100,000 devices registered in both at once
        card_inst, card_rest, out["boot_wall_s"] = boot_instance(
            instance_config(data_dir, str(dev)), epoch)
        insts.append((card_inst, card_rest))
        cpu_inst, cpu_rest, out["cpu_boot_wall_s"] = boot_instance(
            instance_config(None, "cpu"), epoch)
        insts.append((cpu_inst, cpu_rest))
        engine = card_inst.pipeline_engine
        assert engine.device == dev and \
            cpu_inst.pipeline_engine.device.type == "cpu"
        t0 = time.perf_counter()
        failed = []

        def register(inst):
            try:
                register_devices(inst, N_REGISTERED)
            except Exception as exc:  # noqa: BLE001 - raised below
                failed.append(exc)

        threads = [threading.Thread(target=register, args=(inst,))
                   for inst in (card_inst, cpu_inst)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if failed:
            raise failed[0]
        out["register_wall_s"] = time.perf_counter() - t0
        _, _, zones = random_world(SEED, 1, N_ZONES, INSTANCE_ZONE_VERTS,
                                   box=LAT_LON_BOX, radius=ZONE_RADIUS)
        rests = [rest_client(card_rest.base_url),
                 rest_client(cpu_rest.base_url)]
        t0 = time.perf_counter()
        for rest in rests:
            provision_over_rest(rest, zones)
        out["provision_wall_s"] = (time.perf_counter() - t0) / 2
        for inst in (card_inst, cpu_inst):
            # params built before the first step: rule alert types are
            # interned then, a device alert's type when it is packed, and
            # the state keeps interner indices
            inst.pipeline_engine._ensure_params()
        reg = card_inst.registry_tensors
        assert reg.devices.lookup("dev-1") > 0 and \
            reg.devices.lookup(f"rest-{INSTANCE_REST_DEVICES - 1}") > 0
        log(f"[instance] booted in {out['boot_wall_s']:.2f} s (CPU twin "
            f"{out['cpu_boot_wall_s']:.2f} s); {N_REGISTERED} devices "
            f"registered in both in {out['register_wall_s']:.1f} s; REST "
            f"provisioning {out['provision_wall_s']:.1f} s an instance")

        tokens = [f"dev-{i}" for i in range(1, N_REGISTERED + 1)] + \
            [f"rest-{i}" for i in range(INSTANCE_REST_DEVICES)]
        payloads = instance_payloads(epoch, tokens)
        n_total = sum(p[1] for p in payloads)
        polled = payloads[:INSTANCE_POLLED]
        alone = payloads[INSTANCE_POLLED:-INSTANCE_PROFILED
                         - INSTANCE_AFTER_SAVE]
        profiled = payloads[-INSTANCE_PROFILED - INSTANCE_AFTER_SAVE:
                            -INSTANCE_AFTER_SAVE]

        # (b) a gateway publishes wire payloads to the in-process broker,
        # back to back; the card instance's event source subscribes and its
        # inbound consumer polls all along, as under `serve`
        tenant = card_inst.get_tenant_engine("default")
        source = InboundEventSource(
            "mqtt-wire", WireDecoder(),
            [MqttEventReceiver("127.0.0.1", broker.port, topic="SW/+/input",
                               qos=0, loop_thread=loop)],
            tenant.bus, tenant.naming)
        tenant.event_sources.add_source(source)
        source.start()
        publisher = MqttClient("127.0.0.1", broker.port,
                               client_id="smoke-gateway")
        loop.run(publisher.connect())

        def send(payload):
            loop.run(publisher.publish("SW/gateway/input", payload),
                     timeout_s=60.0)

        for inst in (card_inst, cpu_inst):
            attach_command_destination(inst, broker.port, loop)
        groups = StepGroups(card_inst)
        # the flight recorder is process-wide: earlier phases' steps are in
        # it too, so the spans read are those after this sequence number
        last = engine.flight.export(last_n=1)["records"]
        seq0 = last[-1]["seq"] if last else -1
        reset_launch_counts(engine)
        segsum.segment_row_sum.launches = 0
        stop = threading.Event()
        pollers, samples, errors = rest_pollers(
            rests[0], [tokens[i] for i in np.random.default_rng(SEED).choice(
                len(tokens), INSTANCE_SAMPLE_DEVICES, replace=False)], stop)
        time.sleep(0.5)                      # pollers up before the ingest
        polled_s, polled_events = stream(card_inst, send, polled, groups,
                                         "beside the pollers")
        stop.set()
        for t in pollers:
            t.join(timeout=120)
        assert not errors, errors[:5]
        n_polled = len(groups.groups)
        log(f"[instance] {polled_events} events over MQTT beside "
            f"{INSTANCE_CLIENTS} REST pollers in {polled_s:.2f} s = "
            f"{polled_events / polled_s:.1f} events/s, "
            f"{n_polled} polls")
        alone_s, alone_events = stream(card_inst, send, alone, groups,
                                       "alone")
        last = engine.flight.export(last_n=1)["records"]
        seq1 = last[-1]["seq"] if last else -1
        # the profiler over the next payloads (it records every op of
        # every thread: the pollers stay off)
        wall_ms, _, _, busy_ms, idle = device_profile(lambda: stream(
            card_inst, send, profiled, groups, "profiled"))
        launches = launch_counts(engine)
        launches["segment_row_sum"] = segsum.segment_row_sum.launches
        keys, captures = len(engine._graphs), engine.graph_captures
        steps = engine.batches_processed
        assert launches["points_in_zones"] > 0 and \
            launches["eval_rule_programs"] > 0, launches
        assert launches["segment_row_sum"] > 0, launches
        assert keys >= 1 and captures == keys, (captures, keys)
        # step spans of the unprofiled windows
        records = engine.flight.export(last_n=256)["records"]
        spans = [r["span_ms"] for r in records if seq0 < r["seq"] <= seq1]
        sizes = groups.sizes()
        events = polled_events + alone_events
        out.update({
            "ingest_events_per_s": events / (polled_s + alone_s),
            "ingest_events_per_s_beside_pollers": polled_events / polled_s,
            "ingest_events_per_s_alone": alone_events / alone_s,
            "events_timed": events,
            "ingest_wall_s": {"beside_pollers": polled_s, "alone": alone_s},
            "polls": {"n": len(sizes), "beside_pollers": n_polled,
                      "requests_p50": _pct(sizes, 50),
                      "requests_min": min(sizes), "requests_max": max(sizes),
                      "handler_s_p50": _pct(groups.seconds, 50)},
            "steps": steps, "captures": captures,
            "static_configurations": keys,
            "launches_instance_path": launches,
            "profiled": {"payloads": INSTANCE_PROFILED, "wall_ms": wall_ms,
                         "device_busy_ms": busy_ms,
                         "device_idle_share": idle},
            "step_span_ms": {"p50": _pct(spans, 50), "p90": _pct(spans, 90),
                             "p99": _pct(spans, 99),
                             "max": max(spans) if spans else "not measured",
                             "n": len(spans)},
            "rest_ms": {k: {"p50": _pct(v, 50), "p99": _pct(v, 99),
                            "n": len(v)} for k, v in samples.items()},
        })
        log(f"[instance] {alone_events} events over MQTT alone in "
            f"{alone_s:.2f} s = {out['ingest_events_per_s_alone']:.1f} "
            f"events/s; all {events} timed events, first publish to last "
            f"committed row, {out['ingest_events_per_s']:.1f} events/s; "
            f"{len(sizes)} polls of {out['polls']['requests_p50']} requests "
            f"(p50; {min(sizes)}..{max(sizes)}), {steps} steps, "
            f"{captures} captures for {keys} static configurations; "
            f"launches {launches}")
        out["commands_card"] = command_counts(card_inst)
        log(f"[instance] step span ms {out['step_span_ms']}; device idle "
            f"share {idle} over {INSTANCE_PROFILED} profiled payloads")
        log("[instance] REST ms " + json.dumps(out["rest_ms"]))

        # (c) a checkpoint, one payload past it
        t0 = time.perf_counter()
        rests[0].post("/api/instance/checkpoint")
        out["checkpoint_save_s"] = time.perf_counter() - t0
        for payload, _, requests in payloads[-INSTANCE_AFTER_SAVE:]:
            paced(card_inst, send, payload, requests)
        loop.run(publisher.disconnect())
        card_ref = instance_observation(card_inst)
        assert card_ref["rows"] >= n_total, (card_ref["rows"], n_total)

        # the CPU instance: the card's decoded records in its step groups
        t0 = time.perf_counter()
        groups.replay_into(cpu_inst)
        out["cpu_ingest_wall_s"] = time.perf_counter() - t0
        assert_observations_equal(card_ref, instance_observation(cpu_inst),
                                  "CPU instance vs card instance")
        # every policy fire went out to the broker, the same on both
        delivered, parked, _ = command_counts(card_inst)
        assert delivered > 0 and parked == 0, command_counts(card_inst)
        assert command_counts(cpu_inst)[:2] == (delivered, parked), \
            (command_counts(cpu_inst), command_counts(card_inst))
        log(f"[instance] card instance == CPU instance over "
            f"{len(groups.groups)} step groups: {card_ref['rows']} rows, "
            f"{len(card_ref['alerts'])} alerts, event counts "
            f"{card_ref['events']}, state and groups bit-equal (CPU "
            f"{out['cpu_ingest_wall_s']:.1f} s); {delivered} commands "
            f"delivered by each, none parked")
        cpu_rest.stop()
        cpu_inst.stop()
        insts.remove((cpu_inst, cpu_rest))

        # stop, boot again on the data dir: restore, replay the payload
        # past the checkpoint
        card_rest.stop()
        card_inst.stop()
        insts.remove((card_inst, card_rest))
        t0 = time.perf_counter()
        card_inst, card_rest, _ = boot_instance(
            instance_config(data_dir, str(dev)), epoch)
        out["restore_boot_s"] = time.perf_counter() - t0
        insts.append((card_inst, card_rest))
        assert card_inst.checkpoint_manager.last_restore_offsets
        deadline = time.time() + 300
        while card_inst._ingest_backlog() > 0:
            assert time.time() < deadline, "replay did not finish"
            time.sleep(0.001)
        out["replay_s"] = time.perf_counter() - t0 - out["restore_boot_s"]
        restored = instance_observation(card_inst)
        assert restored["rows"] == card_ref["rows"], \
            f"replay added rows: {restored['rows']} != {card_ref['rows']}"
        assert_observations_equal(card_ref, restored, "restored instance")
        log(f"[instance] checkpoint save {out['checkpoint_save_s']:.3f} s; "
            f"boot with restore {out['restore_boot_s']:.3f} s, replay of "
            f"{INSTANCE_AFTER_SAVE} payload {out['replay_s']:.3f} s: state "
            f"bit-equal, no duplicate rows")
    finally:
        for inst, rest in reversed(insts):
            rest.stop()
            inst.stop()
        loop.run(broker.stop())
        logging.getLogger("sitewhere").removeHandler(errlog)
    # (d) the CLI as a user runs it
    out["cli"] = cli_as_a_user(name, f"{tmp.name}/serve")
    log(f"[instance] CLI: check ok, serve up in {out['cli']['serve_boot_s']:.2f}"
        f" s, answered and exited 0 on SIGTERM")
    tmp.cleanup()
    out["card"] = card
    log("[instance] " + json.dumps(out, default=str))
    return out


# -- phase 11: the feeder fleet on the card, the control-plane cluster -----------

# wire-frame records of one full batch each (BATCH events); record r holds
# only devices of class r % FEEDER_CLASSES, so every device's events sit in
# one partition, in order, for 1, 2 and 4 partitions alike
FEEDER_RECORDS = 8
FEEDER_CLASSES = 4
FEEDER_THREADS = (1, 2, 4)     # run (b): in-process workers over busnet
FEEDER_PROCESSES = 2           # run (c): `serve --feeder` subprocesses
FEEDER_DEATH_AFTER = 2         # run (d): the worker dies after this many acks
FEEDER_PROFILED = 3            # records landed under the profiler
FEEDER_QUERY_THREADS = 8       # window-query threads beside run (b)
FEEDER_QUERY_ROWS = 4096       # rows a window query folds
FEEDER_TIMEOUT_S = 300.0
FEEDER_TOPIC = "feeder-frames"
# the landing's flight records carry only these segments
LANDING_SEGMENTS = {"h2d", "dispatch", "stage_wait", "guard"}
CLUSTER_HOSTS = 3
CLUSTER_WAIT_S = 240.0
# `python -m sitewhere_tpu_torch` subprocesses run from the checkout
REPO_ROOT = str(__import__("pathlib").Path(__file__).resolve().parent)


@functools.lru_cache(maxsize=None)
def thread_cpu_tick_s():
    """The step of the thread CPU clock: the least change of
    time.thread_time() seen while spinning (some kernels advance it a
    scheduler tick at a time), never below the resolution the clock
    reports; inf where it does not move within a second."""
    steps, last = [], time.thread_time()
    deadline = time.perf_counter() + 1.0
    while len(steps) < 3 and time.perf_counter() < deadline:
        now = time.thread_time()
        if now != last:
            steps.append(now - last)
            last = now
    if not steps:
        return float("inf")
    return max(min(steps), time.get_clock_info("thread_time").resolution)


def thread_cpu_ms(total_s, n, readings):
    """The mean thread CPU of `n` items in ms, from `readings` clock
    differences an item, each off by up to one tick of the clock: "not
    measured" where that error could exceed a tenth of the mean."""
    mean = total_s / n
    if readings * thread_cpu_tick_s() > 0.1 * mean:
        return "not measured"
    return mean * 1e3


def feeder_engine(dev, epoch):
    """Phase 3's world on `dev`, its params built before any traffic (rule
    alert types are interned then; a device alert's type when packed)."""
    from sitewhere_tpu_torch.runtime.flight import FlightRecorder

    engine = build_world(dev, "auto", epoch)
    engine.flight = FlightRecorder(capacity=64)
    engine._ensure_params()
    return engine


def _blob_key(blob):
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(blob).tobytes()).hexdigest()


def inline_feeder_run(dev, epoch, records, card):
    """Run (a): the records through FastWireIngest + submit +
    materialize_alerts on one card engine: each record's packed blob (its
    key), its alerts, the canonical state before the sweep, the sweep's
    transitions, and the inline readings."""
    from sitewhere_tpu_torch.ops.pack import batch_to_blob
    from sitewhere_tpu_torch.sources.fastlane import FastWireIngest

    engine = feeder_engine(dev, epoch)
    ingest = FastWireIngest(engine.packer)
    alerts, keys, walls, cpus = {}, [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for data in records:
        ts, c0 = time.perf_counter(), time.thread_time()
        res = ingest.ingest(data)
        if len(res.batches) != 1 or res.n_events != BATCH:
            raise AssertionError("a record is not one full batch")
        batch = res.batches[0]
        key = _blob_key(batch_to_blob(batch))
        got = engine.materialize_alerts(batch, engine.submit(batch))
        alerts[key] = _alert_keys(got)
        keys.append(key)
        walls.append(time.perf_counter() - ts)
        cpus.append(time.thread_time() - c0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(set(keys)) != len(keys):
        raise AssertionError("two records packed the same blob")
    ref = {"alerts": alerts, "keys": keys,
           "state": engine.canonical_state(),
           "captures": engine.graph_captures}
    ref["missing"] = engine.presence_sweep()
    ref["present"] = engine.state.present.clone()
    # per record after the first (which steps eagerly and captures)
    readings = {"wall_s": wall,
                "events_per_s": len(records) * BATCH / wall,
                "events_per_s_after_first":
                    (len(records) - 1) * BATCH / sum(walls[1:]),
                "first_record_ms": walls[0] * 1e3,
                "mesh_host_cpu_ms_per_step":
                    thread_cpu_ms(sum(cpus[1:]), len(cpus) - 1, 1),
                "thread_cpu_tick_ms": thread_cpu_tick_s() * 1e3,
                "record_ms_p50": statistics.median(walls[1:]) * 1e3,
                "alerts": sum(len(a) for a in alerts.values())}
    log(f"[feeders] (a) inline FastWireIngest + submit: "
        f"{json.dumps(readings)} on {card}")
    return ref, readings


class _Landing:
    """A landing host on the card: an EventBus of `partitions` partitions
    holding the records (record r on partition r % partitions), its busnet
    edge, and a FeederService with metrics of its own whose on_outputs hook
    materializes each landed blob's alerts. The hook keeps its own work off
    the blob's flight record (which then shows the landing's work only) and
    times itself, so readings() takes it out of the service's own per-blob
    accounting."""

    events_per_blob = BATCH

    def __init__(self, dev, epoch, records, partitions, engine=None):
        from sitewhere_tpu_torch.feeders import FeederService
        from sitewhere_tpu_torch.runtime.bus import EventBus
        from sitewhere_tpu_torch.runtime.busnet import BusServer
        from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

        self.engine = engine if engine is not None \
            else feeder_engine(dev, epoch)
        self.steps, self.per_blob = [], []
        self.blob = None
        self._see_staged_blobs()
        self.metrics = MetricsRegistry()
        self.landed = self.metrics.counter("feeder.blobs")
        self.bus = EventBus(partitions=partitions)
        self.server = BusServer(self.bus)
        self.server.start()
        self.service = FeederService(self.engine, self.server, FEEDER_TOPIC,
                                     lease_ttl_s=60.0, metrics=self.metrics,
                                     on_outputs=self._hook)
        self.publish(records)

    def _see_staged_blobs(self):
        """Keep the blob the service stages (it stages a blob and runs its
        hook in turn under its step lock), for the hook."""
        stage_blob = self.engine.stage_blob

        def staging(blob, **kw):
            self.blob = blob
            return stage_blob(blob, **kw)

        self.engine.stage_blob = staging

    def _hook(self, engine, outputs, _rec):
        """Notes the landed blob's alerts (`_alerts`), the service's
        accounting as it stands (every blob before this one) and its own
        wall and thread CPU."""
        svc = self.service
        t0, c0 = time.perf_counter(), time.thread_time()
        before = (svc.blob_handle_s, svc.blob_step_s, svc.blob_cpu_s)
        self.steps.append((_blob_key(self.blob),
                           self._alerts(engine, outputs)))
        end = time.perf_counter()
        self.per_blob.append({"before": before, "hook_s": end - t0,
                              "hook_cpu_s": time.thread_time() - c0,
                              "end": end})

    def _alerts(self, engine, outputs):
        """The landed blob's alerts, materialized off its flight record."""
        from sitewhere_tpu_torch.ops.pack import blob_to_batch_np

        batch = blob_to_batch_np(self.blob)
        last, engine._flight_last = engine._flight_last, None
        try:
            return _alert_keys(engine.materialize_alerts(batch, outputs))
        finally:
            engine._flight_last = last

    def publish(self, records):
        for r, data in enumerate(records):
            self.publish_at(r, data)

    def publish_at(self, r, data):
        """Record r on partition r % partitions."""
        topic = self.bus.topic(FEEDER_TOPIC)
        topic.partitions[r % len(topic.partitions)].append(
            f"r{r}".encode(), data)

    def wait(self, n_steps, what, procs=()):
        deadline = time.perf_counter() + FEEDER_TIMEOUT_S
        # the service counts a blob once its accounting is in
        while self.landed.value < n_steps:
            dead = [p.returncode for p in procs if p.poll() is not None]
            if dead:
                raise AssertionError(f"{what}: a worker process exited "
                                     f"{dead[0]}")
            if time.perf_counter() > deadline:
                raise AssertionError(f"{what}: {self.landed.value} of "
                                     f"{n_steps} blobs landed in "
                                     f"{FEEDER_TIMEOUT_S:.0f} s")
            time.sleep(0.002)

    def readings(self, t_ready, wall):
        """bench.py's feeder readings: events/s from the workers' start
        (`t_ready`, connected and leased) to the last blob's end, as
        bench.py's curve counts it; the same from the first blob's end
        (which steps eagerly and captures) to the last's; per blob after
        the first, from the service's accounting less the hook's part: the
        landing's thread CPU, its step host ms and the handoff (the
        handled wall less its step)."""
        b, svc = self.per_blob, self.service
        n = len(b) - 1
        first = b[1]["before"]          # the first blob's accounting alone
        handle = svc.blob_handle_s - first[0]
        step = svc.blob_step_s - first[1]
        cpu = svc.blob_cpu_s - first[2]
        hook = sum(x["hook_s"] for x in b[1:])
        hook_cpu = sum(x["hook_cpu_s"] for x in b[1:])
        per_blob = self.events_per_blob
        return {"blobs": len(b), "wall_s": wall,
                "events_per_s": len(b) * per_blob / (b[-1]["end"] - t_ready),
                "events_per_s_after_first": n * per_blob
                / (b[-1]["end"] - b[0]["end"]),
                "first_blob_ms": (first[1] - b[0]["hook_s"]) * 1e3,
                # two clock differences a blob: the service's, the hook's
                "mesh_host_cpu_ms_per_step":
                    thread_cpu_ms(cpu - hook_cpu, n, 2),
                "step_ms_per_blob": (step - hook) / n * 1e3,
                "handoff_ms_per_blob": (handle - step) / n * 1e3,
                "materialize_hook_ms_per_blob": hook / n * 1e3}

    def check(self, ref, launches, what):
        """Every record stepped exactly once with the inline run's blob and
        alerts; one capture; B1 launched once a landed blob; flight
        records of the landing's segments only; state and presence
        transitions equal the inline run's."""
        engine = self.engine
        keys = [k for k, _ in self.steps]
        if sorted(keys) != sorted(ref["keys"]):
            raise AssertionError(f"{what}: landed blobs are not the inline "
                                 f"packs, each once ({len(keys)} steps)")
        for key, alerts in self.steps:
            if alerts != ref["alerts"][key]:
                raise AssertionError(f"{what}: a blob's alerts differ from "
                                     f"the inline step's")
        if engine.graph_captures != 1:
            raise AssertionError(f"{what}: {engine.graph_captures} captures")
        if launches != len(keys):
            raise AssertionError(f"{what}: B1 launched {launches} times for "
                                 f"{len(keys)} blobs")
        recs = engine.flight.export(last_n=len(keys))["records"]
        extra = {s for r in recs for s in r["stages"]} - LANDING_SEGMENTS
        if len(recs) != len(keys) or extra:
            raise AssertionError(f"{what}: flight records hold {extra}")
        assert_tree_bits_equal(ref["state"], engine.canonical_state(),
                               f"{what} canonical state")
        if engine.presence_sweep() != ref["missing"] or not torch.equal(
                engine.state.present, ref["present"]):
            raise AssertionError(f"{what}: presence transitions differ")

    def close(self):
        self.server.stop()
        self.bus.close()


def _thread_workers(port, n, name, epoch=1):
    from sitewhere_tpu_torch.feeders import FeederWorker

    workers = [FeederWorker("127.0.0.1", port, f"{name}-{i}", epoch=epoch,
                            partitions=[i]) for i in range(n)]
    for w in workers:
        w.connect()
        w.acquire_leases()
    return workers


def _query_threads(dev, n):
    """`n` threads answering window queries (analytics/windows.py
    `windowed_stats` over FEEDER_QUERY_ROWS rows, on each thread's own
    stream, every grid copied back to the host) until the returned
    finish() is called; finish() returns the queries answered."""
    from sitewhere_tpu_torch.analytics.windows import windowed_stats
    from sitewhere_tpu_torch.device import own_stream

    stop, errors, answered = threading.Event(), [], [0] * n
    ready = threading.Barrier(n + 1, timeout=60)

    def query(i):
        rng = np.random.default_rng(SEED + 120 + i)
        rows = FEEDER_QUERY_ROWS
        cols = (rng.integers(0, 64, rows).astype(np.int32),
                rng.integers(0, 16_000, rows).astype(np.int32),
                rng.uniform(0, 100, rows).astype(np.float32),
                np.ones(rows, bool))
        try:
            with own_stream(dev):
                ready.wait()
                while not stop.is_set():
                    windowed_stats(*cols, window_ms=1000, num_keys=64,
                                   n_windows=16, device=dev).to("cpu")
                    answered[i] += 1
        except Exception as exc:  # noqa: BLE001 - raised by finish()
            errors.append(exc)

    threads = [threading.Thread(target=query, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    ready.wait()

    def finish():
        stop.set()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return sum(answered)

    return finish


def feeder_thread_run(dev, epoch, records, ref, n, card, profile=False,
                      beside_queries=False):
    """Run (b) at `n` in-process workers. With `profile`, FEEDER_PROFILED
    more records are landed under the profiler afterwards; with
    `beside_queries`, FEEDER_QUERY_THREADS threads answer window queries
    on their own streams all along (the first blob's capture among
    them)."""
    what = f"(b) {n} worker thread(s)" + (
        f" beside {FEEDER_QUERY_THREADS} window-query threads"
        if beside_queries else "")
    lb = _Landing(dev, epoch, records, n)
    try:
        finish = _query_threads(dev, FEEDER_QUERY_THREADS) \
            if beside_queries else None
        reset_launch_counts(lb.engine)
        t0 = time.perf_counter()
        workers = _thread_workers(lb.server.port, n, f"w{n}")
        t_ready = time.perf_counter()
        for w in workers:
            w.start()
        try:
            lb.wait(len(records), what)
        finally:
            for w in workers:
                w.stop()
            answered = finish() if finish is not None else None
        wall = time.perf_counter() - t0
        launches = launch_counts(lb.engine)["points_in_zones"]
        readings = lb.readings(t_ready, wall)
        if answered is not None:
            readings["window_queries_answered"] = answered
        lb.check(ref, launches, what)
        if profile:
            lb.publish(records[:FEEDER_PROFILED])
            done = lb.landed.value + FEEDER_PROFILED
            # connected (leases, the replica's journal) before the window
            (prof,) = _thread_workers(lb.server.port, 1, "wprof")

            def land():
                prof.start()
                try:
                    lb.wait(done, "profiled landing")
                finally:
                    prof.stop()

            wall_ms, _, on_device, busy, idle = device_profile(land)
            readings["profiled"] = {
                "blobs": FEEDER_PROFILED, "wall_ms": wall_ms,
                "device_busy_ms": busy, "device_idle_share": idle,
                "device_events": sum(e.count for e in on_device)}
        log(f"[feeders] {what} over busnet == inline (blobs, alerts, state, "
            f"presence; one capture; B1 {launches} launches for "
            f"{len(records)} blobs): {json.dumps(readings)} on {card}")
        return readings, launches
    finally:
        lb.close()
        del lb
        torch.cuda.empty_cache()


def feeder_process_run(dev, epoch, records, ref, card, tmp):
    """Run (c): FEEDER_PROCESSES `python -m sitewhere_tpu_torch serve
    --feeder` workers (their pack off this interpreter's lock) against a
    landing in this process."""
    import re
    import signal

    n = FEEDER_PROCESSES
    lb = _Landing(dev, epoch, records, n)
    procs, ready, outs = [], [], []
    try:
        reset_launch_counts(lb.engine)
        t0 = time.perf_counter()
        for i in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", "sitewhere_tpu_torch", "serve",
                 "--feeder", "--feeder-connect",
                 f"127.0.0.1:{lb.server.port}", "--feeder-name",
                 f"proc-{i}", "--feeder-partitions", str(i), "--data-dir",
                 f"{tmp}/feeder-{i}"], cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            outs.append([])

        def read(i):
            for line in procs[i].stdout:
                outs[i].append(line)
                if re.search(r"feeder '.*' serving", line):
                    ready.append(time.perf_counter())

        readers = [threading.Thread(target=read, args=(i,), daemon=True)
                   for i in range(n)]
        for t in readers:
            t.start()
        lb.wait(len(records), "(c) serve --feeder processes", procs)
        wall = time.perf_counter() - t0
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=120) for p in procs]
        for t in readers:
            t.join(timeout=30)
        if rcs != [0] * n or len(ready) != n:
            raise AssertionError(f"serve --feeder exited {rcs}:\n" + "".join(
                "".join(o[-20:]) for o in outs))
        launches = launch_counts(lb.engine)["points_in_zones"]
        readings = lb.readings(min(ready), wall)
        readings["boot_s"] = max(ready) - t0
        lb.check(ref, launches, "(c) serve --feeder")
        log(f"[feeders] (c) {n} `serve --feeder` processes == inline "
            f"(B1 {launches} launches): {json.dumps(readings)} on {card}")
        return readings, launches
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        lb.close()
        del lb
        torch.cuda.empty_cache()


def feeder_takeover_run(dev, epoch, records, ref, card):
    """Run (d): a worker dies between a blob's ack and its offset commit
    (the `feeder_process_death` fault point) after FEEDER_DEATH_AFTER
    acks; a successor at a higher epoch steals the live lease and replays
    the partition: the landing's watermark drops the acked extents."""
    from sitewhere_tpu_torch.feeders import FeederWorker
    from sitewhere_tpu_torch.runtime.faults import (
        FaultPlan, FaultRule, arm, disarm)

    lb = _Landing(dev, epoch, records, 1)
    try:
        reset_launch_counts(lb.engine)
        t0 = time.perf_counter()
        dying = FeederWorker("127.0.0.1", lb.server.port, "w-dying",
                             epoch=1)
        arm(FaultPlan(seed=SEED, rules=[FaultRule(
            "feeder_process_death", times=1, after=FEEDER_DEATH_AFTER)]))
        try:
            for _ in range(50):
                dying.run_once(timeout_s=0.05)
                if dying.dead:
                    break
        finally:
            disarm()
        dying.client.close()
        died_after = len(lb.steps)
        if not dying.dead or died_after != FEEDER_DEATH_AFTER + 1:
            raise AssertionError(f"the worker did not die after "
                                 f"{FEEDER_DEATH_AFTER + 1} acks "
                                 f"({died_after} landed)")
        successor = FeederWorker("127.0.0.1", lb.server.port,
                                 "w-successor", epoch=2)
        successor.connect()
        if not successor.acquire_leases():
            raise AssertionError("the successor got no lease")
        successor.start()
        try:
            lb.wait(len(records), "(d) takeover")
            # the replayed extents were dropped, nothing stepped twice
            time.sleep(0.5)
        finally:
            successor.stop()
        wall = time.perf_counter() - t0
        launches = launch_counts(lb.engine)["points_in_zones"]
        readings = lb.readings(t0, wall)
        readings.update(died_after_blobs=died_after,
                        replay_dropped=lb.metrics.counter(
                            "feeder.replay_dropped").value,
                        takeovers=lb.metrics.counter("takeover.count").value)
        if readings["replay_dropped"] < 1 or readings["takeovers"] < 1:
            raise AssertionError(f"(d) takeover: {readings}")
        lb.check(ref, launches, "(d) takeover")
        log(f"[feeders] (d) takeover at a higher epoch, replay deduplicated "
            f"== inline (B1 {launches} launches, no blob stepped twice): "
            f"{json.dumps(readings)} on {card}")
        return readings, launches
    finally:
        lb.close()
        del lb
        torch.cuda.empty_cache()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gpu_processes():
    """nvidia-smi's compute processes: [(pid, used MiB)], or "not measured"
    where it lists none (a pid namespace may hide them)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    rows = [ln.split(",") for ln in out.splitlines() if ln.strip()]
    return [(int(p), float(m)) for p, m in rows] or "not measured"


class _HostLog:
    """A child process (`python -u ARGS` from the repo's root) whose output
    a thread collects: `wait_for` blocks for a marker line, `result` parses
    its RESULT line, `finish` waits for a clean exit."""

    def __init__(self, args, what, env=None):
        self.what = what
        self.proc = subprocess.Popen(
            [sys.executable, "-u", *args], cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line)
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def text(self):
        return "".join(self.lines)

    def tail(self, n=60):
        return "".join(self.lines[-n:])

    def count(self, what):
        return self.text().count(what)

    def child_pids(self):
        import re

        return [int(m) for m in re.findall(r"child pid=(\d+)", self.text())]

    def wait_for(self, marker, deadline):
        with self._cond:
            while True:
                for line in self.lines:
                    if line.startswith(marker):
                        return line
                if (self.proc.poll() is not None
                        and not self._reader.is_alive()):
                    raise AssertionError(f"{self.what} exited "
                                         f"{self.proc.returncode} before "
                                         f"{marker}:\n{self.tail()}")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise AssertionError(f"{self.what}: no {marker} by its "
                                         f"deadline:\n{self.tail()}")
                self._cond.wait(timeout=min(left, 1.0))

    def result(self, deadline):
        return json.loads(self.wait_for("RESULT ", deadline)[len("RESULT "):])

    def finish(self, deadline):
        """Wait for a clean exit; a child that fails or outlives its
        deadline fails the phase."""
        try:
            rc = self.proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{self.what} outlived its deadline:\n"
                                 f"{self.tail()}")
        self._reader.join(timeout=10)
        if rc != 0:
            raise AssertionError(f"{self.what} exited {rc}:\n{self.tail()}")

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _until(predicate, what, logs, timeout_s=CLUSTER_WAIT_S):
    """Seconds until predicate() holds; raises with the hosts' output."""
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout_s:
            tails = "\n".join(f"--- host {i} ---\n{h.text()[-3000:]}"
                              for i, h in enumerate(logs))
            raise AssertionError(f"timed out waiting for {what}\n{tails}")
        time.sleep(0.25)
    return time.perf_counter() - t0


def control_plane_drill(dev, card, tmp):
    """CLUSTER_HOSTS `serve --cluster-peers ... --supervise` processes, each
    with its engine on the card in the default configuration, through
    tests/test_provisioning_cluster.py's drill: tenant and user created on
    host 0, an event through host 1's bus edge, a JWT minted on host 2,
    host 1 killed and rebuilt by its supervisor, the tenant deleted on
    host 2; host 0's cluster telemetry names every peer."""
    import os
    import signal

    import msgpack

    from sitewhere_tpu_torch.client import SiteWhereClient
    from sitewhere_tpu_torch.client.rest import SiteWhereClientError
    from sitewhere_tpu_torch.model.common import _asdict
    from sitewhere_tpu_torch.model.event import (
        DeviceEventBatch, DeviceMeasurement)
    from sitewhere_tpu_torch.runtime.bus import TopicNaming
    from sitewhere_tpu_torch.runtime.busnet import BusClient

    n, instance_id = CLUSTER_HOSTS, "cpdrill"
    bus_ports = [_free_port() for _ in range(n)]
    rest_ports = [_free_port() for _ in range(n)]
    peers = ",".join(f"{i}=127.0.0.1:{bus_ports[i]}" for i in range(n))
    cfg = f"{tmp}/cluster.json"
    with open(cfg, "w") as f:
        json.dump({"instance": {"id": instance_id},
                   "cluster": {"heartbeat_s": 0.5, "stale_after_s": 5.0},
                   "persist": {"checkpoint_interval_s": None}}, f)

    def client(port, tenant="default", user="admin", password="password"):
        c = SiteWhereClient(f"http://127.0.0.1:{port}", tenant=tenant,
                            timeout=60.0)
        c.authenticate(user, password)
        return c

    def attempt(fn):
        try:
            return fn()
        except Exception:  # noqa: BLE001 - polled until it holds
            return None

    def publish(port, token, name, value):
        naming = TopicNaming(instance=instance_id)
        payload = msgpack.packb({
            "sourceId": "drill", "deviceToken": token,
            "kind": "DeviceEventBatch",
            "request": _asdict(DeviceEventBatch(
                device_token=token, measurements=[DeviceMeasurement(
                    name=name, value=value,
                    event_date=int(time.time() * 1000))])),
            "metadata": {}}, use_bin_type=True)
        bc = BusClient("127.0.0.1", port)
        try:
            bc.publish(naming.event_source_decoded_events("acme"),
                       token.encode(), payload)
        finally:
            bc.close()

    def engines(port):
        topo = attempt(lambda: client(port).get_topology())
        return None if topo is None else set(topo.get("tenant_engines", {}))

    def devices(port):
        listed = attempt(lambda: client(port, "acme").get(
            "/api/devices", pageSize=100))
        return {d["token"] for d in (listed or {}).get("results", [])}

    def folded(port, name, value):
        state = attempt(lambda: client(port, "acme").get(
            "/api/devicestates/adev")) or {}
        meas = state.get("lastMeasurements") or state.get(
            "last_measurements") or {}
        got = meas.get(name)
        return (got[1] if isinstance(got, (list, tuple)) else got) == value

    out = {}
    sups, logs = [], []
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    try:
        for i in range(n):
            logs.append(_HostLog(
                ["-m", "sitewhere_tpu_torch", "serve",
                 "--supervise", "--supervise-backoff", "1", "--config", cfg,
                 "--cluster-num-processes", str(n),
                 "--cluster-process-id", str(i), "--cluster-peers", peers,
                 "--bus-port", str(bus_ports[i]),
                 "--port", str(rest_ports[i]),
                 "--data-dir", f"{tmp}/host-{i}"], f"host {i}", env=env))
            sups.append(logs[-1].proc)
        boots = [None] * n

        def serving():
            for i, h in enumerate(logs):
                if boots[i] is None and h.count("REST gateway"):
                    boots[i] = time.perf_counter() - t0
            return all(b is not None for b in boots)

        _until(serving, "all hosts serving", logs, timeout_s=300.0)
        out["boot_s"] = boots
        for h in logs:
            if f"device       : {dev.type}" not in h.text():
                raise AssertionError(f"a host's engine is not on {dev}:\n"
                                     + h.text()[-2000:])
        out["gpu_processes_mib"] = _gpu_processes()

        c0 = client(rest_ports[0])
        created = c0.post("/api/tenants", {
            "token": "acme", "name": "Acme", "tenant_template_id": "empty"})
        rep = created["replication"]
        if rep.get("mode") != "replicated" or rep.get("peers") != n - 1:
            raise AssertionError(f"tenant create: {rep}")
        c0.post("/api/users", {
            "username": "drill-user", "password": "drill-pw",
            "authorities": ["REST", "VIEW_SERVER_INFO",
                            "ADMINISTER_TENANTS"]})
        c0t = client(rest_ports[0], "acme")
        c0t.post("/api/devicetypes", {"token": "adt", "name": "drill"})
        c0t.post("/api/devices", {"token": "adev",
                                  "device_type_token": "adt"})
        c0t.post("/api/assignments", {"token": "aas",
                                      "device_token": "adev"})
        out["tenant_engines_converged_s"] = _until(
            lambda: all("acme" in (engines(p) or ()) for p in rest_ports),
            "acme engines on every host", logs)
        out["registry_converged_s"] = _until(
            lambda: all("adev" in devices(p) for p in rest_ports[1:]),
            "acme registry on hosts 1 and 2", logs)
        publish(bus_ports[1], "adev", "temp", 42.5)
        out["event_folded_s"] = _until(
            lambda: folded(rest_ports[1], "temp", 42.5),
            "the event folded on host 1", logs)
        c2u = client(rest_ports[2], user="drill-user", password="drill-pw")
        if c2u.get("/api/system/version").get("edition") is None:
            raise AssertionError("the replicated user's JWT was refused")

        telemetry = client(rest_ports[0]).get("/api/cluster/telemetry")
        if sorted(telemetry["processes"]) != [str(i) for i in range(n)] \
                or telemetry["stale_peers"]:
            raise AssertionError(f"cluster telemetry: "
                                 f"{sorted(telemetry['processes'])}, stale "
                                 f"{telemetry['stale_peers']}")

        for port in rest_ports:
            client(port).post("/api/instance/checkpoint", {})
        victim = logs[1].child_pids()[-1]
        restarts, banners = logs[1].count("restarting in"), \
            logs[1].count("REST gateway")
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        _until(lambda: logs[1].count("restarting in") > restarts,
               "host 1's supervisor restart", logs)
        _until(lambda: logs[1].count("REST gateway") > banners,
               "host 1 serving again", logs)
        _until(lambda: "acme" in (engines(rest_ports[1]) or ())
               and "adev" in devices(rest_ports[1]),
               "host 1 rebuilt acme from durable state", logs)
        out["restart_wall_s"] = time.perf_counter() - t_kill
        client(rest_ports[1], user="drill-user", password="drill-pw")
        publish(bus_ports[1], "adev", "post", 77.0)
        out["post_restart_event_folded_s"] = _until(
            lambda: folded(rest_ports[1], "post", 77.0),
            "the post-restart event folded on host 1", logs)

        deleted = client(rest_ports[2]).delete("/api/tenants/acme")
        if deleted["replication"]["tombstones"] < 1:
            raise AssertionError(f"tenant delete: {deleted['replication']}")
        out["delete_converged_s"] = _until(
            lambda: all(e is not None and "acme" not in e
                        for e in map(engines, rest_ports)),
            "acme engines stopped everywhere", logs)
        out["gpu_processes_mib_end"] = _gpu_processes()
        for p in sups:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=120) for p in sups]
        if rcs != [0] * n:
            raise AssertionError(f"supervisors exited {rcs}")
    finally:
        for p in sups:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for h in logs:
            for pid in h.child_pids():
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
    out["drill_wall_s"] = time.perf_counter() - t0
    log(f"[cluster] {n} supervised `serve --cluster-peers` hosts, engines "
        f"on {dev}: tenant, user, registry and an event converged, JWT on "
        f"host 2, host 1 killed and rebuilt, delete converged, telemetry "
        f"names every peer: {json.dumps(out)} on {card}")
    return out


def phase_feeders(dev, card):
    """Phase 11: the feeder fleet landing on the card at phase 3's size,
    then the control-plane cluster drill. Returns the readings and B1's
    launches on the feeder path."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    epoch = int(time.time() * 1000) - EPOCH_LAG_MS
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 110)
    records = [encode_delivery(rng, epoch, N_REGISTERED, BATCH, 0,
                               device_class=r % FEEDER_CLASSES)[1]
               for r in range(FEEDER_RECORDS)]
    log(f"[feeders] {FEEDER_RECORDS} records of {BATCH} events encoded in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({sum(map(len, records))} bytes)")
    out, launches = {}, 0
    ref, out["inline"] = inline_feeder_run(dev, epoch, records, card)
    for n in FEEDER_THREADS:
        out[f"threads_{n}"], k = feeder_thread_run(
            dev, epoch, records, ref, n, card, profile=(n == 1))
        launches += k
    out["threads_1_beside_queries"], k = feeder_thread_run(
        dev, epoch, records, ref, 1, card, beside_queries=True)
    launches += k
    tmp = tempfile.TemporaryDirectory(prefix="swt-feeders-")
    try:
        out["processes"], k = feeder_process_run(dev, epoch, records, ref,
                                                 card, tmp.name)
        launches += k
        out["takeover"], k = feeder_takeover_run(dev, epoch, records, ref,
                                                 card)
        launches += k
        del ref
        torch.cuda.empty_cache()
        out["cluster"] = control_plane_drill(dev, card, tmp.name)
    finally:
        tmp.cleanup()
    out["launches_feeder_path"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[feeders] readings {json.dumps(out)} on {card}")
    return out


# -- phase 12: the sharded path on one card ----------------------------------

SHARDS = 8
# a flat batch of phase 3's traffic a little short of SHARDS x the
# per-shard batch (BATCH // SHARDS): a uniform flat batch of exactly
# SHARDS x B overflows some shard on most steps (each shard's count spreads
# ~115 rows around B), so phase 3's 131,072 rows would spill to the host
# route every step; at 15/16 of it every shard and every lane fits
SHARD_EVENTS = BATCH * 15 // 16
# cut from 10 timed steps, so that the script with phase 13 stays inside
# its time
SHARD_WARMUP, SHARD_STEPS = 3, 6
SHARD_LAYOUTS = ("compact", "full", "packed")
SHARD_STATEFUL_STEPS = 2
# alert lanes that hold every fire of a step (the default 128 would keep a
# different first-128 per shard than the single engine's first 128)
SHARD_LANES = BATCH // SHARDS
SHARD_AFTER_RESTORE = 2
ROUTER_BENCH = (65536, 8, 8192)      # the router micro-bench's shape
ROUTER_REPS = 7
SERVE_SHARDS = 8
SERVE_DEVICES = 64
# (f): the feeders' sharded landing at these worker-thread counts, and the
# skewed record's events (one per-shard batch, all on one device)
LANDING_THREADS = (1, 2)
SHARD_SKEW_EVENTS = BATCH // SHARDS


def shard_traffic(packer, seed):
    """{layout: SHARD_WARMUP + SHARD_STEPS flat batches} of phase 3's
    traffic: compact (the main path's mix), full (the same with
    elevations) and packed (measurements and alerts only)."""
    out = {}
    for i, layout in enumerate(SHARD_LAYOUTS):
        batches = []
        for s in range(SHARD_WARMUP + SHARD_STEPS):
            b = synthetic_batch(
                packer, N_REGISTERED, SHARD_EVENTS, seed + 100 * i + s,
                p_types=((0.9, 0.0, 0.1) if layout == "packed"
                         else (0.6, 0.3, 0.1)))
            if layout == "full":
                b.elevation = torch.from_numpy(np.random.default_rng(
                    seed + s).uniform(1, 50, b.elevation.shape[0])
                    .astype(np.float32))
            batches.append(b)
        out[layout] = batches
    return out


def shard_schedule(traffic):
    """The steps in order: each layout's first step (the CPU-checked
    ones), then each layout's other warm-ups and timed steps. Returns
    [(layout, index, batch)]."""
    order = [(layout, 0, traffic[layout][0]) for layout in SHARD_LAYOUTS]
    for layout in SHARD_LAYOUTS:
        order += [(layout, i, b) for i, b in enumerate(traffic[layout])
                  if i]
    return order


def lane_digest(engine, view, out):
    """The step's fired rows as its alert lanes hold them, whatever the
    engine's layout: (number of rows, sha256 of the rows sorted), a row
    being (global device index, ts, the threshold / geofence / program /
    model fire, rule and level fields). It is what materialize_alerts
    builds its alerts from, without building them (each alert object
    costs ~14 us of host time, 0.4 s a step at this traffic)."""
    import hashlib

    from sitewhere_tpu_torch.ops.compact import decode_alert_lanes

    lanes = out.alert_lanes.cpu().numpy()
    dev, ts = np.asarray(view.device_idx), np.asarray(view.ts)
    S = getattr(engine, "n_shards", 1)
    if lanes.ndim == 2:
        lanes, dev, ts = lanes[None], dev[None], ts[None]
    parts = []
    for s in range(lanes.shape[0]):
        d = decode_alert_lanes(lanes[s])
        parts.append(np.stack([
            dev[s][d.rows].astype(np.int64) * S + s, ts[s][d.rows],
            d.thr_fired, d.thr_rule, d.thr_level, d.geo_fired, d.geo_rule,
            d.geo_level, d.prog_fired, d.prog_rule, d.prog_level,
            d.model_fired, d.model_slot], axis=1).astype(np.int64))
    rows = np.concatenate(parts)
    rows = rows[np.lexsort(rows.T[::-1])]
    return len(rows), hashlib.sha256(rows.tobytes()).hexdigest()


def sharded_step(engine, batch, materialize=True):
    """submit, then materialize or digest the lanes: ((step s: submit
    until the card is done, materialize s or None), alert keys or the
    lane digest, outputs)."""
    t0 = time.perf_counter()
    view, out = engine.submit_routed(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if not materialize:
        return (t1 - t0, None), lane_digest(engine, view, out), out
    alerts = engine.materialize_alerts(view, out)
    return (t1 - t0, time.perf_counter() - t1), _alert_keys(alerts), out


def _outputs_bits_equal(a, b, what, score_tol=False):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f).to(getattr(a, f).device)
        if f == "model_score" and score_tol:
            torch.testing.assert_close(x, y, rtol=SCORE_RTOL,
                                       atol=SCORE_ATOL)
        elif not torch.equal(_bits(x), _bits(y)):
            raise AssertionError(f"{what}: outputs field {f} differs")


def sharded_run(dev, card, mode, traffic, epoch, single_ref):
    """One sharded engine (SHARDS shards on the card, host or device
    routing) over the schedule: the first step of each layout held against
    the same engine on the CPU (outputs and state), every launch counted
    from 0, one capture a static configuration, the run's alerts and
    state against the single card engine's."""
    cpu = torch.device("cpu")
    routing = mode == "device"
    kw = dict(shards=SHARDS, device_routing=routing,
              alert_lane_capacity=SHARD_LANES)
    engine = build_world(dev, "auto", epoch, **kw)
    twin = build_world(cpu, "auto", epoch, **kw)
    schedule = shard_schedule(traffic)
    torch.cuda.synchronize()
    reset_launch_counts(engine)
    timed = {layout: [] for layout in SHARD_LAYOUTS}
    materialize, alerts = [], 0
    t_cpu = 0.0
    for n, (layout, i, batch) in enumerate(schedule):
        # the first step of each layout materializes its alerts (card ==
        # CPU == single engine); the others compare the lanes' digests
        first = n < len(SHARD_LAYOUTS)
        (wall, mat), got, out = sharded_step(engine, batch, first)
        want = single_ref["steps"][n]
        if (sorted(got) if first else got) != want:
            raise AssertionError(f"[sharded {mode}] step {n} ({layout}): "
                                 f"alerts differ from the single engine's")
        alerts += len(got) if first else got[0]
        if i >= SHARD_WARMUP:
            timed[layout].append(wall)
        if first:
            materialize.append(mat)
            t0 = time.perf_counter()
            _, cpu_keys, cpu_out = sharded_step(twin, batch)
            if cpu_keys != got:
                raise AssertionError(f"[sharded {mode}] {layout} first "
                                     f"step: card and CPU alerts differ")
            _outputs_bits_equal(cpu_out, out, f"[sharded {mode}] {layout}")
            assert_tree_bits_equal(twin.canonical_state(),
                                   engine.canonical_state(),
                                   f"[sharded {mode}] {layout} state")
            t_cpu += time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_counts(engine)
    steps = len(schedule)
    if launches["points_in_zones"] != SHARDS * steps:
        raise AssertionError(
            f"[sharded {mode}] B1 launched {launches['points_in_zones']} "
            f"times over {steps} steps of {SHARDS} shards")
    # one key a layout, and one more a layout a host spill ran on
    keys = len(SHARD_LAYOUTS) * (2 if engine.device_route_fallbacks else 1)
    if not (engine.graph_captures == len(engine._graphs) <= keys):
        raise AssertionError(f"[sharded {mode}] {engine.graph_captures} "
                             f"captures of {len(engine._graphs)} keys")
    if engine.device_route_dropped:
        raise AssertionError(f"[sharded {mode}] the device route dropped "
                             f"{engine.device_route_dropped} rows")
    if engine.pending_overflow:
        raise AssertionError(f"[sharded {mode}] rows left in the overflow "
                             f"backlog")
    assert_tree_bits_equal(single_ref["state"], engine.canonical_state(),
                           f"[sharded {mode}] state vs the single engine")
    missing = sorted(engine.presence_sweep())
    if missing != single_ref["missing"]:
        raise AssertionError(f"[sharded {mode}] presence transitions differ "
                             f"from the single card engine's")
    all_timed = [w for layout in SHARD_LAYOUTS for w in timed[layout]]
    valid = SHARD_EVENTS * len(all_timed)
    summary = {
        "mode": mode, "shards": SHARDS,
        "per_shard_batch": engine.batch_size, "events_a_step": SHARD_EVENTS,
        "steps": steps, "timed_steps": len(all_timed),
        "events_per_s": valid / sum(all_timed),
        "step_ms_p50": float(np.percentile(all_timed, 50) * 1e3),
        "step_ms_p99": float(np.percentile(all_timed, 99) * 1e3),
        "step_ms_p50_by_layout": {
            layout: float(np.percentile(timed[layout], 50) * 1e3)
            for layout in SHARD_LAYOUTS},
        "materialize_ms_first_steps": [m * 1e3 for m in materialize],
        "graph_captures": engine.graph_captures,
        "b1_launches": launches["points_in_zones"],
        "device_route_steps": engine.device_route_steps,
        "device_route_fallbacks": engine.device_route_fallbacks,
        "device_route_dropped": engine.device_route_dropped,
        "alerts": alerts, "presence_missing": len(missing),
        "cpu_check_s": t_cpu,
    }
    log(f"[sharded {mode}] {json.dumps(summary)} on {card}")
    del twin
    return engine, summary


def single_reference(dev, card, traffic, epoch):
    """The single card engine (phase 3's) over the same schedule: alerts,
    canonical state before its sweep, presence transitions, timings."""
    engine = build_world(dev, "auto", epoch, alert_lane_capacity=BATCH)
    steps, timed, materialize = [], [], []
    for n, (_, i, batch) in enumerate(shard_schedule(traffic)):
        first = n < len(SHARD_LAYOUTS)
        (wall, mat), got, _ = sharded_step(engine, batch, first)
        steps.append(sorted(got) if first else got)
        if i >= SHARD_WARMUP:
            timed.append(wall)
        if first:
            materialize.append(mat)
    ref = {"steps": steps, "state": engine.canonical_state(),
           "missing": sorted(engine.presence_sweep())}
    summary = {"events_per_s": SHARD_EVENTS * len(timed) / sum(timed),
               "step_ms_p50": float(np.percentile(timed, 50) * 1e3),
               "step_ms_p99": float(np.percentile(timed, 99) * 1e3),
               "materialize_ms_first_steps": [m * 1e3 for m in materialize],
               "timed_steps": len(timed),
               "alerts": sum(len(g) if n < len(SHARD_LAYOUTS) else g[0]
                             for n, g in enumerate(steps))}
    log(f"[sharded single] the single card engine over the same steps: "
        f"{json.dumps(summary)} on {card}")
    return engine, ref, summary


def routing_prologue_ms(engine, batch):
    """CUDA-event ms of the device route alone (ops/route.py) on one flat
    blob of the schedule, on the card: the sharded step's prologue."""
    from sitewhere_tpu_torch.ops.pack import batch_to_blob
    from sitewhere_tpu_torch.ops.route import device_route_chunk

    flat = engine._pack_flat_blob(batch)
    blob = torch.from_numpy(np.ascontiguousarray(flat)).to(engine.device)
    del flat
    S, B, C = engine.n_shards, engine.batch_size, engine.route_lane_capacity
    routed, dropped = device_route_chunk(blob, S, B, C)
    if int(dropped.sum()):
        raise AssertionError("the route dropped rows of a fitting batch")
    host, _ = engine.router.route_blob(batch_to_blob(
        batch, wire_rows=blob.shape[0]))
    if not torch.equal(routed.cpu(), torch.from_numpy(host)):
        raise AssertionError("the device route and the host router differ")
    return {"ms": time_cuda(lambda: device_route_chunk(blob, S, B, C)),
            "queued_ms": time_cuda_queued(
                lambda: device_route_chunk(blob, S, B, C)),
            "rows": int(blob.shape[0]), "lanes": int(blob.shape[1]),
            "lane_capacity": C}


def sharded_stateful(dev, card, epoch):
    """(b) Phase 5's world on SHARDS shards (device routing) on the card
    and on the CPU, SHARD_STATEFUL_STEPS steps: alerts, command fires,
    every state group and counter equal, scores within the tolerance; the
    rule-program kernel counted once a shard a step."""
    cpu = torch.device("cpu")
    engine = build_stateful_world(dev, epoch, shards=SHARDS)
    twin = build_stateful_world(cpu, epoch, shards=SHARDS)
    batches = [synthetic_batch(engine.packer, N_REGISTERED, SHARD_EVENTS,
                               SEED + 900 + s, mm_slots=(1, 2),
                               t_off_ms=1000 * s)
               for s in range(SHARD_STATEFUL_STEPS)]
    torch.cuda.synchronize()
    reset_launch_counts(engine)
    walls, _, alerts, fires, scores, snap, families, _ = run_stateful_trace(
        engine, batches, len(batches))
    launches = launch_counts(engine)
    want = SHARDS * len(batches)
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"[sharded stateful] {name} launched {n} "
                                 f"times; expected {want}")
    _, _, c_alerts, c_fires, c_scores, c_snap, _, _ = run_stateful_trace(
        twin, batches, len(batches))
    if c_alerts != alerts or c_fires != fires:
        raise AssertionError("[sharded stateful] card and CPU alerts or "
                             "command fires differ")
    compare_snapshots(snap, c_snap)
    worst = 0.0
    for got, ref in zip(scores, c_scores):
        torch.testing.assert_close(got, ref, rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)
        worst = max(worst, float((got - ref).abs().max()))
    summary = {"steps": len(batches), "launches": launches,
               "alerts": sum(len(a) for a in alerts),
               "fires": sum(len(f) for f in fires),
               "fired_rows_by_family": dict(zip(
                   ("threshold", "geofence", "program", "model"), families)),
               "score_max_abs_diff": worst,
               "step_ms": [w * 1e3 for w in walls]}
    if not (families[2] and families[3]):
        raise AssertionError("[sharded stateful] no program or model fired")
    log(f"[sharded stateful] card == CPU: {json.dumps(summary)} on {card}")
    return summary


def sharded_elastic(dev, card, engine, traffic, epoch):
    """(c) Save the SHARDS-shard engine, restore into 4 shards and into a
    single engine on the card; all three continue equal."""
    from sitewhere_tpu_torch.persist.checkpoint import PipelineCheckpointer

    four = build_world(dev, "auto", epoch + 1, shards=4,
                       alert_lane_capacity=BATCH // 4)
    single = build_world(dev, "auto", epoch + 2, alert_lane_capacity=BATCH)
    with tempfile.TemporaryDirectory(prefix="chip-sharded-") as tmp:
        ckpt = PipelineCheckpointer(tmp)
        t0 = time.perf_counter()
        path = ckpt.save(engine)
        save_s = time.perf_counter() - t0
        restore_s = []
        for other in (four, single):
            t0 = time.perf_counter()
            ckpt.restore(other, path)
            restore_s.append(time.perf_counter() - t0)
    engines = (engine, four, single)
    for eng in engines[1:]:
        assert_tree_bits_equal(engine.canonical_state(),
                               eng.canonical_state(), "[elastic] restored")
    after = shard_traffic(engine.packer, SEED + 950)["compact"][
        :SHARD_AFTER_RESTORE]
    for k, batch in enumerate(after):
        keys = [sorted(sharded_step(e, batch)[1]) for e in engines]
        if keys[1] != keys[0] or keys[2] != keys[0]:
            raise AssertionError(f"[elastic] step {k}: alerts differ "
                                 f"after the restore")
    for eng in engines[1:]:
        assert_tree_bits_equal(engine.canonical_state(),
                               eng.canonical_state(), "[elastic] continued")
    summary = {"save_s": save_s, "restore_s_4_shards": restore_s[0],
               "restore_s_single": restore_s[1],
               "steps_after": len(after)}
    log(f"[sharded elastic] {SHARDS} shards -> 4 shards and -> single, "
        f"continued equal: {json.dumps(summary)} on {card}")
    return summary


def router_bench(card):
    """(d) The port's host router at the micro-bench's shape: the native
    and numpy route_blob, route_columns and the fused pack + route, median
    ms of ROUTER_REPS runs each, after one warm run."""
    from sitewhere_tpu_torch.ops.pack import EventBatch, batch_to_blob
    from sitewhere_tpu_torch.parallel.router import ShardRouter

    n, S, B = ROUTER_BENCH
    rng = np.random.default_rng(SEED)
    et = rng.integers(0, 3, n).astype(np.int32)
    batch = EventBatch(
        device_idx=rng.integers(0, 1_000_000, n).astype(np.int32),
        tenant_idx=np.zeros(n, np.int32), event_type=et,
        ts=rng.integers(0, 100_000, n).astype(np.int32),
        mm_idx=np.where(et == 0, rng.integers(0, 8, n), 0).astype(np.int32),
        value=rng.uniform(-50, 50, n).astype(np.float32),
        lat=np.where(et == 1, rng.uniform(-90, 90, n), 0).astype(np.float32),
        lon=np.where(et == 1, rng.uniform(-180, 180, n), 0)
        .astype(np.float32),
        elevation=np.zeros(n, np.float32),
        alert_type_idx=np.where(et == 2, rng.integers(0, 8, n), 0)
        .astype(np.int32),
        alert_level=rng.integers(0, 5, n).astype(np.int32),
        valid=np.ones(n, bool))
    blob = batch_to_blob(batch)
    router = ShardRouter(S, B)
    nat, nat_over = router.route_blob(blob)
    plain, plain_over = router.route_blob_plain(blob)
    if not (np.array_equal(nat, plain) and np.array_equal(nat_over,
                                                          plain_over)):
        raise AssertionError("the native and numpy routers differ")

    def median_ms(fn):
        fn()
        samples = []
        for _ in range(ROUTER_REPS):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    out = {"n": n, "shards": S, "per_shard_batch": B,
           "wire_rows": int(blob.shape[0]),
           "route_blob_native_ms": median_ms(lambda: router.route_blob(blob)),
           "route_blob_numpy_ms": median_ms(
               lambda: router.route_blob_plain(blob)),
           "route_columns_ms": median_ms(lambda: router.route_columns(batch)),
           "route_batch_native_ms": median_ms(
               lambda: router.route_batch(batch))}
    log(f"[sharded router] host ms at the micro-bench shape: "
        f"{json.dumps(out)} (host of {card})")
    return out


def landing_engine(dev, epoch):
    """Phase 12's device-routing sharded engine of phase 3's world, its
    params built before any traffic, with a flight recorder."""
    from sitewhere_tpu_torch.runtime.flight import FlightRecorder

    engine = build_world(dev, "auto", epoch, shards=SHARDS,
                         device_routing=True,
                         alert_lane_capacity=SHARD_LANES)
    engine.flight = FlightRecorder(capacity=64)
    engine._ensure_params()
    return engine


def landing_records(epoch):
    """FEEDER_RECORDS records of SHARD_EVENTS wire frames of phase 3's
    traffic, record r holding the devices of class r % FEEDER_CLASSES by
    (d // SHARDS), so every shard gets its even share of a record and
    records that share devices share a partition at 1 or 2 workers; then
    the skewed record, SHARD_SKEW_EVENTS frames of dev-1 (class 0, as its
    position FEEDER_RECORDS is), which no device-route lane holds."""
    rng = np.random.default_rng(SEED + 710)
    records = [encode_delivery(rng, epoch, N_REGISTERED, SHARD_EVENTS, 0,
                               device_class=r % FEEDER_CLASSES,
                               class_stride=SHARDS)[1]
               for r in range(FEEDER_RECORDS)]
    skew = encode_delivery(rng, epoch, 1, SHARD_SKEW_EVENTS, 0)[1]
    return records, skew


def inline_sharded_landing(dev, epoch, records, skew, card):
    """The records through FastWireIngest + submit on one landing engine:
    each uniform record takes the device route (its flat blob is the key),
    the skewed one the host route; the lanes' digest a record, the state
    before the sweep and the sweep's transitions."""
    from sitewhere_tpu_torch.parallel.engine import DeviceRoutedView
    from sitewhere_tpu_torch.sources.fastlane import FastWireIngest

    engine = landing_engine(dev, epoch)
    ingest = FastWireIngest(engine.packer)
    alerts, keys, walls = {}, [], []
    for data in records + [skew]:
        res = ingest.ingest(data)
        if len(res.batches) != 1:
            raise AssertionError("a landing record is not one batch")
        t0 = time.perf_counter()
        view, out = engine.submit_routed(res.batches[0])
        if data is skew:
            if isinstance(view, DeviceRoutedView) or \
                    engine.device_route_fallbacks != 1:
                raise AssertionError("the skewed record took the device "
                                     "route inline")
            continue
        if not isinstance(view, DeviceRoutedView):
            raise AssertionError("a uniform record left the device route")
        key = _blob_key(view.blob)
        alerts[key] = lane_digest(engine, view, out)
        keys.append(key)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    if engine.pending_overflow:
        raise AssertionError("the inline landing left an overflow backlog")
    ref = {"alerts": alerts, "keys": keys,
           "state": engine.canonical_state(),
           "missing": sorted(engine.presence_sweep())}
    readings = {"events_per_s_after_first": (len(walls) - 1) * SHARD_EVENTS
                / sum(walls[1:]),
                "record_ms_p50": statistics.median(walls[1:]) * 1e3,
                "fired_rows": sum(a[0] for a in alerts.values())}
    log(f"[sharded landing] inline FastWireIngest + submit: "
        f"{json.dumps(readings)} on {card}")
    del engine
    return ref, readings


class _ShardedLanding(_Landing):
    """A landing host over a device-routing sharded engine: the hook keeps
    the blob the service stages through `stage_prepared` and digests the
    step's lanes (`lane_digest`) instead of materializing ~29,000 alerts."""

    events_per_blob = SHARD_EVENTS

    def _see_staged_blobs(self):
        stage_prepared = self.engine.stage_prepared

        def staging(prepared, **kw):
            self.blob = prepared.blob
            return stage_prepared(prepared, **kw)

        self.engine.stage_prepared = staging

    def _alerts(self, engine, outputs):
        from sitewhere_tpu_torch.parallel.engine import DeviceRoutedView

        return lane_digest(engine, DeviceRoutedView(self.blob, engine.router),
                           outputs)


def sharded_landing_run(dev, epoch, records, skew, ref, n, card):
    """(f) at `n` worker threads: the uniform records land on the device
    route, each once with the inline run's flat blob and lanes, flight
    records of the landing's segments only; then the skewed record, which
    the worker's guard sends down the counted spill; B1 SHARDS launches a
    landed record, one capture a static configuration, state and presence
    transitions equal the inline run's."""
    what = f"(f) sharded landing, {n} worker thread(s)"
    engine = landing_engine(dev, epoch)
    lb = _ShardedLanding(dev, epoch, records, n, engine=engine)
    spills = lb.metrics.counter("feeder.guard_spills")
    try:
        reset_launch_counts(engine)
        t0 = time.perf_counter()
        workers = _thread_workers(lb.server.port, n, f"s{n}")
        t_ready = time.perf_counter()
        for w in workers:
            w.start()
        try:
            lb.wait(len(records), what)
            readings = lb.readings(t_ready, time.perf_counter() - t0)
            lb.publish_at(len(records), skew)
            lb.wait(len(records) + 1, what + ", the skewed record")
        finally:
            for w in workers:
                w.stop()
        torch.cuda.synchronize()
        launches = launch_counts(engine)["points_in_zones"]
        keys = [k for k, _ in lb.steps]
        if sorted(keys) != sorted(ref["keys"]):
            raise AssertionError(f"{what}: landed blobs are not the inline "
                                 f"flat blobs, each once")
        for key, digest in lb.steps:
            if digest != ref["alerts"][key]:
                raise AssertionError(f"{what}: a blob's lanes differ from "
                                     f"the inline step's")
        if spills.value != 1:
            raise AssertionError(f"{what}: {spills.value} guard spills")
        if launches != SHARDS * (len(records) + 1):
            raise AssertionError(f"{what}: B1 launched {launches} times for "
                                 f"{len(records) + 1} records")
        if not engine.graph_captures == len(engine._graphs) <= 2:
            raise AssertionError(f"{what}: {engine.graph_captures} captures "
                                 f"of {len(engine._graphs)} keys")
        recs = engine.flight.export(last_n=len(keys) + 1)["records"][:-1]
        extra = {st for r in recs for st in r["stages"]} - LANDING_SEGMENTS
        if extra:
            raise AssertionError(f"{what}: flight records hold {extra}")
        if engine.pending_overflow:
            raise AssertionError(f"{what}: rows left in the overflow "
                                 f"backlog")
        assert_tree_bits_equal(ref["state"], engine.canonical_state(),
                               f"{what} canonical state")
        if sorted(engine.presence_sweep()) != ref["missing"]:
            raise AssertionError(f"{what}: presence transitions differ")
        readings.update(guard_spills=spills.value, b1_launches=launches,
                        graph_captures=engine.graph_captures,
                        device_route_fallbacks=engine.device_route_fallbacks)
        log(f"[sharded landing] {what} over busnet == inline (blobs, lanes, "
            f"state, presence; the skewed record spilled once; B1 "
            f"{launches} launches for {len(records) + 1} records): "
            f"{json.dumps(readings)} on {card}")
        return readings, launches
    finally:
        lb.close()
        del lb, engine
        torch.cuda.empty_cache()


def sharded_landing(dev, card, epoch):
    """(f): the feeders' sharded landing at 1 and 2 worker threads against
    the inline run. Returns the readings and B1's launches."""
    t0 = time.perf_counter()
    records, skew = landing_records(epoch)
    out = {"records": len(records), "events_a_record": SHARD_EVENTS,
           "skewed_events": SHARD_SKEW_EVENTS,
           "encode_s": time.perf_counter() - t0}
    ref, out["inline"] = inline_sharded_landing(dev, epoch, records, skew,
                                                card)
    launches = 0
    for n in LANDING_THREADS:
        out[f"threads_{n}"], k = sharded_landing_run(
            dev, epoch, records, skew, ref, n, card)
        launches += k
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def _feeder_process(port, tmp, name="serve-feeder"):
    """`python -m sitewhere_tpu_torch serve --feeder` against the bus edge
    at `port`, up (its hello and leases done) when this returns."""
    import re

    proc = subprocess.Popen(
        [sys.executable, "-m", "sitewhere_tpu_torch", "serve", "--feeder",
         "--feeder-connect", f"127.0.0.1:{port}", "--feeder-name", name,
         "--data-dir", f"{tmp}/{name}"], cwd=REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("serve --feeder did not come up:\n"
                                 + "".join(lines))
        lines.append(line)
        if re.search(r"feeder '.*' serving", line):
            return proc


def _stop(proc, what):
    import signal

    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}:\n{proc.stdout.read()}")


def _window_cells(keys):
    """{key id: (count, sum, mean, min, max)} of a windows answer."""
    return {k["id"]: tuple(tuple(k[f]) for f in ("count", "sum", "mean",
                                                   "min", "max"))
            for k in keys}


def _cpu_window_cells(ids, date, values, window_ms, shards):
    """The same answer from the port on the CPU: the rows' report over an
    `shards`-shard mesh, as the REST route renders it."""
    from sitewhere_tpu_torch.analytics.engine import WindowedAnalyticsEngine
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    report = WindowedAnalyticsEngine._build_report(
        np.asarray(ids, np.int64), np.full(len(ids), date, np.int64),
        np.asarray(values, np.float32), window_ms=window_ms, start_ms=None,
        end_ms=None, max_windows=1024, device="cpu",
        mesh=make_mesh(shards, device="cpu"))

    def col(grid, row):
        return tuple(v if v == v and abs(v) != float("inf") else None
                     for v in (float(x) for x in
                               grid[row, :report.n_windows]))

    return {int(report.key_ids[r]): (
        tuple(int(c) for c in report.stats.count[r, :report.n_windows]),
        *(col(getattr(report.stats, f), r)
          for f in ("sum", "mean", "min", "max")))
        for r in range(report.num_keys)}


def serve_sharded_drive(device_arg, shards=SERVE_SHARDS, env_extra=None,
                        timeout_s=300.0, feeders=False):
    """`python -m sitewhere_tpu_torch serve --shards N` as a user runs it:
    boot with a bus edge, provision SERVE_DEVICES devices over REST, send
    one decoded-events request a device over the edge into the sharded
    step, read every device's state back over REST (its last measurement
    must be the one sent), and exit 0 on SIGTERM. With `feeders`, the
    instance also mounts the feeder fleet's landing (`--feeders`) and
    routes every window query of one row or more to its mesh: one `serve
    --feeder` process lands a wire frame a device (every state must show
    it), then a window query over REST must take the mesh route and answer
    what the port on the CPU answers for the persisted rows."""
    import os
    import re

    import msgpack

    from sitewhere_tpu_torch.client.rest import SiteWhereClientError
    from sitewhere_tpu_torch.model.common import _asdict
    from sitewhere_tpu_torch.model.event import (
        DeviceEventBatch, DeviceMeasurement)
    from sitewhere_tpu_torch.runtime.bus import TopicNaming
    from sitewhere_tpu_torch.runtime.busnet import BusClient

    env = dict(os.environ, PYTHONUNBUFFERED="1", **(env_extra or {}))
    args = ["--feeders"] if feeders else []
    if feeders:
        env["SWTPU_SERVING__MESH_ROW_THRESHOLD"] = "1"
    with tempfile.TemporaryDirectory(prefix="chip-serve-") as tmp:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sitewhere_tpu_torch", "serve",
             "--port", "0", "--bus-port", "0", "--device", device_arg,
             "--shards", str(shards), "--data-dir", f"{tmp}/data", *args],
            cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        try:
            t0, seen, lines = time.perf_counter(), {}, []
            patterns = {"url": r"REST gateway : (http://\S+)",
                        "bus": r"bus edge     : tcp://[^:]+:(\d+)",
                        "shards": r"shards       : (\d+)"}
            if feeders:
                patterns["frames"] = r"feeder fleet : topic (\S+)"
            while (len(seen) < len(patterns)
                   and time.perf_counter() - t0 < timeout_s):
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                for key, pattern in patterns.items():
                    m = re.search(pattern, line)
                    if m:
                        seen[key] = m.group(1)
            assert len(seen) == len(patterns), \
                "serve did not come up:\n" + "".join(lines)
            boot_s = time.perf_counter() - t0
            rest = rest_client(seen["url"])
            topology = rest.get("/api/instance/topology")
            rest.create_device_type({"token": "dt-shard", "name": "S"})
            tokens = [f"shard-dev-{i}" for i in range(SERVE_DEVICES)]
            for i, token in enumerate(tokens):
                rest.create_device({"token": token,
                                    "device_type_token": "dt-shard"})
                rest.create_assignment({"token": f"shard-as-{i}",
                                        "device_token": token})
            topic = TopicNaming(instance=topology["instance_id"]) \
                .event_source_decoded_events("default")
            values = {token: 10.0 + i for i, token in enumerate(tokens)}
            now = int(time.time() * 1000)
            client = BusClient("127.0.0.1", int(seen["bus"]))
            t_ingest = time.perf_counter()
            try:
                for token in tokens:
                    batch = DeviceEventBatch(
                        device_token=token, measurements=[DeviceMeasurement(
                            name="temp", value=values[token],
                            event_date=now)])
                    client.publish(topic, token.encode(), msgpack.packb({
                        "sourceId": "chip-smoke", "deviceToken": token,
                        "kind": "DeviceEventBatch",
                        "request": _asdict(batch), "metadata": {}},
                        use_bin_type=True))
            finally:
                client.close()

            def states(want, since):
                got, pending = {}, list(tokens)
                while pending and time.perf_counter() - since < timeout_s:
                    token = pending[0]
                    try:
                        state = rest.get(f"/api/devicestates/{token}")
                    except SiteWhereClientError as exc:
                        if exc.status != 404:   # no state until its step
                            raise
                        time.sleep(0.2)
                        continue
                    value = state.get("last_measurements", {}).get("temp")
                    if value is None or float(value[1]) != want[token]:
                        time.sleep(0.2)
                        continue
                    got[token] = float(value[1])
                    pending.pop(0)
                assert not pending, f"{len(pending)} devices never folded"
                return got

            ingested = states(values, t_ingest)
            ingest_s = time.perf_counter() - t_ingest
            out = {"shards": int(seen["shards"]), "boot_s": boot_s,
                   "ingest_and_read_s": ingest_s, "events": len(tokens),
                   "ingested": len(ingested),
                   "state_value": ingested[tokens[-1]],
                   "last_value": values[tokens[-1]],
                   "device": topology["device"],
                   "mesh": topology.get("mesh")}
            if feeders:
                out.update(_serve_feeder_and_window(
                    rest, seen, tmp, tokens, values, now, shards, states))
            _stop(proc, "serve")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return out


def _serve_feeder_and_window(rest, seen, tmp, tokens, values, now, shards,
                             states):
    """serve_sharded_drive's feeder landing and mesh-routed window query
    (its `feeders` half)."""
    from sitewhere_tpu_torch.runtime.busnet import BusClient
    from sitewhere_tpu_torch.transport.wire import (
        MessageType, WireCodec, encode_frame)

    t0 = time.perf_counter()
    feeder = _feeder_process(seen["bus"], tmp)
    try:
        landed = {token: 100.0 + i for i, token in enumerate(tokens)}
        client = BusClient("127.0.0.1", int(seen["bus"]))
        t_land = time.perf_counter()
        try:
            for token in tokens:
                client.publish(seen["frames"], token.encode(), encode_frame(
                    MessageType.MEASUREMENT, WireCodec.encode_measurement(
                        token, now + 1, "temp", landed[token])))
        finally:
            client.close()
        states(landed, t_land)
        land_s = time.perf_counter() - t_land
        _stop(feeder, "serve --feeder")
    finally:
        if feeder.poll() is None:
            feeder.kill()
            feeder.wait(timeout=30)
    t_query = time.perf_counter()
    answer = rest.get("/api/analytics/windows?window_ms=60000&keys=256")
    query_s = time.perf_counter() - t_query
    if answer["serving"]["route"] != "mesh":
        raise AssertionError(f"the window query took "
                             f"{answer['serving']['route']}, not the mesh")
    got = _window_cells(answer["keys"])
    ids = [k["id"] for k in answer["keys"]]
    by_id = {k["id"]: values[k["token"]] for k in answer["keys"]}
    want = _cpu_window_cells(ids, now, [by_id[i] for i in ids],
                             answer["window_ms"], shards)
    if len(got) != len(tokens) or got != want:
        raise AssertionError(f"the mesh-routed window answer differs from "
                             f"the CPU's: {len(got)} keys")
    return {"feeder_landed": len(tokens), "feeder_land_and_read_s": land_s,
            "feeder_s": time.perf_counter() - t0, "window_route": "mesh",
            "window_keys": len(got), "window_query_s": query_s}


def phase_sharded(dev, card):
    """Phase 12: the sharded path on the card (see the module docstring).
    Returns the summary; its `b1_launches` and `rule_launches` are the
    kernels' launches on the sharded path, `landing["launches"]` B1's on
    the feeders' sharded landing."""
    t_phase = time.perf_counter()
    epoch = int(time.time() * 1000) - EPOCH_LAG_MS
    single, single_ref, single_sum = None, None, None
    t0 = time.perf_counter()
    world = build_world(dev, "auto", epoch, shards=SHARDS)
    traffic = shard_traffic(world.packer, SEED + 700)
    log(f"[sharded] {SHARDS} shards x {world.batch_size} rows, "
        f"{len(SHARD_LAYOUTS)} layouts x {SHARD_WARMUP + SHARD_STEPS} "
        f"flat batches of {SHARD_EVENTS} events built in "
        f"{time.perf_counter() - t0:.2f} s")
    del world
    single, single_ref, single_sum = single_reference(dev, card, traffic,
                                                      epoch)
    runs = {}
    engines = {}
    for mode in ("host", "device"):
        engines[mode], runs[mode] = sharded_run(dev, card, mode, traffic,
                                                epoch, single_ref)
    device_eng = engines["device"]
    compact = traffic["compact"]
    prologue = routing_prologue_ms(device_eng, compact[0])
    log(f"[sharded] routing prologue (ops/route.py, CUDA events): "
        f"{json.dumps(prologue)} on {card}")
    profiles = {"single": profile_engine(single, compact, n_prof=3)}
    for mode, eng in engines.items():
        profiles[mode] = profile_engine(eng, compact, n_prof=3)
    for name, prof in profiles.items():
        log(f"[sharded] profiler ({name}): {json.dumps(prof)} on {card}")
    del single
    stateful = sharded_stateful(dev, card, epoch)
    elastic = sharded_elastic(dev, card, device_eng, traffic, epoch)
    del engines, device_eng
    torch.cuda.empty_cache()
    landing = sharded_landing(dev, card, epoch)
    router = router_bench(card)
    t0 = time.perf_counter()
    serve = serve_sharded_drive("cuda", feeders=True)
    serve["wall_s"] = time.perf_counter() - t0
    if serve["device"]["type"] != "cuda":
        raise AssertionError(f"serve ran on {serve['device']}")
    log(f"[sharded serve] {json.dumps(serve)} on {card}")
    summary = {
        "single": single_sum, "host": runs["host"], "device": runs["device"],
        "routing_prologue": prologue,
        "idle_share": {k: p["device_idle_share"] for k, p in
                       profiles.items()},
        "busy_ms_per_step": {k: p["device_busy_ms_per_step"] for k, p in
                             profiles.items()},
        "stateful": stateful, "elastic": elastic, "landing": landing,
        "router": router, "serve": serve,
        "b1_launches": (runs["host"]["b1_launches"]
                        + runs["device"]["b1_launches"]),
        "rule_launches": stateful["launches"]["eval_rule_programs"],
        "seconds": time.perf_counter() - t_phase}
    log(f"[sharded] phase 12 took {summary['seconds']:.1f} s: "
        f"device route p50 {runs['device']['step_ms_p50']:.2f} ms / p99 "
        f"{runs['device']['step_ms_p99']:.2f} ms, host route p50 "
        f"{runs['host']['step_ms_p50']:.2f} ms, single engine p50 "
        f"{single_sum['step_ms_p50']:.2f} ms, sharded landing "
        f"{landing['threads_1']['events_per_s_after_first']:.0f} events/s "
        f"after the first blob at 1 worker, on {card}")
    return summary


# -- phase 13: the multi-host data plane --------------------------------------

# two processes, each holding SHARDS / 2 shards of phase 12's world over the
# cards `cluster_layout` gives it; each feeds 15/16 of its half of S x B a
# tick, so that a tick's own rows and the peer's forwarded ones fit a
# shard's rows together
CLUSTER_PROCS = 2
CLUSTER_EVENTS = SHARD_EVENTS // CLUSTER_PROCS
# (a)'s timed ticks: 6 (10 before) keeps phase 13 near its ~105 s on one card
CLUSTER_WARMUP, CLUSTER_TICKS, CLUSTER_PROFILED = 3, 6, 2
# a tick's traffic is dated CLUSTER_TICK_MS after the last's (no two ticks
# share a timestamp, whichever step a forwarded row folds in)
CLUSTER_TICK_MS = 1100
CLUSTER_CHILD_S = 300          # a child's deadline
CLUSTER_HEARTBEAT_S, CLUSTER_STALE_S = 0.5, 3.0
CLUSTER_FAIL_AFTER_S = 10.0    # (c): the watchdog's gang-exit bound
CLUSTER_WATCHDOG_CHECK_S = 0.1  # how often the watchdog looks
CLUSTER_REPLAY_BATCHES, CLUSTER_REPLAY_ROWS = 2, 4096
# (d): the multi-process mesh query's rows, keys and windows
CLUSTER_QUERY_ROWS, CLUSTER_QUERY_K, CLUSTER_QUERY_W = 4_194_304, 131_072, 16
CLUSTER_QUERY_WINDOW_MS = 60_000
CLUSTER_QUERY_REPS = 3
# the file whose creation lets the restore pair leave its wait
CLUSTER_GO = "go-restore"
# (b): decoded records each host gets for its peer's devices
SERVE_CLUSTER_RECORDS = 64
SERVE_CLUSTER_DEVICES = 160


def cluster_layout():
    """Phase 13's layout by the visible cards: each child's
    CUDA_VISIBLE_DEVICES (None: the parent's), its device argument (one
    card, or a comma-separated list of card blocks), the cards a child
    holds, the cards a `serve --cluster-coordinator` host of SHARDS shards
    takes (every card it sees) and the collectives backend all must pick.
    Four or more visible: two cards each, NCCL; two or three: one each,
    NCCL; one: two blocks on cuda:0 each (a serve host: the one card), both
    processes on the one card, gloo."""
    import os

    n = torch.cuda.device_count()
    ids = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ids.split(",")[:n] if ids else [str(k) for k in range(n)]
    if n >= 4:
        return {"visible": [",".join(ids[0:2]), ",".join(ids[2:4])],
                "device": "cuda", "cards": 2, "serve_cards": 2,
                "backend": "nccl"}
    if n >= 2:
        return {"visible": ids[0:2], "device": "cuda", "cards": 1,
                "serve_cards": 1, "backend": "nccl"}
    return {"visible": [None, None], "device": "cuda:0,cuda:0", "cards": 2,
            "serve_cards": 1, "backend": "gloo"}


def _child_env(visible):
    """The environment of a child that sees the cards `visible` (None:
    the parent's)."""
    import os

    env = dict(os.environ)
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    return env


def cluster_traffic(packer):
    """Every tick's flat batch of phase 3's traffic (SHARD_EVENTS events,
    tick t dated t * CLUSTER_TICK_MS after the first): what the single
    reference engine takes a tick, and what the hosts share out."""
    return [synthetic_batch(packer, N_REGISTERED, SHARD_EVENTS,
                            SEED + 1300 + t, t_off_ms=t * CLUSTER_TICK_MS)
            for t in range(CLUSTER_WARMUP + CLUSTER_TICKS
                           + CLUSTER_PROFILED)]


def entering_host(device_idx, n_shards):
    """The host a device's rows enter through: (d // S) % 2, so that for
    half the devices it is not the owner ((d % S) // (S / 2))."""
    return (np.asarray(device_idx) // n_shards) % CLUSTER_PROCS


def host_share(batch, pid, n_shards):
    """The rows of `batch` that enter through host `pid`, in order."""
    from sitewhere_tpu_torch.parallel.engine import ShardedPipelineEngine

    valid = np.asarray(batch.valid)
    rows = np.nonzero(valid & (entering_host(batch.device_idx, n_shards)
                               == pid))[0]
    return ShardedPipelineEngine._slice_flat(batch, rows)


def cluster_query_rows():
    """(d)'s replay rows: keys, in-range window offsets, values spanning
    eleven decades, 10% invalid."""
    rng = np.random.default_rng(SEED + 1313)
    n, K, W = CLUSTER_QUERY_ROWS, CLUSTER_QUERY_K, CLUSTER_QUERY_W
    return (rng.integers(0, K, n).astype(np.int32),
            rng.integers(0, W * CLUSTER_QUERY_WINDOW_MS, n).astype(np.int32),
            (rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n))
            .astype(np.float32),
            rng.random(n) > 0.1)


def stats_digest(stats):
    """sha256 of every grid's bytes (f32 as bit patterns)."""
    import hashlib

    h = hashlib.sha256()
    for f in ("count", "sum", "mean", "min", "max"):
        h.update(getattr(stats, f).contiguous().view(torch.int32)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _cluster_pair(role, tmp, epoch, layout):
    coord, bus0, bus1 = _free_port(), _free_port(), _free_port()
    return [_HostLog([__file__, "--cluster-child", role, str(pid),
                    f"127.0.0.1:{coord}", str(bus0), str(bus1), tmp,
                    str(epoch), layout["device"]],
                     f"cluster child {role} {pid}",
                     env=_child_env(layout["visible"][pid]))
            for pid in range(CLUSTER_PROCS)]


def _percentiles(ms):
    """(p50, p99) of a list of ms, None for an empty list."""
    if not ms:
        return None
    return [float(np.percentile(ms, 50)), float(np.percentile(ms, 99))]


def cluster_child_main(argv):
    """One host of phase 13's data plane (`--cluster-child ROLE PID COORD
    BUS0 BUS1 DIR EPOCH DEVICE`, DEVICE "cuda" for every visible card or
    card blocks "cuda:0,cuda:0"): ROLE `run` does (a), (d) and (c)'s save
    and post-checkpoint records, then waits to be killed (host 1) or for
    its watchdog (host 0); ROLE `restore` boots from the checkpoint and
    replays. Prints its cards and backend (CARDS), RESULT {json}; writes
    its blocks under DIR."""
    import os

    import torch.distributed as dist

    from sitewhere_tpu_torch.ops.segsum import segment_row_sum
    from sitewhere_tpu_torch.parallel.cluster import (
        FOREIGN_ROWS_GROUP, ClusterControl, ClusterStepLoop,
        ForeignRowForwarder, ForeignRowsConsumer, PeerWatchdog,
        ProcessStateReporter, TopologyAggregator, encode_rows,
        foreign_rows_topic)
    from sitewhere_tpu_torch.parallel.distributed import (
        card_identity, initialize, make_global_mesh, sharded_windowed_stats)
    from sitewhere_tpu_torch.persist.checkpoint import PipelineCheckpointer
    from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming
    from sitewhere_tpu_torch.runtime.busnet import BusClient, BusServer

    role, pid, coord = argv[0], int(argv[1]), argv[2]
    ports, tmp, epoch = [int(argv[3]), int(argv[4])], argv[5], int(argv[6])
    peer = 1 - pid
    out = {"pid": pid, "role": role}
    spec = argv[7].split(",")
    dev = torch.device("cuda", 0) if spec == ["cuda"] else torch.device(
        spec[0])
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    if role == "restore":
        # booted while host 0 of the first pair waits out its watchdog;
        # its bus directory is free once the parent writes the go file
        go = time.monotonic() + CLUSTER_CHILD_S
        while not os.path.exists(f"{tmp}/{CLUSTER_GO}"):
            if time.monotonic() > go:
                raise AssertionError("no go file by the deadline")
            time.sleep(0.02)
    t0 = time.perf_counter()
    initialize(coord, num_processes=CLUSTER_PROCS, process_id=pid)
    mesh = (make_global_mesh(n_shards=SHARDS, devices=spec) if len(spec) > 1
            else make_global_mesh(n_shards=SHARDS, device=spec[0]))
    cards = list(mesh.cards)
    print(f"CARDS host {pid}: {', '.join(map(str, cards))} "
          f"({', '.join(card_identity(c) for c in cards)}), shards "
          f"{mesh.local_shards}, collectives {mesh.collectives}", flush=True)
    out["cards"] = [str(c) for c in cards]
    out["collectives"] = mesh.collectives
    engine = build_world(dev, "auto", epoch, shards=SHARDS, mesh=mesh,
                         alert_lane_capacity=SHARD_LANES)
    out["boot_s"] = time.perf_counter() - t0
    assert engine.is_multiprocess and not engine.device_routing
    lo = engine.local_shards[0]

    naming = TopicNaming(instance="chip-cluster")
    topic = foreign_rows_topic(naming)
    bus = EventBus(partitions=1, data_dir=f"{tmp}/bus{pid}")
    server = BusServer(bus, host="127.0.0.1", port=ports[pid])
    server.start()
    peers = {peer: BusClient("127.0.0.1", ports[peer])}
    forwarder = ForeignRowForwarder(pid, peers, naming, local_bus=bus)
    control = ClusterControl(mesh)
    alerts, fwd_ticks, fold_ticks = [], [], []
    loop = None

    def forward(batch):
        forwarder.forward(engine, batch)
        fwd_ticks.append(loop.tick_count)

    def on_fatal(exc):
        print(f"[cluster {pid}] step loop died: {exc!r}", flush=True)
        os._exit(13)

    loop = ClusterStepLoop(engine, control=control, idle_interval_s=0.002,
                           on_alerts=lambda a: alerts.extend(_alert_keys(a)),
                           forward_foreign=forward, on_fatal=on_fatal)

    def owns(token):
        return engine.owns(engine.packer.devices.lookup(token))

    consumer = ForeignRowsConsumer(
        bus, naming, engine, loop, owner_check=owns,
        on_folded=lambda records: fold_ticks.extend(
            loop.tick_count for _ in records))
    def peer_lost(stale):
        print(f"PEER_LOSS {time.time()!r}", flush=True)
        os._exit(13)

    aggregator = TopologyAggregator(bus, naming,
                                    stale_after_s=CLUSTER_STALE_S)
    reporter = ProcessStateReporter(
        pid, bus, naming, peers, build_state=lambda: {"tick": loop.tick_count},
        interval_s=CLUSTER_HEARTBEAT_S)
    watchdog = PeerWatchdog(aggregator, [peer],
                            fail_after_s=CLUSTER_FAIL_AFTER_S,
                            check_interval_s=CLUSTER_WATCHDOG_CHECK_S,
                            on_peer_loss=peer_lost)
    for part in (aggregator, reporter, watchdog):
        part.start()

    def folded():
        """Wait until every record of the foreign topic has folded (its
        consumer committed past it) and nothing is queued or parked."""
        deadline = time.monotonic() + 120
        group = bus.consumer(topic, FOREIGN_ROWS_GROUP)
        while (sum(group.committed) < sum(bus.topic(topic).end_offsets())
               or loop._q or engine.pending_overflow
               or loop._pending_tickets):
            if loop.fatal is not None:
                raise AssertionError(f"loop died: {loop.fatal!r}")
            if time.monotonic() > deadline:
                raise AssertionError("forwarded rows never folded")
            time.sleep(0.01)

    def run_ticks(batches):
        for batch in batches:
            if not loop.feed(batch).wait(120):
                raise AssertionError("a tick's rows never folded")

    def blocks():
        return engine.local_state_shards()[1]

    ckpt = PipelineCheckpointer(f"{tmp}/ckpt{pid}")
    group = bus.consumer(topic, FOREIGN_ROWS_GROUP)
    if role == "restore":
        t = time.perf_counter()
        offsets = ckpt.restore(engine)
        out["restore_s"] = time.perf_counter() - t
        for key, saved in offsets.items():
            name, _, gid = key.rpartition("@")
            g = bus.consumer(name, gid)
            g.committed = list(saved)
            g.seek_to_committed()
        want = np.load(f"{tmp}/a{pid}.npz")
        got = blocks()
        for name in want.files:
            if not np.array_equal(want[name].view(np.uint8),
                                  got[name].view(np.uint8)):
                raise AssertionError(f"restored block {name} differs")
        dist.barrier()
        t = time.perf_counter()
        consumer.start()
        loop.start()
        folded()
        out["replay_s"] = time.perf_counter() - t
        out["replayed_rows"] = consumer.consumed_rows
        out["replay_ticks"] = loop.tick_count
        dist.barrier()
        loop.stop()
        want = np.load(f"{tmp}/before{pid}.npz")
        got = blocks()
        for name in want.files:
            if not np.array_equal(want[name].view(np.uint8),
                                  got[name].view(np.uint8)):
                raise AssertionError(f"replayed block {name} differs from "
                                     f"the one before the kill")
        out["blocks_equal_after_replay"] = True
        print("RESULT " + json.dumps(out), flush=True)
        for part in (watchdog, reporter, aggregator, consumer):
            part.stop()
        server.stop()
        return 0

    # (a) the data plane at full width
    traffic = cluster_traffic(engine.packer)
    shares = [host_share(b, pid, SHARDS) for b in traffic]
    expect_in = sum(int(((entering_host(b.device_idx, SHARDS) == peer)
                         & (np.asarray(b.device_idx) % SHARDS // 4 == pid)
                         & np.asarray(b.valid)).sum()) for b in traffic)
    dist.barrier()
    reset_launch_counts(engine)
    counts = CardLaunches(engine)
    consumer.start()
    with counts.window():
        loop.start()
        run_ticks(shares[:CLUSTER_WARMUP])
        _sync_cards(cards)
        t_start = time.perf_counter()
        run_ticks(shares[CLUSTER_WARMUP:CLUSTER_WARMUP + CLUSTER_TICKS])
        t_end = time.perf_counter()
        if pid == 0:
            window = [loop.tick_count]

            def profiled():
                run_ticks(shares[CLUSTER_WARMUP + CLUSTER_TICKS:])
                window.append(loop.tick_count)

            prof = profile_cards(profiled, cards, ranges=(
                "swt::all_reduce_sums", "swt::vote"))
        else:
            run_ticks(shares[CLUSTER_WARMUP + CLUSTER_TICKS:])
        while consumer.consumed_rows < expect_in:
            if loop.fatal is not None:
                raise AssertionError(f"loop died: {loop.fatal!r}")
            time.sleep(0.01)
        folded()
        dist.barrier()
        loop.stop()
    if loop.fatal is not None:
        raise AssertionError(f"loop died: {loop.fatal!r}")
    # every tick steps once: S/2 B1 launches a tick a host, S/(2K) on each
    # of its K cards, counted from the loop's start to its stop (no tick
    # straddles the count)
    b1 = launch_counts(engine)["points_in_zones"]
    if b1 != engine.n_local * loop.tick_count:
        raise AssertionError(f"B1 launched {b1} times over "
                             f"{loop.tick_count} ticks of {engine.n_local} "
                             f"shards")
    b1_by_card = counts.check("points_in_zones", engine.shards_per_card,
                              loop.tick_count, f"[cluster] host {pid}")
    if len(loop.history) != loop.tick_count:
        raise AssertionError("the loop's tick history was cut")
    timed = [t for t in loop.history
             if t.start_s >= t_start and t.start_s + t.wall_s <= t_end]
    worked = [t for t in timed if t.batches]
    walls = [t.wall_s * 1e3 for t in worked]
    fed = sum(int(np.asarray(s.valid).sum()) for s in shares)
    lag = [f - s for s, f in zip(fwd_ticks, fold_ticks)]
    reduce_s = engine.sum_reduce_s      # waits for the card's last calls
    reduce_ms = list(engine.sum_reduce_clock.recent_ms)
    vote_ms = list(control.clock.recent_ms)
    out["a"] = {
        "ticks_timed": len(timed), "ticks_with_work": len(worked),
        "ticks_total": loop.tick_count,
        "tick_ms_p50": float(np.percentile(walls, 50)),
        "tick_ms_p99": float(np.percentile(walls, 99)),
        "timed_events": sum(int(np.asarray(s.valid).sum()) for s in
                            shares[CLUSTER_WARMUP:CLUSTER_WARMUP
                                   + CLUSTER_TICKS]),
        "timed_wall_s": t_end - t_start,
        "all_reduce_ms_per_tick": 1e3 * reduce_s
        / max(1, engine.sum_reduces),
        "all_reduce_ms_p50_p99": _percentiles(reduce_ms),
        "all_reduce_timed_on": ("card events" if mesh.collectives == "nccl"
                                else "host clock"),
        "vote_ms_per_tick": 1e3 * control.vote_s / max(1, control.votes),
        "vote_ms_p50_p99": _percentiles(vote_ms),
        "fed_rows": fed, "forwarded_rows": forwarder.forwarded,
        "consumed_rows": consumer.consumed_rows, "expected_in": expect_in,
        "dead_lettered": forwarder.dead_lettered,
        "misrouted": consumer.misrouted_rows,
        "lag_ticks_p50": float(np.percentile(lag, 50)) if lag else None,
        "lag_ticks_max": max(lag) if lag else None,
        "forward_messages": len(fwd_ticks), "folded_messages": len(lag),
        "processed_total": loop.processed,
        "processed": [t.processed for t in loop.history],
        "b1_launches": b1,
        "b1_by_card": {str(k): v["launches"] for k, v in b1_by_card.items()},
        "b1_per_card_per_tick": [v["launches"] / loop.tick_count
                                 for v in b1_by_card.values()],
        "captures": engine.graph_captures,
        "graph_keys": len(engine._graphs), "alerts": len(alerts)}
    if pid == 0:
        # the ticks that ended inside the profile: the CLUSTER_PROFILED fed
        # ones and every tick between them that folded a trickle of
        # forwarded rows
        ticks = list(loop.history)[window[0]:window[1]]
        out["a"]["profile"] = {
            "ticks": len(ticks),
            "ticks_with_work": sum(1 for t in ticks if t.rows),
            "rows_folded": sum(t.rows for t in ticks),
            "tick_walls_ms": [t.wall_s * 1e3 for t in ticks], **prof}
    np.savez(f"{tmp}/a{pid}.npz", **blocks())
    with open(f"{tmp}/alerts{pid}.pkl", "wb") as fh:
        pickle.dump(alerts, fh)

    # (d) the multi-process mesh query (its own group)
    rows = cluster_query_rows()
    d = {"rows": CLUSTER_QUERY_ROWS, "K": CLUSTER_QUERY_K,
         "W": CLUSTER_QUERY_W}
    segment_row_sum.launches = 0
    segment_row_sum.by_card.clear()
    for combine in ("psum", "ring"):
        splits = []
        for _ in range(1 + CLUSTER_QUERY_REPS):
            timings = {}
            st = sharded_windowed_stats(
                *rows, window_ms=CLUSTER_QUERY_WINDOW_MS,
                num_keys=CLUSTER_QUERY_K, n_windows=CLUSTER_QUERY_W,
                mesh=mesh, combine=combine, timings=timings)
            splits.append(timings)
        d[combine] = {"digest": stats_digest(st),
                      **{f"{k}_ms": 1e3 * statistics.median(
                          s[f"{k}_s"] for s in splits[1:])
                         for k in ("fold", "gather", "combine")}}
        if len(cards) > 1:
            d[combine]["fold_ms_by_card"] = [
                1e3 * statistics.median(s["fold_s_by_card"][k]
                                        for s in splits[1:])
                for k in range(len(cards))]
        del st
    d["segsum_launches"] = segment_row_sum.launches
    d["segsum_by_card"] = {str(k): n
                           for k, n in segment_row_sum.by_card.items()}
    out["d"] = d
    torch.cuda.empty_cache()

    # (c) the host-shards checkpoint, then records past it
    t = time.perf_counter()
    out["save_path"] = ckpt.save(engine, consumer_groups=[group])
    out["save_s"] = time.perf_counter() - t
    dist.barrier()
    loop.start()
    rng = np.random.default_rng(SEED + 1400 + pid)
    for r in range(CLUSTER_REPLAY_BATCHES):
        batch = synthetic_batch(
            engine.packer, N_REGISTERED, CLUSTER_REPLAY_ROWS,
            SEED + 1500 + 10 * r + pid,
            t_off_ms=(len(traffic) + r) * CLUSTER_TICK_MS)
        mine = np.nonzero(np.asarray(batch.valid) & np.array(
            [engine.owns(int(i)) for i in np.asarray(batch.device_idx)]))[0]
        bus.publish(topic, str(pid).encode(),
                    encode_rows(engine, batch, mine))
    del rng
    folded()
    dist.barrier()
    loop.stop()
    np.savez(f"{tmp}/before{pid}.npz", **blocks())
    out["blocked_in_collective_at_kill"] = (pid == 0 and
                                            mesh.collectives == "nccl")
    print("RESULT " + json.dumps(out), flush=True)
    print("READY_TO_DIE", flush=True)
    if out["blocked_in_collective_at_kill"]:
        # over NCCL host 0 waits out the kill inside its next tick's
        # collective (host 1 never ticks again): NCCL's kernel waits for
        # the dead peer, and only the watchdog may end the process
        loop.start()
    # host 1 is killed here; host 0's watchdog exits 13 when it goes stale
    time.sleep(CLUSTER_CHILD_S)
    return 3


def cluster_reference(dev, epoch):
    """The single-process SHARDS-shard engine (host route, full layout) on
    the card over every tick's whole batch: each device's rows in the order
    the hosts fold them. Returns (engine, sorted alert keys, processed)."""
    from sitewhere_tpu_torch.ops.pack import WIRE_ROWS

    engine = build_world(dev, "auto", epoch, shards=SHARDS,
                         device_routing=False,
                         alert_lane_capacity=SHARD_LANES)
    engine.router.fixed_wire_rows = WIRE_ROWS
    alerts, processed = [], 0
    from sitewhere_tpu_torch.ops.pack import empty_batch

    traffic = cluster_traffic(engine.packer)
    while traffic or engine.pending_overflow:
        view, out = engine.submit(traffic.pop(0) if traffic
                                  else empty_batch(1))
        processed += int(out.processed)
        alerts += _alert_keys(engine.materialize_alerts(view, out))
    return engine, sorted(alerts), processed


def serve_cluster_drive(device_arg, tmp, card, layout):
    """(b): two `serve --cluster-coordinator` processes of SHARDS shards,
    each on the cards `layout` gives it (every card it sees; its banner
    names them and the collectives backend, which must be the layout's),
    the same world provisioned on both over REST (registry gossip off, so
    no boot race), SERVE_CLUSTER_RECORDS decoded records published to each
    host's edge for its peer's devices; each must fold on its owner, fire
    and persist the owner's threshold alert and read back over the owner's
    REST API; both exit 0 on SIGTERM."""
    import re
    import zlib

    import msgpack

    from sitewhere_tpu_torch.client.rest import SiteWhereClientError
    from sitewhere_tpu_torch.model.common import _asdict
    from sitewhere_tpu_torch.model.event import (
        DeviceEventBatch, DeviceMeasurement)
    from sitewhere_tpu_torch.runtime.bus import TopicNaming
    from sitewhere_tpu_torch.runtime.busnet import BusClient

    coord, bus0, bus1 = _free_port(), _free_port(), _free_port()
    config = f"{tmp}/serve-cluster.json"
    with open(config, "w") as fh:
        json.dump({
            "cluster": {"registry_gossip": False,
                        "heartbeat_s": CLUSTER_HEARTBEAT_S,
                        "stale_after_s": CLUSTER_STALE_S,
                        "fail_after_s": CLUSTER_FAIL_AFTER_S},
            "persist": {"checkpoint_interval_s": None},
            "mesh": {"shards": SHARDS},
            "rules": [{"type": "threshold", "token": "hot",
                       "measurement_name": "temp", "operator": ">",
                       "threshold": 50.0}]}, fh)
    t0 = time.perf_counter()
    hosts = [_HostLog(["-m", "sitewhere_tpu_torch", "serve", "--config",
                     config, "--device", device_arg, "--port", "0",
                     "--cluster-coordinator", f"127.0.0.1:{coord}",
                     "--cluster-num-processes", "2",
                     "--cluster-process-id", str(pid),
                     "--cluster-peers",
                     f"0=127.0.0.1:{bus0},1=127.0.0.1:{bus1}",
                     "--bus-port", str([bus0, bus1][pid]),
                     "--data-dir", f"{tmp}/serve{pid}"],
                    f"serve --cluster-coordinator host {pid}",
                    env=_child_env(layout["visible"][pid]))
             for pid in range(2)]
    deadline = time.monotonic() + CLUSTER_CHILD_S
    try:
        urls, boots, n_shards, banners = [], [], None, []
        for h in hosts:
            urls.append(re.search(r"REST gateway : (http://\S+)",
                                  h.wait_for("  REST gateway", deadline))
                        .group(1))
            mesh_line = h.wait_for("  mesh", deadline)
            n_shards = int(re.search(r"(\d+) shards", mesh_line).group(1))
            cards = int(re.search(r"over (\d+) card", mesh_line).group(1))
            backend = re.search(r"collectives (\w+)", mesh_line).group(1)
            banners.append(mesh_line.strip())
            if (n_shards, cards, backend) != (
                    SHARDS, layout["serve_cards"], layout["backend"]):
                raise AssertionError(f"serve host: {mesh_line!r} for the "
                                     f"layout {layout}")
            boots.append(time.perf_counter() - t0)
        rests = [rest_client(u) for u in urls]
        tokens = [f"cdev-{i}" for i in range(SERVE_CLUSTER_DEVICES)]
        owner = {t: (zlib.crc32(t.encode()) % n_shards) // (n_shards // 2)
                 for t in tokens}
        t_prov = time.perf_counter()
        for rest in rests:
            rest.create_device_type({"token": "cdt", "name": "C"})
            for i, token in enumerate(tokens):
                rest.create_device({"token": token,
                                    "device_type_token": "cdt"})
                rest.create_assignment({"token": f"cas-{i}",
                                        "device_token": token})
        # settled: both hosts live in each other's topology
        while True:
            procs = [r.get("/api/instance/topology").get("processes", {})
                     for r in rests]
            if all({"0", "1"} <= set(p) and not any(
                    v.get("stale") for v in p.values()) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"hosts never settled: {procs}")
            time.sleep(0.2)
        provision_s = time.perf_counter() - t_prov
        instance_id = rests[0].get("/api/instance/topology")["instance_id"]
        topic = TopicNaming(instance=instance_id) \
            .event_source_decoded_events("default")
        sent = {}
        now = int(time.time() * 1000)
        for pid in range(2):
            theirs = [t for t in tokens if owner[t] != pid]
            assert len(theirs) >= SERVE_CLUSTER_RECORDS, len(theirs)
            client = BusClient("127.0.0.1", [bus0, bus1][pid])
            try:
                for k, token in enumerate(theirs[:SERVE_CLUSTER_RECORDS]):
                    value = 60.0 + k + 0.5 * pid
                    batch = DeviceEventBatch(
                        device_token=token, measurements=[DeviceMeasurement(
                            name="temp", value=value, event_date=now + k)])
                    sent[token] = (value, time.perf_counter())
                    client.publish(topic, token.encode(), msgpack.packb({
                        "sourceId": "chip-cluster", "deviceToken": token,
                        "kind": "DeviceEventBatch",
                        "request": _asdict(batch), "metadata": {}},
                        use_bin_type=True))
            finally:
                client.close()
        fold_s, pending = {}, list(sent)
        while pending:
            token = pending[0]
            value, t_pub = sent[token]
            rest = rests[owner[token]]
            try:
                state = rest.get(f"/api/devicestates/{token}")
                got = state.get("last_measurements", {}).get("temp")
            except SiteWhereClientError as exc:
                if exc.status != 404:
                    raise
                got = None
            if got is not None and float(got[1]) == value:
                fold_s[token] = time.perf_counter() - t_pub
                pending.pop(0)
                continue
            if time.monotonic() > deadline:
                raise AssertionError(f"{len(pending)} records never folded "
                                     f"on their owner")
            time.sleep(0.05)
        alerts = 0
        for i, token in enumerate(tokens):
            if token not in sent:
                continue
            res = rests[owner[token]].list_alerts(f"cas-{i}")
            if not res.get("numResults", res.get("num_results", 0)):
                raise AssertionError(f"no persisted alert for {token} on "
                                     f"its owner")
            alerts += 1
        for h in hosts:
            h.proc.send_signal(__import__("signal").SIGTERM)
        for h in hosts:
            h.finish(time.monotonic() + 120)
        lat = sorted(fold_s.values())
        return {"boot_s": boots, "provision_s": provision_s,
                "shards": n_shards, "banners": banners,
                "records": len(sent),
                "alerts_persisted": alerts,
                "publish_to_fold_ms_p50": 1e3 * float(np.percentile(lat, 50)),
                "publish_to_fold_ms_p99": 1e3 * float(np.percentile(lat, 99))}
    finally:
        for h in hosts:
            h.kill()


def phase_cluster(dev, card):
    """Phase 13: the multi-host data plane on the card (see the module
    docstring). Returns the summary; its `b1_launches` and
    `segsum_launches` are the kernels' launches on the cluster path."""
    from sitewhere_tpu_torch.analytics import windows as windows_mod
    from sitewhere_tpu_torch.ops.segsum import segment_row_sum_plain
    from sitewhere_tpu_torch.parallel.distributed import (
        sharded_windowed_stats)
    from sitewhere_tpu_torch.parallel.mesh import make_mesh
    from sitewhere_tpu_torch.persist.checkpoint import (
        PipelineCheckpointer, write_assembled)

    t_phase = time.perf_counter()
    epoch = int(time.time() * 1000) - EPOCH_LAG_MS
    layout = cluster_layout()
    summary = {"processes": CLUSTER_PROCS, "shards": SHARDS,
               "layout": layout}
    log(f"[cluster] {CLUSTER_PROCS} processes x {layout['cards']} card "
        f"block(s), CUDA_VISIBLE_DEVICES {layout['visible']}, device "
        f"{layout['device']}, collectives {layout['backend']}")
    if layout["backend"] != "nccl":
        log("[cluster] one visible card: both processes share cuda:0 over "
            "gloo; NCCL was not exercised")
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip-cluster-") as tmp:
        deadline = time.monotonic() + CLUSTER_CHILD_S
        run = _cluster_pair("run", tmp, epoch, layout)
        again = []
        try:
            results = [c.result(deadline) for c in run]
            for c in run:
                c.wait_for("READY_TO_DIE", deadline)
            walls["run_pair_s"] = time.perf_counter() - t_phase
            # the restore pair boots up to its go file meanwhile
            again = _cluster_pair("restore", tmp, epoch, layout)
            # (c) hard-kill host 1; host 0's watchdog must gang-exit 13
            t_kill, t_kill_wall = time.perf_counter(), time.time()
            run[1].kill()
            exited = {}

            def wait_exit():
                exited["rc"] = run[0].proc.wait()
                exited["s"] = time.perf_counter() - t_kill

            waiter = threading.Thread(target=wait_exit, daemon=True)
            waiter.start()
            # (a)'s single-process reference, while host 0 waits
            t = time.perf_counter()
            ref_engine, ref_alerts, ref_processed = cluster_reference(
                dev, epoch)
            walls["reference_s"] = time.perf_counter() - t
            waiter.join(timeout=max(
                0.0, t_kill + CLUSTER_FAIL_AFTER_S + 5 - time.perf_counter()))
            if "rc" not in exited:
                raise AssertionError("host 0 outlived its peer by "
                                     f"{CLUSTER_FAIL_AFTER_S + 5} s")
            if exited["rc"] != 13:
                raise AssertionError(f"host 0 exited {exited['rc']}, not 13")
            exit_s = exited["s"]
            fired_s = float(run[0].wait_for("PEER_LOSS", deadline)
                            .split()[1]) - t_kill_wall
            # the watchdog fires fail_after_s after the peer's last
            # heartbeat reached it, at its next check; that heartbeat left
            # before the kill and is delivered within a poll (<= 0.4 s)
            bound = CLUSTER_FAIL_AFTER_S + CLUSTER_WATCHDOG_CHECK_S + 0.4
            if fired_s > bound:
                raise AssertionError(f"host 0's watchdog fired {fired_s:.2f}"
                                     f" s after its peer's kill")
            # (c) the restore pair restores the checkpoints, replays past
            t = time.perf_counter()
            open(f"{tmp}/{CLUSTER_GO}", "w").close()
            deadline = time.monotonic() + CLUSTER_CHILD_S
            restored = [c.result(deadline) for c in again]
            for c in again:
                c.finish(deadline)
            walls["restore_pair_after_go_s"] = time.perf_counter() - t
        finally:
            for c in run + again:
                c.kill()
        got_alerts = []
        _, ref_blocks = ref_engine.local_state_shards()
        for pid, res in enumerate(results + restored):
            if (res["collectives"] != layout["backend"]
                    or len(res["cards"]) != layout["cards"]):
                raise AssertionError(
                    f"host {pid} ({res['role']}): {res['cards']} over "
                    f"{res['collectives']}; the layout is {layout}")
        for pid, res in enumerate(results):
            a = res["a"]
            if a["processed_total"] != ref_processed:
                raise AssertionError(f"host {pid}: processed "
                                     f"{a['processed_total']} != "
                                     f"{ref_processed}")
            if a["dead_lettered"] or a["misrouted"]:
                raise AssertionError(f"host {pid}: rows parked")
            if a["consumed_rows"] != a["expected_in"]:
                raise AssertionError(f"host {pid}: folded "
                                     f"{a['consumed_rows']} forwarded rows "
                                     f"of {a['expected_in']}")
            # one key, a captured body on each of the host's cards
            if a["captures"] != layout["cards"]:
                raise AssertionError(f"host {pid}: {a['captures']} captures")
            blocks = np.load(f"{tmp}/a{pid}.npz")
            for name in blocks.files:
                want = ref_blocks[name][4 * pid:4 * pid + 4]
                if not np.array_equal(blocks[name].view(np.uint8),
                                      want.view(np.uint8)):
                    raise AssertionError(f"host {pid}: block {name} "
                                         f"differs from the single engine")
            with open(f"{tmp}/alerts{pid}.pkl", "rb") as fh:
                got_alerts += pickle.load(fh)
        if results[0]["a"]["processed"] != results[1]["a"]["processed"]:
            raise AssertionError("the hosts read different processed sums")
        if sorted(got_alerts) != ref_alerts:
            raise AssertionError("the hosts' alerts differ from the single "
                                 "engine's")
        fed = sum(r["a"]["fed_rows"] for r in results)
        if fed != ref_processed:
            raise AssertionError(f"{fed} rows fed, {ref_processed} folded")
        # host 0's profiled ticks: over NCCL no host copy of the sums
        sums = results[0]["a"]["profile"]["swt::all_reduce_sums"]
        if not sums["ranges"]:
            raise AssertionError("the profile saw no all_reduce of the sums")
        if layout["backend"] == "nccl" and sums["host_copies"]:
            raise AssertionError(f"{sums['host_copies']} host copies of the "
                                 f"sums in {sums['ranges']} NCCL all_reduces")
        # (c) the assembled checkpoints onto a single-process engine
        t = time.perf_counter()
        assembled = write_assembled([r["save_path"] for r in results],
                                    f"{tmp}/assembled")
        assemble_s = time.perf_counter() - t
        single = build_world(dev, "auto", epoch, shards=SHARDS,
                             device_routing=False,
                             alert_lane_capacity=SHARD_LANES)
        t = time.perf_counter()
        PipelineCheckpointer(f"{tmp}/assembled").restore(single, assembled)
        assembled_restore_s = time.perf_counter() - t
        assert_tree_bits_equal(ref_engine.canonical_state(),
                               single.canonical_state(),
                               "[cluster] assembled restore")
        del single
        # (d) against the single-process call, kernel and plain version
        rows = cluster_query_rows()
        mesh = make_mesh(SHARDS, device=dev)
        t = time.perf_counter()
        d_ref = {}
        for combine in ("psum", "ring"):
            kw = dict(window_ms=CLUSTER_QUERY_WINDOW_MS,
                      num_keys=CLUSTER_QUERY_K, n_windows=CLUSTER_QUERY_W,
                      mesh=mesh, combine=combine)
            d_ref[combine] = stats_digest(sharded_windowed_stats(*rows, **kw))
            kernel = windows_mod.segment_row_sum
            windows_mod.segment_row_sum = segment_row_sum_plain
            try:
                plain = stats_digest(sharded_windowed_stats(*rows, **kw))
            finally:
                windows_mod.segment_row_sum = kernel
            if plain != d_ref[combine]:
                raise AssertionError(f"(d) {combine}: kernel and plain "
                                     f"segment sum differ")
            for pid, res in enumerate(results):
                if res["d"][combine]["digest"] != d_ref[combine]:
                    raise AssertionError(
                        f"(d) {combine}: host {pid}'s grids differ from the "
                        f"single-process call")
        torch.cuda.empty_cache()
        walls["query_checks_s"] = time.perf_counter() - t
        t = time.perf_counter()
        serve = serve_cluster_drive(dev.type, tmp, card, layout)
        walls["serve_s"] = time.perf_counter() - t
    a0, a1 = results[0]["a"], results[1]["a"]
    per_proc_cells = 4 * CLUSTER_QUERY_K * CLUSTER_QUERY_W
    fold_bytes = (CLUSTER_QUERY_ROWS // 2 * 13 + per_proc_cells * 16)
    gather_bytes = CLUSTER_PROCS * per_proc_cells * 16 * 2
    combine_bytes = (SHARDS * CLUSTER_QUERY_K * CLUSTER_QUERY_W * 16
                     + CLUSTER_QUERY_K * CLUSTER_QUERY_W * 20)
    wall = max(a0["timed_wall_s"], a1["timed_wall_s"])
    summary.update({
        "a": {"tick_ms_p50": [a0["tick_ms_p50"], a1["tick_ms_p50"]],
              "tick_ms_p99": [a0["tick_ms_p99"], a1["tick_ms_p99"]],
              "events_per_s": (a0["timed_events"] + a1["timed_events"])
              / wall,
              "all_reduce_ms_per_tick": [a0["all_reduce_ms_per_tick"],
                                         a1["all_reduce_ms_per_tick"]],
              "vote_ms_per_tick": [a0["vote_ms_per_tick"],
                                   a1["vote_ms_per_tick"]],
              "all_reduce_ms_p50_p99": [a0["all_reduce_ms_p50_p99"],
                                        a1["all_reduce_ms_p50_p99"]],
              "all_reduce_timed_on": a0["all_reduce_timed_on"],
              "vote_ms_p50_p99": [a0["vote_ms_p50_p99"],
                                  a1["vote_ms_p50_p99"]],
              "b1_per_card_per_tick": [a0["b1_per_card_per_tick"],
                                       a1["b1_per_card_per_tick"]],
              "forwarded_rows": [a0["forwarded_rows"], a1["forwarded_rows"]],
              "fed_rows": [a0["fed_rows"], a1["fed_rows"]],
              "lag_ticks_p50": [a0["lag_ticks_p50"], a1["lag_ticks_p50"]],
              "lag_ticks_max": [a0["lag_ticks_max"], a1["lag_ticks_max"]],
              "ticks": [a0["ticks_total"], a1["ticks_total"]],
              "b1_launches": [a0["b1_launches"], a1["b1_launches"]],
              "ticks_timed": [a0["ticks_timed"], a1["ticks_timed"]],
              "captures": [a0["captures"], a1["captures"]],
              "alerts": len(ref_alerts), "processed": ref_processed,
              "profile_host0": a0["profile"],
              "boot_s": [r["boot_s"] for r in results]},
        "b": serve,
        "c": {"save_s": [r["save_s"] for r in results],
              "host0_blocked_in_collective_at_kill":
              results[0]["blocked_in_collective_at_kill"],
              "host0_watchdog_fired_after_kill_s": fired_s,
              "host0_exit_13_after_kill_s": exit_s,
              "restore_s": [r["restore_s"] for r in restored],
              "replay_s": [r["replay_s"] for r in restored],
              "replayed_rows": [r["replayed_rows"] for r in restored],
              "assemble_s": assemble_s,
              "assembled_restore_s": assembled_restore_s},
        "d": {"rows": CLUSTER_QUERY_ROWS,
              "cells": CLUSTER_QUERY_K * CLUSTER_QUERY_W,
              **{f"{c}_{k}": [r["d"][c].get(k) for r in results]
                 for c in ("psum", "ring")
                 for k in ("fold_ms", "fold_ms_by_card", "gather_ms",
                           "combine_ms")},
              "fold_bound_ms": fold_bytes / H100_HBM_BYTES_S * 1e3,
              "gather_bound_ms": gather_bytes / H100_HBM_BYTES_S * 1e3,
              "combine_bound_ms": combine_bytes / H100_HBM_BYTES_S * 1e3,
              "bound_by": "bytes",
              "segsum_launches": [r["d"]["segsum_launches"]
                                  for r in results],
              "segsum_by_card": [r["d"]["segsum_by_card"]
                                 for r in results]},
    })
    summary["b1_launches"] = sum(a["b1_launches"] for a in (a0, a1))
    summary["segsum_launches"] = sum(r["d"]["segsum_launches"]
                                     for r in results)
    summary["walls"] = walls
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"[cluster] {json.dumps(summary)} on {card}")
    log(f"[cluster] phase 13 took {summary['seconds']:.1f} s: tick p50 "
        f"{a0['tick_ms_p50']:.1f} / {a1['tick_ms_p50']:.1f} ms, "
        f"{summary['a']['events_per_s']:.0f} events/s over both hosts, "
        f"all_reduce p50/p99 {a0['all_reduce_ms_p50_p99']} ms, vote "
        f"{a0['vote_ms_p50_p99']} ms over {layout['backend']}, host 0's "
        f"watchdog fired {fired_s:.2f} s after host 1's kill, on {card}")
    return summary


# -- phase 14: the shard axis over several cards ---------------------------------

# phase 12's world (SHARDS shards of BATCH // SHARDS rows, SHARD_EVENTS
# events a step, SHARD_LAYOUTS x (SHARD_WARMUP + SHARD_STEPS) steps a route)
# on a mesh of K cards; with one visible card, two blocks on cuda:0
MULTI_PROFILED = 3
MULTI_STATEFUL_STEPS = 2
MULTI_QUERY_ROWS = READ_ROWS
MULTI_QUERY_KEYS, MULTI_QUERY_WINDOWS = N_REGISTERED, READ_WINDOWS
MULTI_TIMING_REPS = 20


def multicard_cards():
    """(cards, distinct): every visible card when there are two or more
    (the most that divide SHARDS), else two blocks on cuda:0."""
    n = torch.cuda.device_count()
    if n >= 2:
        K = min(SHARDS, n)
        while SHARDS % K:
            K -= 1
        return tuple(torch.device("cuda", k) for k in range(K)), True
    return (torch.device("cuda", 0),) * 2, False


def card_lines():
    """`nvidia-smi`'s name and power limit of every visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()


def _sync_cards(cards):
    for index in sorted({c.index for c in cards}):
        torch.cuda.synchronize(index)


def host_ms(fn, cards, reps=MULTI_TIMING_REPS):
    """Median host ms of `fn()` with every card waited for before and
    after (work spread over several cards has no one stream to time)."""
    fn()
    times = []
    for _ in range(reps):
        _sync_cards(cards)
        t0 = time.perf_counter()
        fn()
        _sync_cards(cards)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_cards(fn, cards, ranges=()):
    """The profiler around fn() (every thread's host ops): wall ms, each
    card's device busy ms and idle share (its device events summed once
    each, NCCL's kernels apart: they spin until the peers arrive, so
    their time, `nccl_ms`, is mostly waiting; `top_ms` the four device
    events that took the most), and for each name in
    `ranges` the `record_function` ranges of that name and the host
    copies inside them (`aten::copy_` or a `cudaMemcpy*` call on the
    range's thread)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync_cards(cards)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        t0 = time.perf_counter()
        fn()
        _sync_cards(cards)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy, nccl, by_name = {}, {}, {}
    for e in events:
        # a `record_function` range shows on the card as well, spanning
        # its kernels and the waits between them: not device work
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            key = f"cuda:{e.device_index}"
            ms = e.self_device_time_total / 1e3
            into = nccl if e.name.startswith("nccl") else busy
            into[key] = into.get(key, 0.0) + ms
            names = by_name.setdefault(key, {})
            names[e.name[:60]] = names.get(e.name[:60], 0.0) + ms
    out = {"wall_ms": wall_ms}
    for index in sorted({c.index for c in cards}):
        key = f"cuda:{index}"
        if key in busy:
            out[key] = {"busy_ms": busy[key],
                        "idle_share": 1 - busy[key] / wall_ms,
                        "nccl_ms": nccl.get(key, 0.0),
                        "top_ms": sorted(by_name[key].items(),
                                         key=lambda kv: -kv[1])[:4]}
        else:
            out[key] = {"busy_ms": "not measured",
                        "idle_share": "not measured"}
    copies = [e for e in events if e.device_type == DeviceType.CPU and (
        e.name == "aten::copy_" or e.name.startswith("cudaMemcpy"))]
    for name in ranges:
        spans = [e for e in events if e.name == name]
        out[name] = {"ranges": len(spans), "host_copies": sum(
            1 for r in spans for c in copies if c.thread == r.thread
            and r.time_range.start <= c.time_range.start
            and c.time_range.end <= r.time_range.end)}
    return out


def blocks_equal(one, many, what):
    """Every state group of the K-card engine, block by block, bit-equal to
    the one-card engine's rows of the same shards (on the card)."""
    from sitewhere_tpu_torch.tree import tree_leaves

    n = many.shards_per_card
    for group in ("_state", "_rule_state", "_model_state",
                  "_actuation_state"):
        ref = getattr(one, group)[0]
        for k, block in enumerate(getattr(many, group)):
            for a, b in zip(tree_leaves(ref), tree_leaves(block)):
                if not torch.equal(_bits(a[k * n:(k + 1) * n]),
                                   _bits(b).to(a.device)):
                    raise AssertionError(f"{what}: {group} block {k} "
                                         f"differs from the one-card rows")


def multicard_step(engine, batch, cards, materialize):
    """sharded_step with every card waited for: ((wall s), alert keys or
    the lane digest, outputs)."""
    t0 = time.perf_counter()
    view, out = engine.submit_routed(batch)
    _sync_cards(cards)
    wall = time.perf_counter() - t0
    if materialize:
        return wall, sorted(_alert_keys(engine.materialize_alerts(
            view, out))), out
    return wall, lane_digest(engine, view, out), out


class CardLaunches:
    """Each step kernel's launches on each card index, made by one engine
    over the cards inside `window()`s: the wrappers' own per-card counts
    (eager launches; every wrapper's `by_card` set to 0 as a window opens,
    read as it closes) plus the replays that engine counted on each block
    (its `card_kernel_launches`, set to 0 here), summed on the block's
    card. Launches made outside the windows (another engine's, a compare)
    do not count."""

    def __init__(self, engine):
        self.engine = engine
        self.eager = {}
        for counts in engine.card_kernel_launches:
            counts.clear()

    @contextlib.contextmanager
    def window(self):
        from sitewhere_tpu_torch.pipeline.graph import STEP_KERNELS

        for wrapper in STEP_KERNELS.values():
            wrapper.by_card.clear()
        try:
            yield
        finally:
            for name, wrapper in STEP_KERNELS.items():
                mine = self.eager.setdefault(name, {})
                for index, n in wrapper.by_card.items():
                    mine[index] = mine.get(index, 0) + n

    def by_card(self, name):
        """{card index: eager, replays, launches} for kernel `name`."""
        out = {}
        for card in self.engine.cards:
            out.setdefault(card.index, {"eager": self.eager.get(
                name, {}).get(card.index, 0), "replays": 0})
        for card, counts in zip(self.engine.cards,
                                self.engine.card_kernel_launches):
            out[card.index]["replays"] += counts.get(name, 0)
        for entry in out.values():
            entry["launches"] = entry["eager"] + entry["replays"]
        return out

    def check(self, name, per_block_step, steps, what):
        """Fail unless each card launched `name` per_block_step times a
        step for each of its blocks, and no other card launched it;
        returns by_card(name)."""
        got = self.by_card(name)
        stray = set(self.eager.get(name, {})) - set(got)
        if stray:
            raise AssertionError(f"{what}: {name} launched on cards "
                                 f"{sorted(stray)} outside the engine's")
        blocks = collections.Counter(c.index for c in self.engine.cards)
        for index, entry in got.items():
            want = per_block_step * blocks[index] * steps
            if entry["launches"] != want:
                raise AssertionError(
                    f"{what}: {name} launched {entry} on cuda:{index}; "
                    f"expected {want} ({per_block_step} a block a step, "
                    f"{blocks[index]} blocks, {steps} steps)")
        return got


def multicard_route(one, many, traffic, mode, card):
    """(a) for one route: both engines over phase 12's schedule, each step
    held bits against the one-card engine (outputs, every block of every
    state group, alerts set-equal or the lanes' digest, processed); the
    walls, B1's launches and the captures on each card."""
    cards = many.cards
    for engine in (one, many):
        engine.device_routing = mode == "device"
    schedule = shard_schedule(traffic)
    keys_before = len(many._graphs)
    captures_before = list(many.card_graph_captures)
    counts = CardLaunches(many)
    timed = {"one": [], "many": []}
    alerts = 0
    for n, (layout, i, batch) in enumerate(schedule):
        first = n < len(SHARD_LAYOUTS)
        w1, got1, out1 = multicard_step(one, batch, cards, first)
        with counts.window():
            w2, got2, out2 = multicard_step(many, batch, cards, first)
        what = f"[multicard {mode}] step {n} ({layout})"
        _outputs_bits_equal(out1, out2, what)
        if got1 != got2:
            raise AssertionError(f"{what}: alerts differ from the one-card "
                                 f"engine's")
        if int(out1.processed) != int(out2.processed):
            raise AssertionError(f"{what}: processed differs")
        blocks_equal(one, many, what)
        alerts += len(got2) if first else got2[0]
        if i >= SHARD_WARMUP:
            timed["one"].append(w1)
            timed["many"].append(w2)
    _sync_cards(cards)
    keys = len(many._graphs) - keys_before
    n = many.shards_per_card
    b1 = counts.check("points_in_zones", n, len(schedule),
                      f"[multicard {mode}]")
    captures = [c - c0 for c, c0 in zip(many.card_graph_captures,
                                        captures_before)]
    if captures != [keys] * len(cards) or keys != len(SHARD_LAYOUTS):
        raise AssertionError(f"[multicard {mode}] captures per card "
                             f"{captures} for {keys} keys")
    if mode == "device" and many.device_route_fallbacks:
        raise AssertionError(f"[multicard {mode}] the K-card engine spilled "
                             f"to the host route")
    valid = SHARD_EVENTS * len(timed["many"])
    out = {"mode": mode, "steps": len(schedule),
           "timed_steps": len(timed["many"]), "alerts": alerts,
           "captures_per_card": captures,
           "b1_launches_per_block_per_step": n,
           "b1_by_card": b1,
           "b1_launches": sum(e["launches"] for e in b1.values())}
    for name in ("one", "many"):
        walls = timed[name]
        out[name] = {"step_ms_p50": float(np.percentile(walls, 50) * 1e3),
                     "step_ms_p99": float(np.percentile(walls, 99) * 1e3),
                     "events_per_s": valid / sum(walls)}
    return out


def multicard_costs(many, cards, batch):
    """The parts of a device-routed step over the cards that leave the
    state as it is, each alone (host ms, every card waited for): the
    staging of `batch`'s flat blob a part a card (beside strided host
    copies of the parts into pinned buffers), the route prologues'
    replays on its lanes, the exchange's copies, both together, and the
    sums' gather; and whether the cards reach each other's memory."""
    flat = many._pack_flat_blob(batch)
    steps = next(s for key, s in many._graphs.items()
                 if tuple(key[-1]) == (flat.shape[0], flat.shape[1]))
    parts = many._card_parts(flat)

    def prologues():
        for flat, part, graph in zip(steps.flats, parts, steps.prologues):
            flat.copy_(part, non_blocking=True)
            graph.replay()

    def route():
        prologues()
        steps.exchange()

    # the staging of the flat blob a part a card (into a slot of its own;
    # a lane chunk a row at a time), and beside it what copying each
    # strided part into a pinned buffer on the host first would cost
    from sitewhere_tpu_torch.pipeline.staging import RingSlot

    slot = RingSlot(-1)
    host = torch.from_numpy(flat)
    width = host.shape[1] // len(cards)
    strided = [host[:, k * width:(k + 1) * width] for k in range(len(cards))]
    pinned = [torch.empty(p.shape, dtype=torch.int32, pin_memory=True)
              for p in strided]

    def host_copies():
        for dst, part in zip(pinned, strided):
            dst.copy_(part)

    out = {"stage_ms": host_ms(lambda: many._stage_copy(slot, flat), cards),
           "strided_host_copies_ms": host_ms(host_copies, cards),
           "prologues_ms": host_ms(prologues, cards),
           "exchange_ms": host_ms(steps.exchange, cards),
           "prologues_and_exchange_ms": host_ms(route, cards),
           "sums_ms": host_ms(lambda: many._gather_outputs(
               steps.outputs_on_first()), cards),
           "exchange_bytes": sum(int(r.nbytes) for r in steps.received)}
    indexes = sorted({c.index for c in cards})
    out["peer_access"] = all(
        torch.cuda.can_device_access_peer(a, b)
        for a in indexes for b in indexes if a != b) \
        if len(indexes) > 1 else "one card"
    return out


SPLIT_PHASES = ("prologues", "exchange", "bodies", "gathered")


def multicard_split(one, many, cards, batches):
    """Device-routed steps over the cards split into their phases: each of
    `batches` taken by the one-card engine, then by the K-card engine with
    its replays' marks on (`_CardSteps.marks`), the two held bit-equal.
    Per block, medians over the steps of the device ms between the marks
    on its card's stream (prologues: the blob's copy into the prologue's
    input and the route prologue's replay; exchange: the copies between
    cards; bodies: the body graphs' replays; gathered: the outputs' copies
    to the first card, the sums and the concatenations), each phase's host
    ms to queue it, and the flight record's host stages (route_device,
    h2d, dispatch) beside the one-card engine's; the step's wall (submit
    until every card is done)."""
    routed = [s for s in many._graphs.values()
              if getattr(s, "prologues", None) is not None]
    for steps in routed:
        steps.marks = []
    walls, flights, flights_one = [], [], []
    try:
        for n, batch in enumerate(batches):
            _, got1, out1 = multicard_step(one, batch, cards, False)
            flights_one.append(one.flight.export(last_n=1)["records"][-1])
            wall, got2, out2 = multicard_step(many, batch, cards, False)
            what = f"[multicard split] step {n}"
            _outputs_bits_equal(out1, out2, what)
            if got1 != got2:
                raise AssertionError(f"{what}: lanes differ")
            walls.append(wall * 1e3)
            flights.append(many.flight.export(last_n=1)["records"][-1])
        marks = [m for steps in routed for m in steps.marks]
    finally:
        for steps in routed:
            steps.marks = None
    names = ("start",) + SPLIT_PHASES
    per_step = [marks[i:i + len(names)]
                for i in range(0, len(marks), len(names))]
    if len(per_step) != len(batches) or any(
            [m[0] for m in step] != list(names) for step in per_step):
        raise AssertionError(f"[multicard split] {len(per_step)} marked "
                             f"replays for {len(batches)} device-routed "
                             f"steps")
    out = {"steps": len(batches),
           "step_ms_p50": statistics.median(walls),
           "host_ms": {}, "flight_ms": {}, "flight_ms_one_card": {},
           "by_block": []}
    for j, name in enumerate(SPLIT_PHASES, start=1):
        out["host_ms"][name] = statistics.median(
            (step[j][1] - step[j - 1][1]) * 1e3 for step in per_step)
    for stage in ("route_device", "h2d", "dispatch"):
        for key, recs in (("flight_ms", flights),
                          ("flight_ms_one_card", flights_one)):
            out[key][stage] = statistics.median(
                f["stages"].get(stage, {}).get("ms", 0.0) for f in recs)
    for k, c in enumerate(cards):
        entry = {"block": k, "card": str(c)}
        for j, name in enumerate(SPLIT_PHASES, start=1):
            entry[f"{name}_ms"] = statistics.median(
                step[j - 1][2][k].elapsed_time(step[j][2][k])
                for step in per_step)
        entry["start_to_gathered_ms"] = statistics.median(
            step[0][2][k].elapsed_time(step[-1][2][k]) for step in per_step)
        out["by_block"].append(entry)
    return out


def multicard_stateful(dev, cards, epoch, card):
    """(b) phase 5's world over the cards beside the one-card engine:
    alerts, command fires, every state group equal, scores within the
    tolerance; the rule-program kernel's launches on each card."""
    from sitewhere_tpu_torch.parallel import make_mesh

    one = build_stateful_world(dev, epoch, shards=SHARDS)
    many = build_stateful_world(dev, epoch, shards=SHARDS,
                                mesh=make_mesh(SHARDS, devices=cards))
    batches = [synthetic_batch(one.packer, N_REGISTERED, SHARD_EVENTS,
                               SEED + 1400 + s, mm_slots=(1, 2),
                               t_off_ms=1000 * s)
               for s in range(MULTI_STATEFUL_STEPS)]
    _sync_cards(cards)
    runs = [run_stateful_trace(one, batches, len(batches))]
    _sync_cards(cards)
    counts = CardLaunches(many)
    with counts.window():
        runs.append(run_stateful_trace(many, batches, len(batches)))
        _sync_cards(cards)
    (_, _, a1, f1, s1, snap1, fam1, _), (_, _, a2, f2, s2, snap2, fam2, _) \
        = runs
    if [sorted(a) for a in a1] != [sorted(a) for a in a2] or f1 != f2:
        raise AssertionError("[multicard stateful] alerts or command fires "
                             "differ from the one-card engine's")
    compare_snapshots(snap1, snap2)
    for x, y in zip(s1, s2):
        torch.testing.assert_close(y, x, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    blocks_equal(one, many, "[multicard stateful]")
    rule = counts.check("eval_rule_programs", many.shards_per_card,
                        len(batches), "[multicard stateful]")
    if not (fam2[2] and fam2[3]):
        raise AssertionError("[multicard stateful] no program or model "
                             "fired")
    out = {"steps": len(batches), "rule_by_card": rule,
           "rule_launches": sum(e["launches"] for e in rule.values()),
           "alerts": sum(len(a) for a in a2),
           "fires": sum(len(f) for f in f2)}
    log(f"[multicard stateful] K cards == one card: {json.dumps(out)} on "
        f"{card}")
    return out


def multicard_checkpoint(dev, cards, many, epoch, card):
    """(c) a save on the K cards restored on one card, and that engine's
    save restored on K fresh cards: bit-equal canonical state each way."""
    from sitewhere_tpu_torch.parallel import make_mesh
    from sitewhere_tpu_torch.persist.checkpoint import PipelineCheckpointer

    want = many.canonical_state()
    one = build_world(dev, "auto", epoch + 1, shards=SHARDS)
    back = build_world(dev, "auto", epoch + 2, shards=SHARDS,
                       mesh=make_mesh(SHARDS, devices=cards))
    with tempfile.TemporaryDirectory(prefix="chip-multicard-") as tmp:
        t0 = time.perf_counter()
        path = PipelineCheckpointer(f"{tmp}/k").save(many)
        save_s = time.perf_counter() - t0
        PipelineCheckpointer(f"{tmp}/k").restore(one, path)
        assert_tree_bits_equal(want, one.canonical_state(),
                               "[multicard] K cards -> one card")
        path = PipelineCheckpointer(f"{tmp}/one").save(one)
        t0 = time.perf_counter()
        PipelineCheckpointer(f"{tmp}/one").restore(back, path)
        restore_s = time.perf_counter() - t0
    assert_tree_bits_equal(want, back.canonical_state(),
                           "[multicard] one card -> K cards")
    blocks_equal(one, back, "[multicard] restored blocks")
    return {"save_s_k_cards": save_s, "restore_s_k_cards": restore_s}


def multicard_query(cards, card):
    """(d) phase 9 (g)'s mesh query, at its size (READ_ROWS rows over
    N_REGISTERED keys x READ_WINDOWS windows), over the K cards beside the
    one-card mesh: counts and the sum, min and max bits equal under both
    combines; each card's fold and the combine timed on a warm call (one
    call over the K cards before, so no card's first touch is timed); the
    segment-sum kernel's launches on each card in the timed call."""
    from sitewhere_tpu_torch.ops.segsum import segment_row_sum
    from sitewhere_tpu_torch.parallel import distributed as dist_mod
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    first = cards[0]
    rng = np.random.default_rng(SEED + 1401)
    n = MULTI_QUERY_ROWS
    rows = [torch.from_numpy(rng.integers(0, MULTI_QUERY_KEYS, n)
                             .astype(np.int32)).to(first),
            torch.from_numpy(rng.integers(0, MULTI_QUERY_WINDOWS, n)
                             .astype(np.int32)).to(first),
            torch.from_numpy((rng.standard_normal(n) * 10.0 **
                              rng.integers(-3, 4, n)).astype(np.float32))
            .to(first),
            torch.from_numpy(rng.random(n) > 0.05).to(first)]
    kw = dict(window_ms=1, num_keys=MULTI_QUERY_KEYS,
              n_windows=MULTI_QUERY_WINDOWS)
    one = make_mesh(SHARDS, device=first)
    many = make_mesh(SHARDS, devices=cards)
    out = {"rows": n, "cells": MULTI_QUERY_KEYS * MULTI_QUERY_WINDOWS}
    for combine in ("psum", "ring"):
        want = dist_mod.sharded_windowed_stats(*rows, mesh=one,
                                               combine=combine, **kw)
        dist_mod.sharded_windowed_stats(*rows, mesh=many, combine=combine,
                                        **kw)
        _sync_cards(cards)
        segment_row_sum.by_card.clear()
        timings = {}
        got = dist_mod.sharded_windowed_stats(*rows, mesh=many,
                                              combine=combine,
                                              timings=timings, **kw)
        _sync_cards(cards)
        launches = dict(segment_row_sum.by_card)
        for name in ("count", "sum", "mean", "min", "max"):
            if not torch.equal(_bits(getattr(want, name)),
                               _bits(getattr(got, name))):
                raise AssertionError(f"[multicard query {combine}] {name} "
                                     f"differs from the one-card mesh")
        blocks = collections.Counter(c.index for c in cards)
        if launches != dict(blocks):
            raise AssertionError(f"[multicard query] segment-sum launches "
                                 f"{launches}; expected one a card block "
                                 f"{dict(blocks)}")
        out[combine] = {
            "fold_ms_by_card": [t * 1e3 for t in timings["fold_s_by_card"]],
            "fold_ms": timings["fold_s"] * 1e3,
            "gather_ms": timings["gather_s"] * 1e3,
            "combine_ms": timings["combine_s"] * 1e3,
            "segsum_by_card": launches,
            "segsum_launches": sum(launches.values())}
        del want, got
    log(f"[multicard query] K cards == one card: {json.dumps(out)} on "
        f"{card}")
    return out


def phase_multicard(dev, card):
    """Phase 14: the shard axis over several cards (see the module
    docstring). Returns the summary; `b1_launches`, `rule_launches` and
    `segsum_launches` are the kernels' launches on the multi-card path."""
    from sitewhere_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    cards, distinct = multicard_cards()
    K = len(cards)
    for line in card_lines():
        log(f"[multicard] card: {line}")
    if distinct:
        log(f"[multicard] K = {K} distinct cards: "
            f"{', '.join(map(str, cards))}")
    else:
        log(f"[multicard] one visible card: K = {K} blocks on cuda:0 "
            f"(devices=('cuda:0', 'cuda:0')); peer copies and launches on "
            f"a second card are not exercised")
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    epoch = int(time.time() * 1000) - EPOCH_LAG_MS
    one = build_world(dev, "auto", epoch, shards=SHARDS,
                      alert_lane_capacity=SHARD_LANES)
    many = build_world(dev, "auto", epoch, shards=SHARDS,
                       mesh=make_mesh(SHARDS, devices=cards),
                       alert_lane_capacity=SHARD_LANES)
    traffic = shard_traffic(one.packer, SEED + 1300)
    routes = {mode: multicard_route(one, many, traffic, mode, card)
              for mode in ("host", "device")}
    for mode, run in routes.items():
        log(f"[multicard {mode}] {json.dumps(run)} on {card}")
    compact = traffic["compact"][:MULTI_PROFILED]
    costs = multicard_costs(many, cards, compact[0])

    def steps(engine):
        return lambda: [engine.materialize_alerts(*engine.submit_routed(b))
                        for b in compact]

    profiles = {name: profile_cards(steps(eng), cards)
                for name, eng in (("one", one), ("many", many))}
    for prof in profiles.values():
        prof["steps"] = len(compact)
        for entry in prof.values():
            if isinstance(entry, dict) and \
                    isinstance(entry["busy_ms"], float):
                entry["busy_ms_per_step"] = entry["busy_ms"] / len(compact)
    split = multicard_split(one, many, cards,
                            traffic["compact"][MULTI_PROFILED:])
    blocks_equal(one, many, "[multicard] after the profiled steps")
    peak = {str(c): torch.cuda.max_memory_allocated(c) for c in cards}
    log(f"[multicard] exchange and sums: {json.dumps(costs)}; profiler "
        f"{json.dumps(profiles)}; peak memory {json.dumps(peak)} on {card}")
    log(f"[multicard split] a device-routed step over the cards by phase: "
        f"{json.dumps(split)} on {card}")
    del one
    stateful = multicard_stateful(dev, cards, epoch, card)
    ckpt = multicard_checkpoint(dev, cards, many, epoch, card)
    log(f"[multicard checkpoint] K cards -> one card -> K cards, bit-equal: "
        f"{json.dumps(ckpt)} on {card}")
    del many
    torch.cuda.empty_cache()
    query = multicard_query(cards, card)
    if distinct:
        t0 = time.perf_counter()
        serve = serve_sharded_drive("cuda")
        serve["wall_s"] = time.perf_counter() - t0
        mesh = serve.get("mesh") or {}
        if len(mesh.get("cards", ())) != K:
            raise AssertionError(f"serve --shards {SHARDS} ran on "
                                 f"{mesh.get('cards')}, not {K} cards")
        log(f"[multicard serve] {json.dumps(serve)} on {card}")
    else:
        serve = None
        log("[multicard serve] (e) needs two visible cards: not run")
    summary = {
        "cards": [str(c) for c in cards], "distinct": distinct,
        "routes": routes, "costs": costs, "profiles": profiles,
        "split": split,
        "peak_bytes_by_card": peak, "stateful": stateful,
        "checkpoint": ckpt, "query": query, "serve": serve,
        "b1_launches": sum(r["b1_launches"] for r in routes.values()),
        "b1_by_card": {index: sum(r["b1_by_card"][index]["launches"]
                                  for r in routes.values())
                       for index in routes["device"]["b1_by_card"]},
        "rule_launches": stateful["rule_launches"],
        "rule_by_card": {index: e["launches"]
                         for index, e in stateful["rule_by_card"].items()},
        "segsum_launches": sum(query[c]["segsum_launches"]
                               for c in ("psum", "ring")),
        "segsum_by_card": dict(collections.Counter(
            query["psum"]["segsum_by_card"])
            + collections.Counter(query["ring"]["segsum_by_card"])),
        "seconds": time.perf_counter() - t_phase}
    log(f"[multicard] phase 14 took {summary['seconds']:.1f} s over "
        f"{K} {'cards' if distinct else 'blocks on one card'}: device "
        f"route p50 {routes['device']['many']['step_ms_p50']:.2f} ms "
        f"(one card {routes['device']['one']['step_ms_p50']:.2f} ms), host "
        f"route p50 {routes['host']['many']['step_ms_p50']:.2f} ms (one "
        f"card {routes['host']['one']['step_ms_p50']:.2f} ms), exchange "
        f"{costs['exchange_ms']:.3f} ms, sums {costs['sums_ms']:.3f} ms, "
        f"on {card}")
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script measures "
              "the card and does not run on the CPU", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--instance-only"]:
        # phase 10 alone, for debugging it (prints no result line)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, name = phase_card()
        phase_instance(dev, card, name)
        return 0
    if sys.argv[1:] == ["--feeders-only"]:
        # phase 11 alone, for debugging it (prints no result line)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, _ = phase_card()
        phase_feeders(dev, card)
        return 0
    if sys.argv[1:2] == ["--cluster-child"]:
        # one host of phase 13, spawned by phase_cluster
        return cluster_child_main(sys.argv[2:])
    if sys.argv[1:] == ["--cluster-only"]:
        # phase 13 alone, for debugging it (prints no result line)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, _ = phase_card()
        phase_cluster(dev, card)
        return 0
    if sys.argv[1:] == ["--sharded-only"]:
        # phase 12 alone, for debugging it (prints no result line)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, _ = phase_card()
        phase_sharded(dev, card)
        return 0
    if sys.argv[1:] == ["--multicard-only"]:
        # phase 14 alone, for debugging it (prints no result line)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, _ = phase_card()
        phase_multicard(dev, card)
        return 0
    if sys.argv[1:] == ["--read-only"]:
        # phase 9 alone, after the phase 3 it reads (prints no result line)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card, _ = phase_card()
        engine, batches, _, _, alerts, state = phase_main_path(dev, card)
        main_ref = {"batches": batches, "alerts": alerts, "state": state,
                    "epoch_base_ms": engine.packer.epoch_base_ms}
        del engine
        phase_read_side(dev, card, main_ref)
        return 0
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
        instance = phase_instance(dev, card, name)
        feeders = phase_feeders(dev, card)
        sharded = phase_sharded(dev, card)
        cluster = phase_cluster(dev, card)
        multicard = phase_multicard(dev, card)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    main_shape = next(r for r in shapes if r["world"] == "main_z256")
    instance_launches = instance["launches_instance_path"]
    kernels = [{
        "name": "points_in_zones",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/geofence.cu",
        "replaces": "sitewhere_tpu/ops/pallas_geofence.py:63",
        "launches": launches["points_in_zones"],
        "launches_stateful_path": stateful_launches,
        "launches_durable_path": durable_launches,
        "launches_ingest_path": ingest_launches,
        "launches_instance_path": instance_launches["points_in_zones"],
        "launches_feeder_path": feeders["launches_feeder_path"],
        "launches_sharded_path": sharded["b1_launches"],
        "launches_sharded_feeder_path": sharded["landing"]["launches"],
        "launches_cluster_path": cluster["b1_launches"],
        "launches_multicard_path": multicard["b1_launches"],
        "launches_multicard_by_card": multicard["b1_by_card"],
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
        "launches_instance_path": instance_launches["segment_row_sum"],
        "launches_mesh_path": read["mesh"]["launches"],
        "launches_cluster_path": cluster["segsum_launches"],
        "launches_multicard_path": multicard["segsum_launches"],
        "launches_multicard_by_card": multicard["segsum_by_card"],
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
        "launches_instance_path": instance_launches["eval_rule_programs"],
        "launches_sharded_path": sharded["rule_launches"],
        "launches_multicard_path": multicard["rule_launches"],
        "launches_multicard_by_card": multicard["rule_by_card"],
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
