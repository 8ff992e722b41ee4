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
     and m2; B1 launches counted, CUDA-event spans of the stateful stages
     and a profile. The first STATEFUL_CPU_STEPS batches then run through
     the same engine built on the CPU: alerts, command fires, every state
     group (f32 as bit patterns) and every counter must be identical, the
     per-row anomaly scores within rtol=1e-4, atol=1e-5.
The last lines are the kernels' JSON line, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
H100_F32_FLOPS = 67e12        # NVIDIA H100 SXM data sheet, non-tensor f32
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


# -- measurement helpers --------------------------------------------------------

def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    sources = ["geofence"]
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


def build_world(dev, geofence_impl, epoch_base_ms=None):
    from sitewhere_tpu_torch.model import AlertLevel
    from sitewhere_tpu_torch.pipeline import (
        GeofenceRule, PipelineEngine, ThresholdRule)
    from sitewhere_tpu_torch.registry import RegistryTensors

    rng = np.random.default_rng(SEED)
    reg = RegistryTensors(max_devices=MAX_DEVICES, max_zones=N_ZONES,
                          max_zone_vertices=N_VERTS)
    reg.mirror_devices([f"dev-{i}" for i in range(1, N_REGISTERED + 1)],
                       tenant="tenant-1", device_type="sensor",
                       area="area-1")
    _, _, verts = random_world(SEED, 1, N_ZONES, N_VERTS, box=LAT_LON_BOX,
                               radius=ZONE_RADIUS)
    for z in range(N_ZONES):
        reg.mirror_zone(f"zone-{z}", "tenant-1",
                        [tuple(v) for v in verts[z]], area="area-1")
    engine = PipelineEngine(
        reg, batch_size=BATCH, measurement_slots=MEASUREMENT_SLOTS,
        max_tenants=MAX_TENANTS, max_threshold_rules=MAX_RULES,
        max_geofence_rules=MAX_RULES,
        presence_missing_interval_ms=PRESENCE_MS,
        geofence_impl=geofence_impl,
        device=dev)
    engine.packer.epoch_base_ms = (
        epoch_base_ms if epoch_base_ms is not None
        else int(time.time() * 1000) - EPOCH_LAG_MS)
    engine.packer.measurements.intern("m1")
    for i in range(N_THRESHOLD):
        engine.add_threshold_rule(ThresholdRule(
            token=f"thr-{i}", measurement_name="m1", operator=">",
            threshold=95.0 + i, alert_level=AlertLevel.WARNING))
    zones = rng.permutation(N_ZONES)[:N_GEOFENCE]
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


def run_trace(engine, batches):
    """submit + materialize_alerts over `batches`; per-step wall seconds
    (each ends in the lanes' host copy, which waits for the card) and the
    materialized alert keys."""
    walls, alerts = [], []
    for batch in batches:
        t0 = time.perf_counter()
        out = engine.submit(batch)
        got = engine.materialize_alerts(batch, out)
        walls.append(time.perf_counter() - t0)
        alerts.append(_alert_keys(got))
    return walls, alerts


def phase_main_path(dev, card):
    from sitewhere_tpu_torch.ops.geofence_kernel import (
        points_in_zones_kernel)
    t0 = time.perf_counter()
    engine = build_world(dev, "auto")
    batches = [synthetic_batch(engine.packer, N_REGISTERED, BATCH, SEED + s)
               for s in range(WARMUP + STEPS)]
    log(f"[main] world + {len(batches)} batches built in "
        f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    points_in_zones_kernel.launches = 0
    walls, alerts = run_trace(engine, batches)
    state_before_sweep = engine.canonical_state()
    t_sweep = time.perf_counter()
    missing = engine.presence_sweep()
    sweep_s = time.perf_counter() - t_sweep
    launches = {"points_in_zones": points_in_zones_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    if launches["points_in_zones"] != len(batches):
        raise AssertionError(f"geofence kernel launched "
                             f"{launches['points_in_zones']} times over "
                             f"{len(batches)} steps; expected one per step")

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
    }
    log(f"[main] {json.dumps(summary)} on {card}")
    if stats["tenant_event_count"][1] != BATCH * len(batches):
        raise AssertionError(f"tenant event count {stats} != "
                             f"{BATCH * len(batches)}")
    if not missing or summary["alerts_materialized"] == 0:
        raise AssertionError("main path fired no alerts or no presence "
                             "transition")

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
    for name in plain_state.__dataclass_fields__:
        a, b = getattr(state_before_sweep, name), getattr(plain_state, name)
        if a.dtype == torch.float32:   # bit patterns: -0.0 and NaN count
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"canonical state differs in {name}")
    if plain_missing != missing or not torch.equal(
            engine.state.present, plain.state.present):
        raise AssertionError("presence transitions differ")
    log(f"[main] plain-geofence engine: identical alerts "
        f"({summary['alerts_materialized']} timed), canonical state and "
        f"presence transitions ({len(missing)})")
    return engine, batches, summary, launches


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
    `all_events_sum_ms_per_step` for comparison with their records."""
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


def build_stateful_world(dev, epoch_base_ms=None):
    """Phase 3's world with the stateful families installed; the engine's
    stateful buckets are its defaults, the JAX engine's."""
    engine = build_world(dev, "auto", epoch_base_ms)
    engine.packer.measurements.intern("m2")
    for spec in STATEFUL_PROGRAMS:
        engine.upsert_rule_program(dict(spec))
    for spec in STATEFUL_MODELS:
        engine.upsert_anomaly_model(dict(spec))
    for spec in STATEFUL_POLICIES:
        engine.upsert_actuation_policy(dict(spec))
    engine.start()
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


def run_stateful_trace(engine, batches, n_check):
    """submit + materialize_alerts + take_command_fires over `batches`.
    Returns per-step walls and materialized-alert counts, then for the
    first `n_check` steps the alert keys, command fires and per-row anomaly
    scores, the snapshot after step `n_check`, and the per-family
    fired-row counts of all steps (on the device, summed after each step's
    wall)."""
    walls, counts, alerts, fires, scores, snap = [], [], [], [], [], None
    families = torch.zeros(4, dtype=torch.int64, device=engine.device)
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        out = engine.submit(batch)
        got = engine.materialize_alerts(batch, out)
        fired = engine.take_command_fires()
        walls.append(time.perf_counter() - t0)
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
            families.cpu().tolist())


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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


def phase_stateful(dev, card, main_summary):
    from sitewhere_tpu_torch.ops.geofence_kernel import (
        points_in_zones_kernel)

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
    points_in_zones_kernel.launches = 0
    walls, counts, alerts, fires, scores, snap, families = \
        run_stateful_trace(engine, batches, STATEFUL_CPU_STEPS)
    launches = points_in_zones_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != len(batches):
        raise AssertionError(f"geofence kernel launched {launches} times "
                             f"over {len(batches)} stateful steps; "
                             f"expected one per step")
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
    }
    log(f"[stateful] {json.dumps(summary)} on {card}")
    log(f"[stateful] counters {json.dumps(counters)}")
    if not (families[2] and families[3] and engine.commands_fired):
        raise AssertionError("stateful path fired no program or model "
                             "alert, or no command")

    t_cpu = time.perf_counter()
    cpu = build_stateful_world(torch.device("cpu"),
                               engine.packer.epoch_base_ms)
    _, _, c_alerts, c_fires, c_scores, c_snap, _ = run_stateful_trace(
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

    spans = stateful_spans(engine, batches[-1], card)
    prof = profile_engine(engine, batches)
    log(f"[stateful] profiler: {json.dumps(prof)} on {card}")
    log(f"[stateful] phase took {time.perf_counter() - t_phase:.1f} s")
    return summary, launches, spans, prof


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
        engine, batches, summary, launches = phase_main_path(dev, card)
        phase_breakdown(engine, batches, card)
        del engine
        _, stateful_launches, _, _ = phase_stateful(dev, card, summary)
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
