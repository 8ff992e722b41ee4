"""The one traffic generator: a mix file's parameters and a seed make a pool
of distinct batches; step k sends pool batch k % P with its event times
moved forward by (k // P) pool spans, so time advances as in a live fleet
and no batch is generated inside the window.

Batch p's events are dated within [p, p + 1) batch spans of the pool's
start; a pool spans P batch spans, so every reuse dates its events after
all earlier ones. Rewritten from chip_smoke.py `synthetic_batch`: device
keys uniform over the registered devices, the measurement / location /
alert mix, values U(lo, hi), lat/lon uniform in the configuration's box.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MEASUREMENT, LOCATION, ALERT = 0, 1, 2


def make_pool(traffic: Dict, config: Dict, seed: int) -> List[Dict]:
    """P batches of numpy columns, as the step sees them after the wire
    unpack (value / mm only on measurements, lat / lon only on
    locations): dev, et, ts (int32 ms since the epoch base), mm, value,
    lat, lon."""
    B, P, span = traffic["batch"], traffic["pool"], traffic["batch_span_ms"]
    mix = traffic["mix"]
    probs = [mix["measurement"], mix["location"], mix["alert"]]
    n_reg = config["registered_devices"]
    lo, hi = traffic["value_range"]
    box = config["lat_lon_box"]
    slots = np.asarray(traffic["mm_slots"], np.int32)
    if traffic.get("keys", "uniform") != "uniform":
        raise ValueError(f"unknown key distribution {traffic['keys']!r}")
    pool = []
    for p in range(P):
        rng = np.random.default_rng([seed, 2, p])
        dev = rng.integers(1, n_reg + 1, B).astype(np.int32)
        et = rng.choice(np.array([MEASUREMENT, LOCATION, ALERT], np.int32),
                        size=B, p=probs).astype(np.int32)
        ts = (p * span + rng.integers(0, span, B)).astype(np.int32)
        value = rng.uniform(lo, hi, B).astype(np.float32)
        lat = rng.uniform(box[0], box[1], B).astype(np.float32)
        lon = rng.uniform(box[0], box[1], B).astype(np.float32)
        mm = (np.full(B, slots[0], np.int32) if len(slots) == 1
              else rng.choice(slots, B).astype(np.int32))
        is_m, is_l = et == MEASUREMENT, et == LOCATION
        pool.append({
            "dev": dev, "et": et, "ts": ts,
            "mm": np.where(is_m, mm, 0).astype(np.int32),
            "value": np.where(is_m, value, 0).astype(np.float32),
            "lat": np.where(is_l, lat, 0).astype(np.float32),
            "lon": np.where(is_l, lon, 0).astype(np.float32)})
    return pool


def pool_span_ms(traffic: Dict) -> int:
    return traffic["pool"] * traffic["batch_span_ms"]


def step_source(k: int, traffic: Dict) -> Tuple[int, int]:
    """(pool index, ms added to its event times) of step k."""
    P = traffic["pool"]
    return k % P, (k // P) * pool_span_ms(traffic)


def port_batches(pool: List[Dict]):
    """The pool as the port's EventBatch objects (CPU tensors)."""
    import torch
    from sitewhere_tpu_torch.ops.pack import EventBatch

    out = []
    for cols in pool:
        B = cols["dev"].shape[0]
        zi = torch.zeros(B, dtype=torch.int32)
        zf = torch.zeros(B, dtype=torch.float32)
        out.append(EventBatch(
            device_idx=torch.from_numpy(cols["dev"]), tenant_idx=zi,
            event_type=torch.from_numpy(cols["et"]),
            ts=torch.from_numpy(cols["ts"]),
            mm_idx=torch.from_numpy(cols["mm"]),
            value=torch.from_numpy(cols["value"]),
            lat=torch.from_numpy(cols["lat"]),
            lon=torch.from_numpy(cols["lon"]), elevation=zf,
            alert_type_idx=zi, alert_level=zi.clone(),
            valid=torch.ones(B, dtype=torch.bool)))
    return out


def batch_for_step(k: int, traffic: Dict, pool: List[Dict], batches):
    """Step k's EventBatch: its pool batch with the times moved on."""
    import dataclasses

    import torch

    p, shift = step_source(k, traffic)
    if shift == 0:
        return batches[p]
    return dataclasses.replace(
        batches[p], ts=torch.from_numpy(pool[p]["ts"] + np.int32(shift)))


def sampled_devices(seed: int, n_registered: int, n: int) -> np.ndarray:
    """Sorted device indices whose whole history the reference replays."""
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(np.arange(1, n_registered + 1), n,
                              replace=False)).astype(np.int64)


def answer_offset(seed: int, every: int) -> int:
    """Steps k with k % every == offset keep their full answers."""
    return int(np.random.default_rng([seed, 4]).integers(0, every))
