"""Online refit under drift: keep deployed models honest as the field moves.

A model's standardization constants (per-feature mean / std) and fire
threshold are fit offline, but the fleet drifts — sensors age, seasons
turn, firmware changes the baseline. Once the constants go stale the
model either storms (every device "anomalous") or goes blind. The
actuation loop makes this urgent: a storming model now PUSHES COMMANDS.

The refitter closes the adaptation loop with data the platform already
holds on device: the fused model-state slab carries per-(device, model,
feature) EWMA accumulators and rate lanes (ops/anomaly.py), and the
device-state tensors carry every device's post-fold last measurement.
One on-demand D2H snapshot (never the hot path) yields population
moments per feature; the refit spec re-centers (mean, std) on those
moments, re-scores the observed fleet with a host-side NumPy forward
pass (bit-same equations as the oracle in tests/test_anomaly_models.py)
and re-sets the threshold at a quantile of the refit scores. The new
spec pushes through the SAME ``upsert_anomaly_model`` path every other
config change uses — so it rides `_model` gossip to every peer, and the
slot's epoch bump resets feature state lazily inside the step.

``time-to-adapt`` (bench.py drift scenario) is the end-to-end measure:
inject a mean shift, watch the stale model storm, refit, and report the
wall time until the fire rate returns to baseline.

Counterpart of `sitewhere_tpu/actuation/refit.py`. On the card the
snapshot is one device-to-host copy each of the engine's live model slab
and last-measurement columns (the resident state groups the captured step
updates in place, never a replay's output copy), taken under the engine's
state lock.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Optional

import numpy as np

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.ops.slab import unpack_state_slab_np
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

LOGGER = logging.getLogger("sitewhere.actuation")

DEFAULT_THRESHOLD_QUANTILE = 0.99
# the refit threshold is margin * quantile(refit scores): the snapshot is
# one frozen instant per device, so its top quantile underestimates the
# step-to-step score spread — fresh draws would trip a bare quantile
DEFAULT_THRESHOLD_MARGIN = 3.0
MIN_REFIT_DEVICES = 4
MIN_REFIT_STD = 1e-3


def forward_scores(spec: Dict, feats: np.ndarray) -> np.ndarray:
    """Host-side NumPy forward pass over RAW feature rows [N, F] using
    the spec's (mean, std) and weights — the oracle equations from
    ops/anomaly.py: tanh hidden layers; mlp score = sigmoid(out_w . h +
    out_b); autoencoder final layer LINEAR, score = mean squared
    reconstruction error of the normalized features."""
    feats = np.asarray(feats, np.float32)
    mean = np.array([f.get("mean", 0.0) for f in spec["features"]],
                    np.float32)
    std = np.array([f.get("std", 1.0) for f in spec["features"]],
                   np.float32)
    z = (feats - mean) / std
    h = z
    layers = spec.get("layers", [])
    last = len(layers) - 1
    for li, layer in enumerate(layers):
        W = np.asarray(layer["weights"], np.float32)
        b = np.asarray(layer["bias"], np.float32)
        h = h @ W.T + b
        if not (spec["kind"] == "autoencoder" and li == last):
            h = np.tanh(h)
    if spec["kind"] == "autoencoder":
        return ((h - z) ** 2).mean(axis=1)
    out = spec["output"]
    logit = h @ np.asarray(out["weights"], np.float32) + out["bias"]
    return 1.0 / (1.0 + np.exp(-logit))


class DriftRefitter:
    """Snapshot live feature state for one model and refit its
    standardization constants and threshold against the CURRENT fleet.

    Moments are permutation-invariant, so the device order of the rows
    does not matter."""

    def __init__(self, engine, *,
                 min_devices: int = MIN_REFIT_DEVICES,
                 min_std: float = MIN_REFIT_STD,
                 threshold_quantile: float = DEFAULT_THRESHOLD_QUANTILE,
                 threshold_margin: float = DEFAULT_THRESHOLD_MARGIN):
        self.engine = engine
        self.min_devices = int(min_devices)
        self.min_std = float(min_std)
        self.threshold_quantile = float(threshold_quantile)
        self.threshold_margin = float(threshold_margin)
        self.refits = 0

    # -- state snapshot ----------------------------------------------------

    def _model_entry(self, token: str) -> Dict:
        for entry in self.engine.anomaly_model_manifest():
            if entry["spec"]["token"] == token:
                return entry
        raise KeyError(f"unknown anomaly model '{token}'")

    def feature_matrix(self, token: str) -> np.ndarray:
        """Per-device RAW feature rows [N, F] for every device that has
        observed ALL of the model's features (NaN-free, generation
        current); N == 0 when nothing qualified yet.

        Feature sources mirror what the kernel reads: `value` features
        read the post-fold last measurement (device state), `ewma` the
        accumulator lane, `rate` the last computed rate lane (model
        state slab)."""
        entry = self._model_entry(token)
        slot, epoch, spec = entry["slot"], entry["epoch"], entry["spec"]
        eng = self.engine
        with eng._state_lock:
            slab = eng._model_state.slab.cpu().numpy()
            last_mm = eng._state.last_measurement.cpu().numpy()
            last_mm_ts = eng._state.last_measurement_ts.cpu().numpy()
        planes = unpack_state_slab_np(slab)
        D = slab.shape[0]
        _NEG = -(2 ** 31)
        cols: List[np.ndarray] = []
        ok = planes["row_gen"][:, slot] == epoch
        for i, feature in enumerate(spec["features"]):
            kind = feature["feature"]
            if kind == "value":
                mm = eng.packer.measurements.lookup(feature["measurement"])
                col = last_mm[:, mm].astype(np.float32)
                seen = last_mm_ts[:, mm] != _NEG
            elif kind == "ewma":
                col = planes["value"][:, slot, i]
                seen = planes["counter"][:, slot, i] >= 1
            else:                      # rate
                col = planes["aux"][:, slot, i]
                seen = planes["counter"][:, slot, i] >= 2
            cols.append(col)
            ok = ok & seen & np.isfinite(col)
        if not cols:
            return np.empty((0, 0), np.float32)
        feats = np.stack(cols, axis=1)[ok]
        return np.asarray(feats, np.float32).reshape(int(ok.sum()),
                                                     len(cols))

    def snapshot_moments(self, token: str) -> List[Dict]:
        """Per-feature population moments over the qualified fleet."""
        entry = self._model_entry(token)
        feats = self.feature_matrix(token)
        out = []
        for i, feature in enumerate(entry["spec"]["features"]):
            if feats.shape[0]:
                col = feats[:, i]
                out.append({"feature": feature["feature"],
                            "measurement": feature["measurement"],
                            "n": int(feats.shape[0]),
                            "mean": float(col.mean()),
                            "std": float(col.std())})
            else:
                out.append({"feature": feature["feature"],
                            "measurement": feature["measurement"],
                            "n": 0, "mean": 0.0, "std": 0.0})
        return out

    # -- refit -------------------------------------------------------------

    def refit(self, token: str, *, apply: bool = True,
              refit_threshold: bool = True) -> Optional[Dict]:
        """Re-center the model's feature constants on the live fleet and
        (optionally) re-set its threshold at `threshold_quantile` of the
        refit scores. Returns the report dict, or None when fewer than
        `min_devices` devices qualify (refusing a refit on thin data is
        the safe failure — the stale model keeps running)."""
        entry = self._model_entry(token)
        spec = copy.deepcopy(entry["spec"])
        feats = self.feature_matrix(token)
        n = int(feats.shape[0])
        if n < self.min_devices:
            LOGGER.warning(
                "refit of '%s' skipped: %d qualified devices < %d",
                token, n, self.min_devices)
            return None
        for i, feature in enumerate(spec["features"]):
            col = feats[:, i]
            feature["mean"] = float(col.mean())
            feature["std"] = float(max(col.std(), self.min_std))
        old_threshold = spec["threshold"]
        if refit_threshold:
            scores = forward_scores(spec, feats)
            q = float(np.quantile(scores, self.threshold_quantile))
            spec["threshold"] = max(q * self.threshold_margin,
                                    float(np.finfo(np.float32).tiny))
        report = {"token": token, "devices": n,
                  "old_threshold": float(old_threshold),
                  "threshold": float(spec["threshold"]),
                  "features": [{"measurement": f["measurement"],
                                "mean": f["mean"], "std": f["std"]}
                               for f in spec["features"]],
                  "applied": bool(apply)}
        if apply:
            # the ONE write path: epoch bumps (state resets lazily in
            # the step) and instance-level wiring replicates via gossip
            self.engine.upsert_anomaly_model(spec)
            self.refits += 1
            LOGGER.info(
                "refit '%s': threshold %.4f -> %.4f over %d devices",
                token, report["old_threshold"], report["threshold"], n)
        return report


class DriftRefitJobExecutor:
    """ScheduleManager executor (ScheduledJobType.DRIFT_REFIT): one job
    fire = one unattended refit sweep.

    Without it a refit runs only when an operator POSTs one. Registered
    on every tenant engine's schedule manager
    (multitenant/engine.py), so a simple-trigger schedule turns the
    adaptation loop autonomous: each fire walks the engine's installed
    anomaly models (or the comma-separated ``models`` subset in the job
    configuration) and pushes a refit through the same gossip-replicated
    ``upsert_anomaly_model`` path the manual route uses. Thin-data
    models are skipped by the refitter itself (`min_devices`), so an
    unattended sweep can never clobber a model with a bad fit. Sweeps
    are counted under ``actuation.refit_sweeps``; instance wiring is
    opt-in via the off-by-default ``actuation.refit_interval_s`` knob
    (runtime/config.py)."""

    # job_configuration key: comma-separated model tokens ("" = all)
    MODELS_KEY = "models"

    def __init__(self, refitter: DriftRefitter, metrics=None):
        self.refitter = refitter
        m = metrics or GLOBAL_METRICS
        self.sweep_counter = m.counter("actuation.refit_sweeps")

    def execute(self, job) -> Dict:
        cfg = getattr(job, "job_configuration", None) or {}
        wanted = [t for t in
                  (cfg.get(self.MODELS_KEY) or "").split(",") if t]
        if not wanted:
            wanted = [entry["spec"]["token"] for entry in
                      self.refitter.engine.anomaly_model_manifest()]
        applied = 0
        for token in wanted:
            try:
                report = self.refitter.refit(token, apply=True)
            except (KeyError, SiteWhereError):
                # the model went away or its refit spec was refused; a
                # failed read off the card propagates
                LOGGER.exception("scheduled refit of '%s' failed", token)
                continue
            if report is not None:
                applied += 1
        self.sweep_counter.inc()
        return {"models": len(wanted), "applied": applied}
