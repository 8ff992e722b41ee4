"""Anomaly-model compiler: tiny learned scorers -> fixed-shape weight tables.

Counterpart of `sitewhere_tpu/ml/compiler.py`, same tables, error messages
and codes. Per-device-type tiny models over the step's per-device
last-value/EWMA/rate features — learned-threshold MLPs and autoencoder
reconstruction-error scorers — compile into static SoA weight tables that
ops/anomaly.py evaluates for every (batch row, model) pair inside the step.
Everything pads to static buckets (models, feature slots, layers, layer
width); installing or removing a model only rewrites table rows, and bumps
the slot's epoch so per-device model state resets lazily inside the step.

Spec shape (JSON):

    {"token": "bearing-wear", "tenant_token": "", "device_type_token": "",
     "kind": "mlp",                      # or "autoencoder"
     "alert_type": "anomaly.model", "alert_level": "WARNING",
     "alert_message": "...", "active": true,
     "threshold": 0.8,                   # fire when score > threshold
     "features": [
         {"feature": "value", "measurement": "temp",
          "mean": 70.0, "std": 5.0},
         {"feature": "ewma", "measurement": "vibration", "alpha": 0.3},
         {"feature": "rate", "measurement": "temp"}],
     "layers": [{"weights": [[...], ...], "bias": [...]}, ...],
     "output": {"weights": [...], "bias": -0.5}}   # mlp only

Feature kinds read the same state the rule-program predicates read, with
per-feature standardization ((x - mean) / std) baked into the table as
(mean, 1/std). Scoring:

  mlp          hidden layers tanh; score = sigmoid(out_w . h + out_b)
  autoencoder  hidden layers tanh, FINAL layer linear (must reconstruct
               the n_features inputs); score = mean squared
               reconstruction error over the normalized features

A model fires on the RISING EDGE of (score > threshold) at a device's
observation tick, and only when every used feature is ready and finite.
An invalid spec raises AnomalyModelError (a 409 SiteWhereError) naming the
offending field path ("features[1].alpha").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError

# static buckets: every table pads to these, so its shapes never change.
DEFAULT_MAX_MODELS = 8
MAX_MODEL_BUCKET = 64          # model slot id travels in 8 lane bits
DEFAULT_MODEL_FEATURES = 4
DEFAULT_MODEL_LAYERS = 2
DEFAULT_MODEL_WIDTH = 8
MAX_MODEL_ALERT_LEVEL = 15


class ModelKind:
    MLP = 0
    AUTOENCODER = 1

    BY_NAME = {"mlp": MLP, "autoencoder": AUTOENCODER}


class FeatureKind:
    """Feature-slot opcodes; 0 marks an unused padded slot."""

    UNUSED = 0
    VALUE = 1      # post-fold last measurement
    EWMA = 2       # per-(device, model, feature) EWMA accumulator
    RATE = 3       # per-second rate of change between observations

    BY_NAME = {"value": VALUE, "ewma": EWMA, "rate": RATE}


class AnomalyModelError(SiteWhereError):
    """Invalid anomaly-model spec: names the offending field so the 409
    is actionable on REST and replicated-apply paths alike."""

    def __init__(self, message: str, field_path: str = "spec"):
        super().__init__(f"invalid anomaly model at {field_path}: {message}",
                         ErrorCode.GENERIC, http_status=409)
        self.field_path = field_path


@dataclasses.dataclass
class AnomalyModelTable:
    """SoA weight tables; per-model columns [P], per-feature [P, F],
    stacked zero-padded weights [P, L, H, H] / [P, L, H] / [P, H].

    `epoch` is a per-slot generation number: the scoring stage zeroes a
    slot's ModelStateTensors lanes when its stored generation differs, so
    installing a new model into a recycled slot resets feature state
    inside the step."""

    active: np.ndarray           # bool [P]
    tenant_idx: np.ndarray       # int32 [P], 0 = any tenant
    device_type_idx: np.ndarray  # int32 [P], 0 = any device type
    alert_level: np.ndarray      # int32 [P]
    alert_type_idx: np.ndarray   # int32 [P]
    kind: np.ndarray             # int32 [P] ModelKind
    n_features: np.ndarray       # int32 [P] used feature slots
    n_layers: np.ndarray         # int32 [P] used layers
    threshold: np.ndarray        # float32 [P] fire when score > threshold
    out_b: np.ndarray            # float32 [P] mlp output bias
    epoch: np.ndarray            # int32 [P] state generation

    feat_kind: np.ndarray        # int32 [P, F] FeatureKind
    feat_mm: np.ndarray          # int32 [P, F] measurement slot (< M)
    feat_alpha: np.ndarray       # float32 [P, F] ewma alpha
    feat_mean: np.ndarray        # float32 [P, F] standardization mean
    feat_scale: np.ndarray       # float32 [P, F] 1 / std

    w: np.ndarray                # float32 [P, L, H, H] layer weights
    b: np.ndarray                # float32 [P, L, H] layer biases
    out_w: np.ndarray            # float32 [P, H] mlp output weights

    @property
    def num_models(self) -> int:
        return self.active.shape[0]

    @property
    def num_features(self) -> int:
        return self.feat_kind.shape[1]

    @property
    def num_layers(self) -> int:
        return self.w.shape[1]

    @property
    def width(self) -> int:
        return self.w.shape[2]


def empty_model_table(max_models: int = DEFAULT_MAX_MODELS,
                      max_features: int = DEFAULT_MODEL_FEATURES,
                      max_layers: int = DEFAULT_MODEL_LAYERS,
                      width: int = DEFAULT_MODEL_WIDTH) -> AnomalyModelTable:
    P, F, L, H = max_models, max_features, max_layers, width
    if F > H:
        raise ValueError(
            f"model feature bucket {F} exceeds layer width {H}: features "
            f"embed into the first F lanes of a width-H activation vector")
    zp = np.zeros(P, np.int32)
    zf = np.zeros((P, F), np.int32)
    return AnomalyModelTable(
        active=np.zeros(P, bool), tenant_idx=zp, device_type_idx=zp.copy(),
        alert_level=zp.copy(), alert_type_idx=zp.copy(), kind=zp.copy(),
        n_features=zp.copy(), n_layers=zp.copy(),
        threshold=np.zeros(P, np.float32), out_b=np.zeros(P, np.float32),
        epoch=zp.copy(),
        feat_kind=zf, feat_mm=zf.copy(),
        feat_alpha=np.zeros((P, F), np.float32),
        feat_mean=np.zeros((P, F), np.float32),
        feat_scale=np.ones((P, F), np.float32),
        w=np.zeros((P, L, H, H), np.float32),
        b=np.zeros((P, L, H), np.float32),
        out_w=np.zeros((P, H), np.float32))


# ---------------------------------------------------------------------------
# spec validation / normalization (wire + store form)
# ---------------------------------------------------------------------------

def _require(cond: bool, message: str, path: str) -> None:
    if not cond:
        raise AnomalyModelError(message, path)


def _finite_number(value, message: str, path: str) -> float:
    _require(isinstance(value, (int, float))
             and not isinstance(value, bool), message, path)
    value = float(value)
    _require(math.isfinite(value), message, path)
    return value


def _validate_vector(vec, path: str) -> List[float]:
    _require(isinstance(vec, list) and len(vec) >= 1,
             "must be a non-empty list of numbers", path)
    return [_finite_number(v, "must be a finite number", f"{path}[{i}]")
            for i, v in enumerate(vec)]


def _validate_matrix(mat, path: str) -> List[List[float]]:
    _require(isinstance(mat, list) and len(mat) >= 1,
             "must be a non-empty list of rows", path)
    rows = [_validate_vector(row, f"{path}[{i}]")
            for i, row in enumerate(mat)]
    widths = {len(row) for row in rows}
    _require(len(widths) == 1, "rows must all have the same length", path)
    return rows


def _validate_feature(node, path: str) -> Dict:
    _require(isinstance(node, dict), "feature must be an object", path)
    kind = node.get("feature")
    _require(kind in FeatureKind.BY_NAME,
             f"unknown feature kind {kind!r} (one of "
             f"{sorted(FeatureKind.BY_NAME)})", f"{path}.feature")
    name = node.get("measurement")
    _require(isinstance(name, str) and bool(name),
             "feature requires a 'measurement' name", f"{path}.measurement")
    out = {"feature": kind, "measurement": name}
    if kind == "ewma":
        alpha = node.get("alpha", 0.2)
        _require(isinstance(alpha, (int, float))
                 and not isinstance(alpha, bool)
                 and 0.0 < float(alpha) <= 1.0,
                 "ewma 'alpha' must be in (0, 1]", f"{path}.alpha")
        out["alpha"] = float(alpha)
    mean = node.get("mean", 0.0)
    out["mean"] = _finite_number(mean, "'mean' must be a finite number",
                                 f"{path}.mean")
    std = node.get("std", 1.0)
    std = _finite_number(std, "'std' must be a finite number > 0",
                         f"{path}.std")
    _require(std > 0.0, "'std' must be a finite number > 0", f"{path}.std")
    out["std"] = std
    return out


def model_from_dict(data: Dict) -> Dict:
    """Validate + normalize a wire/store spec into its canonical dict.
    Raises AnomalyModelError (409, names the field) on anything a
    compile could not turn into table rows. Layer dimension chaining is
    validated here too (input dim of layer i must equal output dim of
    layer i-1; layer 0 consumes the feature vector; an autoencoder's
    final layer must reconstruct all n_features)."""
    from sitewhere_tpu_torch.model.event import AlertLevel

    _require(isinstance(data, dict), "spec must be an object", "spec")
    token = data.get("token")
    _require(isinstance(token, str) and bool(token),
             "model requires a string token", "spec.token")
    kind = data.get("kind", "mlp")
    _require(kind in ModelKind.BY_NAME,
             f"unknown model kind {kind!r} (one of "
             f"{sorted(ModelKind.BY_NAME)})", "spec.kind")
    level = data.get("alert_level", int(AlertLevel.WARNING))
    try:
        level = (AlertLevel[level]
                 if isinstance(level, str) and not level.lstrip("-").isdigit()
                 else AlertLevel(int(level)))
    except (KeyError, ValueError, TypeError):
        raise AnomalyModelError(f"invalid alert_level {level!r}",
                                "spec.alert_level")
    _require(0 <= int(level) <= MAX_MODEL_ALERT_LEVEL,
             f"alert_level must fit {MAX_MODEL_ALERT_LEVEL}",
             "spec.alert_level")
    for field in ("tenant_token", "device_type_token", "alert_type",
                  "alert_message"):
        value = data.get(field, "")
        _require(isinstance(value, str),
                 f"'{field}' must be a string", f"spec.{field}")
    threshold = _finite_number(data.get("threshold"),
                               "model requires a finite numeric 'threshold'",
                               "spec.threshold")

    features = data.get("features")
    _require(isinstance(features, list) and len(features) >= 1,
             "model requires a non-empty 'features' list", "spec.features")
    features = [_validate_feature(f, f"features[{i}]")
                for i, f in enumerate(features)]
    n_features = len(features)

    layers_in = data.get("layers")
    _require(isinstance(layers_in, list) and len(layers_in) >= 1,
             "model requires a non-empty 'layers' list", "spec.layers")
    layers = []
    dims = n_features
    for i, layer in enumerate(layers_in):
        path = f"layers[{i}]"
        _require(isinstance(layer, dict), "layer must be an object", path)
        weights = _validate_matrix(layer.get("weights"), f"{path}.weights")
        bias = _validate_vector(layer.get("bias"), f"{path}.bias")
        _require(len(weights[0]) == dims,
                 f"layer input dim {len(weights[0])} != previous output "
                 f"dim {dims}", f"{path}.weights")
        _require(len(bias) == len(weights),
                 f"bias length {len(bias)} != layer output dim "
                 f"{len(weights)}", f"{path}.bias")
        layers.append({"weights": weights, "bias": bias})
        dims = len(weights)

    out = None
    if kind == "mlp":
        out_in = data.get("output")
        _require(isinstance(out_in, dict),
                 "mlp model requires an 'output' {weights, bias} object",
                 "spec.output")
        out_weights = _validate_vector(out_in.get("weights"),
                                       "spec.output.weights")
        _require(len(out_weights) == dims,
                 f"output weights length {len(out_weights)} != last layer "
                 f"output dim {dims}", "spec.output.weights")
        out = {"weights": out_weights,
               "bias": _finite_number(out_in.get("bias", 0.0),
                                      "'bias' must be a finite number",
                                      "spec.output.bias")}
    else:
        _require(dims == n_features,
                 f"autoencoder final layer output dim {dims} must "
                 f"reconstruct all {n_features} features",
                 f"layers[{len(layers) - 1}].weights")

    normalized = {
        "token": token,
        "kind": kind,
        "tenant_token": data.get("tenant_token", "") or "",
        "device_type_token": data.get("device_type_token", "") or "",
        "alert_type": data.get("alert_type", "") or "anomaly.model",
        "alert_level": int(level),
        "alert_message": data.get("alert_message", "") or "",
        "active": bool(data.get("active", True)),
        "threshold": threshold,
        "features": features,
        "layers": layers,
    }
    if out is not None:
        normalized["output"] = out
    return normalized


# ---------------------------------------------------------------------------
# compilation: normalized spec -> weight rows at one model slot
# ---------------------------------------------------------------------------

def compile_model_into(table: AnomalyModelTable, slot: int, spec: Dict,
                       epoch: int, *, intern_measurement,
                       intern_alert_type, lookup_tenant,
                       lookup_device_type, measurement_slots: int) -> None:
    """Compile one normalized spec into model slot `slot` of `table`.

    The intern/lookup callables bind the spec's names to the engine's
    interners (pipeline/engine.py passes its packer + registry). A
    scoping token that does not resolve deactivates the model rather
    than silently widening to "any" — the same rule every other rule
    compiler applies. Bucket overflows (features/layers/width past the
    table's static shape) raise AnomalyModelError naming the field."""
    spec = model_from_dict(spec)  # idempotent; applies on every path
    F, L, H = table.num_features, table.num_layers, table.width

    features = spec["features"]
    if len(features) > F:
        raise AnomalyModelError(
            f"model over the static bucket: {len(features)} features > "
            f"{F} slots", "spec.features")
    layers = spec["layers"]
    if len(layers) > L:
        raise AnomalyModelError(
            f"model over the static bucket: {len(layers)} layers > {L}",
            "spec.layers")
    for i, layer in enumerate(layers):
        if len(layer["weights"]) > H:
            raise AnomalyModelError(
                f"layer output dim {len(layer['weights'])} > width "
                f"bucket {H}", f"layers[{i}].weights")

    mm_slots = []
    for i, feature in enumerate(features):
        mm = intern_measurement(feature["measurement"])
        if not (0 < mm < measurement_slots):
            raise AnomalyModelError(
                f"operand slot out of range: measurement "
                f"{feature['measurement']!r} interned to slot {mm}, "
                f"tracked slots are 1..{measurement_slots - 1}",
                f"features[{i}].measurement")
        mm_slots.append(mm)

    active = spec["active"]
    tenant_idx = dtype_idx = 0
    if spec["tenant_token"]:
        tenant_idx = lookup_tenant(spec["tenant_token"])
        active = active and tenant_idx > 0
    if spec["device_type_token"]:
        dtype_idx = lookup_device_type(spec["device_type_token"])
        active = active and dtype_idx > 0

    # clear the slot before writing (a recycled slot keeps no stale rows)
    table.feat_kind[slot, :] = FeatureKind.UNUSED
    table.feat_mm[slot, :] = 0
    table.feat_alpha[slot, :] = 0.0
    table.feat_mean[slot, :] = 0.0
    table.feat_scale[slot, :] = 1.0
    table.w[slot] = 0.0
    table.b[slot] = 0.0
    table.out_w[slot, :] = 0.0

    for i, feature in enumerate(features):
        table.feat_kind[slot, i] = FeatureKind.BY_NAME[feature["feature"]]
        table.feat_mm[slot, i] = mm_slots[i]
        table.feat_alpha[slot, i] = feature.get("alpha", 0.0)
        table.feat_mean[slot, i] = feature["mean"]
        table.feat_scale[slot, i] = 1.0 / feature["std"]
    for li, layer in enumerate(layers):
        wmat = np.asarray(layer["weights"], np.float32)
        table.w[slot, li, :wmat.shape[0], :wmat.shape[1]] = wmat
        table.b[slot, li, :wmat.shape[0]] = np.asarray(
            layer["bias"], np.float32)
    if "output" in spec:
        out_w = np.asarray(spec["output"]["weights"], np.float32)
        table.out_w[slot, :out_w.shape[0]] = out_w
        table.out_b[slot] = spec["output"]["bias"]
    else:
        table.out_b[slot] = 0.0

    table.active[slot] = active
    table.tenant_idx[slot] = tenant_idx
    table.device_type_idx[slot] = dtype_idx
    table.alert_level[slot] = spec["alert_level"]
    table.alert_type_idx[slot] = intern_alert_type(spec["alert_type"])
    table.kind[slot] = ModelKind.BY_NAME[spec["kind"]]
    table.n_features[slot] = len(features)
    table.n_layers[slot] = len(layers)
    table.threshold[slot] = spec["threshold"]
    table.epoch[slot] = epoch


def dry_run_compile(spec: Dict, *, measurement_slots: int,
                    max_features: int = DEFAULT_MODEL_FEATURES,
                    max_layers: int = DEFAULT_MODEL_LAYERS,
                    width: int = DEFAULT_MODEL_WIDTH,
                    intern_measurement=None) -> Dict:
    """Full validation WITHOUT touching a live table: used by the REST
    create and the replicated-apply paths so a bad spec 409s before any
    store/engine mutation. Returns the normalized spec. When no interner
    is supplied, measurement names validate structurally only (slot 1
    assumed) — the engine-side compile still enforces the range."""
    normalized = model_from_dict(spec)
    table = empty_model_table(1, max_features, max_layers, width)
    compile_model_into(
        table, 0, normalized, epoch=1,
        intern_measurement=intern_measurement or (lambda name: 1),
        intern_alert_type=lambda name: 0,
        lookup_tenant=lambda token: 1,
        lookup_device_type=lambda token: 1,
        measurement_slots=measurement_slots)
    return normalized
