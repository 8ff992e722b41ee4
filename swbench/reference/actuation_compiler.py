# Frozen copy of sitewhere_tpu_torch/actuation/compiler.py at commit f8b6811,
# imports rewired to swbench.reference; the benchmark's plain
# reference. Do not edit to follow the port: it is the yardstick.
"""Actuation-policy compiler: declarative alert->command policies ->
fixed-shape SoA tables.

Counterpart of `sitewhere_tpu/actuation/compiler.py`, same tables, error
messages and codes. Per-tenant JSON policies — "when THIS kind of alert
fires at or above THIS level, send THIS command with THESE params, at most
once per debounce window per device" — compile into a static table that
ops/actuate.py evaluates for every (batch row, policy) pair inside the
step. A replace bumps the slot's epoch so per-(device, policy) debounce
state resets lazily inside the step.

Spec shape (JSON):

    {"token": "overheat-shutdown", "tenant_token": "acme",
     "source": "threshold",       # any|threshold|geofence|program|model
     "match_slot": -1,            # rule idx / program slot / model slot;
                                  # -1 = any slot of the source kind
     "min_level": "WARNING",      # fire only at alert level >= this
     "debounce_ms": 60000,        # per-(device, policy) refractory window
     "command": "shutdown",       # command token delivered to the device
     "params": [1, 0],            # up to 4 int32 params (zero padded)
     "active": true}

A policy matches a batch row when any allowed source kind fired on that
row with a matching slot id and a level >= min_level; per device it
triggers on its LAST matching row of the step, gated by the debounce
window measured in event time against the stored last-fire ts. An invalid
spec raises ActuationPolicyError (a 409 SiteWhereError) naming the
offending field path ("params[2]").
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from swbench.reference.base import ErrorCode, SiteWhereError

# static buckets: every table pads to these, so its shapes never change.
DEFAULT_MAX_POLICIES = 8
MAX_POLICY_BUCKET = 256        # policy slot id travels in 8 lane bits
POLICY_PARAM_SLOTS = 4         # int32 params per policy (command payload)
MAX_POLICY_LEVEL = 15          # level field travels in 4 lane bits
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


class PolicySource:
    """Which alert family a policy listens to; ANY matches all four."""

    ANY = 0
    THRESHOLD = 1
    GEOFENCE = 2
    PROGRAM = 3
    MODEL = 4

    BY_NAME = {"any": ANY, "threshold": THRESHOLD, "geofence": GEOFENCE,
               "program": PROGRAM, "model": MODEL}
    NAMES = {v: k for k, v in BY_NAME.items()}


class ActuationPolicyError(SiteWhereError):
    """Invalid actuation-policy spec: names the offending field so the
    409 is actionable on REST and replicated-apply paths alike."""

    def __init__(self, message: str, field_path: str = "spec"):
        super().__init__(
            f"invalid actuation policy at {field_path}: {message}",
            ErrorCode.GENERIC, http_status=409)
        self.field_path = field_path


@dataclasses.dataclass
class ActuationPolicyTable:
    """SoA policy columns [P] (+ params [P, 4]).

    `epoch` is the per-slot generation: the actuate kernel treats a
    stored debounce record whose generation lags its policy's epoch as
    never-fired, so installing a new policy into a recycled slot resets
    debounce state lazily inside the step."""

    active: np.ndarray       # bool [P]
    tenant_idx: np.ndarray   # int32 [P], 0 = any tenant
    source: np.ndarray       # int32 [P] PolicySource
    match_slot: np.ndarray   # int32 [P], -1 = any slot of the source
    min_level: np.ndarray    # int32 [P]
    debounce_ms: np.ndarray  # int32 [P]
    command_idx: np.ndarray  # int32 [P] interned command token
    params: np.ndarray       # int32 [P, POLICY_PARAM_SLOTS]
    epoch: np.ndarray        # int32 [P] debounce-state generation

    @property
    def num_policies(self) -> int:
        return self.active.shape[0]


def empty_policy_table(max_policies: int = DEFAULT_MAX_POLICIES
                       ) -> ActuationPolicyTable:
    P = max_policies
    zp = np.zeros(P, np.int32)
    return ActuationPolicyTable(
        active=np.zeros(P, bool), tenant_idx=zp,
        source=zp.copy(), match_slot=np.full(P, -1, np.int32),
        min_level=zp.copy(), debounce_ms=zp.copy(),
        command_idx=zp.copy(),
        params=np.zeros((P, POLICY_PARAM_SLOTS), np.int32),
        epoch=zp.copy())


# ---------------------------------------------------------------------------
# spec validation / normalization (wire + store form)
# ---------------------------------------------------------------------------

def _require(cond: bool, message: str, path: str) -> None:
    if not cond:
        raise ActuationPolicyError(message, path)


def _int_in_range(value, lo: int, hi: int, message: str, path: str) -> int:
    _require(isinstance(value, int) and not isinstance(value, bool),
             message, path)
    _require(lo <= value <= hi, message, path)
    return int(value)


def policy_from_dict(data: Dict) -> Dict:
    """Validate + normalize a wire/store spec into its canonical dict.
    Raises ActuationPolicyError (409, names the field) on anything a
    compile could not turn into table rows."""
    from swbench.reference.base import AlertLevel

    _require(isinstance(data, dict), "spec must be an object", "spec")
    token = data.get("token")
    _require(isinstance(token, str) and bool(token),
             "policy requires a string token", "spec.token")

    source = data.get("source", "any")
    _require(source in PolicySource.BY_NAME,
             f"unknown source {source!r} (one of "
             f"{sorted(PolicySource.BY_NAME)})", "spec.source")

    match_slot = data.get("match_slot", -1)
    match_slot = _int_in_range(
        match_slot, -1, _I32_MAX,
        "match_slot must be an integer >= -1 (-1 = any)",
        "spec.match_slot")
    _require(source != "any" or match_slot == -1,
             "match_slot requires a concrete source kind "
             "(slot ids are per-family)", "spec.match_slot")

    level = data.get("min_level", int(AlertLevel.WARNING))
    try:
        level = (AlertLevel[level]
                 if isinstance(level, str) and not level.lstrip("-").isdigit()
                 else AlertLevel(int(level)))
    except (KeyError, ValueError, TypeError):
        raise ActuationPolicyError(f"invalid min_level {level!r}",
                                   "spec.min_level")
    _require(0 <= int(level) <= MAX_POLICY_LEVEL,
             f"min_level must fit {MAX_POLICY_LEVEL}", "spec.min_level")

    debounce = data.get("debounce_ms", 0)
    debounce = _int_in_range(
        debounce, 0, _I32_MAX,
        "debounce_ms must be an int32 integer >= 0", "spec.debounce_ms")

    command = data.get("command")
    _require(isinstance(command, str) and bool(command),
             "policy requires a string 'command' token", "spec.command")

    params_in = data.get("params", [])
    _require(isinstance(params_in, list)
             and len(params_in) <= POLICY_PARAM_SLOTS,
             f"params must be a list of at most {POLICY_PARAM_SLOTS} "
             f"int32 values", "spec.params")
    params = [_int_in_range(v, _I32_MIN, _I32_MAX,
                            "param must be an int32 integer",
                            f"spec.params[{i}]")
              for i, v in enumerate(params_in)]

    tenant_token = data.get("tenant_token", "") or ""
    _require(isinstance(tenant_token, str),
             "'tenant_token' must be a string", "spec.tenant_token")

    return {
        "token": token,
        "tenant_token": tenant_token,
        "source": source,
        "match_slot": match_slot,
        "min_level": int(level),
        "debounce_ms": debounce,
        "command": command,
        "params": params,
        "active": bool(data.get("active", True)),
    }


# ---------------------------------------------------------------------------
# compilation: normalized spec -> table rows at one policy slot
# ---------------------------------------------------------------------------

def compile_policy_into(table: ActuationPolicyTable, slot: int, spec: Dict,
                        epoch: int, *, intern_command,
                        lookup_tenant) -> None:
    """Compile one normalized spec into policy slot `slot` of `table`.

    `intern_command` binds the command token to the engine's command
    interner (the dispatcher resolves lane rows back through its
    token_array); `lookup_tenant` scopes the policy. A tenant token that
    does not resolve deactivates the policy rather than silently
    widening to "any" — the rule every other compiler here applies."""
    spec = policy_from_dict(spec)  # idempotent; applies on every path

    command_idx = intern_command(spec["command"])
    if command_idx <= 0:
        raise ActuationPolicyError(
            f"command token {spec['command']!r} exhausted the command "
            f"interner (capacity)", "spec.command")

    active = spec["active"]
    tenant_idx = 0
    if spec["tenant_token"]:
        tenant_idx = lookup_tenant(spec["tenant_token"])
        active = active and tenant_idx > 0

    table.active[slot] = active
    table.tenant_idx[slot] = tenant_idx
    table.source[slot] = PolicySource.BY_NAME[spec["source"]]
    table.match_slot[slot] = spec["match_slot"]
    table.min_level[slot] = spec["min_level"]
    table.debounce_ms[slot] = spec["debounce_ms"]
    table.command_idx[slot] = command_idx
    table.params[slot, :] = 0
    table.params[slot, :len(spec["params"])] = np.asarray(
        spec["params"], np.int64).astype(np.int32)
    table.epoch[slot] = epoch


def dry_run_compile(spec: Dict, *, intern_command=None) -> Dict:
    """Full validation WITHOUT touching a live table: used by the REST
    create and the replicated-apply paths so a bad spec 409s before any
    store/engine mutation. Returns the normalized spec. When no command
    interner is supplied, command tokens validate structurally only —
    the engine-side compile still enforces interner capacity."""
    normalized = policy_from_dict(spec)
    table = empty_policy_table(1)
    compile_policy_into(
        table, 0, normalized, epoch=1,
        intern_command=intern_command or (lambda token: 1),
        lookup_tenant=lambda token: 1)
    return normalized
