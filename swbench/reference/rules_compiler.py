# Frozen copy of sitewhere_tpu_torch/rules/compiler.py at commit f8b6811,
# imports rewired to swbench.reference; the benchmark's plain
# reference. Do not edit to follow the port: it is the yardstick.
"""Rule-program compiler: a CEP-lite DSL -> fixed-shape program tables.

Counterpart of `sitewhere_tpu/rules/compiler.py`, same tables, error
messages and codes. A small declarative spec compiles into static SoA
program tables — predicate opcodes, operand slot indices, constants, a
binarized boolean-combinator tree, temporal-operator params — padded to a
static max-program bucket. ops/stateful.py evaluates the tables for every
(batch row, program) pair inside the step, with per-(device, program)
state carried on the device across steps.

Spec shape (JSON; `when` is the expression tree):

    {"token": "overheat-dry", "tenant_token": "", "device_type_token": "",
     "alert_type": "rule.program", "alert_level": "WARNING",
     "alert_message": "...", "active": true,
     "when": {"all": [
         {"pred": "value", "measurement": "temp", "op": ">", "value": 90},
         {"for_duration": {"pred": "value", "measurement": "humidity",
                           "op": "<", "value": 20}, "ms": 30000}]}}

Node kinds:
  predicates   {"pred": "value" | "ewma" | "rate", "measurement": name,
                "op": one of > >= < <= == !=, "value": float,
                "alpha": float (ewma only, default 0.2)}
  combinators  {"all": [nodes]}  {"any": [nodes]}  {"not": node}
  temporal     {"for_duration": node, "ms": int}
               {"debounce": node, "count": int}
               {"hysteresis": {"arm": node, "disarm": node}}

Semantics are per step (docs/RULE_PROGRAMS.md): a device's observation
tick is a step in which it had at least one valid measurement event on a
tracked slot; predicates read the post-fold last-measurement state, so
conditions over measurements arriving in different events compose. A
program fires on the RISING EDGE of its root expression at an observation
tick; steps where the root stays true count as suppressions.

An invalid spec raises RuleProgramError (a 409 SiteWhereError) naming the
offending node path ("when.all[1].debounce").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from swbench.reference.base import ErrorCode, SiteWhereError
from swbench.reference.threshold import ThresholdOp

# static buckets: programs, nodes-per-program and stateful-nodes-per-
# program all pad to these, so the tables' shapes never change.
DEFAULT_MAX_PROGRAMS = 32
MAX_PROGRAM_BUCKET = 256       # program slot id travels in 8 lane bits
DEFAULT_PROGRAM_NODES = 16
DEFAULT_STATE_SLOTS = 8
MAX_ALERT_LEVEL = 15           # program alert level travels in 4 lane bits


class ProgramOp:
    """Node opcodes of the compiled program table (evaluation order is
    node-slot order; children always sit at lower slots)."""

    NOP = 0
    VALUE = 1        # cmp(last_measurement[mm], const)
    EWMA = 2         # cmp(ewma_alpha(mm), const)        [stateful]
    RATE = 3         # cmp(d(mm)/dt per second, const)    [stateful]
    NOT = 4          # ~lhs
    AND = 5          # lhs & rhs
    OR = 6           # lhs | rhs
    DEBOUNCE = 7     # lhs held for >= iparam consecutive ticks [stateful]
    FOR_DURATION = 8  # lhs held continuously for >= iparam ms  [stateful]
    HYSTERESIS = 9   # latch: set by lhs (arm), cleared by rhs (disarm)
                     #                                     [stateful]

    STATEFUL = (EWMA, RATE, DEBOUNCE, FOR_DURATION, HYSTERESIS)


class RuleProgramError(SiteWhereError):
    """Invalid rule-program spec: names the offending node so the 409
    is actionable on REST and replicated-apply paths alike."""

    def __init__(self, message: str, node_path: str = "when"):
        super().__init__(f"invalid rule program at {node_path}: {message}",
                         ErrorCode.GENERIC, http_status=409)
        self.node_path = node_path


@dataclasses.dataclass
class RuleProgramTable:
    """SoA program tables; per-program columns [P], per-node [P, N].

    `epoch` is a per-slot generation number: the stateful stage zeroes a
    slot's RuleStateTensors lanes when its stored generation differs, so
    installing a new program into a recycled slot resets temporal state
    inside the step."""

    active: np.ndarray           # bool [P]
    tenant_idx: np.ndarray       # int32 [P], 0 = any tenant
    device_type_idx: np.ndarray  # int32 [P], 0 = any device type
    alert_level: np.ndarray      # int32 [P]
    alert_type_idx: np.ndarray   # int32 [P]
    root: np.ndarray             # int32 [P] root node slot
    epoch: np.ndarray            # int32 [P] state generation

    opcode: np.ndarray           # int32 [P, N] ProgramOp
    mm_idx: np.ndarray           # int32 [P, N] measurement slot (< M)
    lhs: np.ndarray              # int32 [P, N] child node slot
    rhs: np.ndarray              # int32 [P, N] second child node slot
    cmp_op: np.ndarray           # int32 [P, N] ThresholdOp
    fconst: np.ndarray           # float32 [P, N] compare constant
    falpha: np.ndarray           # float32 [P, N] ewma alpha
    iparam: np.ndarray           # int32 [P, N] debounce count / duration ms
    state_slot: np.ndarray       # int32 [P, N] RuleStateTensors lane

    @property
    def num_programs(self) -> int:
        return self.active.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.opcode.shape[1]


def empty_program_table(max_programs: int = DEFAULT_MAX_PROGRAMS,
                        max_nodes: int = DEFAULT_PROGRAM_NODES
                        ) -> RuleProgramTable:
    P, N = max_programs, max_nodes
    zp = np.zeros(P, np.int32)
    zn = np.zeros((P, N), np.int32)
    return RuleProgramTable(
        active=np.zeros(P, bool), tenant_idx=zp, device_type_idx=zp.copy(),
        alert_level=zp.copy(), alert_type_idx=zp.copy(), root=zp.copy(),
        epoch=zp.copy(), opcode=zn, mm_idx=zn.copy(), lhs=zn.copy(),
        rhs=zn.copy(), cmp_op=zn.copy(),
        fconst=np.zeros((P, N), np.float32),
        falpha=np.zeros((P, N), np.float32), iparam=zn.copy(),
        state_slot=zn.copy())


# ---------------------------------------------------------------------------
# spec validation / normalization (wire + store form)
# ---------------------------------------------------------------------------

_COMBINATORS = ("all", "any", "not")
_TEMPORALS = ("for_duration", "debounce", "hysteresis")
_PREDICATES = ("value", "ewma", "rate")


def _require(cond: bool, message: str, path: str) -> None:
    if not cond:
        raise RuleProgramError(message, path)


def _validate_node(node, path: str) -> None:
    """Structural validation of one expression node (no engine context:
    measurement-slot range checks happen at compile time)."""
    _require(isinstance(node, dict), "node must be an object", path)
    if "pred" in node:
        kind = node.get("pred")
        _require(kind in _PREDICATES,
                 f"unknown opcode {kind!r} (one of {_PREDICATES})", path)
        name = node.get("measurement")
        _require(isinstance(name, str) and bool(name),
                 "predicate requires a 'measurement' name", path)
        op = node.get("op", ">")
        _require(op in ThresholdOp.BY_NAME,
                 f"unknown operator {op!r} (one of "
                 f"{sorted(ThresholdOp.BY_NAME)})", path)
        _require(isinstance(node.get("value"), (int, float))
                 and not isinstance(node.get("value"), bool),
                 "predicate requires a numeric 'value'", path)
        if kind == "ewma":
            alpha = node.get("alpha", 0.2)
            _require(isinstance(alpha, (int, float))
                     and 0.0 < float(alpha) <= 1.0,
                     "ewma 'alpha' must be in (0, 1]", path)
        return
    keys = [k for k in node
            if k in _COMBINATORS or k in _TEMPORALS]
    _require(len(keys) == 1,
             "node must be exactly one of pred/all/any/not/"
             "for_duration/debounce/hysteresis", path)
    kind = keys[0]
    sub = node[kind]
    if kind in ("all", "any"):
        _require(isinstance(sub, list) and len(sub) >= 1,
                 f"'{kind}' requires a non-empty list", path)
        for i, child in enumerate(sub):
            _validate_node(child, f"{path}.{kind}[{i}]")
    elif kind == "not":
        _validate_node(sub, f"{path}.not")
    elif kind == "hysteresis":
        _require(isinstance(sub, dict) and "arm" in sub and "disarm" in sub,
                 "'hysteresis' requires {'arm': node, 'disarm': node}", path)
        _validate_node(sub["arm"], f"{path}.hysteresis.arm")
        _validate_node(sub["disarm"], f"{path}.hysteresis.disarm")
    elif kind == "debounce":
        _validate_node(sub, f"{path}.debounce")
        count = node.get("count")
        _require(isinstance(count, int) and not isinstance(count, bool)
                 and count >= 1, "'debounce' requires integer count >= 1",
                 path)
    elif kind == "for_duration":
        _validate_node(sub, f"{path}.for_duration")
        ms = node.get("ms")
        _require(isinstance(ms, int) and not isinstance(ms, bool)
                 and ms >= 0, "'for_duration' requires integer ms >= 0",
                 path)


def program_from_dict(data: Dict) -> Dict:
    """Validate + normalize a wire/store spec into its canonical dict.
    Raises RuleProgramError (409, names the node) on anything a compile
    could not turn into table rows."""
    from swbench.reference.base import AlertLevel

    _require(isinstance(data, dict), "spec must be an object", "spec")
    token = data.get("token")
    _require(isinstance(token, str) and bool(token),
             "program requires a string token", "spec.token")
    level = data.get("alert_level", int(AlertLevel.WARNING))
    try:
        level = (AlertLevel[level]
                 if isinstance(level, str) and not level.lstrip("-").isdigit()
                 else AlertLevel(int(level)))
    except (KeyError, ValueError, TypeError):
        raise RuleProgramError(f"invalid alert_level {level!r}",
                               "spec.alert_level")
    _require(0 <= int(level) <= MAX_ALERT_LEVEL,
             f"alert_level must fit {MAX_ALERT_LEVEL}", "spec.alert_level")
    for field in ("tenant_token", "device_type_token", "alert_type",
                  "alert_message"):
        value = data.get(field, "")
        _require(isinstance(value, str),
                 f"'{field}' must be a string", f"spec.{field}")
    when = data.get("when")
    _require(when is not None, "program requires a 'when' expression",
             "spec.when")
    _validate_node(when, "when")
    return {
        "token": token,
        "tenant_token": data.get("tenant_token", "") or "",
        "device_type_token": data.get("device_type_token", "") or "",
        "alert_type": data.get("alert_type", "") or "rule.program",
        "alert_level": int(level),
        "alert_message": data.get("alert_message", "") or "",
        "active": bool(data.get("active", True)),
        "when": when,
    }


# ---------------------------------------------------------------------------
# compilation: expression tree -> node rows at one program slot
# ---------------------------------------------------------------------------

class _ProgramBuilder:
    """Flattens one expression tree into post-order node rows; children
    always land at lower slots than their parents, so the evaluator is a
    single unrolled pass over node slots."""

    def __init__(self, token: str, max_nodes: int, max_state_slots: int):
        self.token = token
        self.max_nodes = max_nodes
        self.max_state_slots = max_state_slots
        self.rows: List[Dict] = []
        self.next_state_slot = 0

    def _alloc_node(self, path: str) -> int:
        if len(self.rows) >= self.max_nodes:
            raise RuleProgramError(
                f"program over the static bucket: more than "
                f"{self.max_nodes} nodes", path)
        self.rows.append({})
        return len(self.rows) - 1

    def _alloc_state(self, path: str) -> int:
        if self.next_state_slot >= self.max_state_slots:
            raise RuleProgramError(
                f"program over the static bucket: more than "
                f"{self.max_state_slots} stateful nodes", path)
        slot = self.next_state_slot
        self.next_state_slot += 1
        return slot

    def emit(self, node: Dict, path: str, intern_measurement,
             measurement_slots: int) -> int:
        """Returns the node slot holding this subtree's output."""
        if "pred" in node:
            mm = intern_measurement(node["measurement"])
            if not (0 < mm < measurement_slots):
                raise RuleProgramError(
                    f"operand slot out of range: measurement "
                    f"{node['measurement']!r} interned to slot {mm}, "
                    f"tracked slots are 1..{measurement_slots - 1}", path)
            opcode = {"value": ProgramOp.VALUE, "ewma": ProgramOp.EWMA,
                      "rate": ProgramOp.RATE}[node["pred"]]
            row = {"opcode": opcode, "mm_idx": mm,
                   "cmp_op": ThresholdOp.BY_NAME[node.get("op", ">")],
                   "fconst": float(node["value"])}
            if opcode == ProgramOp.EWMA:
                row["falpha"] = float(node.get("alpha", 0.2))
            if opcode in ProgramOp.STATEFUL:
                row["state_slot"] = self._alloc_state(path)
            slot = self._alloc_node(path)
            self.rows[slot] = row
            return slot
        kind = next(k for k in node if k in _COMBINATORS + _TEMPORALS)
        if kind in ("all", "any"):
            op = ProgramOp.AND if kind == "all" else ProgramOp.OR
            children = [self.emit(child, f"{path}.{kind}[{i}]",
                                  intern_measurement, measurement_slots)
                        for i, child in enumerate(node[kind])]
            out = children[0]
            for child in children[1:]:  # left-fold binarization
                slot = self._alloc_node(path)
                self.rows[slot] = {"opcode": op, "lhs": out, "rhs": child}
                out = slot
            return out
        if kind == "not":
            child = self.emit(node["not"], f"{path}.not",
                              intern_measurement, measurement_slots)
            slot = self._alloc_node(path)
            self.rows[slot] = {"opcode": ProgramOp.NOT, "lhs": child}
            return slot
        if kind == "hysteresis":
            arm = self.emit(node["hysteresis"]["arm"],
                            f"{path}.hysteresis.arm",
                            intern_measurement, measurement_slots)
            disarm = self.emit(node["hysteresis"]["disarm"],
                               f"{path}.hysteresis.disarm",
                               intern_measurement, measurement_slots)
            slot = self._alloc_node(path)
            self.rows[slot] = {"opcode": ProgramOp.HYSTERESIS, "lhs": arm,
                               "rhs": disarm,
                               "state_slot": self._alloc_state(path)}
            return slot
        child = self.emit(node[kind], f"{path}.{kind}",
                          intern_measurement, measurement_slots)
        slot = self._alloc_node(path)
        if kind == "debounce":
            self.rows[slot] = {"opcode": ProgramOp.DEBOUNCE, "lhs": child,
                               "iparam": int(node["count"]),
                               "state_slot": self._alloc_state(path)}
        else:
            self.rows[slot] = {"opcode": ProgramOp.FOR_DURATION,
                               "lhs": child, "iparam": int(node["ms"]),
                               "state_slot": self._alloc_state(path)}
        return slot


def compile_program_into(table: RuleProgramTable, slot: int, spec: Dict,
                         epoch: int, *, intern_measurement,
                         intern_alert_type, lookup_tenant,
                         lookup_device_type, measurement_slots: int,
                         max_state_slots: int = DEFAULT_STATE_SLOTS) -> None:
    """Compile one normalized spec into program slot `slot` of `table`.

    The intern/lookup callables bind the spec's names to the engine's
    interners (pipeline/engine.py passes its packer + registry). A
    scoping token that does not resolve deactivates the program rather
    than silently widening to "any" — the same rule the threshold
    compiler applies."""
    spec = program_from_dict(spec)  # idempotent; applies on every path
    builder = _ProgramBuilder(spec["token"], table.num_nodes,
                              max_state_slots)
    root = builder.emit(spec["when"], "when", intern_measurement,
                        measurement_slots)

    active = spec["active"]
    tenant_idx = dtype_idx = 0
    if spec["tenant_token"]:
        tenant_idx = lookup_tenant(spec["tenant_token"])
        active = active and tenant_idx > 0
    if spec["device_type_token"]:
        dtype_idx = lookup_device_type(spec["device_type_token"])
        active = active and dtype_idx > 0

    # clear the slot before writing (a recycled slot keeps no stale rows)
    for name in ("opcode", "mm_idx", "lhs", "rhs", "cmp_op", "iparam",
                 "state_slot"):
        getattr(table, name)[slot, :] = 0
    table.fconst[slot, :] = 0.0
    table.falpha[slot, :] = 0.0
    for j, row in enumerate(builder.rows):
        table.opcode[slot, j] = row.get("opcode", ProgramOp.NOP)
        table.mm_idx[slot, j] = row.get("mm_idx", 0)
        table.lhs[slot, j] = row.get("lhs", 0)
        table.rhs[slot, j] = row.get("rhs", 0)
        table.cmp_op[slot, j] = row.get("cmp_op", 0)
        table.fconst[slot, j] = row.get("fconst", 0.0)
        table.falpha[slot, j] = row.get("falpha", 0.0)
        table.iparam[slot, j] = row.get("iparam", 0)
        table.state_slot[slot, j] = row.get("state_slot", 0)
    table.active[slot] = active
    table.tenant_idx[slot] = tenant_idx
    table.device_type_idx[slot] = dtype_idx
    table.alert_level[slot] = spec["alert_level"]
    table.alert_type_idx[slot] = intern_alert_type(spec["alert_type"])
    table.root[slot] = root
    table.epoch[slot] = epoch


def dry_run_compile(spec: Dict, *, measurement_slots: int,
                    max_nodes: int = DEFAULT_PROGRAM_NODES,
                    max_state_slots: int = DEFAULT_STATE_SLOTS,
                    intern_measurement=None) -> Dict:
    """Full validation WITHOUT touching a live table: used by the REST
    create and the replicated-apply paths so a bad spec 409s before any
    store/engine mutation. Returns the normalized spec. When no interner
    is supplied, measurement names validate structurally only (slot 1
    assumed) — the engine-side compile still enforces the range."""
    normalized = program_from_dict(spec)
    table = empty_program_table(1, max_nodes)
    compile_program_into(
        table, 0, normalized, epoch=1,
        intern_measurement=intern_measurement or (lambda name: 1),
        intern_alert_type=lambda name: 0,
        lookup_tenant=lambda token: 1,
        lookup_device_type=lambda token: 1,
        measurement_slots=measurement_slots,
        max_state_slots=max_state_slots)
    return normalized
