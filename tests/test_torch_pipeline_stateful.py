"""The port's engine with rule programs, anomaly models and actuation
policies installed, held against the JAX package's engine on the CPU.

The world of tests/test_torch_pipeline.py (two tenants, registered and
unassigned devices, zones, threshold/geofence rules) gets the same
programs, models and policies in both engines; the same seeded traffic then
runs through both:
  - alerts (order included), command fires, every canonical state group
    and every per-family counter must be equal, over several steps and
    across install / replace / remove transitions (back to the
    placeholder state included);
  - the step itself, with rows of out-of-range device indices, gives the
    reference's clamped-gather, dropped-scatter answers;
  - the compilers normalize the reference's spec fixtures identically and
    reject invalid specs with the same error code, status and message.
Tolerance: none (f32 compared as int32 bit patterns), but for the per-row
anomaly score channel: rtol=1e-4, atol=1e-5, the reference's own.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.pipeline import engine as tengine
from sitewhere_tpu_torch.pipeline.step import process_batch

from test_torch_pipeline import (
    RULES, _alert_key, _blob_for, _jax_params_dict, assert_bits_equal,
    assert_dataclass_bits_equal, make_cols, world)  # noqa: F401 (fixture)

B, M, T, K = 128, 4, 4, 32
BUCKETS = dict(max_rule_programs=8, rule_program_nodes=16,
               rule_program_state_slots=8, max_anomaly_models=4,
               anomaly_model_features=4, anomaly_model_layers=2,
               anomaly_model_width=8, max_actuation_policies=4,
               command_lane_capacity=8)

PROGRAMS = [
    {"token": "composite", "alert_level": "CRITICAL",
     "when": {"all": [
         {"pred": "value", "measurement": "m1", "op": ">", "value": 60.0},
         {"pred": "value", "measurement": "m2", "op": "<", "value": 40.0}]}},
    {"token": "debounce", "alert_level": "WARNING",
     "when": {"debounce": {"pred": "value", "measurement": "m1", "op": ">",
                           "value": 50.0}, "count": 2}},
    {"token": "duration", "alert_level": "ERROR", "alert_type": "dur",
     "when": {"for_duration": {"pred": "value", "measurement": "m2",
                               "op": ">", "value": 30.0}, "ms": 200}},
    {"token": "hyst", "alert_level": "INFO",
     "when": {"hysteresis": {
         "arm": {"pred": "value", "measurement": "m3", "op": ">",
                 "value": 80.0},
         "disarm": {"pred": "value", "measurement": "m3", "op": "<",
                    "value": 20.0}}}},
    {"token": "rate", "alert_level": "WARNING", "tenant_token": "t2",
     "when": {"pred": "rate", "measurement": "m1", "op": ">",
              "value": 50.0}},
    {"token": "any-not-ewma", "alert_level": "ERROR",
     "alert_message": "m3 low or m1 drifting low",
     "when": {"any": [
         {"not": {"pred": "value", "measurement": "m3", "op": ">=",
                  "value": 10.0}},
         {"pred": "ewma", "measurement": "m1", "op": "<", "value": 30.0,
          "alpha": 0.3}]}},
]
MODELS = [
    {"token": "hot", "kind": "mlp", "threshold": 0.5,
     "alert_level": "WARNING", "alert_type": "anomaly.hot",
     "features": [{"feature": "value", "measurement": "m1",
                   "mean": 50.0, "std": 25.0}],
     "layers": [{"weights": [[1.0]], "bias": [0.0]}],
     "output": {"weights": [40.0], "bias": -38.3}},
    {"token": "drift", "kind": "mlp", "threshold": 0.6,
     "alert_level": "ERROR", "device_type_token": "tracker",
     "features": [{"feature": "ewma", "measurement": "m2", "alpha": 0.4,
                   "mean": 50.0, "std": 20.0}],
     "layers": [{"weights": [[2.0]], "bias": [0.5]}],
     "output": {"weights": [3.0], "bias": -0.5}},
    {"token": "ae", "kind": "autoencoder", "threshold": 0.9,
     "alert_level": "CRITICAL",
     "features": [{"feature": "value", "measurement": "m3",
                   "mean": 50.0, "std": 30.0},
                  {"feature": "rate", "measurement": "m3",
                   "mean": 0.0, "std": 100.0}],
     "layers": [{"weights": [[0.7, 0.2], [-0.3, 0.9], [0.5, 0.5]],
                 "bias": [0.0, 0.1, -0.1]},
                {"weights": [[0.9, -0.2, 0.3], [0.1, 0.8, -0.4]],
                 "bias": [0.05, -0.05]}]},
]
POLICIES = [
    {"token": "on-threshold", "source": "threshold", "min_level": "ERROR",
     "debounce_ms": 0, "command": "shutdown", "params": [1]},
    {"token": "on-program", "source": "program", "min_level": "INFO",
     "debounce_ms": 300, "command": "inspect", "params": [2, -3]},
    {"token": "on-model", "source": "model", "match_slot": 0,
     "command": "cool"},
    {"token": "t2-any", "tenant_token": "t2", "min_level": "CRITICAL",
     "debounce_ms": 500, "command": "page"},
]


@pytest.fixture(scope="module")
def engines(world):
    """A JAX and a port engine over the world's registry, with the stateful
    buckets above and the same rules, measurements and epoch base."""
    from sitewhere_tpu.pipeline import engine as jengine

    kwargs = dict(batch_size=B, measurement_slots=M, max_tenants=T,
                  max_threshold_rules=16, max_geofence_rules=8,
                  alert_lane_capacity=K, **BUCKETS)
    jeng = jengine.PipelineEngine(world["jreg"], name="torch-stateful-ref",
                                  **kwargs)
    teng = tengine.PipelineEngine(world["treg"], device="cpu", **kwargs)
    teng.packer.epoch_base_ms = jeng.packer.epoch_base_ms
    for eng, mod in ((jeng, jengine), (teng, tengine)):
        for name in ("m1", "m2", "m3"):
            eng.packer.measurements.intern(name)
        for spec in RULES:
            eng.upsert_rule(*mod.rule_from_dict(dict(spec)))
        eng.start()
    return jeng, teng


def install(engs, programs=(), models=(), policies=()):
    for eng in engs:
        for spec in programs:
            eng.upsert_rule_program(dict(spec))
        for spec in models:
            eng.upsert_anomaly_model(dict(spec))
        for spec in policies:
            eng.upsert_actuation_policy(dict(spec))


def drive(engs, seeds, variant="compact"):
    """Submit + materialize the same traffic on both engines; asserts equal
    alerts and command fires per step; returns the totals."""
    jeng, teng = engs
    base = jeng.packer.epoch_base_ms
    n_alerts = n_fires = 0
    for seed in seeds:
        cols = make_cols(seed, variant)
        # steps a second apart, so rates and durations see time pass
        cols["ts"] = cols["ts"] + np.int32(1000 * (seed % 7))
        args = (cols["device_idx"], cols["event_type"],
                base + cols["ts"].astype(np.int64))
        kw = {k: cols[k] for k in ("mm_idx", "value", "lat", "lon",
                                   "elevation", "alert_type_idx",
                                   "alert_level")}
        jb, out_j = jeng.submit_routed(jeng.packer.pack_columns(*args, **kw))
        tb, out_t = teng.submit_routed(teng.packer.pack_columns(*args, **kw))
        ja = jeng.materialize_alerts(jb, out_j)
        ta = teng.materialize_alerts(tb, out_t)
        assert [_alert_key(a) for a in ta] == [_alert_key(a) for a in ja]
        jf, tf = jeng.take_command_fires(), teng.take_command_fires()
        assert tf == jf
        n_alerts += len(ta)
        n_fires += len(tf)
    return n_alerts, n_fires


def assert_outputs_equal(ref, got, what):
    """Every output bit-equal but the anomaly score channel, which carries
    the reference's score tolerance."""
    for f in dataclasses.fields(ref):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "model_score":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-5, err_msg=what)
        else:
            assert_bits_equal(r, g, f"{what}.{f.name}")


def assert_engines_equal(engs):
    jeng, teng = engs
    assert_dataclass_bits_equal(jeng.canonical_state(),
                                teng.canonical_state(), "state")
    for group in ("rule", "model", "actuation"):
        assert_dataclass_bits_equal(
            getattr(jeng, f"canonical_{group}_state")(),
            getattr(teng, f"canonical_{group}_state")(), f"{group} state")
    for counters in ("rule_program_counters", "anomaly_model_counters",
                     "actuation_policy_counters"):
        assert getattr(teng, counters)() == getattr(jeng, counters)(), \
            counters
    for manifest in ("rule_program_manifest", "anomaly_model_manifest",
                     "actuation_policy_manifest"):
        assert getattr(teng, manifest)() == getattr(jeng, manifest)(), \
            manifest
    for name in ("commands_fired", "commands_debounced", "commands_dropped",
                 "alerts_dropped"):
        assert getattr(teng, name) == getattr(jeng, name), name


def test_engine_stateful_differential(engines):
    """All three families installed; six steps of mixed traffic."""
    install(engines, PROGRAMS, MODELS, POLICIES)
    n_alerts, n_fires = drive(engines, range(500, 506))
    assert_engines_equal(engines)
    teng = engines[1]
    counters = teng.rule_program_counters()
    assert sum(c["fires"] for c in counters.values()) > 0
    assert sum(c["suppressed"] for c in counters.values()) > 0
    assert sum(c["fires"] for c in teng.anomaly_model_counters().values()) > 0
    assert n_alerts > 0 and n_fires > 0
    assert teng.commands_debounced > 0 and teng.commands_dropped > 0
    assert teng.d2h_fetches == 2 * teng.batches_processed


def test_install_replace_remove_transitions(engines):
    """Replace (epoch bump) and removal down to the placeholder groups,
    then a fresh install: states, alerts and fires stay equal throughout."""
    install(engines, PROGRAMS[:2], MODELS[1:2], POLICIES[1:2])   # replace
    for eng in engines:
        assert eng.remove_rule_program("hyst")
        assert eng.remove_anomaly_model("ae")
    drive(engines, range(510, 512))
    assert_engines_equal(engines)
    for eng in engines:
        for spec in PROGRAMS:
            eng.remove_rule_program(spec["token"])
        for spec in MODELS:
            eng.remove_anomaly_model(spec["token"])
        for spec in POLICIES:
            eng.remove_actuation_policy(spec["token"])
        assert not eng.remove_actuation_policy("on-model")
    drive(engines, range(512, 514))
    assert_engines_equal(engines)
    teng = engines[1]
    assert tuple(teng.canonical_rule_state().slab.shape) == (256, 1, 6)
    assert tuple(teng.canonical_actuation_state().slab.shape) == (256, 1, 6)
    install(engines, PROGRAMS[3:], MODELS[:1], POLICIES)
    drive(engines, range(514, 517))
    assert_engines_equal(engines)
    assert teng.rule_program_manifest()[0]["spec"]["token"] == "hyst"


def test_out_of_range_device_index_matches_xla_clamp_stateful(engines):
    """Rows whose device index is >= D through the stateful step: the
    reference gathers row D-1 for them and drops their scatters; the
    port's outputs and every state group must come out the same."""
    jeng, teng = engines
    install(engines, PROGRAMS, MODELS, POLICIES)
    jparams = jeng._ensure_params()
    tparams = teng._ensure_params()
    d = _jax_params_dict(jparams)
    for name in ("programs", "models", "policies"):
        table = getattr(jparams, name)
        d[name] = {f.name: np.asarray(getattr(table, f.name))
                   for f in dataclasses.fields(table)}
    assert_dataclass_bits_equal(convert.params_from_numpy(d, "cpu"),
                                tparams, "params")
    js = [jeng._state, jeng._rule_state, jeng._model_state,
          jeng._actuation_state]
    ts = [convert.state_from_numpy(dataclasses.asdict(
              jeng.canonical_state()), "cpu"),
          convert.rule_state_from_numpy(convert.rule_state_to_numpy(
              jeng.canonical_rule_state()), "cpu"),
          convert.model_state_from_numpy(convert.model_state_to_numpy(
              jeng.canonical_model_state()), "cpu"),
          convert.actuation_state_from_numpy(convert.actuation_state_to_numpy(
              jeng.canonical_actuation_state()), "cpu")]
    flags = teng._step_flags
    for seed in (600, 601):
        cols = make_cols(seed, "compact", oob=True)
        cols["ts"] = cols["ts"] + np.int32(20_000)
        blob = _blob_for(cols, "compact")
        *js, jout = jeng._step_blob(jparams, *js, jnp.asarray(blob))
        *ts, tout = process_batch(
            tparams, *ts, tpack.blob_to_batch(torch.from_numpy(blob)),
            alert_lane_capacity=K,
            command_lane_capacity=BUCKETS["command_lane_capacity"], **flags)
        assert_outputs_equal(jout, tout, f"outputs {seed}")
        for j, t in zip(js, ts):
            assert_dataclass_bits_equal(j, t, f"state {seed}")
    assert bool(tout.valid[:6].all())
    # the JAX step consumed the engine's (donated) buffers: both engines
    # take the advanced, bit-equal states, and stay in step
    jeng._state, jeng._rule_state, jeng._model_state, \
        jeng._actuation_state = js
    teng._state, teng._rule_state, teng._model_state, \
        teng._actuation_state = ts
    assert_engines_equal(engines)


def test_state_groups_load_across_engines(engines):
    """Each state group of the JAX engine, carried over as numpy dicts,
    loads into the port's engine, which then steps on bit-equal; a group
    of another shape is refused."""
    jeng, teng = engines
    install(engines, PROGRAMS, MODELS, POLICIES)
    drive(engines, [520])
    for group in ("rule", "model", "actuation"):
        d = getattr(convert, f"{group}_state_to_numpy")(
            getattr(jeng, f"canonical_{group}_state")())
        getattr(teng, f"load_canonical_{group}_state")(
            getattr(convert, f"{group}_state_from_numpy")(d, "cpu"))
        d["slab"] = d["slab"][:, :1]
        with pytest.raises(ValueError, match="shape mismatch for slab"):
            getattr(teng, f"load_canonical_{group}_state")(
                getattr(convert, f"{group}_state_from_numpy")(d, "cpu"))
    drive(engines, [521, 522])
    assert_engines_equal(engines)


# -- compilers ----------------------------------------------------------------

def test_compilers_normalize_reference_fixtures_identically():
    from sitewhere_tpu.actuation import compiler as jact
    from sitewhere_tpu.ml import compiler as jml
    from sitewhere_tpu.rules import compiler as jrules
    from sitewhere_tpu_torch.actuation import compiler as tact
    from sitewhere_tpu_torch.ml import compiler as tml
    from sitewhere_tpu_torch.rules import compiler as trules
    from test_torch_actuation import MIXED
    from test_torch_anomaly import MODELS as MODEL_FIXTURES
    from test_torch_stateful import PROGRAMS as PROGRAM_FIXTURES

    for spec in PROGRAM_FIXTURES + PROGRAMS:
        assert trules.dry_run_compile(dict(spec), measurement_slots=4) == \
            jrules.dry_run_compile(dict(spec), measurement_slots=4)
    for spec in MODEL_FIXTURES + MODELS:
        assert tml.dry_run_compile(dict(spec), measurement_slots=4) == \
            jml.dry_run_compile(dict(spec), measurement_slots=4)
    for spec in MIXED + POLICIES:
        assert tact.dry_run_compile(dict(spec)) == \
            jact.dry_run_compile(dict(spec))


INVALID = [
    ("program", {"token": "x", "when": {"all": []}}),
    ("program", {"token": "x", "when": {"all": [
        {"pred": "value", "measurement": "m1", "op": ">", "value": 1},
        {"debounce": {"pred": "value", "measurement": "m1", "value": 1},
         "count": 0}]}}),
    ("program", {"token": "x", "when": {"pred": "ewma", "measurement": "m1",
                                        "value": 1, "alpha": 2.0}}),
    ("program", {"token": "x", "when": {"pred": "value",
                                        "measurement": "m9", "value": 1}}),
    ("program", {"when": {"pred": "value", "measurement": "m1",
                          "value": 1}}),
    ("model", {"token": "x", "threshold": 0.5, "features": [
        {"feature": "ewma", "measurement": "m1", "alpha": 0.0}],
        "layers": [{"weights": [[1.0]], "bias": [0.0]}],
        "output": {"weights": [1.0]}}),
    ("model", {"token": "x", "kind": "autoencoder", "threshold": 1.0,
               "features": [{"feature": "value", "measurement": "m1"}],
               "layers": [{"weights": [[1.0], [2.0]], "bias": [0, 0]}]}),
    ("model", {"token": "x", "threshold": float("nan"),
               "features": [{"feature": "value", "measurement": "m1"}],
               "layers": [{"weights": [[1.0]], "bias": [0.0]}]}),
    ("policy", {"token": "x", "command": "c", "params": [1, 2, 3, 4, 5]}),
    ("policy", {"token": "x", "command": "c", "match_slot": 2}),
    ("policy", {"token": "x", "command": "c", "min_level": "LOUD"}),
    ("policy", {"token": "x", "command": "c", "params": [2 ** 31]}),
]


@pytest.mark.parametrize("kind,spec", INVALID)
def test_invalid_specs_raise_the_reference_error(engines, kind, spec):
    jeng, teng = engines
    method = {"program": "upsert_rule_program",
              "model": "upsert_anomaly_model",
              "policy": "upsert_actuation_policy"}[kind]
    errors = []
    for eng in (jeng, teng):
        with pytest.raises(Exception) as info:
            getattr(eng, method)(dict(spec))
        errors.append(info.value)
    ref, got = errors
    assert type(got).__name__ == type(ref).__name__
    assert str(got) == str(ref)
    assert (int(got.code), got.http_status) == (int(ref.code),
                                                ref.http_status) \
        == (9999, 409)


def test_duplicate_and_capacity_errors_match(engines):
    from sitewhere_tpu_torch.errors import DuplicateTokenError, SiteWhereError

    jeng, teng = engines
    install(engines, policies=POLICIES)
    with pytest.raises(DuplicateTokenError, match="already exists"):
        teng.create_actuation_policy(dict(POLICIES[0]))
    extra = {"token": "fifth", "command": "c"}
    errors = []
    for eng in (jeng, teng):
        with pytest.raises(Exception) as info:
            eng.upsert_actuation_policy(dict(extra))
        errors.append(info.value)
    assert isinstance(errors[1], SiteWhereError)
    assert str(errors[1]) == str(errors[0])
    assert int(errors[1].code) == int(errors[0].code) == 805
