"""The host side of the port's stateful families held against the JAX
package's, on the CPU: the install stores (rules/store.py, ml/store.py,
actuation/store.py), the command fan-out (actuation/dispatcher.py), the
drift refitter (actuation/refit.py) and the presence manager
(pipeline/presence.py).

  - stores: the reference's ScriptedRuleStore scenarios
    (tests/test_scripts_replication.py) on the port's store; the same
    operations on each package's rule-program, model and policy stores on
    a pinned clock give the same answers and the same JSON file, and a file
    either package wrote loads in the other;
  - fan-out: engines of both packages with the same policies and the same
    seeded `command_delivery_error` plan deliver, retry, park and redeliver
    the same fires; delivered + parked equals what `take_command_fires`
    yields on a twin engine with no dispatcher; the replay barrier
    suppresses a restored tenant's fires;
  - refit: the same feature matrix (bit for bit), report and refit spec on
    both packages' engines after the same traffic, and the engines stay
    bit-equal after applying it; the scheduled sweep reports alike;
  - presence: one `sweep` of the port's manager equals the JAX manager's
    and a twin engine's `presence_sweep`; its thread sweeps on its own.
Tolerance: none.
"""

import json
import threading
import time

import numpy as np
import pytest

import test_scripts_replication as ref_scripts
from sitewhere_tpu.actuation import dispatcher as jdispatch
from sitewhere_tpu.actuation import refit as jrefit
from sitewhere_tpu.actuation import store as jact_store
from sitewhere_tpu.ml import store as jml_store
from sitewhere_tpu.pipeline import presence as jpresence
from sitewhere_tpu.rules import store as jrules_store
from sitewhere_tpu.runtime import faults as j_faults
from sitewhere_tpu_torch.actuation import dispatcher as tdispatch
from sitewhere_tpu_torch.actuation import refit as trefit
from sitewhere_tpu_torch.actuation import store as tact_store
from sitewhere_tpu_torch.ml import store as tml_store
from sitewhere_tpu_torch.pipeline import presence as tpresence
from sitewhere_tpu_torch.rules import store as trules_store
from sitewhere_tpu_torch.runtime import faults as t_faults
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.runtime.recovery import ReplayBarrier

from test_torch_checkpoint import (
    EPOCH, assert_same_engines, jax_engine, jax_registry, port_engine, step)
from test_torch_pipeline_stateful import MODELS, POLICIES, PROGRAMS


@pytest.fixture(autouse=True)
def _always_disarm():
    j_faults.disarm()
    t_faults.disarm()
    yield
    j_faults.disarm()
    t_faults.disarm()


def stateful_pair(**kw):
    """A JAX engine and a port engine over the same world, every family
    installed, one packer epoch."""
    jreg = jax_registry()
    jeng = jax_engine(jreg, stateful=True, **kw)
    teng = port_engine(jreg, jeng.packer.epoch_base_ms, stateful=True, **kw)
    return jeng, teng


# -- stores -----------------------------------------------------------------------

SCRIPTED = sorted(n for n in dir(ref_scripts.TestScriptedRuleStore)
                  if n.startswith("test_"))


@pytest.mark.parametrize("name", SCRIPTED)
def test_scripted_rule_store_scenario_on_the_port(name, monkeypatch,
                                                 tmp_path):
    monkeypatch.setattr(ref_scripts, "ScriptedRuleStore",
                        trules_store.ScriptedRuleStore)
    scenario = getattr(ref_scripts.TestScriptedRuleStore(), name)
    scenario(**({"tmp_path": tmp_path} if "tmp_path" in
                scenario.__code__.co_varnames[:2] else {}))


SPEC_STORES = {
    "rule_programs": (jrules_store.RuleProgramStore,
                      trules_store.RuleProgramStore, PROGRAMS),
    "anomaly_models": (jml_store.ModelStore, tml_store.ModelStore, MODELS),
    "actuation_policies": (jact_store.ActuationPolicyStore,
                           tact_store.ActuationPolicyStore, POLICIES),
}


def _store_script(store, specs):
    """One fixed sequence of local and replicated operations; returns
    every answer and every read along the way."""
    a, b = dict(specs[0]), dict(specs[1])
    heard = []
    store.add_listener(lambda *args: heard.append(args))
    out = [store.record("t1", a["token"], a),
           store.record("t2", b["token"], b, notify=False),
           store.would_apply_add("t1", a["token"], b, 5),
           store.apply_add("t1", a["token"], b, 10 ** 13),
           store.apply_add("t1", a["token"], a, 10 ** 13),    # tiebreak
           store.apply_add("t1", a["token"], b, 10 ** 13),    # idempotent
           store.erase("t2", b["token"]),
           store.erase("t2", "nobody"),
           store.apply_remove("t3", "early", 500),
           store.apply_add("t3", "early", a, 400),             # dead
           store.apply_add("t3", "early", a, 600),
           store.apply_remove("t1", a["token"], 1),            # too old
           store.installs_for("t1"), store.installs_for("t2"),
           store.all_installs(), store.get("t1", a["token"]),
           store.get("t9", "x"), store.export_state()]
    store.emit("add", "t2", b["token"], {"stamp": 1})
    return out, heard


@pytest.mark.parametrize("kind", sorted(SPEC_STORES))
def test_spec_store_matches_the_reference(kind, monkeypatch, tmp_path):
    jcls, tcls, specs = SPEC_STORES[kind]
    monkeypatch.setattr(f"{jcls.__module__}.now_ms", lambda: 1_000_000)
    # the port's stores share rules/store.py's clock
    monkeypatch.setattr(trules_store, "now_ms", lambda: 1_000_000)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jout, jheard = _store_script(jcls(str(jdir)), specs)
    tout, theard = _store_script(tcls(str(tdir)), specs)
    assert tout == jout
    assert theard == jheard and len(theard) == 3
    (jfile,) = jdir.iterdir()
    (tfile,) = tdir.iterdir()
    assert tfile.name == jfile.name == f"{kind}.json"
    assert json.loads(tfile.read_text()) == json.loads(jfile.read_text())
    # each package loads the other's file: same reads, same tombstones
    for reader, path in ((tcls, jdir), (jcls, tdir)):
        loaded = reader(str(path))
        assert loaded.export_state() == jout[-1]
        assert not loaded.apply_add("t3", "early", dict(specs[0]), 450)


# -- command fan-out ------------------------------------------------------------------

PLAN = {"seed": 7, "rules": [{"point": "command_delivery_error",
                              "p": 0.4}]}


def test_fanout_drill_matches_the_reference_and_conserves_fires():
    jeng, teng = stateful_pair()
    twin = port_engine(jax_registry(), jeng.packer.epoch_base_ms,
                       stateful=True)
    jfan = jdispatch.CommandFanout(max_retries=1)
    tfan = tdispatch.CommandFanout(max_retries=1)
    jeng.command_dispatcher, teng.command_dispatcher = jfan, tfan
    wanted = []
    for k in range(3):                                  # no faults
        for eng in (jeng, teng):
            step(eng, 900 + k, k)
        wanted += step(twin, 900 + k, k)[1]
    for eng, faults in ((jeng, j_faults), (teng, t_faults)):
        faults.arm(faults.FaultPlan.from_json(PLAN))
        for k in range(3, 6):
            step(eng, 900 + k, k)
        faults.disarm()
    for k in range(3, 6):
        wanted += step(twin, 900 + k, k)[1]
    assert tfan.stats() == jfan.stats()
    assert tfan.sent == jfan.sent and tfan.parked == jfan.parked
    stats = tfan.stats()
    assert stats["parked"] > 0 and stats["retries"] > stats["parked"]
    assert stats["delivered"] + stats["parked"] == len(wanted) > 0
    key = lambda f: json.dumps(f, sort_keys=True)  # noqa: E731
    parked = [{k: v for k, v in f.items() if k != "error"}
              for f in tfan.parked]
    assert sorted(map(key, tfan.sent + parked)) == sorted(map(key, wanted))
    assert tfan.redeliver_parked() == jfan.redeliver_parked() \
        == stats["parked"]
    assert tfan.stats() == jfan.stats()
    assert tfan.stats()["dead_letter_depth"] == 0
    assert sorted(map(key, tfan.sent)) == sorted(map(key, wanted))


def test_replay_barrier_suppresses_fires_like_the_reference():
    """While a restored tenant's replay budget lasts, fires it may own —
    its own policies' and any-tenant policies' — are suppressed; another
    tenant's go out."""
    from sitewhere_tpu.runtime.metrics import MetricsRegistry as JRegistry
    from sitewhere_tpu.runtime.recovery import ReplayBarrier as JBarrier

    jeng, teng = stateful_pair(command_lane_capacity=4 * 128)
    fans = []
    for eng, barrier, fan_mod, registry in (
            (jeng, JBarrier(metrics=JRegistry()), jdispatch, JRegistry),
            (teng, ReplayBarrier(metrics=MetricsRegistry()), tdispatch,
             MetricsRegistry)):
        fan = fan_mod.CommandFanout(barrier=barrier, metrics=registry())
        eng.command_dispatcher = fan
        barrier.arm({"t1": 1})
        for k in range(3):
            step(eng, 910 + k, k)
        fans.append(fan)
    jfan, tfan = fans
    assert tfan.stats() == jfan.stats() and tfan.sent == jfan.sent
    stats = tfan.stats()
    assert stats["suppressed"] > 0 and stats["delivered"] > 0
    assert {f["tenant"] for f in tfan.sent} == {"t2"}
    assert teng.commands_fired == stats["delivered"] + stats["suppressed"]


def test_deliver_via_service_builds_the_invocation():
    from sitewhere_tpu_torch.model.event import (
        CommandInitiator, DeviceCommandInvocation)

    class Device:
        id = "id-7"

    class Assignment:
        token = "as-7"

    class Registry:
        def get_device_by_token(self, token):
            return Device() if token == "dev-7" else None

        def get_active_assignment(self, device_id):
            return Assignment() if device_id == "id-7" else None

    class Service:
        registry = Registry()
        delivered = []

        def deliver(self, invocation):
            self.delivered.append(invocation)

    service = Service()
    fan = tdispatch.CommandFanout(tdispatch.deliver_via_service(service),
                                  max_retries=0, metrics=MetricsRegistry())
    fire = {"policy": "p", "device": "dev-7", "command": "reboot",
            "params": [1, -2], "tenant": "t1"}
    fan.dispatch(None, [fire, dict(fire, device="ghost")])
    (inv,) = service.delivered
    assert isinstance(inv, DeviceCommandInvocation)
    assert (inv.device_id, inv.initiator, inv.initiator_id, inv.target_id,
            inv.command_token, inv.parameter_values) == (
        "id-7", CommandInitiator.SCRIPT, "actuation:p", "as-7", "reboot",
        {"p0": "1", "p1": "-2"})
    assert fan.stats()["parked"] == 1 and "ghost" in fan.parked[0]["error"]


# -- drift refit ------------------------------------------------------------------------

@pytest.mark.parametrize("token", [m["token"] for m in MODELS])
def test_refit_matches_the_reference(token):
    jeng, teng = stateful_pair()
    for k in range(4):
        assert step(teng, 920 + k, k) == step(jeng, 920 + k, k)
    jr = jrefit.DriftRefitter(jeng, min_devices=2)
    tr = trefit.DriftRefitter(teng, min_devices=2)
    jm, tm = jr.feature_matrix(token), tr.feature_matrix(token)
    assert tm.dtype == jm.dtype and tm.shape == jm.shape and tm.shape[0] > 2
    np.testing.assert_array_equal(tm.view(np.int32), jm.view(np.int32))
    assert tr.snapshot_moments(token) == jr.snapshot_moments(token)
    report = tr.refit(token)
    assert report == jr.refit(token) and report["applied"]
    assert teng.get_anomaly_model(token) == jeng.get_anomaly_model(token)
    assert tr.refits == jr.refits == 1
    for k in range(4, 6):
        assert step(teng, 920 + k, k) == step(jeng, 920 + k, k)
    assert_same_engines(jeng, teng, "after refit")


def test_refit_sweep_and_thin_data_match_the_reference():
    jeng, teng = stateful_pair()
    step(jeng, 930, 0)
    step(teng, 930, 0)

    class Job:
        job_configuration = {"models": "hot,drift,nobody"}

    metrics = MetricsRegistry()
    jex = jrefit.DriftRefitJobExecutor(jrefit.DriftRefitter(jeng))
    tex = trefit.DriftRefitJobExecutor(trefit.DriftRefitter(teng),
                                       metrics=metrics)
    assert tex.execute(Job()) == jex.execute(Job())
    assert metrics.counter("actuation.refit_sweeps").value == 1
    thin = trefit.DriftRefitter(teng, min_devices=10 ** 6)
    assert thin.refit("hot") is None and thin.refits == 0
    with pytest.raises(KeyError):
        thin.refit("nobody")
    # the forward pass is the reference's, bit for bit
    feats = np.random.default_rng(5).uniform(0, 100, (64, 2)) \
        .astype(np.float32)
    spec = teng.get_anomaly_model("ae")
    np.testing.assert_array_equal(trefit.forward_scores(spec, feats),
                                  jrefit.forward_scores(spec, feats))


# -- presence ---------------------------------------------------------------------------

def test_presence_manager_sweep_matches_the_reference(monkeypatch):
    jreg = jax_registry()
    jeng = jax_engine(jreg)
    teng = port_engine(jreg, jeng.packer.epoch_base_ms)
    twin = port_engine(jax_registry(), jeng.packer.epoch_base_ms)
    for k in range(2):
        for eng in (jeng, teng, twin):
            step(eng, 940 + k, k)
    monkeypatch.setattr(time, "time", lambda: (
        jeng.packer.epoch_base_ms + 1000 + 2000) / 1000.0)
    jman = jpresence.DevicePresenceManager(jeng)
    tman = tpresence.DevicePresenceManager(teng, metrics=MetricsRegistry())
    heard = []
    tman.add_listener(heard.append)
    got = tman.sweep()
    assert got == jman.sweep() == twin.presence_sweep() and got
    assert heard == [got] and tman.missing_counter.value == len(got)
    assert tman.sweep() == [] and heard == [got]     # send-once
    assert_same_engines(twin, teng, "after sweep")


def test_presence_manager_thread_sweeps_on_its_own(monkeypatch):
    teng = port_engine(jax_registry(), EPOCH)
    step(teng, 950, 0)
    monkeypatch.setattr(time, "time", lambda: (EPOCH + 5000) / 1000.0)
    man = tpresence.DevicePresenceManager(teng, check_interval_s=0.01,
                                          metrics=MetricsRegistry())
    swept = threading.Event()
    man.add_listener(lambda tokens: swept.set())
    man.start()
    try:
        assert swept.wait(timeout=30)
    finally:
        man.stop()
    assert man._thread is None and man.missing_counter.value > 0
