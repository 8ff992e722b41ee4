"""Registry gossip on the port: the reference's
tests/test_gossip_replication.py scenarios run on
`sitewhere_tpu_torch.parallel.cluster.RegistryGossip` between port
instances on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_gossip_replication")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 19


# -- the engine's rules listener (the gossip's fused-rule feed) ---------------

_PROGRAM = {"token": "p-composite", "alert_level": "CRITICAL",
            "alert_type": "prog.composite",
            "when": {"all": [
                {"pred": "value", "measurement": "temp", "op": ">",
                 "value": 90.0},
                {"pred": "value", "measurement": "hum", "op": "<",
                 "value": 20.0}]}}


def _engine():
    from sitewhere_tpu_torch.pipeline.engine import PipelineEngine
    from sitewhere_tpu_torch.registry import RegistryTensors

    return PipelineEngine(RegistryTensors(32, 2, 4), batch_size=8,
                          device="cpu", name="rules-listener")


def test_engine_fires_rule_mutations_in_order():
    """add / remove of threshold and geofence rules reach the listener in
    the order they happened, each after its mutation is visible; a remove
    of an unknown token fires nothing, and rule programs (replicated
    through the instance's durable store) fire nothing."""
    from sitewhere_tpu_torch.pipeline.engine import rule_from_dict

    engine = _engine()
    seen = []

    def listener(op, kind, payload):
        token = payload if op == "remove" else payload.token
        seen.append((op, kind, token, engine.get_rule(token)[0] is not None))

    engine.add_rules_listener(listener)
    engine.create_rule(*rule_from_dict({
        "type": "threshold", "token": "t1", "measurement_name": "temp",
        "operator": ">", "threshold": 1.0}))
    engine.upsert_rule(*rule_from_dict({
        "type": "geofence", "token": "g1", "zone_token": "z",
        "condition": "inside"}))
    engine.create_rule_program(dict(_PROGRAM))
    assert engine.remove_rule("t1")
    assert not engine.remove_rule("absent")
    assert engine.remove_rule_program("p-composite")
    assert not engine.remove_rule_program("p-composite")
    assert seen == [("add", "threshold", "t1", True),
                    ("add", "geofence", "g1", True),
                    ("remove", "", "t1", False)]


def test_gossip_replicates_rules_and_leaves_programs_to_their_store():
    """The gossip's rules feed publishes threshold/geofence adds and
    removes; a rule program's add with a peer attached neither raises (the
    reference raises AttributeError there) nor publishes on that feed —
    programs replicate through the instance's durable store
    (`_rule_program` envelopes)."""
    from sitewhere_tpu_torch.pipeline.engine import rule_from_dict

    def pipeline_host(instance_id):
        instance = SiteWhereInstance(
            instance_id=instance_id, enable_pipeline=True, max_devices=64,
            max_zones=4, max_zone_vertices=4, batch_size=16,
            measurement_slots=4, max_tenants=4)
        instance.start()
        capture = _Capture()
        gossip = RegistryGossip(0, {1: capture}, instance, instance.naming)
        gossip.register_rules_engine(instance.pipeline_engine)
        return instance, gossip, capture

    instance, gossip, capture = pipeline_host("rules-feed")
    engine = instance.pipeline_engine
    engine.upsert_rule(*rule_from_dict({
        "type": "threshold", "token": "t9", "measurement_name": "temp",
        "operator": ">", "threshold": 5.0}))
    engine.upsert_rule_program(dict(_PROGRAM))
    engine.remove_rule("t9")
    sent = [msgpack.unpackb(p, raw=False) for p in capture.drain()]
    assert [(d["kind"], d["op"]) for d in sent] == [("_rule", "add"),
                                                  ("_rule", "remove")]
    assert sent[0]["rule"]["token"] == "t9" and sent[1]["token"] == "t9"
    # a peer applies them
    peer, peer_gossip, _cap = pipeline_host("rules-feed-peer")
    _apply(peer_gossip, [msgpack.packb(sent[0], use_bin_type=True)])
    assert peer.pipeline_engine.get_rule("t9")[0] == "threshold"
    _apply(peer_gossip, [msgpack.packb(sent[1], use_bin_type=True)])
    assert peer.pipeline_engine.get_rule("t9") == (None, None)
    for inst in (instance, peer):
        inst.stop()


def test_the_storm_clock_reaches_only_the_thread_that_set_it(monkeypatch):
    """`TestThreeHostStorm` installs a counting fake clock; a thread that
    another instance left running must read the wall clock and leave the
    count alone, or it moves the storm's ties (ROADMAP C: the port's storm
    failed for seed 7 beside such a thread)."""
    import threading
    import time

    from sitewhere_tpu_torch.model import common

    ticks = {"n": 0}

    def fake_now():
        ticks["n"] += 1
        return 1_700_000_000_000 + ticks["n"] // 5

    monkeypatch.setattr(common, "_now_ms_override", fake_now)
    seen = []
    reader = threading.Thread(target=lambda: seen.append(common.now_ms()))
    reader.start()
    reader.join()
    assert ticks["n"] == 0
    assert abs(seen[0] - time.time() * 1000) < 60_000
    assert common.now_ms() == 1_700_000_000_000 and ticks["n"] == 1
    monkeypatch.undo()
    assert common._now_ms_owner is None
    assert abs(common.now_ms() - time.time() * 1000) < 60_000
