"""The port's event bus and recovery primitives (sitewhere_tpu_torch/runtime/
bus.py, runtime/recovery.py) held against the JAX package's, on the CPU.

Every scenario of tests/test_bus.py, and the recovery-primitive classes of
tests/test_recovery.py (epoch mint, fences, leases, successor election,
the replay barrier, the dedup-seed hand-off), runs here against the port's
modules: the reference test functions themselves, with the names they
import rebound to the port's classes and functions. Then the two packages
against each other: a bus written by one is read by the other (log files
and committed offsets), and `jittered` has one definition in the port.
Tolerance: none.
"""

import inspect

import pytest

import test_bus as ref_bus
import test_recovery as ref_recovery
from sitewhere_tpu.runtime import bus as jbus
from sitewhere_tpu_torch.runtime import bus as tbus
from sitewhere_tpu_torch.runtime import faults as tfaults
from sitewhere_tpu_torch.runtime import metrics as tmetrics
from sitewhere_tpu_torch.runtime import recovery as trecovery

BUS_SCENARIOS = sorted(name for name in dir(ref_bus)
                       if name.startswith("test_"))
RECOVERY_CLASSES = ("TestEpochMint", "TestEpochFence", "TestLeaseTable",
                    "TestElectSuccessor", "TestReplayBarrier")
RECOVERY_SCENARIOS = sorted(
    (cls, name) for cls in RECOVERY_CLASSES
    for name in dir(getattr(ref_recovery, cls)) if name.startswith("test_"))
RECOVERY_NAMES = ("EpochFence", "LeaseTable", "ReplayBarrier",
                  "StaleEpochError", "elect_successor", "mint_epoch",
                  "stash_dedup_seeds", "stored_epoch", "take_dedup_seed")


def _call(fn, tmp_path):
    """Call a reference test function with the fixtures it names."""
    fixtures = {"tmp_data_dir": str(tmp_path / "swtpu-data"),
                "tmp_path": tmp_path}
    return fn(**{name: fixtures[name]
                 for name in inspect.signature(fn).parameters})


def test_every_reference_scenario_is_covered():
    assert len(BUS_SCENARIOS) == 13 and len(RECOVERY_SCENARIOS) == 18


@pytest.mark.parametrize("name", BUS_SCENARIOS)
def test_bus_scenario_on_the_port(name, monkeypatch, tmp_path):
    for attr in ("ConsumerHost", "EventBus", "TopicNaming"):
        monkeypatch.setattr(ref_bus, attr, getattr(tbus, attr))
    # scenarios that import a helper inside their body find the port's
    monkeypatch.setattr(jbus, "batch_extent", tbus.batch_extent)
    _call(getattr(ref_bus, name), tmp_path)


@pytest.mark.parametrize("cls,name", RECOVERY_SCENARIOS)
def test_recovery_scenario_on_the_port(cls, name, monkeypatch, tmp_path):
    for attr in RECOVERY_NAMES:
        monkeypatch.setattr(ref_recovery, attr, getattr(trecovery, attr))
    monkeypatch.setattr(ref_recovery, "MetricsRegistry",
                        tmetrics.MetricsRegistry)
    _call(getattr(getattr(ref_recovery, cls)(), name), tmp_path)


def test_dedup_seed_hand_off_on_the_port():
    trecovery.stash_dedup_seeds({"tenant-a": {"src-1": ["x", "y"]}})
    assert trecovery.take_dedup_seed("tenant-a", "src-1") == ["x", "y"]
    assert trecovery.take_dedup_seed("tenant-a", "src-1") is None


@pytest.mark.parametrize("writer,reader", [(jbus, tbus), (tbus, jbus)])
def test_bus_logs_and_offsets_cross_packages(writer, reader, tmp_path):
    """A bus one package wrote (partition logs + committed offsets) opens
    in the other: the same records at the same offsets, the committed
    cursor honoured, and appends continue the same logs."""
    data = str(tmp_path / "bus")
    bus = writer.EventBus(partitions=3, data_dir=data)
    bus.publish_batch("events", [(f"k{i}".encode(), bytes([i]) * (i + 1))
                                 for i in range(20)])
    consumer = bus.consumer("events", "g")
    first = consumer.poll(7)
    bus.commit(consumer)
    bus.flush()
    bus.close()

    other = reader.EventBus(partitions=3, data_dir=data)
    again = other.consumer("events", "g")
    assert again.committed == consumer.committed
    again.seek_to_committed()
    rest = again.poll(100)
    seen = {(r.partition, r.offset, r.key, r.value) for r in first + rest}
    assert len(seen) == 20
    assert {(r.key, r.value) for r in first + rest} == {
        (f"k{i}".encode(), bytes([i]) * (i + 1)) for i in range(20)}
    other.publish("events", b"k0", b"late")
    other.flush()
    other.close()
    reopened = writer.EventBus(partitions=3, data_dir=data)
    tail = reopened.consumer("events", "tail")
    tail.seek_to_beginning()
    assert [r.value for r in tail.poll(100)
            if r.key == b"k0"] == [b"\x00", b"late"]
    reopened.close()


def test_partitioning_and_naming_match_the_reference():
    jt, tt = jbus.Topic("t", 8), tbus.Topic("t", 8)
    for i in range(200):
        key = f"device-{i}".encode()
        assert tt.partition_for(key) == jt.partition_for(key)
    jn, tn = jbus.TopicNaming("p", "i"), tbus.TopicNaming("p", "i")
    for name, member in inspect.getmembers(jn, inspect.ismethod):
        if name.startswith("_"):
            continue
        args = ["tenant-x"] * (len(inspect.signature(member).parameters))
        assert getattr(tn, name)(*args) == member(*args), name


def test_jittered_has_one_definition():
    assert tbus.jittered is tfaults.jittered
    for backoff in (0.01, 0.4, 3.0):
        for _ in range(50):
            assert backoff / 2 <= tbus.jittered(backoff) <= backoff
