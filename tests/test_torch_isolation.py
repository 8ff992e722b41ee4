"""The port stands alone: it imports nothing of JAX, Flax or the JAX
package, and its entry points never fall back to the CPU by themselves.
(msgpack and pyarrow, which the wire codec, the bus markers and the event
log need, are allowed: the card's installation has both.)"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "sitewhere_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
import sitewhere_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    sitewhere_tpu_torch.__path__, "sitewhere_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(set(sys.modules) - before)
print(json.dumps({"modules": names, "loaded": loaded,
                  "preloaded": sorted(before)}))
"""


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert "sitewhere_tpu_torch.pipeline.engine" in info["modules"]
    assert "sitewhere_tpu_torch.ops.geofence_kernel" in info["modules"]
    # the host runtime: imported (and so importable) JAX-free as well
    runtime = {f"sitewhere_tpu_torch.runtime.{m}" for m in (
        "metrics", "faults", "health", "flight", "eventage", "lifecycle",
        "hbmledger", "bus", "recovery")} | {
        f"sitewhere_tpu_torch.pipeline.{m}"
        for m in ("staging", "feed", "graph", "presence")} | {
        f"sitewhere_tpu_torch.{m}" for m in (
            "persist.atomic", "persist.checkpoint", "actuation.dispatcher",
            "actuation.refit", "actuation.store", "ml.store",
            "rules.store")} | {
        # the ingest host tier
        f"sitewhere_tpu_torch.{m}" for m in (
            "native", "transport.wire", "runtime.tracing",
            "runtime.deadletter", "sources.fastlane", "persist.eventlog",
            "persist.worker", "persist.event_management",
            "persist.datastore", "registry.store", "pipeline.inbound",
            "pipeline.enrichment", "model.common", "model.device",
            "model.area", "model.asset", "model.batch", "model.schedule")} | {
        # the read side of the event log
        f"sitewhere_tpu_torch.{m}" for m in (
            "persist.widerow", "ops.segsum", "analytics",
            "analytics.windows",
            "analytics.engine", "analytics.receiver", "serving",
            "serving.planner", "serving.wincache", "serving.executor",
            "streams", "streams.manager", "search", "search.providers",
            "search.external")} | {
        # the instance and its REST gateway
        f"sitewhere_tpu_torch.{m}" for m in (
            "__main__", "instance", "assets", "assets.manager", "batch",
            "batch.manager", "commands", "commands.delivery",
            "commands.destinations", "commands.encoding", "commands.routing",
            "connectors", "connectors.base", "connectors.filters",
            "connectors.host", "connectors.sinks", "labels",
            "labels.manager", "labels.png", "labels.qr", "model.tenant",
            "model.user", "multitenant", "multitenant.engine",
            "multitenant.instance", "multitenant.replication",
            "multitenant.tenants", "registration", "registration.manager",
            "rules.processor", "runtime.config", "runtime.config_model",
            "runtime.logs", "runtime.scripts", "schedule", "schedule.cron",
            "schedule.manager", "security", "security.auth",
            "security.tokens", "security.users", "sources.decoders",
            "sources.dedup", "sources.manager", "sources.receivers",
            "sources.receivers_ext", "transport.coap", "transport.mqtt",
            "transport.protobuf_compat", "transport.servers",
            "transport.stomp", "web", "web.admin", "web.controllers",
            "web.explorer", "web.marshal", "web.openapi", "web.pagejs",
            "web.router", "web.server")} | {
        # the networked tier: the bus edge, the feeder fleet, the
        # control-plane cluster, its supervisor, telemetry, the client
        f"sitewhere_tpu_torch.{m}" for m in (
            "runtime.busnet", "runtime.telemetry", "runtime.supervisor",
            "feeders", "feeders.protocol", "feeders.replica",
            "feeders.service", "feeders.worker", "parallel",
            "parallel.cluster", "client", "client.rest")}
    assert runtime <= set(info["modules"]) <= set(info["loaded"]) | \
        set(info["preloaded"])
    assert not [m for m in info["preloaded"] if _forbidden(m)]
    assert not [m for m in info["loaded"] if _forbidden(m)]


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_names_jax_or_the_jax_package():
    sources = sorted((ROOT / "sitewhere_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 10
    for path in sources:
        bad = [n for n in _imported_names(path) if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    from sitewhere_tpu_torch import convert
    from sitewhere_tpu_torch.pipeline import PipelineEngine
    from sitewhere_tpu_torch.pipeline.state_tensors import init_device_state
    from sitewhere_tpu_torch.registry import RegistryTensors

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    reg = RegistryTensors(16, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineEngine(reg, batch_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_device_state(16, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_numpy({}, "cuda")
    engine = PipelineEngine(reg, batch_size=8, device="cpu")
    assert engine.device.type == "cpu"
