"""`python -m sitewhere_tpu_torch` as an operator runs it: the reference's
tests/test_cli.py scenarios on the port (serve asked for the CPU with
`--device cpu`), and the port's own refusals.

DIVERGES (the port's behaviour, asserted instead):
  test_version_and_check, test_check_passes_without_native_runtime:
    `check` reports torch, the CUDA device, nvcc, a build of each CUDA
    kernel and of the native host library, and exits non-zero when one is
    missing; the native library has no pure-Python fallback mode.
  test_serve_bus_edge: the networked bus edge is ROADMAP A5; serve refuses
    `--bus-port` naming it.
"""

import re
import subprocess
import sys

import pytest
import torch

from test_torch_scenarios import load_reference

DIVERGES = {"test_version_and_check",
            "test_check_passes_without_native_runtime",
            "test_serve_bus_edge"}

REFERENCE_TESTS = load_reference(globals(), "test_cli", replacements=[
    ('''        [sys.executable, "-m", "sitewhere_tpu_torch", "serve",
         "--config"''',
     '''        [sys.executable, "-m", "sitewhere_tpu_torch", "serve",
         "--device", "cpu", "--config"'''),
], diverges=DIVERGES)


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 5


def _cli(*args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "sitewhere_tpu_torch",
                           *args], capture_output=True, text=True,
                          env=env or _env(), timeout=timeout)


def test_version_and_check():
    out = _cli("version", timeout=120)
    assert out.returncode == 0
    assert re.match(r"^\d+\.\d+\.\d+$", out.stdout.strip())
    chk = _cli("check")
    assert "torch" in chk.stdout and "native host runtime" in chk.stdout
    if not torch.cuda.is_available():
        assert chk.returncode != 0
        assert "cuda device: MISSING" in chk.stdout
    else:
        assert chk.returncode == 0, chk.stdout + chk.stderr
        assert torch.cuda.get_device_name(0) in chk.stdout


def test_check_passes_without_native_runtime():
    """The reference's switch for its pure-Python fallback means nothing to
    the port: the native library still builds and loads (the check then
    fails here only for want of CUDA)."""
    env = _env()
    env["SITEWHERE_TPU_NO_NATIVE"] = "1"
    chk = _cli("check", env=env)
    assert "native host runtime: ok" in chk.stdout, chk.stdout + chk.stderr
    assert (chk.returncode != 0) == (not torch.cuda.is_available())


def test_serve_bus_edge(tmp_path):
    out = _cli("serve", "--port", "0", "--no-pipeline", "--device", "cpu",
               "--bus-port", "0", "--data-dir", str(tmp_path / "data"),
               timeout=120)
    assert out.returncode != 0
    assert "ROADMAP A5" in out.stderr
    assert not (tmp_path / "data").exists()


@pytest.mark.parametrize("args,item", [
    (("--feeder",), "A5"),
    (("--feeders",), "A5"),
    (("--cluster-peers", "0=127.0.0.1:9092", "--cluster-process-id", "0"),
     "A4b"),
    (("--cluster-coordinator", "127.0.0.1:1234"), "A6"),
    (("--shards", "2"), "A6"),
    (("--supervise",), "A4b"),
])
def test_left_out_serve_modes_exit_naming_their_roadmap_item(args, item):
    out = _cli("serve", "--port", "0", "--device", "cpu", *args,
               timeout=120)
    assert out.returncode != 0
    assert f"ROADMAP {item}" in out.stderr


def test_serve_without_cuda_refuses_to_boot(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    out = _cli("serve", "--port", "0", "--data-dir", str(tmp_path / "d"),
               timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert "serving" not in out.stdout
