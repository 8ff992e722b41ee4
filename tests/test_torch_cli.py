"""`python -m sitewhere_tpu_torch` as an operator runs it: the reference's
tests/test_cli.py scenarios on the port (serve asked for the CPU with
`--device cpu`), and the port's own refusals.

DIVERGES (the port's behaviour, asserted instead):
  test_version_and_check, test_check_passes_without_native_runtime:
    `check` reports torch, the CUDA device, nvcc, a build of each CUDA
    kernel and of the native host library, and exits non-zero when one is
    missing; the native library has no pure-Python fallback mode.

The networked serve modes (`--feeders --bus-port`, `--feeder`,
`--cluster-peers`, `--supervise`), the sharded pipeline (`--shards N`,
tests/test_torch_sharded_instance.py) and the feeder landing on it
(`--shards N --feeders`) boot on `--device cpu`. The multi-host data plane
(`--cluster-coordinator`, two processes) boots in
tests/test_torch_cluster_cli.py.
"""

import re
import subprocess
import sys

import pytest
import torch

from test_torch_scenarios import load_reference

DIVERGES = {"test_version_and_check",
            "test_check_passes_without_native_runtime"}

REFERENCE_TESTS = load_reference(globals(), "test_cli", replacements=[
    ('''        [sys.executable, "-m", "sitewhere_tpu_torch", "serve",
         "--config"''',
     '''        [sys.executable, "-m", "sitewhere_tpu_torch", "serve",
         "--device", "cpu", "--config"'''),
    ('''"serve", "--port", "0",
         "--no-pipeline", "--bus-port", "0",''',
     '''"serve", "--port", "0",
         "--no-pipeline", "--bus-port", "0", "--device", "cpu",'''),
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


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_until(args, pattern, tmp_path):
    """Boot `serve --device cpu ARGS` in a session of its own, wait for
    `pattern` on its stdout, SIGTERM it and return (match, exit code); on
    a failure the whole session is killed (a supervisor's child too)."""
    import os
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "sitewhere_tpu_torch", "serve", "--port", "0",
         "--device", "cpu", "--data-dir", str(tmp_path / "data"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), start_new_session=True)
    try:
        m = _wait_for(proc, pattern)
        proc.send_signal(signal.SIGTERM)
        return m, proc.wait(timeout=120)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait(timeout=30)


@pytest.mark.parametrize("mode", ["feeders", "feeder", "cluster-peers",
                                  "supervise", "shards-feeders"])
def test_networked_serve_modes_boot_on_the_cpu(mode, tmp_path):
    if mode == "feeder":
        # a worker needs the landing host's edge: the reference's message
        out = _cli("serve", "--feeder", timeout=120)
        assert out.returncode == 2
        assert "serve --feeder requires --feeder-connect host:port" \
            in out.stderr
        return
    if mode in ("feeders", "shards-feeders"):
        shards = ("--shards", "2") if mode == "shards-feeders" else ()
        m, rc = _serve_until(("--feeders", "--bus-port", "0", *shards),
                             r"feeder fleet : topic (\S+)", tmp_path)
        assert m.group(1).endswith("feeder-frames"), m.group(0)
    elif mode == "cluster-peers":
        m, rc = _serve_until(
            ("--cluster-peers", f"0=127.0.0.1:{_free_port()}",
             "--cluster-process-id", "0"),
            r"control-plane host (\d+)/(\d+)", tmp_path)
        assert m.groups() == ("0", "1")
    else:
        m, rc = _serve_until(("--supervise",), r"REST gateway : http",
                             tmp_path)
    assert rc == 0


def test_serve_without_cuda_refuses_to_boot(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    out = _cli("serve", "--port", "0", "--data-dir", str(tmp_path / "d"),
               timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert "serving" not in out.stdout
