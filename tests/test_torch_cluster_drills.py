"""The reference's instance-level multi-host drills on the port, marked
slow: tests/test_cluster.py's two-process registry gossip, gang restart
and recovery, end-to-end forwarding and scripted-rule replication drills,
and tests/test_supervised_cluster.py's kill-one-of-three supervised
drill, each run as written with its own deadlines, on the CPU.

The child scripts are the reference's with the JAX bootstrap swapped for
the port's: `initialize(coord, num_processes=N, process_id=pid)` joins a
gloo world in place of `jax.distributed.initialize`, and the global mesh
is `make_global_mesh(n_shards=2 * N, device="cpu")`, two shards a process
as the reference's two virtual devices a process; instances and `serve`
run with `device="cpu"` / `--device cpu --shards 2N`.

They are marked slow (tier-1 runs `-m 'not slow'`): each takes two
minutes or more, and they are held to the reference's behaviour, not to a
pass. The reference's own copies fail on the record (ROADMAP C, "A tenant
boot race fails the reference's multi-host drills"): at boot a peer's
tenant gossip restarts the tenant engine the drill holds, so registry
gossip for `default` is refused as an unknown tenant, dependent applies
back off, and what applies lands in the new engine's registry. The port
copies that control plane, so its copies race the same way.
"""

import re

import pytest

from test_torch_scenarios import TESTS, port_source

_BOOT = [
    # the port's bootstrap in place of jax.distributed's (line counts kept)
    (r'^os\.environ\["XLA_FLAGS"\] = .*$', 'pass'),
    (r'^import jax$', 'pass'),
    (r'^jax\.config\.update\("jax_platforms", "cpu"\)$', 'pass'),
    (r'jax\.distributed\.initialize\(coordinator_address=coord, '
     r'num_processes=2,\n\s*process_id=pid\)',
     '__import__("sitewhere_tpu_torch.parallel.distributed", fromlist=["_"]'
     ').initialize(\n    coord, num_processes=2, process_id=pid)'),
    (r'^mesh = make_global_mesh\(\)$',
     'mesh = make_global_mesh(n_shards=4, device="cpu")'),
    (r'^instance = SiteWhereInstance\($',
     'instance = SiteWhereInstance(device="cpu",'),
    (r'"-m", "sitewhere_tpu_torch", "serve",$',
     '"-m", "sitewhere_tpu_torch", "serve", "--device", "cpu",'),
    # the parents' own engines run on the CPU too
    (r'engine = PipelineEngine\(tensors, batch_size=16,',
     'engine = PipelineEngine(tensors, device="cpu", batch_size=16,'),
    # the renamed children import the CPU instance from tests/
    (r'env\["PYTHONPATH"\] = REPO$',
     'env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, '
     '"tests")])'),
]


def _load(name, tests, extra=()):
    src = port_source(name)
    for pattern, repl in list(_BOOT) + list(extra):
        src, n = re.subn(pattern, repl, src, flags=re.M)
        assert n or pattern.startswith(r'"-m"') or name != "test_cluster", \
            (name, pattern)
    ns = {"__name__": f"port_{name}", "__file__": str(TESTS / f"{name}.py")}
    exec(compile(src, str(TESTS / f"{name}.py"), "exec"), ns)
    for test in tests:
        globals()[test] = pytest.mark.slow(ns[test])
    return src


CLUSTER_DRILLS = ("test_two_process_registry_gossip",
                  "test_two_process_gang_restart_recovery",
                  "test_two_process_cluster_end_to_end",
                  "test_two_process_scripted_rule_replication_and_gang_"
                  "restart")
_CLUSTER_SRC = _load("test_cluster", CLUSTER_DRILLS)
_SUPERVISED_SRC = _load(
    "test_supervised_cluster",
    ("test_kill_one_of_three_supervised_hosts_recovers",),
    extra=[(r'"--supervise", "--supervise-backoff", "1",',
            '"--shards", "6", "--supervise", "--supervise-backoff", "1",')])


def test_the_drills_boot_the_port_not_jax():
    """Every child and serve command of the copies runs the port's
    bootstrap: no jax import in a child, no jax.distributed, the CPU asked
    for (the units' `_engine` helper, which the drills do not call, keeps
    its jax import)."""
    for src in (_CLUSTER_SRC, _SUPERVISED_SRC):
        assert "jax.distributed.initialize" not in src
        assert not re.search(r"^import jax", src, flags=re.M)
        assert "sitewhere_tpu." not in src.replace(
            "sitewhere_tpu_torch.", "")
    assert _CLUSTER_SRC.count("make_global_mesh(n_shards=4, "
                              "device=\"cpu\")") == 4
    assert _CLUSTER_SRC.count('PipelineEngine(tensors, device="cpu"') == 1
    assert _SUPERVISED_SRC.count('"--device", "cpu",') == 1
    assert _SUPERVISED_SRC.count('"--shards", "6", "--supervise"') == 1
