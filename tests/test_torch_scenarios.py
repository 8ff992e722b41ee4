"""The reference's own scenario files, run on the port's classes.

`load_reference(namespace, "test_web")` reads tests/test_web.py, renames its
`sitewhere_tpu` imports to `sitewhere_tpu_torch` (the REST client too: the
scenarios drive the port's own `client/rest.py`), and executes it into the
calling test module's namespace, so pytest collects
every reference test and fixture there as a test of the port. The port's
instance runs where it is told to: `SiteWhereInstance` is rebound to a
subclass whose device defaults to the CPU, the way the port's tests ask for
it. Where the port deliberately differs, the calling module lists the
test in its `DIVERGES` and replaces it with one that asserts the port's
behaviour.
"""

import pathlib
import re

import torch

from sitewhere_tpu_torch.instance import SiteWhereInstance as _PortInstance
from sitewhere_tpu_torch.parallel.mesh import make_mesh as _port_make_mesh
from sitewhere_tpu_torch.pipeline.engine import PipelineEngine as _PortEngine

TESTS = pathlib.Path(__file__).resolve().parent


class CPUInstance(_PortInstance):
    """The port's instance, on the CPU unless a device is named."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


def port_source(name: str, replacements=()) -> str:
    """tests/<name>.py with the package renamed; `replacements` are extra
    (old, new) text edits, each of which must apply."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bsitewhere_tpu\b", "sitewhere_tpu_torch", src)
    # an instance built inside a test body runs on the CPU too
    src = src.replace("from sitewhere_tpu_torch.instance import "
                      "SiteWhereInstance",
                      "from test_torch_scenarios import "
                      "CPUInstance as SiteWhereInstance")
    for old, new in replacements:
        assert old in src, f"{name}: {old!r} not in the reference"
        src = src.replace(old, new)
    return src


class CPUPipelineEngine(_PortEngine):
    """The port's single engine, on the CPU unless a device is named."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


def cpu_make_mesh(n_shards=None, device="cpu"):
    """The port's make_mesh, on the CPU unless a device is named."""
    return _port_make_mesh(n_shards, device=device)


def cpu_meshes(monkeypatch):
    """Make `sitewhere_tpu_torch.parallel.make_mesh` default to the CPU for
    one test, so a reference test body that imports it builds its mesh
    where the port's tests run (a module's autouse fixture calls this)."""
    import sitewhere_tpu_torch.parallel as parallel
    import sitewhere_tpu_torch.parallel.mesh as mesh

    monkeypatch.setattr(parallel, "make_mesh", cpu_make_mesh)
    monkeypatch.setattr(mesh, "make_mesh", cpu_make_mesh)


def load_reference(namespace: dict, name: str, replacements=(),
                   diverges=(), only=None) -> list:
    """Execute the renamed reference file into `namespace`; returns the
    names of its tests. Tests named in `diverges` are dropped (the caller
    defines their port versions). With `only` (test function or class
    names), the file's other tests are dropped too: the caller runs just
    that part of the reference file. A module-level `make_mesh` is rebound
    to the CPU one."""
    # tracebacks point at the reference's lines (edits keep line counts)
    code = compile(port_source(name, replacements), str(TESTS / f"{name}.py"),
                   "exec")
    exec(code, namespace)
    if "SiteWhereInstance" in namespace:
        namespace["SiteWhereInstance"] = CPUInstance
    if "make_mesh" in namespace:
        namespace["make_mesh"] = cpu_make_mesh
    if only is not None:
        for key in [k for k in namespace
                    if (k.startswith("test_") or k.startswith("Test"))
                    and k not in only]:
            del namespace[key]
    tests = sorted(
        [k for k in namespace if k.startswith("test_")]
        + [f"{k}.{m}" for k in namespace if k.startswith("Test")
           for m in dir(namespace[k]) if m.startswith("test_")])
    for test in diverges:
        assert test in tests or test in namespace, \
            f"{name}: no test {test!r} to replace"
        if "." in test:  # a method of a test class
            cls, method = test.split(".")
            delattr(namespace[cls], method)
        else:
            del namespace[test]
    return tests


def test_renaming_keeps_the_client_and_the_cpu_default():
    """The renamed scenarios drive the port's REST client, and an instance
    built in a test body runs on the CPU."""
    src = port_source("test_web")
    assert "from sitewhere_tpu_torch.client import" in src
    assert "from test_torch_scenarios import CPUInstance as " \
        "SiteWhereInstance" in src
    assert "from sitewhere_tpu_torch.web import RestServer" in src
    assert "sitewhere_tpu." not in src
    if not torch.cuda.is_available():
        try:
            _PortInstance(instance_id="no-cuda-default")
        except RuntimeError as exc:
            assert "CUDA" in str(exc)
        else:
            raise AssertionError("the port's instance fell back to the CPU")
