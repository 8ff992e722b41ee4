"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port. Each in a fresh
interpreter."""

import json
import subprocess
import sys

from swbench.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "sitewhere_tpu")


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "HOME": str(ROOT / "swbench" / ".cache")})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _loaded(
        "import json, sys\n"
        "from swbench.tests.conftest import tiny_spec\n"
        "from swbench.run import run_cell\n"
        "r = run_cell(tiny_spec('fleet-100k-stateful.closed'), 5, 0.3, False,"
        " 'cpu')\n"
        "assert r['correct']\n"
        "import swbench.control\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "sitewhere_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    tops = _loaded(
        "import json, sys\n"
        "import swbench.reference.replay, swbench.reference.world\n"
        "import swbench.check, swbench.roofline, swbench.traffic\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not tops & (set(FORBIDDEN) | {"sitewhere_tpu_torch"})
