"""The port's event sources, decoders, dedup and receivers (sources/, transport/): every scenario of the reference's
tests/test_sources.py, run on the port's classes on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_sources")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 20
