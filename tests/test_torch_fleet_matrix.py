"""The fleet harness's scenario matrix through the port (`slow`, as the
JAX package's `tests/testing/test_fleet_matrix.py` is).

Tolerance: none. Every case of that file runs on the port (`port_copy`: the
JAX test module with its imports rewritten to the port, assertions
unchanged, collected here as `test_port_*`), and every scenario of
`SCENARIOS` that runs on virtual time gives the same ledger, fault schedule
and summary in both packages (seed 7).
"""

from __future__ import annotations

import pytest

from .test_torch_fleet import fleets, observe
from .test_torch_utils_gaps import port_copy

pytestmark = pytest.mark.slow

port_copy("tests.testing.test_fleet_matrix", globals())


def _virtual_scenarios():
    jfleet, _ = fleets()
    return sorted(n for n in jfleet.SCENARIOS if jfleet.build_scenario(n).virtual_time)


@pytest.mark.parametrize("name", _virtual_scenarios())
def test_scenario_is_byte_identical_between_the_packages(name):
    jax_run, port_run = (observe(f, name, 7) for f in fleets())
    assert port_run == jax_run
