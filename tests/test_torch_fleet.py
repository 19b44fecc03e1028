"""The port's fleet chaos harness (`lodestar_tpu_torch.testing.fleet`)
against the JAX package's.

Tolerance: none. `run_fleet(build_scenario("smoke", seed=s))` gives the
same verdict ledger (`ledger_lines`, byte for byte), the same fault
schedule (as sorted JSON), the same summary and no broken invariant in both
packages, as do the nodes' metric snapshots and endpoint states, for
several seeds; the smoke scenario with an audit and with
invalid sets does too. No field of a ledger line or of the schedule names
the package, so nothing is normalised before the comparison. The cases of
the JAX package's `tests/testing/test_fleet.py` and `test_fault_trace.py`,
and `tests/offload/test_chaos_soak.py::test_lying_helper_storm_fast`, run
on the port (`port_copy`: the JAX test module with its imports rewritten
to the port, assertions unchanged, collected here as `test_port_*`). The
scenario matrix and the long soaks stay `slow`, as in the JAX package
(`tests/test_torch_fleet_matrix.py`).
"""

from __future__ import annotations

import importlib
import json

import pytest

from .test_torch_utils_gaps import port_copy

port_copy("tests.testing.test_fleet", globals())
port_copy("tests.testing.test_fault_trace", globals())
port_copy("tests.offload.test_chaos_soak", globals(), names={"test_lying_helper_storm_fast"})


def fleets():
    from lodestar_tpu.testing import fleet as jfleet
    from lodestar_tpu_torch.testing import fleet as tfleet

    return jfleet, tfleet


@pytest.fixture
def occupancy_on_the_fleet_clock(monkeypatch):
    """Each package's offload hosts measure their occupancy on the fleet's
    `SimClock`, as every other clock seam of the fleet does. Their
    `OccupancyTracker` reads `time.monotonic_ns` otherwise, so the last
    probe's `occupancy_permille`, which the endpoint states compare, is a
    busy fraction of real time: it depends on how loaded the host was
    during the run, not on the package."""
    for root, fleet in zip(("lodestar_tpu", "lodestar_tpu_torch"), fleets()):
        clocks = []

        class RecordedClock(fleet.SimClock):
            def __init__(self, *args, clocks=clocks, **kwargs):
                super().__init__(*args, **kwargs)
                clocks.append(self)

        server = importlib.import_module(f"{root}.offload.server")

        def tracker(clocks=clocks, real=server.OccupancyTracker, **kwargs):
            return real(time_fn=clocks[-1].monotonic_ns, **kwargs)

        monkeypatch.setattr(fleet, "SimClock", RecordedClock)
        monkeypatch.setattr(server, "OccupancyTracker", tracker)


def observe(fleet, name, seed, **overrides):
    result = fleet.run_fleet(fleet.build_scenario(name, seed=seed, **overrides))
    return {
        "ledger_lines": result.ledger_lines,
        "fault_schedule": json.dumps(result.fault_schedule, sort_keys=True),
        "summary": json.dumps(result.summary, sort_keys=True, default=str),
        "metrics": json.dumps(result.metrics, sort_keys=True, default=str),
        "endpoint_states": json.dumps(result.endpoint_states, sort_keys=True, default=str),
        "invariants": fleet.check_invariants(result),
    }


@pytest.mark.parametrize("seed", [0, 3, 9, 17, 2024])
@pytest.mark.usefixtures("occupancy_on_the_fleet_clock")
def test_smoke_is_byte_identical_between_the_packages(seed):
    jax_run, port_run = (observe(f, "smoke", seed) for f in fleets())
    assert port_run == jax_run
    assert port_run["ledger_lines"] and port_run["invariants"] == []


AUDIT_DRAIN_S = 300.0  # each node's audit drain: the whole backlog, however loaded the host


@pytest.mark.parametrize("overrides", [{"audit_rate": 0.5}, {"invalid_rate": 0.25},
                                       {"nodes": 3, "hosts": 2}],
                         ids=["audit", "invalid", "3x2"])
@pytest.mark.usefixtures("occupancy_on_the_fleet_clock")
def test_smoke_variants_are_byte_identical_between_the_packages(overrides, monkeypatch):
    """Each node's `drain_audit` (both packages' give up after 10 s and say
    nothing) waits here until its auditor has accounted for every sampled
    verdict, and must say so: a loaded host could otherwise snapshot one
    package's trust and quarantine before its last audit."""
    drained = []
    for fleet in fleets():
        def drain_audit(node):
            if node.auditor is not None:
                drained.append(node.auditor.drain(timeout_s=AUDIT_DRAIN_S))

        monkeypatch.setattr(fleet._SimNode, "drain_audit", drain_audit)
    jax_run, port_run = (observe(f, "smoke", 5, **overrides) for f in fleets())
    assert all(drained), f"{drained.count(False)} audit drains outlasted {AUDIT_DRAIN_S} s"
    assert bool(drained) == ("audit_rate" in overrides)
    assert port_run == jax_run
    assert port_run["invariants"] == []


def test_scenarios_and_config_agree():
    jfleet, tfleet = fleets()
    assert sorted(tfleet.SCENARIOS) == sorted(jfleet.SCENARIOS)
    for name in jfleet.SCENARIOS:
        j, t = jfleet.build_scenario(name, seed=1), tfleet.build_scenario(name, seed=1)
        assert repr(t).replace("lodestar_tpu_torch", "lodestar_tpu") == repr(j)
    rng_sets = [(f.make_set(__import__("random").Random(4), valid=v), f) for f in fleets()
                for v in (True, False)]
    assert [(s.pubkey, s.message, s.signature) for s, _ in rng_sets[:2]] == \
        [(s.pubkey, s.message, s.signature) for s, _ in rng_sets[2:]]
    assert [f.oracle_verify([s]) for s, f in rng_sets] == [True, False, True, False]
