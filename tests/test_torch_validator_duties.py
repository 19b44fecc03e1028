"""The JAX package's validator duty loops on the port (`port_copy`, their
assertions unchanged): `tests/validator/test_rest_validator.py` (the full
duty loop and the sync-committee duties over a real HTTP Beacon API, the
server on the host oracle), `tests/validator/test_sync_duties.py` (messages
and contributions into the next block's sync aggregate, that block through
the signature-verifying transition) and the chain test of
`tests/metrics/test_validator_monitor.py` (the in-process `Validator`'s keys
registered with the chain's validator monitor, three epochs of duties, the
epoch summaries scraped). Tolerance: none.
"""

from __future__ import annotations

from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_utils_gaps import port_copy

for _mod in ("test_rest_validator", "test_sync_duties"):
    port_copy(f"tests.validator.{_mod}", globals())
port_copy("tests.metrics.test_validator_monitor", globals(),
          names={"test_monitor_tracks_proposals_attestations_and_epoch_summary"})
