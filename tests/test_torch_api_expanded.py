"""The JAX package's `tests/api/test_api_expanded.py` on the port
(`port_copy`, its assertions unchanged, its `_chain_of_blocks` bridged to the
JAX package's through SSZ bytes): the beacon state extras, the pool surface,
the node namespace, the light-client and proof routes, the sync-committee
validator routes, debug and config, the launch ledger's and the SLO view's
route contracts. A file of its own: its fixture `env` shares its name with
the other API test modules'. Tolerance: none.
"""

from __future__ import annotations

from .test_torch_api import port_copy_bridged
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages

port_copy_bridged("tests.api.test_api_expanded", globals(), ("_chain_of_blocks",))
