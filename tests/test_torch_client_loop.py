"""The JAX package's `tests/light_client/test_client_loop.py` on the port
(`port_copy`, its assertions unchanged, its `_altair_block` bridged to the JAX
package's through SSZ bytes): a `Lightclient` over the port's REST routes
bootstraps, crosses a sync-committee period (68 Altair blocks imported by the
port's chain) and follows the head, and refuses a wrong root and a tampered
bootstrap. A file of its own: its fixture builds the 68 blocks in both
packages (~3 min on one core). Tolerance: none.
"""

from __future__ import annotations

from .test_torch_api import port_copy_bridged
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages

port_copy_bridged("tests.light_client.test_client_loop", globals(), ("_altair_block",))
