"""Eth Beacon API: route definitions + server + client.

Reference `packages/api/src` (route schemas shared by client and server,
`beacon/routes/*`) and `beacon-node/src/api/` (fastify impl,
`rest/base.ts:39`). Namespaces implemented: beacon (genesis, headers,
blocks, state info, pool), validator (duties, block/attestation
production), node (health/version/syncing), debug (state), config
(spec), events (SSE).

The port of `lodestar_tpu.api`, with its imports rewritten.
"""

from .impl import BeaconApiImpl  # noqa: F401
from .server import BeaconRestApiServer  # noqa: F401
from .client import BeaconApiClient  # noqa: F401
