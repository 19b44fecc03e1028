"""Real inter-process P2P transport (reference `network/nodejs/bundle.ts`).

The libp2p stack the reference assembles from js-libp2p modules —
TCP transport, noise-XX security (`network/nodejs/noise.ts`), mplex
stream muxing, multistream-select negotiation — rebuilt natively on
asyncio + the `cryptography` primitives:

* `identity`  — ed25519 identity keys and libp2p peer ids
* `noise`     — Noise_XX_25519_ChaChaPoly_SHA256 with the libp2p
                identity-binding payload
* `multistream` — multistream-select/1.0.0 protocol negotiation
* `mplex`     — /mplex/6.7.0 stream multiplexer
* `host`      — the composed swarm: listen, dial, upgrade, per-protocol
                stream handlers

Two `lodestar-tpu beacon` processes peer over TCP sockets with this
stack; the in-process `GossipBus` remains for single-process simulation
tests only.

The port of `lodestar_tpu.network.transport` (host Python, as there).
"""

from .host import Libp2pHost, Stream  # noqa: F401
from .identity import Identity, peer_id_from_pubkey  # noqa: F401
