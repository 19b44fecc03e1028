"""Network layer: gossip topics/encoding, message ids, in-process bus,
peer scoring (reference `beacon-node/src/network/`).

The libp2p transport itself stays out of scope for now; everything that
defines eth2 gossip SEMANTICS is here and wire-faithful:

* topic naming `/eth2/<fork_digest>/<name>/ssz_snappy`
  (`gossip/topic.ts`)
* message payloads snappy-BLOCK-compressed; message id =
  SHA256(MESSAGE_DOMAIN_VALID_SNAPPY ++ uncompressed)[:20] on valid
  decompression, INVALID domain over the raw bytes otherwise
  (`gossip/encoding.ts:12-36` — xxhash only dedups internally there; the
  spec id is this SHA256 form)
* `GossipBus` — in-process pubsub wiring multiple nodes for dev/sim
  (the multi-node-without-a-cluster strategy, `test/utils/node/`)
* `PeerScore` / `PeerManager` — reference `peers/score.ts` decay model.

The port of `lodestar_tpu.network` (host Python, as there): `gossip`,
`peers`, `reqresp_node` (the beacon req/resp handlers), `processor` (the
gossip work queues in front of the chain), the libp2p `transport` (noise
XX, mplex and multistream on `cryptography`), `gossipsub`, `discv5`,
`discovery`, `subnets` and `service` (`Libp2pBeaconNetwork`, which composes
them).
"""

from .gossip import (  # noqa: F401
    GossipBus,
    GossipTopic,
    compute_message_id,
    topic_string,
)
from .peers import PeerManager, PeerScore  # noqa: F401
