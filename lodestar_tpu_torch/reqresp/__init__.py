"""Req/Resp protocol library (reference `packages/reqresp/src`).

Protocol-agnostic request/response streams with eth2 ssz_snappy framing
(`encodingStrategies/sszSnappy/`): request = varint(ssz-length) +
snappy-framed payload; response = chunks of result-byte + varint +
snappy-framed payload. Transport is any asyncio duplex stream — the
libp2p negotiation layer sits above, exactly as the reference keeps
`ReqResp.ts:47` transport-agnostic.

Includes the token-bucket rate limiter (`rate_limiter/`) and the beacon
protocol table (status/goodbye/ping/metadata/blocksByRange/blocksByRoot,
reference `beacon-node/src/network/reqresp/protocols.ts`).

The port of `lodestar_tpu.reqresp` (host Python, as there).
"""

from .encoding import read_request, read_response_chunks, write_request, write_response_chunk  # noqa: F401
from .protocols import BEACON_PROTOCOLS, Protocol, protocol_by_id  # noqa: F401
from .rate_limiter import RateLimiter, RateLimiterQuota  # noqa: F401
from .reqresp import ReqResp, ReqRespError, ResponseError, RespStatus  # noqa: F401
