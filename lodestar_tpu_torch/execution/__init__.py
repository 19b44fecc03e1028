"""Execution layer clients (reference `beacon-node/src/execution/`).

`ExecutionEngineHttp` speaks the Engine API over JSON-RPC with JWT auth
(`engine/http.ts:83`); `ExecutionEngineMock` is the in-memory EL that
ships in src/ so dev/sim runs need no external client
(`engine/mock.ts`). Both implement the same 3-method seam the block
pipeline consumes: notify_new_payload / notify_forkchoice_update /
get_payload.

The port of `lodestar_tpu.execution`, with its imports rewritten.
"""

from .engine import (  # noqa: F401
    ExecutePayloadStatus,
    ExecutionEngineHttp,
    ExecutionEngineMock,
    IExecutionEngine,
    PayloadAttributes,
)
from .eth1 import Eth1ForBlockProductionDisabled, Eth1MemoryProvider  # noqa: F401
