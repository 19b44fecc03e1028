"""Sync: range sync, unknown-block sync, backfill.

Reference `beacon-node/src/sync/` — `BeaconSync` (`sync.ts:18`)
orchestrates `RangeSync` (epoch batches downloaded in parallel, processed
serially — `range/chain.ts:79,104`), `UnknownBlockSync` (parent-root
fetch loop, `unknownBlock.ts:27`) and `BackfillSync` (checkpoint back to
genesis, `backfill/backfill.ts:105`).

The port of `lodestar_tpu.sync` (host Python, as there).
"""

from .range_sync import Batch, BatchStatus, RangeSync, SyncResult  # noqa: F401
from .unknown_block import UnknownBlockSync  # noqa: F401
from .backfill import BackfillSync  # noqa: F401
