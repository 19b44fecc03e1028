"""Persistence layer (reference `packages/db/src`): Bucket schema,
pluggable KV controllers, typed SSZ repositories.

The port of `lodestar_tpu.db` (host Python and numpy, as there).
"""

from .controller import (  # noqa: F401
    DbController,
    FileDbController,
    FilterOptions,
    MemoryDbController,
)
from .repository import Repository  # noqa: F401
from .schema import BUCKET_LENGTH, Bucket, decode_key_id, encode_key  # noqa: F401
