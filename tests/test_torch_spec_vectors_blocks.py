"""The block half of the committed spec vectors (operations, sanity,
finality) through the port's `spec_test` runner and state transition; the
runners, the skip and the exhaustiveness check are in
`test_torch_spec_vectors.py`, whose `RUNNERS` this file uses. Split so
that xdist's `loadfile` runs the two halves on two workers.
"""

from __future__ import annotations

import pytest

from .test_torch_spec_vectors import (  # noqa: F401 - minimal_cpu is autouse
    BLOCK_RUNNERS,
    CASES,
    minimal_cpu,
    run_case,
)

BLOCKS = [c for c in CASES if c.runner in BLOCK_RUNNERS]


@pytest.mark.parametrize("case", BLOCKS, ids=[c.test_id for c in BLOCKS])
def test_spec_case(case):
    run_case(case)
