"""`device_batch_verify_many` of the port: J independent RLC jobs in one
call, over a leading job axis (the JAX package's `jax.vmap` of its verify
program), on the CPU.

Tolerance: none. J = 2 jobs of 8 sets with explicit blinding bits, the
second job tampered (two swapped signatures): the verdicts are
[True, False], equal to the port's `device_batch_verify` of each job on
the same inputs and, in the `slow` test, to the JAX package's
`device_batch_verify_many`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lodestar_tpu.models import batch_verify as jbv
from lodestar_tpu_torch.models import batch_verify as bv

N = 8


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jobs():
    """Two jobs' numpy inputs (the oracle's prep, bits from a fixed seed):
    ((pk_x, pk_y), (h_x, h_y), (sig_x, sig_y), bits, mask), each array with
    a leading job axis of 2."""
    sets = bv.make_synthetic_sets(N, seed=5)
    tampered = list(sets)
    tampered[3] = dataclasses.replace(sets[3], signature=sets[6].signature)
    tampered[6] = dataclasses.replace(sets[6], signature=sets[3].signature)
    r = np.random.default_rng(9)
    per_job = []
    for batch in (sets, tampered):
        bits = r.integers(0, 2, size=(N, bv.COEFF_BITS), dtype=np.int32)
        bits[:, 0] = 1
        bits[0] = 0
        bits[0, -1] = 1
        inputs = bv.build_device_inputs(batch, size=N, device="cpu", coeff_bits=bits, prep="off")
        per_job.append(tuple(
            tuple(c.numpy() for c in x) if isinstance(x, tuple) else x.numpy() for x in inputs
        ))
    return tuple(
        tuple(np.stack([j[k][c] for j in per_job]) for c in range(2)) if k < 3
        else np.stack([j[k] for j in per_job])
        for k in range(5)
    )


def _torch(x):
    return tuple(torch.from_numpy(c) for c in x) if isinstance(x, tuple) else torch.from_numpy(x)


def test_many_matches_per_job_verify(jobs):
    got = bv.device_batch_verify_many(*(_torch(x) for x in jobs))
    assert got.shape == (2,) and got.dtype == torch.bool
    per_job = [
        bool(bv.device_batch_verify(*(_torch(tuple(c[j] for c in x) if isinstance(x, tuple)
                                              else x[j]) for x in jobs)))
        for j in range(2)
    ]
    assert got.tolist() == per_job == [True, False]


def test_many_takes_a_job_axis(jobs):
    single = tuple(_torch(tuple(c[0] for c in x) if isinstance(x, tuple) else x[0]) for x in jobs)
    with pytest.raises(ValueError):
        bv.device_batch_verify_many(*single)
    with pytest.raises(ValueError):
        bv.device_batch_verify(*(_torch(x) for x in jobs))


@pytest.mark.slow
def test_many_matches_jax(jobs):
    got = bv.device_batch_verify_many(*(_torch(x) for x in jobs))
    want = np.asarray(jbv.device_batch_verify_many(*jobs))
    assert got.tolist() == want.tolist() == [True, False]
