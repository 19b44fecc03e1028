"""The port's benchmark: `python -m lodestar_tpu_torch bench`.

The PyTorch counterpart of the repo's root ``bench.py`` (which drives the
JAX package and stays its benchmark). `main` prints ONE JSON line,
{"metric", "value", "unit", "vs_baseline"}, with bench.py's keys and
strings.

Headline: BASELINE config 1, random-linear-combination BLS batch
verification of 128-set gossip jobs, MERGE_JOBS of them merged into one
batch (16 x 128 = 2,048 sets), the workload the reference routes to its
blst thread pool (`packages/beacon-node/src/chain/bls/multithread/
worker.ts:30`). vs_baseline = sigs/s over 2,200, the reference's ~45 ms
for ~100 single-core blst verifications (`verifyBlocksSignatures.ts:41-43`):
"how many blst cores one card replaces".

`bench_merkle` keeps bench.py's secondary line (BASELINE config 4): a
2^20-chunk SHA-256 tree root. `main` does not print it, as in bench.py.

Departures from bench.py:

* The device comes from `resolve_device`: CUDA unless the caller names
  another ("cpu"); without CUDA the default raises.
* The road is the one the port's own entry point
  (`verify_signature_sets_device`) takes on that device. On CUDA that is
  the single launch: the host byte stage runs once, before the timed
  window (as bench.py builds its inputs once), and each launch is one
  replay of the class-2,048 CUDA graph on those bytes with its own fresh
  blinding bits. bench.py times ``device_batch_verify``, which in the port
  is the split schedule, kept as the single launch's reference; it is the
  road here where the single launch is not active (the CPU by default):
  the job prepped once, its arrays tiled MERGE_JOBS times.
* The correctness gate raises `RuntimeError` (not ``assert``, which
  ``python -O`` drops), and nothing is printed: a False verdict is never a
  line.
* `bench_merkle` roots through `ssz.device_htr.merkle_root` (one graph
  replay on CUDA, the counterpart of the jitted ``merkle_root_device``)
  on bench.py's words as big-endian bytes, on the process-wide HTR device,
  which it sets for the call and restores; the root must equal hashlib's.
* `vs_baseline` is the printed `value` over 2,200, so the line checks
  itself; bench.py divides the unrounded rate (the two differ by at most
  0.01, and only where the rounding of `value` crosses a boundary).
* No compile cache to enable: the kernels build once into their
  git-ignored directory, and graphs live as long as the process.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from .models import batch_verify as bv
from .ssz import device_htr as dh
from .ssz.hash import hash_nodes_hashlib

__all__ = ["bench_batch_verify", "bench_merkle", "main", "merged_inputs"]

REFERENCE_SIGS_PER_SEC_PER_CORE = 2200.0  # blst envelope, see module docstring
BATCH = 128  # sets per gossip job (the north-star workload unit)
# buffered jobs merged into one RLC batch; bench.py's own override
MERGE_JOBS = int(os.environ.get("LODESTAR_BENCH_MERGE_JOBS", "16"))
ITERS = 3
MERKLE_ITERS = 5  # timed roots after the warm-up
HASHLIB_SAMPLE = 1 << 14  # pair hashes of the host rate


def _make_sets(n: int):
    return bv.make_synthetic_sets(n, seed=17)


def merged_inputs(device=None):
    """The merged batch of MERGE_JOBS copies of one BATCH-set job, staged
    for the road `bench_batch_verify` takes on `device`: a
    `SingleLaunchInputs` of the merged sets' bytes where the single launch
    is active, else bench.py's merge, the job's `build_device_inputs`
    tiled MERGE_JOBS times, as (pk, h, sig, mask) tensors. Blinding bits
    are left to each launch. Raises when the job's prep rejects it."""
    dev = bv.resolve_device(device)
    sets = _make_sets(BATCH)
    if bv.single_launch_active(device=dev):
        si = bv.prepare_single_launch_inputs(sets * MERGE_JOBS)
        if si is None:
            raise RuntimeError("the merged batch has a set that cannot be read")
        return si
    inputs = bv.build_device_inputs(sets, device=dev)
    if inputs is None:
        raise RuntimeError("prep rejected the benchmark's job")
    pk, h, sig, _, mask = inputs

    def tile(t):
        return torch.cat([t] * MERGE_JOBS, dim=0)

    return tuple((tile(a), tile(b)) for a, b in (pk, h, sig)) + (tile(mask),)


def bench_batch_verify(device=None) -> dict:
    """Sustained verification throughput of the merged 2,048-set batch:
    one warm-up launch that must verify True (on CUDA it captures the
    class's graph if this process has none), then ITERS timed launches,
    each with fresh blinding bits drawn before the window, each verdict
    read as that launch's sync point. A False verdict raises."""
    dev = bv.resolve_device(device)
    staged = merged_inputs(dev)
    if isinstance(staged, bv.SingleLaunchInputs):
        merged, size = staged.n, len(staged.mask)

        def job(bits):
            return bv.SingleLaunchInputs(staged.arrays, bits, staged.mask, staged.n)

        def launch(inputs):
            return bv.verify_prepared(inputs, device=dev)

    else:
        pk, h, sig, mask = staged
        merged = size = len(mask)

        def job(bits):
            return torch.as_tensor(bits, device=dev)

        def launch(bits):
            return bv.device_batch_verify(pk, h, sig, bits, mask)

    def fresh_bits():
        return bv._blinding_and_mask(merged, size)[0]

    if not bool(launch(job(fresh_bits()))):
        raise RuntimeError("the warm-up merged batch did not verify")

    jobs = [job(fresh_bits()) for _ in range(ITERS)]
    t0 = time.perf_counter()
    results = [launch(j) for j in jobs]
    oks = [bool(r) for r in results]
    dt = (time.perf_counter() - t0) / ITERS
    if not all(oks):
        raise RuntimeError(f"a timed merged batch did not verify: {oks}")

    value = round(merged / dt, 1)
    return {
        "metric": "bls_batch_verify_sigs_per_sec",
        "value": value,
        "unit": "sigs/s",
        "vs_baseline": round(value / REFERENCE_SIGS_PER_SEC_PER_CORE, 2),
    }


def _hashlib_root(chunks: np.ndarray) -> bytes:
    level = chunks
    while level.shape[0] > 1:
        level = hash_nodes_hashlib(level)
    return level[0].tobytes()


def bench_merkle(depth: int = 20, device=None) -> dict:
    """Secondary: a 2^depth-chunk SHA-256 tree root in one launch (BASELINE
    config 4), bench.py's chunks, against a hashlib sample on one host
    core. The root must equal hashlib's, or it raises."""
    dev = bv.resolve_device(device)
    n = 1 << depth
    words = np.random.default_rng(0).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    data = words.astype(">u4").tobytes()
    chunks = np.frombuffer(data, dtype=np.uint8).reshape(n, 32).copy()
    prev_device = dh._htr_device
    prev_mode = dh.configure_device_htr(mode="on", device=dev)
    try:
        root = dh.merkle_root(chunks)
        t0 = time.perf_counter()
        roots = [dh.merkle_root(chunks) for _ in range(MERKLE_ITERS)]
        dt = (time.perf_counter() - t0) / MERKLE_ITERS
    finally:
        dh.configure_device_htr(mode=prev_mode, device=prev_device)
    device_rate = (n - 1) / dt
    expect = _hashlib_root(chunks)
    if any(r != expect for r in (root, *roots)):
        raise RuntimeError("the device's merkle root differs from hashlib's")

    t0 = time.perf_counter()
    for i in range(HASHLIB_SAMPLE):
        hashlib.sha256(data[i * 64 : (i + 1) * 64]).digest()
    cpu_rate = HASHLIB_SAMPLE / (time.perf_counter() - t0)

    return {
        "metric": "merkle_sha256_pair_hashes_per_sec",
        "value": round(device_rate),
        "unit": "hashes/s",
        "vs_baseline": round(device_rate / cpu_rate, 2),
    }


def main(device=None) -> None:
    print(json.dumps(bench_batch_verify(device)), flush=True)


if __name__ == "__main__":
    main()
