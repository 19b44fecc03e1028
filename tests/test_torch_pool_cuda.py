"""The single-launch graph cache served from several threads on a card:
per-class locks, thread-local captures and exact counts.

* A replay of one size class does not wait for the capture of another:
  while one thread captures class 16, another completes replays of class
  8 inside the capture's window.
* A capture while another thread runs the split schedule eagerly: both
  finish with the right verdicts, and the graph books only the launches
  its own thread recorded (the same Fp launches as the class captured
  alone).
* The counts of a threaded run equal the sum of its parts: replays of
  classes 8 and 16 from two threads at once add exactly their graphs'
  launches to `graphs.REPLAYED`.

Tolerance: none (equal bools, equal counts). Every test carries the
`cuda` marker and skips where `torch.cuda.is_available()` is false. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pool_cuda.py -q
"""

import dataclasses
import threading
import time

import pytest
import torch

from lodestar_tpu_torch import graphs
from lodestar_tpu_torch.models import batch_verify as bv


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs capture and replay only on a GPU")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def sets():
    s8 = bv.make_synthetic_sets(4, seed=31)  # class 8
    s16 = bv.make_synthetic_sets(9, seed=32)  # class 16
    swapped = list(s8)
    swapped[0] = dataclasses.replace(s8[0], signature=s8[1].signature)
    swapped[1] = dataclasses.replace(s8[1], signature=s8[0].signature)
    return {8: s8, 16: s16, "swapped": swapped}


@pytest.fixture(scope="module")
def cache(cuda_device):
    """A graph cache of its own, with class 8 captured alone."""
    c = graphs.GraphCache(bv._single_launch_verify)
    info = c.warm(cuda_device, [8], bv._warm_inputs)
    assert list(info) == [8] and c.captures == 1
    return c


def _args(batch):
    si = bv.prepare_single_launch_inputs(batch)
    return (*si.arrays, si.bits, si.mask)


def _run_threads(*targets):
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # re-raised in the test's thread
                errors.append(e)
        return run

    threads = [threading.Thread(target=wrap(fn)) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    if errors:
        raise errors[0]


@pytest.mark.cuda
def test_replay_does_not_wait_for_another_class_capture(cuda_device, cache, sets):
    captured = {}
    replays = []

    def capture():
        captured["start"] = time.perf_counter()
        captured["out"] = tuple(bool(t) for t in cache(cuda_device, *_args(sets[16])))
        captured["end"] = time.perf_counter()

    def replay():
        while "start" not in captured:
            time.sleep(0.01)
        while "end" not in captured and len(replays) < 200:
            out = cache(cuda_device, *_args(sets[8]))
            replays.append((time.perf_counter(), tuple(bool(t) for t in out)))

    _run_threads(capture, replay)
    assert captured["out"] == (True, True)
    inside = [r for t, r in replays if t < captured["end"]]
    assert len(inside) >= 2, f"{len(inside)} class-8 replays finished during the capture"
    assert all(r == (True, True) for _, r in replays)
    assert cache.captures == 2 and cache.graphs[(cuda_device.index, 16)].replays == 1


@pytest.mark.cuda
def test_capture_while_another_thread_runs_the_split_schedule(cuda_device, cache, sets):
    fresh = graphs.GraphCache(bv._single_launch_verify)
    done = threading.Event()
    split = []
    got = {}

    def capture():
        try:
            got["out"] = tuple(bool(t) for t in fresh(cuda_device, *_args(sets[8])))
        finally:
            done.set()

    def eager():
        while not done.is_set() or not split:
            for name, want in ((8, True), ("swapped", False)):
                split.append((bv._verify_sets_split(sets[name], device=cuda_device, prep="on"),
                              want))

    _run_threads(capture, eager)
    assert got["out"] == (True, True)
    assert split and all(v is want for v, want in split)
    g, alone = fresh.graphs[(cuda_device.index, 8)], cache.graphs[(cuda_device.index, 8)]
    assert g.launches == alone.launches and g.rows == alone.rows
    # the graph replays right after the other thread's eager work
    assert tuple(bool(t) for t in fresh(cuda_device, *_args(sets["swapped"]))) == (False, True)


@pytest.mark.cuda
def test_threaded_replay_counts_are_the_sum_of_their_parts(cuda_device, cache, sets):
    for size in (8, 16):  # both classes captured (test order independent)
        cache(cuda_device, *_args(sets[size]))
    runs = 3
    graphs.reset_replayed()

    def replay(size):
        def run():
            for _ in range(runs):
                assert bool(cache(cuda_device, *_args(sets[size]))[0])
        return run

    _run_threads(replay(8), replay(16))
    g8, g16 = (cache.graphs[(cuda_device.index, s)] for s in (8, 16))
    assert graphs.REPLAYED == {k: runs * (g8.launches[k] + g16.launches[k]) for k in g8.launches}
