"""The port's device hashTreeRoot collector (`lodestar_tpu_torch.ssz.device_htr`)
against the JAX package's on the CPU: the counterparts of
`tests/ssz/test_device_htr.py`, each root also compared with the JAX
package's root of the same data, and the port's departure from it: a device
error raises, nothing degrades to the host hasher.

Tolerance: none (equal bytes). The port's device levels run eagerly on the
CPU device (`configure_device_htr(mode="on", device="cpu")`, the plain
PyTorch `hash_pairs` the card's graphs replay), with the per-level floor
dropped to 1 pair where a test says so; the JAX side roots on its host
hasher. Inputs are numpy-seeded.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu import ssz as jssz
from lodestar_tpu.ssz import batch as jbatch
from lodestar_tpu.ssz import device_htr as jdh
from lodestar_tpu.ssz import tree as JT
from lodestar_tpu_torch.ops import sha256
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.ssz import tree as T
from lodestar_tpu_torch.ssz.batch import batch_container_roots
from lodestar_tpu_torch.ssz.hash import hash_nodes_cpu
from lodestar_tpu_torch.ssz.merkle import merkleize
from lodestar_tpu_torch.ssz.types import (
    Bytes32,
    Bytes48,
    Container,
    ContainerValue,
    List,
    boolean,
    uint64,
)


@pytest.fixture(scope="module", autouse=True)
def _cpu_setup():
    """One ATen thread; the port's HTR device is the CPU; the JAX package's
    HTR mode is off (its roots come from its host hasher)."""
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_dev = dh._htr_device
    prev = dh.configure_device_htr(device="cpu")
    prev_j = jdh.configure_device_htr(mode="off")
    yield
    jdh.configure_device_htr(mode=prev_j)
    dh.configure_device_htr(mode=prev, device=prev_dev)
    torch.set_num_threads(prev_threads)


@pytest.fixture
def device_on():
    """Device hashing on, and the per-level floor at 1 pair so small test
    trees launch (`test_small_levels_stay_on_host_at_production_floor`
    keeps the production floor)."""
    prev = dh.configure_device_htr(mode="on")
    prev_min = dh.DEVICE_MIN_FLUSH_PAIRS
    dh.DEVICE_MIN_FLUSH_PAIRS = 1
    yield
    dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
    dh.configure_device_htr(mode=prev)


class _Counter:
    def __init__(self):
        self.n = 0.0

    def labels(self, *a):
        return self

    def inc(self, amount=1):
        self.n += amount


class _Obs:
    def __init__(self):
        self.vals = []

    def observe(self, v):
        self.vals.append(v)


class _Labeled:
    def __init__(self, leaf_cls):
        self._leaf_cls = leaf_cls
        self.by_label = {}

    def labels(self, *labels):
        return self.by_label.setdefault(labels, self._leaf_cls())


class FakeHtrMetrics:
    def __init__(self):
        self.flushes = _Labeled(_Counter)
        self.dirty_chunks = _Counter()
        self.launches = _Counter()
        self.seconds = _Labeled(_Obs)


@pytest.fixture
def htr_metrics():
    m = FakeHtrMetrics()
    prev = dh._htr_metrics
    dh.configure_device_htr(metrics=m)
    yield m
    dh._htr_metrics = prev


def _chunks(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 32), dtype=np.uint8)


def _stack(chunks):
    pow2 = 1 << (chunks.shape[0] - 1).bit_length() if chunks.shape[0] > 1 else 1
    levels = [np.zeros((pow2 >> k, 32), dtype=np.uint8) for k in range(pow2.bit_length())]
    levels[0][: chunks.shape[0]] = chunks
    return levels


class TestCollectorNodePath:
    def test_root_matches_cpu_and_merkleize(self, device_on):
        chunks = _chunks(13, 7)
        got = dh.compute_root_node(T.subtree_from_chunks(chunks, 4))
        assert got == T.compute_root(T.subtree_from_chunks(chunks, 4)) == merkleize(chunks, limit=16)
        assert got == JT.compute_root(JT.subtree_from_chunks(chunks, 4))
        assert got == jssz.merkleize(chunks, limit=16)

    def test_from_scratch_merkle_root_agrees(self, device_on):
        chunks = _chunks(16, 8)
        got = dh.compute_root_node(T.subtree_from_chunks(chunks, 4))
        words = torch.from_numpy(sha256.words_from_bytes(chunks.tobytes()).astype(np.int64))
        assert got == sha256.bytes_from_words(sha256.merkle_root_device(words)[None])
        before = dh.launch_count()
        assert dh.merkle_root(chunks) == got == jssz.merkleize(chunks)
        assert dh.launch_count() == before + 1  # a whole tree is one launch

    def test_one_launch_per_level(self, device_on):
        chunks = _chunks(32, 9)
        node = T.subtree_from_chunks(chunks, 5)
        T.compute_root(node)
        for i in (0, 7, 19, 30):
            node = T.set_node(node, (1 << 5) + i, T.leaf(bytes([i]) * 32))
        before = dh.launch_count()
        root = dh.compute_root_node(node)
        assert dh.launch_count() - before == 5
        mutated = chunks.copy()
        for i in (0, 7, 19, 30):
            mutated[i] = np.frombuffer(bytes([i]) * 32, dtype=np.uint8)
        assert root == merkleize(mutated, limit=32) == jssz.merkleize(mutated, limit=32)


class TestCollectorStackPath:
    def test_stack_flush_matches_merkleize(self, device_on):
        chunks = _chunks(16, 10)
        levels = _stack(chunks)
        coll = dh.DirtyCollector()
        coll.add_stack_job(levels, range(16))
        stats = coll.flush()
        assert stats["backend"] == "device"
        assert stats["launches"] == 4
        assert levels[-1][0].tobytes() == merkleize(chunks, limit=16) == jssz.merkleize(chunks, 16)

    def test_two_jobs_share_launches(self, device_on):
        a, b = _chunks(8, 11), _chunks(16, 12)
        la, lb = _stack(a), _stack(b)
        coll = dh.DirtyCollector()
        coll.add_stack_job(la, range(8))
        coll.add_stack_job(lb, range(16))
        stats = coll.flush()
        assert stats["launches"] == 4
        assert la[-1][0].tobytes() == jssz.merkleize(a, limit=8)
        assert lb[-1][0].tobytes() == jssz.merkleize(b, limit=16)

    def test_incremental_dirty_subset(self, device_on):
        chunks = _chunks(32, 13)
        levels = _stack(chunks)
        coll = dh.DirtyCollector()
        coll.add_stack_job(levels, range(32))
        coll.flush()
        chunks2 = chunks.copy()
        chunks2[3] = 1
        chunks2[29] = 2
        levels[0][:32] = chunks2
        coll2 = dh.DirtyCollector()
        coll2.add_stack_job(levels, [3, 29])
        stats = coll2.flush()
        assert stats["launches"] == 5
        assert stats["dirty_chunks"] == 2
        assert levels[-1][0].tobytes() == merkleize(chunks2, limit=32) == jssz.merkleize(chunks2, 32)

    def test_metrics_count_launches_and_flushes(self, device_on, htr_metrics):
        levels = _stack(_chunks(16, 14))
        coll = dh.DirtyCollector()
        coll.add_stack_job(levels, range(16))
        coll.flush()
        assert htr_metrics.launches.n == 4
        assert htr_metrics.flushes.by_label[("device",)].n == 1
        assert htr_metrics.dirty_chunks.n == 16
        assert len(htr_metrics.seconds.by_label[("device",)].vals) == 1


class TestNoFallback:
    """The JAX package recomputes on its host hasher after a device error
    (`TestDegradation` in tests/ssz/test_device_htr.py); the port raises."""

    @staticmethod
    def _boom(data):
        raise RuntimeError("injected device fault")

    def test_flush_raises(self, device_on, htr_metrics, monkeypatch):
        monkeypatch.setattr(dh, "_device_level", self._boom)
        coll = dh.DirtyCollector()
        coll.add_stack_job(_stack(_chunks(16, 15)), range(16))
        with pytest.raises(RuntimeError, match="injected device fault"):
            coll.flush()
        assert not htr_metrics.flushes.by_label  # no flush was booked

    def test_hash_level_raises(self, device_on, monkeypatch):
        monkeypatch.setattr(dh, "_device_level", self._boom)
        with pytest.raises(RuntimeError, match="injected device fault"):
            dh.hash_level(_chunks(64, 16))

    def test_node_root_raises(self, device_on, monkeypatch):
        monkeypatch.setattr(dh, "_device_level", self._boom)
        with pytest.raises(RuntimeError, match="injected device fault"):
            dh.compute_root_node(T.subtree_from_chunks(_chunks(8, 17), 3))

    def test_default_device_without_cuda_raises(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is usable")
        monkeypatch.setattr(dh, "_htr_device", torch.device("cuda"))
        monkeypatch.setattr(dh, "_htr_mode", "auto")
        monkeypatch.setattr(dh, "DEVICE_MIN_FLUSH_PAIRS", None)
        assert dh.device_htr_active()  # "auto" on the default device is the device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dh.hash_level(_chunks(2 * 2048, 18))
        coll = dh.DirtyCollector()
        coll.add_stack_job(_stack(_chunks(8192, 19)), range(8192))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            coll.flush()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dh.merkle_root(_chunks(8, 20))
        # a level under the floor is the host's in every mode
        small = _chunks(16, 21)
        assert np.array_equal(dh.hash_level(small), hash_nodes_cpu(small))

    def test_small_levels_stay_on_host_at_production_floor(self, monkeypatch):
        prev = dh.configure_device_htr(mode="on")
        try:
            monkeypatch.setattr(dh, "DEVICE_MIN_FLUSH_PAIRS", 2048)

            def boom(data):
                raise AssertionError("small level dispatched to device")

            monkeypatch.setattr(dh, "_device_level", boom)
            data = _chunks(8, 15)
            assert np.array_equal(dh.hash_level(data), hash_nodes_cpu(data))
            chunks = _chunks(16, 22)
            levels = _stack(chunks)
            coll = dh.DirtyCollector()
            coll.add_stack_job(levels, range(16))
            stats = coll.flush()
            assert stats["launches"] == 0
            assert levels[-1][0].tobytes() == jssz.merkleize(chunks, limit=16)
        finally:
            dh.configure_device_htr(mode=prev)


def test_modes_and_padding():
    assert dh.HTR_MODES == jdh.HTR_MODES
    assert dh.device_htr_active("auto", device="cuda")
    assert not dh.device_htr_active("auto", device="cpu")
    assert dh.device_htr_active("on", device="cpu")
    assert not dh.device_htr_active("off", device="cuda")
    with pytest.raises(ValueError):
        dh.configure_device_htr(mode="sometimes")
    for n in (0, 1, 7, 8, 9, 1000, 2048, 2049):
        assert dh.pad_pow2_pairs(n) == jdh.pad_pow2_pairs(n)


def test_padded_level_equals_hashlib(device_on):
    data = _chunks(2 * 13, 23)  # 13 pairs -> class 16, pad pairs dropped
    assert np.array_equal(dh._device_level(data), hash_nodes_cpu(data))


class TestViews:
    LT = List(uint64, 2**40)
    JLT = jssz.List(jssz.uint64, 2**40)

    def test_view_roots_match_cpu_path(self, device_on):
        vals = [3 * i for i in range(300)]
        view = T.tree_view(self.LT, vals)
        view.set(17, 9999)
        view.push(41)
        expect = list(vals)
        expect[17] = 9999
        expect.append(41)
        assert view.hash_tree_root() == self.LT.hash_tree_root(expect) == self.JLT.hash_tree_root(expect)

    def test_dirty_gindices_recorded_and_cleared(self, device_on, htr_metrics):
        view = T.tree_view(self.LT, list(range(20)))
        view.hash_tree_root()
        base = htr_metrics.dirty_chunks.n
        view.set(0, 5)
        view.set(8, 6)
        assert view.dirty_count() == 2
        assert len(view.dirty_gindices()) == 2
        root = view.hash_tree_root()
        assert view.dirty_count() == 0
        assert htr_metrics.dirty_chunks.n - base == 2
        assert root == self.JLT.hash_tree_root([5] + list(range(1, 8)) + [6] + list(range(9, 20)))

    def test_container_view_dirty_fields(self, device_on):
        C = Container("Mini", [("a", uint64), ("r", Bytes32)])
        JC = jssz.Container("Mini", [("a", jssz.uint64), ("r", jssz.Bytes32)])
        view = T.tree_view(C, ContainerValue(C, a=1, r=b"\x01" * 32))
        view.set("a", 7)
        assert view.dirty_count() == 1
        assert view.hash_tree_root() == JC.hash_tree_root(jssz.ContainerValue(JC, a=7, r=b"\x01" * 32))
        assert view.dirty_count() == 0


class TestBatchHook:
    C = Container("Rec", [("k", Bytes48), ("w", Bytes32), ("b", uint64), ("s", boolean)])
    JC = jssz.Container("Rec", [("k", jssz.Bytes48), ("w", jssz.Bytes32), ("b", jssz.uint64),
                               ("s", jssz.boolean)])

    def test_batch_roots_identical_device_and_cpu(self, device_on):
        fields = [dict(k=bytes([i % 250]) * 48, w=bytes([i % 7]) * 32, b=i, s=bool(i % 2))
                  for i in range(33)]
        vals = [ContainerValue(self.C, **f) for f in fields]
        dev = batch_container_roots(self.C, vals)
        prev = dh.configure_device_htr(mode="off")
        try:
            cpu = batch_container_roots(self.C, vals)
        finally:
            dh.configure_device_htr(mode=prev)
        want = jbatch.batch_container_roots(self.JC, [jssz.ContainerValue(self.JC, **f) for f in fields])
        assert np.array_equal(dev, cpu)
        assert np.array_equal(dev, want)


def test_mutation_sequence_fuzz(device_on):
    """Random set/push storms on a basic-list view: device-flushed root ==
    host-incremental root == the JAX package's value-path root."""
    LT = List(uint64, 2**32)
    JLT = jssz.List(jssz.uint64, 2**32)
    rng = np.random.default_rng(42)
    vals = [int(x) for x in rng.integers(0, 2**63, size=50)]
    view_dev = T.tree_view(LT, vals)
    view_cpu = T.tree_view(LT, vals)
    model = list(vals)
    for round_ in range(6):
        for _ in range(int(rng.integers(1, 8))):
            v = int(rng.integers(0, 2**63))
            if model and rng.random() < 0.7:
                i = int(rng.integers(0, len(model)))
                view_dev.set(i, v)
                view_cpu.set(i, v)
                model[i] = v
            else:
                view_dev.push(v)
                view_cpu.push(v)
                model.append(v)
        r_dev = view_dev.hash_tree_root()
        prev = dh.configure_device_htr(mode="off")
        try:
            r_cpu = view_cpu.hash_tree_root()
        finally:
            dh.configure_device_htr(mode=prev)
        assert r_dev == r_cpu == JLT.hash_tree_root(model), round_
