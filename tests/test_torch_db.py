"""The port's db (`lodestar_tpu_torch.db`: schema, controllers, repository)
against the JAX package's.

Tolerance: none. Each scenario of the JAX package's `tests/db/test_db.py`
runs through both packages, with the JAX test's own assertions, and the two
runs' observations must be equal: keys, values and repository contents as
bytes, and a `FileDbController`'s write-ahead log as its file bytes after
every step. Then the files cross over: a directory written by either
package is read back by the other (puts, deletes, batch puts, a compacted
log, and a torn last record that the reader drops and truncates).
"""

from __future__ import annotations

import functools
import importlib
import os

import pytest

ROOTS = ("lodestar_tpu", "lodestar_tpu_torch")


class Pkg:
    def __init__(self, root: str):
        self.root = root
        self.db = importlib.import_module(f"{root}.db")
        self.types = importlib.import_module(f"{root}.types")
        self.t = self.types.ssz_types()


@functools.lru_cache(maxsize=None)
def pkg(root: str) -> Pkg:
    return Pkg(root)


def both(scenario, tmp_path=None):
    """Run `scenario(pkg, obs[, dir])` through the JAX package, then the port;
    their observations must be equal."""
    runs = []
    for root in ROOTS:
        obs = []
        args = () if tmp_path is None else (str(tmp_path / root),)
        scenario(pkg(root), obs, *args)
        runs.append(obs)
    assert runs[1] == runs[0]
    return runs[1]


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def contents(db) -> list:
    return list(db.entries_stream())


# -- the JAX package's scenarios ----------------------------------------------


def sc_encode_key_orders_ints_numerically(P, obs):
    d = P.db
    ks = [d.encode_key(d.Bucket.allForks_blockArchive, s) for s in (0, 1, 255, 256, 2**32)]
    assert ks == sorted(ks)
    obs += [ks, d.encode_key(d.Bucket.index_chainInfo, "head"), d.BUCKET_LENGTH,
            d.decode_key_id(ks[-1]), sorted((b.name, int(b)) for b in d.Bucket)]


def sc_encode_key_bucket_prefix_separates_namespaces(P, obs):
    d = P.db
    a = d.encode_key(d.Bucket.allForks_block, b"\xff" * 32)
    b = d.encode_key(d.Bucket.allForks_blockArchive, 0)
    assert a[0] != b[0]
    obs += [a, b]


def _fill(P, db):
    for i in (3, 1, 2, 5, 4):
        db.put(P.db.encode_key(P.db.Bucket.index_mainChain, i), bytes([i]))


def sc_memory_controller_range_filters(P, obs):
    d = P.db
    db = d.MemoryDbController()
    _fill(P, db)
    k = lambda i: d.encode_key(d.Bucket.index_mainChain, i)  # noqa: E731
    F = d.FilterOptions
    obs.append(list(db.keys_stream(F(gte=k(2), lt=k(5)))))
    assert obs[-1] == [k(2), k(3), k(4)]
    obs.append(list(db.keys_stream(F(gt=k(2), lte=k(5)))))
    assert obs[-1] == [k(3), k(4), k(5)]
    obs.append(list(db.keys_stream(F(reverse=True, limit=2))))
    assert obs[-1] == [k(5), k(4)]
    db.delete(k(3))
    db.delete(k(9))  # absent: no-op
    obs.append([v for _, v in db.entries_stream(F(gte=k(1), lt=k(5)))])
    assert obs[-1] == [bytes([1]), bytes([2]), bytes([4])]
    db.batch_put([(k(7), b"seven"), (k(0), b"zero")])
    db.batch_delete([k(1), k(2)])
    obs += [contents(db), db.get(k(7)), db.get(k(1))]


def sc_file_controller_persists_and_replays(P, obs, base):
    d = P.db
    path = os.path.join(base, "db", "wal.log")
    db = d.FileDbController(path)
    _fill(P, db)
    db.delete(d.encode_key(d.Bucket.index_mainChain, 2))
    db.put(d.encode_key(d.Bucket.index_mainChain, 1), b"\x99")
    db.close()
    obs.append(file_bytes(path))

    db2 = d.FileDbController(path)
    k = lambda i: d.encode_key(d.Bucket.index_mainChain, i)  # noqa: E731
    assert db2.get(k(1)) == b"\x99"
    assert db2.get(k(2)) is None
    assert sorted(db2.keys_stream()) == [k(1), k(3), k(4), k(5)]
    obs.append(contents(db2))
    db2.close()


def sc_file_controller_discards_torn_tail(P, obs, base):
    d = P.db
    path = os.path.join(base, "wal.log")
    db = d.FileDbController(path)
    db.put(b"\x01good", b"value")
    db.close()
    with open(path, "ab") as f:
        f.write(b"\x00\xff\xff")  # torn partial record
    db2 = d.FileDbController(path)
    assert db2.get(b"\x01good") == b"value"
    assert len(list(db2.keys_stream())) == 1
    obs += [contents(db2), file_bytes(path)]  # the tail truncated on replay
    db2.close()


def sc_file_controller_compaction(P, obs, base):
    d = P.db
    path = os.path.join(base, "wal.log")
    db = d.FileDbController(path, compact_bytes=2_000)
    sizes = []
    for round_ in range(40):
        for i in range(10):
            db.put(d.encode_key(d.Bucket.index_mainChain, i), bytes([round_]) * 30)
        sizes.append(os.path.getsize(path))
    # 400 writes of ~43+ bytes would be >17k uncompacted
    assert sizes[-1] < 4_000
    db.close()
    obs += [sizes, file_bytes(path)]
    db2 = d.FileDbController(path)
    assert db2.get(d.encode_key(d.Bucket.index_mainChain, 9)) == bytes([39]) * 30
    obs.append(contents(db2))
    db2.close()


def sc_file_controller_batch_put_and_delete(P, obs, base):
    d = P.db
    path = os.path.join(base, "wal.log")
    db = d.FileDbController(path, compact_bytes=600)
    k = lambda i: d.encode_key(d.Bucket.phase0_exit, i)  # noqa: E731
    for r in range(6):
        db.batch_put([(k(i), bytes([r, i]) * (i + 1)) for i in range(8)])
        db.batch_delete([k(r), k(7 - r)])
        obs += [os.path.getsize(path), file_bytes(path)]
    db.close()
    db2 = d.FileDbController(path)
    obs.append(contents(db2))
    db2.close()


def sc_repository_roundtrip_and_root_id(P, obs):
    d, t = P.db, P.t
    repo = d.Repository(d.MemoryDbController(), d.Bucket.allForks_block, t.phase0.SignedBeaconBlock)
    block = t.phase0.SignedBeaconBlock.default()
    block.message.slot = 7
    repo.add(block)
    root = t.phase0.SignedBeaconBlock.hash_tree_root(block)
    assert repo.has(root)
    got = repo.get(root)
    assert got is not None and got.message.slot == 7
    assert t.phase0.SignedBeaconBlock.hash_tree_root(got) == root
    obs += [root, repo.get_binary(root), contents(repo.db)]
    repo.remove(block)
    assert not repo.has(root)
    obs.append(contents(repo.db))


def sc_repository_slot_indexed_iteration(P, obs):
    d, t = P.db, P.t
    repo = d.Repository(d.MemoryDbController(), d.Bucket.allForks_blockArchive,
                        t.phase0.SignedBeaconBlock)
    for slot in (30, 10, 20):
        b = t.phase0.SignedBeaconBlock.default()
        b.message.slot = slot
        repo.put(slot, b)
    assert [b.message.slot for b in repo.values()] == [10, 20, 30]
    assert [b.message.slot for b in repo.values(gte=15, lt=30)] == [20]
    assert repo.last_value().message.slot == 30
    assert repo.first_value().message.slot == 10
    ser = t.phase0.SignedBeaconBlock.serialize
    obs += [repo.keys(), repo.keys(reverse=True, limit=2),
            [(k, ser(v)) for k, v in repo.entries(gte=11)], contents(repo.db)]


def sc_repository_batch_ops_and_bucket_isolation(P, obs):
    d, t = P.db, P.t
    db = d.MemoryDbController()
    blocks = d.Repository(db, d.Bucket.allForks_block, t.phase0.SignedBeaconBlock)
    exits = d.Repository(db, d.Bucket.phase0_exit, t.SignedVoluntaryExit)
    vals = []
    for i in range(3):
        b = t.phase0.SignedBeaconBlock.default()
        b.message.proposer_index = i
        vals.append(b)
    blocks.batch_add(vals)
    exits.put(5, t.SignedVoluntaryExit.default())
    assert len(blocks.values()) == 3
    assert len(exits.values()) == 1  # no cross-bucket bleed
    obs.append(contents(db))
    blocks.batch_delete([blocks.get_id(v) for v in vals])
    assert blocks.values() == []
    obs.append(contents(db))


SCENARIOS = {name[3:]: fn for name, fn in globals().items() if name.startswith("sc_")}
FILE_SCENARIOS = {"file_controller_persists_and_replays", "file_controller_discards_torn_tail",
                  "file_controller_compaction", "file_controller_batch_put_and_delete"}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_db_scenario_agrees(case, tmp_path):
    both(SCENARIOS[case], tmp_path if case in FILE_SCENARIOS else None)


# -- the files cross over -----------------------------------------------------


def _write_log(P, path, compact_bytes):
    """A log with puts, overwrites, deletes, a batch put and (at a small
    compact_bytes) a compaction; returns what it holds."""
    d = P.db
    db = d.FileDbController(path, compact_bytes=compact_bytes)
    t = P.t
    blocks = d.Repository(db, d.Bucket.allForks_block, t.phase0.SignedBeaconBlock)
    for i in range(12):
        b = t.phase0.SignedBeaconBlock.default()
        b.message.slot = i
        b.message.proposer_index = 3 * i
        blocks.add(b)
        db.put(d.encode_key(d.Bucket.index_mainChain, i % 5), bytes([i]) * (i + 3))
    db.delete(d.encode_key(d.Bucket.index_mainChain, 2))
    db.batch_put([(d.encode_key(d.Bucket.index_chainInfo, "k%d" % i), b"v" * i) for i in range(4)])
    held = contents(db)
    db.close()
    return held


@pytest.mark.parametrize("compact_bytes", [64 * 1024 * 1024, 1_500])
@pytest.mark.parametrize("writer,reader", [ROOTS, ROOTS[::-1]])
def test_file_db_crosses_between_packages(writer, reader, compact_bytes, tmp_path):
    """A FileDbController directory written by one package is read back by
    the other, entry for entry; then the reader appends and the writer
    reads that back too."""
    path = str(tmp_path / "db" / "wal.log")
    held = _write_log(pkg(writer), path, compact_bytes)
    # the other package writes the same steps to the same bytes
    twin = str(tmp_path / "twin" / "wal.log")
    assert _write_log(pkg(reader), twin, compact_bytes) == held
    assert file_bytes(twin) == file_bytes(path)

    d = pkg(reader).db
    db = d.FileDbController(path, compact_bytes=compact_bytes)
    assert contents(db) == held
    db.put(d.encode_key(d.Bucket.index_mainChain, 9), b"appended")
    db.delete(d.encode_key(d.Bucket.index_mainChain, 0))
    after = contents(db)
    db.close()
    w = pkg(writer).db.FileDbController(path, compact_bytes=compact_bytes)
    assert contents(w) == after
    w.close()


@pytest.mark.parametrize("cut", [1, 5, 9, 20])
@pytest.mark.parametrize("writer,reader", [ROOTS, ROOTS[::-1]])
def test_torn_last_record_replays_across_packages(writer, reader, cut, tmp_path):
    """A log whose last record is cut `cut` bytes short, written by one
    package: the other replays every whole record, drops the torn one and
    truncates the file where the JAX package's reader does."""
    path = str(tmp_path / "wal.log")
    held = _write_log(pkg(writer), path, 64 * 1024 * 1024)
    whole = file_bytes(path)
    with open(path, "r+b") as f:
        f.truncate(len(whole) - cut)
    torn = file_bytes(path)
    seen = []
    for root in (reader, writer):
        with open(path, "wb") as f:
            f.write(torn)
        db = pkg(root).db.FileDbController(path)
        seen.append((contents(db), file_bytes(path)))
        db.close()
    assert seen[0] == seen[1]
    got, truncated = seen[0]
    assert set(got) < set(held) and held[-1] not in got  # the torn record is gone
    assert whole.startswith(truncated) and len(truncated) < len(torn)
