"""Incremental merkle tree + tree-backed SSZ views (dirty-node hashing).

Counterpart of `@chainsafe/persistent-merkle-tree` + ssz ViewDU
(reference `packages/state-transition/src/stateTransition.ts:100` calls
`hashTreeRoot` on a tree-backed state so only dirty subtrees re-hash; perf
pin `state-transition/test/perf/hashing.test.ts`: BeaconState root after
{1, 32, 512, 250k} mutations).

Design (hybrid host/device, SURVEY §7 hard part 4):

* Immutable structural-sharing `Node` tree. Branch roots are **lazy**: a
  mutation rebuilds only the O(depth) path and leaves the new branches
  unhashed.
* `compute_root` collects every unhashed node grouped by height and hashes
  each height as ONE batch through `ssz.hash.hash_nodes` — large frontiers
  (initial builds, epoch-boundary sweeps) ride the device SHA-256 graphs,
  small update paths stay on the host. Cost is O(dirty * depth) batched,
  never O(state).
* Tree-backed views (`tree_view`) give typed get/set access for the state
  transition: packed basic lists (balances), composite lists (validators,
  with element roots vectorized via `ssz.batch`), containers (BeaconState)
  with lazily-attached child views.

Composite list elements are stored as root leaves (their own subtree is
re-rooted on element write via the vectorized batch path); proofs *into*
an element therefore go through the element type's `merkle_branch`, while
state-field-level proofs come from `merkle_proof` here.

A copy of `lodestar_tpu.ssz.tree`.
"""

from __future__ import annotations

import numpy as np

from .batch import batch_container_roots, pack_basic_chunks
from .hash import ZERO_HASHES, hash_nodes
from .merkle import mix_in_length, next_pow_of_two
from .types import (
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    ByteVector,
    Container,
    ContainerValue,
    List,
    SSZType,
    Uint,
    Vector,
)

__all__ = [
    "Node",
    "leaf",
    "branch",
    "zero_node",
    "collect_unhashed",
    "compute_root",
    "subtree_from_chunks",
    "get_node",
    "set_node",
    "tree_view",
    "TreeView",
    "ContainerTreeView",
    "BasicListTreeView",
    "CompositeListTreeView",
]


class Node:
    """Immutable binary merkle node. Leaves carry a fixed 32-byte root;
    branches compute theirs lazily (see compute_root)."""

    __slots__ = ("left", "right", "_root")

    def __init__(self, left: "Node | None", right: "Node | None", root: bytes | None):
        self.left = left
        self.right = right
        self._root = root

    @property
    def is_leaf(self) -> bool:
        return self.left is None


def leaf(root: bytes) -> Node:
    return Node(None, None, bytes(root))


def branch(left: Node, right: Node) -> Node:
    return Node(left, right, None)


_ZERO_NODES: list[Node] = [leaf(ZERO_HASHES[0])]


def zero_node(depth: int) -> Node:
    """Root node of a depth-d all-zero subtree (shared, pre-rooted)."""
    while len(_ZERO_NODES) <= depth:
        d = len(_ZERO_NODES)
        n = Node(_ZERO_NODES[d - 1], _ZERO_NODES[d - 1], ZERO_HASHES[d])
        _ZERO_NODES.append(n)
    return _ZERO_NODES[depth]


def _root_routed(node: Node, dirty: int | None = None) -> bytes:
    """Root of `node` through the process-wide HTR backend switch: the
    device dirty-subtree collector (`ssz.device_htr`, one padded
    `hash_pairs` launch per level; a device error raises) when active,
    else the host `compute_root` below.
    `dirty` is the view's recorded mutated-chunk count, forwarded for
    metric attribution."""
    from . import device_htr

    if device_htr.device_htr_active():
        return device_htr.compute_root_node(node, dirty_hint=dirty)
    return compute_root(node)


def collect_unhashed(node: Node) -> dict[int, list[Node]]:
    """Group every unhashed descendant of `node` by dirty-subgraph
    height (1 = both children rooted). The ONE walk behind both the
    CPU `compute_root` below and the device collector's node jobs
    (`ssz.device_htr`) — their launch schedules must stay identical,
    so the grouping lives in exactly one place."""
    groups: dict[int, list[Node]] = {}
    memo: dict[int, int] = {}

    def height(n: Node) -> int:
        if n._root is not None:
            return 0
        key = id(n)
        h = memo.get(key)
        if h is not None:
            return h
        h = 1 + max(height(n.left), height(n.right))
        memo[key] = h
        groups.setdefault(h, []).append(n)
        return h

    height(node)
    return groups


def compute_root(node: Node) -> bytes:
    """Root of `node`, hashing every unhashed descendant in height-grouped
    batches (one `hash_nodes` call per level of dirty frontier)."""
    if node._root is not None:
        return node._root
    groups = collect_unhashed(node)
    for h in sorted(groups):
        batch = groups[h]
        data = np.empty((2 * len(batch), 32), dtype=np.uint8)
        for i, n in enumerate(batch):
            data[2 * i] = np.frombuffer(n.left._root, dtype=np.uint8)
            data[2 * i + 1] = np.frombuffer(n.right._root, dtype=np.uint8)
        roots = hash_nodes(data)
        for i, n in enumerate(batch):
            n._root = roots[i].tobytes()
    return node._root


def subtree_from_chunks(chunks: np.ndarray, depth: int) -> Node:
    """Build a depth-d subtree over (N, 32) chunk leaves, zero-filled to
    2^d. No hashing happens here — roots are computed lazily in batch."""
    n = chunks.shape[0]
    if n > (1 << depth):
        raise ValueError("too many chunks for depth")
    if n == 0:
        return zero_node(depth)
    nodes: list[Node] = [leaf(chunks[i].tobytes()) for i in range(n)]
    for d in range(depth):
        nxt: list[Node] = []
        for i in range(0, len(nodes), 2):
            left = nodes[i]
            right = nodes[i + 1] if i + 1 < len(nodes) else zero_node(d)
            nxt.append(branch(left, right))
        if not nxt:
            nxt = [zero_node(d + 1)]
        nodes = nxt
    return nodes[0]


def _path_bits(gindex: int) -> list[int]:
    """MSB-after-leading-1 bit path of a generalized index (0=left)."""
    return [int(b) for b in bin(gindex)[3:]]


def get_node(root: Node, gindex: int) -> Node:
    n = root
    for b in _path_bits(gindex):
        n = n.right if b else n.left
        if n is None:
            raise IndexError("gindex beyond tree")
    return n


def set_node(root: Node, gindex: int, new: Node) -> Node:
    """Structural-sharing update: new tree with the node at gindex
    replaced; only the O(depth) path is rebuilt (unhashed)."""
    bits = _path_bits(gindex)

    def rec(n: Node, i: int) -> Node:
        if i == len(bits):
            return new
        if bits[i]:
            return branch(n.left, rec(n.right, i + 1))
        return branch(rec(n.left, i + 1), n.right)

    return rec(root, 0)


# --- typed tree views --------------------------------------------------------


def _chunk_depth(limit_chunks: int) -> int:
    return (next_pow_of_two(max(limit_chunks, 1)) - 1).bit_length()


class TreeView:
    """Base: a typed window over a Node subtree.

    Views carry cheap dirty tracking: mutated gindices (or field names)
    are recorded on `set`/`push` into a plain set — no per-node Python
    object bloat for clean subtrees — and cleared when the view
    re-roots. `dirty_count()` is forwarded to the collector as the
    exact mutated-chunk count behind
    `lodestar_ssz_htr_dirty_chunks_total`; the authoritative dirty
    structure for hashing stays the unhashed-node frontier."""

    def hash_tree_root(self) -> bytes:
        raise NotImplementedError

    def commit(self) -> Node:
        """Return the current backing node (after flushing child views)."""
        raise NotImplementedError

    def to_value(self):
        raise NotImplementedError

    def dirty_count(self) -> int:
        return 0


class _LeafView(TreeView):
    """Opaque fallback: value re-rooted through the scalar type path on
    every write (bitfields, byte lists, small vectors...)."""

    def __init__(self, sszt: SSZType, value):
        self.type = sszt
        self.value = value

    def hash_tree_root(self) -> bytes:
        return self.type.hash_tree_root(self.value)

    def commit(self) -> Node:
        return leaf(self.hash_tree_root())

    def to_value(self):
        return self.value


class BasicListTreeView(TreeView):
    """Packed basic list (balances, inactivity scores...): chunked leaves,
    O(depth) single-lane writes, device-batched bulk builds."""

    def __init__(self, sszt: List, values=None, node: Node | None = None, length: int = 0):
        self.type = sszt
        self.elem_size = sszt.elem.fixed_size()
        self.per_chunk = 32 // self.elem_size
        limit_chunks = -(-sszt.limit * self.elem_size // 32)
        self.depth = _chunk_depth(limit_chunks)
        # mutated chunk gindices since the last re-root (cheap dirty
        # tracking: one set for the whole view, nothing per clean node)
        self._dirty: set[int] = set()  # guarded by: view-owner (views are confined to the thread advancing their state)
        if node is not None:
            self._node = node
            self._length = length
        else:
            values = list(values or [])
            self._node = subtree_from_chunks(
                pack_basic_chunks(sszt.elem, values), self.depth
            )
            self._length = len(values)

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    def _chunk_gindex(self, ci: int) -> int:
        return (1 << self.depth) + ci

    def get(self, i: int):
        if not 0 <= i < self._length:
            raise IndexError("list index out of range")
        ci, lane = divmod(i, self.per_chunk)
        chunk = get_node(self._node, self._chunk_gindex(ci))._root
        return self.type.elem.deserialize(
            chunk[lane * self.elem_size : (lane + 1) * self.elem_size]
        )

    def set(self, i: int, v) -> None:
        if not 0 <= i < self._length:
            raise IndexError("list index out of range")
        ci, lane = divmod(i, self.per_chunk)
        gi = self._chunk_gindex(ci)
        chunk = bytearray(get_node(self._node, gi)._root)
        chunk[lane * self.elem_size : (lane + 1) * self.elem_size] = self.type.elem.serialize(v)
        self._node = set_node(self._node, gi, leaf(bytes(chunk)))
        self._dirty.add(gi)

    def push(self, v) -> None:
        if self._length >= self.type.limit:
            raise ValueError("list limit exceeded")
        self._length += 1
        i = self._length - 1
        ci, lane = divmod(i, self.per_chunk)
        gi = self._chunk_gindex(ci)
        chunk = bytearray(get_node(self._node, gi)._root if lane else b"\x00" * 32)
        chunk[lane * self.elem_size : (lane + 1) * self.elem_size] = self.type.elem.serialize(v)
        self._node = set_node(self._node, gi, leaf(bytes(chunk)))
        self._dirty.add(gi)

    def dirty_count(self) -> int:
        return len(self._dirty)

    def dirty_gindices(self) -> frozenset[int]:
        return frozenset(self._dirty)

    def commit(self) -> Node:
        return self._node

    def hash_tree_root(self) -> bytes:
        root = mix_in_length(_root_routed(self._node, dirty=len(self._dirty)), self._length)
        self._dirty.clear()
        return root

    def to_value(self):
        return [self.get(i) for i in range(self._length)]


class CompositeListTreeView(TreeView):
    """List of composite elements (validators, historical roots...):
    element ROOTS are the tree leaves; bulk builds use the vectorized
    batch container rooter, element writes re-root one element."""

    def __init__(self, sszt: List, values=None, node: Node | None = None, length: int = 0):
        self.type = sszt
        self.depth = _chunk_depth(sszt.limit)
        self._dirty: set[int] = set()  # guarded by: view-owner (views are confined to the thread advancing their state)
        if node is not None:
            self._node = node
            self._length = length
            self._values = None  # unknown; to_value unsupported in this mode
        else:
            values = list(values or [])
            roots = None
            if isinstance(sszt.elem, Container):
                roots = batch_container_roots(sszt.elem, values)
            if roots is None:
                roots = np.frombuffer(
                    b"".join(sszt.elem.hash_tree_root(v) for v in values), dtype=np.uint8
                ).reshape(len(values), 32) if values else np.zeros((0, 32), dtype=np.uint8)
            self._node = subtree_from_chunks(roots, self.depth)
            self._length = len(values)
            self._values = values

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    def get(self, i: int):
        if self._values is None:
            raise TypeError("view not value-backed")
        if not 0 <= i < self._length:
            raise IndexError("list index out of range")
        return self._values[i]

    def set(self, i: int, v) -> None:
        if not 0 <= i < self._length:
            raise IndexError("list index out of range")
        gi = (1 << self.depth) + i
        self._node = set_node(self._node, gi, leaf(self.type.elem.hash_tree_root(v)))
        self._dirty.add(gi)
        if self._values is not None:
            self._values[i] = v

    def push(self, v) -> None:
        if self._length >= self.type.limit:
            raise ValueError("list limit exceeded")
        gi = (1 << self.depth) + self._length
        self._node = set_node(self._node, gi, leaf(self.type.elem.hash_tree_root(v)))
        self._dirty.add(gi)
        self._length += 1
        if self._values is not None:
            self._values.append(v)

    def dirty_count(self) -> int:
        return len(self._dirty)

    def dirty_gindices(self) -> frozenset[int]:
        return frozenset(self._dirty)

    def commit(self) -> Node:
        return self._node

    def hash_tree_root(self) -> bytes:
        root = mix_in_length(_root_routed(self._node, dirty=len(self._dirty)), self._length)
        self._dirty.clear()
        return root

    def to_value(self):
        if self._values is None:
            raise TypeError("view not value-backed")
        return list(self._values)


class ContainerTreeView(TreeView):
    """Container with per-field subtrees and lazily-attached child views.

    Reads of unmodified fields come from the original value; list/container
    fields accessed via `view(field)` get their own tree views whose dirty
    state folds in at hash_tree_root/commit time."""

    def __init__(self, sszt: Container, value: ContainerValue):
        self.type = sszt
        self.depth = _chunk_depth(len(sszt.fields))
        self._value = value
        self._children: dict[str, TreeView] = {}
        self._field_roots: dict[str, bytes] = {}
        self._node: Node | None = None  # built lazily on first root
        self._dirty_fields: set[str] = set()  # guarded by: view-owner (views are confined to the thread advancing their state)

    # -- typed access ---------------------------------------------------------

    def get(self, fname: str):
        child = self._children.get(fname)
        if child is not None:
            return child.to_value()
        return getattr(self._value, fname)

    def set(self, fname: str, v) -> None:
        idx = self.type.field_index(fname)
        ftype = self.type.fields[idx][1]
        self._children.pop(fname, None)
        self._field_roots[fname] = ftype.hash_tree_root(v)
        self._dirty_fields.add(fname)
        setattr(self._value, fname, v)

    def view(self, fname: str) -> TreeView:
        """Child view for a composite field (cached; mutations tracked)."""
        child = self._children.get(fname)
        if child is None:
            idx = self.type.field_index(fname)
            ftype = self.type.fields[idx][1]
            child = tree_view(ftype, getattr(self._value, fname))
            self._children[fname] = child
            self._field_roots.pop(fname, None)
        return child

    # -- rooting --------------------------------------------------------------

    def _field_root(self, fname: str, ftype: SSZType) -> bytes:
        child = self._children.get(fname)
        if child is not None:
            return child.hash_tree_root()
        r = self._field_roots.get(fname)
        if r is None:
            r = ftype.hash_tree_root(getattr(self._value, fname))
            self._field_roots[fname] = r
        return r

    def dirty_count(self) -> int:
        return len(self._dirty_fields) + sum(
            c.dirty_count() for c in self._children.values()
        )

    def hash_tree_root(self) -> bytes:
        # hint = OWN dirty field roots only: each dirty child view
        # attributes its chunks itself when `_field_root` re-roots it —
        # folding children in here would double-count the metric
        dirty = len(self._dirty_fields)
        roots = np.frombuffer(
            b"".join(self._field_root(n, t) for n, t in self.type.fields), dtype=np.uint8
        ).reshape(len(self.type.fields), 32)
        self._node = subtree_from_chunks(roots, self.depth)
        self._dirty_fields.clear()
        return _root_routed(self._node, dirty=dirty)

    def commit(self) -> Node:
        self.hash_tree_root()
        return self._node

    def to_value(self) -> ContainerValue:
        # flush child views back into the value
        for fname, child in self._children.items():
            setattr(self._value, fname, child.to_value())
        return self._value


def tree_view(sszt: SSZType, value) -> TreeView:
    """Build the appropriate tree view for a typed value."""
    if isinstance(sszt, Container):
        return ContainerTreeView(sszt, value)
    if isinstance(sszt, List):
        if isinstance(sszt.elem, (Uint, Boolean)):
            return BasicListTreeView(sszt, value)
        return CompositeListTreeView(sszt, value)
    if isinstance(sszt, (Vector, Bitvector, Bitlist, ByteList, ByteVector, Uint, Boolean)):
        return _LeafView(sszt, value)
    return _LeafView(sszt, value)


# --- merkle proofs (reference proof.ts / persistent-merkle-tree getProof) -----


def merkle_proof(sszt, value, gindex: int) -> tuple[bytes, list[bytes]]:
    """Single-leaf merkle branch for a CONTAINER FIELD by generalized
    index.

    Supported gindex domain: the container's top field layer — for a
    container with its field count padded to 2^d leaves, field i has
    gindex 2^d + i. (Deeper paths can be composed by proving recursively
    on the field's own type; the Beacon API proof route serves the
    field-level case, e.g. finalized_checkpoint or state roots out of
    BeaconState.)

    Returns (leaf, branch) with branch ordered leaf -> root, verifiable
    by hashing leaf with each sibling per the gindex's bit path.
    """
    import hashlib

    from .hash import ZERO_HASHES

    if not isinstance(sszt, Container):
        raise ValueError("merkle_proof supports container types")
    n = len(sszt.fields)
    depth = max(1, (n - 1).bit_length())
    width = 1 << depth
    if not (width <= gindex < 2 * width):
        raise ValueError(
            f"gindex {gindex} outside the field layer [{width}, {2 * width})"
        )
    index = gindex - width
    leaves = [
        ftype.hash_tree_root(getattr(value, fname)) for fname, ftype in sszt.fields
    ]
    leaves += [ZERO_HASHES[0]] * (width - n)
    leaf = leaves[index]

    branch = []
    layer = leaves
    idx = index
    for _ in range(depth):
        sibling = layer[idx ^ 1]
        branch.append(sibling)
        layer = [
            hashlib.sha256(layer[2 * i] + layer[2 * i + 1]).digest()
            for i in range(len(layer) // 2)
        ]
        idx //= 2
    return leaf, branch
