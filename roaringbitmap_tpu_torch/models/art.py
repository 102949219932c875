"""Adaptive Radix Tree over fixed 6-byte keys (the 64-bit layer's key index).

The port's own copy of the JAX package's ``models/art.py`` (pure Python,
no dependencies), kept here so the port imports nothing of that package.
Re-expression of the reference's ``art/`` package (art/Art.java:10-13, per
Leis et al. "The adaptive radix tree: ARTful indexing for main-memory
databases"): keys are the high 48 bits of a 64-bit value as 6 big-endian
bytes (longlong/LongUtils.java high48 split), so unsigned numeric order ==
lexicographic byte order. Four node widths with upgrade/downgrade
(art/Node4.java, Node16.java, Node48.java, Node256.java), path compression
(the ``prefix`` field), and ordered forward/backward traversal (the
reference's ``AbstractShuttle``/``ForwardShuttle``/``BackwardShuttle``
cursors become Python generators).

Leaves store an opaque payload (here: the packed index of a 16-bit
container in ``roaring64art.Containers``). Structure is plain Python
objects — this is the host-side index; device work happens on the packed
container store (parallel/store.py).
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

KEY_BYTES = 6


class _Leaf:
    __slots__ = ("key", "value")

    def __init__(self, key: bytes, value: Any):
        self.key = key
        self.value = value


class _Node:
    """Inner node; concrete width decided by ``n_children``."""

    __slots__ = ("prefix", "keys", "children", "child_index")

    GROW_AT = {4: 16, 16: 48, 48: 256}

    def __init__(self, prefix: bytes):
        self.prefix = prefix
        # Node4/16 representation: sorted parallel arrays
        self.keys: Optional[bytearray] = bytearray()
        self.children: list = []
        # Node48/256 representation: 256-entry dispatch table
        self.child_index: Optional[list] = None

    # -- representation management ----------------------------------------
    @property
    def n_children(self) -> int:
        if self.child_index is not None:
            return sum(1 for c in self.child_index if c is not None)
        return len(self.children)

    def node_width(self) -> int:
        """4/16/48/256 — the concrete reference node type this corresponds to
        (used by introspection/tests; the physical representation here is
        array-form up to 48 children, table-form beyond)."""
        n = self.n_children
        if self.child_index is not None:
            return 256 if n > 48 else 48
        return 4 if n <= 4 else (16 if n <= 16 else 48)

    def find(self, byte: int):
        if self.child_index is not None:
            return self.child_index[byte]
        # binary search over the sorted key array (Node16's SSE compare
        # becomes a bisect here)
        keys = self.keys
        lo, hi = 0, len(keys)
        while lo < hi:
            mid = (lo + hi) // 2
            if keys[mid] < byte:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(keys) and keys[lo] == byte:
            return self.children[lo]
        return None

    def put(self, byte: int, child) -> None:
        if self.child_index is not None:
            self.child_index[byte] = child
            return
        keys = self.keys
        # ascending-order fast path (bulk_load, sorted ingest): append
        if (not keys or byte > keys[-1]) and len(keys) < 48:
            keys.append(byte)
            self.children.append(child)
            return
        lo, hi = 0, len(keys)
        while lo < hi:
            mid = (lo + hi) // 2
            if keys[mid] < byte:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(keys) and keys[lo] == byte:
            self.children[lo] = child
            return
        if len(keys) >= 48:  # upgrade to the 256-table form (Node48 -> Node256
            # boundary; 16 -> 48 also lands here as the table form covers both)
            table = [None] * 256
            for k, c in zip(keys, self.children):
                table[k] = c
            table[byte] = child
            self.child_index = table
            self.keys = None
            self.children = []
            return
        keys.insert(lo, byte)
        self.children.insert(lo, child)

    def delete(self, byte: int) -> None:
        if self.child_index is not None:
            self.child_index[byte] = None
            if self.n_children <= 36:  # downgrade back to array form
                pairs = [
                    (k, c) for k, c in enumerate(self.child_index) if c is not None
                ]
                self.keys = bytearray(k for k, _ in pairs)
                self.children = [c for _, c in pairs]
                self.child_index = None
            return
        keys = self.keys
        for i, k in enumerate(keys):
            if k == byte:
                del keys[i]
                del self.children[i]
                return

    # -- ordered access -----------------------------------------------------
    def items(self):
        """(byte, child) in ascending byte order."""
        if self.child_index is not None:
            for b, c in enumerate(self.child_index):
                if c is not None:
                    yield b, c
        else:
            yield from zip(self.keys, self.children)

    def items_reverse(self):
        if self.child_index is not None:
            for b in range(255, -1, -1):
                c = self.child_index[b]
                if c is not None:
                    yield b, c
        else:
            yield from zip(reversed(self.keys), reversed(self.children))

    def only_child(self):
        for item in self.items():
            return item
        return None


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class Art:
    """The trie facade (art/Art.java:35 ``insert`` / :47 ``findByKey``)."""

    __slots__ = ("_root", "_size")

    def __init__(self):
        self._root = None
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def is_empty(self) -> bool:
        return self._root is None

    # -- core ---------------------------------------------------------------
    def insert(self, key: bytes, value: Any) -> None:
        assert len(key) == KEY_BYTES
        if self._root is None:
            self._root = _Leaf(key, value)
            self._size = 1
            return
        self._root = self._insert(self._root, key, 0, value)

    def _insert(self, node, key: bytes, depth: int, value: Any):
        if isinstance(node, _Leaf):
            if node.key == key:
                node.value = value  # replaceContainer path
                return node
            # split into a new inner node holding both leaves
            cp = _common_prefix(node.key[depth:], key[depth:])
            new = _Node(key[depth : depth + cp])
            new.put(node.key[depth + cp], node)
            new.put(key[depth + cp], _Leaf(key, value))
            self._size += 1
            return new
        pfx = node.prefix
        cp = _common_prefix(pfx, key[depth:])
        if cp < len(pfx):
            # split the compressed path (prefix mismatch)
            new = _Node(key[depth : depth + cp])
            node.prefix = pfx[cp + 1 :]
            new_branch_old = pfx[cp]
            new.put(new_branch_old, node)
            new.put(key[depth + cp], _Leaf(key, value))
            self._size += 1
            return new
        depth += cp
        child = node.find(key[depth])
        if child is None:
            node.put(key[depth], _Leaf(key, value))
            self._size += 1
        else:
            node.put(key[depth], self._insert(child, key, depth + 1, value))
        return node

    def bulk_load(self, pairs) -> None:
        """Build the whole trie from SORTED DISTINCT (key, value) pairs in
        one bottom-up pass — O(n) node construction with no per-key descent
        (the reference only has per-key ``insert``; bulk ingest through it
        costs a full root-to-leaf walk per key, which is what
        Roaring64Bitmap.add_many's scattered-key profile showed dominating).
        Only valid on an empty trie; node widths come out identical to
        incremental insertion because ``put`` upgrades at the same
        thresholds."""
        if self._root is not None:
            raise ValueError("bulk_load requires an empty trie")
        items = list(pairs)
        if not items:
            return
        assert all(len(k) == KEY_BYTES for k, _ in items), "keys must be 6 bytes"
        assert all(
            items[i][0] < items[i + 1][0] for i in range(len(items) - 1)
        ), "keys must be sorted distinct"
        self._root = self._bulk_build(items, 0)
        self._size = len(items)

    def _bulk_build(self, items, depth: int):
        if len(items) == 1:
            k, v = items[0]
            return _Leaf(k, v)
        # sorted input: the common prefix of (first, last) is common to all
        first, last = items[0][0], items[-1][0]
        cp = _common_prefix(first[depth:], last[depth:])
        node = _Node(first[depth : depth + cp])
        d = depth + cp
        i, n = 0, len(items)
        while i < n:
            b = items[i][0][d]
            j = i + 1
            while j < n and items[j][0][d] == b:
                j += 1
            # ascending bytes: put() appends at the tail, no mid-array shifts
            node.put(b, self._bulk_build(items[i:j], d + 1))
            i = j
        return node

    def find(self, key: bytes):
        """Payload for key, or None (art/Art.java:47 findByKey)."""
        node = self._root
        depth = 0
        while node is not None:
            if isinstance(node, _Leaf):
                return node.value if node.key == key else None
            pfx = node.prefix
            if key[depth : depth + len(pfx)] != pfx:
                return None
            depth += len(pfx)
            node = node.find(key[depth])
            depth += 1
        return None

    def remove(self, key: bytes) -> bool:
        if self._root is None:
            return False
        removed, self._root = self._remove(self._root, key, 0)
        if removed:
            self._size -= 1
        return removed

    def _remove(self, node, key: bytes, depth: int):
        if isinstance(node, _Leaf):
            return (True, None) if node.key == key else (False, node)
        pfx = node.prefix
        if key[depth : depth + len(pfx)] != pfx:
            return False, node
        depth += len(pfx)
        byte = key[depth]
        child = node.find(byte)
        if child is None:
            return False, node
        removed, new_child = self._remove(child, key, depth + 1)
        if not removed:
            return False, node
        if new_child is None:
            node.delete(byte)
        else:
            node.put(byte, new_child)
        n = node.n_children
        if n == 0:
            return True, None
        if n == 1:
            # path-compress single-child inner nodes away
            b, only = node.only_child()
            if isinstance(only, _Leaf):
                return True, only
            only.prefix = node.prefix + bytes([b]) + only.prefix
            return True, only
        return True, node

    # -- ordered traversal (Forward/BackwardShuttle) -------------------------
    def items(self) -> Iterator[Tuple[bytes, Any]]:
        yield from self._walk(self._root, reverse=False)

    def items_reverse(self) -> Iterator[Tuple[bytes, Any]]:
        """Streaming descending traversal in O(depth) memory — the
        BackwardShuttle (art/BackwardShuttle.java:1); callers must NOT need
        the trie materialized (it exists precisely to hold huge key sets)."""
        yield from self._walk(self._root, reverse=True)

    def _walk(self, node, reverse: bool):
        """Explicit-stack shuttle (art/AbstractShuttle.java:1): one child
        iterator per trie level, so traversal holds O(depth) frames — never
        the O(n) node list — in either direction."""
        if node is None:
            return
        stack = [iter(((0, node),))]
        while stack:
            nxt = next(stack[-1], None)
            if nxt is None:
                stack.pop()
                continue
            child = nxt[1]
            if isinstance(child, _Leaf):
                yield child.key, child.value
            else:
                stack.append(
                    child.items_reverse() if reverse else child.items()
                )

    def node_width_histogram(self) -> dict:
        """Count of inner nodes per reference node class (4/16/48/256) —
        introspection for the adaptive-width design (art/Node4.java etc.;
        here widths <= 48 share the sorted-array physical form and wider
        nodes the 256-table form, with upgrade at 48 and downgrade at 36)."""
        hist = {4: 0, 16: 0, 48: 0, 256: 0, "leaves": 0}
        stack = [self._root] if self._root is not None else []
        while stack:
            node = stack.pop()
            if isinstance(node, _Leaf):
                hist["leaves"] += 1
                continue
            hist[node.node_width()] += 1
            for _, child in node.items():
                stack.append(child)
        return hist

    def first(self) -> Optional[Tuple[bytes, Any]]:
        for kv in self.items():
            return kv
        return None

    def last(self) -> Optional[Tuple[bytes, Any]]:
        for kv in self.items_reverse():
            return kv
        return None

    def items_from(self, key: bytes) -> Iterator[Tuple[bytes, Any]]:
        """Ordered (k, v) with k >= key — the shuttle's seek support
        (LeafNodeIterator with from-key)."""
        yield from self._walk_from(self._root, key, 0)

    def items_to(self, key: bytes) -> Iterator[Tuple[bytes, Any]]:
        """Reverse-ordered (k, v) with k <= key (the BackwardShuttle seek)."""
        yield from self._walk_to(self._root, key, 0)

    def _walk_to(self, node, key: bytes, depth: int):
        if node is None:
            return
        if isinstance(node, _Leaf):
            if node.key <= key:
                yield node.key, node.value
            return
        pfx = node.prefix
        sub = key[depth : depth + len(pfx)]
        if pfx < sub:  # whole subtree is before the seek point
            yield from self._walk(node, reverse=True)
            return
        if pfx > sub:  # whole subtree is after it
            return
        depth += len(pfx)
        target = key[depth] if depth < len(key) else 255
        for b, child in node.items_reverse():
            if b > target:
                continue
            if b == target:
                yield from self._walk_to(child, key, depth + 1)
            else:
                yield from self._walk(child, reverse=True)

    def _walk_from(self, node, key: bytes, depth: int):
        if node is None:
            return
        if isinstance(node, _Leaf):
            if node.key >= key:
                yield node.key, node.value
            return
        pfx = node.prefix
        sub = key[depth : depth + len(pfx)]
        if pfx > sub:  # whole subtree is after the seek point
            yield from self._walk(node, reverse=False)
            return
        if pfx < sub:  # whole subtree is before it
            return
        depth += len(pfx)
        target = key[depth] if depth < len(key) else 0
        for b, child in node.items():
            if b < target:
                continue
            if b == target:
                yield from self._walk_from(child, key, depth + 1)
            else:
                yield from self._walk(child, reverse=False)
