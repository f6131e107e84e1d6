"""Immutable tree topologies with the reference's id conventions.

Reimplements the semantics of /root/reference/src/node.hpp (Node) for the
host-side, compile-time layer of the framework. The conventions that
matter for numerical parity and for the SBN indexers:

  * Children of an internal node are sorted by their max leaf id at
    construction (node.cpp Node::Node), which canonicalizes topologies.
  * After ``polish()``, leaves have ids equal to their leaf (taxon) number and
    internal nodes are numbered ``leaf_count, leaf_count+1, ...`` in postorder
    (node.cpp Node::Polish); the root has the largest id.
  * ``tag`` is (max leaf id below, number of leaves below).

At runtime, a topology is lowered to dense index arrays (see ops/schedule.py);
this class only exists while building those schedules.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.bitset import Bitset


class Topology:
    """An immutable (post-construction) phylogenetic tree topology node."""

    __slots__ = (
        "children",
        "leaf_id",
        "max_leaf_id",
        "leaf_count",
        "id",
        "leaves",
        "_hash",
    )

    def __init__(self, children: Tuple["Topology", ...], leaf_id: Optional[int]):
        if leaf_id is not None:
            assert not children
            self.children: Tuple[Topology, ...] = ()
            self.leaf_id: Optional[int] = leaf_id
            self.max_leaf_id = leaf_id
            self.leaf_count = 1
            self._hash = hash(("leaf", leaf_id))
        else:
            assert children
            # Sort children by max leaf id — canonical form (node.cpp).
            children = tuple(sorted(children, key=lambda c: c.max_leaf_id))
            for a, b in zip(children, children[1:]):
                if a.max_leaf_id == b.max_leaf_id:
                    raise ValueError("tie in max leaf ids; repeated taxon?")
            self.children = children
            self.leaf_id = None
            self.max_leaf_id = children[-1].max_leaf_id
            self.leaf_count = sum(c.leaf_count for c in children)
            self._hash = hash(("join",) + tuple(c._hash for c in children))
        # Assigned by polish():
        self.id: int = -1
        self.leaves: Optional[Bitset] = None

    # -- constructors -------------------------------------------------------
    @staticmethod
    def leaf(leaf_id: int) -> "Topology":
        return Topology((), leaf_id)

    @staticmethod
    def join(children: Sequence["Topology"]) -> "Topology":
        return Topology(tuple(children), None)

    @staticmethod
    def join2(left: "Topology", right: "Topology") -> "Topology":
        return Topology((left, right), None)

    # -- identity -----------------------------------------------------------
    @property
    def tag(self) -> Tuple[int, int]:
        return (self.max_leaf_id, self.leaf_count)

    def is_leaf(self) -> bool:
        return self.leaf_id is not None

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        if not isinstance(other, Topology):
            return NotImplemented
        if self._hash != other._hash:
            return False
        if self.is_leaf() or other.is_leaf():
            return self.leaf_id == other.leaf_id
        if len(self.children) != len(other.children):
            return False
        return all(a == b for a, b in zip(self.children, other.children))

    def __repr__(self) -> str:
        return f"Topology({self.newick()})"

    # -- polish: id and leaf-set assignment ---------------------------------
    def polish(self) -> Dict[Tuple[int, int], int]:
        """Assign ids (leaves: taxon number; internals: postorder from
        leaf_count) and leaf bitsets. Returns tag -> id map (node.cpp
        Node::Polish)."""
        tag_id_map: Dict[Tuple[int, int], int] = {}
        leaf_count = self.max_leaf_id + 1
        next_id = leaf_count

        for node in self.postorder():
            if node.is_leaf():
                node.id = node.leaf_id
                node.leaves = Bitset.singleton(leaf_count, node.leaf_id)
            else:
                node.id = next_id
                next_id += 1
                leaves = Bitset(leaf_count, 0)
                for c in node.children:
                    leaves = leaves | c.leaves
                node.leaves = leaves
            tag_id_map[node.tag] = node.id
        return tag_id_map

    # -- traversals ---------------------------------------------------------
    def postorder(self):
        """Iterative postorder (children before parent)."""
        stack: List[Tuple[Topology, bool]] = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded or node.is_leaf():
                yield node
            else:
                stack.append((node, True))
                for c in reversed(node.children):
                    stack.append((c, False))

    def preorder(self):
        stack: List[Topology] = [self]
        while stack:
            node = stack.pop()
            yield node
            for c in reversed(node.children):
                stack.append(c)

    def levelorder(self):
        queue: List[Topology] = [self]
        while queue:
            node = queue.pop(0)
            yield node
            queue.extend(node.children)

    def binary_id_postorder(self, f: Callable[[int, int, int], None]):
        """Apply f(node_id, child0_id, child1_id) at internal nodes in
        postorder, assuming bifurcating internals (node.hpp:124)."""
        for node in self.postorder():
            if not node.is_leaf():
                assert len(node.children) == 2, "binary traversal on non-binary node"
                f(node.id, node.children[0].id, node.children[1].id)

    def binary_id_preorder(self, f: Callable[[int, int, int], None]):
        for node in self.preorder():
            if not node.is_leaf():
                assert len(node.children) == 2
                f(node.id, node.children[0].id, node.children[1].id)

    def triple_id_preorder_bifurcating(self, f: Callable[[int, int, int], None]):
        """Apply f(node_id, sister_id, parent_id) in preorder over a
        bifurcating tree, skipping the root (node.hpp:116-122)."""
        assert len(self.children) == 2

        def recur(node: Topology):
            if not node.is_leaf():
                c0, c1 = node.children
                f(c0.id, c1.id, node.id)
                recur(c0)
                f(c1.id, c0.id, node.id)
                recur(c1)

        recur(self)

    def triple_preorder(
        self,
        f_root: Callable[["Topology", "Topology", "Topology"], None],
        f_internal: Callable[["Topology", "Topology", "Topology"], None],
    ):
        """Reference Node::TriplePreorder: f_root over the root's children in
        cyclic order 012, 120, 201, then f_internal(node, sister, parent)
        within each subtree."""
        assert len(self.children) == 3

        def recur(node: Topology, sister: Topology, parent: Topology):
            f_internal(node, sister, parent)
            if not node.is_leaf():
                c0, c1 = node.children
                recur(c0, c1, node)
                recur(c1, c0, node)

        c = self.children
        for i in range(3):
            n, s, p = c[i], c[(i + 1) % 3], c[(i + 2) % 3]
            f_root(n, s, p)
            if not n.is_leaf():
                c0, c1 = n.children
                recur(c0, c1, n)
                recur(c1, c0, n)

    def depth_first(self, pre: Callable, post: Callable):
        def recur(node: Topology):
            pre(node)
            for c in node.children:
                recur(c)
            post(node)

        recur(self)

    def ids_above(self) -> List[List[int]]:
        """ids_above[i] = ids of the nodes above node i (node.cpp IdsAbove)."""
        out: List[List[int]] = [[] for _ in range(self.id + 1)]
        path: List[int] = []

        def pre(node: Topology):
            out[node.id] = list(path)
            path.append(node.id)

        def post(node: Topology):
            path.pop()

        self.depth_first(pre, post)
        return out

    # -- conversions --------------------------------------------------------
    def parent_id_vector(self) -> List[int]:
        """v[i] = id of parent of node with id i; length = id of root
        (node.hpp:151-154)."""
        out = [-1] * self.id
        for node in self.preorder():
            for c in node.children:
                out[c.id] = node.id
        return out

    @staticmethod
    def of_parent_id_vector(indices: Sequence[int]) -> "Topology":
        """Build from a parent-id vector; assumes contiguous ids with the root
        having the largest id (node.hpp:165-168)."""
        n_nodes = len(indices) + 1
        children_of: Dict[int, List[int]] = {}
        for child, parent in enumerate(indices):
            children_of.setdefault(parent, []).append(child)

        def build(i: int) -> Topology:
            if i not in children_of:
                return Topology.leaf(i)
            return Topology.join([build(c) for c in children_of[i]])

        top = build(n_nodes - 1)
        top.polish()
        return top

    def deroot(self) -> "Topology":
        """Remove a bifurcating root: merge the root's non-leaf child's
        children with the other child (node.cpp Node::Deroot)."""
        assert self.leaf_count >= 3, "deroot expects >= 3 tips"
        assert len(self.children) == 2, "can't deroot a non-bifurcating root"
        c0, c1 = self.children
        if c1.leaf_count == 1:
            other, has_desc = c1, c0
        else:
            other, has_desc = c0, c1
        top = Topology.join(list(has_desc.children) + [other])
        top.polish()
        return top

    def newick(
        self,
        branch_lengths: Optional[Sequence[float]] = None,
        node_labels: Optional[Dict[Tuple[int, int], str]] = None,
        show_tags: bool = False,
    ) -> str:
        def label(node: Topology) -> str:
            if show_tags:
                return f"{node.max_leaf_id}_{node.leaf_count}"
            if node.is_leaf():
                if node_labels is not None:
                    name = node_labels[node.tag]
                    # Requote names containing spaces or metacharacters.
                    if any(ch in name for ch in " ()[]:;,'"):
                        return "'" + name.replace("'", "''") + "'"
                    return name
                return str(node.leaf_id)
            if node_labels is not None:
                return ""
            return str(node.id) if node.id >= 0 else ""

        def aux(node: Topology) -> str:
            if node.is_leaf():
                s = label(node)
            else:
                s = "(" + ",".join(aux(c) for c in node.children) + ")" + label(node)
            if branch_lengths is not None:
                s += f":{branch_lengths[node.id]}"
            return s

        return aux(self) + ";"

    # -- examples (node.cpp ExampleTopologies) ------------------------------
    @staticmethod
    def example_topologies() -> List["Topology"]:
        L = Topology.leaf
        J = Topology.join
        tops = [
            J([L(0), L(1), J([L(2), L(3)])]),
            J([L(1), L(0), J([L(3), L(2)])]),
            J([L(0), L(2), J([L(1), L(3)])]),
            J([L(0), J([L(1), J([L(2), L(3)])])]),
            J([J([L(0), J([L(2), L(3)])]), L(1)]),
        ]
        for t in tops:
            t.polish()
        return tops

    @staticmethod
    def ladder(leaf_count: int) -> "Topology":
        """Maximally unbalanced tree ((...(0,1),2),...)."""
        assert leaf_count >= 2
        node = Topology.join2(Topology.leaf(0), Topology.leaf(1))
        for i in range(2, leaf_count):
            node = Topology.join2(node, Topology.leaf(i))
        node.polish()
        return node


def topology_counter(topologies: Sequence[Topology]) -> Dict[Topology, int]:
    """Count identical topologies (Node::TopologyCounter analog)."""
    counter: Dict[Topology, int] = {}
    for t in topologies:
        counter[t] = counter.get(t, 0) + 1
    return counter
