"""The subsplit DAG (reference: /root/reference/src/subsplit_dag.{hpp,cpp}).

A DAG over subsplits built from a rooted tree collection. Node ids: fake
(leaf) subsplits at [0, taxon_count), then internal subsplits depth-first,
rootsplit subsplits last. Edges carry GPCSP indices laid out as rootsplits
first, then PCSP blocks grouped by parent, then fake-subsplit edges appended
(AddFakeSubsplitsToDAGEdgesAndParentToRange).

Besides the combinatorial structure, this module lowers the DAG to the dense
level schedules the GP engine consumes (see gp/engine.py): edges grouped
by parent-level for the rootward pass and by child-level for the leafward
pass, as int32 arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.topology import Topology
from ..sbn import maps
from ..utils.bitset import Bitset
from ..utils.combinatorics import log_child_subsplit_count_ratio


class DAGNode:
    __slots__ = (
        "id", "subsplit", "leafward_rotated", "leafward_sorted",
        "rootward_rotated", "rootward_sorted",
    )

    def __init__(self, node_id: int, subsplit: Bitset):
        self.id = node_id
        self.subsplit = subsplit
        self.leafward_rotated: List[int] = []
        self.leafward_sorted: List[int] = []
        self.rootward_rotated: List[int] = []
        self.rootward_sorted: List[int] = []

    def get_bitset(self, rotated: bool = False) -> Bitset:
        return self.subsplit.rotate_subsplit() if rotated else self.subsplit

    def is_root(self) -> bool:
        return not self.rootward_rotated and not self.rootward_sorted

    def is_leaf(self) -> bool:
        return not self.leafward_rotated and not self.leafward_sorted

    def get_leafward(self, rotated: bool) -> List[int]:
        return self.leafward_rotated if rotated else self.leafward_sorted

    def get_rootward(self, rotated: bool) -> List[int]:
        return self.rootward_rotated if rotated else self.rootward_sorted


class SubsplitDAG:
    def __init__(self, taxon_count: int, topology_counter):
        assert topology_counter, "Empty topology counter given to SubsplitDAG."
        self.taxon_count = taxon_count
        (
            self.rootsplits,
            gpcsp_indexer,
            index_to_child,
            self.parent_to_range,
            self.gpcsp_count_without_fake,
        ) = maps.build_indexer_bundle(
            maps.rooted_rootsplit_counter_of(topology_counter),
            maps.rooted_pcsp_counter_of(topology_counter),
        )
        self.subsplit_to_id: Dict[Bitset, int] = {}
        self.nodes: List[DAGNode] = []
        self.dag_edges: Dict[Tuple[int, int], int] = {}
        self._build_nodes(index_to_child)
        self._build_edges(index_to_child)
        self._build_dag_edges_from_indexer(gpcsp_indexer)
        self._add_fake_subsplits()
        self._count_topologies()

    @staticmethod
    def of_tree_collection(tree_collection) -> "SubsplitDAG":
        return SubsplitDAG(
            tree_collection.taxon_count(), tree_collection.topology_counter()
        )

    # -- construction --------------------------------------------------------
    def _create_node(self, subsplit: Bitset):
        node_id = len(self.nodes)
        self.subsplit_to_id[subsplit] = node_id
        self.subsplit_to_id[subsplit.rotate_subsplit()] = node_id
        self.nodes.append(DAGNode(node_id, subsplit))

    def _get_child_subsplits(self, index_to_child, subsplit: Bitset,
                             include_fake: bool) -> List[Bitset]:
        if subsplit in self.parent_to_range:
            start, stop = self.parent_to_range[subsplit]
            return [index_to_child[i] for i in range(start, stop)]
        if include_fake:
            return [Bitset.fake_child_subsplit(subsplit)]
        return []

    def _build_nodes_depth_first(self, index_to_child, subsplit, visited):
        visited.add(subsplit)
        for rotated in (False, True):
            s = subsplit.rotate_subsplit() if rotated else subsplit
            for child in self._get_child_subsplits(index_to_child, s, False):
                if child not in visited:
                    self._build_nodes_depth_first(index_to_child, child, visited)
        self._create_node(subsplit)

    def _build_nodes(self, index_to_child):
        visited = set()
        for taxon_idx in range(self.taxon_count):
            self._create_node(
                Bitset.fake_subsplit(Bitset.singleton(self.taxon_count, taxon_idx))
            )
        for rootsplit in self.rootsplits:
            subsplit = rootsplit + ~rootsplit
            self._build_nodes_depth_first(index_to_child, subsplit, visited)

    def _build_edges(self, index_to_child):
        for i in range(self.taxon_count, len(self.nodes)):
            for rotated in (False, True):
                node = self.nodes[i]
                subsplit = node.get_bitset(rotated)
                for child_subsplit in self._get_child_subsplits(
                    index_to_child, subsplit, True
                ):
                    child = self.nodes[self.subsplit_to_id[child_subsplit]]
                    if rotated:
                        node.leafward_rotated.append(child.id)
                        child.rootward_rotated.append(node.id)
                    else:
                        node.leafward_sorted.append(child.id)
                        child.rootward_sorted.append(node.id)

    def _build_dag_edges_from_indexer(self, gpcsp_indexer):
        for gpcsp, index in gpcsp_indexer.items():
            if gpcsp.size == 3 * self.taxon_count:
                parent_id = self.subsplit_to_id[gpcsp.pcsp_parent()]
                child_id = self.subsplit_to_id[gpcsp.pcsp_child_subsplit()]
                self.dag_edges[(parent_id, child_id)] = index
            elif gpcsp.size == self.taxon_count:
                rootsplit_id = self.subsplit_to_id[gpcsp + ~gpcsp]
                self.dag_edges[(rootsplit_id, rootsplit_id)] = index  # #273
            else:
                raise ValueError("Don't recognize bitset size!")

    def _add_fake_subsplits(self):
        for i in range(self.taxon_count):
            leaf_bitset = self.nodes[i].subsplit
            for rotated in (False, True):
                for parent_id in self.nodes[i].get_rootward(rotated):
                    parent = self.nodes[parent_id]
                    self.parent_to_range[parent.get_bitset(rotated)] = (
                        len(self.dag_edges), len(self.dag_edges) + 1,
                    )
                    self.dag_edges[(parent_id, i)] = len(self.dag_edges)

    # -- queries -------------------------------------------------------------
    def node_count(self) -> int:
        return len(self.nodes)

    def rootsplit_count(self) -> int:
        return len(self.rootsplits)

    def gpcsp_count(self) -> int:
        return self.gpcsp_count_without_fake

    def gpcsp_count_with_fake(self) -> int:
        return len(self.dag_edges)

    def rootsplit_node_ids(self) -> List[int]:
        return [self.subsplit_to_id[r + ~r] for r in self.rootsplits]

    def rootsplit_index_of_id(self, root_id: int) -> int:
        return self.dag_edges[(root_id, root_id)]

    def gpcsp_index_of_ids(self, parent_id: int, child_id: int) -> int:
        return self.dag_edges[(parent_id, child_id)]

    def get_gpcsp_index(self, parent_subsplit: Bitset, child_subsplit: Bitset) -> int:
        return self.gpcsp_index_of_ids(
            self.subsplit_to_id[parent_subsplit],
            self.subsplit_to_id[child_subsplit],
        )

    # -- traversals ----------------------------------------------------------
    def leafward_pass_traversal(self) -> List[int]:
        """Nodes ordered so parents of each r-update are already done."""
        visit_order: List[int] = []
        visited = set()

        def rootward_depth_first(node_id):
            visited.add(node_id)
            for parent_id in (
                self.nodes[node_id].rootward_sorted
                + self.nodes[node_id].rootward_rotated
            ):
                if parent_id not in visited:
                    rootward_depth_first(parent_id)
            visit_order.append(node_id)

        for leaf_id in range(self.taxon_count):
            rootward_depth_first(leaf_id)
        return visit_order

    def rootward_pass_traversal(self) -> List[int]:
        """Nodes ordered so children are done before parents."""
        visit_order: List[int] = []
        visited = set()

        def leafward_depth_first(node_id):
            visited.add(node_id)
            for child_id in (
                self.nodes[node_id].leafward_sorted
                + self.nodes[node_id].leafward_rotated
            ):
                if child_id not in visited:
                    leafward_depth_first(child_id)
            visit_order.append(node_id)

        for root_id in self.rootsplit_node_ids():
            leafward_depth_first(root_id)
        return visit_order

    def reverse_postorder_index_traversal(self):
        """Yield (parent_id, rotated, child_id, gpcsp_idx) parents-first."""
        for node_id in reversed(self.rootward_pass_traversal()):
            node = self.nodes[node_id]
            for rotated in (False, True):
                for child_id in node.get_leafward(rotated):
                    yield node_id, rotated, child_id, self.gpcsp_index_of_ids(
                        node_id, child_id
                    )

    def edge_list(self):
        """All (parent, child, rotated, gpcsp) edges, excluding rootsplit
        self-loops."""
        out = []
        for node in self.nodes:
            for rotated in (False, True):
                for child_id in node.get_leafward(rotated):
                    out.append(
                        (node.id, child_id, rotated,
                         self.gpcsp_index_of_ids(node.id, child_id))
                    )
        return out

    # -- topology counting and priors ---------------------------------------
    def _count_topologies(self):
        n = self.node_count()
        self.topology_count_below = np.ones(n)
        for node_id in self.rootward_pass_traversal():
            node = self.nodes[node_id]
            if not node.is_leaf():
                for rotated in (False, True):
                    per_rotated = sum(
                        self.topology_count_below[c]
                        for c in node.get_leafward(rotated)
                    )
                    self.topology_count_below[node_id] *= per_rotated
        self.topology_count = sum(
            self.topology_count_below[r] for r in self.rootsplit_node_ids()
        )

    def build_uniform_on_topological_support_prior(self) -> np.ndarray:
        """q(child|parent) proportional to topologies below the child
        (subsplit_dag.cpp BuildUniformOnTopologicalSupportPrior)."""
        q = np.ones(self.gpcsp_count_with_fake())
        for node_id in self.rootward_pass_traversal():
            node = self.nodes[node_id]
            if not node.is_leaf():
                for rotated in (False, True):
                    children = node.get_leafward(rotated)
                    total = sum(self.topology_count_below[c] for c in children)
                    for c in children:
                        q[self.gpcsp_index_of_ids(node_id, c)] = (
                            self.topology_count_below[c] / total
                        )
        for root_id in self.rootsplit_node_ids():
            q[self.rootsplit_index_of_id(root_id)] = (
                self.topology_count_below[root_id] / self.topology_count
            )
        return q

    def build_uniform_on_all_topologies_prior(self) -> np.ndarray:
        q = np.zeros(self.gpcsp_count_with_fake())
        for (parent_id, child_id), gpcsp_idx in self.dag_edges.items():
            if parent_id == child_id:  # rootsplit
                c0 = self.nodes[child_id].subsplit.subsplit_chunk(0).count()
                c1 = self.taxon_count - c0
            else:
                c0 = self.nodes[child_id].subsplit.subsplit_chunk(1).count()
                c1 = self.nodes[child_id].subsplit.subsplit_chunk(0).count()
            q[gpcsp_idx] = np.exp(log_child_subsplit_count_ratio(c0, c1))
        return q

    def unconditional_node_probabilities(self, normalized_sbn_parameters) -> np.ndarray:
        p = np.zeros(self.node_count())
        for root_id in self.rootsplit_node_ids():
            p[root_id] += normalized_sbn_parameters[
                self.rootsplit_index_of_id(root_id)
            ]
        for parent_id, _rot, child_id, gpcsp_idx in (
            self.reverse_postorder_index_traversal()
        ):
            p[child_id] += p[parent_id] * normalized_sbn_parameters[gpcsp_idx]
        return p

    def unconditional_subsplit_probabilities(self, normalized_sbn_parameters):
        node_probs = self.unconditional_node_probabilities(
            normalized_sbn_parameters
        )
        out = {}
        for node_id, prob in enumerate(node_probs):
            subsplit = self.nodes[node_id].subsplit
            if not subsplit.subsplit_is_fake():
                out[subsplit] = prob
        return out

    def inverted_gpcsp_probabilities(
        self, normalized_sbn_parameters, node_probabilities
    ) -> np.ndarray:
        inverted = np.ones(len(normalized_sbn_parameters))
        for parent_id, _rot, child_id, gpcsp_idx in (
            self.reverse_postorder_index_traversal()
        ):
            inverted[gpcsp_idx] = (
                node_probabilities[parent_id]
                * normalized_sbn_parameters[gpcsp_idx]
                / node_probabilities[child_id]
            )
        return inverted

    # -- expanded GPCSP indexer & pretty forms --------------------------------
    def build_gpcsp_indexer(self) -> Dict[Bitset, int]:
        indexer: Dict[Bitset, int] = {}
        for parent_id, rotated, child_id, gpcsp_idx in (
            self.reverse_postorder_index_traversal()
        ):
            parent_subsplit = self.nodes[parent_id].get_bitset(rotated)
            child_subsplit = self.nodes[child_id].subsplit
            indexer[Bitset.pcsp_of_pair(parent_subsplit, child_subsplit)] = gpcsp_idx
        for rootsplit in self.rootsplits:
            subsplit = rootsplit + ~rootsplit
            indexer[subsplit] = self.rootsplit_index_of_id(
                self.subsplit_to_id[subsplit]
            )
        return indexer

    def pretty_indexer(self) -> List[str]:
        out = [""] * self.gpcsp_count_with_fake()
        for key, idx in self.build_gpcsp_indexer().items():
            if idx < self.rootsplit_count():
                classic = min(key.subsplit_chunk(0), key.subsplit_chunk(1))
                out[idx] = classic.to_string()
            else:
                out[idx] = key.pcsp_to_string()
        return out

    # -- topology generation --------------------------------------------------
    def generate_all_topologies(self) -> List[Topology]:
        """All topologies spanned by the DAG (GenerateAllTopologies)."""
        topology_below: List[List[Topology]] = [[] for _ in range(self.node_count())]

        for node_id in self.rootward_pass_traversal():
            node = self.nodes[node_id]
            if node.is_leaf():
                topology_below[node_id] = [Topology.leaf(node_id)]
            else:
                rotated_subs: List[Topology] = []
                sorted_subs: List[Topology] = []
                for rotated in (False, True):
                    for child_id in node.get_leafward(rotated):
                        for sub in topology_below[child_id]:
                            (rotated_subs if rotated else sorted_subs).append(sub)
                topology_below[node_id] = [
                    Topology.join2(s, r) for r in rotated_subs for s in sorted_subs
                ]

        topologies: List[Topology] = []
        for root_id in self.rootsplit_node_ids():
            topologies.extend(topology_below[root_id])
        assert len(topologies) == int(self.topology_count), (
            "The realized number of topologies does not match the expected count."
        )
        # Deep-copy by rebuilding from parent vectors to avoid shared subtrees.
        final = []
        for top in topologies:
            top.polish()
            final.append(Topology.of_parent_id_vector(top.parent_id_vector()))
        return final

    # -- dense level schedules (device lowering) ------------------------------
    def level_schedules(self):
        """Rootward and leafward edge groupings by dependency level.

        Returns (rootward_levels, leafward_levels) where each level is a dict
        of int32 arrays {parent, child, rotated, gpcsp}. Rootward: a node's
        level is 1 + max over children levels (leaves at 0); an edge is
        processed at its parent's level. Leafward: a node's level is 1 + max
        over parent levels (rootsplit nodes at 0); an edge is processed at
        its child's level."""
        n = self.node_count()
        edges = self.edge_list()

        rlevel = np.zeros(n, dtype=np.int64)
        for node_id in self.rootward_pass_traversal():
            node = self.nodes[node_id]
            kids = node.leafward_sorted + node.leafward_rotated
            if kids:
                rlevel[node_id] = 1 + max(rlevel[c] for c in kids)

        llevel = np.zeros(n, dtype=np.int64)
        for node_id in self.leafward_pass_traversal():
            node = self.nodes[node_id]
            parents = node.rootward_sorted + node.rootward_rotated
            if parents:
                llevel[node_id] = 1 + max(llevel[p] for p in parents)

        def group(levels_of_edge, count):
            out = []
            for lev in range(1, count + 1):
                idx = [i for i, L in enumerate(levels_of_edge) if L == lev]
                if not idx:
                    continue
                out.append(
                    {
                        "parent": np.asarray(
                            [edges[i][0] for i in idx], dtype=np.int32
                        ),
                        "child": np.asarray(
                            [edges[i][1] for i in idx], dtype=np.int32
                        ),
                        "rotated": np.asarray(
                            [edges[i][2] for i in idx], dtype=bool
                        ),
                        "gpcsp": np.asarray(
                            [edges[i][3] for i in idx], dtype=np.int32
                        ),
                    }
                )
            return out

        rootward = group([rlevel[e[0]] for e in edges], int(rlevel.max()))
        leafward = group([llevel[e[1]] for e in edges], int(llevel.max()))
        return rootward, leafward
