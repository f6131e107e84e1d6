"""GPInstance: the generalized-pruning orchestrator.

Reference: /root/reference/src/gp_instance.{hpp,cpp}. Builds the subsplit DAG
and priors from a rooted tree collection, runs coordinate-ascent branch
length estimation and SBN parameter estimation on the GP engine, and exports
trees with GP branch lengths.
"""

from __future__ import annotations

import csv as csv_mod
from typing import List, Optional

import numpy as np

from ..core.site_pattern import SitePattern
from ..core.topology import Topology
from ..core.tree import RootedTree, RootedTreeCollection
from ..io import newick
from ..io.fasta import Alignment
from ..sbn import maps as sbn_maps
from ..utils.bitset import Bitset
from .engine import GPEngine
from .quartet import quartet_hybrid_request_of
from .subsplit_dag import SubsplitDAG


class GPInstance:
    def __init__(self, mmap_file_path: str = ""):
        # mmap_file_path kept for API parity: PLVs live in device/host RAM.
        self.mmap_file_path = mmap_file_path
        self.alignment: Optional[Alignment] = None
        self.tree_collection: Optional[RootedTreeCollection] = None
        self.dag: Optional[SubsplitDAG] = None
        self.engine: Optional[GPEngine] = None

    # -- I/O ----------------------------------------------------------------
    def read_fasta_file(self, path: str):
        self.alignment = Alignment.read_fasta(path)

    def read_newick_file(self, path: str):
        tops, bls, ttm = newick.parse_newick_file(path)
        self.tree_collection = RootedTreeCollection(
            [RootedTree(t, b) for t, b in zip(tops, bls)], ttm
        )

    def read_nexus_file(self, path: str):
        tops, bls, ttm = newick.parse_nexus_file(path)
        self.tree_collection = RootedTreeCollection(
            [RootedTree(t, b) for t, b in zip(tops, bls)], ttm
        )

    # -- engine -------------------------------------------------------------
    def make_engine(
        self, rescaling_threshold: float = 1e-40, dtype=None, mesh=None
    ):
        """dtype=np.float32 trades the f64 parity precision for speed (a
        GPU runs f64 at a fraction of its f32 rate). mesh: a
        jax.sharding.Mesh with an "sp" axis shards the site-pattern axis of
        every PLV across devices (the GP multi-device path; all pattern
        reductions are weighted sums/logsumexps that XLA lowers to psums)."""
        import numpy as np

        if self.alignment is None or self.tree_collection is None:
            raise RuntimeError("Please load both fasta and newick files.")
        site_pattern = SitePattern(
            self.alignment, self.tree_collection.tag_taxon_map
        )
        self.dag = SubsplitDAG.of_tree_collection(self.tree_collection)
        sbn_prior = self.dag.build_uniform_on_topological_support_prior()
        node_probs = self.dag.unconditional_node_probabilities(sbn_prior)
        inverted = self.dag.inverted_gpcsp_probabilities(sbn_prior, node_probs)
        self.engine = GPEngine(
            site_pattern, self.dag, sbn_prior, node_probs, inverted,
            rescaling_threshold, dtype=dtype or np.float64, mesh=mesh,
        )

    def get_engine(self) -> GPEngine:
        if self.engine is None:
            raise RuntimeError(
                "Engine not available. Call make_engine to make an engine for "
                "phylogenetic likelihood computation."
            )
        return self.engine

    # -- core computations ---------------------------------------------------
    def populate_plvs(self):
        self.get_engine().populate_plvs()

    def compute_likelihoods(self):
        self.get_engine().compute_likelihoods()

    def compute_marginal_likelihood(self):
        self.compute_likelihoods()

    def estimate_branch_lengths(
        self, tol: float, max_iter: int, quiet=True, device_loop=None,
        rtol: float = 0.0,
    ):
        """Coordinate ascent: vectorized branch sweeps until the marginal
        log likelihood converges (EstimateBranchLengths).

        All edges are optimized simultaneously against frozen PLVs (Jacobi),
        which can overshoot and oscillate where the reference's sequential
        tidy-traversal (Gauss-Seidel) would not; a backtracking line search
        in log-branch-length space damps each sweep until the marginal
        improves, restoring monotone ascent.

        By default (quiet=True) the WHOLE ascent runs as one device program
        (engine.run_branch_ascent) — the host loop pays a dispatch and a
        host sync per device call. quiet=False keeps the host loop for
        per-iteration reporting; device_loop overrides."""
        engine = self.get_engine()
        if device_loop is None:
            device_loop = quiet
        if device_loop:
            marginal, iters = engine.run_branch_ascent(tol, max_iter, rtol=rtol)
            if not engine.last_ascent_converged:
                # Near-flat surfaces (e.g. signal-free alignments) converge
                # well past typical caps — measured 279 sweeps at tol=1e-4
                # on a random-100-taxon noise fixture, where real-data fits
                # take 6-12 (ROADMAP.md, findings kept, "GP flat-surface
                # convergence"). Surface the cap hit instead of silently
                # returning an unconverged fit.
                print(
                    f"WARNING: branch ascent hit max_iter={max_iter} before "
                    f"the tolerance (marginal {marginal:.6f}); raise "
                    "max_iter or pass rtol= for near-flat surfaces."
                )
            return
        engine.populate_plvs()
        engine.compute_likelihoods()
        current = engine.get_log_marginal_likelihood()
        if not quiet:
            print(f"Initial marginal log likelihood: {current:.9f}")

        def marginal_of(bl):
            engine.branch_lengths = bl
            engine.populate_plvs()
            engine.compute_likelihoods()
            return engine.get_log_marginal_likelihood()

        for i in range(max_iter):
            previous_bl = engine.branch_lengths.copy()
            engine.optimize_branch_lengths_sweep()
            proposed = engine.branch_lengths
            marginal = marginal_of(proposed)
            alpha = 1.0
            while marginal < current and alpha > 1.0 / 64:
                alpha /= 2.0
                # Zero branch lengths (e.g. zero-length edges in input trees
                # via hot start) stay zero under the geometric mix.
                # Mix in float64 regardless of engine dtype: the 1e-300
                # floor underflows to 0 in float32 (log(0) = -inf).
                damped = np.exp(
                    (1.0 - alpha)
                    * np.log(np.maximum(previous_bl.astype(np.float64), 1e-300))
                    + alpha
                    * np.log(np.maximum(proposed.astype(np.float64), 1e-300))
                )
                marginal = marginal_of(damped)
            if marginal < current:
                # No damping helped: restore and stop.
                marginal_of(previous_bl)
                if not quiet:
                    print(f"Iteration {i + 1}: no improvement; stopping.")
                break
            if not quiet:
                print(f"Iteration {i + 1}: {marginal:.9f}")
            if abs(marginal - current) < tol + rtol * abs(current):
                current = marginal
                break
            current = marginal

    def estimate_sbn_parameters(self):
        engine = self.get_engine()
        engine.populate_plvs()
        engine.compute_likelihoods()
        engine.update_sbn_probabilities()

    def calculate_hybrid_marginals(self):
        engine = self.get_engine()
        engine.populate_plvs()
        engine.process_quartet_hybrid_requests(
            quartet_hybrid_request_of(self.dag, parent_id, rotated, child_id)
            for parent_id, rotated, child_id, _ in (
                self.dag.reverse_postorder_index_traversal()
            )
        )

    def hot_start_branch_lengths(self):
        if self.engine is None:
            raise RuntimeError(
                "Please load and process some trees before calling "
                "hot_start_branch_lengths."
            )
        self.engine.hot_start_branch_lengths(
            self.tree_collection, self.dag.build_gpcsp_indexer()
        )

    # -- tree export ---------------------------------------------------------
    def _gpcsp_index_for_leaf(self, parent_subsplit: Bitset, leaf: Topology) -> int:
        return self.dag.get_gpcsp_index(
            parent_subsplit, Bitset.fake_subsplit(leaf.leaves)
        )

    def trees_with_gp_branch_lengths_of_topologies(
        self, topologies: List[Topology]
    ) -> RootedTreeCollection:
        bl_by_gpcsp = self.get_engine().branch_lengths
        trees = []
        for top in topologies:
            node_count = 2 * top.leaf_count - 1
            branch_lengths = np.zeros(node_count)

            def visit(sister, focal, child0, child1):
                parent_subsplit = sister.leaves + focal.leaves
                child_subsplit = child0.leaves + child1.leaves
                gpcsp_idx = self.dag.get_gpcsp_index(parent_subsplit, child_subsplit)
                branch_lengths[focal.id] = bl_by_gpcsp[gpcsp_idx]
                if sister.is_leaf():
                    branch_lengths[sister.id] = bl_by_gpcsp[
                        self._gpcsp_index_for_leaf(
                            parent_subsplit.rotate_subsplit(), sister
                        )
                    ]
                if child0.is_leaf():
                    branch_lengths[child0.id] = bl_by_gpcsp[
                        self._gpcsp_index_for_leaf(
                            child_subsplit.rotate_subsplit(), child0
                        )
                    ]
                if child1.is_leaf():
                    branch_lengths[child1.id] = bl_by_gpcsp[
                        self._gpcsp_index_for_leaf(child_subsplit, child1)
                    ]

            sbn_maps.rooted_pcsp_preorder(top, visit)
            trees.append(RootedTree(top, branch_lengths))
        return RootedTreeCollection(
            trees, self.tree_collection.tag_taxon_map
        )

    def generate_complete_rooted_tree_collection(self) -> RootedTreeCollection:
        return self.trees_with_gp_branch_lengths_of_topologies(
            self.dag.generate_all_topologies()
        )

    def currently_loaded_trees_with_gp_branch_lengths(self) -> RootedTreeCollection:
        return self.trees_with_gp_branch_lengths_of_topologies(
            [t.topology for t in self.tree_collection.trees]
        )

    def export_trees(self, path: str):
        """Write the loaded trees with GP branch lengths
        (GPInstance::ExportTrees, gp_instance.cpp:348-351)."""
        self.currently_loaded_trees_with_gp_branch_lengths().to_newick_file(path)

    def export_trees_with_a_pcsp(self, pcsp_string: str, path: str):
        """Loaded trees containing the PCSP, with GP branch lengths
        (GPInstance::ExportTreesWithAPCSP, gp_instance.cpp:353-362)."""
        self.currently_loaded_trees_with_a_pcsp_string_and_gp_branch_lengths(
            pcsp_string
        ).to_newick_file(path)

    def print_dag(self):
        """Print the DAG nodes (SubsplitDAG::Print, subsplit_dag.cpp:61-65)."""
        for node in self.dag.nodes:
            print(node)

    def export_all_generated_trees(self, path: str):
        """Write every DAG-spanned tree with GP branch lengths
        (gp_instance ExportAllGeneratedTrees)."""
        self.generate_complete_rooted_tree_collection().to_newick_file(path)

    def load_all_generated_trees(self):
        """Replace the loaded collection with all DAG-spanned trees."""
        self.tree_collection = self.generate_complete_rooted_tree_collection()

    def print_status(self):
        eng = self.engine
        print(
            "GPInstance: "
            f"{self.tree_collection.tree_count() if self.tree_collection else 0}"
            " trees, "
            f"{self.dag.node_count() if self.dag else 0} DAG nodes, "
            f"{self.dag.gpcsp_count_with_fake() if self.dag else 0} GPCSPs"
        )
        if eng is not None:
            plv_bytes = 6 * self.dag.node_count() * 4 * eng.patterns * 8
            print(f"PLV arena: {plv_bytes / 1e9:.3f} GB (device/host resident)")

    def currently_loaded_trees_with_a_pcsp_string_and_gp_branch_lengths(
        self, pcsp_string: str
    ) -> RootedTreeCollection:
        """Trees containing the given PCSP (gp_instance.cpp:348-362)."""
        pcsp = Bitset.of_string(pcsp_string)
        indexer = self.dag.build_gpcsp_indexer()
        if pcsp not in indexer:
            raise ValueError("Don't recognize the PCSP bitset!")
        wanted = indexer[pcsp]
        tops = []
        for tree in self.tree_collection.trees:
            rep = sbn_maps.rooted_indexer_representation_of(
                indexer_pcsp_only(indexer, self.dag), tree.topology,
                self.dag.gpcsp_count_with_fake(),
            )
            if wanted in rep:
                tops.append(tree.topology)
        return self.trees_with_gp_branch_lengths_of_topologies(tops)

    # -- pretty output --------------------------------------------------------
    def pretty_indexer(self) -> List[str]:
        return self.dag.pretty_indexer()

    def pretty_indexed_vector(self, v):
        return list(zip(self.pretty_indexer(), np.asarray(v)))

    def pretty_indexed_per_gpcsp_log_likelihoods(self):
        return self.pretty_indexed_vector(
            self.get_engine().get_per_gpcsp_log_likelihoods()
        )

    def pretty_indexed_per_gpcsp_components_of_full_log_marginal(self):
        return self.pretty_indexed_vector(
            self.get_engine().get_per_gpcsp_components_of_full_log_marginal()
        )

    def pretty_indexed_branch_lengths(self):
        return self.pretty_indexed_vector(self.get_engine().branch_lengths)

    def pretty_indexed_sbn_parameters(self):
        return self.pretty_indexed_vector(self.get_engine().q)

    def _csv_out(self, rows, path):
        with open(path, "w", newline="") as f:
            writer = csv_mod.writer(f)
            for key, value in rows:
                writer.writerow([key, value])

    def sbn_parameters_to_csv(self, path: str):
        self._csv_out(self.pretty_indexed_sbn_parameters(), path)

    def branch_lengths_to_csv(self, path: str):
        self._csv_out(self.pretty_indexed_branch_lengths(), path)

    def sbn_prior_to_csv(self, path: str):
        self._csv_out(
            self.pretty_indexed_vector(
                self.dag.build_uniform_on_topological_support_prior()
            ),
            path,
        )

    def subsplit_dag_to_dot(self, path: str, show_index_labels: bool = True):
        with open(path, "w") as f:
            f.write(dag_to_dot(self.dag, show_index_labels))


def indexer_pcsp_only(indexer, dag):
    """The GPCSP indexer restricted to PCSP-sized bitsets (for indexer
    representations of topologies, which emit rootsplit clades not expanded
    subsplits)."""
    out = {}
    for key, idx in indexer.items():
        if key.size == 3 * dag.taxon_count:
            out[key] = idx
        else:
            # Rootsplit: also key by the classic minorized clade form.
            classic = min(key.subsplit_chunk(0), key.subsplit_chunk(1))
            out[classic] = idx
    return out


def dag_to_dot(dag, show_index_labels: bool = True) -> str:
    """DOT export, byte-mirroring the reference's ToDot
    (subsplit_dag.cpp:77-119): same DepthFirstWithAction emission order
    (per rootsplit: BeforeNode, then the rotated=false clade before the
    rotated=true clade, recursing into unvisited non-leaf children before
    VisitEdge fires), same leaf-label re-emission on every edge visit,
    same header/label/color formatting, same lone closing brace."""
    out = ["digraph g {\n", "node [shape=record];\n", "edge [colorscheme=dark23];\n"]
    visited = set()

    def before_node(node_id):
        bs = dag.nodes[node_id].subsplit
        mid = str(node_id) if show_index_labels else ""
        out.append(
            f'{node_id} [label="<f0>'
            f"{bs.subsplit_chunk(0).to_index_set_string()}|<f1>{mid}|<f2>"
            f'{bs.subsplit_chunk(1).to_index_set_string()}"]\n'
        )

    def visit_edge(node_id, child_id, rotated):
        if dag.nodes[child_id].is_leaf():
            out.append(f'{child_id} [label="<f1>{child_id}"]\n')
        field = "f0" if rotated else "f2"
        edge = f'"{node_id}":{field}->"{child_id}":f1'
        if show_index_labels:
            idx = dag.gpcsp_index_of_ids(node_id, child_id)
            color = 1 if rotated else 3
            edge += f' [label="{idx}", color={color}, fontcolor={color}]'
        out.append(edge + "\n")

    def for_node(node_id):
        before_node(node_id)
        for rotated in (False, True):
            for child_id in dag.nodes[node_id].get_leafward(rotated):
                if child_id not in visited:
                    visited.add(child_id)
                    if not dag.nodes[child_id].is_leaf():
                        for_node(child_id)
                visit_edge(node_id, child_id, rotated)

    for root_id in dag.rootsplit_node_ids():
        for_node(root_id)
    out.append("}")
    return "".join(out)
