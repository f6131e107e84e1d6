"""Generic SBN instance: the user-facing orchestrator.

Mirrors the API surface of the reference's GenericSBNInstance
(generic_sbn_instance.hpp) and its pybind bindings (pylibsbn.cpp): load
trees, build the SBN support, train SA/EM, sample topologies, compute
probabilities, and drive the phylogenetic likelihood engine.

Differences from the reference: sbn_parameters is a numpy array lowered to device
arrays at call sites; likelihood calls batch the whole tree collection into
one jitted program (no thread_count: parallelism is vmap + device sharding).
"""

from __future__ import annotations

import csv as csv_mod
from typing import Dict, List, Optional

import numpy as np

from ..core.site_pattern import SitePattern
from ..core.topology import Topology
from ..io import newick
from ..io.fasta import Alignment
from ..models.engine import LikelihoodEngine
from ..models.phylo_model import (
    PhyloModelSpec,
    block_specification,
    default_parameters,
    flat_from_parameters,
    parameters_from_flat,
)
from ..ops import schedule as schedule_ops
from ..sbn import probability as sbn_probability
from ..sbn import sampling
from ..sbn.support import PSPIndexer

DOUBLE_MINIMUM = -np.finfo(np.float64).max


class GenericSBNInstance:
    support_class = None  # set by subclasses
    collection_class = None
    rooted = True

    def __init__(self, name: str = "libsbn_tpu"):
        self.name = name
        self.tree_collection = None
        self.alignment: Optional[Alignment] = None
        self.topology_counter = {}
        self.sbn_support = self.support_class()
        self.sbn_parameters = np.zeros(0)
        self.psp_indexer = PSPIndexer()
        self.engine: Optional[LikelihoodEngine] = None
        self.phylo_model_spec: Optional[PhyloModelSpec] = None
        self.phylo_model_params: Dict = {}
        self.phylo_model_params_matrix: Optional[np.ndarray] = None
        self.rescaling = True
        self._sampler: Optional[sampling.SBNSampler] = None
        self._seed = 0

    # -- I/O ----------------------------------------------------------------
    def read_newick_file(self, path: str):
        tops, bls, ttm = newick.parse_newick_file(path)
        self._set_trees(tops, bls, ttm)

    def read_nexus_file(self, path: str):
        tops, bls, ttm = newick.parse_nexus_file(path)
        self._set_trees(tops, bls, ttm)

    def read_fasta_file(self, path: str):
        self.alignment = Alignment.read_fasta(path)

    def _set_trees(self, tops, bls, ttm):
        trees = [
            self.collection_class.tree_class(t, b) for t, b in zip(tops, bls)
        ]
        self.tree_collection = self.collection_class(trees, ttm)

    def tree_count(self) -> int:
        return self.tree_collection.tree_count() if self.tree_collection else 0

    def taxon_names(self) -> List[str]:
        return self.tree_collection.taxon_names()

    # -- SBN support & training ---------------------------------------------
    def process_loaded_trees(self):
        self._check_trees_loaded()
        self.topology_counter = self.tree_collection.topology_counter()
        self.sbn_support = self.support_class(
            self.topology_counter, self.tree_collection.taxon_names()
        )
        self.sbn_parameters = np.ones(self.sbn_support.gpcsp_count)
        self.psp_indexer = self.sbn_support.build_psp_indexer()
        self._sampler = None

    def train_simple_average(self):
        self._check_support()
        reps, counts = self._dense_counter()
        # Writable copy: the reference exposes sbn_parameters as a mutable
        # zero-copy view (pylibsbn.cpp:28-48) that vip's optimizer writes
        # through; np.asarray of a jax array would be read-only.
        self.sbn_parameters = np.array(
            sbn_probability.simple_average(
                reps, counts, self.sbn_support.gpcsp_count
            )
        )
        self._sampler = None

    def _dense_counter(self):
        tops = list(self.topology_counter.keys())
        counts = np.asarray(
            [self.topology_counter[t] for t in tops], dtype=np.float64
        )
        reps = self.sbn_support.dense_representations(tops)
        return reps, counts

    def calculate_sbn_probabilities(self) -> np.ndarray:
        self._check_support()
        seg = self.sbn_support.segment_ids()
        num_segments = int(seg.max(initial=0)) + 1
        normalized = sbn_probability.probability_normalize_in_log(
            np.asarray(self.sbn_parameters), seg, num_segments
        )
        reps = self.sbn_support.dense_representations(
            [t.topology for t in self.tree_collection.trees]
        )
        if self.rooted:
            return np.asarray(
                sbn_probability.probability_of_rooted_collection(normalized, reps)
            )
        return np.asarray(
            sbn_probability.probability_of_unrooted_collection(normalized, reps)
        )

    def make_indexer_representations(self):
        return [
            self.sbn_support.indexer_representation_of(t.topology)
            for t in self.tree_collection.trees
        ]

    def pretty_indexer(self) -> List[str]:
        return self.sbn_support.pretty_indexer()

    def normalized_sbn_parameters(self) -> np.ndarray:
        seg = self.sbn_support.segment_ids()
        num_segments = int(seg.max(initial=0)) + 1
        return np.exp(
            np.asarray(
                sbn_probability.probability_normalize_in_log(
                    np.asarray(self.sbn_parameters), seg, num_segments
                )
            )
        )

    def pretty_indexed_sbn_parameters(self):
        return list(zip(self.pretty_indexer(), self.normalized_sbn_parameters()))

    # -- SBN parameter CSV round trip ----------------------------------------
    def sbn_parameters_to_csv(self, path: str):
        with open(path, "w", newline="") as f:
            writer = csv_mod.writer(f)
            for key, value in sorted(self.pretty_indexed_sbn_parameters()):
                writer.writerow([key, value])

    def set_sbn_parameters(self, pretty_map: Dict[str, float], warn_missing=True):
        """Linear-space probabilities keyed by pretty GPCSP strings
        (generic_sbn_instance.hpp SetSBNParameters)."""
        pretty = self.pretty_indexer()
        missing = 0
        out = np.empty(len(pretty))
        for i, key in enumerate(pretty):
            if key not in pretty_map:
                out[i] = DOUBLE_MINIMUM
                missing += 1
            else:
                v = pretty_map[key]
                if v > 0:
                    out[i] = np.log(v)
                elif v == 0:
                    out[i] = DOUBLE_MINIMUM
                else:
                    raise ValueError(
                        "Negative probability encountered in set_sbn_parameters; "
                        "probabilities must be in linear space."
                    )
        if warn_missing and missing:
            print(
                f"Warning: when setting SBN parameters, {missing} were in the "
                "support but not specified; these were set to log-zero."
            )
        self.sbn_parameters = out
        self._sampler = None

    def read_sbn_parameters_from_csv(self, path: str):
        m = {}
        with open(path) as f:
            for row in csv_mod.reader(f):
                if len(row) >= 2:
                    m[row[0]] = float(row[1])
        self.set_sbn_parameters(m)

    # -- sampling ------------------------------------------------------------
    def set_seed(self, seed: int):
        self._seed = seed
        if self._sampler is not None:
            self._sampler.set_seed(seed)

    def _get_sampler(self) -> sampling.SBNSampler:
        if self._sampler is None:
            self._sampler = sampling.SBNSampler(
                self.sbn_support, self.sbn_parameters, self._seed
            )
        return self._sampler

    def sample_topology(self) -> Topology:
        self._check_support()
        return self._get_sampler().sample_topology(self.rooted)

    # -- phylogenetic likelihood ---------------------------------------------
    def prepare_for_phylo_likelihood(
        self, spec: PhyloModelSpec, thread_count: int = 1, beagle_flags=(),
        use_tip_states: bool = False, tree_count_option: Optional[int] = None,
        rescaling: bool = True,
    ):
        """Create the likelihood engine. Argument order matches the reference
        binding (pylibsbn.cpp:196-199). thread_count and beagle_flags are
        accepted for API parity but ignored: batching replaces the executor
        pool and there is no BEAGLE (§2.9). use_tip_states selects the
        1-byte resident tip-code mode (bit-identical results; the default
        here is tip partials)."""
        self._check_trees_loaded()
        if self.alignment is None:
            raise RuntimeError("Please read a FASTA file first.")
        site_pattern = SitePattern(
            self.alignment, self.tree_collection.tag_taxon_map
        )
        self.phylo_model_spec = spec
        self.phylo_model_params = default_parameters(spec)
        self.engine = LikelihoodEngine(
            site_pattern, spec, rescale=rescaling,
            use_tip_states=use_tip_states,
        )
        # The parameter matrix is created lazily (get_phylo_model_params /
        # resize_phylo_model_params): direct pytree users never pay for it.
        self.phylo_model_params_matrix = None
        if tree_count_option is not None:
            self.resize_phylo_model_params(tree_count_option)
        return self.engine

    def get_phylo_model_block_specification(self):
        return block_specification(self.phylo_model_spec)

    def set_phylo_model_params_from_flat(self, v):
        self.phylo_model_params = parameters_from_flat(self.phylo_model_spec, v)
        self.phylo_model_params_matrix = None

    # -- per-tree parameter matrix (GetPhyloModelParams /
    # GetPhyloModelParamBlockMap / ResizePhyloModelParams,
    # generic_sbn_instance.hpp:221-270). The reference hands Python a
    # mutable Eigen matrix with one row per tree plus named column-block
    # views; here the matrix is a plain numpy array (rows users edit in
    # place) synced to parameter pytrees at compute time.
    def resize_phylo_model_params(self, tree_count_option: Optional[int] = None):
        if self.phylo_model_spec is None:
            raise RuntimeError(
                "Please call prepare_for_phylo_likelihood to make an engine "
                "before resizing the parameter matrix."
            )
        count = (
            tree_count_option
            if tree_count_option is not None
            else self.tree_collection.tree_count()
        )
        row = flat_from_parameters(self.phylo_model_spec, self.phylo_model_params)
        mat = np.tile(row, (count, 1))
        old = getattr(self, "phylo_model_params_matrix", None)
        if old is not None and old.shape[1] == mat.shape[1]:
            keep = min(count, old.shape[0])
            mat[:keep] = old[:keep]
        self.phylo_model_params_matrix = mat
        return mat

    def get_phylo_model_params(self) -> np.ndarray:
        if getattr(self, "phylo_model_params_matrix", None) is None:
            self.resize_phylo_model_params()
        return self.phylo_model_params_matrix

    def get_phylo_model_param_block_map(self) -> Dict[str, np.ndarray]:
        """Named mutable column-block views of the parameter matrix."""
        mat = self.get_phylo_model_params()
        bs = block_specification(self.phylo_model_spec)
        return {
            key: mat[:, start : start + size]
            for key, (start, size) in bs.get_map().items()
        }

    def _compute_params(self):
        """(params, per_tree): the pytree the engine should see. With a
        parameter matrix whose rows differ, every leaf gains a leading
        tree axis (the reference evaluates param_matrix.row(i) per tree,
        fat_beagle.hpp:144)."""
        mat = getattr(self, "phylo_model_params_matrix", None)
        if mat is None:
            return self.phylo_model_params, False
        B = self.tree_collection.tree_count()
        if mat.shape[0] < B:
            raise ValueError(
                f"Parameter matrix has {mat.shape[0]} rows < {B} trees; "
                "call resize_phylo_model_params."
            )
        if np.all(mat[:B] == mat[0]):
            self.phylo_model_params = parameters_from_flat(
                self.phylo_model_spec, mat[0]
            )
            return self.phylo_model_params, False
        import jax

        rows = [
            parameters_from_flat(self.phylo_model_spec, mat[i])
            for i in range(B)
        ]
        import jax.numpy as jnp

        return jax.tree.map(lambda *xs: jnp.stack(xs), *rows), True

    def set_rescaling(self, rescaling: bool):
        if self.engine is not None:
            self.engine.rescale = rescaling
            self.engine._jit_cache = {}
        self.rescaling = rescaling

    def _get_engine(self) -> LikelihoodEngine:
        if self.engine is None:
            raise RuntimeError(
                "Engine not available. Call prepare_for_phylo_likelihood first."
            )
        return self.engine

    def _batched_schedule(self):
        return schedule_ops.schedules_of_topologies(
            [t.topology for t in self.tree_collection.trees]
        )

    def branch_length_matrix(self) -> np.ndarray:
        return self.tree_collection.branch_length_matrix()


    def print_status(self):
        """Summary print (generic_sbn_instance.hpp PrintStatus)."""
        tree_count = self.tree_count()
        print(
            f"{self.name} instance: {tree_count} trees, "
            f"{self.sbn_support.gpcsp_count} GPCSPs in support"
        )

    def string_indexer_representation_of(self, topology, out_of_sample_index=None):
        from ..sbn import maps

        rep = self.sbn_support.indexer_representation_of(
            topology, out_of_sample_index
        )
        reversed_indexer = self.pretty_indexer()
        return maps.string_indexer_representation_of(reversed_indexer, rep)

    # -- checks ---------------------------------------------------------------
    def _check_trees_loaded(self):
        if self.tree_collection is None or not self.tree_collection.trees:
            raise RuntimeError("Please load some trees into your SBN instance.")

    def _check_support(self):
        if self.sbn_support.empty():
            raise RuntimeError(
                "Please call process_loaded_trees to prepare your SBN support."
            )
