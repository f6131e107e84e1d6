"""libsbn_tpu: phylogenetic variational inference in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of
phylovi/libsbn (subsplit Bayes networks, variational Bayesian phylogenetic
inference, generalized pruning):

  * tree topologies compile to dense index schedules; likelihoods and
    gradients run as batched, jitted Felsenstein pruning over device-resident
    partial likelihood vectors;
  * thousands of trees evaluate per launch via vmap instead of the
    reference's one-thread-per-tree model;
  * multi-device scaling uses jax.sharding meshes with XLA collectives.

Double precision is enabled at import because the parity targets of the
reference demand 1e-6..1e-12 agreement; throughput paths pass float32
explicitly.
"""

import os as _os

from jax import config as _jax_config

_jax_config.update("jax_enable_x64", True)

# A GPU may run float32 matrix products in TF32 (about three decimal
# digits), which loses far more of the log-likelihood than the pybeagle
# parity gate allows (docs/parity_map.md precision policy). Every
# einsum/dot in the likelihood, gradient, GP and VI paths therefore runs
# at full float32 precision.
_jax_config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache: deep subsplit-DAG programs take long to
# compile cold. JAX_COMPILATION_CACHE_DIR, when set, is honoured by JAX
# itself; otherwise the cache lives at a fixed path inside the checkout.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax_config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
# Only cache the expensive programs (deep GP DAGs, big training steps):
# caching every small test program churns disk.
_jax_config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

__version__ = "0.1.0"

from .instance import RootedInstance, UnrootedInstance  # noqa: E402
from .instance.rooted import ratio_gradient_of_height_gradient  # noqa: E402
from .gp.instance import GPInstance  # noqa: E402
from .models.phylo_model import PhyloModelSpec  # noqa: E402
from .core.tree import (  # noqa: E402
    RootedTree,
    RootedTreeCollection,
    UnrootedTree,
    UnrootedTreeCollection,
)
from .sbn.support import PSPIndexer  # noqa: E402

# Reference-exact module names (pylibsbn.cpp:177,269,383,130): a pylibsbn
# user's `libsbn.unrooted_instance(...)` / `libsbn.PhyloModelSpecification(
# substitution=..., site=..., clock=...)` works verbatim against this
# package (PhyloModelSpec is a dataclass with the same three fields in the
# same positional order).
rooted_instance = RootedInstance
unrooted_instance = UnrootedInstance
gp_instance = GPInstance
PhyloModelSpecification = PhyloModelSpec

__all__ = [
    "RootedInstance",
    "UnrootedInstance",
    "GPInstance",
    "PhyloModelSpec",
    "PhyloModelSpecification",
    "rooted_instance",
    "unrooted_instance",
    "gp_instance",
    "RootedTree",
    "RootedTreeCollection",
    "UnrootedTree",
    "UnrootedTreeCollection",
    "PSPIndexer",
    "ratio_gradient_of_height_gradient",
    "__version__",
]
