"""ctypes bindings for the native host core (native/libsbn_native.cpp).

The shared library is built from source with `make -C native` (g++, no
dependencies) on first use in each process; make rebuilds only when a
source is newer than its library. All entry points degrade gracefully:
if the library is missing or a parse hits an unsupported construct,
callers fall back to the pure-Python implementations in io/newick.py and
ops/schedule.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# LIBSBN_TPU_NATIVE_DIR lets a pip-installed package (no repo-root native/
# sibling) point at a prebuilt native directory; unset, the source-checkout
# layout is assumed and every entry point degrades to pure Python.
_NATIVE_DIR = os.environ.get(
    "LIBSBN_TPU_NATIVE_DIR", os.path.join(_REPO_ROOT, "native")
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libsbn_native.so")

_lib = None
_load_attempted = False


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("n_trees", ctypes.c_int32),
        ("n_taxa", ctypes.c_int32),
        ("n_nodes", ctypes.c_int32),
        ("parent_vectors", ctypes.POINTER(ctypes.c_int32)),
        ("branch_lengths", ctypes.POINTER(ctypes.c_double)),
        ("taxon_names", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


def build_native(target: str = "all", native_dir: str = _NATIVE_DIR) -> bool:
    """Run ``make target`` in native_dir. The Makefile compiles each
    library under a temporary name and renames it into place, so processes
    building concurrently never load a half-written file. Returns True when
    make succeeded."""
    if not os.path.exists(os.path.join(native_dir, "Makefile")):
        return False
    try:
        subprocess.run(
            ["make", "-C", native_dir, target],
            check=True, capture_output=True, timeout=300,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    build_native()
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.lsbn_parse_newick_file.restype = ctypes.POINTER(_ParseResult)
    lib.lsbn_parse_newick_file.argtypes = [ctypes.c_char_p]
    lib.lsbn_parse_nexus_file.restype = ctypes.POINTER(_ParseResult)
    lib.lsbn_parse_nexus_file.argtypes = [ctypes.c_char_p]
    lib.lsbn_free_result.restype = None
    lib.lsbn_free_result.argtypes = [ctypes.POINTER(_ParseResult)]
    lib.lsbn_build_schedules.restype = ctypes.c_int32
    lib.lsbn_build_schedules.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ] + [ctypes.POINTER(ctypes.c_int32)] * 5
    if hasattr(lib, "lsbn_sample_topologies"):
        lib.lsbn_sample_topologies.restype = ctypes.c_int32
        lib.lsbn_sample_topologies.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(lib, "lsbn_indexer_create"):
        lib.lsbn_indexer_create.restype = ctypes.c_void_p
        lib.lsbn_indexer_create.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.lsbn_indexer_free.restype = None
        lib.lsbn_indexer_free.argtypes = [ctypes.c_void_p]
        lib.lsbn_indexer_representations.restype = ctypes.c_int32
        lib.lsbn_indexer_representations.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(lib, "lsbn_psp_create"):
        lib.lsbn_psp_create.restype = ctypes.c_void_p
        lib.lsbn_psp_create.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.lsbn_psp_free.restype = None
        lib.lsbn_psp_free.argtypes = [ctypes.c_void_p]
        lib.lsbn_psp_representations.restype = ctypes.c_int32
        lib.lsbn_psp_representations.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    _lib = lib
    return _lib


def parse_tree_file(path: str, nexus: bool):
    """Parse via the native library.

    Returns (parent_vectors (T, N-1) int32, branch_lengths (T, N) float64,
    taxon_names list) or None if the native path is unavailable/failed."""
    lib = get_lib()
    if lib is None:
        return None
    fn = lib.lsbn_parse_nexus_file if nexus else lib.lsbn_parse_newick_file
    res = fn(path.encode())
    try:
        r = res.contents
        if r.error:
            return None
        T, N = r.n_trees, r.n_nodes
        parents = np.ctypeslib.as_array(
            r.parent_vectors, shape=(T, N - 1)
        ).copy()
        bls = np.ctypeslib.as_array(r.branch_lengths, shape=(T, N)).copy()
        names = r.taxon_names.decode().split("\n") if r.taxon_names else []
        if len(names) != r.n_taxa:
            return None
        return parents, bls, names
    finally:
        lib.lsbn_free_result(res)


def build_schedules(parent_vectors: np.ndarray, n_leaves: int):
    """Batched schedules from (T, N-1) parent vectors via the native builder.

    Returns dict of arrays or None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    pv = np.ascontiguousarray(parent_vectors, dtype=np.int32)
    T, nm1 = pv.shape
    N = nm1 + 1
    n_internal = N - n_leaves
    post_node = np.empty((T, n_internal), dtype=np.int32)
    post_children = np.empty((T, n_internal, 3), dtype=np.int32)
    up_node = np.empty((T, N - 1), dtype=np.int32)
    up_parent = np.empty((T, N - 1), dtype=np.int32)
    up_sibs = np.empty((T, N - 1, 2), dtype=np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.lsbn_build_schedules(
        ptr(pv), T, N, n_leaves,
        ptr(post_node), ptr(post_children), ptr(up_node), ptr(up_parent),
        ptr(up_sibs),
    )
    if rc != 0:
        return None
    return {
        "post_node": post_node,
        "post_children": post_children,
        "up_node": up_node,
        "up_parent": up_parent,
        "up_sibs": up_sibs,
    }


def _pack_clade_words(bits_list, size: int, W: int) -> np.ndarray:
    """Pack size-bit Python-int bitsets (string order: position 0 most
    significant) into (len, W) big-endian uint64 words, so lexicographic
    word comparison in C++ matches Bitset.__lt__."""
    out = np.empty((len(bits_list), W), dtype=np.uint64)
    shift = W * 64 - size
    m64 = 0xFFFFFFFFFFFFFFFF
    for i, b in enumerate(bits_list):
        padded = b << shift
        for k in range(W):
            out[i, k] = (padded >> (64 * (W - 1 - k))) & m64
    return out


class NativeIndexerHandle:
    """Persistent C++ hash-map handle over an SBN indexer, for batched
    unrooted indexer representations of canonical parent-id vectors."""

    def __init__(self, split_items, pcsp_items, taxon_count: int):
        """split_items: [(bits, index)] for size-n rootsplit keys;
        pcsp_items: [(bits, index)] for size-3n PCSP keys."""
        lib = get_lib()
        if lib is None or not hasattr(lib, "lsbn_indexer_create"):
            raise RuntimeError("native indexer unavailable")
        self._lib = lib
        self.taxon_count = taxon_count
        n = taxon_count
        W = (n + 63) // 64
        split_keys = _pack_clade_words([b for b, _ in split_items], n, W)
        mask_n = (1 << n) - 1
        pcsp_rows = []
        for bits, _ in pcsp_items:
            chunks = [(bits >> ((2 - c) * n)) & mask_n for c in range(3)]
            pcsp_rows.append(_pack_clade_words(chunks, n, W).reshape(-1))
        pcsp_keys = (
            np.stack(pcsp_rows)
            if pcsp_rows
            else np.empty((0, 3 * W), dtype=np.uint64)
        )
        split_vals = np.asarray([i for _, i in split_items], dtype=np.int32)
        pcsp_vals = np.asarray([i for _, i in pcsp_items], dtype=np.int32)
        split_keys = np.ascontiguousarray(split_keys)
        pcsp_keys = np.ascontiguousarray(pcsp_keys)
        self._handle = lib.lsbn_indexer_create(
            split_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            split_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(split_items),
            pcsp_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            pcsp_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(pcsp_items), taxon_count,
        )

    def representations(self, parent_vectors: np.ndarray, default_index: int):
        """(T, E, R) int32 unrooted representations, or None on error."""
        pv = np.ascontiguousarray(parent_vectors, dtype=np.int32)
        T, nm1 = pv.shape
        n_nodes = nm1 + 1
        E = n_nodes - 1
        R = self.taxon_count - 1
        out = np.empty((T, E, R), dtype=np.int32)
        rc = self._lib.lsbn_indexer_representations(
            self._handle,
            pv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            T, n_nodes, default_index,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out if rc == 0 else None

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.lsbn_indexer_free(handle)


class NativePSPHandle:
    """Persistent C++ hash-map handle for PSP branch representations of
    canonical parent-id vectors (psp_indexer.cpp RepresentationOf)."""

    def __init__(self, split_items, subsplit_items, taxon_count: int):
        """split_items: [(bits, index)] size-n rootsplit keys; subsplit_items:
        [(bits, index)] size-2n focal|min-child subsplit keys."""
        lib = get_lib()
        if lib is None or not hasattr(lib, "lsbn_psp_create"):
            raise RuntimeError("native PSP indexer unavailable")
        self._lib = lib
        self.taxon_count = taxon_count
        n = taxon_count
        W = (n + 63) // 64
        split_keys = np.ascontiguousarray(
            _pack_clade_words([b for b, _ in split_items], n, W)
        )
        mask_n = (1 << n) - 1
        rows = []
        for bits, _ in subsplit_items:
            chunks = [(bits >> n) & mask_n, bits & mask_n]
            rows.append(_pack_clade_words(chunks, n, W).reshape(-1))
        sub_keys = np.ascontiguousarray(
            np.stack(rows) if rows else np.empty((0, 2 * W), dtype=np.uint64)
        )
        split_vals = np.asarray([i for _, i in split_items], dtype=np.int32)
        sub_vals = np.asarray([i for _, i in subsplit_items], dtype=np.int32)
        self._handle = lib.lsbn_psp_create(
            split_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            split_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(split_items),
            sub_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            sub_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(subsplit_items), taxon_count,
        )

    def representations(self, parent_vectors: np.ndarray, sentinel: int):
        """(T, 3, E) int32 PSP rows [rootsplit, down, up], or None."""
        pv = np.ascontiguousarray(parent_vectors, dtype=np.int32)
        T, nm1 = pv.shape
        n_nodes = nm1 + 1
        out = np.empty((T, 3, n_nodes - 1), dtype=np.int32)
        rc = self._lib.lsbn_psp_representations(
            self._handle,
            pv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            T, n_nodes, sentinel,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out if rc == 0 else None

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.lsbn_psp_free(handle)


def sample_topologies(probs, root_tab, child_tab, n_taxa: int,
                      n_samples: int, seed: int, rooted: bool):
    """Sample SBN topologies natively; returns (n_samples, n_nodes-1) int32
    canonical parent-id vectors or None if unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "lsbn_sample_topologies"):
        return None
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    root_tab = np.ascontiguousarray(root_tab, dtype=np.int32)
    child_tab = np.ascontiguousarray(child_tab, dtype=np.int32)
    n_nodes = 2 * n_taxa - 1 if rooted else 2 * n_taxa - 2
    out = np.empty((n_samples, n_nodes - 1), dtype=np.int32)
    rc = lib.lsbn_sample_topologies(
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        root_tab.shape[0],
        root_tab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        child_tab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        child_tab.shape[0], n_taxa, n_samples,
        ctypes.c_uint64(seed & (2**64 - 1)), int(rooted),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return out
