"""Site-pattern compression of an alignment.

Reference: /root/reference/src/site_pattern.cpp. Unique alignment columns
become patterns with multiplicity weights; symbols A/C/G/T map to 0..3 and
every ambiguity code maps to 4 (gap), which becomes a uniform tip partial.

Unlike the reference (which keeps per-taxon symbol vectors and expands to
partials on demand), we eagerly produce the dense arrays the device kernels
want: an int8 (taxa, patterns) matrix, a float weights vector, and the
(taxa, 4, patterns) tip-partial tensor.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..io.fasta import Alignment

SYMBOL_TABLE: Dict[str, int] = {
    "A": 0, "C": 1, "G": 2, "T": 3,
    "a": 0, "c": 1, "g": 2, "t": 3,
    "-": 4, "N": 4, "X": 4, "?": 4,
    # Degenerate nucleotides treated as gaps (reference issue #162).
    "B": 4, "D": 4, "H": 4, "K": 4, "M": 4, "R": 4, "S": 4,
    "U": 4, "V": 4, "W": 4, "Y": 4,
}


def symbol_vector_of(s: str) -> List[int]:
    try:
        return [SYMBOL_TABLE[c] for c in s]
    except KeyError as e:
        raise ValueError(f"Symbol {e.args[0]!r} not known.") from None


class SitePattern:
    """Compressed site patterns for a fixed taxon numbering."""

    def __init__(self, alignment: Alignment, tag_taxon_map: Dict[Tuple[int, int], str]):
        self.alignment = alignment
        self.tag_taxon_map = dict(tag_taxon_map)
        self._compress()

    def _compress(self):
        taxon_count = len(self.tag_taxon_map)
        number_to_sequence: Dict[int, List[int]] = {}
        for (leaf_id, _), taxon in self.tag_taxon_map.items():
            number_to_sequence[leaf_id] = symbol_vector_of(self.alignment.at(taxon))
        assert sorted(number_to_sequence) == list(range(taxon_count))
        # (taxa, sites) symbol matrix.
        sym = np.array(
            [number_to_sequence[i] for i in range(taxon_count)], dtype=np.int8
        )
        # Unique columns + counts. Keep first-appearance order for determinism.
        cols = sym.T  # (sites, taxa)
        uniq, first_idx, counts = np.unique(
            cols, axis=0, return_index=True, return_counts=True
        )
        order = np.argsort(first_idx)
        self.patterns = uniq[order].T.astype(np.int8)  # (taxa, patterns)
        self.weights = counts[order].astype(np.float64)  # (patterns,)

    def pattern_count(self) -> int:
        return self.patterns.shape[1]

    def sequence_count(self) -> int:
        return self.patterns.shape[0]

    def site_count(self) -> int:
        return self.alignment.length()

    def tip_partials(self, dtype=np.float64) -> np.ndarray:
        """(taxa, 4, patterns) tip partials: one-hot for states, all-ones for
        gaps (site_pattern.cpp GetPartials)."""
        taxa, patterns = self.patterns.shape
        out = np.zeros((taxa, 4, patterns), dtype=dtype)
        for t in range(taxa):
            p = self.patterns[t]
            gap = p >= 4
            out[t, :, gap] = 1.0
            idx = np.where(~gap)[0]
            out[t, p[idx], idx] = 1.0
        return out

    def tip_states(self) -> Tuple[np.ndarray, np.ndarray]:
        """Tip-states form (fat_beagle.cpp:207-256 use_tip_states): the
        (taxa, patterns) int8 symbol codes plus the (5, 4) decode table
        (rows 0..3 one-hot, row 4 the all-ones gap partial). Stores 1
        byte/site instead of 16 (4 floats) — the engine expands partials
        on the fly inside its jitted programs, so the dense tensor never
        persists."""
        decode = np.concatenate(
            [np.eye(4), np.ones((1, 4))], axis=0
        )
        return self.patterns.copy(), decode

    @staticmethod
    def hello() -> "SitePattern":
        aln = Alignment(
            {
                "mars": "CCGAG-AGCAGCAATGGAT-GAGGCATGGCG",
                "saturn": "GCGCGCAGCTGCTGTAGATGGAGGCATGACG",
                "jupiter": "GCGCGCAGCAGCTGTGGATGGAAGGATGACG",
            }
        )
        return SitePattern(aln, {(0, 1): "mars", (1, 1): "saturn", (2, 1): "jupiter"})
