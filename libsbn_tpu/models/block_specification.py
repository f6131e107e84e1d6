"""Named contiguous parameter blocks.

API-parity port of /root/reference/src/block_specification.{hpp,cpp}: a map
from block name to (start, size) into one flat parameter vector, with
"entire"-prefixed keys spanning composed sub-models. In this framework
parameters natively live in pytrees; this class exists for the reference's
flat-vector interface (param matrices indexed from Python,
generic_sbn_instance.hpp:225-228) and round-trips pytree <-> flat vector.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

ENTIRE_KEY = "entire"


class BlockSpecification:
    def __init__(self, param_counts: List[Tuple[str, int]]):
        self.map: Dict[str, Tuple[int, int]] = {}
        next_available = 0
        # The reference stores blocks in a std::map, so indices are assigned
        # in sorted-key order (block_specification.hpp:78-99).
        for key, size in sorted(param_counts):
            self.map[key] = (next_available, size)
            next_available += size
        self.insert_entire_key((0, next_available))

    def get_map(self) -> Dict[str, Tuple[int, int]]:
        return self.map

    def parameter_count(self) -> int:
        return self.map[ENTIRE_KEY][1]

    def insert_entire_key(self, coords: Tuple[int, int]):
        self.map.pop(ENTIRE_KEY, None)
        self.map[ENTIRE_KEY] = coords

    def append(self, sub_entire_key: str, other: "BlockSpecification"):
        """Compose: shift other's blocks past ours; other's entire block is
        re-keyed as sub_entire_key (block_specification.cpp Append)."""
        our_count = self.parameter_count()
        for key, (start, size) in other.get_map().items():
            if key == ENTIRE_KEY:
                self.map[sub_entire_key] = (start + our_count, size)
            else:
                if key in self.map:
                    raise ValueError(f"Key {key!r} already in block specification")
                self.map[key] = (start + our_count, size)
        self.insert_entire_key((0, our_count + other.parameter_count()))

    def check_parameter_vector_size(self, v):
        if len(v) != self.parameter_count():
            raise ValueError(
                f"Parameter vector of length {len(v)}; expected "
                f"{self.parameter_count()}"
            )

    def extract_segment(self, v, key: str):
        start, size = self.map[key]
        return v[start : start + size]

    def parameter_segment_map_of(self, v) -> Dict[str, np.ndarray]:
        """Views into a flat vector (zero-copy for numpy inputs)."""
        return {key: v[start : start + size] for key, (start, size) in self.map.items()}
