"""Bitset algebra for clades, subsplits, and PCSPs.

Reimplementation of the subsplit combinatorics of the reference
(see /root/reference/src/bitset.hpp). This layer is *host-side compile-time*
machinery: bitsets exist while building indexers and traversal schedules;
at runtime everything is dense int32 index arrays on device.

Representation: a ``Bitset`` is (size, bits) where ``bits`` is an arbitrary
precision Python int holding the bits in *string order*: bit index 0 is the
most significant position. With this encoding, integer comparison of ``bits``
coincides with the reference's lexicographic comparison on ``std::vector<bool>``
(bitset.hpp:38-44), and the "smaller binary representation" rule used to pick
child 0 of a PCSP (bitset.hpp:95-123) is plain ``<`` on ints.

Three views over the same storage (bitset.hpp:77-123):
  * clade: a plain taxon membership set;
  * subsplit: two equal-size chunks (the two sides of a tree bipartition);
  * PCSP: three equal-size chunks, sister|focal|child0.
"""

from __future__ import annotations

import functools


@functools.total_ordering
class Bitset:
    """An immutable, hashable bitset with clade/subsplit/PCSP views."""

    __slots__ = ("size", "bits")

    def __init__(self, size: int, bits: int = 0):
        if bits < 0 or (size < bits.bit_length()):
            raise ValueError(f"bits {bits} out of range for size {size}")
        object.__setattr__(self, "size", size)
        object.__setattr__(self, "bits", bits)

    def __setattr__(self, *a):  # pragma: no cover
        raise AttributeError("Bitset is immutable")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def of_string(s: str) -> "Bitset":
        return Bitset(len(s), int(s, 2) if s else 0)

    @staticmethod
    def singleton(size: int, which_on: int) -> "Bitset":
        return Bitset(size, 1 << (size - 1 - which_on))

    @staticmethod
    def of_indices(size: int, indices) -> "Bitset":
        bits = 0
        for i in indices:
            bits |= 1 << (size - 1 - i)
        return Bitset(size, bits)

    @staticmethod
    def full(size: int) -> "Bitset":
        return Bitset(size, (1 << size) - 1)

    # -- basic ops ----------------------------------------------------------
    def __getitem__(self, i: int) -> bool:
        if not 0 <= i < self.size:
            raise IndexError(i)
        return bool((self.bits >> (self.size - 1 - i)) & 1)

    def set(self, i: int) -> "Bitset":
        return Bitset(self.size, self.bits | (1 << (self.size - 1 - i)))

    def reset(self, i: int) -> "Bitset":
        return Bitset(self.size, self.bits & ~(1 << (self.size - 1 - i)))

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Bitset)
            and self.size == other.size
            and self.bits == other.bits
        )

    def __lt__(self, other: "Bitset") -> bool:
        # Lexicographic comparison; sizes equal in all reference uses.
        if self.size != other.size:
            # Fall back to genuine lexicographic comparison on the strings.
            return self.to_string() < other.to_string()
        return self.bits < other.bits

    def __hash__(self) -> int:
        return hash((self.size, self.bits))

    def __and__(self, o: "Bitset") -> "Bitset":
        return Bitset(self.size, self.bits & o.bits)

    def __or__(self, o: "Bitset") -> "Bitset":
        return Bitset(self.size, self.bits | o.bits)

    def __xor__(self, o: "Bitset") -> "Bitset":
        return Bitset(self.size, self.bits ^ o.bits)

    def __invert__(self) -> "Bitset":
        return Bitset(self.size, self.bits ^ ((1 << self.size) - 1))

    def __add__(self, o: "Bitset") -> "Bitset":
        """Concatenation, as in the reference's operator+ (bitset.hpp:50)."""
        return Bitset(self.size + o.size, (self.bits << o.size) | o.bits)

    def __repr__(self) -> str:
        return f"Bitset({self.to_string()})"

    # -- queries ------------------------------------------------------------
    def to_string(self) -> str:
        return format(self.bits, f"0{self.size}b") if self.size else ""

    def all(self) -> bool:
        return self.bits == (1 << self.size) - 1 and self.size > 0

    def any(self) -> bool:
        return self.bits != 0

    def none(self) -> bool:
        return self.bits == 0

    def count(self) -> int:
        return bin(self.bits).count("1")

    def is_singleton(self) -> bool:
        return self.bits != 0 and (self.bits & (self.bits - 1)) == 0

    def singleton_option(self):
        if not self.is_singleton():
            return None
        return self.size - 1 - self.bits.bit_length() + 1

    def indices(self):
        """Indices of set bits, ascending."""
        return [i for i in range(self.size) if self[i]]

    def to_index_set_string(self) -> str:
        return ",".join(str(i) for i in self.indices())

    def minorize(self) -> "Bitset":
        """Minimum of the bitset and its complement (bitset.hpp:66)."""
        comp = ~self
        return self if self.bits <= comp.bits else comp

    def copy_from(self, other: "Bitset", begin: int, flip: bool) -> "Bitset":
        bits = self.bits
        for i in range(other.size):
            target = begin + i
            val = (not other[i]) if flip else other[i]
            mask = 1 << (self.size - 1 - target)
            bits = (bits | mask) if val else (bits & ~mask)
        return Bitset(self.size, bits)

    # -- subsplit view ------------------------------------------------------
    def subsplit_chunk_size(self) -> int:
        assert self.size % 2 == 0, "subsplit bitset must have even size"
        return self.size // 2

    def subsplit_chunk(self, i: int) -> "Bitset":
        n = self.subsplit_chunk_size()
        shift = self.size - (i + 1) * n
        return Bitset(n, (self.bits >> shift) & ((1 << n) - 1))

    def rotate_subsplit(self) -> "Bitset":
        return self.subsplit_chunk(1) + self.subsplit_chunk(0)

    def subsplit_to_string(self) -> str:
        return self.to_string_chunked(2)

    def to_string_chunked(self, chunk_count: int) -> str:
        n = self.size // chunk_count
        s = self.to_string()
        return "|".join(s[i * n : (i + 1) * n] for i in range(chunk_count))

    def subsplit_to_index_set_string(self) -> str:
        return "|".join(
            self.subsplit_chunk(i).to_index_set_string() for i in range(2)
        )

    def subsplit_is_fake(self) -> bool:
        """Right-hand chunk all zero (bitset.hpp:92)."""
        if self.size == 0:
            return True
        return self.subsplit_chunk(1).none()

    def subsplit_union(self) -> "Bitset":
        return self.subsplit_chunk(0) | self.subsplit_chunk(1)

    # -- PCSP view ----------------------------------------------------------
    def pcsp_chunk_size(self) -> int:
        assert self.size % 3 == 0, "PCSP bitset must have size divisible by 3"
        return self.size // 3

    def pcsp_chunk(self, i: int) -> "Bitset":
        n = self.pcsp_chunk_size()
        shift = self.size - (i + 1) * n
        return Bitset(n, (self.bits >> shift) & ((1 << n) - 1))

    def pcsp_to_string(self) -> str:
        return self.to_string_chunked(3)

    def pcsp_parent(self) -> "Bitset":
        """The first two chunks: sister|focal, i.e. the parent subsplit."""
        n = self.pcsp_chunk_size()
        return Bitset(2 * n, self.bits >> n)

    def pcsp_without_parent(self) -> "Bitset":
        """The last two chunks: focal|child0."""
        n = self.pcsp_chunk_size()
        return Bitset(2 * n, self.bits & ((1 << (2 * n)) - 1))

    def pcsp_child_subsplit(self) -> "Bitset":
        """Child subsplit (child1|child0) where child1 = focal minus child0."""
        focal = self.pcsp_chunk(1)
        child0 = self.pcsp_chunk(2)
        child1 = Bitset(focal.size, focal.bits & ~child0.bits)
        return child1 + child0

    def pcsp_child_subsplit_taxon_counts(self):
        child0 = self.pcsp_chunk(2)
        focal = self.pcsp_chunk(1)
        return (child0.count(), focal.count() - child0.count())

    def pcsp_is_valid(self) -> bool:
        if self.size % 3 != 0:
            return False
        sister = self.pcsp_chunk(0)
        focal = self.pcsp_chunk(1)
        child0 = self.pcsp_chunk(2)
        # Sister and focal disjoint.
        if (sister & focal).any():
            return False
        # Child 0 must be a subset of focal.
        if (child0 & ~focal).any():
            return False
        # Something has to be set in each chunk (bitset.cpp PCSPIsValid).
        if not sister.any() or not focal.any() or not child0.any():
            return False
        return True

    def pcsp_is_fake(self) -> bool:
        """Third chunk empty: the child subsplit is a fake subsplit."""
        return self.pcsp_chunk(2).none()

    def pcsp_is_rootsplit(self) -> bool:
        return (self.pcsp_chunk(0) | self.pcsp_chunk(1)).all()

    # -- static subsplit/PCSP builders --------------------------------------
    @staticmethod
    def subsplit_of_pair(clade0: "Bitset", clade1: "Bitset") -> "Bitset":
        """Canonical subsplit of two disjoint clades: sorted so that the
        chunk with the smaller binary representation comes first... The
        reference stores subsplits via explicit construction; canonicalization
        happens at use sites via min(subsplit, rotated). We provide the common
        'sorted' convention used by SBNMaps (sbn_maps.cpp): larger chunk first
        is NOT assumed; callers choose."""
        if (clade0 & clade1).any():
            raise ValueError("subsplit chunks must be disjoint")
        return clade0 + clade1

    @staticmethod
    def child_subsplit(parent_subsplit: "Bitset", child_half: "Bitset") -> "Bitset":
        """Make the subsplit (parent_focal \\ child_half, child_half)
        (bitset.hpp:134)."""
        focal = parent_subsplit.subsplit_chunk(1)
        other = Bitset(focal.size, focal.bits & ~child_half.bits)
        if (child_half & ~focal).any():
            raise ValueError("child_half must be a subset of the parent focal clade")
        return other + child_half

    @staticmethod
    def pcsp_of_pair(
        parent_subsplit: "Bitset", child_subsplit: "Bitset", assert_validity=True
    ) -> "Bitset":
        """PCSP = sister|focal|child0 from compatible parent & child subsplits.

        The child subsplit's chunks must disjoint-union to the parent's focal
        chunk; child0 is the chunk with smaller binary representation
        (bitset.hpp:95-123).
        """
        sister = parent_subsplit.subsplit_chunk(0)
        focal = parent_subsplit.subsplit_chunk(1)
        c0 = child_subsplit.subsplit_chunk(0)
        c1 = child_subsplit.subsplit_chunk(1)
        if assert_validity:
            # Only disjoint-union is asserted (bitset.cpp PCSPOfPair): fake
            # child subsplits (leaf|0...0) are legal, e.g. in the subsplit
            # DAG's expanded GPCSP indexer.
            if (c0 & c1).any() or (c0 | c1) != focal:
                raise ValueError(
                    "child subsplit must disjoint-union to the parent focal clade"
                )
        child0 = min(c0, c1)
        return sister + focal + child0

    @staticmethod
    def fake_subsplit(nonzero_contents: "Bitset") -> "Bitset":
        """Pad on the right with zeros to double width (bitset.hpp:136)."""
        return nonzero_contents + Bitset(nonzero_contents.size, 0)

    @staticmethod
    def fake_child_subsplit(parent_subsplit: "Bitset") -> "Bitset":
        focal = parent_subsplit.subsplit_chunk(1)
        sister = parent_subsplit.subsplit_chunk(0)
        if not sister.any():
            raise ValueError("fake child subsplit requires non-empty sister")
        if not focal.is_singleton():
            raise ValueError("fake child subsplit requires singleton focal clade")
        return Bitset.fake_subsplit(focal)

    @staticmethod
    def fake_pcsp(parent_subsplit: "Bitset") -> "Bitset":
        focal = parent_subsplit.subsplit_chunk(1)
        sister = parent_subsplit.subsplit_chunk(0)
        if not sister.any():
            raise ValueError("fake PCSP requires non-empty sister")
        if not focal.is_singleton():
            raise ValueError("fake PCSP requires singleton focal clade")
        return parent_subsplit + Bitset(focal.size, 0)


def remap(bitset: Bitset, idx_table) -> Bitset:
    """Build a new bitset: entry i is bitset[idx_table[i]], or 0 for None
    (bitset.hpp:167-172). Used for taxon restriction."""
    out = Bitset(len(idx_table), 0)
    for i, idx in enumerate(idx_table):
        if idx is not None and bitset[idx]:
            out = out.set(i)
    return out
