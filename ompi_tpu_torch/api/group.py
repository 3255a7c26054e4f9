"""Process groups (``ompi/group/group.c`` — ordered rank sets with set
algebra and rank translation).  Copy of ``ompi_tpu/api/group.py``."""
from __future__ import annotations

from typing import Sequence

from ompi_tpu_torch.api.errors import ErrorClass, MpiError

#: ``MPI_UNDEFINED`` (``ompi_tpu/api/status.py``)
UNDEFINED = -32766

IDENT = 0
SIMILAR = 1
UNEQUAL = 2


class Group:
    """An ordered set of world ranks (proc ids)."""

    def __init__(self, world_ranks: Sequence[int]):
        self._ranks = tuple(world_ranks)
        if len(set(self._ranks)) != len(self._ranks):
            raise MpiError(ErrorClass.ERR_GROUP, "duplicate ranks in group")

    # -- accessors -------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self._ranks)

    def rank_of(self, world_rank: int) -> int:
        """Group rank of a world proc (UNDEFINED if absent)."""
        try:
            return self._ranks.index(world_rank)
        except ValueError:
            return UNDEFINED

    def world_rank(self, group_rank: int) -> int:
        return self._ranks[group_rank]

    @property
    def world_ranks(self) -> tuple:
        return self._ranks

    def translate_ranks(self, ranks: Sequence[int], other: "Group") -> list[int]:
        out = []
        for r in ranks:
            out.append(other.rank_of(self._ranks[r]))
        return out

    def compare(self, other: "Group") -> int:
        if self._ranks == other._ranks:
            return IDENT
        if set(self._ranks) == set(other._ranks):
            return SIMILAR
        return UNEQUAL

    # -- set algebra (``MPI_Group_union`` etc.) -------------------------
    def union(self, other: "Group") -> "Group":
        seen = list(self._ranks)
        extra = [r for r in other._ranks if r not in self._ranks]
        return Group(seen + extra)

    def intersection(self, other: "Group") -> "Group":
        return Group([r for r in self._ranks if r in other._ranks])

    def difference(self, other: "Group") -> "Group":
        return Group([r for r in self._ranks if r not in other._ranks])

    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self._ranks[r] for r in ranks])

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = set(ranks)
        return Group([r for i, r in enumerate(self._ranks) if i not in drop])

    def range_incl(self, ranges: Sequence[tuple]) -> "Group":
        idx: list[int] = []
        for first, last, stride in ranges:
            idx.extend(range(first, last + (1 if stride > 0 else -1), stride))
        return self.incl(idx)

    def range_excl(self, ranges: Sequence[tuple]) -> "Group":
        idx: list[int] = []
        for first, last, stride in ranges:
            idx.extend(range(first, last + (1 if stride > 0 else -1), stride))
        return self.excl(idx)

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return f"Group({list(self._ranks)})"


GROUP_EMPTY = Group(())
