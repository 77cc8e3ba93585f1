"""Paged KV cache: device page pools + host-side page allocator.

Pool layout (per k and v): ``[num_layers, num_pages, page_size, kv_heads,
head_dim]`` — the reference's layout, one tensor for all layers so the
whole pool moves device<->host in one transfer on sleep/wake, and a
layer's pages are the view ``k_pages[l]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


@dataclass
class PagePool:
    k_pages: Optional[torch.Tensor]
    v_pages: Optional[torch.Tensor]

    @staticmethod
    def pool_shape(
        num_layers: int,
        num_pages: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
    ) -> Tuple[int, int, int, int, int]:
        """The per-direction (k or v) pool shape — the ONE definition
        shared by :meth:`create` and :meth:`estimate_nbytes`."""
        return (num_layers, num_pages, page_size, num_kv_heads, head_dim)

    @classmethod
    def estimate_nbytes(
        cls,
        num_layers: int,
        num_pages: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
    ) -> int:
        """Device bytes a :meth:`create` with these arguments allocates
        (k + v), without allocating."""
        elems = 1
        for d in cls.pool_shape(num_layers, num_pages, page_size, num_kv_heads, head_dim):
            elems *= int(d)
        return 2 * elems * dtype.itemsize

    @classmethod
    def page_nbytes(
        cls,
        num_layers: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
    ) -> int:
        """Device bytes ONE page occupies across all layers, k and v."""
        return cls.estimate_nbytes(num_layers, 1, page_size, num_kv_heads, head_dim, dtype)

    @classmethod
    def create(
        cls,
        num_layers: int,
        num_pages: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: "torch.device | str" = "cpu",
    ) -> "PagePool":
        shape = cls.pool_shape(num_layers, num_pages, page_size, num_kv_heads, head_dim)
        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
        )

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k_pages, self.v_pages))

    def as_tuple(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.k_pages, self.v_pages


class OutOfPages(Exception):
    """Page pool exhausted — the scheduler must preempt or queue."""


@dataclass
class PageAllocator:
    """Host-side free-list allocator over the pool's page indices.

    Page 0 is reserved as the null page (page tables are initialized to it),
    so sequences never alias a live page before assignment.
    """

    num_pages: int
    _free: List[int] = field(default_factory=list)
    #: monotonic mutation counter: bumps whenever the free list changes, so
    #: blocked-admission memos can key on "did anything move" exactly
    version: int = 0

    def __post_init__(self) -> None:
        if not self._free:
            self._free = list(range(self.num_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        if out:
            self.version += 1
        return out

    def free(self, pages: List[int]) -> None:
        returned = False
        for p in pages:
            if p == 0:
                continue
            self._free.append(p)
            returned = True
        if returned:
            self.version += 1

    @staticmethod
    def pages_needed(num_tokens: int, page_size: int) -> int:
        return -(-num_tokens // page_size)
