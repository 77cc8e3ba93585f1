"""Paged KV cache: device page pools + host-side page allocator.

Pool layout (per k and v): ``[num_layers, num_pages, page_size, kv_heads,
head_dim]`` — the reference's layout, one tensor for all layers so the
whole pool moves device<->host in one transfer on sleep/wake, and a
layer's pages are the view ``k_pages[l]``.

On a tensor-parallel mesh the pool is split on its kv_heads axis, as the
reference shards it (``P(None, None, None, "tp", None)``): one
``[L, pages, page_size, kv_heads/tp, head_dim]`` pair per rank, each a
contiguous allocation of its own on the rank's device. The shape and byte
helpers keep reporting the GLOBAL figures; the allocator, the page table
and the prefix cache stay single and host-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass
class PagePool:
    k_pages: Optional[torch.Tensor]
    v_pages: Optional[torch.Tensor]
    #: on a mesh: every rank's (k, v) pair in rank order, and ``k_pages``/
    #: ``v_pages`` are rank 0's; None on one device
    shards: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

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
        mesh=None,
        arenas=None,
    ) -> "PagePool":
        """A zero pool on ``device``, or with a ``mesh``
        (``parallel/mesh.py:TpMesh``) one kv_heads/tp slice per rank on the
        rank's device. With ``arenas`` (device -> ``engine/arena.py:Arena``,
        the engine's) each tensor is an allocation of its device's arena,
        at an address a sleep and wake keep."""

        def zeros(shape, d, name):
            if arenas is None:
                return torch.zeros(shape, dtype=dtype, device=d)
            return arenas[d].zeros(shape, dtype, "offload", name)

        if mesh is None:
            shape = cls.pool_shape(num_layers, num_pages, page_size, num_kv_heads, head_dim)
            return cls(k_pages=zeros(shape, device, "k_pages"), v_pages=zeros(shape, device, "v_pages"))
        if num_kv_heads % mesh.tp:
            raise ValueError(f"num_kv_heads={num_kv_heads} is not divisible by tensor_parallel_size {mesh.tp}")
        shape = cls.pool_shape(num_layers, num_pages, page_size, num_kv_heads // mesh.tp, head_dim)
        shards = [
            (zeros(shape, d, f"k_pages.{r}"), zeros(shape, d, f"v_pages.{r}"))
            for r, d in enumerate(mesh.devices)
        ]
        return cls(k_pages=shards[0][0], v_pages=shards[0][1], shards=shards)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the pool: k then v, rank by rank."""
        if self.shards is None:
            return [self.k_pages, self.v_pages]
        return [t for pair in self.shards for t in pair]

    def nbytes(self) -> int:
        """Bytes the pool holds over all ranks: the global figure."""
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def as_tuple(self) -> "Tuple[torch.Tensor, torch.Tensor] | Sequence[Tuple[torch.Tensor, torch.Tensor]]":
        """What the model's forwards take as ``cache``: the (k, v) pair, or
        on a mesh one pair per rank."""
        return (self.k_pages, self.v_pages) if self.shards is None else self.shards


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
