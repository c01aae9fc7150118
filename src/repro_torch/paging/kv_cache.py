"""Paged KV cache: pool init, static page table, append, flat-pool decode
attention, page allocator.

Counterpart of ``src/repro/paging/kv_cache.py``. :class:`PageAllocator` is
a copy of the reference's host-side free list; :func:`linear_page_table`
the static layout of the lock-step batch path; :func:`kv_pool_specs` the
pool's logical axes for ``repro_torch.distributed.sharding``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import paged_attention


def init_paged_kv(n_layers: int, n_pages: int, page_size: int,
                  n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Zeroed KV pool ``{"k","v"}``, each ``[L, n_pages, page, Hkv, dh]``."""
    dev = resolve_device(device)
    sh = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
    return {"k": torch.zeros(sh, dtype=dtype, device=dev),
            "v": torch.zeros(sh, dtype=dtype, device=dev)}


def kv_pool_specs(n_layers: int) -> dict:
    """Logical axes of :func:`init_paged_kv`'s pool: the page dim sharded
    (the disaggregated tier), as the reference's."""
    ax = ("layers", "pages", None, "kv_heads_s", None)
    return {"k": ax, "v": ax}


def linear_page_table(batch: int, n_pages_per_seq: int, stride: int = 1,
                      device=None) -> torch.Tensor:
    """Static allocation: seq b's logical page j -> ``b * npps + (j *
    stride % npps)``, as ``int32 [batch, npps]``.

    ``j -> j * stride % npps`` is a permutation of ``[0, npps)`` only when
    ``gcd(stride, npps) == 1``; any other stride would map two logical
    pages of a sequence to one physical page, so it is rejected.
    """
    if math.gcd(stride, n_pages_per_seq) != 1:
        raise ValueError(
            f"stride={stride} is not coprime with n_pages_per_seq="
            f"{n_pages_per_seq}: j*stride % npps would collide physical "
            "pages within a sequence")
    dev = resolve_device(device)
    base = torch.arange(batch, device=dev)[:, None] * n_pages_per_seq
    j = torch.arange(n_pages_per_seq, device=dev)[None, :]
    return (base + (j * stride) % n_pages_per_seq).to(torch.int32)


def append_kv(pool: dict, layer: int, k_new: torch.Tensor,
              v_new: torch.Tensor, page_table: torch.Tensor,
              pos: int) -> dict:
    """Write one token's K/V for every sequence at position ``pos``, IN
    PLACE (the reference returns a new pool); returns ``pool``.

    ``k_new`` / ``v_new`` are ``[B, Hkv, dh]`` (cast to the pool dtype);
    pool leaves are ``[L, n_pages, page, Hkv, dh]``.
    """
    page_size = pool["k"].shape[2]
    phys = page_table[:, pos // page_size].long()            # [B]
    offset = pos % page_size
    pool["k"][layer, phys, offset] = k_new.to(pool["k"].dtype)
    pool["v"][layer, phys, offset] = v_new.to(pool["v"].dtype)
    return pool


def paged_decode_attention(q: torch.Tensor, pool: dict, layer: int,
                           page_table: torch.Tensor, lengths: torch.Tensor, *,
                           use_kernel: bool = False) -> torch.Tensor:
    """Decode attention of ``q [B,1,Hq,dh]`` against layer ``layer`` of the
    flat pool; ``page_table int32[B, npps]``, ``lengths int32[B]``."""
    return paged_attention(q, pool["k"][layer], pool["v"][layer], page_table,
                           lengths, use_kernel=use_kernel)


@dataclasses.dataclass
class PageAllocator:
    """Host-side page free-list with occupancy introspection and reuse
    seq-stamps (a copy of the reference's allocator)."""

    n_pages: int

    def __post_init__(self):
        self.free = list(range(self.n_pages - 1, -1, -1))
        self.owned: dict[int, list[int]] = {}
        self._stamp = [0] * self.n_pages
        self._next_stamp = 1

    def alloc_seq(self, seq_id: int, n: int) -> list[int]:
        if len(self.free) < n:
            raise MemoryError(f"pool exhausted: need {n}, have {len(self.free)}")
        pages = [self.free.pop() for _ in range(n)]
        self.owned.setdefault(seq_id, []).extend(pages)
        for p in pages:
            self._stamp[p] = self._next_stamp
        self._next_stamp += 1
        return pages

    def extend_seq(self, seq_id: int, n: int = 1) -> list[int]:
        return self.alloc_seq(seq_id, n)

    def free_seq(self, seq_id: int) -> int:
        pages = self.owned.pop(seq_id, [])
        self.free.extend(reversed(pages))
        return len(pages)

    def recycle(self, pages) -> int:
        """Reclaim ``pages`` from whichever sequences own them; returns the
        number reclaimed (free list extended in descending page order)."""
        want = set(int(p) for p in pages) - set(self.free)
        reclaimed = []
        for seq_id, owned in self.owned.items():
            keep = [p for p in owned if p not in want]
            reclaimed.extend(p for p in owned if p in want)
            owned[:] = keep
        self.owned = {s: o for s, o in self.owned.items() if o}
        self.free.extend(sorted(reclaimed, reverse=True))
        return len(reclaimed)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self.free)

    @property
    def free_count(self) -> int:
        return len(self.free)

    def occupancy(self) -> float:
        return self.in_use / self.n_pages

    def alive(self) -> tuple[int, ...]:
        return tuple(sorted(self.owned))

    def owner_of(self, page: int) -> int | None:
        for seq_id, pages in self.owned.items():
            if page in pages:
                return seq_id
        return None

    def stamp_of(self, page: int) -> int:
        """Allocation-generation stamp of ``page`` (0 = never allocated)."""
        return self._stamp[page]
