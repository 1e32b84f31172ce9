"""Paged KV-cache manager (vLLM-style, block size 16 — paper §II-C/§III-A).

Pure host-side page accounting shared by the real-execution and simulated
engines: allocation, per-request page tables, utilisation/fragmentation
telemetry, and a prefix-reuse hook. Device-side paged storage is the pool
of ``repro_torch.core.runner.TorchRunner``, indexed by these page ids and
read by the CUDA paged-attention kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class PagedAllocator:
    n_pages: int
    page_size: int = 16

    def __post_init__(self):
        self._free: List[int] = list(range(self.n_pages))[::-1]
        self._tables: Dict[int, List[int]] = {}
        self._used_tokens: Dict[int, int] = {}
        self.peak_used_pages = 0
        # event spine (repro.trace): the owning engine wires its emitter in
        # so every page movement is on the stream (kv_alloc / kv_free)
        self.emitter = None

    # ---- queries ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def utilization(self) -> float:
        """Fraction of page pool allocated (the paper's 'Aggregated KV
        Cache Util.')."""
        return self.used_pages / self.n_pages if self.n_pages else 0.0

    def internal_fragmentation(self) -> float:
        """Allocated-but-unused token slots / allocated slots ('stranded
        capacity' inside pages)."""
        cap = self.used_pages * self.page_size
        if cap == 0:
            return 0.0
        used = sum(self._used_tokens.values())
        return 1.0 - used / cap

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def table(self, rid: int) -> List[int]:
        return self._tables.get(rid, [])

    def tokens_of(self, rid: int) -> int:
        return self._used_tokens.get(rid, 0)

    # ---- mutation ---------------------------------------------------------
    def grow(self, rid: int, new_total_tokens: int) -> bool:
        """Ensure rid has pages for new_total_tokens; False if pool exhausted
        (caller must preempt). All-or-nothing: a failed grow leaves no
        table entry behind for a rid that had none."""
        have = self._tables.get(rid, [])
        need = self.pages_for(new_total_tokens) - len(have)
        if need > len(self._free):
            return False
        for _ in range(max(need, 0)):
            have.append(self._free.pop())
        self._tables[rid] = have
        self._used_tokens[rid] = new_total_tokens
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        if need > 0 and self.emitter is not None:
            self.emitter.emit("kv_alloc", rid=rid, pages=need,
                              held=len(have), tokens=new_total_tokens)
        return True

    def free(self, rid: int) -> int:
        pages = self._tables.pop(rid, [])
        self._free.extend(pages)
        self._used_tokens.pop(rid, None)
        if pages and self.emitter is not None:
            self.emitter.emit("kv_free", rid=rid, pages=len(pages))
        return len(pages)

    def reset(self):
        self.__post_init__()


@dataclasses.dataclass(frozen=True)
class KVView:
    """Frozen, read-only snapshot of a :class:`PagedAllocator` — the KV leg
    of the decision plane (see ``repro.cluster.view``).

    Carries exactly what capacity/headroom decisions need (pool size, page
    geometry, current occupancy) and the pure ``pages_for`` arithmetic, so
    admission budgets, routing feasibility and rebalancing all compute
    headroom from one snapshot instead of scraping allocator internals.
    Duck-type-compatible with the allocator for ``AdmissionPolicy.admit``
    (which reads only ``n_pages`` / ``free_pages`` / ``pages_for``)."""
    n_pages: int
    page_size: int
    used_pages: int
    free_pages: int

    @classmethod
    def of(cls, alloc: "PagedAllocator") -> "KVView":
        return cls(n_pages=alloc.n_pages, page_size=alloc.page_size,
                   used_pages=alloc.used_pages, free_pages=alloc.free_pages)

    @property
    def capacity_tokens(self) -> int:
        """Structural pool capacity: every page filled to the brim."""
        return self.n_pages * self.page_size

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def utilization(self) -> float:
        return self.used_pages / self.n_pages if self.n_pages else 0.0


def kv_pages_needed(cfg, tokens: int, page_size: int = 16) -> int:
    """Pages needed for `tokens` of context (token-granular; all layers share
    a page table as in vLLM's per-layer parallel allocation)."""
    return -(-tokens // page_size)
