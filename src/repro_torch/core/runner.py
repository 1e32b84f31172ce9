"""``TorchRunner``: real execution of the port's ``Transformer`` behind the
engine, the counterpart of ``repro.core.runner.JaxRunner``.

The KV cache is a paged pool ``k_pool``/``v_pool`` of shape
``(L, n_pages, page, KV, hd)`` in the model's dtype. Its page ids are the
engine's ``PagedAllocator`` page ids (the engine hands its allocator over
with ``bind``), so the scheduler's block tables index the pool directly:
there are no slots and nothing to free on the device — the allocator frees
a request's pages on preemption and on finish.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.kv_cache import PagedAllocator
from repro_torch.core.request import Request
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer


class TorchRunner:
    def __init__(self, model: Transformer, *, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, runner on {self.device}")
        self.model = model
        self.alloc = None
        self.k_pool = self.v_pool = None

    def bind(self, alloc: PagedAllocator):
        """Allocate the device pool for ``alloc``: pool page i is allocator
        page i."""
        cfg = self.model.cfg
        shape = (cfg.n_layers, alloc.n_pages, alloc.page_size,
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.model.dtype,
                                  device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.alloc = alloc

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    # ------------------------------------------------------------------ api
    def prefill(self, req: Request, chunk: int) -> int:
        """Whole prefill target (prompt + regenerated prefix after a
        preemption) at the completing chunk; its k/v go into the pages of
        the request's table, which the scheduler grew to cover it. Returns
        the first token."""
        toks = req.prompt + req.output[:req.resume_extra]
        tokens = self._to_device(np.asarray([toks], np.int64))
        logits, ks, vs = self.model.prefill(tokens)
        pos = np.arange(len(toks))
        table = np.asarray(self.alloc.table(req.rid), np.int64)
        pages = self._to_device(table[pos // self.alloc.page_size])
        slots = self._to_device(pos % self.alloc.page_size)
        self.k_pool[:, pages, slots] = torch.stack(ks)[:, 0]
        self.v_pool[:, pages, slots] = torch.stack(vs)[:, 0]
        return int(logits[0].argmax())

    def decode(self, reqs: List[Request]) -> List[int]:
        """One token for each request: the newest token sits at position
        ``context_len - 1``, and the scheduler has grown each table to
        ``context_len + 1`` tokens. Tables are padded to the batch's longest
        with page 0, a valid id the kernel never reads past ``lens``."""
        tables = [self.alloc.table(r.rid) for r in reqs]
        padded = np.zeros((len(reqs), max(len(t) for t in tables)), np.int32)
        for i, t in enumerate(tables):
            padded[i, :len(t)] = t
        tokens = self._to_device(np.asarray([r.output[-1] for r in reqs], np.int64))
        positions = self._to_device(
            np.asarray([r.context_len - 1 for r in reqs], np.int64))
        logits = self.model.decode_step(tokens, positions, self.k_pool,
                                        self.v_pool, self._to_device(padded))
        return logits.argmax(dim=-1).tolist()

    def release(self, req: Request):
        pass

    def iteration_time(self, prefill_tokens, decode_reqs):
        return None, {}   # real mode: the engine uses the wall clock
