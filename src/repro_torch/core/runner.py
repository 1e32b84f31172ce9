"""``TorchRunner``: real execution of the port's ``Transformer`` behind the
engine, the counterpart of ``repro.core.runner.JaxRunner``.

The decode cache is two paged pools in the model's dtype, of the shapes
``Transformer.pool_shapes`` gives: k and v ``(L, n_pages, page, KV, hd)``
for GQA, the latent ``ckv (L, n_pages, page, kv_rank)`` and the roped key
``kpe (L, n_pages, page, rope)`` for MLA. Their page ids are the engine's
``PagedAllocator`` page ids (the engine hands its allocator over with
``bind``), so the scheduler's block tables index the pools directly:
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
        self.pools = ()

    def bind(self, alloc: PagedAllocator):
        """Allocate the device pools for ``alloc``: pool page i is
        allocator page i."""
        self.pools = tuple(
            torch.zeros(shape, dtype=self.model.dtype, device=self.device)
            for shape in self.model.pool_shapes(alloc.n_pages, alloc.page_size))
        self.alloc = alloc

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    # ------------------------------------------------------------------ api
    def prefill(self, req: Request, chunk: int) -> int:
        """Whole prefill target (prompt + regenerated prefix after a
        preemption) at the completing chunk; its cache entries go into the
        pages of the request's table, which the scheduler grew to cover it.
        Returns the first token."""
        toks = req.prompt + req.output[:req.resume_extra]
        tokens = self._to_device(np.asarray([toks], np.int64))
        logits, caches = self.model.prefill(tokens)
        pos = np.arange(len(toks))
        table = np.asarray(self.alloc.table(req.rid), np.int64)
        pages = self._to_device(table[pos // self.alloc.page_size])
        slots = self._to_device(pos % self.alloc.page_size)
        for j, pool in enumerate(self.pools):
            pool[:, pages, slots] = torch.stack([c[j] for c in caches])[:, 0]
        return int(logits[0].argmax())

    def decode(self, reqs: List[Request]) -> List[int]:
        """One token for each request: the newest token sits at position
        ``context_len - 1``, and the scheduler has grown each table to
        ``context_len + 1`` tokens. Tables are padded to the batch's longest
        with page 0, a valid id never read past ``lens``."""
        tables = [self.alloc.table(r.rid) for r in reqs]
        padded = np.zeros((len(reqs), max(len(t) for t in tables)), np.int32)
        for i, t in enumerate(tables):
            padded[i, :len(t)] = t
        tokens = self._to_device(np.asarray([r.output[-1] for r in reqs], np.int64))
        positions = self._to_device(
            np.asarray([r.context_len - 1 for r in reqs], np.int64))
        logits = self.model.decode_step(tokens, positions, self.pools,
                                        self._to_device(padded))
        return logits.argmax(dim=-1).tolist()

    def release(self, req: Request):
        pass

    def iteration_time(self, prefill_tokens, decode_reqs):
        return None, {}   # real mode: the engine uses the wall clock
