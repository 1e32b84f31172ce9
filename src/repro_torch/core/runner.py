"""Model runners behind the engine.

``SimRunner``   — advances a virtual clock with the analytical perf model
                  (a copy of ``repro.core.runner.SimRunner``; H200 constants
                  reproduce the paper's figures, v5e constants drive TPU
                  planning, H100 constants predict the port's card).
``TorchRunner`` — real execution of the port's ``Transformer``, the
                  counterpart of ``repro.core.runner.JaxRunner``, on one
                  device or, as one controller, over a mesh's ranks.

The paged-accounting layer in the scheduler is identical in both modes.
``TorchRunner``'s decode cache is paged pools in the model's dtype, of the shapes
``Transformer.pool_shapes`` gives: k and v ``(L, n_pages, page, KV, hd)``
for GQA (L the shared block's groups in a hybrid), the latent
``ckv (L, n_pages, page, kv_rank)`` and the roped key
``kpe (L, n_pages, page, rope)`` for MLA, none for xLSTM. Their page ids
are the engine's ``PagedAllocator`` page ids (the engine hands its
allocator over with ``bind``), so the scheduler's block tables index the
pools directly; the allocator frees a request's pages on preemption and on
finish. A model with recurrent state (the hybrid and ssm families) also
has the buffers of ``Transformer.state_shapes`` with one slot per running
sequence, as ``JaxRunner``'s slots: prefill takes a free slot and writes
the request's fresh state there, decode reads and writes the batch's
slots, and ``release`` (on finish and on preemption) returns the slot, so
a resumed request recomputes its state from its prompt and output.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import perf_model as pm
from repro_torch.core.kv_cache import PagedAllocator
from repro_torch.core.request import Request
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer


class SimRunner:
    """Virtual-clock runner: returns iteration latencies, emits dummy tokens."""

    def __init__(self, cfg: ModelConfig, plan: pm.ParallelismPlan,
                 hw: pm.Hardware, dtype_bytes: int = 2):
        self.cfg = cfg
        self.plan = plan
        self.hw = hw
        self.dtype_bytes = dtype_bytes

    def iteration_time(self, prefill_tokens: int, decode_reqs: List[Request]
                       ) -> Tuple[float, Dict[str, float]]:
        cfg, plan, hw = self.cfg, self.plan, self.hw
        parts = {"compute": 0.0, "memory": 0.0, "comm": 0.0}
        t = 0.0
        if prefill_tokens:
            p = pm.prefill_step_time(cfg, prefill_tokens, plan, hw,
                                     self.dtype_bytes)
            t += p["total"]
            for k in parts:
                parts[k] += p[k]
        if decode_reqs:
            mean_ctx = float(np.mean([r.context_len for r in decode_reqs]))
            d = pm.decode_step_time(cfg, len(decode_reqs), mean_ctx, plan, hw,
                                    self.dtype_bytes)
            bubble = pm.pp_bubble_factor(cfg, plan, hw, len(decode_reqs),
                                         mean_ctx, self.dtype_bytes)
            t += d["total"] * bubble \
                + pm.pp_transport_time(cfg, len(decode_reqs), plan, hw,
                                       self.dtype_bytes)
            for k in parts:
                parts[k] += d[k]
        return t, parts

    def prefill(self, req: Request, chunk: int) -> int:
        return 0   # dummy token id

    def decode(self, reqs: List[Request]) -> List[int]:
        return [0] * len(reqs)

    def release(self, req: Request):
        pass

    def hbm_busy_fraction(self, parts: Dict[str, float], t: float) -> float:
        return min(parts["memory"] / t, 1.0) if t > 0 else 0.0


class TorchRunner:
    """Real execution of ``model``. Under a mesh (``model.ctx``; the
    reference's ``JaxRunner`` with a mesh ctx) it is a single controller:
    the rank at "model" coordinate 0 leads, runs the engine and its
    allocator, and broadcasts each call's work (the pool's size, prefill
    tokens with their pages and state slot, decode tokens with their
    positions, block tables and slots) to the other ranks, which
    ``follow``: each runs the same model calls on its shard, on a pool of
    its own kv heads indexed by the leader's page ids and on state buffers
    of its own (a Mamba2 rank's heads) indexed by the leader's slot ids.
    Meshes with "data" > 1 are refused (a later slice: each data rank
    would need its own engine or its batch's rows), and so is a decode
    cache cut along the sequence (``seq_shard_decode``). Of the other §Perf
    levers ``seq_parallel_norm`` cuts its prefill's residual stream, and
    ``decode_unroll`` changes nothing (the decode step already runs layer
    by layer and writes pages in place); ``serve_2d_tp`` and
    ``moe_ff_shard`` act only across "data"."""

    def __init__(self, model: Transformer, *, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, runner on {self.device}")
        ctx = model.ctx
        if ctx.mesh is not None and ctx.dp > 1:
            raise NotImplementedError(
                f"TorchRunner under a mesh with data = {ctx.dp}: the runner "
                "takes meshes with data == 1 (data > 1 is a later slice)")
        if model.seq_axis is not None:
            raise NotImplementedError(
                f"TorchRunner with the decode cache's sequence cut over "
                f"{model.seq_axis!r} (seq_shard_decode): the engine's block "
                "tables index whole sequences, not a rank's share (ROADMAP §1)")
        self.model = model
        self.comm = ctx.comm if ctx.mesh is not None else None
        self.axis = ctx.model_axis
        self.leads = self.comm is None or self.comm.axis_index(self.axis) == 0
        self.alloc = None
        self.pools = ()
        self.states = ()
        self._free_slots: List[int] = []
        self._slot_of: Dict[int, int] = {}

    def _send(self, *work):
        """The leader's work, to every follower."""
        if self.comm is not None:
            self.comm.broadcast_object(work, self.axis)

    def follow(self):
        """A follower's loop: run the leader's work until it ``close``s."""
        if self.leads:
            raise RuntimeError("the leading rank runs the engine, not follow()")
        calls = {"bind": self._bind, "prefill": self._prefill,
                 "decode": self._decode}
        while True:
            op, *args = self.comm.broadcast_object(None, self.axis)
            if op == "close":
                return
            calls[op](*args)

    def close(self):
        """The leader is done: its followers return from ``follow``."""
        if self.leads:
            self._send("close")

    def bind(self, alloc: PagedAllocator, n_slots: int):
        """Allocate the device pools for ``alloc`` (pool page i is
        allocator page i) and the state buffers of ``n_slots`` sequences,
        the engine's ``max_num_seqs``."""
        self._send("bind", alloc.n_pages, alloc.page_size, n_slots)
        self._bind(alloc.n_pages, alloc.page_size, n_slots)
        self.alloc = alloc

    def _bind(self, n_pages: int, page_size: int, n_slots: int):
        self.pools = tuple(
            torch.zeros(shape, dtype=self.model.dtype, device=self.device)
            for shape in self.model.pool_shapes(n_pages, page_size))
        self.states = tuple(
            torch.zeros(shape, dtype=dtype, device=self.device)
            for shape, dtype in self.model.state_shapes(n_slots))
        self._free_slots = list(range(n_slots))[::-1]
        self._slot_of = {}

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    # ------------------------------------------------------------------ api
    def prefill(self, req: Request, chunk: int) -> int:
        """Whole prefill target (prompt + regenerated prefix after a
        preemption) at the completing chunk; its cache entries go into the
        pages of the request's table, which the scheduler grew to cover it,
        and its state into its slot, which the leader picks and every rank
        writes. Returns the first token."""
        toks = np.asarray(req.prompt + req.output[:req.resume_extra], np.int64)
        table = np.asarray(self.alloc.table(req.rid), np.int64)
        pages = table[np.arange(len(toks)) // self.alloc.page_size]
        slot = None
        if self.states:
            if req.rid not in self._slot_of:
                if not self._free_slots:
                    raise RuntimeError(
                        f"request {req.rid}: every one of the "
                        f"{self.states[0].shape[1]} state slots is taken")
                self._slot_of[req.rid] = self._free_slots.pop()
            slot = self._slot_of[req.rid]
        self._send("prefill", toks, pages, slot)
        return self._prefill(toks, pages, slot)

    def _prefill(self, toks: np.ndarray, pages: np.ndarray, slot) -> int:
        logits, caches, states = self.model.prefill(self._to_device(toks[None]))
        if self.pools:
            slots = self._to_device(np.arange(len(toks)) % self.pools[0].shape[2])
            pages = self._to_device(pages)
            for j, pool in enumerate(self.pools):
                pool[:, pages, slots] = torch.stack([c[j] for c in caches])[:, 0]
        for buf, st in zip(self.states, states):
            buf[:, slot] = st[:, 0]
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
        tokens = np.asarray([r.output[-1] for r in reqs], np.int64)
        positions = np.asarray([r.context_len - 1 for r in reqs], np.int64)
        rows = np.asarray([self._slot_of[r.rid] for r in reqs], np.int64) \
            if self.states else None
        self._send("decode", tokens, positions, padded, rows)
        return self._decode(tokens, positions, padded, rows)

    def _decode(self, tokens, positions, tables, rows) -> List[int]:
        logits = self.model.decode_step(
            self._to_device(tokens), self._to_device(positions), self.pools,
            self._to_device(tables), self.states,
            None if rows is None else self._to_device(rows))
        return logits.argmax(dim=-1).tolist()

    def release(self, req: Request):
        """The request finished or was preempted: its state slot is free."""
        slot = self._slot_of.pop(req.rid, None)
        if slot is not None:
            self._free_slots.append(slot)

    def iteration_time(self, prefill_tokens, decode_reqs):
        return None, {}   # real mode: the engine uses the wall clock
