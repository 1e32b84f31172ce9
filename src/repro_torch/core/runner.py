"""Model runners behind the engine.

``SimRunner``   — advances a virtual clock with the analytical perf model
                  (a copy of ``repro.core.runner.SimRunner``; H200 constants
                  reproduce the paper's figures, v5e constants drive TPU
                  planning, H100 constants predict the port's card).
``TorchRunner`` — real execution of the port's ``Transformer``, the
                  counterpart of ``repro.core.runner.JaxRunner``, on one
                  device or, as one controller, over a mesh's ranks.

The paged-accounting layer in the scheduler is identical in both modes.
``TorchRunner``'s decode cache is paged pools of ``Transformer.pool_dtype``
(the context's ``kv_cache_dtype``, else the runner's ``cache_dtype``, else
the model's dtype), of the shapes
``Transformer.pool_shapes`` gives: k and v ``(L, n_pages, page, KV, hd)``
for GQA (L the shared block's groups in a hybrid), the latent
``ckv (L, n_pages, page, kv_rank)`` and the roped key
``kpe (L, n_pages, page, rope)`` for MLA, none for xLSTM. Their page ids
are the engine's ``PagedAllocator`` page ids (the engine hands its
allocator over with ``bind``), so the scheduler's block tables index the
pools directly, or, under ``JaxRunner``'s bound ``max_len``, a rank's own
pages that ``PageMap`` gives them; the allocator frees a request's pages
on preemption and on finish. Every running sequence holds one of
``max_num_seqs`` slots, as ``JaxRunner``'s: prefill takes a free slot,
``release`` (on finish and on preemption) returns it, so a resumed request
recomputes its cache and state from its prompt and output. A model with recurrent state (the
hybrid and ssm families) keeps its state in the buffers of
``Transformer.state_shapes``, one row per slot: prefill writes the
request's fresh state into its row, decode reads and writes the batch's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import perf_model as pm
from repro_torch.core.kv_cache import PagedAllocator
from repro_torch.core.request import Request
from repro_torch.device import resolve_device
from repro_torch.models.cache_dtype import to_cache_dtype, writable
from repro_torch.models.transformer import Transformer
from repro_torch.parallel.sharding import mesh_axes


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


class PageMap:
    """The leader's map from engine page ids to one rank's own pool pages,
    ``n_local`` of them. A page takes a local page, from a free list, the
    first time it appears in a table on the rank that keeps it, and keeps
    it until the request that holds it is released (on finish and on
    preemption). The allocator frees a preempted request's pages in the
    scheduler's plan, while the runner releases it after the step: an
    engine page that another request of the same rank takes meanwhile
    passes to that request with its local page, which its own writes fill
    before any read."""

    def __init__(self, n_local: int):
        self.n_local = n_local
        self._free: List[int] = list(range(n_local))[::-1]
        self._local: Dict[int, int] = {}          # engine page -> local page
        self._holder: Dict[int, int] = {}         # engine page -> rid
        self._held: Dict[int, List[int]] = {}     # rid -> the engine pages it took

    def local(self, rid: int, page: int) -> int:
        """The local page of engine page ``page``, which request ``rid``
        holds."""
        at = self._local.get(page)
        if at is None:
            if not self._free:
                raise RuntimeError(f"request {rid}: every one of the rank's "
                                   f"{self.n_local} pages is taken")
            at = self._local[page] = self._free.pop()
        if self._holder.get(page) != rid:
            self._holder[page] = rid
            self._held.setdefault(rid, []).append(page)
        return at

    def release(self, rid: int):
        """Free the local pages that request ``rid`` still holds."""
        for page in self._held.pop(rid, ()):
            if self._holder.get(page) == rid:
                del self._holder[page]
                self._free.append(self._local.pop(page))

    def mapped(self) -> Dict[int, int]:
        """Engine page -> local page, of every page held now."""
        return dict(self._local)


class RankPages:
    """Each rank's table of a request, from the engine's: the blocks of
    sequence rank s's share (``share_blocks`` of them from block s *
    share_blocks; all blocks where ``sp`` is 1) among the first ``n_pos``
    positions, as the pool pages of the data rank that owns the request.
    With ``n_local`` None the pools are indexed by engine page ids (every
    block of the table, as it stands); else through a ``PageMap`` per
    (data rank, sequence rank) of ``n_local`` pages, asked only for the
    blocks a request's tables did not hold before (a live request's table
    only grows)."""

    def __init__(self, dp: int, sp: int, share_blocks: int, page_size: int,
                 n_local: Optional[int]):
        self.sp, self.share_blocks, self.page_size = sp, share_blocks, page_size
        self.maps = None if n_local is None else [
            [PageMap(n_local) for _ in range(sp)] for _ in range(dp)]
        self._known: Dict[int, List[List[int]]] = {}   # rid -> each share's local pages

    def tables(self, rid: int, data: int, table: List[int],
               n_pos: int) -> List[List[int]]:
        """The ``sp`` tables of request ``rid`` on data rank ``data``."""
        sb = self.share_blocks
        if self.maps is None:
            return [table[s * sb:(s + 1) * sb] for s in range(self.sp)]
        n = -(-n_pos // self.page_size)
        known = self._known.setdefault(rid, [[] for _ in range(self.sp)])
        for s, have in enumerate(known):
            m = self.maps[data][s]
            have += [m.local(rid, p) for p in table[s * sb + len(have):min(n, (s + 1) * sb)]]
        return [have[:max(0, min(n - s * sb, sb))] for s, have in enumerate(known)]

    def release(self, rid: int):
        self._known.pop(rid, None)
        for row in self.maps or ():
            for m in row:
                m.release(rid)


class TorchRunner:
    """Real execution of ``model``. Under a mesh (``model.ctx``; the
    reference's ``JaxRunner`` with a mesh ctx) it is a single controller:
    the rank at coordinate 0 of every mesh axis leads, runs the engine and
    its allocator, and broadcasts each call's work (the pool's size,
    prefill tokens with their pages and slot, decode tokens with their
    positions, block tables and slots) to every other rank of the mesh,
    which ``follow``\\ s: each runs the same model calls on its shard, on a
    pool of its own kv heads indexed by the leader's page ids and on state
    buffers of its own (a Mamba2 rank's heads).

    Over "data" (the mesh axes of the "batch" rule) the slots are cut as
    the reference cuts its ``cache_batch``: slot s belongs to data rank
    s // (max_num_seqs / dp), and so does the request that holds it, from
    its prefill until ``release``. A prefill runs on every rank (each data
    rank must join the weights' collectives); only the owner's ranks keep
    its cache pages and its state row. A decode step gives each data rank
    the rows of its own requests, padded to the step's largest share so
    that every "data" collective (FSDP gathers, ``serve_2d_tp``'s rows,
    ``moe_ff_shard``'s tokens) sees one shape; a pad row reads the pool's
    pad page (its last, which the allocator never hands out) and a free
    slot of its rank, and writes nothing (``decode_step``'s ``valid``).
    The leader gathers the tokens over "data" and returns them in the
    engine's order.

    With the decode cache's sequence cut over a mesh axis
    (``seq_shard_decode``) each rank holds a fixed share of every
    sequence's positions: ``bind`` sets it from the longest sequence, in
    whole pages split over that axis. Every prefill and decode cuts each
    rank's block table from the engine's, the blocks of its share padded
    with the pad page; a prefill writes only the pages of the rank's
    positions, and decode runs K2's split half and ``paged_merge`` (MLA:
    ``Transformer._mla_split``).

    ``max_len`` is ``JaxRunner``'s bound: the positions a sequence may
    hold. Without it (None) every rank's pool is indexed by every engine
    page id, so it holds all ``n_pages`` pages (and a sequence's share
    under ``seq_shard_decode`` is the whole pool's over the axis). With it
    a rank holds its share of the reference's cache: a sequence's
    ``ceil(max_len / page)`` blocks (``bps``), cut over the sequence axis
    into ``share_blocks = ceil(bps / sp)``, for each of its data rank's
    ``rows`` slots, so ``min(n_pages, rows * share_blocks)`` pages and the
    pad page. The leader keeps a ``PageMap`` per (data rank, sequence
    rank) and sends each rank its tables as its own pages (``RankPages``);
    a page takes its local page where a table first names it on the rank
    that keeps it, and a request's local pages are freed at ``release``.
    A prefill or decode past ``max_len`` raises ``ValueError`` (where the
    reference's decode overwrites its last position: ROADMAP §3).

    Of the other §Perf levers ``seq_parallel_norm`` cuts its prefill's
    residual stream, ``serve_2d_tp`` and ``moe_ff_shard`` act across
    "data", and ``decode_unroll`` reads a cache of another dtype than the
    model's upcast to the model's (the decode step already runs layer by
    layer and writes pages in place).

    ``cache_dtype`` is ``JaxRunner``'s: the pools' dtype where the
    context's ``kv_cache_dtype`` is None. Where both are None the pools
    take the model's dtype, where ``JaxRunner``'s take fp32 (a departure:
    a bf16 model here serves from a bf16 cache). Prefill's cache entries
    are cast into the pools as ``jnp.astype`` casts (``to_cache_dtype``)."""

    def __init__(self, model: Transformer, *, device="cuda",
                 cache_dtype: Optional[torch.dtype] = None,
                 max_len: Optional[int] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, runner on {self.device}")
        ctx = model.ctx
        if max_len is not None and max_len < 1:
            raise ValueError(f"max_len {max_len}: a sequence needs a position")
        self.model = model
        self.max_len = max_len
        self.cache_dtype = model.pool_dtype(cache_dtype)
        self.comm = ctx.comm if ctx.mesh is not None else None
        # the mesh axes of the batch, and this rank's coordinate over them
        # (row-major)
        self.batch_axes = mesh_axes(ctx.spec("batch")[0]) if self.comm else ()
        self.dp, self.data = 1, 0
        for a in self.batch_axes:
            self.dp *= ctx.axis_size(a)
            self.data = self.data * ctx.axis_size(a) + self.comm.axis_index(a)
        self.seq_axis = model.seq_axis
        if self.seq_axis is not None and self.seq_axis in self.batch_axes:
            raise ValueError(f"the batch and the cache's sequence are both cut "
                             f"over {self.seq_axis!r}")
        self.sp = ctx.axis_size(self.seq_axis) if self.seq_axis else 1
        self.leads = self.comm is None or not any(ctx.coords().values())
        self.alloc = None
        self.pools = ()
        self.states = ()
        self.pad_page = None      # the pool's last page, where rows or tables pad
        self.share_blocks = 0     # blocks of a rank's share of a sequence
        self.rows = 0             # slots of one data rank
        self.pages: Optional[RankPages] = None   # the leader's tables of every rank
        self._free_slots: List[int] = []
        self._slot_of: Dict[int, int] = {}

    def _send(self, *work):
        """The leader's work, to every other rank of the mesh."""
        if self.comm is not None:
            self.comm.broadcast_object(work)

    def follow(self):
        """A follower's loop: run the leader's work until it ``close``s."""
        if self.leads:
            raise RuntimeError("the leading rank runs the engine, not follow()")
        calls = {"bind": self._bind, "prefill": self._prefill,
                 "decode": self._decode}
        while True:
            op, *args = self.comm.broadcast_object(None)
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
        the engine's ``max_num_seqs``, cut over "data"."""
        if n_slots % self.dp:
            raise ValueError(f"max_num_seqs {n_slots} does not divide over "
                             f"{self.dp} data ranks")
        self._send("bind", alloc.n_pages, alloc.page_size, n_slots, self.max_len)
        n_local = self._bind(alloc.n_pages, alloc.page_size, n_slots, self.max_len)
        self.alloc = alloc
        self.pages = RankPages(self.dp, self.sp, self.share_blocks, alloc.page_size,
                               None if self.max_len is None else n_local)
        self._free_slots = list(range(n_slots))[::-1]
        self._slot_of = {}

    def _bind(self, n_pages: int, page_size: int, n_slots: int,
              max_len: Optional[int]) -> int:
        """Allocate this rank's pools and state rows, sized by the leader's
        ``max_len``; returns the pool's pages, the pad page left out."""
        self.max_len = max_len
        padded = self.dp > 1 or self.sp > 1
        self.rows = n_slots // self.dp
        if self.max_len is None:
            self.share_blocks = -(-n_pages // self.sp)
            n_local = n_pages
        else:
            self.share_blocks = -(-(-(-self.max_len // page_size)) // self.sp)
            n_local = min(n_pages, self.rows * self.share_blocks)
        self.pad_page = n_local if padded else None
        self.pools = tuple(
            torch.zeros(shape, dtype=self.cache_dtype, device=self.device)
            for shape in self.model.pool_shapes(n_local + padded, page_size))
        self.states = tuple(
            torch.zeros(shape, dtype=dtype, device=self.device)
            for shape, dtype in self.model.state_shapes(self.rows))
        return n_local

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def _seq_rank(self) -> int:
        """This rank's coordinate over the cache's sequence axis."""
        if self.seq_axis is None:
            return 0
        return self.model.ctx.comm.axis_index(self.seq_axis)

    def _check_len(self, req: Request, n: int, what: str):
        if self.max_len is not None and n > self.max_len:
            raise ValueError(f"request {req.rid}: {what} of {n} positions past the "
                             f"runner's max_len {self.max_len}")

    # ------------------------------------------------------------------ api
    def prefill(self, req: Request, chunk: int) -> int:
        """Whole prefill target (prompt + regenerated prefix after a
        preemption) at the completing chunk; its cache entries go into the
        pages of the request's table, which the scheduler grew to cover it,
        and its state into the row of its slot, which the leader picks.
        Every rank runs it; the ranks of the slot's data rank keep what it
        writes. Returns the first token."""
        toks = np.asarray(req.prompt + req.output[:req.resume_extra], np.int64)
        self._check_len(req, len(toks), "a prefill")
        if req.rid not in self._slot_of:
            if not self._free_slots:
                raise RuntimeError(f"request {req.rid}: every one of the "
                                   f"{self.rows * self.dp} slots is taken")
            self._slot_of[req.rid] = self._free_slots.pop()
        slot = self._slot_of[req.rid]
        tables = self.pages.tables(req.rid, slot // self.rows, self.alloc.table(req.rid),
                                   len(toks))
        self._send("prefill", toks, tables, slot)
        return self._prefill(toks, tables, slot)

    def _prefill(self, toks: np.ndarray, tables: List[List[int]], slot: int) -> int:
        logits, caches, states = self.model.prefill(self._to_device(toks[None]))
        if slot // self.rows != self.data:
            return int(logits[0].argmax())
        if self.pools:
            page = self.pools[0].shape[2]
            # this rank's positions: all, or those of its share, in its
            # table's pages
            s = self._seq_rank()
            first = s * self.share_blocks * page
            pos = np.arange(len(toks))[first:][:self.share_blocks * page]
            pages = self._to_device(np.asarray(tables[s], np.int64)[(pos - first) // page])
            offs = self._to_device(pos % page)
            for j, pool in enumerate(self.pools):
                new = torch.stack([c[j] for c in caches])[:, 0, first:first + len(pos)]
                writable(pool)[:, pages, offs] = writable(to_cache_dtype(new, pool.dtype))
        for buf, st in zip(self.states, states):
            buf[:, slot % self.rows] = st[:, 0]
        return int(logits[0].argmax())

    def decode(self, reqs: List[Request]) -> List[int]:
        """One token for each request: the newest token sits at position
        ``context_len - 1``, and the scheduler has grown each table to
        ``context_len + 1`` tokens. Tables are padded to the batch's longest
        with page 0, a valid id never read past ``lens`` (the pad page where
        the runner pads). Each data rank's rows are its own requests', in
        the engine's order, then pads up to the largest share; each rank
        gets its own tables (``RankPages``): under ``seq_shard_decode`` its
        share's ``share_blocks``, else the blocks a row reads."""
        for r in reqs:
            self._check_len(r, r.context_len, "a decode")
        slots = [self._slot_of[r.rid] for r in reqs]
        mine = [[i for i, s in enumerate(slots) if s // self.rows == dr]
                for dr in range(self.dp)]
        B = max(map(len, mine))
        local = [self.pages.tables(r.rid, s // self.rows, self.alloc.table(r.rid),
                                   r.context_len) for r, s in zip(reqs, slots)]
        width = self.share_blocks if self.sp > 1 else max(len(t[0]) for t in local)
        tokens = np.zeros((self.dp, B), np.int64)
        positions = np.zeros((self.dp, B), np.int64)
        tables = np.full((self.dp, self.sp, B, width), self.pad_page or 0, np.int32)
        rows = np.zeros((self.dp, B), np.int64)
        valid = np.zeros((self.dp, B), bool)
        at = [0] * len(reqs)          # each request's row in the gathered tokens
        for dr, idx in enumerate(mine):
            for j, i in enumerate(idx):
                tokens[dr, j] = reqs[i].output[-1]
                positions[dr, j] = reqs[i].context_len - 1
                for s, t in enumerate(local[i]):
                    tables[dr, s, j, :len(t)] = t
                rows[dr, j] = slots[i] % self.rows
                valid[dr, j] = True
                at[i] = dr * B + j
            # a pad row takes a free slot of its data rank, which it leaves as it is
            free = [s % self.rows for s in range(dr * self.rows, (dr + 1) * self.rows)
                    if s not in slots]
            rows[dr, len(idx):] = free[:B - len(idx)]
        self._send("decode", tokens, positions, tables, rows, valid)
        got = self._decode(tokens, positions, tables, rows, valid)
        return [got[k] for k in at]

    def _decode(self, tokens, positions, tables, rows, valid) -> List[int]:
        d = self.data
        tables = tables[d, self._seq_rank()]
        logits = self.model.decode_step(
            self._to_device(tokens[d]), self._to_device(positions[d]), self.pools,
            self._to_device(tables), self.states,
            self._to_device(rows[d]) if self.states else None,
            None if valid[d].all() else self._to_device(valid[d]))
        out = logits.argmax(dim=-1)
        for a in reversed(self.batch_axes):
            out = self.comm.all_gather(out, a, 0)
        return out.tolist()

    def release(self, req: Request):
        """The request finished or was preempted: its slot and its ranks'
        pages are free."""
        slot = self._slot_of.pop(req.rid, None)
        if slot is not None:
            self._free_slots.append(slot)
        if self.pages is not None:
            self.pages.release(req.rid)

    def iteration_time(self, prefill_tokens, decode_reqs):
        return None, {}   # real mode: the engine uses the wall clock
