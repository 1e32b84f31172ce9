"""The leader's per-rank page map of ``TorchRunner(max_len=)``
(``repro_torch.core.runner.PageMap`` and ``RankPages``), on the CPU.

Random sequences of admissions, growth, finishes and preemptions drive the
engine's own ``PagedAllocator`` the way the scheduler and the engine do: a
preemption frees the victim's engine pages in the step's plan, where other
requests may take them at once, and the runner releases the victim after
the step. After every step each rank (data rank, sequence rank) must hold a
bijection between the engine pages its live requests read (the blocks of
its share among their positions) and its own pages, all within its pool of
``min(n_pages, rows * share_blocks)``; at release a request's pages return
to the free list, and with every request gone the maps are empty. Without
``max_len`` the runner keeps today's pools (every engine page id).
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.kv_cache import PagedAllocator
from repro_torch.core.runner import PageMap, RankPages, TorchRunner
from repro_torch.models.transformer import Transformer

PAGE = 4


def _geometry(dp, sp, slots, max_len, n_pages):
    rows = slots // dp
    share = -(-(-(-max_len // PAGE)) // sp)
    return rows, share, min(n_pages, rows * share)


def _step_ops():
    # (op, request index, tokens): admit a new request with tokens, grow a
    # running one by tokens, finish one, preempt one
    return st.tuples(st.sampled_from(["admit", "grow", "finish", "preempt"]),
                     st.integers(0, 30), st.integers(1, 9))


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(dp=st.sampled_from([1, 2]), sp=st.sampled_from([1, 2]),
       max_len=st.integers(6, 40), n_pages=st.integers(3, 40),
       steps=st.lists(st.lists(_step_ops(), min_size=1, max_size=4), min_size=1,
                      max_size=25))
def test_each_rank_maps_its_requests_pages_one_to_one(dp, sp, max_len, n_pages, steps):
    slots = 6
    rows, share, n_local = _geometry(dp, sp, slots, max_len, n_pages)
    alloc = PagedAllocator(n_pages, PAGE)
    pages = RankPages(dp, sp, share, PAGE, n_local)
    free_slots = list(range(slots))[::-1]
    live = {}          # rid -> (slot, tokens in cache)
    next_rid = 0
    for step in steps:
        released = []
        for op, i, k in step:
            rids = sorted(live)
            if op == "admit":
                if not free_slots or k > max_len or not alloc.grow(next_rid, k):
                    continue
                live[next_rid] = (free_slots.pop(), k)
                next_rid += 1
            elif not rids:
                continue
            else:
                rid = rids[i % len(rids)]
                slot, n = live[rid]
                if op == "grow":
                    if n + k <= max_len and alloc.grow(rid, n + k):
                        live[rid] = (slot, n + k)
                else:
                    # finish or preempt: the allocator frees the pages in the
                    # plan, the runner releases the request after the step
                    alloc.free(rid)
                    del live[rid]
                    released.append((rid, slot))
        # the step's tables: every live request's, as a prefill or decode asks
        for rid, (slot, n) in live.items():
            tables = pages.tables(rid, slot // rows, alloc.table(rid), n)
            assert len(tables) == sp
            assert sum(len(t) for t in tables) == -(-n // PAGE)
            assert all(len(t) <= share for t in tables)
        for rid, slot in released:
            pages.release(rid)
            free_slots.append(slot)
        # each rank: engine pages of its live requests' shares <-> its own pages
        for d in range(dp):
            for s in range(sp):
                want = {p for rid, (slot, n) in live.items() if slot // rows == d
                        for p in alloc.table(rid)[:-(-n // PAGE)][s * share:(s + 1) * share]}
                got = pages.maps[d][s].mapped()
                assert set(got) == want
                assert len(set(got.values())) == len(got)
                assert all(0 <= v < n_local for v in got.values())
    for rid in list(live):
        pages.release(rid)
    for row in pages.maps:
        for m in row:
            assert m.mapped() == {} and sorted(m._free) == list(range(n_local))


def test_a_page_taken_before_its_holder_is_released_passes_on():
    """A preempted request's engine page that another request of the same
    rank takes within the step keeps its local page; the preempted
    request's release then frees only what it still holds."""
    m = PageMap(4)
    assert [m.local(1, p) for p in (7, 8)] == [0, 1]
    assert m.local(2, 8) == 1           # page 8 passed from request 1 to 2
    m.release(1)
    assert m.mapped() == {8: 1}
    assert m.local(3, 9) == 0           # request 1's freed local page
    m.release(2)
    m.release(3)
    assert m.mapped() == {}
    with pytest.raises(RuntimeError, match="every one of the rank's 1 pages"):
        one = PageMap(1)
        one.local(1, 0)
        one.local(1, 1)


def test_without_max_len_the_tables_are_engine_page_ids():
    """``RankPages`` without a map: every block of the table as it stands,
    cut into the sequence ranks' shares."""
    pages = RankPages(2, 2, 3, PAGE, None)
    table = [9, 4, 7, 1, 5]
    got = pages.tables(0, 1, table, 2)
    assert got == [[9, 4, 7], [1, 5]]
    assert RankPages(1, 1, 20, PAGE, None).tables(0, 0, table, 2) == [table]


@pytest.mark.parametrize("max_len,want", [(None, 20), (32, 12), (1000, 20)])
def test_max_len_none_keeps_todays_pools(max_len, want):
    """One device: without ``max_len`` the pool holds the engine's every
    page (no pad page); with it, ``min(n_pages, slots * ceil(max_len /
    page))``."""
    cfg = get_smoke_config("llama3.2-3b")
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    runner = TorchRunner(model, device="cpu", max_len=max_len)
    runner.bind(PagedAllocator(20, 16), 6)
    assert runner.pad_page is None
    assert [tuple(p.shape) for p in runner.pools] == [
        tuple(s) for s in model.pool_shapes(min(20, want), 16)]
    if max_len is None:
        assert runner.pages.maps is None


def test_a_prefill_or_decode_past_max_len_raises():
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    cfg = get_smoke_config("llama3.2-3b")
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    rng = np.random.default_rng(0)
    for prompt, new, what in ((20, 2, "a prefill of 20 positions"),
                              (10, 8, "a decode of 17 positions")):
        eng = InferenceEngine(cfg, EngineConfig(n_pages=16, max_num_seqs=6),
                              TorchRunner(model, device="cpu", max_len=16),
                              virtual_clock=False)
        eng.submit(rng.integers(0, cfg.vocab, size=prompt).tolist(), new)
        with pytest.raises(ValueError, match=f"{what} past the runner's max_len 16"):
            eng.run(max_steps=100)
