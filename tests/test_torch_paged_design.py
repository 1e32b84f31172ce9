"""Which design runs K2's default mode over pages of another dtype than q
(``kernels/paged_attention/ops.py`` ``cvt_design``), its upcast mode
(``upcast_design``) and its sequence split (``split_design``), and through
which tensor map (``page_map``), on the CPU. The default mode and the
split: the cluster designs (``csrc/paged_cluster.cuh``,
``csrc/paged_split_cluster.cuh``) at every shape the card runs and at
every length a table holds (a block's scores past its shared memory are
recomputed from k in the same launch), 8-bit rows of head dim 120 under an
odd number of kv heads too, through the map over token pairs. The upcast
mode: the one-launch cluster design (``csrc/paged_cluster_upcast.cuh``)
for fp8 e4m3 and int8 pages under a bf16 q at every head dim and kv head
count, the split kernel for every other pair. The kernels themselves run
on the card (``tests/test_torch_kernels_gpu.py``)."""
import pytest
import torch

from repro_torch.kernels.paged_attention import ops

# (max_blocks, G, window, D, KV, bytes an element): the card's K2 shapes
# over an 8-bit cache (chip_smoke.Q8_PAGED), its fp8 and int8 serving runs
# and equality runs, a bf16 cache under fp32 weights, and the test shapes
CARD_SHAPES = {
    "llama3.2-3b decode batch": (128, 3, 0, 128, 8, 1),
    "h2o-danube window 4096, D 120": (400, 4, 4096, 120, 8, 1),
    "llama3-405b G 16": (80, 16, 0, 128, 8, 1),
    "zamba2 D 80, G 1": (80, 1, 0, 80, 32, 1),
    "llama3.2-3b served from an 8-bit cache": (80, 3, 0, 128, 8, 1),
    "the equality runs' 7-page pool": (7, 3, 0, 128, 8, 1),
    "bf16 pages under an fp32 q": (128, 3, 0, 128, 8, 2),
    "G 9, D 112, window": (40, 9, 100, 112, 2, 1),
    "D 32": (20, 8, 0, 32, 4, 1),
    "D 64, one page": (1, 1, 0, 64, 4, 1),
}


@pytest.mark.parametrize("shape", list(CARD_SHAPES.values()), ids=list(CARD_SHAPES))
def test_the_card_shapes_take_the_cluster(shape):
    assert ops.cvt_design(*shape) == "cluster"


# the old limits of the cluster's scores (8 blocks of floor(96 KB / (64 G))
# pages: 65,536 tokens at G 3, 12,288 at G 16) and past them, where the
# two passes ran until the cluster took every length: (max_blocks, G,
# window) at the old limit and one page or more past it
LIMITS = [((4096, 3, 0), (4097, 3, 0)),        # 65,536 tokens at G 3
          ((12_288, 1, 0), (12_289, 1, 0)),    # G 1
          ((1536, 8, 0), (2048, 8, 0)),        # 24,576 tokens at G 8
          ((1360, 9, 0), (1361, 9, 0)),        # floor(98,304 / 576) = 170 pages a block
          ((768, 16, 0), (769, 16, 0))]        # 12,288 tokens at G 16


@pytest.mark.parametrize("fits,past", LIMITS, ids=[f"G{f[1]}-{p[0]}pages" for f, p in LIMITS])
def test_a_sequence_past_the_scores_takes_two_passes(fits, past):
    """Named for the rule it pinned: past the old limit the two passes ran.
    The cluster now takes those lengths in one launch (its overflow pages'
    scores recomputed from k)."""
    assert ops.cvt_design(*fits, 128, 8, 1) == "cluster"
    assert ops.cvt_design(*past, 128, 8, 1) == "cluster"
    # the reasoning lengths (up to 33,792 tokens) and far past them
    assert ops.cvt_design(33_792 // 16, fits[1], 0, 128, 8, 1) == "cluster"
    assert ops.cvt_design(1 << 20, fits[1], 0, 128, 8, 1) == "cluster"


def test_the_window_bounds_the_span():
    """A window holds the span to (window - 1) // 16 + 2 pages; without one
    the span is the table's width: the cluster takes both, at any width."""
    assert ops.cvt_design(100_000, 4, 4096, 120, 8, 1) == "cluster"
    assert ops.cvt_design(100_000, 4, 0, 120, 8, 1) == "cluster"
    assert ops.cvt_design(100_000, 3, 65_536 - 16, 128, 8, 1) == "cluster"
    assert ops.cvt_design(100_000, 3, 65_536, 128, 8, 1) == "cluster"


@pytest.mark.parametrize("KV,page_bytes,tmap", [(8, 1, "flat"), (1, 1, "paired"),
                                                (3, 1, "paired"), (1, 2, "per_head")])
def test_rows_of_d120_take_the_cluster_through_their_map(KV, page_bytes, tmap):
    """A kv head's 8-bit row of 120 elements is not a 16-byte stride; the
    cluster reads such rows through a map over all heads' rows, whose
    stride (KV * 120 bytes) is one for an even KV, or over token pairs
    (2 * KV * 120 bytes, one for every KV); a bf16 row of 240 bytes takes
    the per-head map. The cluster at any length."""
    assert ops.page_map(120, KV, page_bytes) == tmap
    assert ops.cvt_design(128, 3, 0, 120, KV, page_bytes) == "cluster"
    assert ops.cvt_design(4096, 16, 0, 120, KV, page_bytes) == "cluster"


def test_on_the_cpu_the_wrapper_runs_the_plain_version():
    """The design is the card's: a CPU tensor takes the plain version and
    launches nothing."""
    rng = torch.Generator().manual_seed(0)
    q = torch.randn((2, 2, 3, 64), generator=rng)
    kp, vp = (torch.randn((8, 16, 2, 64), generator=rng).to(torch.float8_e4m3fn)
              for _ in range(2))
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([63, 20], dtype=torch.int32)
    before = ops.CVT.launches
    out = ops.paged_attention(q, kp, vp, tables, lens)
    assert ops.CVT.launches == before and out.dtype == torch.float32
    torch.testing.assert_close(out, ops.paged_attention_plain(q, kp, vp, tables, lens))


# (q, pages) -> the upcast mode's design at D 128 under 8 kv heads: every
# pair of two dtypes the wrapper takes (pages of q's dtype take the
# same-dtype kernel)
F32, BF16, E4M3, INT8 = torch.float32, torch.bfloat16, torch.float8_e4m3fn, torch.int8
UPCAST_PAIRS = {(BF16, E4M3): "cluster", (BF16, INT8): "cluster", (BF16, F32): "split",
                (F32, E4M3): "split", (F32, INT8): "split", (F32, BF16): "split"}


@pytest.mark.parametrize("pair", list(UPCAST_PAIRS),
                         ids=[f"{str(q)[6:]}-{str(p)[6:]}" for q, p in UPCAST_PAIRS])
def test_the_upcast_design_routes_every_dtype_pair(pair):
    q, pages = pair
    assert ops.upcast_design(q, pages, 128, 8) == UPCAST_PAIRS[pair]
    # the card's other head dims: the same route
    for D, KV in ((120, 8), (112, 8), (80, 32), (64, 24), (32, 4)):
        assert ops.upcast_design(q, pages, D, KV) == UPCAST_PAIRS[pair]


@pytest.mark.parametrize("KV,tmap", [(8, "flat"), (2, "flat"), (1, "paired"),
                                     (3, "paired")])
def test_upcast_rows_of_d120_take_the_cluster_under_any_kv(KV, tmap):
    """8-bit rows of D 120 under an odd KV are no 16-byte stride, nor are
    a token's KV rows: the upcast cluster reads them through the map over
    token pairs, as ``cvt_design``'s cluster does."""
    assert ops.page_map(120, KV, 1) == tmap
    for pages in (E4M3, INT8):
        assert ops.upcast_design(BF16, pages, 120, KV) == "cluster"
        assert ops.cvt_design(128, 3, 0, 120, KV, 1) == "cluster"


# the sequence split's design (``split_design``) at the card's shapes and
# the served configs' under ``seq_shard_decode``, whose pools hold every kv
# head: (D, KV, bytes an element)
SPLIT_SHAPES = {
    "llama3.2-3b": (128, 8, 1), "h2o-danube D 120": (120, 8, 1), "zamba2 D 80": (80, 32, 1),
    "musicgen D 64": (64, 24, 1), "kimi-k2 D 112": (112, 8, 1), "D 32": (32, 4, 1),
    "bf16 pages under an fp32 q, D 120 under one kv head": (120, 1, 2),
}


@pytest.mark.parametrize("shape", list(SPLIT_SHAPES.values()), ids=list(SPLIT_SHAPES))
def test_the_split_takes_its_cluster_design_where_tma_addresses_the_rows(shape):
    assert ops.split_design(*shape) == "cluster"


@pytest.mark.parametrize("KV", [1, 3, 5])
def test_the_split_takes_the_cluster_for_rows_of_an_odd_kv(KV):
    """8-bit rows of D 120 under an odd KV: the split's cluster passes
    through the map over token pairs (as the one launch's ``cvt_design``);
    an even KV takes the all-heads map."""
    assert ops.split_design(120, KV, 1) == "cluster" == ops.cvt_design(128, 3, 0, 120, KV, 1)
    assert ops.page_map(120, KV, 1) == "paired"
    assert ops.split_design(120, KV + 1, 1) == "cluster"
    assert ops.page_map(120, KV + 1, 1) == "flat"


def test_the_split_passes_book_their_bytes_on_meta():
    """On meta (the dry-run) nothing launches; pass 1 books q.k and the
    fp32 scores it writes, pass 2 p.v and the scores it reads with v. The
    eager bytes count each k or v row as its TMA box reads it: under the
    map over token pairs (8-bit D 120, KV 1 and 3) 128 bytes a row of 120,
    one 128-byte box row, where the per-head map reads a row's own bytes
    (D 112 and 128); the strict bytes count the row's elements alike."""
    from repro_torch.analysis import scopes
    from repro_torch.analysis.counter import OpCounter
    B, G, nblk = 2, 4, 4
    counts = [k.launches for k in ops.COUNTERS]
    for D, KV, tmap in ((120, 1, "paired"), (120, 3, "paired"), (112, 1, "per_head"),
                        (128, 1, "per_head")):
        assert ops.page_map(D, KV, 1) == tmap
        q = torch.empty((B, KV, G, D), dtype=torch.bfloat16, device="meta")
        pages = torch.empty((16, 16, KV, D), dtype=torch.float8_e4m3fn, device="meta")
        tables = torch.zeros((B, nblk), dtype=torch.int32, device="meta")
        lens = torch.zeros((B,), dtype=torch.int32, device="meta")
        with OpCounter() as c1:
            ml, scores = ops.paged_attention_stats(q, pages, tables, lens)
        gathered = torch.cat([ml, ml], dim=2)
        with OpCounter() as c2:
            acc = ops.paged_attention_values(q, pages, pages, tables, lens, gathered, scores)
        assert ml.shape == (B, KV, 1, G, 2) and acc.shape == (B, KV, 1, G, D)
        assert scores.shape == (B, KV, nblk, G, 16)
        keys = B * KV * nblk * 16
        row = 128 if tmap == "paired" else D
        assert c1.flops_by_op["paged_attention_stats"] == \
            c2.flops_by_op["paged_attention_values"] == 2 * keys * G * D
        small1 = sum(t.numel() * t.element_size() for t in (q, tables, lens, ml))
        small2 = sum(t.numel() * t.element_size() for t in (q, tables, lens, gathered, acc))
        # pass 1: k's box rows, the scores written; pass 2: v's, the scores read
        assert c1.hbm_bytes_eager == keys * row + keys * G * 4 + small1
        assert c2.hbm_bytes_eager == keys * row + keys * G * 4 + small2
        strict = sum(scopes.strict_bytes(t) for t in (q, tables, lens, ml))
        assert c1.hbm_bytes == keys * D * scopes.FLOAT_BYTES \
            + keys * G * scopes.FLOAT_BYTES + strict
    assert [k.launches for k in ops.COUNTERS] == counts
