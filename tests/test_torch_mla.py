"""The port's MLA (``repro_torch.models.attention.mla_*``) against
``repro.models.attention`` on the same numpy inputs, at the smoke size of
DeepSeek-R1 in fp32: prefill (with positions and kv_lens) and the absorbed
decode within atol 1e-4 (float32 roundings of the same products); the
paged latent decode equals the dense one on shuffled pages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import _attn_specs

ATOL = 1e-4
ARCH = "deepseek-r1-671b"


def _layer(cfg, seed):
    """One MLA layer's weights, std 1/sqrt(fan_in), norms ones."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, init, fan_in) in _attn_specs(cfg).items():
        out[name] = (np.ones(shape, np.float32) if init == "ones" else
                     (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))
    return out


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kv_lens", [None, [9, 4]])
def test_mla_prefill_matches_jax(seed, kv_lens):
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _both(_layer(cfg, seed))
    rng = np.random.default_rng(seed + 10)
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int32)
    jout, (jckv, jkpe) = jattn.mla_prefill(
        jnp.asarray(x), jp, jcfg, jnp.asarray(pos),
        None if lens is None else jnp.asarray(lens))
    out, (ckv, kpe) = tattn.mla_prefill(
        torch.from_numpy(x), tp, cfg, torch.from_numpy(pos),
        None if lens is None else torch.from_numpy(lens))
    for mine, ref in ((out, jout), (ckv, jckv), (kpe, jkpe)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


def _decode_inputs(cfg, seed, B=3, S=21):
    rng = np.random.default_rng(seed + 20)
    ml = cfg.mla
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, S, ml.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((B, S, ml.qk_rope_head_dim)).astype(np.float32)
    lens = rng.integers(0, S, size=B).astype(np.int32)
    lens[0] = S - 1
    return x, ckv, kpe, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_mla_decode_matches_jax(seed):
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _both(_layer(cfg, seed))
    x, ckv, kpe, lens = _decode_inputs(cfg, seed)
    ref = jattn.mla_decode(jnp.asarray(x), jp, jcfg, jnp.asarray(ckv),
                           jnp.asarray(kpe), jnp.asarray(lens))
    out = tattn.mla_decode(torch.from_numpy(x), tp, cfg, torch.from_numpy(ckv),
                           torch.from_numpy(kpe), torch.from_numpy(lens))
    assert out.shape == (x.shape[0], 1, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_mla_paged_decode_equals_dense(seed):
    """Each sequence's latents in shuffled pages of one pool, with stale
    values in every slot no table reaches: the paged decode equals
    ``mla_decode`` on the dense cache."""
    cfg = get_smoke_config(ARCH)
    _, tp = _both(_layer(cfg, seed))
    page = 16
    x, ckv, kpe, lens = _decode_inputs(cfg, seed, B=3, S=40)
    B, S = ckv.shape[:2]
    nblk = -(-S // page)
    rng = np.random.default_rng(seed + 30)
    n_pages = 3 * B * nblk
    tables = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk).astype(np.int32)
    ckv_pool = torch.from_numpy(rng.standard_normal(
        (n_pages, page, ckv.shape[2])).astype(np.float32))
    kpe_pool = torch.from_numpy(rng.standard_normal(
        (n_pages, page, kpe.shape[2])).astype(np.float32))
    pos = np.arange(S)
    for b in range(B):
        pages = torch.from_numpy(tables[b, pos // page]).long()
        ckv_pool[pages, torch.from_numpy(pos % page)] = torch.from_numpy(ckv[b])
        kpe_pool[pages, torch.from_numpy(pos % page)] = torch.from_numpy(kpe[b])
    t_lens = torch.from_numpy(lens)
    dense = tattn.mla_decode(torch.from_numpy(x), tp, cfg, torch.from_numpy(ckv),
                             torch.from_numpy(kpe), t_lens)
    paged = tattn.mla_decode_paged(torch.from_numpy(x), tp, cfg, ckv_pool,
                                   kpe_pool, torch.from_numpy(tables), t_lens)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ranks", [2, 3])
def test_mla_split_decode_matches_jax(seed, ranks):
    """The absorbed decode split as ranks of a sequence-cut cache split it
    (``Transformer._mla_split``): each rank's share of every sequence's
    positions in its own shuffled pages, ``mla_partials`` over the share
    with lens counted from its start (a share past a sequence's newest
    token adds nothing), the shares' partials merged by ``mla_merge`` and
    absorbed by ``mla_absorb``: within 1e-4 of the reference's
    ``mla_decode`` on the dense cache, fp32."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _both(_layer(cfg, seed))
    page = 4
    x, ckv, kpe, lens = _decode_inputs(cfg, seed, B=3, S=40)
    lens[1] = 3                          # only the first share holds it
    B, S = ckv.shape[:2]
    nb = -(-S // (page * ranks))         # blocks of a share
    rng = np.random.default_rng(seed + 40)
    xt, t_lens = torch.from_numpy(x), torch.from_numpy(lens)
    q_lat, q_pe = tattn.mla_query(xt, tp, cfg, t_lens)
    parts = []
    for r in range(ranks):
        n_pages = 2 * B * nb
        tables = rng.permutation(n_pages)[:B * nb].reshape(B, nb)
        ckv_pool = torch.from_numpy(rng.standard_normal(
            (n_pages, page, ckv.shape[2])).astype(np.float32))
        kpe_pool = torch.from_numpy(rng.standard_normal(
            (n_pages, page, kpe.shape[2])).astype(np.float32))
        pos = np.arange(r * nb * page, min((r + 1) * nb * page, S))
        local = pos - r * nb * page
        for b in range(B):
            pages = torch.from_numpy(tables[b, local // page]).long()
            ckv_pool[pages, torch.from_numpy(local % page)] = torch.from_numpy(ckv[b, pos])
            kpe_pool[pages, torch.from_numpy(local % page)] = torch.from_numpy(kpe[b, pos])
        parts.append(tattn.mla_partials(
            q_lat, q_pe, ckv_pool, kpe_pool, torch.from_numpy(tables.astype(np.int32)),
            t_lens - r * nb * page, tattn.mla_scale(cfg.mla)))
    acc, m, l = (torch.stack(t, 1) for t in zip(*parts))
    assert float(m[1, 1:].max()) <= tattn.NEG_INF / 2 and float(l[1, 1:].max()) == 0.0
    out = tattn.mla_absorb(tattn.mla_merge(acc, m, l, xt.dtype), tp)
    ref = jattn.mla_decode(jnp.asarray(x), jp, jcfg, jnp.asarray(ckv),
                           jnp.asarray(kpe), jnp.asarray(lens))
    assert out.shape == (B, 1, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
