"""The port's model against ``repro.models.transformer`` on bridged weights
(smoke llama3.2-3b, fp32): the bridge round-trips exactly, and prefill plus
paged decode steps give the JAX logits (atol 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import transformer as T
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.bridge import from_jax_params, numpy_params, to_jax_params

CTX = single_device_ctx()
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_smoke_config("llama3.2-3b")
    params = T.init_params(cfg, jax.random.PRNGKey(0), CTX, mode="serve",
                           dtype=jnp.float32)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_agree_with_jax(smoke):
    mine = (get_smoke_config if smoke else get_config)("llama3.2-3b")
    ref = (jax_smoke_config if smoke else jax_config)("llama3.2-3b")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()


def test_bridge_round_trips_bit_for_bit(jax_params):
    _, params = jax_params
    model = from_jax_params(params, get_smoke_config("llama3.2-3b"),
                            device="cpu")
    back = to_jax_params(model)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_numpy_params_have_the_jax_layout(jax_params):
    _, params = jax_params
    mine = numpy_params(get_smoke_config("llama3.2-3b"), seed=0)
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), params)
    assert jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), mine) == shapes


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_paged_decode_match_jax(jax_params, seed):
    """Two prompts prefilled together, their k/v scattered into shuffled
    pages, then 8 greedy paged decode steps; every step's logits match
    ``T.prefill`` + ``T.decode_step`` (dense cache)."""
    jcfg, params = jax_params
    cfg = get_smoke_config("llama3.2-3b")
    model = from_jax_params(params, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    B, S, n_steps, page = 2, 13, 8, 16
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)

    jprefill = jax.jit(lambda p, t: T.prefill(
        p, t, jcfg, CTX, max_len=S + n_steps, cache_dtype=jnp.float32))
    jdecode = jax.jit(lambda p, st, t: T.decode_step(p, st, t, jcfg, CTX))
    jlast, state = jprefill(params, jnp.asarray(tokens))
    last, ks, vs = model.prefill(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=ATOL)

    nblk = -(-(S + n_steps) // page)
    n_pages = 3 * B * nblk
    tables = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk).astype(np.int32)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    k_pool = torch.zeros((L, n_pages, page, KV, hd))
    v_pool = torch.zeros_like(k_pool)
    pos = np.arange(S)
    for b in range(B):
        pages = torch.from_numpy(tables[b, pos // page]).long()
        slots = torch.from_numpy(pos % page)
        k_pool[:, pages, slots] = torch.stack(ks)[:, b]
        v_pool[:, pages, slots] = torch.stack(vs)[:, b]

    nxt = np.array(jnp.argmax(jlast, axis=-1), np.int32)
    for i in range(n_steps):
        jlogits, state = jdecode(params, state, jnp.asarray(nxt[:, None]))
        logits = model.decode_step(
            torch.from_numpy(nxt).long(), torch.full((B,), S + i),
            k_pool, v_pool, torch.from_numpy(tables))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits[:, 0]),
                                   rtol=0, atol=ATOL)
        nxt = np.array(jnp.argmax(jlogits[:, 0], axis=-1), np.int32)
