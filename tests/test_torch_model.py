"""The port's model against ``repro.models.transformer`` on bridged weights,
at the smoke size of each served family in fp32: llama3.2-3b (dense GQA,
tied head), DeepSeek-R1 (MLA, a dense then an MoE layer with a shared
expert, untied head), phi3.5-moe (GQA, every layer MoE), the R1 Llama
distill (dense GQA, untied head), qwen3-14b (qk-norm), h2o-danube-3-4b
(sliding window 16 at smoke size; its prompts are longer than the window,
so it binds in prefill and in paged decode), kimi-k2 (GQA, a dense then an
MoE layer with a shared expert), llama3-405b (dense GQA, untied head),
internvl2-76b (vlm: a dense GQA backbone whose prefill takes patch
embeddings as a prefix), musicgen-medium (audio: an MHA decoder over codec
tokens), zamba2-2.7b (12 Mamba2 layers and two invocations of its shared
attention block) and xlstm-350m (14 mLSTM and 2 sLSTM blocks, no
attention). The registry holds the JAX package's models, the configs
equal its configs, the bridge round-trips exactly, and prefill (with and
without a prefix of embeddings) plus paged decode steps give the JAX
logits (atol 1e-4, float32 roundings of the same products) and, for the
recurrent families, the JAX package's recurrent state."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ALL_MODELS as JAX_MODELS
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import transformer as T
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs.registry import ALL_MODELS, get_config, get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.models.bridge import from_jax_params, numpy_params, to_jax_params
from repro_torch.models.transformer import Transformer, check_supported

CTX = single_device_ctx()
ATOL = 1e-4
ARCHS = ["llama3.2-3b", "deepseek-r1-671b", "phi3.5-moe-42b-a6.6b",
         "ds-distill-8b", "qwen3-14b", "h2o-danube-3-4b", "kimi-k2-1t-a32b",
         "llama3-405b", "internvl2-76b", "musicgen-medium", "zamba2-2.7b",
         "xlstm-350m"]


# xlstm-350m's 16 blocks of exponentially gated recurrence amplify fp32
# rounding: the JAX package's own fp32 prefill logits lie about 1e-4 from
# a float64 run of the port (whose recurrences stay fp32, as both packages
# cast them), so the two fp32 runs cannot agree to 1e-4; see
# test_xlstm_fp32_logits_near_a_float64_run
XLSTM_ATOL = 3e-4


def atol_of(arch: str) -> float:
    return XLSTM_ATOL if arch == "xlstm-350m" else ATOL


def window_of(cfg) -> int:
    """The sliding window a config's attention binds at (0: none)."""
    return cfg.swa_window if cfg.attention == "swa" else 0


@pytest.fixture(scope="module", params=ARCHS)
def jax_params(request):
    cfg = jax_smoke_config(request.param)
    params = T.init_params(cfg, jax.random.PRNGKey(0), CTX, mode="serve",
                           dtype=jnp.float32)
    return request.param, cfg, jax.tree_util.tree_map(np.asarray, params)


def test_registry_holds_every_jax_model():
    assert list(ALL_MODELS) == list(JAX_MODELS)


@pytest.mark.parametrize("arch", sorted(ALL_MODELS))
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_agree_with_jax(arch, smoke):
    mine = (get_smoke_config if smoke else get_config)(arch)
    ref = (jax_smoke_config if smoke else jax_config)(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert mine.kv_bytes_per_token() == ref.kv_bytes_per_token()


@pytest.mark.parametrize("arch", sorted(ALL_MODELS))
def test_param_specs_equal_jax_serve_specs(arch):
    """Names, shapes, inits and fan-ins of every served model at full size
    equal ``build_param_specs`` in serve mode on one device."""
    def flat(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from flat(val, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", (val.shape, val.init, val.fan_in)

    ref = dict(flat(T.build_param_specs(jax_config(arch), CTX, "serve")))
    assert TT.param_specs(get_config(arch)) == ref


def test_bridge_round_trips_bit_for_bit(jax_params):
    arch, _, params = jax_params
    model = from_jax_params(params, get_smoke_config(arch), device="cpu")
    back = to_jax_params(model)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_numpy_params_have_the_jax_layout(jax_params):
    arch, _, params = jax_params
    mine = numpy_params(get_smoke_config(arch), seed=0)
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), params)
    assert jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), mine) == shapes


def jax_states(cfg, state):
    """The JAX decode state's recurrent part as the port's state buffers:
    a hybrid's h and conv states (L,B,...); xLSTM's mLSTM C, n, m, conv
    with (groups, per) flattened to the blocks in run order, then its
    sLSTM c, n, h, m."""
    if cfg.family == "hybrid":
        h, cs = state["mamba"]
        return [h, *cs]
    if cfg.family == "ssm":
        return ([a.reshape(-1, *a.shape[2:]) for a in state["mlstm"]]
                + list(state["slstm"]))
    return []


def assert_states_match(states, jstates):
    """Each layer's state within ATOL of its largest value: the states of
    random weights grow large (a hybrid's h reaches hundreds at smoke size),
    and fp32 roundings grow with them."""
    assert len(states) == len(jstates)
    for mine, ref in zip(states, jstates):
        ref = np.asarray(ref)
        assert tuple(mine.shape) == ref.shape
        for l in range(ref.shape[0]):
            scale = max(1.0, float(np.abs(ref[l]).max()))
            np.testing.assert_allclose(mine[l].numpy(), ref[l], rtol=0,
                                       atol=ATOL * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_paged_decode_match_jax(jax_params, seed):
    """Two prompts prefilled together, their cache entries (k/v, or the
    MLA latents) scattered into shuffled pages and their recurrent state
    into slots 1 and 0, then 8 greedy paged decode steps; every step's
    logits match ``T.prefill`` + ``T.decode_step`` (dense cache), and the
    state after prefill and after the last step matches the JAX state. A
    windowed model's prompts are longer than its window; a hybrid's cross
    a chunk of its scan."""
    arch, jcfg, params = jax_params
    cfg = get_smoke_config(arch)
    model = from_jax_params(params, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    B, S, n_steps, page = 2, 13 + window_of(cfg), 8, 16
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)

    jprefill = jax.jit(lambda p, t: T.prefill(
        p, t, jcfg, CTX, max_len=S + n_steps, cache_dtype=jnp.float32))
    jdecode = jax.jit(lambda p, st, t: T.decode_step(p, st, t, jcfg, CTX))
    jlast, state = jprefill(params, jnp.asarray(tokens))
    last, caches, states = model.prefill(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=atol_of(arch))
    assert_states_match(states, jax_states(cfg, state))

    nblk = -(-(S + n_steps) // page)
    n_pages = 3 * B * nblk
    tables = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk).astype(np.int32)
    pools = [torch.zeros(s) for s in model.pool_shapes(n_pages, page)]
    pos = np.arange(S)
    for b in range(B):
        pages = torch.from_numpy(tables[b, pos // page]).long()
        slots = torch.from_numpy(pos % page)
        for j, pool in enumerate(pools):
            pool[:, pages, slots] = torch.stack([c[j] for c in caches])[:, b]
    rows = torch.tensor([1, 0])
    bufs = [torch.zeros(shape, dtype=dt) for shape, dt in model.state_shapes(B)]
    for buf, st in zip(bufs, states):
        buf[:, rows] = st

    nxt = np.array(jnp.argmax(jlast, axis=-1), np.int32)
    for i in range(n_steps):
        jlogits, state = jdecode(params, state, jnp.asarray(nxt[:, None]))
        logits = model.decode_step(
            torch.from_numpy(nxt).long(), torch.full((B,), S + i),
            pools, torch.from_numpy(tables), bufs, rows)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits[:, 0]),
                                   rtol=0, atol=atol_of(arch))
        nxt = np.array(jnp.argmax(jlogits[:, 0], axis=-1), np.int32)
    assert_states_match([buf[:, rows] for buf in bufs], jax_states(cfg, state))


@pytest.mark.parametrize("arch", ["internvl2-76b", "musicgen-medium"])
@pytest.mark.parametrize("n_prefix", [4, 0])
def test_prefix_prefill_and_decode_match_jax(arch, n_prefix):
    """A prefix of ``n_prefix`` embeddings (normal, at the embedding's
    scale; 4 is what ``reduced`` keeps of internvl2's 256) before two
    13-token prompts: the last logits match ``T.prefill(prefix_embeds=)``,
    the caches cover the prefix and the prompt, and 8 paged decode steps
    from position P+S match ``T.decode_step`` on the reference's
    ``DecodeState`` (fp32, atol 1e-4)."""
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    params = jax.tree_util.tree_map(np.asarray, T.init_params(
        jcfg, jax.random.PRNGKey(0), CTX, mode="serve", dtype=jnp.float32))
    model = from_jax_params(params, cfg, device="cpu")
    rng = np.random.default_rng(3)
    B, S, n_steps, page = 2, 13, 8, 16
    P = n_prefix
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    prefix = (rng.standard_normal((B, P, cfg.d_model))
              / math.sqrt(cfg.d_model)).astype(np.float32)

    jlast, state = T.prefill(params, jnp.asarray(tokens), jcfg, CTX,
                             prefix_embeds=jnp.asarray(prefix) if P else None,
                             max_len=P + S + n_steps, cache_dtype=jnp.float32)
    last, caches, _ = model.prefill(torch.from_numpy(tokens).long(),
                                    torch.from_numpy(prefix) if P else None)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    assert [tuple(k.shape) for k, _ in caches] \
        == [(B, P + S, cfg.n_kv_heads, cfg.resolved_head_dim)] * cfg.n_layers

    nblk = -(-(P + S + n_steps) // page)
    n_pages = 3 * B * nblk
    tables = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk).astype(np.int32)
    pools = [torch.zeros(s) for s in model.pool_shapes(n_pages, page)]
    pos = np.arange(P + S)
    for b in range(B):
        pages = torch.from_numpy(tables[b, pos // page]).long()
        slots = torch.from_numpy(pos % page)
        for j, pool in enumerate(pools):
            pool[:, pages, slots] = torch.stack([c[j] for c in caches])[:, b]
    nxt = np.array(jnp.argmax(jlast, axis=-1), np.int32)
    for i in range(n_steps):
        jlogits, state = T.decode_step(params, state, jnp.asarray(nxt[:, None]),
                                       jcfg, CTX)
        logits = model.decode_step(
            torch.from_numpy(nxt).long(), torch.full((B,), P + S + i),
            pools, torch.from_numpy(tables))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits[:, 0]),
                                   rtol=0, atol=ATOL)
        nxt = np.array(jnp.argmax(jlogits[:, 0], axis=-1), np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_xlstm_fp32_logits_near_a_float64_run(seed):
    """The basis of ``XLSTM_ATOL``: the prefill logits of the JAX package
    and of the port, both fp32, each lie within it of the port run in
    float64 on the same weights and prompts."""
    jcfg = jax_smoke_config("xlstm-350m")
    cfg = get_smoke_config("xlstm-350m")
    params = jax.tree_util.tree_map(np.asarray, T.init_params(
        jcfg, jax.random.PRNGKey(0), CTX, mode="serve", dtype=jnp.float32))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(2, 13)).astype(np.int32)
    jlast, _ = jax.jit(lambda p, t: T.prefill(
        p, t, jcfg, CTX, cache_dtype=jnp.float32))(params, jnp.asarray(tokens))
    ref = from_jax_params(params, cfg, device="cpu", dtype=torch.float64
                          ).prefill(torch.from_numpy(tokens).long())[0].numpy()
    mine = from_jax_params(params, cfg, device="cpu"
                           ).prefill(torch.from_numpy(tokens).long())[0]
    for logits in (np.asarray(jlast, np.float64), mine.double().numpy()):
        np.testing.assert_allclose(logits, ref, rtol=0, atol=XLSTM_ATOL)


@pytest.mark.parametrize("change", [dict(family="audio", attention="linear"),
                                    dict(attention="none"),
                                    dict(family="hybrid", attn_every=2),
                                    dict(family="ssm"),
                                    dict(family="vlm", attention="none")])
def test_check_supported_refuses_unported_kinds(change):
    cfg = dataclasses.replace(get_smoke_config("llama3.2-3b"), **change)
    with pytest.raises(NotImplementedError):
        check_supported(cfg)
    with pytest.raises(NotImplementedError):
        Transformer(cfg, device="cpu", seed=None)


def test_seeded_init_draws_in_pieces_with_the_documented_scale(monkeypatch):
    """With pieces far smaller than a weight, every normal weight still
    has mean 0 and std 1/sqrt(fan_in) (pooled over the model, within 2%),
    no two experts or layers are drawn alike, and the norms are ones."""
    monkeypatch.setattr(TT, "INIT_CHUNK", 1000)
    cfg = dataclasses.replace(get_smoke_config("deepseek-r1-671b"),
                              n_layers=3)
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    params = dict(model.named_parameters())
    scaled = []
    for name, (_, init, fan_in) in model.specs.items():
        p = params[name]
        if init == "ones":
            assert bool((p == 1).all()), name
        else:
            scaled.append(p.reshape(-1) * math.sqrt(fan_in))
    z = torch.cat(scaled)
    assert z.numel() > 100_000
    assert abs(float(z.std()) - 1.0) < 0.02
    assert abs(float(z.mean())) < 0.02
    we = params["moe_stack.we_gate"]
    assert we.shape[0] == 2 and we.shape[1] == cfg.moe.n_experts
    assert not torch.equal(we[0, 0], we[0, 1])
    assert not torch.equal(we[0, 0], we[1, 0])
    again = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    for name, p in again.named_parameters():
        assert torch.equal(p, params[name]), name
