"""The port's single-device MoE (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs.

Dispatch slots and keep flags are equal exactly; ``moe_ffn_reference``
matches at fp32 within atol 1e-5 (float32 roundings of the same sums) with
no drops, with drops, and at DeepSeek-R1's decode shape, where the
capacity is one slot an expert and dropped assignments read a clamped
row; in bf16 within a relative RMS of 1e-2 (a few bf16 roundings of the
expert products and the combine).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import moe as tmoe

ATOL = 1e-5
BF16_REL_RMS = 1e-2


def _cfgs(E, k, cf, d, shared):
    """The same MoE config for both packages."""
    kw = dict(name="m", family="moe", n_layers=1, d_model=d, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=64)
    m = dict(n_experts=E, top_k=k, d_ff_expert=48, n_shared_experts=shared,
             capacity_factor=cf)
    return (JaxModelConfig(**kw, moe=JaxMoEConfig(**m)),
            ModelConfig(**kw, moe=MoEConfig(**m)))


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    f = m.d_ff_expert
    shapes = {"router": (d, m.n_experts), "we_gate": (m.n_experts, d, f),
              "we_up": (m.n_experts, d, f), "we_down": (m.n_experts, f, d)}
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        shapes.update(ws_gate=(d, fs), ws_up=(d, fs), ws_down=(fs, d))
    return {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("n_assign", [1, 5, 23, 64])
@pytest.mark.parametrize("n_experts", [2, 3, 8])
@pytest.mark.parametrize("capacity", [1, 4, 16])
def test_dispatch_indices_equal_jax(n_assign, n_experts, capacity):
    flat = np.random.default_rng(n_assign * 100 + n_experts).integers(
        0, n_experts, n_assign)
    jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(flat, jnp.int32),
                                          n_experts, capacity)
    slot, keep = tmoe._dispatch_indices(torch.from_numpy(flat), n_experts,
                                        capacity)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


# (T, E, k, cf, d): no drops; drops; R1's decode batch of 16 (256 experts,
# top-8, cf 1.25 -> capacity 1, about a fifth of the assignments dropped)
FFN_CASES = {"cf8": (32, 4, 2, 8.0, 32), "cf0.25": (32, 4, 2, 0.25, 32),
             "r1_decode": (16, 256, 8, 1.25, 32)}


def _run_both(case, shared, dtype, seed=0):
    T, E, k, cf, d = FFN_CASES[case]
    jcfg, cfg = _cfgs(E, k, cf, d, shared)
    params = _params(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal((T, d)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jmoe.moe_ffn_reference(
        jnp.asarray(x, jdt), {n: jnp.asarray(v, jdt) for n, v in params.items()},
        jcfg)
    out = tmoe.moe_ffn_reference(
        torch.from_numpy(x).to(tdt),
        {n: torch.from_numpy(v).to(tdt) for n, v in params.items()}, cfg)
    return cfg, x, np.asarray(ref, np.float32), out.float().numpy()


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_reference_matches_jax(case, shared):
    cfg, x, ref, out = _run_both(case, shared, "float32")
    assert out.shape == x.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    A = x.shape[0] * cfg.moe.top_k
    _, idx = tmoe._topk_assignments(
        tmoe.router_probs(torch.from_numpy(x),
                          torch.from_numpy(_params(cfg, 0)["router"])),
        cfg.moe.top_k)
    _, keep = tmoe._dispatch_indices(idx.reshape(-1), cfg.moe.n_experts,
                                     tmoe.capacity(cfg, x.shape[0]))
    n_dropped = A - int(keep.sum())
    if case == "cf8":
        assert n_dropped == 0
    else:
        assert n_dropped > 0, "the case is meant to drop assignments"


@pytest.mark.parametrize("case", ["cf0.25", "r1_decode"])
def test_moe_ffn_reference_bf16_close_to_jax(case):
    _, _, ref, out = _run_both(case, 1, "bfloat16")
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < BF16_REL_RMS, rel


def test_r1_decode_capacity_is_one_slot():
    """R1 at a decode batch of 16: one slot an expert (the reference's
    rule), so the batch decides which assignments drop."""
    _, cfg = _cfgs(256, 8, 1.25, 32, 1)
    assert tmoe.capacity(cfg, 16) == 1
    assert tmoe.capacity(cfg, 1) == 1


def test_moe_ffn_flattens_leading_dims():
    _, cfg = _cfgs(4, 2, 8.0, 32, 1)
    p = {n: torch.from_numpy(v) for n, v in _params(cfg, 3).items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, 32)).astype(np.float32))
    out = tmoe.moe_ffn(x, p, cfg)
    ref = tmoe.moe_ffn_reference(x.reshape(10, 32), p, cfg).reshape(2, 5, 32)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
