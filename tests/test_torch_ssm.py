"""The port's Mamba2 block (``repro_torch.models.ssm``) against
``repro.models.ssm``, fp32, at zamba2-2.7b's smoke size (d_model 64, 8
heads of 16, state 16, conv width 4, chunk 8).

Seeded numpy inputs and weights go through both: the causal conv with and
without a carried state; the chunked scan at S equal to the chunk, above
it, a multiple of it and not, from zero and from a carried state and conv
state; and decode steps from a forward's state. ``dt_bias`` is 25 on half
the heads in one case, so softplus's input passes 20, where torch's
``softplus`` turns linear and JAX's does not. Tolerance: atol 1e-5 with
rtol 1e-5 (the state h grows to tens here), float32 roundings of the same
products in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import _mamba_specs

TOL = 1e-5
CFG = get_smoke_config("zamba2-2.7b")
JCFG = jax_smoke_config("zamba2-2.7b")


def _params(seed, dt_bias=None):
    """One Mamba2 layer's weights: normal with std 1/sqrt(fan_in), and
    A_log, D, dt_bias and the norms drawn too so none is trivial."""
    rng = np.random.default_rng(seed)
    p = {}
    for name, (shape, init, fan_in) in _mamba_specs(CFG).items():
        if init == "normal":
            p[name] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            p[name] = (1.0 + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    p["A_log"] = (0.5 * rng.standard_normal(p["A_log"].shape)).astype(np.float32)
    p["dt_bias"] = (rng.standard_normal(p["dt_bias"].shape) - 1.0).astype(np.float32)
    if dt_bias is not None:
        p["dt_bias"] = dt_bias.astype(np.float32)
    return p


def _torch(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_torch(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(mine, ref):
    if isinstance(ref, (tuple, list)):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            _close(a, b)
        return
    ref = np.asarray(ref)
    assert tuple(mine.shape) == ref.shape and mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), ref, rtol=TOL, atol=TOL)


def _state(seed, B):
    """A carried (h, conv states) of B sequences."""
    rng = np.random.default_rng(seed)
    (h, cs) = tssm.init_mamba_state(CFG, B)
    h = rng.standard_normal(h.shape).astype(np.float32)
    cs = tuple(rng.standard_normal(c.shape).astype(np.float32) for c in cs)
    return h, cs


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32) if carried else None
    ref = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if state is None else jnp.asarray(state))
    mine = tssm._causal_conv(*_torch((x, w)),
                             None if state is None else _torch(state))
    _close(mine, ref)


@pytest.mark.parametrize("S", [8, 19, 24, 3])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba2_forward_matches_jax(S, carried):
    """S = the chunk, past it and not a multiple, two whole chunks, and
    shorter than the conv window; y, h and the conv states."""
    p = _params(S)
    x = np.random.default_rng(10 + S).standard_normal((2, S, CFG.d_model)) \
        .astype(np.float32)
    kw = {}
    if carried:
        h, cs = _state(20 + S, 2)
        kw = dict(initial_state=h, conv_state=cs)
    ref = jssm.mamba2_forward(jnp.asarray(x), p, JCFG,
                              **{k: jnp.asarray(v) if k == "initial_state"
                                 else tuple(map(jnp.asarray, v))
                                 for k, v in kw.items()})
    mine = tssm.mamba2_forward(_torch(x), _torch(p), CFG, **_torch(kw))
    _close(mine, ref)


def test_mamba2_softplus_past_20_matches_jax():
    """dt_bias 25 on half the heads: softplus's input passes 20."""
    nh = CFG.ssm.expand * CFG.d_model // CFG.ssm.head_dim
    p = _params(5, dt_bias=np.where(np.arange(nh) % 2 == 0, 25.0, -1.0))
    x = np.random.default_rng(6).standard_normal((2, 19, CFG.d_model)) \
        .astype(np.float32)
    dt_in = x @ p["w_dt"] + p["dt_bias"]
    assert dt_in.max() > 20.0
    ref = jssm.mamba2_forward(jnp.asarray(x), p, JCFG)
    mine = tssm.mamba2_forward(_torch(x), _torch(p), CFG)
    _close(mine, ref)


def test_mamba2_decode_matches_jax():
    """4 decode steps from the state a 13-token forward leaves."""
    p = _params(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 13, CFG.d_model)).astype(np.float32)
    _, jstate = jssm.mamba2_forward(jnp.asarray(x), p, JCFG)
    _, state = tssm.mamba2_forward(_torch(x), _torch(p), CFG)
    _close(state, jstate)
    for _ in range(4):
        xt = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
        jy, jstate = jssm.mamba2_decode(jnp.asarray(xt), p, JCFG, jstate)
        y, state = tssm.mamba2_decode(_torch(xt), _torch(p), CFG, state)
        _close((y, state), (jy, jstate))


def test_init_state_dtypes():
    """h is fp32 whatever the model's dtype; the conv states take it."""
    h, cs = tssm.init_mamba_state(CFG, 3, torch.bfloat16)
    jh, jcs = jssm.init_mamba_state(JCFG, 3, jnp.bfloat16)
    assert h.dtype == torch.float32 and tuple(h.shape) == jh.shape
    for c, jc in zip(cs, jcs):
        assert c.dtype == torch.bfloat16 and tuple(c.shape) == jc.shape
