"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against
``repro.models.xlstm``, fp32, at xlstm-350m's smoke size (d_model 64, 4
heads: mLSTM heads of 32 over d_inner 128, sLSTM heads of 16, FFN 64).

Seeded numpy inputs and weights go through both: mLSTM and sLSTM over a
prompt from zero and from a carried state, and decode steps from a
forward's state. One case scales the gate projections so the gates reach
|30|, where log-sigmoid and the stabiliser m do the work; one shows that
the sLSTM FFN's gelu must be the tanh form, as ``jax.nn.gelu``'s default:
torch's default erf form moves the output past the tolerance. Tolerance:
atol and rtol 1e-5, float32 roundings of the same products.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import xlstm as jx
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import xlstm as tx
from repro_torch.models.transformer import _mlstm_specs, _slstm_specs

TOL = 1e-5
CFG = get_smoke_config("xlstm-350m")
JCFG = jax_smoke_config("xlstm-350m")


def _params(specs, seed, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    p = {}
    for name, (shape, init, fan_in) in specs.items():
        if init == "normal":
            p[name] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            p[name] = (1.0 + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    for gates in ("w_if", "w_gates"):
        if gates in p:
            p[gates] = (p[gates] * gate_scale).astype(np.float32)
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


def _x(seed, S):
    return np.random.default_rng(seed).standard_normal(
        (2, S, CFG.d_model)).astype(np.float32)


def _mlstm_state(seed):
    rng = np.random.default_rng(seed)
    C, n, m, conv = tx.init_mlstm_state(CFG, 2)
    return (rng.standard_normal(C.shape).astype(np.float32),
            rng.standard_normal(n.shape).astype(np.float32),
            rng.standard_normal(m.shape).astype(np.float32),
            rng.standard_normal(conv.shape).astype(np.float32))


def _slstm_state(seed):
    rng = np.random.default_rng(seed)
    c, n, h, m = tx.init_slstm_state(CFG, 2)
    return (rng.standard_normal(c.shape).astype(np.float32),
            (1.0 + rng.random(n.shape)).astype(np.float32),
            rng.standard_normal(h.shape).astype(np.float32),
            rng.standard_normal(m.shape).astype(np.float32))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("gate_scale", [1.0, 30.0])
def test_mlstm_forward_matches_jax(carried, gate_scale):
    p = _params(_mlstm_specs(CFG), 1, gate_scale)
    x = _x(2, 11)
    st = _mlstm_state(3) if carried else None
    ref = jx.mlstm_forward(jnp.asarray(x), p, JCFG, initial_state=None
                           if st is None else tuple(map(jnp.asarray, st)))
    mine = tx.mlstm_forward(_torch(x), _torch(p), CFG, initial_state=None
                            if st is None else _torch(st))
    _close(mine, ref)


def test_mlstm_decode_matches_jax():
    """4 decode steps from the state an 11-token forward leaves; the
    carried state itself is not written."""
    p = _params(_mlstm_specs(CFG), 4)
    rng = np.random.default_rng(5)
    _, jst = jx.mlstm_forward(jnp.asarray(_x(6, 11)), p, JCFG)
    _, st = tx.mlstm_forward(_torch(_x(6, 11)), _torch(p), CFG)
    _close(st, jst)
    for _ in range(4):
        xt = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
        before = [t.clone() for t in st]
        jy, jst = jx.mlstm_decode(jnp.asarray(xt), p, JCFG, jst)
        y, new = tx.mlstm_decode(_torch(xt), _torch(p), CFG, st)
        for a, b in zip(st, before):
            assert torch.equal(a, b)
        _close((y, new), (jy, jst))
        st = new


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("gate_scale", [1.0, 30.0])
def test_slstm_forward_matches_jax(carried, gate_scale):
    p = _params(_slstm_specs(CFG), 7, gate_scale)
    x = _x(8, 11)
    st = _slstm_state(9) if carried else None
    ref = jx.slstm_forward(jnp.asarray(x), p, JCFG, initial_state=None
                           if st is None else tuple(map(jnp.asarray, st)))
    mine = tx.slstm_forward(_torch(x), _torch(p), CFG, initial_state=None
                            if st is None else _torch(st))
    _close(mine, ref)


def test_slstm_decode_matches_jax():
    p = _params(_slstm_specs(CFG), 10)
    rng = np.random.default_rng(11)
    _, jst = jx.slstm_forward(jnp.asarray(_x(12, 11)), p, JCFG)
    _, st = tx.slstm_forward(_torch(_x(12, 11)), _torch(p), CFG)
    for _ in range(4):
        xt = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
        jy, jst = jx.slstm_decode(jnp.asarray(xt), p, JCFG, jst)
        y, st = tx.slstm_decode(_torch(xt), _torch(p), CFG, st)
        _close((y, st), (jy, jst))


def test_slstm_gelu_is_the_tanh_form(monkeypatch):
    """With torch's default (erf) gelu in its place the sLSTM output leaves
    the tolerance; with the tanh form it stays inside."""
    p = _params(_slstm_specs(CFG), 13)
    x = _x(14, 11)
    ref, _ = jx.slstm_forward(jnp.asarray(x), p, JCFG)
    mine, _ = tx.slstm_forward(_torch(x), _torch(p), CFG)
    _close(mine, ref)
    exact = F.gelu
    monkeypatch.setattr(F, "gelu", lambda t, approximate="none": exact(t))
    wrong, _ = tx.slstm_forward(_torch(x), _torch(p), CFG)
    assert float((wrong - torch.from_numpy(np.array(ref))).abs().max()) > 10 * TOL


def test_init_states_match_jax():
    for mine, ref in ((tx.init_mlstm_state(CFG, 3, torch.bfloat16),
                       jx.init_mlstm_state(JCFG, 3, jnp.bfloat16)),
                      (tx.init_slstm_state(CFG, 3), jx.init_slstm_state(JCFG, 3))):
        for a, b in zip(mine, ref):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
