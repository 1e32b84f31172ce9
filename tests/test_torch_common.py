"""The port's rmsnorm and rope against ``repro.models.common`` on the same
numpy inputs (fp32, atol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch.models import common as tc

ATOL = 1e-6


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 4, 16), (7, 128)])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_matches_jax(shape, eps):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    ref = np.asarray(jc.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps))
    out = tc.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("head_dim", [16, 64, 15])   # 15: odd tail passes through
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    B, S, H = 2, 9, 3
    x = rng.standard_normal((B, S, H, head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(B, S)).astype(np.int32)
    ref = np.asarray(jc.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    out = tc.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    if head_dim % 2:
        np.testing.assert_array_equal(out[..., -1], x[..., -1])

