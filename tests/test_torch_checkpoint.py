"""The port's checkpoints, launcher and example against the JAX package's.

The four cases of ``tests/test_checkpoint.py`` on torch trees (with a bf16
leaf); checkpoints in both directions with ``repro.train.checkpoint``,
bitwise, bf16 leaves included, and a step resumed from a JAX checkpoint
held to JAX's step from the same state; ``python -m
repro_torch.launch.train --smoke --device cpu`` resumed from its own
checkpoint equal to an uninterrupted run, and refusing to start without
``--device cpu`` where there is no card; the example's config.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.parallel.sharding import single_device_ctx
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.registry import get_smoke_config
from repro_torch.examples import train_small
from repro_torch.launch.train import synthetic_batch, train
from repro_torch.models.bridge import from_jax_params, numpy_params
from repro_torch.models.transformer import param_specs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import flatten_with_path, leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
CTX = single_device_ctx()
ARCH = "llama3.2-3b"
# a parameter after one AdamW step (lr 1e-3): rounding moves it by about
# 1e-7; an element whose first moment sits within rounding of zero may
# take the opposite step (2 lr), and such elements are counted
PARAM_ATOL = 1e-5


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 8, generator=g),
            "nested": {"b": torch.arange(10),
                       "c": torch.tensor(float(seed)),
                       "d": torch.randn(3, 5, generator=g).to(torch.bfloat16)}}


def _assert_trees_equal(a, b):
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ------------------------------------------- tests/test_checkpoint.py's cases
def test_roundtrip(tmp_path):
    t = _tree(0)
    ckpt.save(t, str(tmp_path), step=5)
    like = tree_map(torch.zeros_like, t)
    restored, step = ckpt.restore(like, str(tmp_path))
    assert step == 5
    _assert_trees_equal(t, restored)


def test_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(_tree(s), str(tmp_path), step=s, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, _ = ckpt.restore(_tree(0), str(tmp_path), step=4)
    _assert_trees_equal(restored, _tree(4))
    steps = sorted(int(p.name.split("-")[1]) for p in tmp_path.glob("step-*"))
    assert steps == [4, 5]


def test_async_save(tmp_path):
    t = _tree(7)
    thread = ckpt.save_async(t, str(tmp_path), step=7)
    # the host copy was taken: changing the tree now does not reach the file
    t["a"].add_(1.0)
    thread.join(timeout=30)
    assert not thread.is_alive()
    restored, step = ckpt.restore(t, str(tmp_path))
    assert step == 7
    _assert_trees_equal(restored, _tree(7))


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(_tree(0), str(tmp_path), step=1)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore({"different": torch.zeros(2)}, str(tmp_path))


# ------------------------------------------------------ with the JAX package
def jax_state_after_one_step():
    """llama3.2-3b smoke weights from numpy, one jit'd reference step with
    bf16 AdamW moments, and the next step's batch."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    ocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, state_dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, seed=0))
    state = jopt.init_opt_state(params, ocfg)
    step = jax.jit(jax_make_train_step(jcfg, CTX, ocfg))
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    params, state, _ = step(params, state,
                            {k: jnp.asarray(v) for k, v in batches[0].items()})
    return cfg, step, params, state, batches[1]


def _bits(x):
    """A leaf's raw bits as numpy (bf16 as int16)."""
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.kind == "V" else a


def port_like(cfg):
    model = from_jax_params(numpy_params(cfg, seed=1), cfg, device="cpu",
                            layout="train")
    ocfg = topt.AdamWConfig(lr=1e-3, warmup_steps=2, state_dtype=torch.bfloat16)
    return model, ocfg, topt.init_opt_state(model.param_tree(), ocfg)


def test_jax_checkpoint_restores_bitwise_and_resumes_as_jax(tmp_path):
    """A JAX-written ``(params, opt_state)`` with bf16 moments restores
    bitwise into the port's model and state; the next step from it matches
    JAX's next step: loss rtol 1e-6, grad norm rtol 1e-5, params within
    PARAM_ATOL but for counted flips (at most 1e-3 of them)."""
    cfg, jstep, jparams, jstate, batch = jax_state_after_one_step()
    jckpt.save((jparams, jstate), str(tmp_path), step=1)
    model, ocfg, like_state = port_like(cfg)
    (params, state), step = ckpt.restore((model.param_tree(), like_state),
                                         str(tmp_path))
    assert step == 1
    assert state["m"]["embed"].dtype == torch.bfloat16
    ref = [leaf for _, leaf in jax.tree_util.tree_flatten_with_path(
        (jparams, jstate))[0]]
    mine = leaves((params, state))
    assert len(ref) == len(mine)
    for x, y in zip(mine, ref):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    with torch.no_grad():
        for p, saved in zip(leaves(model.param_tree()), leaves(params)):
            p.copy_(saved)

    metrics = make_train_step(model, ocfg)(
        state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    jparams2, _, jm = jstep(jparams, jstate,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert int(state["step"]) == 2
    n_off = 0
    for (path, p), r in zip(flatten_with_path(model.param_tree()),
                            jax.tree_util.tree_leaves(jparams2)):
        d = np.abs(p.detach().numpy() - np.asarray(r))
        assert d.max() <= 4e-3, path
        n_off += int((d > PARAM_ATOL).sum())
    n = sum(p.numel() for p in model.parameters())
    print(f"{n_off} of {n} parameters off by more than {PARAM_ATOL}")
    assert n_off <= 1e-3 * n


def test_port_checkpoint_restores_bitwise_through_jax(tmp_path):
    """A port-written ``(params, opt_state)`` after a step with bf16
    moments restores bitwise through ``repro.train.checkpoint.restore``
    into the reference's own tree (its keys asserted there)."""
    cfg, _, jparams, jstate, batch = jax_state_after_one_step()
    model, ocfg, state = port_like(cfg)
    make_train_step(model, ocfg)(
        state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    ckpt.save((model.param_tree(), state), str(tmp_path), step=9)
    restored, step = jckpt.restore((jparams, jstate), str(tmp_path))
    assert step == 9
    mine = leaves((model.param_tree(), state))
    ref = jax.tree_util.tree_leaves(restored)
    assert len(mine) == len(ref)
    for x, y in zip(mine, ref):
        np.testing.assert_array_equal(_bits(x.detach()), _bits(y))


# ---------------------------------------------------------------- launcher
def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--smoke", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_launcher_resumes_as_an_uninterrupted_run(tmp_path):
    """The CLI trains 4 steps with a checkpoint every 2; a second run to
    step 6 on the same ``--ckpt-dir`` resumes from step 4, and its two
    losses equal those of 6 uninterrupted steps (rtol 1e-6: the same ops on
    bitwise the same weights, moments and batches)."""
    out = _cli("--device", "cpu", "--steps", "4", "--batch", "2", "--seq",
               "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
               "--log-every", "1")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[train] step") == 4
    assert "[train] done: 4 steps" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 4
    cfg = get_smoke_config(ARCH)
    resumed = train(cfg, steps=6, batch=2, seq=16, ckpt_dir=str(tmp_path),
                    device="cpu")
    assert resumed["start_step"] == 4
    whole = train(cfg, steps=6, batch=2, seq=16, device="cpu")
    assert [h["step"] for h in resumed["history"]] == [5, 6]
    np.testing.assert_allclose([h["loss"] for h in resumed["history"]],
                               [h["loss"] for h in whole["history"][4:]],
                               rtol=1e-6)
    assert all(np.isfinite(h["grad_norm"]) for h in whole["history"])


def test_launcher_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = _cli("--steps", "1")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def test_synthetic_batch_is_a_function_of_the_step():
    a = synthetic_batch(3, 2, 8, 100, device="cpu")
    b = synthetic_batch(3, 2, 8, 100, device="cpu")
    c = synthetic_batch(4, 2, 8, 100, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# ----------------------------------------------------------------- example
def test_example_config_is_the_references():
    spec = importlib.util.spec_from_file_location(
        "jax_train_small", ROOT / "examples" / "train_small.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert dataclasses.asdict(train_small.CFG_100M) == \
        dataclasses.asdict(ref.CFG_100M)
    # the reference's docstring says "~100M params"; ``param_count()``
    # leaves out the final norm's d_model weights
    n = sum(int(np.prod(s)) for s, _, _ in param_specs(train_small.CFG_100M).values())
    assert train_small.CFG_100M.param_count() == 54_538_240
    assert n == 54_538_240 + train_small.CFG_100M.d_model
    b = train_small.batch_for(7, 2, 16, 16384, "cpu")
    assert b["tokens"].shape == (2, 16) and int(b["tokens"].max()) < 16384
