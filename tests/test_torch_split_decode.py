"""Remat and the sequence-split paged decode of the port against the JAX
package.

Remat (``ParallelContext(remat="full")``, one device, fp32 smoke size):
gradients equal the port's without remat, and meet
``tests/test_torch_train.py``'s tolerances against the reference's
``loss_fn`` under its own ``remat="full"``; the counted training FLOPs
rise by exactly one forward of the layer stacks.

The split decode (the ``cache_seq`` rule over "data" that long_500k's B 1
gets): zamba2-2.7b (its shared block's caches) and h2o-danube-3-4b (window
16 < the 40-token prompt, so the window spans two ranks' shares) at smoke
size, fp32, on a (4,1) mesh. The reference runs ``prefill`` and 4 greedy
``decode_step``s under ``rules_override={"batch": None, "cache_batch":
None, "cache_seq": "data"}`` in a subprocess on 4 host CPU devices; the
port on 4 gloo CPU ranks, each holding its 32 positions of every
sequence's cache in its pool: logits within ``LOGIT_ATOL`` 1e-4 and the
same greedy tokens. The plain partials-plus-merge equals the plain one-call
decode (windows, shares before, across and past the newest token).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import transformer as T
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.analysis.counter import OpCounter
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.paged_attention.ref import (paged_attention_partials_plain,
                                                     paged_attention_plain,
                                                     paged_merge_plain)
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.bridge import from_jax_params, numpy_params
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.parallel.sharding import ParallelContext, make_test_mesh
from repro_torch.train.tree import flatten_with_path, unflatten

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-5        # tests/test_torch_train.py's, attention families
REMAT_ARCHS = ["llama3.2-3b", "deepseek-r1-671b", "internvl2-76b"]
SPLIT_ARCHS = ["zamba2-2.7b", "h2o-danube-3-4b"]
OVERRIDE = {"batch": None, "cache_batch": None, "cache_seq": "data"}
RANKS, PAGE, MAX_LEN, PROMPT, STEPS, BATCH = 4, 16, 128, 40, 4, 2

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(ranks)d"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as T
    from repro.parallel.sharding import ParallelContext

    spec = json.load(open(sys.argv[1]))
    out = sys.argv[2]
    mesh = jax.make_mesh((%(ranks)d, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ctx = ParallelContext(mesh=mesh, rules_override=spec["override"])

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    for arch in spec["archs"]:
        cfg = get_smoke_config(arch)
        params = T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="serve",
                               dtype=jnp.float32)
        params = jax.device_put(params, T.param_shardings(cfg, ctx, "serve"))
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab, (%(B)d, %(S)d)).astype(np.int32)
        pre = jax.jit(lambda p, t: T.prefill(p, t, cfg, ctx, max_len=%(max_len)d,
                                             cache_dtype=jnp.float32))
        dec = jax.jit(lambda p, st, t: T.decode_step(p, st, t, cfg, ctx))
        last, state = pre(params, jnp.asarray(tokens))
        logits, fed = [np.asarray(last)], []
        for _ in range(%(steps)d):
            nxt = np.argmax(logits[-1], axis=-1).astype(np.int32)
            fed.append(nxt)
            lg, state = dec(params, state, jnp.asarray(nxt[:, None]))
            logits.append(np.asarray(lg[:, 0]))
        arrays = dict(flat(params))
        arrays.update({"@tokens": tokens, "@logits": np.stack(logits),
                       "@fed": np.stack(fed)})
        np.savez(os.path.join(out, arch + ".npz"), **arrays)
""" % {"ranks": RANKS, "B": BATCH, "S": PROMPT, "max_len": MAX_LEN, "steps": STEPS})


# ------------------------------------------------------------ remat
def _grads(model, batch):
    tree = model.param_tree()
    leaves = [p.requires_grad_(True) for _, p in flatten_with_path(tree)]
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {"/".join(map(str, k)): g.numpy() for k, g in
                           flatten_with_path(unflatten(tree, list(grads)))}


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_prefix_len:
        b["prefix_embeds"] = rng.standard_normal(
            (2, cfg.frontend_prefix_len, cfg.d_model), dtype=np.float32)
    return b


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_match(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    params = numpy_params(cfg, seed=0)
    batch = _batch(cfg)
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
          for k, v in batch.items()}
    plain = from_jax_params(params, cfg, device="cpu", layout="train")
    remat = from_jax_params(params, cfg, device="cpu", layout="train",
                            ctx=ParallelContext(remat="full"))
    loss0, g0 = _grads(plain, tb)
    loss1, g1 = _grads(remat, tb)
    assert float(loss0) == float(loss1)
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)
    jctx = JaxContext(mesh=None, remat="full")
    jloss, jgrads = jax.value_and_grad(lambda p: T.loss_fn(
        p, {k: jax.numpy.asarray(v) for k, v in batch.items()}, jcfg, jctx))(
        jax.tree_util.tree_map(jax.numpy.asarray, params))
    np.testing.assert_allclose(float(loss1), float(jloss), rtol=1e-6)
    for path, r in flatten_with_path(jgrads):
        k, r = "/".join(map(str, path)), np.asarray(r)
        tol = GRAD_RTOL * max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g1[k], r, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-r1-671b"])
def test_remat_adds_one_forward_of_the_layers(arch):
    """Counted on meta: remat's training step less the plain one is one
    forward of the layers (the forward's FLOPs less the head's, 2 B S d V,
    which remat does not recompute) up to each layer's last saved input:
    the checkpoint stops recomputing there (PyTorch's early stop), so a
    dense layer's ``w_down`` product, whose result no backward reads, is
    not recomputed (for the MoE layers of R1, only bounds)."""
    cfg = get_smoke_config(arch)
    B, S = 2, 16
    tokens = torch.empty((B, S), dtype=torch.long, device="meta")
    counts = {}
    for remat in ("none", "full"):
        model = Transformer(cfg, device="meta", dtype=torch.bfloat16, seed=None,
                            layout="train", ctx=ParallelContext(remat=remat))
        for p in model.parameters():
            p.requires_grad_(True)
        with OpCounter() as c:
            loss_fn(model, {"tokens": tokens, "labels": tokens}).backward()
        counts[remat] = c.flops
    with OpCounter() as c, torch.no_grad():
        model(tokens)
    layers = c.flops - 2.0 * B * S * cfg.d_model * cfg.vocab
    rise = counts["full"] - counts["none"]
    print(f"{arch}: remat {counts['full']:.6e}, none {counts['none']:.6e}, "
          f"rise {rise:.6e}, the layers' forward {layers:.6e}")
    if cfg.moe is None:
        assert rise == layers - cfg.n_layers * 2.0 * B * S * cfg.d_ff * cfg.d_model
    else:
        assert 0.5 * layers < rise < layers


# ------------------------------------------------------------ partials
@pytest.mark.parametrize("window", [0, 16, 40])
def test_plain_partials_and_merge_equal_the_one_call_decode(window):
    g = torch.Generator().manual_seed(0)
    B, KV, G, D, page, blocks = 3, 2, 4, 32, 16, 12
    q = torch.randn(B, KV, G, D, generator=g)
    kp, vp = (torch.randn(B * blocks, page, KV, D, generator=g) for _ in range(2))
    tables = torch.randperm(B * blocks, generator=g).view(B, blocks).int()
    lens = torch.tensor([20, 95, 191], dtype=torch.int32)
    want = paged_attention_plain(q, kp, vp, tables, lens, window=window)
    for shares in (2, 3, 4):
        n = blocks // shares
        parts = [paged_attention_partials_plain(
            q, kp, vp, tables[:, i * n:(i + 1) * n].contiguous(),
            lens - i * n * page, window=window, part=2) for i in range(shares)]
        got = paged_merge_plain(torch.cat([a for a, _ in parts], 2),
                                torch.cat([m for _, m in parts], 2), q.dtype)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


# ------------------------------------------------------------ split decode
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    (d / "spec.json").write_text(json.dumps({"archs": SPLIT_ARCHS,
                                             "override": OVERRIDE}))
    (d / "ref.py").write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(d / "ref.py"), str(d / "spec.json"), str(d)],
                   env=env, check=True, timeout=600)
    return d


def _split_rank(rank, ref, out):
    ctx = ParallelContext(mesh=make_test_mesh(RANKS, 1), rules_override=OVERRIDE)
    share = MAX_LEN // RANKS
    n = share // PAGE
    s0 = ctx.coords()["data"] * share
    result = {}
    for arch in SPLIT_ARCHS:
        cfg = get_smoke_config(arch)
        z = np.load(os.path.join(ref, arch + ".npz"))
        nested = {}
        for k in z.files:
            if not k.startswith("@"):
                node = nested
                *path, leaf = k.split(".")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = z[k]
        m = from_jax_params(nested, cfg, device="cpu", dtype=torch.float32, ctx=ctx)
        assert m.seq_axis == "data"
        tokens = torch.from_numpy(z["@tokens"].astype(np.int64))
        last, caches, states = m.prefill(tokens)
        pools = [torch.zeros(s) for s in m.pool_shapes(BATCH * n, PAGE)]
        tables = torch.arange(BATCH * n, dtype=torch.int32).view(BATCH, n)
        pos = torch.arange(max(0, min(share, PROMPT - s0)))  # the prompt's in the share
        for j, pool in enumerate(pools):
            for b in range(BATCH):
                if len(pos):
                    pool[:, tables[b, pos // PAGE].long(), pos % PAGE] = torch.stack(
                        [c[j][b, s0 + pos] for c in caches])
        rows = torch.arange(BATCH)
        got = [last]
        for i in range(STEPS):
            got.append(m.decode_step(torch.from_numpy(z["@fed"][i].astype(np.int64)),
                                     torch.full((BATCH,), PROMPT + i), pools, tables,
                                     states, rows))
        got = torch.stack(got).numpy()
        want = z["@logits"]
        result[arch] = dict(max_abs=float(np.abs(got - want).max()),
                            tokens_equal=bool((got[:-1].argmax(-1) == z["@fed"]).all()),
                            gathers=ctx.comm.stats.get("all_gather", {}).get("calls", 0))
    with open(os.path.join(out, f"split.rank{rank}.json"), "w") as f:
        json.dump(result, f)


@pytest.fixture(scope="module")
def split_results(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    run_ranks(_split_rank, RANKS, (str(reference), str(out)))
    return [json.loads((out / f"split.rank{r}.json").read_text()) for r in range(RANKS)]


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_split_decode_matches_the_reference(split_results, arch):
    for rank, res in enumerate(split_results):
        r = res[arch]
        print(f"{arch} rank {rank}: max |logit diff| {r['max_abs']:.3e}, "
              f"all_gathers {r['gathers']}")
        assert r["max_abs"] < LOGIT_ATOL
        assert r["tokens_equal"]
        assert r["gathers"] > 0
