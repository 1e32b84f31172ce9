#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. the card (nvidia-smi name and power limit, torch and CUDA versions),
     then the build of the CUDA libraries from ``src/repro_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, fp32 and
     bf16, on the kernel test cases, the edges of each kernel's tiling (K1's
     fp32 instance: 64-row q and 64-key tiles ragged, a window edge and lens
     inside a tile, lens 0) and
     the main paths' shapes (llama3.2-3b's G=3, phi3.5-moe's G=4, qwen3's
     G=5, kimi-k2's D=112, h2o-danube's D=120 with its window of 4096,
     llama3-405b's G=16, zamba2's D=80 at G=1, musicgen's D=64 at G=1 over
     24 kv heads, internvl2's G=8 at D=128 and its prefix plus text), and
     the window's edges inside and on K2's 256-token partitions; then K2
     over pages of another dtype than q (fp8 e4m3 and int8 under bf16 and
     fp32 q, bf16 under fp32; ``check_q8``) at llama3.2-3b's, h2o-danube's
     (window, D 120), llama3-405b's (G 16) and zamba2's (D 80, G 1) decode
     batches, in the reference's ``decode_attention`` function (the
     one-launch cluster design there, at a small batch past its old scores
     limit, at reasoning lengths of 12,288-33,792 tokens at G 16 and G 8,
     and at 60,000-65,536 tokens, where each block's last pages are
     recomputed from k; and at 8-bit D 120 rows under one and three kv
     heads, whose token stride TMA cannot take, through the map over token
     pairs) and upcast (``decode_unroll``; its cluster there too; fp32
     pages under a bf16 q), and its sequence split (pass 1, the gathered
     (m, l), pass 2, the sum: two cluster launches a share) over rank
     shares of the four decode batches, the reasoning lengths and the rows
     of an odd KV (each table's halves, and the whole table then a share
     with no key: each share's (m, l) and scores against the plain
     version's) and of zamba2's and
     h2o-danube's split share; int8 pages also under q times 12 and 40, where
     the output is not zeros and rows tell truncation from rounding to
     nearest;
  3. each kernel's time in bf16 at the main paths' shapes (K1 at S 137,
     1000, 512 and 2048, and at the prompts of qwen3-14b, h2o-danube (S
     5000, window 4096), kimi-k2, llama3-405b, zamba2-2.7b, musicgen-medium
     and internvl2-76b (S 1000, and S 456: its prefix and text); K2 at one
     2048-token sequence and at the decode batches of llama3.2-3b,
     h2o-danube with its window, kimi-k2, llama3-405b, zamba2-2.7b,
     musicgen-medium and internvl2-76b),
     eager and on the device alone,
     beside its bound and the share of it reached, the wrapper's host time
     per call, its plain version's time and one PyTorch library call's time
     (for a window, SDPA with a boolean mask; the line names the kernels
     the library ran); K2 over fp8 and int8 pages under a bf16 q: the
     cluster design at the four decode batches above and at the long
     shapes of step 2 (the map over token pairs at the rows of an odd KV),
     and the upcast mode there (its yardstick SDPA on the upcast cache);
     the sequence split's launches on each half of the reasoning lengths
     at G 16 and of h2o-danube's one kv head a rank over fp8 pages, its
     two cluster passes and the sum; K1's fp32 instance at llama3.2-3b's
     heads (S 1000 and 2048, and S 1000 non-causal), zamba2's and the swa
     equality run's 4200-token prompt under the window, SDPA's fp32 path
     beside it;
  4. greedy tokens of a full-width 2-layer fp32 model served on the card
     equal those of the plain path on the CPU, with and without preemption;
  5. the main path: full-depth llama3.2-3b in bf16 serving 16 requests
     through ``InferenceEngine`` -> ``TorchRunner`` with seeded weights,
     then a shorter traced run of the same model (device busy share,
     kernel times by device symbol: the bf16 tensor-core instances of K1
     and K2 and K2's merge must show time, the fp32 instances none);
  6. the MoE family: greedy tokens of DeepSeek-R1 at full width (2 layers,
     16 of its 256 experts, fp32) on the card equal those of a CPU copy
     under forced preemption (``greedy_equality_moe``); DeepSeek-R1 at
     full width, 5 layers and all 256 experts, and phi3.5-moe at full
     width and 8 layers, in bf16, each serving its requests on the main
     path (``main_path``; R1's MLA launches neither kernel, phi's GQA
     both); a traced run of R1's decode steps (``profile``: device busy
     share, time in matmuls, in the MoE dispatch ranges and elsewhere,
     top kernels);
  7. the rest of the attention decoders: greedy tokens of h2o-danube-3-4b
     at full width (1 layer, fp32) on the card equal those of a CPU copy
     for two 4200-token prompts, so its window binds in K1 and in K2
     (``greedy_equality_swa``); then ``main_path`` in bf16 for qwen3-14b
     (qk-norm, 20 of its 40 layers), h2o-danube-3-4b (full depth, prompts of
     4096-6144 tokens), kimi-k2 (full width, 2 layers: 1 dense, 1 MoE of
     all 384 experts) and llama3-405b (full width, 8 layers), each
     launching both kernels;
  8. the recurrent-state families: greedy tokens of zamba2-2.7b at full
     width (12 layers: 2 groups of its shared attention block, head dim
     80, MHA; fp32) and of xlstm-350m at full width (8 blocks: 7 mLSTM, 1
     sLSTM; fp32) on the card equal those of a CPU copy, each under a
     forced preemption that recomputes the state
     (``greedy_equality_hybrid``, ``greedy_equality_xlstm``); then
     ``main_path`` in bf16 for zamba2-2.7b (18 of its 54 Mamba2 layers, 3
     invocations of the shared block, so K1 and K2 launch in multiples of
     3) and xlstm-350m (8 of its 24 blocks, which launch neither kernel),
     each with its state slot's bytes; and a traced run of zamba2's decode
     steps (``profile``);
  9. the vlm and audio families: internvl2-76b at full width (2 layers,
     fp32) with a prefix of 256 embeddings before 200 text tokens, its
     prefill logits on the card against a CPU copy's, then 8 paged decode
     steps with equal tokens (``prefix_equality``); ``main_path`` in bf16
     for musicgen-medium (24 of its 48 layers, MHA at head dim 64) and
     internvl2-76b (full width, 24 of its 80 layers), each launching both
     kernels;
 10. the capacity-bound regime (``capacity``): llama3.2-3b at 7 of its 28
     layers in bf16 on half the pool its requests need, with naive and with kv-aware
     admission and the engine's sanitizer on, each beside the port's
     ``SimRunner`` on H100 constants for the same requests and engine
     config: the same steps and preemptions on both sides, naive
     preempting and kv-aware not, and the measured TPOT over the sim's.
     Each run's events are written as JSONL under
     ``chiprun_out/capacity_traces/`` and folded by ``repro_torch.obs``,
     in this process and by ``python -m repro_torch.obs report --json`` on
     the file (the two must agree): regime fractions, the windows' verdict
     reasons and the requests' phase totals, card beside sim, and ``python
     -m repro_torch.trace diff`` finds the card's file equal to itself and
     diverging from the sim's; every
     finished card request's span sums to its measured latency, the naive
     card run reads ``capacity_bound`` for some of its time and no window
     of the kv-aware one is a preemption storm. Then ``kv_cache_dtype``:
     llama3.2-3b at 7 layers in bf16 served from an fp8 cache
     (``ParallelContext(kv_cache_dtype=)``, ``SERVE_REQUESTS``, a pool of
     176,160,768 B, half of bf16's) and from an int8 cache, each through
     ``TorchRunner`` launching K1 and the one-launch (cluster) K2 over its
     pages; a
     2-layer fp32 model's tokens from fp8 and int8 caches on a preempting
     pool equal on the card and on the CPU; and the capacity traffic on
     an fp8 cache of the bf16 ``capacity`` run's bytes (768 pages) beside
     ``SimRunner``: equal steps and preemptions. Then ``reasoning_decode``:
     llama3-405b at full width (4 of its 126 layers), bf16 weights, 4
     greedy decode steps of 16 sequences of 12,288-33,792 tokens from a
     seeded fp8 pool, K2 launching only its cluster instance, its step
     time beside K2's device time there. Then ``split_reasoning``: the same
     model, pool and steps with the cache's sequence cut over two gloo
     ranks of a (data 2, model 1) mesh on the card, each rank's pools only
     its half of every table's positions (rows shorter than half hold no
     key on the second rank): tokens equal ``reasoning_decode``'s, the first
     step's logits within a stated share of the unsplit ones', K2's split
     pass 1, pass 2 and sum launched 16 times a rank and no other K2 or K1
     instance; one line a rank with its step time and K2's device time a
     step. Then ``danube_tp8``: h2o-danube-3-4b at full width (2 of its
     24 layers), bf16 weights, served at tp 8 on eight gloo ranks of a
     (data 1, model 8) mesh on the card from an fp8 cache, one kv head of
     120 a rank, 4 prompts of 4,200-4,400 tokens past its window and 8
     greedy tokens each through ``InferenceEngine`` -> ``TorchRunner``:
     K2 launches only its cluster instance of the map over token pairs,
     once a layer a decode step on every rank, its first launch held
     against the plain version; tokens equal the same model's at tp 1 on
     the card but at near ties of the top two logits; one line a rank
     with its collectives, decode step and K2's device time a step. Then
     ``cluster``, on the
     host: ``repro_torch.cluster.ClusterRuntime(sanitize=True)`` over four
     DS-Distill-8B ``SimRunner`` replicas on H100 constants, colocated
     under ``MemoryAware`` routing and disaggregated 2 + 2, serving 40
     Poisson arrivals of the reasoning workload; each fleet summary with
     its regime fractions (virtual-clock times, the perf model's). Then
     ``examples``: ``python -m repro_torch.lint src/repro_torch`` and
     ``plan_deployment --scenario ds8b-4xh200-colocated`` as host
     subprocesses (exit 0); the quickstart's three steps in process on
     full-width llama3.2-3b in bf16 (its engine and planner lines the CPU
     run's), serve_reasoning's real half with naive and kv-aware admission
     on that model (10 requests, 468 tokens, 119 steps and no preemption,
     as on the CPU's reduced model; TTFT, TPOT beside its weight floor,
     throughput), each launching K1 and K2; the reduced model (head dim
     16) refused on the card by the kernel; and ``python -m
     repro_torch.examples.quickstart`` alone printing the same lines;
 11. training, through the autograd forward that launches neither kernel
     (as the reference trains through its jnp attention; each phase
     prints the kernels' launches over its run, which must be 0):
     ``train_equality``, two AdamW steps of llama3.2-3b at full width
     (2 layers, fp32, B 2 x S 64) on the card and on a CPU copy filled
     from the card's initial weights, each step's loss and grad norm and
     the parameters after step 2 held to each other; ``train_main_path``,
     ``repro_torch.launch.train.train`` on full-depth llama3.2-3b (fp32
     weights and AdamW state, B 8 x S 128, 6 steps): per-step loss and
     grad norm, the median step time of steps 2-6, tokens/s, the step's
     FLOPs and its bound at the fp32 peak, and the peak memory beside the
     51.4 GB of weights, gradients and moments; ``train_small``, 60 steps
     of the example's 54.5M-parameter model, its loss falling, then steps
     51-60 again from its step-50 checkpoint in a fresh model and
     optimizer, each loss held to the uninterrupted run's;
 12. multi-device serving, two ranks spawned on the card on a (data 1,
     model 2) mesh over gloo (NCCL refuses two ranks on one device):
     ``sharded_equality``, greedy tokens of llama3.2-3b and DeepSeek-R1 at
     full width (2 layers, fp32; R1 with 16 experts and no capacity drops),
     zamba2-2.7b (12 layers) and xlstm-350m (8 blocks), fp32, through the
     sharded runner equal those of a tp=1 model seeded alike on the card,
     under forced preemption (the recurrent states recomputed in fresh
     slots); ``sharded_main_path``, llama3.2-3b at 4 of its 28 layers, R1
     at 4 layers with all 256 experts, zamba2-2.7b at 6 of its 54 layers
     and xlstm-350m at 8 of its 24 blocks, in bf16, each rank on its
     shard (K1 and K2 on llama's 12 q / 4 kv heads and zamba2's 16 / 16
     heads of 80 a rank, zamba2's in multiples of its shared-block
     invocations; the MoE's split and replicated dispatch across the
     ranks; xlstm launches neither). One line per model and rank: the
     leader's TTFT, TPOT and throughput, each rank's peak memory, kernel
     launches and collectives per engine step with their host time, the
     backend and the ops staged through host memory. Step 2 also
     holds K1 and K2 at llama's and zamba2's per-rank shapes;
 13. multi-device training, four ranks spawned on the card on a (data 2,
     model 2) mesh over gloo (``sharded_train``): two AdamW steps of
     llama3.2-3b at full width (2 layers, fp32, B 4 x S 64) on the mesh
     against tp=1 on the card (losses, grad norms, every parameter after
     step 2, under ``train_equality``'s tolerances; each rank's moments
     its parameter shards); that model's params and AdamW state saved from
     (2,2) and restored onto (1,4), every rank's shards against the
     written arrays; then 2 of llama's 28 layers for 3 steps (B 8 x S
     128): median step time, tokens/s, peak memory and collectives per
     step a rank. No kernel launches;
 14. the dry-run (``dryrun``): every (arch x shape) cell of the
     reference's grid on the 16x16 mesh counted on meta tensors by
     ``repro_torch.launch.dryrun`` (one line a cell: FLOPs, device-memory
     bytes strict and eager, collective wire bytes and counts, the H100
     roofline's terms and bound; the 7 skipped long_500k cells with the
     reference's reason), then two cells run on the card at mesh 1x1
     beside their count (``dryrun_measured``): llama3.2-3b's prefill_32k at
     B 1 (K1) and decode_32k at B 8 x 32,768 tokens (K2), the median of 5
     warm steps by CUDA events and its share of the counted bound, each
     kernel then held against its plain version on the inputs the cell
     gave its first call (``held``; K1 by 1,024-row blocks of queries);
 15. the long decode (``long_decode``): zamba2-2.7b's long_500k cell whole
     on the card (B 1, 524,288 tokens of seeded cache, about 48 GB), its
     decode steps timed against the counted bound, K2 held on its first
     call's inputs (one layer's 524,288-position pool); K2's partials
     (partition by partition) and merge entries held against their plain
     versions and against the one-call decode at the split run's shapes
     and timed (``check_split``,
     ``timing``); then the sequence-split decode on two gloo ranks of a
     (data 2, model 1) mesh on the card (``split_decode``): zamba2-2.7b and
     h2o-danube-3-4b (18 and 12 layers) in bf16, an 8,000-token prompt, each
     rank holding 4,096 positions of the cache, 4 greedy tokens equal to
     the unsplit model's on the card, the partials and the merge launched
     on every rank and one-call K2 never;
 16. the reference's §Perf levers (``levers``), each on gloo ranks on the
     card at full width, 2 layers, fp32, beside the same mesh's baseline
     and tp=1 on the card, seeded alike: ``serve_2d_tp`` (llama3.2-3b,
     (2,2): no weight gathered in the decode steps) and ``moe_ff_shard``
     (phi3.5-moe at 1 layer, no capacity drops, (2,2), replicated
     dispatch: no expert gathered) through
     ``Transformer.prefill``/``decode_step`` on prompts of 12-200 tokens,
     ``seq_shard_decode`` (h2o-danube, (1,2), two prompts past its 4,096
     window: K2's partials and merge, never the one-call K2),
     ``seq_parallel_norm`` and ``decode_unroll`` (llama3.2-3b, (1,2))
     through ``TorchRunner`` with uneven prefill chunks, all with 2 greedy
     tokens equal to the baseline's and tp=1's; and ``train_kv_2d``
     (llama3.2-3b, (2,2), two AdamW steps against tp=1 under
     ``train_equality``'s tolerances). One line a lever and rank (tokens,
     launches, collectives by op, host-clock times); then each lever's
     target cells of the 16x16 grid counted on meta beside the baseline's
     (``levers_dryrun``, counted with the grid in step 14);
 17. the ``kernels`` line (launches summed over every main path, and by
     model and rank; K2's partials and merge entries from the split
     decode; ``levers/<lever>`` the levers phase's; K2 over fp8 and over
     int8 pages with their upcast mode, each also through the map over
     token pairs (``danube_tp8``'s); K2's 8-bit sequence split, its two
     passes and sum from ``split_reasoning``; K1's fp32 instance with its
     launches on the fp32 paths and its timed rows), then the card line,
     then as the last line ``{"ok": true, "device": {...}}``.
For the run's time, every main path but llama3.2-3b's serves
half of its requests' output tokens, the sharded ones a quarter
(``fewer_steps``; each line's ``reduced`` says so).
Each line's ``t_s`` is the seconds since the script started, ``dt_s``
those since the line before. Any
failure raises and exits non-zero. It needs a CUDA card and fails without
one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

# copied from tests/test_kernels.py
FLASH_CASES = [
    # B, Sq, Skv, H, KV, D, window[, lens]
    (1, 128, 128, 4, 4, 64, 0),
    (2, 128, 128, 8, 2, 32, 0),
    (2, 64, 256, 4, 4, 64, 0),
    (1, 256, 256, 6, 2, 128, 0),
    (2, 128, 128, 4, 1, 64, 0),
    (1, 256, 256, 4, 4, 64, 64),
    (1, 192, 192, 4, 2, 64, 32),
    # edges of the bf16 tensor-core instance (128-row q tiles, 128-key tiles)
    (1, 200, 200, 4, 2, 32, 0),              # D 32: 64-byte swizzle
    (2, 200, 200, 4, 2, 64, 0),              # D 64, ragged, lens (200, 100)
    (2, 100, 300, 4, 4, 128, 0),             # Skv > Sq
    (1, 300, 300, 4, 2, 128, 0, [170]),      # lens < Skv, mid-tile
    (2, 130, 130, 2, 2, 64, 0, [0, 65]),     # no valid key: zeros
    (1, 1, 1, 4, 2, 64, 0),                  # one token
    (1, 333, 333, 4, 2, 128, 100),           # window, ragged
    (1, 260, 260, 4, 1, 32, 48, [250]),      # window, D 32, lens < Skv
    # the padded head dims (TMA zero-fills columns D..127 in bf16)
    (1, 300, 300, 8, 2, 112, 0),             # D 112, ragged
    (2, 333, 333, 4, 1, 120, 0),             # D 120, lens (333, 166)
    (1, 400, 400, 8, 8, 112, 100, [390]),    # D 112, window, lens < Skv
    (1, 300, 300, 4, 2, 120, 130),           # D 120, window
    (2, 300, 300, 4, 2, 80, 0),              # D 80, G 2, lens (300, 150)
    (1, 333, 333, 4, 4, 80, 100, [250]),     # D 80, MHA, window, lens < Skv
    # edges of the fp32 instance (64-row q tiles, 64-key tiles; v rows of
    # D rounded up to 16, a lane's columns in pieces of 4, 2 and 1)
    (1, 65, 65, 4, 2, 128, 0),               # one row and one key past a tile
    (2, 191, 191, 8, 2, 120, 0),             # ragged, D 120, lens (191, 95) mid-tile
    (1, 250, 250, 4, 4, 112, 40, [201]),     # window edge inside a tile, D 112
    (1, 129, 129, 6, 3, 80, 0, [0]),         # lens 0: zeros, D 80
    (2, 64, 64, 4, 2, 32, 0, [64, 0]),       # one whole tile, lens 0, D 32
    (1, 200, 200, 8, 2, 128, 63, [170]),     # window 63, lens mid-tile
]
PAGED_CASES = [
    # B, KV, G, D, page, P, nblk[, tokens of each sequence]
    (2, 2, 4, 64, 16, 16, 4),
    (3, 4, 1, 64, 16, 32, 6),
    (1, 1, 8, 128, 16, 8, 8),
    (4, 2, 2, 32, 16, 64, 3),
    # partition edges of the split kernel (16 pages = 256 tokens), tables
    # padded past each sequence's pages
    (5, 2, 3, 128, 16, 512, 128, [1, 255, 256, 257, 2048]),
    (1, 8, 3, 128, 16, 256, 128, [2048]),    # B=1, one long sequence
    (3, 2, 1, 64, 16, 64, 40, [300, 17, 640]),   # G 1
    (2, 1, 8, 128, 16, 64, 36, [513, 16]),   # G 8
    # the padded head dims, the second query tile (G 9..16) and the window
    # (last field), its edge inside a partition or on a partition boundary
    (2, 2, 9, 128, 16, 64, 40, [513, 40]),             # G 9: half a second tile
    (2, 2, 5, 128, 16, 64, 40, [600, 100]),            # qwen3-14b: G 5
    (2, 2, 16, 112, 16, 128, 40, [600, 300], 100),     # edges inside partitions
    (2, 2, 4, 120, 16, 128, 40, [513, 40], 257),       # edge on a boundary;
                                                       # window > sequence
    (1, 1, 9, 120, 16, 64, 40, [620], 108),            # edge on a boundary
    (2, 2, 3, 64, 16, 64, 40, [384, 17], 1000),        # window past every sequence
    (4, 32, 1, 80, 16, 512, 80, [1280, 256, 257, 17]),  # D 80, G 1: partition edges
    (3, 2, 2, 80, 16, 64, 40, [513, 40, 256]),         # D 80, G 2
    (2, 2, 1, 80, 16, 64, 40, [600, 300], 100),        # D 80, window
]
# the main path's shapes: llama3.2-3b has 24 q heads over 8 kv heads of 128
MAIN_FLASH = [(1, S, S, 24, 8, 128, 0) for S in (512, 2048)]
# served prompts are ragged (ISL 128-1024): partial q and kv tiles
RAGGED_FLASH = [(1, S, S, 24, 8, 128, 0) for S in (1000, 137)]
MAIN_PAGED = dict(B=16, KV=8, G=3, D=128, max_ctx=2048)
# phi3.5-moe's main path: 32 q heads over 8 kv heads of 128 (G=4), 8
# requests of up to 1024 + 128 tokens
PHI_FLASH = [(1, S, S, 32, 8, 128, 0) for S in (1000, 137)]
PHI_PAGED = dict(B=8, KV=8, G=4, D=128, max_ctx=1152)
# one sequence alone: the case the split over the sequence is for
LONG_PAGED = dict(B=1, KV=8, G=3, D=128, max_ctx=2048)
# the rest of the attention decoders: qwen3-14b (40 q / 8 kv heads of 128),
# h2o-danube-3-4b (32 / 8 of 120, window 4096), kimi-k2 (64 / 8 of 112) and
# llama3-405b (128 / 8 of 128); prompts as served, decode batches of 16 at
# the contexts their traffic reaches
DANUBE_WINDOW = 4096
GQA_FLASH = [(1, 1000, 1000, 40, 8, 128, 0),
             (1, 5000, 5000, 32, 8, 120, DANUBE_WINDOW),
             (1, 1000, 1000, 64, 8, 112, 0),
             (1, 1000, 1000, 128, 8, 128, 0)]
DANUBE_PAGED = dict(B=16, KV=8, G=4, D=120, min_ctx=4096, max_ctx=6400,
                    window=DANUBE_WINDOW)
KIMI_PAGED = dict(B=16, KV=8, G=8, D=112, max_ctx=1280)
L405_PAGED = dict(B=16, KV=8, G=16, D=128, max_ctx=1280)
GQA_PAGED = [DANUBE_PAGED, KIMI_PAGED, L405_PAGED]
# zamba2-2.7b's shared attention block: 32 q heads over 32 kv heads of 80
# (MHA, G 1); a served prompt, and its decode batch of 16 at contexts of
# 128-1280 tokens
ZAMBA_FLASH = [(1, 1000, 1000, 32, 32, 80, 0)]
ZAMBA_PAGED = dict(B=16, KV=32, G=1, D=80, max_ctx=1280)
# the vlm and audio backbones: musicgen-medium (24 q / 24 kv heads of 64,
# MHA) and internvl2-76b (64 / 8 heads of 128, G 8) at a served prompt, and
# internvl2 at its 256 prefix embeddings plus 200 text tokens; their
# decode batches of 16 at contexts of 128-1280 tokens
INTERNVL_PREFIX, INTERNVL_TEXT = 256, 200
VLM_AUDIO_FLASH = [(1, 1000, 1000, 24, 24, 64, 0),
                   (1, 1000, 1000, 64, 8, 128, 0),
                   (1, INTERNVL_PREFIX + INTERNVL_TEXT,
                    INTERNVL_PREFIX + INTERNVL_TEXT, 64, 8, 128, 0)]
MUSICGEN_PAGED = dict(B=16, KV=24, G=1, D=64, max_ctx=1280)
INTERNVL_PAGED = dict(B=16, KV=8, G=8, D=128, max_ctx=1280)
# K1's non-causal mode (the reference wrapper's ``causal=False``) with a
# scale of its own: (B, Sq, Skv, H, KV, D, window, lens, scale); Sq != Skv,
# lens < Skv, with and without a window. No caller on the main path uses it.
NONCAUSAL_FLASH = [
    (2, 200, 333, 8, 2, 64, 0, [333, 170], 0.09),
    (1, 300, 137, 4, 4, 80, 0, [100], 0.2),
    (2, 130, 500, 8, 2, 128, 0, [450, 257], 0.06),
    (1, 257, 400, 4, 2, 128, 100, [390], 0.1),
    (1, 1000, 1000, 24, 8, 128, 0, [1000], 128 ** -0.5),
    (1, 500, 2000, 24, 8, 128, 0, [2000], 128 ** -0.5),
    # edges of the fp32 instance's 64-row and 64-key tiles
    (1, 65, 129, 4, 2, 128, 0, [100], 0.1),          # ragged q, lens mid-tile
    (2, 191, 200, 8, 2, 120, 40, [200, 77], 0.08),   # window edge inside a tile
    (1, 64, 64, 4, 4, 112, 0, [0], 0.125),           # lens 0: zeros
    (2, 130, 65, 4, 1, 80, 0, [65, 1], 0.2),         # one key past a tile, lens 1
]
# its timing rows: llama3.2-3b's heads at S 1000, and queries of 500 over
# 2,000 keys
NONCAUSAL_TIMED = [(1, 1000, 1000, 24, 8, 128, 0), (1, 500, 2000, 24, 8, 128, 0)]
# K1's fp32 instance (the fp32 equality runs' and levers' prefills):
# llama3.2-3b's heads at S 1000 and 2048, zamba2's, the swa equality run's
# 4200-token prompt under h2o-danube's window, and S 1000 non-causal;
# (case, causal)
FP32_FLASH_TIMED = [((1, 1000, 1000, 24, 8, 128, 0), True),
                    ((1, 2048, 2048, 24, 8, 128, 0), True),
                    ((1, 1000, 1000, 32, 32, 80, 0), True),
                    ((1, 4200, 4200, 32, 8, 120, DANUBE_WINDOW), True),
                    ((1, 1000, 1000, 24, 8, 128, 0), False)]
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
# limit on |out - ref|_2 / |ref|_2 over a whole output: bf16 roundings of
# q*scale, P and out give about 3e-3, while a dropped key tile or sequence
# partition shifts the rows it touches by far more than 1e-2
REL_RMS = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# every device kernel each wrapper launches, as the profiler names it; a
# bf16 run must show only the tensor-core instances
KERNEL_SYMBOLS = {"flash_attention": ("flash_fwd_wgmma", "flash_fwd_simt"),
                  "paged_attention": ("paged_split_mma", "paged_split_simt",
                                      "paged_merge")}
FP32_ONLY_SYMBOLS = ("flash_fwd_simt", "paged_split_simt")
# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside the tensor cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SERVE_REQUESTS = dict(n=16, isl=(128, 1024), osl=(128, 256), seed=0)
# cuts for the run's time (each stands in its phase's line as
# ``reduced``): llama3.2-3b at 7 of its 28 layers in ``capacity`` and the
# ``kv_cache_dtype`` serves (their scheduling, pools' pages and checks are
# the same at any depth); musicgen-medium at 24 of 48 layers and qwen3-14b
# at 20 of 40 in ``main_path``, and every main path but llama3.2-3b's at
# half its requests' output tokens (``fewer_steps``), the sharded ones at a
# quarter; h2o-danube at 1 layer and 8 new tokens in
# ``greedy_equality_swa``, R1 at 12 new tokens in ``greedy_equality_moe``;
# ``split_decode`` at 18 of zamba2's 54 layers and 12 of h2o-danube's 24
CAPACITY_LAYERS = 7
MUSICGEN_LAYERS = 24
QWEN3_LAYERS = 20
SWA_EQ = dict(layers=1, new_tokens=8)
MOE_EQ_NEW_TOKENS = 12
SPLIT_LAYERS = {"zamba2-2.7b": 18, "h2o-danube-3-4b": 12}


def fewer_steps(traffic, reduced, div=2):
    """``traffic`` with its output lengths over ``div`` (fewer decode steps
    a request), and ``reduced`` with that cut."""
    cut = dict(traffic, osl=tuple(max(1, n // div) for n in traffic["osl"]))
    return cut, {**reduced, "osl": [list(traffic["osl"]), list(cut["osl"])]}
# the MoE family's main path: DeepSeek-R1 at full width with its depth cut
# to the 3 leading dense layers and 2 MoE layers (about 53 GB of bf16
# weights), and phi3.5-moe at full width and 8 of its 32 layers, with
# fewer and shorter requests to keep the run short
R1_LAYERS = 5
PHI_LAYERS = 8
PHI_REQUESTS = dict(n=8, isl=(128, 1024), osl=(64, 128), seed=0)
# h2o-danube's prompts are longer than its window of 4096, so the window
# binds in every prefill and decode step
DANUBE_REQUESTS = dict(n=16, isl=(4096, 6144), osl=(128, 256), seed=0)
# kimi-k2 at full width cut to its dense layer and one MoE layer of all 384
# experts (about 40 GB of bf16 weights); llama3-405b at full width cut to 8
# of its 126 layers (about 59 GB)
KIMI_LAYERS = 2
L405_LAYERS = 8
# xlstm-350m's prefill is a loop over every token of every block (about a
# dozen small kernels a token a block, bound by the host), so it serves
# phi3.5-moe's fewer and shorter requests
XLSTM_REQUESTS = PHI_REQUESTS
# the recurrent main paths cut for the run's time: zamba2-2.7b at 18 of
# its 54 layers (3 invocations of its shared attention block), xlstm-350m
# at 8 of its 24 blocks (7 mLSTM, 1 sLSTM; its prefill loops over tokens)
ZAMBA_MAIN_LAYERS = 18
XLSTM_MAIN_BLOCKS = 8
STARTED = time.perf_counter()
# internvl2-76b at full width cut to 24 of its 80 layers (about 45.3 GB of
# bf16 weights); musicgen-medium whole
INTERNVL_LAYERS = 24
# prefix_equality: internvl2 at full width and 2 layers in fp32; its
# prefill logits on the card (K1) against the CPU plain path within
# PREFIX_ATOL times the largest logit (fp32 sums over d 8192 and d_ff 28672
# taken in another order differ by about 1e-5 of it)
PREFIX_LAYERS = 2
PREFIX_DECODE_STEPS = 8
PREFIX_ATOL = 1e-3
# train_equality: llama3.2-3b at full width and 2 layers in fp32, 2 AdamW
# steps (lr 1e-3, warmup 2) at B 2 x S 64 on the card and on the CPU. The
# same fp32 products summed in another order: losses within TRAIN_LOSS_RTOL,
# grad norms within TRAIN_GNORM_RTOL; after step 2 every parameter within
# TRAIN_PARAM_ATOL (a step moves one by about lr, rounding that by about
# 1e-7) but for at most TRAIN_FLIP_SHARE of them, each within 4 lr: an
# element whose first moment sits within rounding of zero takes its Adam
# step in either direction (tests/test_torch_train.py counts them on the CPU).
# cut from 3 steps for the run's time
TRAIN_EQ = dict(layers=2, batch=2, seq=64, steps=2, lr=1e-3, warmup=2)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
TRAIN_FLIP_SHARE = 1e-4
# train_main_path: the reference launcher's defaults (B 8 x S 128, fp32
# weights and AdamW state) on full-depth llama3.2-3b, 6 steps; the median
# is over steps 2-6
TRAIN_MAIN = dict(batch=8, seq=128, steps=6)
# train_small: the example's 60 steps, resumed from its step-50 checkpoint;
# each resumed loss within TRAIN_RESUME_RTOL of the uninterrupted run's (the
# same kernels on bitwise the same state and batches; under
# torch.use_deterministic_algorithms the embedding's backward sorts instead
# of adding atomically, so the losses are expected to be equal)
TRAIN_SMALL = dict(steps=60, resume_from=50)
TRAIN_RESUME_RTOL = 1e-6
# the sharded phases: two ranks on the one card, a (data 1, model 2) mesh
# over a gloo group (NCCL refuses two ranks on one device). llama3.2-3b at
# tp 2 runs K1 and K2 on 12 q / 4 kv heads a rank (G 3): its prompts as
# served, its decode batch of 16
SHARDED_MESH = (1, 2)
RANK_FLASH = [(1, S, S, 12, 4, 128, 0) for S in (1000, 137)]
RANK_PAGED = dict(B=16, KV=4, G=3, D=128, max_ctx=2048)
# zamba2-2.7b at tp 2: its shared block runs K1 and K2 on 16 q / 16 kv heads
# of 80 a rank (MHA, G 1): a served prompt, and its decode batch of 16 at
# contexts of 128-1280 tokens
ZAMBA_RANK_FLASH = [(1, 1000, 1000, 16, 16, 80, 0)]
ZAMBA_RANK_PAGED = dict(B=16, KV=16, G=1, D=80, max_ctx=1280)
# sharded_equality: four 30-token prompts, MOE_EQ_NEW_TOKENS new tokens
# each (cut from 20), on a 7-page pool (the engine preempts), as
# greedy_equality_moe
SHARDED_EQ_ENGINE = dict(n_pages=7, max_num_seqs=4, max_num_batched_tokens=512,
                         chunk_size=192, admission_mode="naive")
# the recurrent families' sharded_equality: greedy_equality_hybrid's and
# greedy_equality_xlstm's requests and pools (one preemption each, the
# state recomputed in a fresh slot)
HYBRID_EQ_ENGINE = dict(n_pages=36, max_num_seqs=2, max_num_batched_tokens=2048,
                        chunk_size=512, admission_mode="naive")
XLSTM_EQ_ENGINE = dict(HYBRID_EQ_ENGINE, n_pages=15)
# sharded_train: four ranks on the card, a (data 2, model 2) mesh over gloo;
# llama3.2-3b at full width in the train layout (FSDP over "data", TP over
# "model", AdamW moments as their parameters' shards). Equality: 2 layers,
# B 4 x S 64, 2 steps (cut from 3) against tp=1 on the card under train_equality's
# tolerances; its params and AdamW state are then saved from (2,2) and
# restored onto (1,4). Main path: 2 of 28 layers (full depth, 51.4 GB of
# fp32 weights, gradients and moments, plus each rank's gathered fp32
# weights kept for the backward, does not fit beside four CUDA contexts;
# 2 keeps the whole run in its time), the reference launcher's B 8 x S 128, 3 steps (cut
# from 4); the median over steps 2-3
SHARDED_TRAIN_MESH = (2, 2)
# the sharded main paths, cut to keep the whole run in its time: 6 of
# zamba2's 54 Mamba2 layers (1 invocation of its shared block, whose K1 and
# K2 still run at 16 heads of 80 a rank; 93 s of gloo-bound engine time
# whole), 8 of xlstm's 24 blocks, 4 of llama3.2-3b's 28 layers (cut from
# 8) and 4 of R1's 61 (3 dense + 1 MoE; cut from 5)
SHARDED_ZAMBA_LAYERS = 6
SHARDED_XLSTM_BLOCKS = 8
SHARDED_LLAMA_LAYERS = 4
SHARDED_R1_LAYERS = 4   # 3 dense + 1 MoE; the single card's R1_LAYERS is 5
SHARDED_TRAIN_EQ = dict(layers=2, batch=4, seq=64, steps=2, lr=1e-3, warmup=2)
SHARDED_TRAIN_MAIN = dict(layers=2, batch=8, seq=128, steps=3)
# the capacity runs' recorded events, one JSONL file a run (gitignored)
TRACE_DIR = ROOT / "chiprun_out" / "capacity_traces"
# the host-only fleet: four DS-Distill-8B replicas on H100 constants, 40
# Poisson arrivals of the reasoning workload (output capped so that the
# phase takes seconds)
CLUSTER_TRACE = dict(n=40, rate=8.0, osl_cap=800, seed=0)
CLUSTER_WORKER = dict(n_pages=3000, max_seqs=64)
# what the examples print or serve on the CPU's reduced model (``--smoke
# --device cpu``); the full-width model on the card must serve the same
# lengths in the same steps, since the scheduler reads no clock
QUICKSTART_ENGINE = "[2] engine: 5 requests, 40 tokens, preemptions=0"
QUICKSTART_PLANNER = ("[3] planner: llama3.2-3b on 64x v5e -> DP=8+TP=8 (~76772 "
                      "decode tok/s, 256 concurrent reqs/replica)")
REASONING_REAL = dict(n_finished=10, gen_tokens=468, preemptions=0,
                      recomputed_tokens=0, steps=119)


def emit(phase: str, **kw):
    """One phase's JSON line; ``t_s`` is the seconds since the script
    started and ``dt_s`` those since the line before (the phase's own, for
    a phase of one line), so the lines show where the run's time goes."""
    now = time.perf_counter()
    print(json.dumps({"phase": phase, **kw, "t_s": now - STARTED,
                      "dt_s": now - _LAST_EMIT[0]}), flush=True)
    _LAST_EMIT[0] = now


_LAST_EMIT = [STARTED]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs
def flash_inputs(case, dtype, gen):
    B, Sq, Skv, H, KV, D, window = case[:7]
    dev = torch.device("cuda")
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    lens = case[7] if len(case) > 7 else [Skv] + [max(Skv // 2, 1)] * (B - 1)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev), window


def paged_case_inputs(case, dtype, gen):
    """q, pages, tables, lens, and the window (0: none)."""
    B, KV, G, D, page, P, nblk = case[:7]
    dev = torch.device("cuda")
    q = torch.randn((B, KV, G, D), generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((P, page, KV, D), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    tables = torch.randint(0, P, (B, nblk), generator=gen, device=dev,
                           dtype=torch.int32)
    if len(case) > 7:
        lens = [n - 1 for n in case[7]]
    else:
        lens = [nblk * page - 1] + [page // 2] * (B - 1)
    window = case[8] if len(case) > 8 else 0
    return (q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32, device=dev),
            window)


def paged_main_inputs(dtype, gen, m=MAIN_PAGED):
    """B sequences of min_ctx (default 128) to max_ctx tokens in shuffled
    pages of one pool (the first holds max_ctx)."""
    B, KV, G, D, page = m["B"], m["KV"], m["G"], m["D"], 16
    rng = np.random.default_rng(1)
    ctx = rng.integers(m.get("min_ctx", 128), m["max_ctx"] + 1, size=B)
    ctx[0] = m["max_ctx"]
    n_blocks = -(-ctx // page)
    P = int(n_blocks.sum()) + 64
    perm = rng.permutation(P).astype(np.int32)
    tables = np.zeros((B, int(n_blocks.max())), np.int32)
    used = 0
    for b, n in enumerate(n_blocks):
        tables[b, :n] = perm[used:used + n]
        used += n
    dev = torch.device("cuda")
    q = torch.randn((B, KV, G, D), generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((P, page, KV, D), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ctx - 1).to(dev, torch.int32))


# ------------------------------------------------------------------ phases
def hold(label, out, ref, dtype):
    """``out`` against ``ref``: finite, within TOL of each element (abs
    plus rel), and within REL_RMS of ``ref``'s norm in all (a dropped key
    tile or partition moves rows by far more than that, yet may stay inside
    TOL). Returns (max abs err, relative rms err)."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(out.shape)}, want "
                             f"{tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite output")
    diff = (out - ref).abs()
    tol = TOL[dtype]
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= tol + tol * ref.abs()).all()):
        raise AssertionError(f"{label}: max abs err {err} beyond tol {tol}")
    rel = float(diff.norm() / ref.norm().clamp_min(1e-30))
    if rel > REL_RMS[dtype]:
        raise AssertionError(f"{label}: relative rms err {rel} beyond "
                             f"{REL_RMS[dtype]}")
    return err, rel


def compare(fn, plain, args, kwargs, dtype):
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return hold(f"{fn.__name__} at {[tuple(a.shape) for a in args[:3]]}", out,
                plain(*args, **kwargs), dtype)


def check_kernels(flash_ops, paged_ops):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": [], "paged_attention": []}
    rels = {"flash_attention": [], "paged_attention": []}
    noncausal = []
    fp32_flash = []   # K1's fp32 instance, causal and not
    for dtype in (torch.float32, torch.bfloat16):
        for case in (FLASH_CASES + MAIN_FLASH + RAGGED_FLASH + PHI_FLASH
                     + GQA_FLASH + ZAMBA_FLASH + VLM_AUDIO_FLASH + RANK_FLASH
                     + ZAMBA_RANK_FLASH):
            q, k, v, lens, window = flash_inputs(case, dtype, gen)
            err, rel = compare(
                flash_ops.flash_attention, flash_ops.flash_attention_plain,
                (q, k, v, lens), {"window": window}, dtype)
            errs["flash_attention"].append(err)
            rels["flash_attention"].append(rel)
            if dtype == torch.float32:
                fp32_flash.append(err)
        for B, Sq, Skv, H, KV, D, window, lens, scale in NONCAUSAL_FLASH:
            q, k, v, lt, _ = flash_inputs((B, Sq, Skv, H, KV, D, window, lens), dtype, gen)
            count = flash_ops.NONCAUSAL.launches
            err, rel = compare(
                flash_ops.flash_attention, flash_ops.flash_attention_plain,
                (q, k, v, lt), {"causal": False, "window": window, "scale": scale},
                dtype)
            if flash_ops.NONCAUSAL.launches != count + 1:
                raise AssertionError("flash_attention(causal=False) did not launch "
                                     "the non-causal instance")
            errs["flash_attention"].append(err)
            rels["flash_attention"].append(rel)
            noncausal.append(err)
            if dtype == torch.float32:
                fp32_flash.append(err)
        cases = [paged_case_inputs(c, dtype, gen) for c in PAGED_CASES]
        mains = [(*paged_main_inputs(dtype, gen, m), m.get("window", 0))
                 for m in (MAIN_PAGED, LONG_PAGED, PHI_PAGED, *GQA_PAGED,
                           ZAMBA_PAGED, MUSICGEN_PAGED, INTERNVL_PAGED,
                           RANK_PAGED, ZAMBA_RANK_PAGED)]
        for *args, window in cases + mains:
            err, rel = compare(
                paged_ops.paged_attention, paged_ops.paged_attention_plain,
                tuple(args), {"window": window}, dtype)
            errs["paged_attention"].append(err)
            rels["paged_attention"].append(rel)
    # the blocks of query rows that hold K1 at a dry-run cell's shape
    # (``hold_at_cell``) make up the plain version
    q, k, v, _, _ = flash_inputs((1, 2048, 2048, 24, 8, 128, 0), torch.float32, gen)
    for w in (0, 300):
        hold(f"flash_rows_plain window {w}", torch.cat(
            [flash_rows_plain(q, k, v, r, r + 512, w) for r in range(0, 2048, 512)], 1),
            flash_ops.flash_attention_plain(q, k, v, window=w), torch.float32)
    for name, e in errs.items():
        emit("check", kernel=name, cases=len(e), max_abs_err=max(e),
             max_rel_rms=max(rels[name]), errs=[float(f"{x:.3g}") for x in e],
             rel_rms=[float(f"{x:.3g}") for x in rels[name]])
    emit("check", kernel="flash_attention", mode="causal=False",
         cases=len(noncausal), max_abs_err=max(noncausal))
    emit("check", kernel="flash_attention", dtype="float32", cases=len(fp32_flash),
         max_abs_err=max(fp32_flash))
    return {name: max(e) for name, e in errs.items()} | {
        "flash_attention causal=False": max(noncausal),
        "flash_attention float32": max(fp32_flash)}


def time_ms(fn, iters, warmup=3):
    """Mean time of one call, by CUDA events around ``iters`` eager calls
    (device time, or the host's enqueue time where that is longer), and
    the host's own time to make one call (the wrapper's checks, allocation
    and launch), by the host's clock over the same calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_ms(fn, iters, warmup=3):
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, so the host's per-call cost (the
    wrapper's checks, allocation and launch) is not in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timed(kernel, library, iters, bound_ms):
    """A kernel's and its library call's times, eager (``ms``,
    ``library_ms``: what a caller of the wrapper waits for, and the
    measure of earlier rows) and on the device alone (``device_ms``,
    ``library_device_ms``), with the host's time per wrapper call and the
    share of the bound reached by each measure."""
    ms, host_ms = time_ms(kernel, iters)
    dev = device_ms(kernel, iters)
    return dict(ms=ms, device_ms=dev, host_ms=host_ms,
                library_ms=time_ms(library, iters)[0],
                library_device_ms=device_ms(library, iters),
                bound_share=bound_ms / ms, device_bound_share=bound_ms / dev)


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def library_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs (which backend a
    library call took), from a trace of that call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({evt.name[:80] for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA})


def time_flash(flash_ops, case, dtype, gen, causal=True):
    """K1's row at ``case``; ``causal=False`` times the non-causal instance
    (every key below lens, Sq and Skv independent) against SDPA with
    ``is_causal=False``."""
    import torch.nn.functional as F
    q, k, v, lens, window = flash_inputs(case, dtype, gen)
    B, Sq, Skv, H, KV, D, _ = case[:7]
    lens_np = lens.cpu().numpy()
    # (q, k) pairs these inputs need: row i sees the keys from
    # max(0, i - window + 1) to min(i, lens[b] - 1), or, non-causal, to
    # lens[b] - 1
    rows = np.arange(Sq)
    first = np.maximum(0, rows - window + 1) if window > 0 else np.zeros_like(rows)
    pairs = sum(int(np.maximum(np.minimum(rows + 1 if causal else Skv, lb) - first,
                               0).sum()) for lb in lens_np)
    flops = 4 * D * H * pairs
    # no causal argument for the causal rows: tools/ab_main_path.py times
    # wrappers of trees that take none
    kw = {"window": window} if causal else {"window": window, "causal": False}
    out = flash_ops.flash_attention(q, k, v, lens, **kw)
    b_ms, b_by = bound(flops, nbytes(q, k, v, lens, out), dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kernel = lambda: flash_ops.flash_attention(q, k, v, lens, **kw)  # noqa: E731
    if not causal:  # every sequence is whole here (B 1, lens = Skv)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=False, enable_gqa=True)
    elif window > 0:  # every sequence is whole here (B 1, lens = Skv)
        pos = torch.arange(Skv, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    t = timed(kernel, library, 20, b_ms)
    return dict(
        shape=list(case[:6]), window=window, causal=causal,
        dtype=str(dtype).split(".")[-1], **t,
        bound_ms=b_ms, bound_by=b_by, library_kernels=library_kernels(library),
        plain_ms=time_ms(lambda: flash_ops.flash_attention_plain(
            q, k, v, lens, **kw), 5)[0],
        flops=flops, tflop_s=flops / t["ms"] / 1e9,
        device_tflop_s=flops / t["device_ms"] / 1e9)


def time_paged(paged_ops, dtype, gen, m=MAIN_PAGED):
    import torch.nn.functional as F
    q, kp, vp, tables, lens = paged_main_inputs(dtype, gen, m)
    window = m.get("window", 0)
    B, KV, G, D = q.shape
    # the tokens these inputs need: each sequence's last min(lens + 1, window)
    counted = lens.long() + 1
    if window > 0:
        counted = counted.clamp(max=window)
    tokens = int(counted.sum())
    flops = 4 * G * D * KV * tokens
    # no window argument where there is none: tools/ab_main_path.py times
    # wrappers of trees that take none
    kw = {"window": window} if window else {}
    out = paged_ops.paged_attention(q, kp, vp, tables, lens, **kw)
    elem = q.element_size()
    needed = 2 * tokens * KV * D * elem + nbytes(q, out, tables, lens)
    b_ms, b_by = bound(flops, needed, dtype)
    # the library yardstick reads the same pages gathered into a contiguous
    # cache (gathered outside the timed region)
    S = tables.shape[1] * kp.shape[1]
    kc, vc = (p[tables.long()].reshape(B, S, KV, D).transpose(1, 2).contiguous()
              for p in (kp, vp))
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos <= lens[:, None].long()
    if window > 0:
        mask = mask & (pos > lens[:, None].long() - window)
    mask = mask[:, None, None, :]
    qh = q.reshape(B, KV * G, 1, D)
    kernel = lambda: paged_ops.paged_attention(  # noqa: E731
        q, kp, vp, tables, lens, **kw)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kc, vc, attn_mask=mask, enable_gqa=True)
    t = timed(kernel, library, 50, b_ms)
    return dict(
        shape=[B, KV, G, D], window=window, contexts=(lens + 1).tolist(),
        dtype=str(dtype).split(".")[-1], **t, bound_ms=b_ms, bound_by=b_by,
        library_kernels=library_kernels(library),
        plain_ms=time_ms(lambda: paged_ops.paged_attention_plain(
            q, kp, vp, tables, lens, **kw), 10)[0],
        bytes=needed, gb_s=needed / t["ms"] / 1e6,
        device_gb_s=needed / t["device_ms"] / 1e6)


# ------------------------------------------- K2 over pages of another dtype
# (pages, q) dtypes of the kernels for a cache of the reference's
# kv_cache_dtype: the default mode (decode_attention's function) and the
# one-pass upcast mode (decode_unroll's)
Q8_PAIRS = ((torch.float8_e4m3fn, torch.bfloat16), (torch.float8_e4m3fn, torch.float32),
            (torch.int8, torch.bfloat16), (torch.int8, torch.float32),
            (torch.bfloat16, torch.float32))
# fp32 pages under a bf16 q: the upcast mode only (the default rounds
# nothing: the fp32 K2 on q in fp32)
Q8_UPCAST_ONLY = ((torch.float32, torch.bfloat16),)
# the table's K2 shapes: llama3.2-3b's decode batch (shuffled pages),
# h2o-danube's window at D 120, llama3-405b's G 16, zamba2's D 80 at G 1;
# the default mode runs the one-launch cluster design at each
Q8_PAGED = [MAIN_PAGED, DANUBE_PAGED, L405_PAGED, ZAMBA_PAGED]
# a small batch past the cluster's old scores limit (13,000 tokens, past
# 12,288 at G 16): the cluster design
Q8_TWO_PASS = dict(B=2, KV=8, G=16, D=128, min_ctx=12_400, max_ctx=13_000)
# reasoning lengths (the reference's REASONING outputs up to 32,768 tokens
# after prompts up to 1,024, past K2's old limits at G 16 and G 8): 16
# contexts of 12,288-33,792 tokens drawn from a seed, at llama3-405b's G 16
# and internvl2-76b's G 8 (kv 8 of 128): the cluster design
Q8_REASONING = [dict(B=16, KV=8, G=16, D=128, min_ctx=12_288, max_ctx=33_792),
                dict(B=16, KV=8, G=8, D=128, min_ctx=12_288, max_ctx=33_792)]
# 60,000-65,536 tokens at G 16: past the scores a block's shared memory
# keeps at any cluster size, so each block's last pages are its overflow,
# their k read again in the same launch
Q8_OVERFLOW = dict(B=2, KV=8, G=16, D=128, min_ctx=60_000, max_ctx=65_536)
# 8-bit rows of D 120 under an odd KV (a token's KV x 120 bytes no 16-byte
# stride): one rank's kv head of h2o-danube at tp 8, its window, and the
# same rows under three kv heads (an even head's box shifted 8 bytes in the
# pair's second half); the cluster designs read them through the map over
# token pairs (bf16 pages' rows of 240 bytes take the per-head map there)
Q8_ODD_KV = [dict(B=16, KV=1, G=4, D=120, min_ctx=4096, max_ctx=6400, window=4096),
             dict(B=16, KV=3, G=4, D=120, min_ctx=4096, max_ctx=6400, window=4096)]
# the default mode's shapes past the four main batches: the cluster design
# at each
Q8_MORE = [Q8_TWO_PASS, *Q8_REASONING, Q8_OVERFLOW, *Q8_ODD_KV]
# the default mode against the plain version: fp32 sums in another order
# (1e-4 of the values' scale), the output's rounding to q's dtype (2^-8 of
# it in bf16) and ``weight_slack`` (a weight near a rounding boundary of the
# pages' dtype may round to the other neighbour); the upcast mode: TOL and
# REL_RMS times the values' scale
Q8_ATOL = 1e-4
# the upcast mode's shapes over 8-bit pages under a bf16 q, its one-launch
# cluster design at each: the four main batches, reasoning lengths and the
# rows of an odd KV
Q8_UPCAST = [*Q8_PAGED, *Q8_REASONING, *Q8_ODD_KV]
# K2's rows timed under a bf16 q: (pages, upcast, shape); the default mode
# over 8-bit pages at the four shapes and past them (``Q8_MORE``), the
# upcast mode's cluster at ``Q8_UPCAST``, and its split design over fp32
# pages at llama3.2-3b's batch
Q8_TIMED = tuple((p, False, m) for m in (*Q8_PAGED, *Q8_MORE)
                 for p in (torch.float8_e4m3fn, torch.int8)) + tuple(
    (p, True, m) for m in Q8_UPCAST for p in (torch.float8_e4m3fn, torch.int8)) + (
    (torch.float32, True, MAIN_PAGED),)
# the sequence split's passes (``paged_attention_stats`` ->
# ``paged_attention_values`` -> ``paged_sum``) at the default mode's four
# main batches, at reasoning lengths and at the rows of an odd KV, each
# table cut into rank shares (``split_shares``): its two halves, and the
# whole table then a share that holds no key; every pair, int8 also under
# ``INT8_QX``
Q8_SPLIT = [*Q8_PAGED, *Q8_REASONING, *Q8_ODD_KV]
SPLIT_CUTS = ("halves", "empty")
# each share's (m, l) and scores against the plain version's: within this
# share of the scores' scale (fp32 sums of exact products in another
# order) and, for l, of its value (ex2.approx within 2^-21 a term)
SPLIT_ML_TOL = 1e-4
SPLIT_L_RTOL = 1e-3
# int8 pages are also checked under q times these, where q*scale truncates
# to non-zero integers and the plain output is not zeros: at x12 most
# rows' largest weight lies in [0.5, 1) (truncated to 0, where rounding to
# nearest gives 1), at x40 most rows' is exactly 1 (the output is that
# key's v). At x1 q*scale truncates to 0 and the output is zeros.
INT8_QX = (12.0, 40.0)


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def q8_instance(paged_ops, qdt, pages, m, design):
    """The name the wrappers give the instance that runs ``design`` over
    ``pages`` under a ``qdt`` q at ``m``'s rows: " paired" after a cluster
    that reads them through the map over token pairs."""
    paired = design == "cluster" and paged_ops.page_map(
        m["D"], m["KV"], torch.empty((), dtype=pages).element_size()) == "paired"
    return f"{_dt(qdt)}/{_dt(pages)} {design}" + (" paired" if paired else "")


def q8_inputs(pages, qdt, gen, m, qx=1.0):
    """``paged_main_inputs`` at ``m`` with q times ``qx`` in ``qdt`` and
    pages cast to ``pages`` as the cache casts (int8's values times 3:
    small integers)."""
    from repro_torch.models.cache_dtype import to_cache_dtype
    q, kp, vp, tables, lens = paged_main_inputs(torch.float32, gen, m)
    scale = 3.0 if pages == torch.int8 else 1.0
    return ((q * qx).to(qdt), to_cache_dtype(kp * scale, pages),
            to_cache_dtype(vp * scale, pages), tables, lens)


def int8_scores(label, q, kp, tables, lens, window, ref, slack, qx):
    """Under q times ``qx`` > 1 over int8 pages the plain output tells a
    kernel that truncates from one that writes zeros or rounds to nearest:
    it must hold rows without slack whose largest weight is 1 (x40), or
    lies in [0.5, 1) (x12). Returns the share of non-zero output rows."""
    from repro_torch.kernels.paged_attention.ref import decode_weights
    nonzero = ref.float().abs().amax(dim=-1) > 0
    if qx == 1.0:
        return float(nonzero.float().mean())
    top = decode_weights(q, kp, tables, lens, window).amax(dim=-1)
    exact = slack.amax(dim=-1) == 0
    rows = (top >= 0.5) & (top < 1) if qx == INT8_QX[0] else nonzero
    if not bool((rows & exact).any()):
        raise AssertionError(f"{label}: no row tells truncation from rounding")
    return float(nonzero.float().mean())


def hold_q8(label, out, ref, q, vp, slack, upcast):
    """``out`` against ``ref`` under the bounds of ``Q8_ATOL``'s comment.
    Returns (max abs err, max abs err over the rows without slack,
    relative rms err)."""
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite output")
    v_scale = float(vp.float().std())
    diff = (out - ref).abs()
    if upcast:
        tol = TOL[q.dtype] * v_scale
        bound_ = tol + tol * ref.abs()
    else:
        rel = 2.0 ** -8 if q.dtype == torch.bfloat16 else 1e-6
        bound_ = Q8_ATOL * v_scale + rel * ref.abs() + slack
    if not bool((diff <= bound_).all()):
        raise AssertionError(f"{label}: beyond its bound by {float((diff - bound_).max())}")
    rel_rms = float(diff.norm() / ref.norm().clamp_min(1e-30))
    if float(diff.norm()) > REL_RMS[q.dtype] * float(ref.norm()) + float(slack.norm()):
        raise AssertionError(f"{label}: relative rms err {rel_rms}")
    exact = diff[slack.amax(dim=-1) == 0]
    return float(diff.max()), float(exact.max()) if exact.numel() else 0.0, rel_rms


def check_q8(paged_ops):
    """Each instance over pages of another dtype at the table's K2 shapes,
    both modes, against the plain version (the default mode's one-launch
    cluster there and at ``Q8_MORE``'s shapes, through the map over token
    pairs at ``Q8_ODD_KV``'s, each call's instance read from
    ``CVT.by_instance``: one launch of it; the upcast mode's design, which
    ``upcast_design`` names, from ``UPCAST.by_instance`` likewise: the
    cluster for 8-bit pages under a bf16 q, there, at reasoning lengths
    and at ``Q8_ODD_KV``'s rows, the split for the other pairs and fp32
    pages under a bf16 q); the sequence split's cluster passes on the same
    inputs at ``Q8_SPLIT``'s shapes over each of ``SPLIT_CUTS``
    (``hold_split_q8``); then the split passes over the two halves of
    zamba2's and h2o-danube's split share against the one-call plain
    version; int8 pages also under q times ``INT8_QX``. Returns the max
    abs err of each instance (q/pages, the mode and design, " paired"
    through the map over token pairs; the split's "split cluster"), over
    all rows and over the rows without slack."""
    from repro_torch.kernels.paged_attention.ref import weight_slack
    from repro_torch.models.cache_dtype import to_cache_dtype
    gen = torch.Generator(device="cuda").manual_seed(25)
    errs, exacts, rels, nonzero = {}, {}, {}, {}
    for pages, qdt in Q8_PAIRS + Q8_UPCAST_ONLY:
        up_only = (pages, qdt) in Q8_UPCAST_ONLY
        qxs = (1.0, *INT8_QX) if pages == torch.int8 else (1.0,)
        for qx in qxs:
            for m in Q8_PAGED + ([] if up_only else Q8_MORE):
                q, kp, vp, tables, lens = q8_inputs(pages, qdt, gen, m, qx)
                w = m.get("window", 0)
                up = paged_ops.upcast_design(qdt, pages, m["D"], m["KV"])
                # the upcast mode truncates nothing: its rows at q x1 only,
                # at the four main batches and, where its cluster runs, at
                # reasoning lengths
                modes = ((True,) if up_only else
                         (False, True) if qx == 1.0 and (
                             m in Q8_PAGED or (m in Q8_UPCAST and up == "cluster"))
                         else (False,))
                for upcast in modes:
                    counter = paged_ops.UPCAST if upcast else paged_ops.CVT
                    inst = q8_instance(paged_ops, qdt, pages, m, up if upcast else "cluster")
                    before = counter.by_instance[inst]
                    out = paged_ops.paged_attention(q, kp, vp, tables, lens, window=w,
                                                    upcast=upcast)
                    torch.cuda.synchronize()
                    if counter.by_instance[inst] != before + 1:
                        raise AssertionError(f"paged_attention at {list(q.shape)}: not the "
                                             f"{inst} design ({dict(counter.by_instance)})")
                    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens,
                                                          window=w, upcast=upcast)
                    slack = weight_slack(q, kp, vp, tables, lens, window=w, upcast=upcast)
                    key = inst.replace(" ", " upcast ", 1) if upcast else inst
                    label = f"paged_attention {key} q x{qx:g} at {list(q.shape)}"
                    if pages == torch.int8 and not upcast:
                        nonzero[f"{key} q x{qx:g}"] = min(
                            nonzero.get(f"{key} q x{qx:g}", 1.0),
                            int8_scores(label, q, kp, tables, lens, w, ref, slack, qx))
                    err, exact, rel = hold_q8(label, out, ref, q, vp, slack, upcast)
                    errs[key] = max(errs.get(key, 0.0), err)
                    exacts[key] = max(exacts.get(key, 0.0), exact)
                    rels[key] = max(rels.get(key, 0.0), rel)
                    if upcast or not any(m is x for x in Q8_SPLIT):
                        continue
                    # the sequence split of the same call, against the same
                    # plain output
                    skey = inst.replace(" ", " split ", 1)
                    for cut in SPLIT_CUTS:
                        err, exact, rel = hold_split_q8(
                            paged_ops, f"{label} split {cut}", q, kp, vp, tables, lens, w,
                            cut, ref, slack)
                        errs[skey] = max(errs.get(skey, 0.0), err)
                        exacts[skey] = max(exacts.get(skey, 0.0), exact)
                        rels[skey] = max(rels.get(skey, 0.0), rel)
                del q, kp, vp, ref, slack
        if up_only:
            continue
        for qx, m in [(x, m) for x in qxs for m in SPLIT_PAGED]:
            q, kb, vb, tables, lens, halves = _split_inputs(m, gen)
            q = (q.float() * qx).to(qdt)
            scale = 3.0 if pages == torch.int8 else 1.0
            kp, vp = (to_cache_dtype(t.float() * scale, pages) for t in (kb, vb))
            w = m["window"]
            shift = [0, SPLIT_LEN // 2]
            out = run_split(paged_ops, q, kp, vp,
                            [(h, lens - s) for h, s in zip(halves, shift)], w)[0]
            torch.cuda.synchronize()
            ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=w)
            slack = weight_slack(q, kp, vp, tables, lens, window=w)
            key = q8_instance(paged_ops, qdt, pages, m, "cluster").replace(" ", " split ", 1)
            label = f"paged split {key} q x{qx:g} {m['model']}"
            if pages == torch.int8:
                nonzero[f"{key} q x{qx:g}"] = min(
                    nonzero.get(f"{key} q x{qx:g}", 1.0),
                    int8_scores(label, q, kp, tables, lens, w, ref, slack, qx))
            err, exact, rel = hold_q8(label, out, ref, q, vp, slack, False)
            errs[key] = max(errs.get(key, 0.0), err)
            exacts[key] = max(exacts.get(key, 0.0), exact)
            rels[key] = max(rels.get(key, 0.0), rel)
    emit("check", kernel="paged_attention other page dtypes", cases=len(errs),
         shapes=[[m["B"], m["KV"], m["G"], m["D"], m.get("max_ctx")]
                 for m in Q8_PAGED + Q8_MORE],
         upcast_shapes=[[m["B"], m["KV"], m["G"], m["D"], m.get("max_ctx")]
                        for m in Q8_UPCAST],
         split_shapes=[[m["B"], m["KV"], m["G"], m["D"], m.get("max_ctx")]
                       for m in Q8_SPLIT], split_cuts=list(SPLIT_CUTS),
         max_abs_err=errs, max_abs_err_without_slack=exacts, rel_rms=rels,
         int8_nonzero_rows=nonzero)
    return errs, exacts


def time_q8(paged_ops, pages, upcast, gen, m=MAIN_PAGED):
    """K2's row over ``pages`` under a bf16 q at ``m``: the bound reads
    each counted key's k and v once at the pages' width (one byte an 8-bit
    element, four an fp32 one), q, the table and lens once, and writes the
    output once. The row names the design that ran (``CVT.by_instance``,
    or ``UPCAST.by_instance`` in the upcast mode). The library yardstick
    of the upcast mode is SDPA on the pre-gathered cache upcast to bf16
    (gathered outside the timed region); no library call computes the
    default mode's rounding, so it has none."""
    import torch.nn.functional as F
    q, kp, vp, tables, lens = q8_inputs(pages, torch.bfloat16, gen, m)
    window = m.get("window", 0)
    B, KV, G, D = q.shape
    counted = lens.long() + 1
    if window > 0:
        counted = counted.clamp(max=window)
    tokens = int(counted.sum())
    flops = 4 * G * D * KV * tokens
    kw = {"window": window, "upcast": upcast}
    counter = paged_ops.UPCAST if upcast else paged_ops.CVT
    before = dict(counter.by_instance)
    out = paged_ops.paged_attention(q, kp, vp, tables, lens, **kw)
    # the design that ran, " paired" after a cluster through the map over
    # token pairs
    design = next(k.partition(" ")[2] for k, n in counter.by_instance.items()
                  if n != before.get(k, 0))
    needed = 2 * tokens * KV * D * kp.element_size() + nbytes(q, out, tables, lens)
    b_ms, b_by = bound(flops, needed, torch.bfloat16)
    kernel = lambda: paged_ops.paged_attention(q, kp, vp, tables, lens, **kw)  # noqa: E731
    ms, host_ms = time_ms(kernel, 50)
    dev = device_ms(kernel, 50)
    row = dict(shape=[B, KV, G, D], pages=_dt(pages), mode="upcast" if upcast else "default",
               design=design, window=window, contexts=(lens + 1).tolist(), dtype="bfloat16",
               ms=ms, device_ms=dev, host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
               bound_share=b_ms / ms, device_bound_share=b_ms / dev, bytes=needed,
               gb_s=needed / ms / 1e6, device_gb_s=needed / dev / 1e6,
               plain_ms=time_ms(lambda: paged_ops.paged_attention_plain(
                   q, kp, vp, tables, lens, **kw), 10)[0],
               library_ms=None, library_device_ms=None)
    if upcast:
        S = tables.shape[1] * kp.shape[1]
        kc, vc = (p[tables.long()].reshape(B, S, KV, D).transpose(1, 2).to(torch.bfloat16)
                  .contiguous() for p in (kp, vp))
        mask = (torch.arange(S, device=q.device)[None, :] <= lens[:, None].long())
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.reshape(B, KV * G, 1, D), kc, vc, attn_mask=mask[:, None, None, :],
            enable_gqa=True)
        row.update(library_ms=time_ms(library, 50)[0],
                   library_device_ms=device_ms(library, 50),
                   library_kernels=library_kernels(library))
    return row


def split_shares(tables, lens, cut):
    """Rank shares of every row's table, each (table, lens counted from the
    share's first position): ``cut`` "halves", two of equal width (the
    runner's cut; the table padded with page 0, past every row's newest
    token), or "empty", the whole table and then 16 pages that hold no key
    (past every row's newest token)."""
    B, n = tables.shape
    if cut == "halves":
        w = -(-n // 2)
        t = torch.nn.functional.pad(tables, (0, 2 * w - n))
        return [(t[:, :w].contiguous(), lens), (t[:, w:].contiguous(), lens - w * 16)]
    return [(tables, lens), (torch.zeros((B, 16), dtype=tables.dtype, device=tables.device),
                             lens - n * 16)]


def run_split(paged_ops, q, kp, vp, shares, window):
    """The sequence split on one device: pass 1 on each share, the shares'
    (m, l) gathered, pass 2 on each, the sums gathered and added. Returns
    (out, [(ml, scores)] a share, the gathered ml, [sum] a share)."""
    passes = [paged_ops.paged_attention_stats(q, kp, t, l, window=window) for t, l in shares]
    ml = torch.cat([m for m, _ in passes], dim=2)
    parts = [paged_ops.paged_attention_values(q, kp, vp, t, l, ml, sc, window=window)
             for (t, l), (_, sc) in zip(shares, passes)]
    return paged_ops.paged_sum(torch.cat(parts, dim=2), q.dtype), passes, ml, parts


def _split_counts(paged_ops):
    return {k.symbol: k.launches for k in (paged_ops.SHARE_STATS, paged_ops.SHARE_VALUES,
                                           paged_ops.SUM, paged_ops.CVT)}


def hold_split_q8(paged_ops, label, q, kp, vp, tables, lens, window, cut, ref, slack):
    """The split passes over ``cut``'s shares (``split_shares``) against
    their plain versions and the one-call plain output ``ref``: one launch
    of pass 1 and pass 2 a share, of the instance the pool's map names
    (``q8_instance``: " paired" through the map over token pairs), and one
    of the sum; each share's (m, l) and scores where a key counts within
    ``SPLIT_ML_TOL`` of the scores' scale (l within ``SPLIT_L_RTOL`` of
    itself), the scores at their true tokens; a share with no key (NEG_INF,
    0) and a sum of zeros exactly; the summed output under ``hold_q8``'s
    bounds. Returns hold_q8's (max abs err, without slack, relative
    rms)."""
    from repro_torch.kernels.paged_attention.ref import NEG_INF
    B, KV, G, D = q.shape
    shares = split_shares(tables, lens, cut)
    inst = q8_instance(paged_ops, q.dtype, kp.dtype, dict(D=D, KV=KV), "cluster")
    before = _split_counts(paged_ops), paged_ops.SHARE_STATS.by_instance[inst], \
        paged_ops.SHARE_VALUES.by_instance[inst]
    out, passes, ml, parts = run_split(paged_ops, q, kp, vp, shares, window)
    torch.cuda.synchronize()
    n = {k: v - before[0][k] for k, v in _split_counts(paged_ops).items()}
    n[inst] = (paged_ops.SHARE_STATS.by_instance[inst] - before[1],
               paged_ops.SHARE_VALUES.by_instance[inst] - before[2])
    R = len(shares)
    want = {"paged_cvt_share_stats": R, "paged_cvt_share_values": R, "paged_cvt_sum": 1,
            "paged_cvt_fwd": 0, inst: (R, R)}
    if n != want:
        raise AssertionError(f"{label}: launches {n}, want {want}")
    for i, ((m, sc), (t, l)) in enumerate(zip(passes, shares)):
        m_p, sc_p = paged_ops.paged_attention_stats_plain(q, kp, t, l, window=window)
        counts = m_p[..., 1] > 0                                      # (B,KV,1,G)
        if bool((m[..., 0][~counts] != NEG_INF).any()) or bool((m[..., 1][~counts] != 0).any()) \
                or bool((parts[i].transpose(2, 3)[~counts.transpose(2, 3)] != 0).any()):
            raise AssertionError(f"{label} share {i}: a row with no key holds (m, l) or a sum")
        valid = sc_p > NEG_INF / 2
        scale = float(sc_p[valid].abs().max()) + 1.0 if bool(valid.any()) else 1.0
        if bool(counts.any()):
            dm = float((m[..., 0] - m_p[..., 0])[counts].abs().max())
            dl = float(((m[..., 1] - m_p[..., 1]) / m_p[..., 1])[counts].abs().max())
            if dm > SPLIT_ML_TOL * scale or dl > SPLIT_L_RTOL:
                raise AssertionError(f"{label} share {i}: (m, l) off by {dm}, {dl}")
        if bool(valid.any()):
            ds = float((sc - sc_p)[valid].abs().max())
            if ds > SPLIT_ML_TOL * scale:
                raise AssertionError(f"{label} share {i}: scores off by {ds}")
    return hold_q8(label, out, ref, q, vp, slack, False)


def time_split_q8(paged_ops, pages, gen, m):
    """The sequence split's launches on each share of ``m``'s table over
    ``pages`` under a bf16 q (the cluster's pass 1, pass 2 and sum), the
    gathers left out: each launch's device time (a replayed CUDA graph),
    the three's together, and each pass's eager time, beside each pass's
    bytes bound (pass 1: the share's counted keys' k and their fp32 scores
    written; pass 2: those scores and v read; q, the tables, lens, the (m,
    l) and the sums once) and its plain version's time. No PyTorch call
    rounds the weights to the cache's dtype: no library time. One row a
    share."""
    q, kp, vp, tables, lens = q8_inputs(pages, torch.bfloat16, gen, m)
    w = m.get("window", 0)
    B, KV, G, D = q.shape
    shares = split_shares(tables, lens, "halves")
    _, passes, ml, parts = run_split(paged_ops, q, kp, vp, shares, w)
    cat = torch.cat(parts, dim=2)
    ml_p = torch.cat([paged_ops.paged_attention_stats_plain(q, kp, t, l, window=w)[0]
                      for t, l in shares], dim=2)
    rows = []
    for i, (t, l) in enumerate(shares):
        pos = torch.arange(t.shape[1] * 16, device=q.device)
        valid = pos[None, :] <= l.long()[:, None]
        if w:
            valid &= pos[None, :] > l.long()[:, None] - w
        keys = int(valid.sum()) * KV
        sc = passes[i][1]
        b1 = nbytes(q, t, l, passes[i][0]) + keys * (D * kp.element_size() + G * 4)
        b2 = nbytes(t, l, ml, parts[i]) + keys * (D * kp.element_size() + G * 4)
        fns = {
            "pass1": lambda t=t, l=l: paged_ops.paged_attention_stats(q, kp, t, l, window=w),
            "pass2": lambda t=t, l=l, sc=sc: paged_ops.paged_attention_values(
                q, kp, vp, t, l, ml, sc, window=w),
            "sum": lambda: paged_ops.paged_sum(cat, q.dtype),
        }
        dev = {k: device_ms(f, 20) for k, f in fns.items()}
        both = lambda: [f() for f in fns.values()]   # noqa: E731
        bounds = {k: bound(f, b, torch.bfloat16) for k, f, b in (
            ("pass1", 2 * keys * G * D, b1), ("pass2", 2 * keys * G * D, b2),
            ("sum", 0, nbytes(cat) + nbytes(q)))}
        sc_p = paged_ops.paged_attention_stats_plain(q, kp, t, l, window=w)[1]
        plain = {"pass1": time_ms(lambda t=t, l=l: paged_ops.paged_attention_stats_plain(
                     q, kp, t, l, window=w), 3)[0],
                 "pass2": time_ms(lambda t=t, l=l: paged_ops.paged_attention_values_plain(
                     q, kp, vp, t, l, ml_p, sc_p, window=w), 3)[0],
                 "sum": time_ms(lambda: paged_ops.paged_sum_plain(cat, q.dtype), 3)[0]}
        rows.append(dict(
            shape=[B, KV, G, D], pages=_dt(pages), window=w, cut="halves", share=i,
            instance=q8_instance(paged_ops, q.dtype, pages, m, "cluster"),
            positions=[int(shares[0][0].shape[1]) * 16 * i,
                       int(shares[0][0].shape[1]) * 16 * i + int(t.shape[1]) * 16], keys=keys,
            ms={k: time_ms(f, 20)[0] for k, f in fns.items()},
            device_ms=dev, device_ms_total=sum(dev.values()),
            three_launches_device_ms=device_ms(both, 20),
            bound_ms={k: b[0] for k, b in bounds.items()},
            bound_by={k: b[1] for k, b in bounds.items()},
            device_bound_share={k: bounds[k][0] / dev[k] for k in bounds},
            plain_ms=plain, library_ms=None))
    return rows


def greedy_equality():
    """A full-width 2-layer fp32 model with numpy-seeded weights, served on
    the card through the kernels and on the CPU through the plain path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.models.bridge import from_jax_params, numpy_params

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2)
    params = numpy_params(cfg, seed=1)
    models = {dev: from_jax_params(params, cfg, device=dev, dtype=torch.float32)
              for dev in ("cuda", "cpu")}
    del params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=30).tolist() for _ in range(4)]
    n_new = 20
    result = {}
    for label, n_pages in (("ample", 64), ("preempting", 7)):
        outs, preempts = {}, {}
        for dev, model in models.items():
            ecfg = EngineConfig(n_pages=n_pages, max_num_seqs=4,
                                max_num_batched_tokens=512, chunk_size=192,
                                admission_mode="naive")
            eng = InferenceEngine(cfg, ecfg, TorchRunner(model, device=dev),
                                  virtual_clock=False)
            reqs = [eng.submit(p, n_new) for p in prompts]
            eng.run(max_steps=5000)
            outs[dev] = [r.output for r in reqs]
            preempts[dev] = sum(r.n_preemptions for r in reqs)
            if any(len(o) != n_new for o in outs[dev]):
                raise AssertionError(f"{label}/{dev}: unfinished requests")
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"{label}: card tokens {outs['cuda']} differ "
                                 f"from CPU plain-path tokens {outs['cpu']}")
        if label == "preempting" and preempts["cuda"] == 0:
            raise AssertionError("the small pool forced no preemption")
        result[label] = dict(tokens_equal=True, preemptions=preempts)
    return result


def decode_weight_bytes(model) -> int:
    """Bytes of the weights one decode step reads: all of them, but for an
    untied head the embedding, of which it gathers only the batch's rows."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if name != "embed" or model.cfg.tie_embeddings)


def _zero_launches(*ops):
    """Set each kernel's launch count to 0."""
    for o in ops:
        o.KERNEL.launches = 0


def _launches(flash_ops, paged_ops):
    """Each kernel's launches since its count was set to 0."""
    return {"flash_attention": flash_ops.KERNEL.launches,
            "paged_attention": paged_ops.KERNEL.launches}


def main_path(flash_ops, paged_ops, cfg=None, traffic=SERVE_REQUESTS,
              reduced=None):
    """Serve ``traffic`` on ``cfg`` (default: full-depth llama3.2-3b) in
    bf16 through the entry point, with the kernels' launch counts set to 0
    just before and read just after. A GQA model must launch both kernels,
    a hybrid in multiples of its shared block's invocations; an MLA model
    neither (its attention is PyTorch ops), nor an attention-free one."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_requests, serve

    cfg = cfg or get_config("llama3.2-3b")
    r = traffic
    requests = make_requests(cfg.vocab, r["n"], r["isl"], r["osl"], r["seed"])
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(flash_ops, paged_ops)
    t0 = time.perf_counter()
    eng, reqs = serve(cfg, requests, device="cuda", dtype=torch.bfloat16,
                      seed=0, max_num_seqs=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(flash_ops, paged_ops)
    for (prompt, n), req in zip(requests, reqs):
        if len(req.output) != n or req.t_finished is None:
            raise AssertionError(f"request {req.rid}: {len(req.output)} of {n} tokens")
        if not all(0 <= t < cfg.vocab for t in req.output):
            raise AssertionError(f"request {req.rid}: token out of range")
    if cfg.attention in ("mla", "none"):
        if max(launches.values()) != 0:
            raise AssertionError(f"an {cfg.attention} model launched a GQA "
                                 f"kernel: {launches}")
    elif min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not on the main path: {launches}")
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        if any(n % groups for n in launches.values()):
            raise AssertionError(f"launches {launches} are not multiples of "
                                 f"the shared block's {groups} invocations")
    peak = torch.cuda.max_memory_allocated()
    # the served model still answers: finite logits whose argmax is the
    # first token the engine produced for request 0
    logits = eng.runner.model.prefill(
        torch.tensor([requests[0][0]], device="cuda"))[0]
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("non-finite logits")
    if int(logits[0].argmax()) != reqs[0].output[0]:
        raise AssertionError("prefill argmax differs from the served first token")
    s = eng.metrics.summary()
    weight_bytes = decode_weight_bytes(eng.runner.model)
    extra = {}
    if cfg.moe is not None:
        from repro_torch.models.moe import capacity
        # slots per expert at a full decode batch
        extra = dict(experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                     capacity_factor=cfg.moe.capacity_factor,
                     decode_capacity=capacity(cfg, min(r["n"], 16)))
    states = eng.runner.states
    if states:
        # one sequence's slot across the runner's state buffers, beside the
        # reference config's count of a sequence's state (fp32)
        extra = dict(state_slots=states[0].shape[1],
                     state_slot_bytes=sum(b.numel() // b.shape[1] * b.element_size()
                                          for b in states),
                     state_bytes_per_seq_cfg=cfg.state_bytes_per_seq(4))
    emit("main_path", model=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, attention=cfg.attention, dtype="bfloat16",
         reduced=reduced or {}, **extra,
         params=sum(p.numel() for p in eng.runner.model.parameters()),
         n_requests=len(requests), n_finished=s["n_finished"],
         gen_tokens=s["gen_tokens"], gen_tok_s=s["gen_throughput_tok_s"],
         ttft_p50_s=s["ttft_s"]["p50"], tpot_mean_s=s["tpot_s"]["mean"],
         preemptions=s["preemptions"], engine_s=s["duration_s"],
         wall_s_with_weight_init=wall, max_memory_allocated=peak,
         decode_weight_bytes=weight_bytes,
         tpot_weight_bound_ms=weight_bytes / PEAK_BYTES * 1e3,
         launches=launches)
    return launches, eng.runner.model


MOE_RANGES = ("moe_dispatch", "moe_combine")
# output tokens a request in a traced run, few for the run's time: reading
# a trace's events takes several times the traced run
PROFILE_OSL = 4   # cut from 8 for the run's time


def free_card():
    """Return the memory of dropped models and pools to the card: an
    engine holds reference cycles, so collect them first."""
    gc.collect()
    torch.cuda.empty_cache()


def profile_main_path(model, traffic=SERVE_REQUESTS, decode_only=False):
    """A traced run of a main path's model, on a fresh engine and pool,
    with PROFILE_OSL output tokens a request; with ``decode_only`` the engine first
    runs untraced until every request has its first token, so the trace
    holds decode steps alone. Tracing slows the host, so its step times
    are not the main path's; it gives the device's busy share and the
    kernels that take the device time. For a GQA model the kernels of K1
    and K2 are found by device symbol and must show time (bf16 instances
    only); for an MoE model the device time of the kernels under the
    ``moe_dispatch`` and ``moe_combine`` ranges (``models/moe.py``) is its
    own group; for a model with recurrent state the index and copy kernels
    that read and write its slots (and the rest of the copies) are a group
    of theirs, ``copies``, and ``other`` is then the elementwise rest (a
    hybrid's SSD steps, norms and activations). A decode-only trace need
    show no K1 time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.launch.serve import make_requests, pages_to_hold

    cfg = model.cfg
    r = traffic
    requests = make_requests(cfg.vocab, r["n"], r["isl"], (PROFILE_OSL, PROFILE_OSL),
                             r["seed"] + 1)
    ecfg = EngineConfig(n_pages=pages_to_hold(requests), max_num_seqs=16,
                        admission_mode="kv_aware")
    eng = InferenceEngine(cfg, ecfg, TorchRunner(model, device="cuda"),
                          virtual_clock=False)
    reqs = [eng.submit(prompt, n) for prompt, n in requests]
    while decode_only and not all(r.output for r in reqs):
        eng.step()
    steps_before = len(eng.metrics.timeline)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    moe_ms = 0.0
    for evt in prof.events():
        if evt.name in MOE_RANGES:
            # the CPU range sums its kernels' device time; its device-side
            # copy spans first to last kernel, gaps included: not a kernel
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                moe_ms += evt.device_time_total / 1e3
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) \
                + evt.time_range.elapsed_us() / 1e3
    gqa = cfg.attention not in ("mla", "none")
    stateful = cfg.family in ("hybrid", "ssm")
    groups = dict.fromkeys(("flash_attention", "paged_attention")
                           if gqa else (), 0.0)
    groups.update(matmul=0.0, other=0.0)
    if stateful:
        groups["copies"] = 0.0
    by_symbol = {sym: 0.0 for syms in KERNEL_SYMBOLS.values() for sym in syms}
    for name, ms in by_name.items():
        low = name.lower()
        hits = [(k, sym) for k, syms in KERNEL_SYMBOLS.items() for sym in syms
                if re.search(rf"(^|[\s:]){sym}<", name)]
        if hits:
            groups[hits[0][0]] += ms
            by_symbol[hits[0][1]] += ms
        elif any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
            groups["matmul"] += ms
        elif stateful and any(t in low for t in ("index", "copy", "cat")):
            groups["copies"] += ms
        else:
            groups["other"] += ms
    if cfg.moe is not None:
        # the ranges hold no matmul: their kernels are all in "other"
        groups["moe_dispatch"] = moe_ms
        groups["other"] -= moe_ms
    busy_ms = sum(by_name.values())
    steps = len(eng.metrics.timeline) - steps_before
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", model=cfg.name, layers=cfg.n_layers, osl=PROFILE_OSL,
         decode_only=decode_only, steps=steps,
         wall_ms=wall_ms, step_ms=wall_ms / max(steps, 1),
         device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
         device_ms_by_group=groups,
         **({"device_ms_by_symbol": by_symbol} if gqa else {}),
         top_kernels_ms=[[name[:100], ms] for name, ms in top])
    if not busy_ms:
        raise AssertionError("the trace shows no device time")
    if not gqa:
        return
    wrong = [sym for sym in FP32_ONLY_SYMBOLS if by_symbol[sym] > 0.0]
    if wrong:
        raise AssertionError(f"the bf16 main path reached {wrong}, an fp32 "
                             "instance")
    missing = [sym for sym, ms in by_symbol.items()
               if ms == 0.0 and sym not in FP32_ONLY_SYMBOLS
               and not (decode_only and sym in KERNEL_SYMBOLS["flash_attention"])]
    if missing:
        raise AssertionError(f"the trace shows no device time for {missing}; "
                             f"its kernels: {sorted(by_name)[:20]}")


def moe_configs():
    """DeepSeek-R1 and phi3.5-moe at full width with their depth cut, and
    the cuts, as the main path serves them."""
    from repro_torch.configs.registry import get_config

    r1 = get_config("deepseek-r1-671b")
    phi = get_config("phi3.5-moe-42b-a6.6b")
    return [(dataclasses.replace(r1, n_layers=R1_LAYERS),
             {"n_layers": [r1.n_layers, R1_LAYERS]}, SERVE_REQUESTS),
            (dataclasses.replace(phi, n_layers=PHI_LAYERS),
             {"n_layers": [phi.n_layers, PHI_LAYERS]}, PHI_REQUESTS)]


def greedy_on_card_and_cpu(cfg, requests, label, **engine):
    """Greedy tokens of ``requests`` served by an fp32 model seeded on the
    card and by its CPU copy, filled parameter by parameter from the card,
    each through ``InferenceEngine`` with ``EngineConfig(**engine)``. Fails
    unless every request finishes and the tokens are equal; returns the
    number of parameters and each side's preemptions, steps and seconds."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.models.transformer import Transformer

    card = Transformer(cfg, device="cuda", dtype=torch.float32, seed=1)
    host = Transformer(cfg, device="cpu", dtype=torch.float32, seed=None)
    on_card = dict(card.named_parameters())
    with torch.no_grad():
        for name, p in host.named_parameters():
            p.copy_(on_card[name])
    outs, runs = {}, {}
    for dev, model in (("cuda", card), ("cpu", host)):
        eng = InferenceEngine(cfg, EngineConfig(**engine),
                              TorchRunner(model, device=dev), virtual_clock=False)
        reqs = [eng.submit(p, n) for p, n in requests]
        t0 = time.perf_counter()
        eng.run(max_steps=5000)
        outs[dev] = [r.output for r in reqs]
        runs[dev] = dict(preemptions=sum(r.n_preemptions for r in reqs),
                         steps=len(eng.metrics.timeline),
                         seconds=time.perf_counter() - t0)
        if any(len(r.output) != n for (_, n), r in zip(requests, reqs)):
            raise AssertionError(f"{label}/{dev}: unfinished requests")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"{label}: card tokens {outs['cuda']} differ from "
                             f"CPU plain-path tokens {outs['cpu']}")
    return sum(p.numel() for p in card.parameters()), runs


def greedy_equality_moe():
    """DeepSeek-R1 at full width (d_model, MLA, dense d_ff, expert d_ff,
    vocab) with 2 layers (1 dense, 1 MoE) and 16 experts, on the card and
    on a CPU copy. Four 30-token prompts, ``MOE_EQ_NEW_TOKENS`` new tokens each, on a 7-page
    pool: the engine preempts, decode batches of up to 4 give each expert
    2 slots, so assignments drop on both sides alike."""
    from repro_torch.configs.registry import get_config

    full = get_config("deepseek-r1-671b")
    cfg = dataclasses.replace(full, n_layers=2, moe=dataclasses.replace(
        full.moe, n_experts=16, first_dense_layers=1))
    rng = np.random.default_rng(2)
    requests = [(rng.integers(0, cfg.vocab, size=30).tolist(), MOE_EQ_NEW_TOKENS)
                for _ in range(4)]
    params, runs = greedy_on_card_and_cpu(
        cfg, requests, "moe", n_pages=7, max_num_seqs=4,
        max_num_batched_tokens=512, chunk_size=192, admission_mode="naive")
    if runs["cuda"]["preemptions"] == 0:
        raise AssertionError("moe: the small pool forced no preemption")
    return dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                dtype="float32", reduced={
                    "n_layers": [full.n_layers, 2],
                    "first_dense_layers": [full.moe.first_dense_layers, 1],
                    "n_experts": [full.moe.n_experts, 16]},
                params=params, tokens_equal=True, runs=runs)


def greedy_equality_swa():
    """h2o-danube-3-4b at full width (d_model 3840, 32 q / 8 kv heads of
    120, window 4096, vocab 32000) with ``SWA_EQ``'s layers, on the card and on a CPU
    copy. Two 4200-token prompts, ``SWA_EQ``'s new tokens each: prompt rows past 4096
    lose their first keys in K1, and every decode step's window in K2
    starts past position 0."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import pages_to_hold

    full = get_config("h2o-danube-3-4b")
    cfg = dataclasses.replace(full, n_layers=SWA_EQ["layers"])
    rng = np.random.default_rng(3)
    requests = [(rng.integers(0, cfg.vocab, size=4200).tolist(), SWA_EQ["new_tokens"])
                for _ in range(2)]
    params, runs = greedy_on_card_and_cpu(
        cfg, requests, "swa", n_pages=pages_to_hold(requests), max_num_seqs=2)
    return dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                head_dim=cfg.head_dim, window=cfg.swa_window, dtype="float32",
                reduced={"n_layers": [full.n_layers, cfg.n_layers]},
                prompt_tokens=[len(p) for p, _ in requests],
                params=params, tokens_equal=True, runs=runs)


def greedy_equality_hybrid():
    """zamba2-2.7b at full width (d_model 2560, Mamba2 of 80 heads of 64
    with state 64, the shared block's 32 heads of 80, MHA) with 12 layers
    (2 groups), on the card and on a CPU copy. Two prompts of 270 and 300
    tokens (two 128-token chunks of the scan and a remainder), 16 new
    tokens each, on a 36-page pool: one request is preempted and resumes
    by recomputing its state in a fresh slot."""
    from repro_torch.configs.registry import get_config

    full = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(full, n_layers=12)
    rng = np.random.default_rng(4)
    requests = [(rng.integers(0, cfg.vocab, size=n).tolist(), 16)
                for n in (270, 300)]
    params, runs = greedy_on_card_and_cpu(
        cfg, requests, "hybrid", n_pages=36, max_num_seqs=2,
        max_num_batched_tokens=2048, chunk_size=512, admission_mode="naive")
    if runs["cuda"]["preemptions"] == 0:
        raise AssertionError("hybrid: the small pool forced no preemption")
    return dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                head_dim=cfg.head_dim, dtype="float32",
                reduced={"n_layers": [full.n_layers, 12]},
                prompt_tokens=[len(p) for p, _ in requests],
                params=params, tokens_equal=True, runs=runs)


def greedy_equality_xlstm():
    """xlstm-350m at full width (d_model 1024, mLSTM heads of 512, sLSTM
    FFN 1344) with 8 blocks (7 mLSTM, 1 sLSTM), on the card and on a CPU
    copy. Two prompts of 100 and 120 tokens, 16 new tokens each, on a
    15-page pool (the engine's page accounting; xLSTM has no pool): one
    request is preempted and recomputes its state."""
    from repro_torch.configs.registry import get_config

    full = get_config("xlstm-350m")
    cfg = dataclasses.replace(full, n_layers=8)
    rng = np.random.default_rng(5)
    requests = [(rng.integers(0, cfg.vocab, size=n).tolist(), 16)
                for n in (100, 120)]
    params, runs = greedy_on_card_and_cpu(
        cfg, requests, "xlstm", n_pages=15, max_num_seqs=2,
        max_num_batched_tokens=2048, chunk_size=512, admission_mode="naive")
    if runs["cuda"]["preemptions"] == 0:
        raise AssertionError("xlstm: the small pool forced no preemption")
    return dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                dtype="float32", reduced={"n_layers": [full.n_layers, 8]},
                prompt_tokens=[len(p) for p, _ in requests],
                params=params, tokens_equal=True, runs=runs)


def gqa_configs():
    """The rest of the attention decoders, as the main path serves them:
    h2o-danube-3-4b whole, qwen3-14b, kimi-k2 and llama3-405b at full
    width with their depth cut, with the cuts and their traffic."""
    from repro_torch.configs.registry import get_config

    kimi = get_config("kimi-k2-1t-a32b")
    l405 = get_config("llama3-405b")
    qwen3 = get_config("qwen3-14b")
    return [(dataclasses.replace(qwen3, n_layers=QWEN3_LAYERS),
             {"n_layers": [qwen3.n_layers, QWEN3_LAYERS]}, SERVE_REQUESTS),
            (get_config("h2o-danube-3-4b"), {}, DANUBE_REQUESTS),
            (dataclasses.replace(kimi, n_layers=KIMI_LAYERS),
             {"n_layers": [kimi.n_layers, KIMI_LAYERS]}, SERVE_REQUESTS),
            (dataclasses.replace(l405, n_layers=L405_LAYERS),
             {"n_layers": [l405.n_layers, L405_LAYERS]}, SERVE_REQUESTS)]


def prefix_equality():
    """internvl2-76b at full width (d_model 8192, 64 q / 8 kv heads of 128,
    d_ff 28672, vocab 128256) with 2 layers in fp32, seeded on the card,
    and its CPU copy filled from the card. A seeded prefix of 256
    embeddings (normal, at the embedding's scale 1/sqrt(d)) before 200
    text tokens: the prefill logits of the card (K1 over all 456 tokens)
    and of the CPU (the plain path) agree within ``PREFIX_ATOL`` of the
    largest and have the same argmax; then 8 greedy decode steps through
    K2 on a paged pool holding the prefix's and the text's k/v, from
    position 456, give the same argmax on both sides."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Transformer

    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(full, n_layers=PREFIX_LAYERS)
    card = Transformer(cfg, device="cuda", dtype=torch.float32, seed=1)
    host = Transformer(cfg, device="cpu", dtype=torch.float32, seed=None)
    on_card = dict(card.named_parameters())
    with torch.no_grad():
        for name, p in host.named_parameters():
            p.copy_(on_card[name])
    rng = np.random.default_rng(6)
    prefix = torch.from_numpy((rng.standard_normal(
        (1, INTERNVL_PREFIX, cfg.d_model)) / np.sqrt(cfg.d_model)).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, INTERNVL_TEXT)))
    n = INTERNVL_PREFIX + INTERNVL_TEXT
    page = 16
    n_pages = -(-(n + PREFIX_DECODE_STEPS) // page)
    table = torch.arange(n_pages, dtype=torch.int32)[None]
    logits, tokens, seconds = {}, {}, {}
    for dev, model in (("cuda", card), ("cpu", host)):
        t0 = time.perf_counter()
        last, caches, _ = model.prefill(text.to(dev), prefix.to(dev))
        pools = [torch.zeros(s, device=dev) for s in model.pool_shapes(n_pages, page)]
        pos = torch.arange(n, device=dev)
        for j, pool in enumerate(pools):
            pool[:, pos // page, pos % page] = torch.stack(
                [c[j] for c in caches])[:, 0]
        steps = [last]
        for i in range(PREFIX_DECODE_STEPS):
            nxt = steps[-1].argmax(dim=-1)
            steps.append(model.decode_step(
                nxt, torch.full((1,), n + i, device=dev), pools, table.to(dev)))
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds[dev] = time.perf_counter() - t0
        logits[dev] = [t.float().cpu() for t in steps]
        tokens[dev] = [int(t[0].argmax()) for t in steps]
        del caches, pools
    scale = max(1.0, float(logits["cpu"][0].abs().max()))
    prefill_err = float((logits["cuda"][0] - logits["cpu"][0]).abs().max())
    decode_err = max(float((a - b).abs().max())
                     for a, b in zip(logits["cuda"][1:], logits["cpu"][1:]))
    if not all(bool(torch.isfinite(t).all()) for t in logits["cuda"]):
        raise AssertionError("prefix: non-finite logits on the card")
    if prefill_err > PREFIX_ATOL * scale:
        raise AssertionError(f"prefix: prefill logits differ by {prefill_err}, "
                             f"beyond {PREFIX_ATOL} x {scale}")
    if tokens["cuda"] != tokens["cpu"]:
        raise AssertionError(f"prefix: card tokens {tokens['cuda']} differ from "
                             f"CPU plain-path tokens {tokens['cpu']}")
    return dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                head_dim=cfg.head_dim, dtype="float32",
                reduced={"n_layers": [full.n_layers, PREFIX_LAYERS]},
                prefix_embeds=INTERNVL_PREFIX, text_tokens=INTERNVL_TEXT,
                decode_steps=PREFIX_DECODE_STEPS,
                params=sum(p.numel() for p in card.parameters()),
                prefill_max_abs_logit_diff=prefill_err,
                decode_max_abs_logit_diff=decode_err, logit_scale=scale,
                tolerance=PREFIX_ATOL * scale, tokens=tokens["cuda"],
                tokens_equal=True, seconds=seconds)


def vlm_audio_configs():
    """musicgen-medium and internvl2-76b at full width with their depth
    cut, as the main path serves them, with the cuts and their traffic."""
    from repro_torch.configs.registry import get_config

    vlm = get_config("internvl2-76b")
    musicgen = get_config("musicgen-medium")
    return [(dataclasses.replace(musicgen, n_layers=MUSICGEN_LAYERS),
             {"n_layers": [musicgen.n_layers, MUSICGEN_LAYERS]}, SERVE_REQUESTS),
            (dataclasses.replace(vlm, n_layers=INTERNVL_LAYERS),
             {"n_layers": [vlm.n_layers, INTERNVL_LAYERS]}, SERVE_REQUESTS)]


def port_cli(module, *args):
    """``python -m repro_torch.<module> *args`` from the repository's root,
    as a user runs it."""
    return subprocess.run([sys.executable, "-m", f"repro_torch.{module}", *args],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=300)


def attribution(label, eng, reqs):
    """Fold one recorded engine run with ``repro_torch.obs``. The events go
    to ``TRACE_DIR/<label>.jsonl`` (``repro_torch.trace.jsonl``); the
    bottleneck report is built in this process and again by ``python -m
    repro_torch.obs report --json`` on the file, and the two must agree. Every
    finished request's span must telescope to its measured latency
    (``Span.total_s == t_finished - arrival``, the identity of
    ``obs/spans.py``). Returns the regimes, the request phases and the
    windows' verdict reasons."""
    from repro_torch.obs import (attribute, bottleneck_report, build_windows,
                                 fold_spans, regime_fractions)
    from repro_torch.trace.jsonl import dump_events

    events = eng.events.events
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{label}.jsonl"
    n_events = dump_events(events, str(path))
    rep = bottleneck_report(events)
    trace = str(path.relative_to(ROOT))
    cli = port_cli("obs", "report", "--json", trace)
    if cli.returncode != 0:
        raise AssertionError(f"{label}: obs report exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    if json.loads(cli.stdout) != json.loads(json.dumps(rep)):
        raise AssertionError(f"{label}: the obs CLI's report of {path.name} "
                             "differs from the in-process report")
    spans = {sp.rid: sp for sp in fold_spans(events).spans}
    broken = [r.rid for r in reqs if r.t_finished is not None
              and (r.rid not in spans
                   or spans[r.rid].total_s != r.t_finished - r.arrival)]
    if broken:
        raise AssertionError(f"{label}: spans of rids {broken} do not sum to "
                             "t_finished - arrival")
    reasons = {}
    for v in attribute(build_windows(events)).verdicts:
        reasons[v.reason] = reasons.get(v.reason, 0) + 1
    q = rep["requests"]
    return dict(
        trace=trace, n_events=n_events, window_s=rep["window_s"],
        regimes=regime_fractions(rep), reasons=reasons,
        requests=dict(n_finished=q["n_finished"], n_unfinished=q["n_unfinished"],
                      n_preempted=q["n_preempted"],
                      phase_total_s={k: v["total_s"] for k, v in q["phases"].items()},
                      phase_frac_of_e2e={k: v["frac_of_e2e"]
                                         for k, v in q["phases"].items()}))


def trace_diff(a, b):
    """``python -m repro_torch.trace diff a b``: its exit code and the first
    line of its report."""
    res = port_cli("trace", "diff", a, b, "--context", "0")
    return res.returncode, (res.stdout.splitlines() or [res.stderr.strip()])[0]


def capacity(flash_ops, paged_ops):
    """The capacity-bound regime on the card: llama3.2-3b in bf16 at
    ``CAPACITY_LAYERS`` of its 28 layers serves ``SERVE_REQUESTS`` with 16 sequences at most on half the pool
    that holds them all, once with naive and once with kv-aware admission,
    the engine's sanitizer on. Beside each run, the port's ``SimRunner``
    with H100 constants serves the same lengths behind the same
    ``EngineConfig``. Every request arrives at t=0 and the scheduler reads
    no clock, so the card and the sim must take the same steps and preempt
    alike; naive admission must preempt and kv-aware must not. Each run's
    events are recorded and folded by ``attribution``: the naive card run
    must read ``capacity_bound`` for some of its time, the kv-aware one must
    have no window of a preemption storm, and each report must count every
    request finished. ``python -m repro_torch.trace diff`` must find the
    card's file equal to itself and diverging from the sim's (the clocks
    differ). Returns the kernels' launches of each card run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import perf_model as pm
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import SimRunner, TorchRunner
    from repro_torch.launch.serve import make_requests, pages_to_hold
    from repro_torch.models.transformer import Transformer

    full = get_config("llama3.2-3b")
    cfg = dataclasses.replace(full, n_layers=CAPACITY_LAYERS)
    r = SERVE_REQUESTS
    requests = make_requests(cfg.vocab, r["n"], r["isl"], r["osl"], r["seed"])
    n_pages = pages_to_hold(requests) // 2
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    launches, preempted = {}, {}
    for admission in ("naive", "kv_aware"):
        ecfg = EngineConfig(n_pages=n_pages, max_num_seqs=16,
                            admission_mode=admission, sanitize=True)
        runs, folds = {}, {}
        for side in ("card", "sim"):
            if side == "card":
                eng = InferenceEngine(cfg, ecfg, TorchRunner(model, device="cuda"),
                                      virtual_clock=False)
                eng.events.enable_recording()
                reqs = [eng.submit(p, n) for p, n in requests]
                _zero_launches(flash_ops, paged_ops)
            else:
                eng = InferenceEngine(cfg, ecfg, SimRunner(
                    cfg, pm.ParallelismPlan(), pm.H100))
                eng.events.enable_recording()
                reqs = [eng.submit(len(p), n) for p, n in requests]
            t0 = time.perf_counter()
            eng.run()
            if side == "card":
                torch.cuda.synchronize()
                launches[admission] = _launches(flash_ops, paged_ops)
            wall = time.perf_counter() - t0
            for (_, n), req in zip(requests, reqs):
                if len(req.output) != n or req.t_finished is None:
                    raise AssertionError(f"capacity/{admission}/{side}: request "
                                         f"{req.rid} has {len(req.output)} of {n}")
            s = eng.metrics.summary()
            runs[side] = dict(
                steps=len(eng.metrics.timeline), preemptions=s["preemptions"],
                recomputed_tokens=s["recomputed_tokens"],
                gen_tok_s=s["gen_throughput_tok_s"], ttft_p50_s=s["ttft_s"]["p50"],
                tpot_mean_s=s["tpot_s"]["mean"], engine_s=s["duration_s"],
                peak_kv_util=s["peak_kv_util"], host_wall_s=wall,
                preempted_rids=[q.rid for q in reqs if q.n_preemptions])
            folds[side] = attribution(f"capacity_{admission}_{side}", eng, reqs)
        card, sim = runs["card"], runs["sim"]
        diffs = {"card_card": trace_diff(folds["card"]["trace"], folds["card"]["trace"]),
                 "card_sim": trace_diff(folds["card"]["trace"], folds["sim"]["trace"])}
        emit("capacity", model=cfg.name, layers=cfg.n_layers, dtype="bfloat16",
             reduced={"n_layers": [full.n_layers, cfg.n_layers]},
             admission=admission, n_pages=n_pages,
             pages_to_hold=pages_to_hold(requests), max_num_seqs=16,
             sanitize=True, sim_hw=pm.H100.name, card=card, sim=sim,
             tpot_measured_over_predicted=card["tpot_mean_s"] / sim["tpot_mean_s"],
             launches=launches[admission],
             regimes={side: o["regimes"] for side, o in folds.items()},
             requests={side: o["requests"] for side, o in folds.items()},
             reasons={side: o["reasons"] for side, o in folds.items()},
             traces={side: dict(path=o["trace"], n_events=o["n_events"],
                                window_s=o["window_s"]) for side, o in folds.items()},
             trace_diff=diffs,
             clocks="card: the engine clock, the host wall time of each step "
                    "on the card; sim: the perf model's (H100 constants)")
        for key in ("steps", "preemptions", "recomputed_tokens", "preempted_rids"):
            if card[key] != sim[key]:
                raise AssertionError(f"capacity/{admission}: card {key} "
                                     f"{card[key]} differ from the sim's {sim[key]}")
        if min(launches[admission].values()) == 0:
            raise AssertionError(f"capacity/{admission}: a kernel was not on "
                                 f"the path: {launches[admission]}")
        for side, o in folds.items():
            if o["requests"]["n_finished"] != len(requests):
                raise AssertionError(f"capacity/{admission}/{side}: the report "
                                     f"finishes {o['requests']['n_finished']} of "
                                     f"{len(requests)} requests")
        if diffs["card_card"][0] != 0 or diffs["card_sim"][0] != 1:
            raise AssertionError(f"capacity/{admission}: trace diff exit codes "
                                 f"{diffs}; want 0 on itself, 1 against the sim")
        regimes, reasons = folds["card"]["regimes"], folds["card"]["reasons"]
        if admission == "naive" and not regimes["fractions"]["capacity_bound"] > 0:
            raise AssertionError("capacity/naive: the card run preempts but reads "
                                 f"no capacity_bound time: {regimes}")
        if admission == "kv_aware" and "preemption_storm" in reasons:
            raise AssertionError("capacity/kv_aware: a window of the card run is a "
                                 f"preemption storm: {reasons}")
        preempted[admission] = card["preemptions"]
    if preempted["naive"] < 1 or preempted["kv_aware"] != 0:
        raise AssertionError(f"capacity: preemptions {preempted}; naive must "
                             "preempt and kv-aware must not")
    return launches


# the kv_cache_dtype phase: llama3.2-3b's pool of SERVE_REQUESTS in fp8
# (768 pages of CAPACITY_LAYERS layers x 8 kv heads x 128, k and v, one byte
# each: 704,643,072 B at 28 layers); the int8 serve's requests; the
# equality run's pools (7 pages: preempting)
KV_FP8_POOL_BYTES = 768 * 16 * 8 * 128 * 2 * CAPACITY_LAYERS
KV_INT8_REQUESTS = PHI_REQUESTS
KV_EQ_ENGINE = dict(n_pages=7, max_num_seqs=4, max_num_batched_tokens=512,
                    chunk_size=192, admission_mode="naive")


def _q8_launches(paged_ops):
    """The other-page-dtype kernels' launches by instance since their
    counts were set to 0, and the same-dtype K2's."""
    return {"paged_attention": paged_ops.KERNEL.launches,
            "cvt": dict(paged_ops.CVT.by_instance),
            "upcast": dict(paged_ops.UPCAST.by_instance)}


def _zero_q8(paged_ops):
    for k in paged_ops.COUNTERS:
        k.reset()


def _schedule(eng, reqs):
    """What the scheduler decided in a run, which a card and a sim run of
    the same traffic and engine config must share."""
    s = eng.metrics.summary()
    return dict(steps=len(eng.metrics.timeline), preemptions=s["preemptions"],
                recomputed_tokens=s["recomputed_tokens"], n_finished=s["n_finished"],
                preempted_rids=[q.rid for q in reqs if q.n_preemptions])


def kv_cache_dtype_phase(flash_ops, paged_ops):
    """The reference's ``kv_cache_dtype`` lever on the card: llama3.2-3b at
    ``CAPACITY_LAYERS`` of its 28 layers, bf16 weights, served from an fp8 cache
    (``ParallelContext(kv_cache_dtype=float8_e4m3fn)``) through
    ``InferenceEngine`` -> ``TorchRunner``: the capacity traffic
    (``SERVE_REQUESTS``, naive admission, the sanitizer on) on the pool
    that holds it all, which is the bf16 ``capacity`` run's bytes (768
    pages; ``KV_FP8_POOL_BYTES``), K1 and K2 over fp8 pages counted (the
    cluster design, and no other), and the same traffic and engine config on ``SimRunner``
    beside it: equal steps, preemptions and recomputed tokens. Then the
    same traffic and engine config under ``decode_unroll`` (the cache read
    upcast to bf16): every request finishes, and K2's upcast cluster
    instance alone launches, once a layer a decode step; its TPOT beside
    the default mode's. Then from an int8 cache (``KV_INT8_REQUESTS``).
    Then the equality run: a full-width 2-layer fp32 model on the card and
    its CPU copy, each from an fp8 and from an int8 cache on a preempting
    pool, and from an fp8 cache under ``decode_unroll``, tokens equal.
    Returns the launches of each card run by model."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config
    from repro_torch.core import perf_model as pm
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import SimRunner, TorchRunner
    from repro_torch.launch.serve import make_requests, pages_to_hold
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import ParallelContext

    full = get_config("llama3.2-3b")
    cfg = dataclasses.replace(full, n_layers=CAPACITY_LAYERS)
    launches, tpot = {}, {}
    for cache, traffic, unroll in ((torch.float8_e4m3fn, SERVE_REQUESTS, False),
                                   (torch.float8_e4m3fn, SERVE_REQUESTS, True),
                                   (torch.int8, KV_INT8_REQUESTS, False)):
        r = traffic
        requests = make_requests(cfg.vocab, r["n"], r["isl"], r["osl"], r["seed"])
        # the fp8 runs are the capacity traffic: naive admission and the
        # sanitizer, as the bf16 ``capacity`` runs
        fp8 = cache == torch.float8_e4m3fn
        ecfg = EngineConfig(n_pages=pages_to_hold(requests), max_num_seqs=16,
                            **(dict(admission_mode="naive", sanitize=True) if fp8 else {}))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                            ctx=ParallelContext(kv_cache_dtype=cache, decode_unroll=unroll))
        runner = TorchRunner(model, device="cuda")
        steps = [0]
        decode = runner.decode

        def counted(reqs, decode=decode, steps=steps):
            steps[0] += 1
            return decode(reqs)

        runner.decode = counted
        eng = InferenceEngine(cfg, ecfg, runner, virtual_clock=False)
        reqs = [eng.submit(p, n) for p, n in requests]
        _zero_launches(flash_ops, paged_ops)
        _zero_q8(paged_ops)
        eng.run()
        torch.cuda.synchronize()
        n = dict(_launches(flash_ops, paged_ops), **_q8_launches(paged_ops))
        wall = time.perf_counter() - t0
        label = f"kv_cache_dtype {_dt(cache)}" + (" decode_unroll" if unroll else "")
        for (_, want), req in zip(requests, reqs):
            if len(req.output) != want or req.t_finished is None:
                raise AssertionError(f"{label}: request {req.rid} has "
                                     f"{len(req.output)} of {want} tokens")
        pools = eng.runner.pools
        pool_bytes = sum(t.numel() * t.element_size() for t in pools)
        # the main path's K2 over the cache: the default mode's one-launch
        # cluster design, or under decode_unroll the upcast mode's, once a
        # layer a decode step
        instance = f"bfloat16/{_dt(cache)} cluster"
        used, unused = ("upcast", "cvt") if unroll else ("cvt", "upcast")
        if any(t.dtype != cache for t in pools) or n["paged_attention"] \
                or not n["flash_attention"] or not n[used].get(instance) \
                or sum(n[used].values()) != n[used][instance] or any(n[unused].values()) \
                or (unroll and n[used][instance] != steps[0] * cfg.n_layers):
            raise AssertionError(f"{label}: pools {[t.dtype for t in pools]}, "
                                 f"{steps[0]} decode steps, launches {n}")
        if fp8 and pool_bytes != KV_FP8_POOL_BYTES:
            raise AssertionError(f"{label}: pool of {pool_bytes} B, want "
                                 f"{KV_FP8_POOL_BYTES}")
        s = eng.metrics.summary()
        card = _schedule(eng, reqs)
        tpot[label] = s["tpot_s"]["mean"]
        emit("kv_cache_dtype", model=cfg.name, layers=cfg.n_layers, dtype="bfloat16",
             reduced={"n_layers": [full.n_layers, cfg.n_layers]},
             cache_dtype=_dt(cache), decode_unroll=unroll, n_requests=len(requests),
             admission=ecfg.admission_mode, sanitize=ecfg.sanitize,
             gen_tokens=s["gen_tokens"], gen_tok_s=s["gen_throughput_tok_s"],
             ttft_p50_s=s["ttft_s"]["p50"], tpot_mean_s=s["tpot_s"]["mean"],
             tpot_mean_s_default_mode=tpot.get(f"kv_cache_dtype {_dt(cache)}"),
             decode_steps=steps[0], engine_s=s["duration_s"],
             wall_s_with_weight_init=wall,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             n_pages=pools[0].shape[1], pool_bytes=pool_bytes,
             pool_bytes_bf16=2 * pool_bytes // pools[0].element_size(), card=card,
             launches=n)
        launches[f"llama3.2-3b {label}"] = n
        del model, eng, reqs, pools, runner
        free_card()
        if not fp8 or unroll:
            continue
        # the same traffic and engine config on the port's SimRunner
        sim = InferenceEngine(cfg, ecfg, SimRunner(cfg, pm.ParallelismPlan(), pm.H100))
        sreqs = [sim.submit(len(p), n) for p, n in requests]
        sim.run()
        side = _schedule(sim, sreqs)
        emit("kv_cache_dtype_capacity", model=cfg.name, cache_dtype=_dt(cache),
             admission=ecfg.admission_mode, n_pages=ecfg.n_pages, pool_bytes=pool_bytes,
             bf16_capacity_pages=pages_to_hold(requests) // 2, sim_hw=pm.H100.name,
             card=card, sim=side, sim_tpot_mean_s=sim.metrics.summary()["tpot_s"]["mean"])
        if card != side:
            raise AssertionError(f"kv_cache_dtype capacity: card {card} differs from "
                                 f"the sim's {side}")

    # equality: a 2-layer fp32 model on the card and on the CPU
    small = dc.replace(cfg, n_layers=2)
    rng = np.random.default_rng(4)
    requests = [(rng.integers(0, cfg.vocab, size=30).tolist(), 20) for _ in range(4)]
    for cache, unroll in ((torch.float8_e4m3fn, False), (torch.int8, False),
                          (torch.float8_e4m3fn, True)):
        if cache == torch.float8_e4m3fn:   # the models of the context
            ctx = ParallelContext(decode_unroll=unroll)
            card = Transformer(small, device="cuda", dtype=torch.float32, seed=1, ctx=ctx)
            host = Transformer(small, device="cpu", dtype=torch.float32, seed=None, ctx=ctx)
            on_card = dict(card.named_parameters())
            with torch.no_grad():
                for name, p in host.named_parameters():
                    p.copy_(on_card[name])
            del on_card
        outs, runs = {}, {}
        _zero_q8(paged_ops)
        for dev, model in (("cuda", card), ("cpu", host)):
            eng = InferenceEngine(small, EngineConfig(**KV_EQ_ENGINE),
                                  TorchRunner(model, device=dev, cache_dtype=cache),
                                  virtual_clock=False)
            reqs = [eng.submit(p, n) for p, n in requests]
            t0 = time.perf_counter()
            eng.run(max_steps=5000)
            outs[dev] = [q.output for q in reqs]
            runs[dev] = dict(preemptions=sum(q.n_preemptions for q in reqs),
                             steps=len(eng.metrics.timeline),
                             seconds=time.perf_counter() - t0)
            if any(len(q.output) != n for (_, n), q in zip(requests, reqs)):
                raise AssertionError(f"kv_cache_dtype equality {cache}/{dev}: unfinished")
        n = _q8_launches(paged_ops)
        # an fp32 q: the default mode's cluster, or the upcast mode's split
        counter, instance = ("upcast", f"float32/{_dt(cache)} split") if unroll else \
            ("cvt", f"float32/{_dt(cache)} cluster")
        if outs["cuda"] != outs["cpu"] or not runs["cuda"]["preemptions"] \
                or not n[counter].get(instance):
            raise AssertionError(f"kv_cache_dtype equality {cache}: card tokens "
                                 f"{outs['cuda']} against CPU {outs['cpu']}, runs {runs}, "
                                 f"launches {n}")
        emit("kv_cache_dtype_equality", model=cfg.name, layers=2, dtype="float32",
             cache_dtype=_dt(cache), decode_unroll=unroll, tokens_equal=True, runs=runs,
             launches=n)
    del card, host
    free_card()
    return launches


# a decode step at reasoning lengths on the main path: llama3-405b's
# published widths (128 q / 8 kv heads of 128, G 16), REASONING_LAYERS of
# its 126 layers for the run's time, bf16 weights from a seed, an fp8
# cache (``ParallelContext(kv_cache_dtype=)``) seeded on the card; 16
# sequences whose contexts are drawn from ``Q8_REASONING``'s 12,288-33,792
# tokens, decoded ``steps`` greedy tokens through ``Transformer.decode_step``
REASONING_LAYERS = 4
REASONING_DECODE = dict(B=16, min_ctx=12_288, max_ctx=33_792, steps=4, seed=27)


def reasoning_inputs(vocab):
    """``REASONING_DECODE``'s draws from its numpy seed, in order: the 16
    contexts (the first the longest), the tables (each covering its last
    step's token in shuffled pages; the pad entries name the pool's last
    page, which no sequence reads) and the first tokens. Returns (contexts,
    tables (B, n) int32, the pool's pages P, tokens)."""
    r = REASONING_DECODE
    rng = np.random.default_rng(r["seed"])
    ctx = rng.integers(r["min_ctx"], r["max_ctx"] + 1, size=r["B"])
    ctx[0] = r["max_ctx"]
    n_blocks = -(-(ctx + r["steps"]) // 16)
    P = int(n_blocks.sum()) + 1
    perm = rng.permutation(P - 1).astype(np.int32)
    tables = np.full((r["B"], int(n_blocks.max())), P - 1, np.int32)
    used = 0
    for b, n in enumerate(n_blocks):
        tables[b, :n] = perm[used:used + n]
        used += n
    return ctx, tables, P, rng.integers(0, vocab, size=r["B"])


def seed_reasoning_pools(model, P, gen, keep=None):
    """The fp8 pools of ``model`` for ``REASONING_DECODE``: every layer's k
    and v pages drawn in order from ``gen`` (seeded with its seed) on the
    card, as a pool of P pages; with ``keep`` (page ids) only those pages,
    in that order, then a zero pad page."""
    from repro_torch.models.cache_dtype import to_cache_dtype, writable
    cache = torch.float8_e4m3fn
    n = P if keep is None else len(keep) + 1
    pools = [torch.zeros(shape, dtype=model.pool_dtype(), device="cuda")
             for shape in model.pool_shapes(n, 16)]
    for pool in pools:
        for layer in range(pool.shape[0]):
            drawn = writable(to_cache_dtype(torch.randn(
                (P, *pool.shape[2:]), generator=gen, device="cuda"), cache))
            writable(pool[layer])[:n if keep is None else n - 1].copy_(
                drawn if keep is None else drawn[keep])
            del drawn
    return pools


def reasoning_decode(flash_ops, paged_ops):
    """``reasoning_decode``: the decode steps of ``REASONING_DECODE`` on a
    seeded fp8 pool, timed by CUDA events; K2 must launch only its
    ``cluster`` instance, once a layer a step, and no other kernel; K2 then
    held against its plain version on layer 0's pool at the last step's
    tables (a seeded q, ``hold_q8``'s bounds) and its device time at those
    inputs set beside the step's. Returns the step's launches and what
    ``split_reasoning`` holds its ranks to: the greedy tokens, the first
    step's logits (fp32, on the host), the median step and K2's device
    time a step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_attention.ref import weight_slack
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import ParallelContext

    r = REASONING_DECODE
    full = get_config("llama3-405b")
    cfg = dataclasses.replace(full, n_layers=REASONING_LAYERS)
    cache = torch.float8_e4m3fn
    ctx, tables, P, first = reasoning_inputs(cfg.vocab)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                        ctx=ParallelContext(kv_cache_dtype=cache))
    gen = torch.Generator(device="cuda").manual_seed(r["seed"])
    pools = seed_reasoning_pools(model, P, gen)
    setup_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    tables_t = torch.from_numpy(tables).to(dev)
    tokens = torch.from_numpy(first).to(dev)
    _zero_launches(flash_ops, paged_ops)
    _zero_q8(paged_ops)
    steps_ms, out = [], []
    with torch.no_grad():
        for step in range(r["steps"]):
            positions = torch.from_numpy(ctx + step).to(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            logits = model.decode_step(tokens, positions, pools, tables_t)
            end.record()
            end.synchronize()
            steps_ms.append(start.elapsed_time(end))
            if not bool(torch.isfinite(logits.float()).all()):
                raise AssertionError(f"reasoning_decode: step {step} logits not finite")
            if step == 0:
                logits0 = logits.float().cpu()
            tokens = logits.argmax(dim=-1)
            out.append(tokens.tolist())
    n = dict(_launches(flash_ops, paged_ops), **_q8_launches(paged_ops))
    instance = f"bfloat16/{_dt(cache)} cluster"
    if n["flash_attention"] or n["paged_attention"] or n["upcast"] \
            or n["cvt"] != {instance: cfg.n_layers * r["steps"]}:
        raise AssertionError(f"reasoning_decode: launches {n}, want only "
                             f"{cfg.n_layers * r['steps']} of {instance}")
    # K2 on layer 0's pool at the last step's lens, against its plain version
    lens = torch.from_numpy(ctx + r["steps"] - 1).to(dev, torch.int32)
    q = torch.randn((r["B"], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.resolved_head_dim), generator=gen, device=dev).to(torch.bfloat16)
    kp, vp = pools[0][0], pools[1][0]
    got = paged_ops.paged_attention(q, kp, vp, tables_t, lens)
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables_t, lens)
    slack = weight_slack(q, kp, vp, tables_t, lens)
    err, exact, rel = hold_q8("reasoning_decode K2", got, ref, q, vp, slack, False)
    del ref, slack
    kernel = lambda: paged_ops.paged_attention(q, kp, vp, tables_t, lens)  # noqa: E731
    k2_ms = device_ms(kernel, 20)
    keys = int(lens.long().add(1).sum()) * cfg.n_kv_heads
    needed = 2 * keys * cfg.resolved_head_dim + nbytes(q, got, tables_t, lens)
    b_ms, b_by = bound(4 * keys * q.shape[2] * q.shape[3], needed, torch.bfloat16)
    median = sorted(steps_ms[1:])[len(steps_ms[1:]) // 2]
    emit("reasoning_decode", model=cfg.name, layers=cfg.n_layers,
         reduced={"n_layers": [full.n_layers, cfg.n_layers]}, dtype="bfloat16",
         cache_dtype=_dt(cache), batch=r["B"], contexts=ctx.tolist(),
         n_pages=P, pool_bytes=sum(t.numel() * t.element_size() for t in pools),
         setup_s=setup_s, steps_ms=steps_ms, step_ms_median=median,
         k2_device_ms=k2_ms, k2_device_ms_per_step=k2_ms * cfg.n_layers,
         k2_share_of_step=k2_ms * cfg.n_layers / median, k2_bound_ms=b_ms,
         k2_bound_by=b_by, k2_device_bound_share=b_ms / k2_ms,
         k2_max_abs_err=err, k2_max_abs_err_without_slack=exact, k2_rel_rms=rel,
         tokens=out, launches=n)
    del model, pools, kp, vp, q, got
    free_card()
    return {f"{cfg.name} reasoning_decode {_dt(cache)}": n}, dict(
        tokens=out, logits0=logits0, step_ms_median=median,
        k2_device_ms_per_step=k2_ms * cfg.n_layers)


# split_reasoning: ``reasoning_decode``'s model, pool and traffic with the
# cache's sequence cut over two gloo ranks of a (data 2, model 1) mesh on
# the card (``SPLIT_OVERRIDE``; weights whole on each rank), each rank's
# pools holding only its half of every table's positions: K2's sequence
# split over fp8 pages, three launches a layer. The first step's logits
# against the unsplit model's: within this share of their largest
# magnitude (a weight rounded to the other e4m3 neighbour, where the split's
# (M, L) differs from the one launch's by ulps, moves an attention output
# by one e4m3 step times |v|; the bf16 layers carry that to the logits)
SPLIT_REASONING_LOGITS_RTOL = 2.0 ** -5


def split_reasoning_rank(rank, out_dir):
    """One rank of ``split_reasoning`` (``run_ranks`` spawns two on the
    card): llama3-405b at ``REASONING_LAYERS`` in bf16 from seed 0 on the
    (2, 1) mesh, its fp8 pools this rank's half of every table's positions
    (``reasoning_inputs``' tables padded to an even width and cut in two;
    the pages seeded as ``reasoning_decode`` seeds them), then
    ``REASONING_DECODE``'s steps. Every kernel's count and the
    collectives' counters set to 0 just before the first step and read
    after the last; each step timed by CUDA events, and K2's three launches
    a layer (pass 1, pass 2, the sum) by CUDA events around each. Writes its
    row to ``out_dir``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import transformer as tm
    from repro_torch.parallel.sharding import ParallelContext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = REASONING_DECODE
    cfg = dataclasses.replace(get_config("llama3-405b"), n_layers=REASONING_LAYERS)
    data, model_axis = SPLIT_MESH
    ctx = ParallelContext(mesh=make_mesh_for(data * model_axis, model_axis,
                                             device_type="cuda"),
                          fsdp_axis=None, rules_override=SPLIT_OVERRIDE,
                          kv_cache_dtype=torch.float8_e4m3fn)
    lens, tables, P, first = reasoning_inputs(cfg.vocab)
    W = -(-tables.shape[1] // data)                  # a rank's table width
    tables = np.pad(tables, ((0, 0), (0, data * W - tables.shape[1])), constant_values=P - 1)
    mine = tables[:, rank * W:(rank + 1) * W]
    keep = np.unique(mine[mine != P - 1])            # this rank's pages
    local = np.full(P, len(keep), np.int32)          # the pad entries: the local pad page
    local[keep] = np.arange(len(keep), dtype=np.int32)
    t0 = time.perf_counter()
    model = tm.Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=0, ctx=ctx)
    torch.cuda.empty_cache()   # the init's buffers, for the other rank
    pools = seed_reasoning_pools(model, P,
                                 torch.Generator(device="cuda").manual_seed(r["seed"]),
                                 torch.from_numpy(keep).long().cuda())
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    tables_t = torch.from_numpy(local[mine]).to(dev)
    tokens = torch.from_numpy(first).to(dev)
    # K2's launches on the path, each between CUDA events
    marks = []

    def timed_op(fn):
        def call(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **kw)
            end.record()
            marks.append((start, end))
            return out
        return call

    for name in ("paged_attention_stats", "paged_attention_values", "paged_sum"):
        setattr(tm, name, timed_op(getattr(tm, name)))
    for k in (flash_ops.KERNEL, flash_ops.NONCAUSAL, *paged_ops.COUNTERS):
        k.reset()
    ctx.comm.reset()
    steps_ms, k2_ms, out = [], [], []
    with torch.inference_mode():
        for step in range(r["steps"]):
            marks.clear()
            positions = torch.from_numpy(lens + step).to(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            logits = model.decode_step(tokens, positions, pools, tables_t)
            end.record()
            end.synchronize()
            steps_ms.append(start.elapsed_time(end))
            k2_ms.append(sum(a.elapsed_time(b) for a, b in marks))
            if step == 0:
                torch.save(logits.float().cpu(), Path(out_dir) / f"logits0.rank{rank}.pt")
            tokens = logits.argmax(dim=-1)
            out.append(tokens.tolist())
    launches = {"flash_attention": flash_ops.KERNEL.launches + flash_ops.NONCAUSAL.launches,
                **{k.symbol: k.launches for k in paged_ops.COUNTERS},
                "by_instance": {k.symbol: dict(k.by_instance) for k in paged_ops.COUNTERS
                                if k.by_instance}}
    row = dict(rank=rank, tokens=out, steps_ms=steps_ms, k2_device_ms=k2_ms,
               setup_s=setup_s, table_width=W, pages=len(keep) + 1,
               pool_bytes=sum(t.numel() * t.element_size() for t in pools),
               no_key_rows=int((lens + r["steps"] <= rank * W * 16).sum()),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches,
               comm={k: v["calls"] for k, v in ctx.comm.stats.items()})
    with open(Path(out_dir) / f"split_reasoning.rank{rank}.json", "w") as f:
        json.dump(row, f)


def split_reasoning(unsplit):
    """``split_reasoning``: ``split_reasoning_rank`` on two gloo ranks.
    Each rank's greedy tokens must equal ``unsplit``'s (``reasoning_decode``
    in this run), its first step's logits lie within
    ``SPLIT_REASONING_LOGITS_RTOL`` of the unsplit ones' largest magnitude,
    and it must launch K2's split pass 1, pass 2 and the sum (the cluster
    design) ``REASONING_LAYERS`` x steps times each, and no other K2
    instance (not the one-launch cluster, not the upcast library) and no
    K1. One line a rank. Returns the launches by
    rank."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    r = REASONING_DECODE
    out = tempfile.mkdtemp(prefix="split_reasoning_")
    world = SPLIT_MESH[0] * SPLIT_MESH[1]
    try:
        run_ranks(split_reasoning_rank, world, (out,), backend="gloo", device_type="cuda")
        ranks = [json.loads((Path(out) / f"split_reasoning.rank{i}.json").read_text())
                 for i in range(world)]
        logits = [torch.load(Path(out) / f"logits0.rank{i}.pt") for i in range(world)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    n_calls = REASONING_LAYERS * r["steps"]
    want = {"paged_cvt_share_stats": n_calls, "paged_cvt_share_values": n_calls,
            "paged_cvt_sum": n_calls}
    ref = unsplit["logits0"]
    scale = float(ref.abs().max())
    launches = {}
    for row, lg in zip(ranks, logits):
        n = row["launches"]
        others = {k: v for k, v in n.items() if k not in want and k != "by_instance" and v}
        diff = float((lg - ref).abs().max())
        if row["tokens"] != unsplit["tokens"] or any(n[k] != v for k, v in want.items()) \
                or others or not bool(torch.isfinite(lg).all()) \
                or diff > SPLIT_REASONING_LOGITS_RTOL * scale:
            raise AssertionError(
                f"split_reasoning rank {row['rank']}: tokens {row['tokens']} against "
                f"unsplit {unsplit['tokens']}, launches {n} (want {want} and no other), "
                f"first logits off by {diff} of {scale}")
        median = sorted(row["steps_ms"][1:])[len(row["steps_ms"][1:]) // 2]
        k2 = sorted(row["k2_device_ms"][1:])[len(row["k2_device_ms"][1:]) // 2]
        emit("split_reasoning", model="llama3-405b", rank=row["rank"],
             mesh={"data": SPLIT_MESH[0], "model": SPLIT_MESH[1]},
             layers=REASONING_LAYERS, reduced={"n_layers": [126, REASONING_LAYERS]},
             dtype="bfloat16", cache_dtype="float8_e4m3fn", batch=r["B"],
             table_width=row["table_width"], pages=row["pages"],
             pool_bytes=row["pool_bytes"], rows_without_a_key=row["no_key_rows"],
             tokens=row["tokens"], tokens_equal_unsplit=True,
             first_logits_max_abs_diff=diff, first_logits_scale=scale,
             first_logits_rtol=SPLIT_REASONING_LOGITS_RTOL,
             launches={k: v for k, v in n.items() if k == "by_instance" or v},
             collectives=row["comm"], steps_ms=row["steps_ms"], step_ms_median=median,
             k2_device_ms_per_step=row["k2_device_ms"], k2_device_ms_median=k2,
             unsplit_step_ms_median=unsplit["step_ms_median"],
             unsplit_k2_device_ms_per_step=unsplit["k2_device_ms_per_step"],
             setup_s=row["setup_s"], max_memory_allocated=row["max_memory_allocated"])
        launches[f"llama3-405b split_reasoning rank{row['rank']}"] = n
    return launches


# danube_tp8: h2o-danube-3-4b at its published widths (d 3840, 32 q / 8 kv
# heads of 120, d_ff 10240, vocab 32000, window 4096), DANUBE_TP8_LAYERS of
# its 24 layers for the run's time, bf16 weights from seed 0, served at tp 8
# (a (data 1, model 8) mesh of gloo ranks on the one card: 4 q heads and
# one kv head a rank) from an fp8 cache (``ParallelContext(kv_cache_dtype=)``)
# through ``InferenceEngine(virtual_clock=False)`` on ``TorchRunner(max_len=)``:
# 4 prompts of 4,200-4,400 tokens (past the window) drawn from numpy seed
# 30, 8 new tokens each, naive admission on a pool that holds them all.
# Each rank's K2 reads its one kv head's 8-bit rows of 120 through the map
# over token pairs.
DANUBE_TP8_LAYERS = 2
DANUBE_TP8_MESH = (1, 8)
DANUBE_TP8_REQUESTS = dict(n=4, isl=(4200, 4400), osl=(8, 8), seed=30)
# tp 8's greedy tokens against tp 1's (the same model on one device from an
# fp8 cache): the ranks' partial sums of the attention and MLP outputs are
# added in another order than one device's products, which moves the bf16
# hidden state by ulps, and the logits after 2 layers and the head by a few
# parts in a thousand of their largest magnitude; a position may differ
# only where tp 1's top-two margin there lies below this share of that
# step's largest logit magnitude (a near tie), and the request's later
# positions (its context then differs) are not compared
DANUBE_TP8_MARGIN_RTOL = 2.0 ** -5


def danube_tp8_work():
    """``danube_tp8``'s config (its cut: ``DANUBE_TP8_LAYERS`` layers) and
    requests, and the engine config that serves them."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.serve import make_requests, pages_to_hold
    r = DANUBE_TP8_REQUESTS
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"), n_layers=DANUBE_TP8_LAYERS)
    requests = make_requests(cfg.vocab, r["n"], r["isl"], r["osl"], r["seed"])
    ecfg = EngineConfig(n_pages=pages_to_hold(requests), max_num_seqs=r["n"],
                        admission_mode="naive")
    return cfg, requests, ecfg


def danube_serve(ctx, label, device="cuda", margins=False):
    """``danube_tp8_work``'s requests served on ``ctx`` (its mesh, or one
    device without one) through the engine on ``TorchRunner``; the leader
    runs the engine, the other ranks follow it. Every kernel's count and
    the collectives' counters are set to 0 just before the engine runs and
    read just after. K2's first launch (layer 0 of the first decode step)
    is held against its plain version on the same inputs (``hold_q8``'s
    bounds and ``weight_slack``), and every launch timed by CUDA events.
    With ``margins`` (one device) each output position's top-two logit
    margin and the step's largest logit magnitude are kept. Returns the
    rank's row."""
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import weight_slack
    from repro_torch.models import transformer as tm

    cfg, requests, ecfg = danube_tp8_work()
    t0 = time.perf_counter()
    model = tm.Transformer(cfg, device=device, dtype=torch.bfloat16, seed=0, ctx=ctx)
    cuda = torch.device(device).type == "cuda"
    held, marks = {}, []
    k2 = tm.paged_attention

    def counted_k2(q, kp, vp, tables, lens, **kw):
        if not held:   # layer 0 of the first decode step, before its launch
            args = [t.clone() for t in (q, kp, vp, tables, lens)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2)) if cuda \
            else (None, None)
        if cuda:
            start.record()
        out = k2(q, kp, vp, tables, lens, **kw)
        if cuda:
            end.record()
            marks.append((start, end))
        if not held:
            ref = paged_ops.paged_attention_plain(*args, **kw)
            slack = weight_slack(*args, **kw)
            err, exact, rel = hold_q8(f"{label} K2", out, ref, args[0], args[2], slack,
                                      False)
            held.update(shape=list(q.shape), max_abs_err=err, max_abs_err_without_slack=exact,
                        rel_rms=rel, contexts=(args[4] + 1).tolist())
        return out

    class Runner(TorchRunner):
        """``TorchRunner`` that times its decode steps (every rank runs
        ``_decode``) and, with ``margins``, keeps each output's margin from
        the logits of its last model call (``logits``)."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.steps_s, self.k2_ms, self.margin, self.logits = [], [], {}, None

        def _decode(self, *work):
            marks.clear()
            t = time.perf_counter()
            out = super()._decode(*work)
            self.steps_s.append(time.perf_counter() - t)
            self.k2_ms.append(sum(a.elapsed_time(b) for a, b in marks) if cuda else 0.0)
            return out

        def prefill(self, req, chunk):
            tok = super().prefill(req, chunk)
            self._keep(req.rid, 0)
            return tok

        def decode(self, reqs):
            out = super().decode(reqs)
            for i, r in enumerate(reqs):   # one device: row i is reqs[i]
                self._keep(r.rid, len(r.output), i)
            return out

        def _keep(self, rid, k, row=0):
            if margins:
                top = self.logits[row].float().topk(2).values
                self.margin[rid, k] = (float(top[0] - top[1]),
                                       float(self.logits[row].float().abs().max()))

    runner = Runner(model, device=device, max_len=lever_max_len(requests, ctx))
    if margins:   # each call's logits, for _keep
        for name in ("prefill", "decode_step"):
            def keep(*a, _f=getattr(model, name), **kw):
                out = _f(*a, **kw)
                runner.logits = out[0] if isinstance(out, tuple) else out   # (B, vocab)
                return out
            setattr(model, name, keep)
    setup_s = time.perf_counter() - t0
    tm.paged_attention = counted_k2
    for k in (flash_ops.KERNEL, flash_ops.NONCAUSAL, *paged_ops.COUNTERS):
        k.reset()
    if ctx.mesh is not None:
        ctx.comm.reset()
    t0 = time.perf_counter()
    tokens = None
    try:
        if runner.leads:
            try:
                eng = InferenceEngine(cfg, ecfg, runner, virtual_clock=False)
                reqs = [eng.submit(p, n) for p, n in requests]
                eng.run(max_steps=LEVER_MAX_STEPS)
            finally:
                runner.close()
            tokens = [r.output for r in reqs]
            rids = [r.rid for r in reqs]
        else:
            runner.follow()
        if cuda:
            torch.cuda.synchronize()
    finally:
        tm.paged_attention = k2
    serve_s = time.perf_counter() - t0
    row = dict(
        tokens=tokens, setup_s=setup_s, serve_s=serve_s, decode_steps=len(runner.steps_s),
        decode_step_s=runner.steps_s, k2_device_ms_per_step=runner.k2_ms,
        flash_attention=flash_ops.KERNEL.launches + flash_ops.NONCAUSAL.launches,
        launches={k.symbol: k.launches for k in paged_ops.COUNTERS},
        by_instance={k.symbol: dict(k.by_instance) for k in paged_ops.COUNTERS
                     if k.by_instance},
        pool_bytes=sum(t.numel() * t.element_size() for t in runner.pools),
        pool_dtypes=sorted({str(t.dtype) for t in runner.pools}), k2_first_step=held,
        comm={op: {"calls": v["calls"], "bytes": v["bytes"]}
              for op, v in ctx.comm.stats.items()} if ctx.mesh is not None else {})
    if margins and tokens is not None:
        row["margins"] = [[runner.margin[rid, k] for k in range(len(t))]
                          for rid, t in zip(rids, tokens)]
    del model, runner
    return row


def danube_tp8_rank(rank, out_dir, device="cuda"):
    """One rank of ``danube_tp8`` (``run_ranks`` spawns the mesh's ranks on
    the card): ``danube_serve`` on the (1, 8) mesh. Writes its row to
    ``out_dir``."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel.sharding import ParallelContext
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, tp = DANUBE_TP8_MESH
    ctx = ParallelContext(mesh=make_mesh_for(data * tp, tp, device_type=device),
                          kv_cache_dtype=torch.float8_e4m3fn)
    row = dict(rank=rank, **danube_serve(ctx, f"danube_tp8 rank {rank}", device),
               max_memory_allocated=torch.cuda.max_memory_allocated() if device == "cuda"
               else 0)
    with open(Path(out_dir) / f"danube_tp8.rank{rank}.json", "w") as f:
        json.dump(row, f)


def danube_tokens_agree(got, want, margins):
    """``got`` (tp 8's tokens by request) against ``want`` (tp 1's) under
    ``DANUBE_TP8_MARGIN_RTOL``: per request, None where they are equal,
    else its first differing position with tp 1's margin and logit scale
    there. Raises where a difference is no near tie."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        k = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 None if len(g) == len(w) else min(len(g), len(w)))
        if k is None:
            out.append(None)
            continue
        margin, scale = margins[i][k] if k < len(margins[i]) else (float("inf"), 1.0)
        if not margin < DANUBE_TP8_MARGIN_RTOL * scale:
            raise AssertionError(f"danube_tp8: request {i} differs from tp 1 at position {k} "
                                 f"({g} against {w}), where tp 1's top-two margin {margin} is "
                                 f"no near tie (scale {scale})")
        out.append(dict(position=k, margin=margin, scale=scale))
    return out


def danube_tp8():
    """``danube_tp8``: ``danube_tp8_rank`` on the (1, 8) mesh's gloo ranks,
    then the same model served at tp 1 on the card from an fp8 cache. On
    every rank K2 must launch only the default mode's cluster instance
    through the map over token pairs, ``DANUBE_TP8_LAYERS`` x decode steps
    times, no other K2 instance and K1 for the prefills; K2's first launch
    within ``hold_q8``'s bounds of its plain version; every rank's greedy
    tokens equal tp 1's but at near ties (``danube_tokens_agree``). One
    line a rank: tokens, K2's launches by instance, collectives by op, the
    phase's seconds, the median decode step and K2's device time a step.
    Returns the launches by rank."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.parallel.sharding import ParallelContext

    t_start = time.perf_counter()
    out = tempfile.mkdtemp(prefix="danube_tp8_")
    world = DANUBE_TP8_MESH[0] * DANUBE_TP8_MESH[1]
    try:
        run_ranks(danube_tp8_rank, world, (out,), backend="gloo", device_type="cuda")
        ranks = [json.loads((Path(out) / f"danube_tp8.rank{i}.json").read_text())
                 for i in range(world)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    ranks_s = time.perf_counter() - t_start
    free_card()
    one = danube_serve(ParallelContext(kv_cache_dtype=torch.float8_e4m3fn), "danube_tp8 tp 1",
                       margins=True)
    free_card()
    cfg, requests, _ = danube_tp8_work()
    tokens = ranks[0]["tokens"]
    near = danube_tokens_agree(tokens, one["tokens"], one["margins"])
    instance = "bfloat16/float8_e4m3fn cluster paired"
    launches = {}
    for row in ranks:
        n, steps = row["launches"], row["decode_steps"]
        want = {k: 0 for k in n} | {"paged_cvt_fwd": cfg.n_layers * steps}
        if n != want or row["by_instance"] != {"paged_cvt_fwd": {instance: cfg.n_layers * steps}} \
                or not row["flash_attention"] or not steps \
                or row["pool_dtypes"] != ["torch.float8_e4m3fn"] \
                or row["k2_first_step"].get("shape", [None, None])[1] != 1:
            raise AssertionError(f"danube_tp8 rank {row['rank']}: launches {n} by instance "
                                 f"{row['by_instance']} in {steps} decode steps (want only "
                                 f"{cfg.n_layers * steps} of {instance}), K1 "
                                 f"{row['flash_attention']}, pools {row['pool_dtypes']}, "
                                 f"K2's first call {row['k2_first_step']}")
        steps_s = sorted(row["decode_step_s"][1:])
        k2 = sorted(row["k2_device_ms_per_step"][1:])
        emit("danube_tp8", model=cfg.name, rank=row["rank"],
             mesh={"data": DANUBE_TP8_MESH[0], "model": DANUBE_TP8_MESH[1]},
             layers=cfg.n_layers, reduced={"n_layers": [24, cfg.n_layers]}, dtype="bfloat16",
             cache_dtype="float8_e4m3fn", kv_heads_per_rank=row["k2_first_step"]["shape"][1],
             prompts=[len(p) for p, _ in requests], window=cfg.swa_window,
             tokens=tokens, tp1_tokens=one["tokens"], near_ties=near,
             margin_rtol=DANUBE_TP8_MARGIN_RTOL, k2_launches_by_instance=row["by_instance"],
             k1_launches=row["flash_attention"], collectives=row["comm"],
             decode_steps=row["decode_steps"], decode_step_s=row["decode_step_s"],
             decode_step_s_median=steps_s[len(steps_s) // 2],
             k2_device_ms_per_step=row["k2_device_ms_per_step"],
             k2_device_ms_per_step_median=k2[len(k2) // 2],
             tp1_decode_step_s_median=sorted(one["decode_step_s"][1:])[
                 len(one["decode_step_s"][1:]) // 2],
             tp1_k2_device_ms_per_step_median=sorted(one["k2_device_ms_per_step"][1:])[
                 len(one["k2_device_ms_per_step"][1:]) // 2],
             k2_first_step=row["k2_first_step"], pool_bytes=row["pool_bytes"],
             setup_s=row["setup_s"], serve_s=row["serve_s"], ranks_s=ranks_s,
             seconds=time.perf_counter() - t_start,
             max_memory_allocated=row["max_memory_allocated"])
        launches[f"{cfg.name} danube_tp8 rank{row['rank']}"] = dict(
            flash_attention=row["flash_attention"], paged_attention=n["paged_attention_fwd"],
            cvt=row["by_instance"].get("paged_cvt_fwd", {}),
            upcast=row["by_instance"].get("paged_upcast_fwd", {}))
    return launches


def cluster_phase():
    """The port's cluster layer on the host, where there is no JAX:
    ``ClusterRuntime(sanitize=True)`` over four ``make_sim_worker`` replicas
    of DS-Distill-8B on H100 constants, colocated under ``MemoryAware``
    routing and disaggregated 2 prefill + 2 decode, serving one 40-request
    Poisson trace of the reasoning workload. Each fleet's summary carries
    the regime fractions of its event stream; every request must finish,
    its span telescoping to its latency, and the disaggregated fleet must
    migrate. The times are the perf model's virtual clock, not the card's."""
    from repro_torch import cluster as cl
    from repro_torch.configs.paper_models import DS_DISTILL_8B
    from repro_torch.core import perf_model as pm
    from repro_torch.data.reasoning import REASONING
    from repro_torch.obs import bottleneck_report, fold_spans, regime_fractions

    c = CLUSTER_TRACE
    trace = cl.make_trace(cl.PoissonProcess(rate=c["rate"]), REASONING, c["n"],
                          seed=c["seed"], osl_cap=c["osl_cap"])
    for mode, roles in (("colocated", ["colocated"] * 4),
                        ("disaggregated", ["prefill"] * 2 + ["decode"] * 2)):
        workers = [cl.make_sim_worker(DS_DISTILL_8B, pm.ParallelismPlan(), pm.H100,
                                      role=role, name=f"{role}{i}", **CLUSTER_WORKER)
                   for i, role in enumerate(roles)]
        rt = cl.ClusterRuntime(workers, cl.ClusterConfig(policy=cl.MemoryAware()),
                               sanitize=True)
        rt.events.enable_recording()
        rt.submit_trace(trace)
        t0 = time.perf_counter()
        m = rt.run()
        wall = time.perf_counter() - t0
        rep = bottleneck_report(rt.events.events)
        summary = m.summary(regimes=regime_fractions(rep))
        broken = [sp.rid for sp in fold_spans(rt.events.events).spans
                  if sp.total_s != sp.t_finished - sp.arrival]
        emit("cluster", mode=mode, model=DS_DISTILL_8B.name, hw=pm.H100.name,
             workers=roles, policy="memory_aware", dispatcher=rt.cfg.dispatcher,
             sanitize=True, trace=dict(process="poisson", workload="reasoning", **c),
             clock="virtual: every time on this line is the perf model's (H100 "
                   "constants), not the card's", host_wall_s=wall,
             summary=summary,
             phase_frac_of_e2e={k: v["frac_of_e2e"]
                                for k, v in rep["requests"]["phases"].items()})
        if summary["n_finished"] != c["n"] or rep["requests"]["n_finished"] != c["n"]:
            raise AssertionError(f"cluster/{mode}: {summary['n_finished']} of "
                                 f"{c['n']} requests finished")
        if broken:
            raise AssertionError(f"cluster/{mode}: spans of rids {broken} do not "
                                 "sum to t_finished - arrival")
        if (summary["n_migrations"] > 0) != (mode == "disaggregated"):
            raise AssertionError(f"cluster/{mode}: {summary['n_migrations']} "
                                 "migrations")


def examples_phase(flash_ops, paged_ops):
    """The port's examples and its lint on the card machine, where there is
    no JAX. ``python -m repro_torch.lint src/repro_torch`` and
    ``plan_deployment --scenario ds8b-4xh200-colocated`` (host only) run as
    subprocesses beside the card's work and must exit 0. The quickstart's
    three steps run in process on full-width llama3.2-3b in bf16 (its
    engine and planner lines those of the CPU's reduced run, its logits
    finite), then serve_reasoning's real half with each admission on the
    same model, each taking the CPU's steps, tokens and no preemption; each
    launches K1 and K2. The reduced model (head dim 16) on the card must
    raise the kernel's head-dim error. Last, ``python -m
    repro_torch.examples.quickstart`` alone must print the same lines.
    Returns each example's launches; no subprocess outlives it."""
    from repro_torch.examples import quickstart, serve_reasoning

    host = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.{module}", *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, module, args in (
            ("lint", "lint", ["src/repro_torch"]),
            ("plan_deployment", "examples.plan_deployment",
             ["--scenario", "ds8b-4xh200-colocated"]))}
    try:
        launches = {}
        t0 = time.perf_counter()
        model = quickstart.build_model(False, "cuda")
        _zero_launches(flash_ops, paged_ops)
        lines = quickstart.run(model)
        torch.cuda.synchronize()
        launches["examples/quickstart"] = _launches(flash_ops, paged_ops)
        emit("examples", example="quickstart", model=model.cfg.name, dtype="bfloat16",
             lines=lines, wall_s_with_weight_init=time.perf_counter() - t0,
             launches=launches["examples/quickstart"])
        vocab = model.cfg.vocab
        if lines[0] != f"[1] forward: logits (1, 16, {vocab}), finite=True" \
                or lines[1:] != [QUICKSTART_ENGINE, QUICKSTART_PLANNER]:
            raise AssertionError(f"examples/quickstart printed {lines}")
        if min(launches["examples/quickstart"].values()) == 0:
            raise AssertionError(f"quickstart: a kernel was not launched: {launches}")

        weight_bytes = decode_weight_bytes(model)
        served = {}
        for admission in ("naive", "kv_aware"):
            _zero_launches(flash_ops, paged_ops)
            eng = serve_reasoning.real_engine(admission, model)
            torch.cuda.synchronize()
            n = _launches(flash_ops, paged_ops)
            served[admission] = n
            s = eng.metrics.summary()
            got = dict(n_finished=s["n_finished"], gen_tokens=s["gen_tokens"],
                       preemptions=s["preemptions"],
                       recomputed_tokens=s["recomputed_tokens"],
                       steps=len(eng.metrics.timeline))
            emit("examples", example="serve_reasoning", admission=admission,
                 model=model.cfg.name, dtype="bfloat16", **got,
                 ttft_p50_s=s["ttft_s"]["p50"], tpot_mean_s=s["tpot_s"]["mean"],
                 gen_tok_s=s["gen_throughput_tok_s"], engine_s=s["duration_s"],
                 decode_weight_bytes=weight_bytes,
                 tpot_weight_bound_ms=weight_bytes / PEAK_BYTES * 1e3, launches=n)
            if got != REASONING_REAL:
                raise AssertionError(f"serve_reasoning/{admission}: {got}, the CPU "
                                     f"run's {REASONING_REAL}")
            if min(n.values()) == 0:
                raise AssertionError(f"serve_reasoning/{admission}: a kernel was "
                                     f"not launched: {n}")
            del eng
        launches["examples/serve_reasoning"] = {
            k: sum(n[k] for n in served.values()) for k in served["naive"]}
        del model
        free_card()
        try:
            quickstart.run(quickstart.build_model(True, "cuda"))
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("the reduced model (head dim 16) ran on the card")
        if "head dim 16" not in refused:
            raise AssertionError(f"the reduced model on the card: {refused}")
        free_card()

        t0 = time.perf_counter()
        res = port_cli("examples.quickstart")
        emit("examples", example="quickstart_cli", returncode=res.returncode,
             wall_s=time.perf_counter() - t0, smoke_on_card=refused,
             stdout=res.stdout.splitlines(), stderr=res.stderr[-2000:])
        if res.returncode != 0 or res.stdout.splitlines() != lines:
            raise AssertionError("python -m repro_torch.examples.quickstart: exit "
                                 f"{res.returncode}, {res.stdout!r}")
        for name, proc in host.items():
            out, err = proc.communicate(timeout=300)
            emit("examples", example=name, returncode=proc.returncode,
                 stdout=out.splitlines()[-6:], stderr=err[-2000:])
            if proc.returncode != 0:
                raise AssertionError(f"{name}: exit {proc.returncode}")
    finally:
        for proc in host.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return launches


def train_equality(flash_ops, paged_ops):
    """``TRAIN_EQ``'s ``make_train_step`` steps of llama3.2-3b at full width and
    ``TRAIN_EQ["layers"]`` layers in fp32 (TF32 off) on the card and on a
    CPU copy filled from the card's initial weights, on the same batches.
    Raises beyond the tolerances above; returns both sides' losses and
    grad norms, the parameters' largest difference after the last step
    and the count beyond ``TRAIN_PARAM_ATOL``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    e = TRAIN_EQ
    full = get_config("llama3.2-3b")
    cfg = dataclasses.replace(full, n_layers=e["layers"])
    card = Transformer(cfg, device="cuda", dtype=torch.float32, seed=3,
                       layout="train")
    host = Transformer(cfg, device="cpu", dtype=torch.float32, seed=None,
                       layout="train")
    on_card = dict(card.named_parameters())
    with torch.no_grad():
        for name, p in host.named_parameters():
            p.copy_(on_card[name])
    ocfg = AdamWConfig(lr=e["lr"], warmup_steps=e["warmup"])
    batches = [synthetic_batch(i, e["batch"], e["seq"], cfg.vocab, device="cpu")
               for i in range(e["steps"])]
    sides = {}
    _zero_launches(flash_ops, paged_ops)
    for dev, model in (("cuda", card), ("cpu", host)):
        state = init_opt_state(model.param_tree(), ocfg)
        step = make_train_step(model, ocfg)
        t0 = time.perf_counter()
        runs = [step(state, {k: v.to(dev) for k, v in b.items()})
                for b in batches]
        sides[dev] = dict(loss=[float(m["loss"]) for m in runs],
                          grad_norm=[float(m["grad_norm"]) for m in runs],
                          seconds=time.perf_counter() - t0)
    launches = _launches(flash_ops, paged_ops)
    max_diff, n_off, n = 0.0, 0, 0
    on_card = dict(card.named_parameters())
    for name, p in host.named_parameters():
        d = (on_card[name].detach().cpu() - p.detach()).abs()
        max_diff = max(max_diff, float(d.max()))
        n_off += int((d > TRAIN_PARAM_ATOL).sum())
        n += d.numel()
    result = dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                  dtype="float32", tf32=torch.backends.cuda.matmul.allow_tf32,
                  reduced={"n_layers": [full.n_layers, e["layers"]]},
                  batch=e["batch"], seq=e["seq"], lr=e["lr"],
                  warmup_steps=e["warmup"], params=n, card=sides["cuda"],
                  cpu=sides["cpu"], max_param_diff=max_diff,
                  params_beyond_atol=n_off, param_atol=TRAIN_PARAM_ATOL,
                  loss_rtol=TRAIN_LOSS_RTOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
                  launches=launches)
    emit("train_equality", **result)
    for key, rtol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm", TRAIN_GNORM_RTOL)):
        for i, (a, b) in enumerate(zip(sides["cuda"][key], sides["cpu"][key])):
            if not (np.isfinite(a) and abs(a - b) <= rtol * abs(b)):
                raise AssertionError(f"train_equality: step {i + 1} {key} "
                                     f"card {a} cpu {b} (rtol {rtol})")
    if n_off > TRAIN_FLIP_SHARE * n or max_diff > 4 * e["lr"]:
        raise AssertionError(f"train_equality: {n_off} of {n} parameters "
                             f"beyond {TRAIN_PARAM_ATOL}, largest {max_diff}")
    if max(launches.values()):
        raise AssertionError(f"train_equality launched a kernel: {launches}")
    return result


def train_main_path(flash_ops, paged_ops):
    """``launch.train.train`` on full-depth llama3.2-3b, fp32 weights and
    AdamW state, from seeded weights. Raises on a non-finite loss or grad
    norm, on a parameter leaf whose first moment stayed zero, or a final
    norm (initialised to ones) that did not move."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train
    from repro_torch.train.tree import flatten_with_path

    cfg = get_config("llama3.2-3b")
    t = TRAIN_MAIN
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(flash_ops, paged_ops)
    t0 = time.perf_counter()
    out = train(cfg, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                device="cuda")
    wall = time.perf_counter() - t0
    launches = _launches(flash_ops, paged_ops)
    peak = torch.cuda.max_memory_allocated()
    model, hist = out["model"], out["history"]
    n = sum(p.numel() for p in model.parameters())
    tokens = t["batch"] * t["seq"]
    # causal attention's two products over the pairs a position sees, in
    # the forward and twice in the backward
    pairs = t["batch"] * t["seq"] * (t["seq"] + 1) // 2
    attn_flops = 3 * 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * pairs
    flops = 6 * n * tokens + attn_flops
    median_s = float(np.median([h["seconds"] for h in hist[1:]]))
    bound_s = flops / PEAK_FLOPS[torch.float32]
    state_bytes = 4 * n * 4         # fp32 params, grads, m and v
    emit("train_main_path", model=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype="float32", state_dtype="float32",
         tf32=torch.backends.cuda.matmul.allow_tf32, reduced={},
         params=n, batch=t["batch"], seq=t["seq"], steps=len(hist),
         loss=[h["loss"] for h in hist], grad_norm=[h["grad_norm"] for h in hist],
         lr=[h["lr"] for h in hist], step_s=[h["seconds"] for h in hist],
         median_step_s_2_to_6=median_s, tok_s=tokens / median_s,
         step_flops=flops, step_flops_6nt=6 * n * tokens,
         step_flops_attention=attn_flops, bound_s_fp32=bound_s,
         bound_share=bound_s / median_s, max_memory_allocated=peak,
         params_grads_moments_bytes=state_bytes,
         wall_s_with_weight_init=wall, launches=launches)
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError("train_main_path: non-finite loss or grad norm")
    still = [path for path, m in flatten_with_path(out["opt_state"]["m"])
             if not bool(m.any())]
    if still or bool((model.final_norm == 1).all()):
        raise AssertionError(f"train_main_path: parameters did not move: "
                             f"{still or ['final_norm']}")
    if max(launches.values()):
        raise AssertionError(f"train_main_path launched a kernel: {launches}")


def train_small(flash_ops, paged_ops):
    """The example's model for ``TRAIN_SMALL["steps"]`` steps, then again
    from its checkpoint of step ``resume_from`` in a fresh model and
    optimizer, under ``torch.use_deterministic_algorithms``. The loss must
    fall, and each resumed step's loss equal the uninterrupted run's within
    ``TRAIN_RESUME_RTOL``."""
    import shutil
    import tempfile

    from repro_torch.examples.train_small import CFG_100M, run

    t = TRAIN_SMALL
    ckpt_dir = tempfile.mkdtemp(prefix="train_small_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    _zero_launches(flash_ops, paged_ops)
    try:
        t0 = time.perf_counter()
        whole = run(steps=t["steps"], ckpt_dir=ckpt_dir, device="cuda")
        t1 = time.perf_counter()
        resumed = run(steps=t["steps"], ckpt_dir=ckpt_dir, device="cuda",
                      resume_from=t["resume_from"])
        t2 = time.perf_counter()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = _launches(flash_ops, paged_ops)
    diffs = [abs(resumed[s] - whole[s]) / abs(whole[s]) for s in resumed]
    emit("train_small", model=CFG_100M.name, param_count=CFG_100M.param_count(),
         steps=t["steps"], resume_from=t["resume_from"],
         loss_first=whole[1], loss_last=whole[t["steps"]],
         loss_by_20=[whole[s] for s in range(20, t["steps"] + 1, 20)],
         resumed_steps=sorted(resumed), resumed_loss=[resumed[s] for s in sorted(resumed)],
         uninterrupted_loss=[whole[s] for s in sorted(resumed)],
         resume_max_rel_diff=max(diffs),
         resume_bitwise_equal=all(resumed[s] == whole[s] for s in resumed),
         resume_rtol=TRAIN_RESUME_RTOL, seconds=t1 - t0,
         resumed_seconds=t2 - t1, launches=launches)
    if not whole[t["steps"]] < whole[1]:
        raise AssertionError(f"train_small: loss {whole[1]} -> "
                             f"{whole[t['steps']]} did not fall")
    if sorted(resumed) != list(range(t["resume_from"] + 1, t["steps"] + 1)) \
            or max(diffs) > TRAIN_RESUME_RTOL:
        raise AssertionError(f"train_small: resumed losses {resumed} differ "
                             f"from the uninterrupted run's")
    if max(launches.values()):
        raise AssertionError(f"train_small launched a kernel: {launches}")


def sharded_jobs(phase):
    """(config, its cuts, requests, dtype, engine overrides) of each model
    a sharded phase serves. ``equality``: llama3.2-3b and DeepSeek-R1 at
    full width and 2 layers in fp32 (R1 with 16 experts, 1 dense layer, its
    capacity factor raised to E/top_k, so that no assignment drops at tp=1
    nor in a slice's capacity under split dispatch), preempting; zamba2-2.7b
    at full width and 12 layers and xlstm-350m at full width and 8 blocks
    in fp32 on the requests and pools of ``greedy_equality_hybrid`` and
    ``greedy_equality_xlstm``, each preempting once. ``main_path``:
    llama3.2-3b at ``SHARDED_LLAMA_LAYERS`` of its 28 layers and R1 at 5
    layers with all 256 experts in bf16, serving ``SERVE_REQUESTS`` on a
    pool that holds them; zamba2-2.7b at ``SHARDED_ZAMBA_LAYERS`` of its 54 layers
    (``SERVE_REQUESTS``) and xlstm-350m at ``SHARDED_XLSTM_BLOCKS`` of its
    24 blocks (``XLSTM_REQUESTS``); each traffic at a quarter of its output
    tokens (``fewer_steps``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_requests

    llama, r1 = get_config("llama3.2-3b"), get_config("deepseek-r1-671b")
    zamba, xlstm = get_config("zamba2-2.7b"), get_config("xlstm-350m")
    if phase == "equality":
        rng = np.random.default_rng(2)
        requests = [(rng.integers(0, llama.vocab, size=30).tolist(), MOE_EQ_NEW_TOKENS)
                    for _ in range(4)]
        no_drop = 16 / r1.moe.top_k
        r1_eq = dataclasses.replace(r1, n_layers=2, moe=dataclasses.replace(
            r1.moe, n_experts=16, first_dense_layers=1, capacity_factor=no_drop))
        recurrent = []
        for cfg, layers, seed, lengths, engine in (
                (zamba, 12, 4, (270, 300), HYBRID_EQ_ENGINE),
                (xlstm, 8, 5, (100, 120), XLSTM_EQ_ENGINE)):
            rng = np.random.default_rng(seed)
            recurrent.append((
                dataclasses.replace(cfg, n_layers=layers),
                {"n_layers": [cfg.n_layers, layers]},
                [(rng.integers(0, cfg.vocab, size=n).tolist(), 16)
                 for n in lengths], torch.float32, engine))
        return [(dataclasses.replace(llama, n_layers=2),
                 {"n_layers": [llama.n_layers, 2]}, requests, torch.float32,
                 SHARDED_EQ_ENGINE),
                (r1_eq, {"n_layers": [r1.n_layers, 2],
                         "first_dense_layers": [r1.moe.first_dense_layers, 1],
                         "n_experts": [r1.moe.n_experts, 16],
                         "capacity_factor": [r1.moe.capacity_factor, no_drop]},
                 requests, torch.float32, SHARDED_EQ_ENGINE), *recurrent]
    jobs = []
    for cfg, reduced, r in (
            (dataclasses.replace(llama, n_layers=SHARDED_LLAMA_LAYERS),
             {"n_layers": [llama.n_layers, SHARDED_LLAMA_LAYERS]}, SERVE_REQUESTS),
            (dataclasses.replace(r1, n_layers=SHARDED_R1_LAYERS),
             {"n_layers": [r1.n_layers, SHARDED_R1_LAYERS]}, SERVE_REQUESTS),
            (dataclasses.replace(zamba, n_layers=SHARDED_ZAMBA_LAYERS),
             {"n_layers": [zamba.n_layers, SHARDED_ZAMBA_LAYERS]}, SERVE_REQUESTS),
            (dataclasses.replace(xlstm, n_layers=SHARDED_XLSTM_BLOCKS),
             {"n_layers": [xlstm.n_layers, SHARDED_XLSTM_BLOCKS]}, XLSTM_REQUESTS)):
        r, reduced = fewer_steps(r, reduced, div=4)
        jobs.append((cfg, reduced, make_requests(cfg.vocab, r["n"], r["isl"], r["osl"],
                                                 r["seed"]), torch.bfloat16, {}))
    return jobs


def sharded_rank(rank, phase, out_dir):
    """One rank of a sharded phase (``run_ranks`` spawns two on the card):
    each model of ``sharded_jobs(phase)`` through ``serve_sharded`` on the
    mesh, the kernels' launch counts and the collectives' counters set to
    0 just before and read just after. In ``equality`` the leading rank
    then serves the same requests on a tp=1 model seeded alike on the card.
    Writes its rows to ``out_dir``."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.serve import pages_to_hold, serve_sharded
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import ParallelContext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, model = SHARDED_MESH
    ctx = ParallelContext(mesh=make_mesh_for(data * model, model,
                                             device_type="cuda"))
    rows = []
    for cfg, reduced, requests, dtype, engine in sharded_jobs(phase):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        ctx.comm.reset()
        _zero_launches(flash_ops, paged_ops)
        t0 = time.perf_counter()
        eng, reqs = serve_sharded(cfg, requests, ctx, device="cuda",
                                  dtype=dtype, seed=1, **engine)
        torch.cuda.synchronize()
        row = dict(model=cfg.name, rank=rank, layers=cfg.n_layers,
                   reduced=reduced, dtype=str(dtype).split(".")[-1],
                   wall_s_with_weight_init=time.perf_counter() - t0,
                   launches=_launches(flash_ops, paged_ops),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   comm={k: dict(v) for k, v in ctx.comm.stats.items()},
                   backend=torch.distributed.get_backend(
                       ctx.comm.group(ctx.model_axis)))
        runner_states = eng.runner.states if eng is not None else ()
        row["state_slot_bytes"] = sum(
            b[:, 0].numel() * b.element_size() for b in runner_states) or None
        if eng is not None:
            s = eng.metrics.summary()
            row.update(outputs=[q.output for q in reqs],
                       finished=[len(q.output) == n and q.t_finished is not None
                                 for q, (_, n) in zip(reqs, requests)],
                       steps=len(eng.metrics.timeline),
                       preemptions=s["preemptions"], gen_tokens=s["gen_tokens"],
                       gen_tok_s=s["gen_throughput_tok_s"],
                       ttft_p50_s=s["ttft_s"]["p50"],
                       tpot_mean_s=s["tpot_s"]["mean"], engine_s=s["duration_s"])
        del eng, reqs
        if phase == "equality" and rank == 0:
            free_card()
            one = InferenceEngine(
                cfg, EngineConfig(**{"n_pages": pages_to_hold(requests),
                                     "max_num_seqs": 16, **engine}),
                TorchRunner(Transformer(cfg, device="cuda", dtype=dtype, seed=1),
                            device="cuda"), virtual_clock=False)
            ones = [one.submit(p, n) for p, n in requests]
            one.run()
            row.update(tp1_outputs=[q.output for q in ones],
                       tp1_preemptions=sum(q.n_preemptions for q in ones))
            del one, ones
        rows.append(row)
    with open(Path(out_dir) / f"{phase}.rank{rank}.json", "w") as f:
        json.dump(rows, f)


def sharded(phase):
    """``sharded_equality`` or ``sharded_main_path``: two ranks spawned on
    the card, a (1, 2) mesh over gloo, each serving its shard (K1 and K2 on
    its local heads; the MoE split and replicated dispatch across the
    ranks). Prints one line per model and rank; fails if a rank fails, a
    request does not finish, equality does not hold, or the ranks of
    llama or zamba2 did not launch both kernels (zamba2's in multiples of
    its shared-block invocations in the main path), or those of R1 (MLA)
    or xlstm launched one. The times measure
    gloo through host memory on one card, not NVLink or NCCL. Returns the
    kernels' launches by model and rank."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    out = tempfile.mkdtemp(prefix=f"sharded_{phase}_")
    try:
        run_ranks(sharded_rank, SHARDED_MESH[0] * SHARDED_MESH[1], (phase, out),
                  backend="gloo", device_type="cuda")
        ranks = [json.loads((Path(out) / f"{phase}.rank{r}.json").read_text())
                 for r in range(SHARDED_MESH[0] * SHARDED_MESH[1])]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    launches = {}
    for rows in zip(*ranks):
        lead = rows[0]
        label = f"{lead['model']} tp{SHARDED_MESH[1]}"
        if not all(lead["finished"]):
            raise AssertionError(f"sharded_{phase}/{label}: unfinished requests")
        if phase == "equality":
            if lead["outputs"] != lead["tp1_outputs"]:
                raise AssertionError(
                    f"sharded_equality/{label}: tokens {lead['outputs']} differ "
                    f"from tp=1 on the card {lead['tp1_outputs']}")
            if lead["preemptions"] == 0:
                raise AssertionError(f"sharded_equality/{label}: the small pool "
                                     "forced no preemption")
        for row in rows:
            # MLA (R1) and xlstm attend through neither kernel; zamba2's
            # shared-block invocations (one a 6 layers) launch each in
            # multiples of their count
            attends = row["model"] not in ("deepseek-r1-671b", "xlstm-350m")
            n = row["launches"].values()
            groups = row["layers"] // 6 if row["model"] == "zamba2-2.7b" \
                and phase == "main_path" else 1
            if attends and (min(n) == 0 or any(v % groups for v in n)) or \
                    not attends and max(n) != 0:
                raise AssertionError(f"sharded_{phase}/{label} rank "
                                     f"{row['rank']}: launches {row['launches']}")
            steps = lead["steps"]
            per_step = {op: dict(calls=v["calls"] / steps,
                                 host_ms=v["seconds"] / steps * 1e3,
                                 bytes=v["bytes"] / steps,
                                 staged=v["staged"] / steps)
                        for op, v in row["comm"].items()}
            extra = {k: row[k] for k in ("gen_tok_s", "ttft_p50_s",
                                         "tpot_mean_s", "engine_s",
                                         "preemptions", "gen_tokens",
                                         "state_slot_bytes")
                     if k in row}
            emit(f"sharded_{phase}", model=row["model"], rank=row["rank"],
                 mesh={"data": SHARDED_MESH[0], "model": SHARDED_MESH[1]},
                 backend=row["backend"],
                 transport="gloo on one card (it copies CUDA tensors through "
                           "host memory itself)",
                 layers=row["layers"], reduced=row["reduced"],
                 dtype=row["dtype"], steps=steps, **extra,
                 tokens_equal_tp1=(lead["outputs"] == lead.get("tp1_outputs"))
                 if phase == "equality" else None,
                 max_memory_allocated=row["max_memory_allocated"],
                 wall_s_with_weight_init=row["wall_s_with_weight_init"],
                 launches=row["launches"], collectives_per_step=per_step,
                 staged_through_host=sorted(op for op, v in row["comm"].items()
                                            if v["staged"]))
            if phase == "main_path":
                launches[f"{label} rank{row['rank']}"] = row["launches"]
    return launches


def _rank_rows(ctx, batch):
    """This rank's rows of a batch (its "data" shard)."""
    d, n = ctx.coords()["data"], ctx.axis_size("data")
    return {k: v[d * v.shape[0] // n:(d + 1) * v.shape[0] // n]
            for k, v in batch.items()}


def sharded_train_rank(rank, out_dir):
    """One of the four ranks of ``sharded_train`` on a (2, 2) mesh: the
    equality steps (and on rank 0 the same steps at tp=1 on the card, held
    to the checkpoint the mesh wrote), the elastic restore onto (1, 4) and
    the main path; the kernels' launch counts set to 0 before each and read
    after. Writes its row to ``out_dir``."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import ParallelContext, entry_slices
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import flatten_with_path, leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, model = SHARDED_TRAIN_MESH
    ctx = ParallelContext(mesh=make_mesh_for(data * model, model,
                                             device_type="cuda"))
    full = get_config("llama3.2-3b")
    row = dict(rank=rank, coords=ctx.coords())

    # equality: the mesh's steps, then its checkpoint
    e = SHARDED_TRAIN_EQ
    cfg = dataclasses.replace(full, n_layers=e["layers"])
    ocfg = AdamWConfig(lr=e["lr"], warmup_steps=e["warmup"])
    batches = [synthetic_batch(i, e["batch"], e["seq"], cfg.vocab, device="cpu")
               for i in range(e["steps"])]
    _zero_launches(flash_ops, paged_ops)
    m = Transformer(cfg, device="cuda", dtype=torch.float32, seed=3,
                    layout="train", ctx=ctx)
    state = init_opt_state(m.param_tree(), ocfg)
    step = make_train_step(m, ocfg)
    t0 = time.perf_counter()
    runs = [step(state, {k: v.cuda() for k, v in _rank_rows(ctx, b).items()})
            for b in batches]
    row["eq_mesh"] = dict(loss=[float(r["loss"]) for r in runs],
                          grad_norm=[float(r["grad_norm"]) for r in runs],
                          seconds=time.perf_counter() - t0)
    row["eq_moments_are_shards"] = all(
        tuple(a.shape) == tuple(b.shape)
        for key in ("m", "v")
        for a, b in zip(leaves(state[key]), leaves(m.param_tree())))
    ckdir = Path(out_dir) / "ckpt"
    t0 = time.perf_counter()
    ck.save_training(m, state, str(ckdir), e["steps"])
    row["save_s"] = time.perf_counter() - t0
    row["eq_launches"] = _launches(flash_ops, paged_ops)
    del m, state, step, runs
    free_card()
    if rank == 0:
        one = Transformer(cfg, device="cuda", dtype=torch.float32, seed=3,
                          layout="train")
        st1 = init_opt_state(one.param_tree(), ocfg)
        step1 = make_train_step(one, ocfg)
        runs = [step1(st1, {k: v.cuda() for k, v in b.items()}) for b in batches]
        row["eq_tp1"] = dict(loss=[float(r["loss"]) for r in runs],
                             grad_norm=[float(r["grad_norm"]) for r in runs])
        src = ckdir / f"step-{e['steps']:09d}"
        keys = json.loads((src / "manifest.json").read_text())["keys"]
        index = {k: i for i, k in enumerate(keys)}
        max_diff, n_off, n = 0.0, 0, 0
        with np.load(src / "arrays.npz") as z:
            for path, p in flatten_with_path(one.param_tree()):
                arr = z[f"a{index['0/' + '/'.join(path)]}"]
                d = np.abs(p.detach().cpu().numpy() - arr)
                max_diff = max(max_diff, float(d.max()))
                n_off += int((d > TRAIN_PARAM_ATOL).sum())
                n += d.size
        row.update(eq_max_param_diff=max_diff, eq_params_beyond_atol=n_off,
                   eq_params=n)
        del one, st1, step1, runs
        free_card()
    dist.barrier()

    # elastic restore of that checkpoint onto (1, 4)
    ctx4 = ParallelContext(mesh=make_mesh_for(4, 4, device_type="cuda"))
    m4 = Transformer(cfg, device="cuda", dtype=torch.float32, seed=None,
                     layout="train", ctx=ctx4)
    st4 = init_opt_state(m4.param_tree(), ocfg)
    t0 = time.perf_counter()
    st4, at = ck.restore_training(m4, st4, str(ckdir))
    torch.cuda.synchronize()
    row["restore_s"] = time.perf_counter() - t0
    tree = (m4.param_tree(), st4)
    places = leaves(ck.training_placements(m4))
    bad, checked = [], 0
    with np.load(ckdir / f"step-{e['steps']:09d}" / "arrays.npz") as z:
        for i, ((path, leaf), place) in enumerate(zip(flatten_with_path(tree), places)):
            arr = z[f"a{i}"]
            want = arr[entry_slices(arr.shape, place.entries, ctx4, ctx4.coords())]
            if not np.array_equal(leaf.detach().cpu().numpy(), want):
                bad.append("/".join(map(str, path)))
            checked += 1
    row.update(restore_step=at, restore_leaves=checked, restore_mismatched=bad,
               restore_coords=ctx4.coords())
    del m4, st4, tree
    free_card()
    dist.barrier()

    # main path
    t = SHARDED_TRAIN_MAIN
    cfg = dataclasses.replace(full, n_layers=t["layers"])
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(flash_ops, paged_ops)
    model_ = Transformer(cfg, device="cuda", dtype=torch.float32, seed=0,
                         layout="train", ctx=ctx)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20)
    state = init_opt_state(model_.param_tree(), ocfg)
    step = make_train_step(model_, ocfg)
    ctx.comm.reset()
    hist = []
    for i in range(t["steps"]):
        batch = _rank_rows(ctx, synthetic_batch(i, t["batch"], t["seq"],
                                                cfg.vocab, device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(state, batch)
        torch.cuda.synchronize()
        hist.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                         seconds=time.perf_counter() - t0))
    row["main"] = dict(
        layers=cfg.n_layers, params_local=sum(p.numel() for p in model_.parameters()),
        hist=hist, max_memory_allocated=torch.cuda.max_memory_allocated(),
        comm={k: dict(v) for k, v in ctx.comm.stats.items()},
        launches=_launches(flash_ops, paged_ops),
        backend=torch.distributed.get_backend(ctx.comm.group(ctx.model_axis)))
    with open(Path(out_dir) / f"train.rank{rank}.json", "w") as f:
        json.dump(row, f)


def sharded_train(flash_ops, paged_ops):
    """Four ranks spawned on the card, a (2, 2) mesh over gloo. Prints
    ``sharded_train_equality`` (the mesh's two AdamW steps against tp=1 on
    the card: losses, grad norms and every parameter after step 2 under
    ``train_equality``'s tolerances), ``sharded_train_restore`` (the
    checkpoint saved from (2,2) restored onto (1,4), every rank's shards
    against the written arrays) and one ``sharded_train_main_path`` line a
    rank (median step time of steps 2-3, tokens/s, peak memory, collectives
    per step). Fails if any check fails or a rank launched a kernel. Gloo
    moves every collective through host memory on one card."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    world = SHARDED_TRAIN_MESH[0] * SHARDED_TRAIN_MESH[1]
    out = tempfile.mkdtemp(prefix="sharded_train_")
    try:
        run_ranks(sharded_train_rank, world, (out,), backend="gloo",
                  device_type="cuda")
        rows = [json.loads((Path(out) / f"train.rank{r}.json").read_text())
                for r in range(world)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    mesh = {"data": SHARDED_TRAIN_MESH[0], "model": SHARDED_TRAIN_MESH[1]}
    transport = "gloo on one card (it copies CUDA tensors through host memory)"
    e, full_layers = SHARDED_TRAIN_EQ, 28
    lead = rows[0]
    launches = {f"rank{r['rank']}": {"equality": r["eq_launches"],
                                     "main_path": r["main"]["launches"]}
                for r in rows}
    emit("sharded_train_equality", model="llama3.2-3b", mesh=mesh,
         transport=transport, layers=e["layers"],
         reduced={"n_layers": [full_layers, e["layers"]]}, dtype="float32",
         tf32=False, batch=e["batch"], seq=e["seq"], lr=e["lr"],
         warmup_steps=e["warmup"], mesh_side=[r["eq_mesh"] for r in rows],
         tp1=lead["eq_tp1"], max_param_diff=lead["eq_max_param_diff"],
         params_beyond_atol=lead["eq_params_beyond_atol"],
         params=lead["eq_params"], param_atol=TRAIN_PARAM_ATOL,
         loss_rtol=TRAIN_LOSS_RTOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
         moments_are_shards=[r["eq_moments_are_shards"] for r in rows],
         launches={k: v["equality"] for k, v in launches.items()})
    for key, rtol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm", TRAIN_GNORM_RTOL)):
        for r in rows:
            for i, (a, b) in enumerate(zip(r["eq_mesh"][key], lead["eq_tp1"][key])):
                if not (np.isfinite(a) and abs(a - b) <= rtol * abs(b)):
                    raise AssertionError(
                        f"sharded_train_equality: rank {r['rank']} step {i + 1} "
                        f"{key} mesh {a} tp=1 {b} (rtol {rtol})")
    if lead["eq_params_beyond_atol"] > TRAIN_FLIP_SHARE * lead["eq_params"] \
            or lead["eq_max_param_diff"] > 4 * e["lr"]:
        raise AssertionError(
            f"sharded_train_equality: {lead['eq_params_beyond_atol']} of "
            f"{lead['eq_params']} parameters beyond {TRAIN_PARAM_ATOL}, largest "
            f"{lead['eq_max_param_diff']}")
    if not all(r["eq_moments_are_shards"] for r in rows):
        raise AssertionError("sharded_train_equality: AdamW moments are not "
                             "their parameters' shards")
    emit("sharded_train_restore", model="llama3.2-3b", saved_from=mesh,
         restored_onto={"data": 1, "model": 4}, layers=e["layers"],
         step=lead["restore_step"], leaves=lead["restore_leaves"],
         save_s=[r["save_s"] for r in rows],
         restore_s=[r["restore_s"] for r in rows],
         mismatched={f"rank{r['rank']}": r["restore_mismatched"] for r in rows})
    if any(r["restore_mismatched"] for r in rows) or lead["restore_step"] != e["steps"]:
        raise AssertionError("sharded_train_restore: restored shards differ "
                             "from the written arrays")
    t = SHARDED_TRAIN_MAIN
    for r in rows:
        mm = r["main"]
        hist = mm["hist"]
        median_s = float(np.median([h["seconds"] for h in hist[1:]]))
        steps = len(hist)
        emit("sharded_train_main_path", model="llama3.2-3b", rank=r["rank"],
             coords=r["coords"], mesh=mesh, backend=mm["backend"],
             transport=transport, layers=mm["layers"],
             reduced={"n_layers": [full_layers, mm["layers"]]}, dtype="float32",
             state_dtype="float32", batch=t["batch"], seq=t["seq"],
             params_local=mm["params_local"], steps=steps,
             loss=[h["loss"] for h in hist],
             grad_norm=[h["grad_norm"] for h in hist],
             step_s=[h["seconds"] for h in hist], median_step_s_from_2=median_s,
             tok_s=t["batch"] * t["seq"] / median_s,
             max_memory_allocated=mm["max_memory_allocated"],
             collectives_per_step={op: dict(calls=v["calls"] / steps,
                                            host_ms=v["seconds"] / steps * 1e3,
                                            bytes=v["bytes"] / steps,
                                            staged=v["staged"] / steps)
                                   for op, v in mm["comm"].items()},
             staged_through_host=sorted(op for op, v in mm["comm"].items()
                                        if v["staged"]),
             launches=mm["launches"])
        if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
            raise AssertionError("sharded_train_main_path: non-finite loss or "
                                 "grad norm")
    for rank, n in launches.items():
        if max(n["equality"].values()) or max(n["main_path"].values()):
            raise AssertionError(f"sharded_train launched a kernel on {rank}: {n}")


# ------------------------------------------------------------ the dry-run
# dryrun: the (arch x shape) grid on the 16x16 mesh counted on meta, and two
# cells that fit one card run at mesh 1x1 beside their count: llama3.2-3b's
# prefill_32k at B 1 (K1 at 32,768 tokens) and decode_32k at B 8 x 32,768
# tokens of seeded cache (K2); each the median of DRYRUN_ITERS steps
DRYRUN_MEASURED = (("llama3.2-3b", "prefill_32k", 1, "flash_attention"),
                   ("llama3.2-3b", "decode_32k", 8, "paged_attention"))
DRYRUN_ITERS = 5
# long_decode: zamba2-2.7b's long_500k whole on the card (B 1, 524,288
# tokens of seeded cache in its 9 shared-block pools, about 48 GB); then the
# sequence-split decode on two gloo ranks of a (data 2, model 1) mesh on the
# card (weights whole on each rank, the cache's positions cut in two):
# zamba2-2.7b and h2o-danube-3-4b at ``SPLIT_LAYERS`` in bf16, an 8,000-token
# prompt in a 8,192-position cache (danube's window of 4096 spans both
# shares), SPLIT_STEPS greedy tokens against the unsplit model on the card
SPLIT_MESH = (2, 1)
SPLIT_OVERRIDE = {"batch": None, "cache_batch": None, "cache_seq": "data"}
SPLIT_ARCHS = ("zamba2-2.7b", "h2o-danube-3-4b")
SPLIT_LEN, SPLIT_PROMPT, SPLIT_STEPS = 8192, 8000, 4
# K2's partials and merge at the split run's shapes: each half (4,096
# positions) of one 8,192-position sequence, the newest token at 7,999
SPLIT_PAGED = [dict(model="zamba2-2.7b", KV=32, G=1, D=80, window=0),
               dict(model="h2o-danube-3-4b", KV=8, G=4, D=120, window=DANUBE_WINDOW)]


# K1's plain version at the prefill_32k cell's shape, by blocks of
# query rows (its S x S scores would take 100 GB): the first, a middle and
# the last HELD_ROWS rows
HELD_ROWS = 1024


@contextlib.contextmanager
def first_call(name):
    """The arguments of the model's first call to the kernel wrapper
    ``name`` (``flash_attention`` or ``paged_attention``, as
    ``models.transformer`` calls it) while inside, cloned: one layer's
    inputs at the shape the cell gives the kernel. The call itself goes on
    to the wrapper, which counts it."""
    from repro_torch.models import transformer

    wrapper, got = getattr(transformer, name), {}

    def spy(*args, **kwargs):
        if not got and args[0].is_cuda:      # not the count's, on meta
            got["args"] = [a.clone() if torch.is_tensor(a) else a for a in args]
            got["kwargs"] = dict(kwargs)
        return wrapper(*args, **kwargs)

    setattr(transformer, name, spy)
    try:
        yield got
    finally:
        setattr(transformer, name, wrapper)


def flash_rows_plain(q, k, v, r0, r1, window=0):
    """K1's plain version (``flash_attention_plain``, lens whole) on the
    query rows r0..r1-1 of a causal prefill: those rows against the keys
    0..r1-1."""
    D, g = q.shape[-1], q.shape[2] // k.shape[2]
    qf = q[:, r0:r1].float() * D ** -0.5
    kf = k[:, :r1].repeat_interleave(g, dim=2).float()
    vf = v[:, :r1].repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos = torch.arange(r0, r1, device=q.device)[:, None]
    k_pos = torch.arange(r1, device=q.device)[None, :]
    valid = k_pos <= q_pos
    if window > 0:
        valid = valid & (k_pos > q_pos - window)
    s = torch.where(valid, s, -1e30)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    w = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)


def hold_at_cell(label, kernel, got, flash_ops, paged_ops):
    """The wrapper ``kernel`` on the inputs ``first_call`` took from a
    cell, against its plain version (after the cell's counts are read, so
    these launches are not the main path's): K2 whole (one layer's pool,
    gathered); K1 on ``HELD_ROWS``-row blocks of queries at the start,
    middle and end. Returns (max abs err, relative rms err, the shapes)."""
    if not got:
        raise AssertionError(f"{label}: the cell made no call to {kernel}")
    args, kw = got["args"], got["kwargs"]
    dtype = args[0].dtype
    with torch.inference_mode():
        if kernel == "paged_attention":
            out = paged_ops.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            err, rel = hold(f"{label} paged_attention", out,
                            paged_ops.paged_attention_plain(*args, **kw), dtype)
            return err, rel, [list(a.shape) for a in args[:4]]
        q, k, v = args[:3]
        if len(args) > 3 and args[3] is not None:
            raise AssertionError(f"{label}: flash_attention with lens")
        out = flash_ops.flash_attention(*args, **kw)
        torch.cuda.synchronize()
        S, errs = q.shape[1], []
        for r0 in sorted({0, S // 2, S - HELD_ROWS}):
            r1 = min(r0 + HELD_ROWS, S)
            errs.append(hold(f"{label} flash_attention rows {r0}:{r1}", out[:, r0:r1],
                             flash_rows_plain(q, k, v, r0, r1, kw.get("window", 0)),
                             dtype))
            torch.cuda.empty_cache()
        return (max(e for e, _ in errs), max(r for _, r in errs),
                [list(a.shape) for a in args[:3]])


def _dryrun_line(phase, res, **kw):
    r = res["roofline"]
    emit(phase, arch=res["arch"], shape=res["shape"], mesh=res["mesh"],
         reduced=res.get("reduced", {}), flops=res["flops"],
         hbm_bytes=res["hbm_bytes"], hbm_bytes_eager=res["hbm_bytes_eager"],
         collective_wire_bytes=res["collective_wire_total"],
         collective_counts=res["collective_counts"],
         bound_s=r["step_time_bound_s"], bottleneck=r["bottleneck"],
         t_compute_s=r["t_compute_s"], t_memory_s=r["t_memory_s"],
         t_collective_s=r["t_collective_s"],
         argument_bytes=res["memory"]["argument_bytes"],
         peak_estimate_bytes=res["memory"]["peak_estimate_bytes"],
         trace_s=res["trace_s"], **kw)


def dryrun_phase(flash_ops, paged_ops):
    """``dryrun``: every cell of the grid on the 16x16 mesh counted on meta
    (one line a cell; the 7 long_500k cells the reference skips, with its
    reason), and each of ``DRYRUN_LEVERS`` over its target cells, in
    ``DRYRUN_WORKERS`` processes; then the ``DRYRUN_MEASURED`` cells run on
    the card at mesh 1x1 through ``dryrun.measure_cell``, the kernels'
    counts set to 0 just before and read just after: the counted FLOPs and
    bytes, the bound, the measured step (CUDA events, warm, median) and the
    share of the bound it reached. Returns the launches of each measured
    cell and the counts by (arch, shape, lever or None)."""
    import multiprocessing as mp

    from repro_torch.configs.registry import cells
    from repro_torch.launch import dryrun

    grid = list(cells(include_skipped=True))
    jobs = [(arch, shape, "single", None) for arch, shape, skip in grid if not skip]
    jobs += [(arch, shape, "single", {lever: True}) for lever in DRYRUN_LEVERS
             for arch, shape in dryrun.lever_cells(lever)]
    jobs.sort(key=lambda job: job[1] != "train_4k")     # the longest first
    with mp.get_context("spawn").Pool(DRYRUN_WORKERS) as pool:
        results = pool.starmap(dryrun.count_cell, jobs, chunksize=1)
    counts = {(arch, shape, next(iter(opts)) if opts else None): res
              for (arch, shape, _, opts), res in zip(jobs, results)}
    counted = 0
    for arch, shape, skip in grid:
        if skip:
            emit("dryrun", arch=arch, shape=shape, mesh="16x16", skipped=skip)
            continue
        res = counts[arch, shape, None]
        if not (res["flops"] > 0 and res["hbm_bytes"] > 0
                and res["collective_wire_total"] > 0):
            raise AssertionError(f"dryrun {arch} {shape}: an empty count {res}")
        _dryrun_line("dryrun", res)
        counted += 1
    if counted != 33:
        raise AssertionError(f"dryrun: {counted} cells counted, not 33")
    launches = {}
    for arch, shape, batch, kernel in DRYRUN_MEASURED:
        free_card()
        with first_call(kernel) as got:
            _zero_launches(flash_ops, paged_ops)
            res = dryrun.measure_cell(arch, shape, batch, iters=DRYRUN_ITERS)
            n = _launches(flash_ops, paged_ops)
        m = res["measured"]
        if not m["finite"] or n[kernel] == 0:
            raise AssertionError(f"dryrun_measured {arch} {shape}: finite "
                                 f"{m['finite']}, launches {n}")
        free_card()
        err, rel, shapes = hold_at_cell(f"dryrun_measured {arch} {shape}", kernel,
                                        got, flash_ops, paged_ops)
        del got
        _dryrun_line("dryrun_measured", res, measured_s=m["step_s"],
                     steps_s=m["steps_s"], share_of_bound=m["share_of_bound"],
                     launches=n, device=m["device"],
                     held={"kernel": kernel, "shapes": shapes, "max_abs_err": err,
                           "rel_rms_err": rel})
        launches[f"{arch} {shape} 1x1"] = n
    free_card()
    return launches, counts


def _split_inputs(m, gen):
    """One 8,192-position sequence of bf16 pages (shuffled) and its two
    halves' tables, the newest token at SPLIT_PROMPT - 1."""
    KV, G, D = m["KV"], m["G"], m["D"]
    n = SPLIT_LEN // 16
    q = torch.randn((1, KV, G, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp, vp = (torch.randn((n, 16, KV, D), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    tables = torch.randperm(n, generator=gen, device="cuda").int().view(1, n)
    lens = torch.tensor([SPLIT_PROMPT - 1], dtype=torch.int32, device="cuda")
    halves = [tables[:, :n // 2].contiguous(), tables[:, n // 2:].contiguous()]
    return q, kp, vp, tables, lens, halves


def hold_partitions(label, kern, plain):
    """The kernel's raw partials against the plain version's, partition by
    partition, for each share ``kern`` and ``plain`` hold ((acc, ml) each):
    a partition with no key that counts holds l = 0 and acc = 0; one that
    counts holds m and l within TOL (bf16, the kernel's p.v operands) and
    acc / l within TOL and REL_RMS. Returns the max abs err of acc / l."""
    err = 0.0
    for i, ((acc, ml), (acc_p, ml_p)) in enumerate(zip(kern, plain)):
        counts = ml_p[..., 1] > 0                               # (B,KV,P,G)
        if bool((ml[..., 1][~counts] != 0).any()) or bool((acc[~counts] != 0).any()):
            raise AssertionError(f"{label} share {i}: a partition with no key "
                                 "that counts holds a partial")
        if not bool(counts.any()):
            continue
        for j, what in enumerate(("m", "l")):
            hold(f"{label} share {i} {what}", ml[..., j][counts], ml_p[..., j][counts],
                 torch.bfloat16)
        l, l_p = ml[..., 1:2][counts], ml_p[..., 1:2][counts]
        err = max(err, hold(f"{label} share {i} acc / l", acc[counts] / l,
                            acc_p[counts] / l_p, torch.bfloat16)[0])
    return err


def time_split(paged_ops, m, gen):
    """K2's partials (over each half) and merge held against their plain
    versions at ``m``'s shape, and against the one-call decode: the raw
    partials partition by partition (``hold_partitions``), the merged
    output of the kernel's partials against the plain merge of the plain
    partials, and the merge kernel on the plain partials against the plain
    merge, each by ``hold``. Then each timed beside its bound (the keys a half counts, read
    once with q; the partials or the output written once) and its plain
    version; no PyTorch call computes partials, so no library time."""
    q, kp, vp, tables, lens, halves = _split_inputs(m, gen)
    w = m["window"]
    shift = [0, SPLIT_LEN // 2]
    kern = [paged_ops.paged_attention_partials(q, kp, vp, h, lens - s, window=w)
            for h, s in zip(halves, shift)]
    plain = [paged_ops.paged_attention_partials_plain(q, kp, vp, h, lens - s, window=w)
             for h, s in zip(halves, shift)]
    cat = lambda parts, i: torch.cat([p[i] for p in parts], dim=2)  # noqa: E731
    want = paged_ops.paged_merge_plain(cat(plain, 0), cat(plain, 1), q.dtype)
    one_call = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=w)
    merged = paged_ops.paged_merge(cat(kern, 0), cat(kern, 1), q.dtype)
    merge_only = paged_ops.paged_merge(cat(plain, 0), cat(plain, 1), q.dtype)
    torch.cuda.synchronize()
    label = f"split {m['model']}"
    errs = {"partitions": hold_partitions(label, kern, plain)}
    for name, got, ref in (("partials", paged_ops.paged_merge_plain(
            cat(kern, 0), cat(kern, 1), q.dtype), want), ("merge", merge_only, want),
            ("merged_vs_one_call", merged, one_call)):
        errs[name] = hold(f"{label} {name}", got, ref, torch.bfloat16)[0]
    B, KV, G, D = q.shape
    # the keys the second half counts (it holds the newest token)
    keys = min(SPLIT_PROMPT - SPLIT_LEN // 2, w) if w else SPLIT_PROMPT - SPLIT_LEN // 2
    acc, ml = kern[1]
    p_bytes = 2 * keys * KV * D * q.element_size() + nbytes(q, halves[1], lens, acc, ml)
    p_bound, p_by = bound(4 * G * D * KV * keys, p_bytes, torch.bfloat16)
    a2, m2 = cat(kern, 0), cat(kern, 1)
    g_bound, g_by = bound(0, nbytes(a2, m2, merged), torch.bfloat16)
    rows = {}
    for name, fn, plain_fn, b_ms, b_by in (
            ("paged_attention_partials",
             lambda: paged_ops.paged_attention_partials(q, kp, vp, halves[1],
                                                        lens - shift[1], window=w),
             lambda: paged_ops.paged_attention_partials_plain(
                 q, kp, vp, halves[1], lens - shift[1], window=w), p_bound, p_by),
            ("paged_merge", lambda: paged_ops.paged_merge(a2, m2, q.dtype),
             lambda: paged_ops.paged_merge_plain(a2, m2, q.dtype), g_bound, g_by)):
        ms, host_ms = time_ms(fn, 50)
        dev = device_ms(fn, 50)
        rows[name] = dict(
            model=m["model"], shape=[B, KV, G, D], window=w,
            positions=[SPLIT_LEN // 2, SPLIT_PROMPT], ms=ms, device_ms=dev,
            host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
            bound_share=b_ms / ms, device_bound_share=b_ms / dev,
            plain_ms=time_ms(plain_fn, 5)[0], library_ms=None,
            max_abs_err=errs["partials" if name == "paged_attention_partials"
                             else "merge"])
        emit("timing", kernel=name, **rows[name])
    emit("check_split", model=m["model"], max_abs_err=errs)
    return rows


def split_rank(rank, out_dir):
    """One rank of the split decode (``run_ranks`` spawns two on the card):
    each of ``SPLIT_ARCHS`` at ``SPLIT_LAYERS`` in bf16 on a (2, 1) mesh whose
    cache sequence is cut over "data" (weights whole), the prompt
    prefilled whole, this rank's 4,096 positions of it written into its
    pool, then ``SPLIT_STEPS`` greedy decode steps through K2's partials,
    an all_gather of them and the merge; every kernel's count set to 0
    just before the prefill and read after the last step. The leading rank
    then runs the same prompt on the unsplit model (no mesh) on the card.
    Writes its rows to ``out_dir``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import ParallelContext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, model_axis = SPLIT_MESH
    ctx = ParallelContext(mesh=make_mesh_for(data * model_axis, model_axis,
                                             device_type="cuda"),
                          fsdp_axis=None, rules_override=SPLIT_OVERRIDE)
    share = SPLIT_LEN // data

    def greedy(model, lo, hi):
        """Prefill, the positions lo..hi-1 into a pool, SPLIT_STEPS steps."""
        gen = torch.Generator(device="cuda").manual_seed(7)
        prompt = torch.randint(0, model.cfg.vocab, (1, SPLIT_PROMPT), generator=gen,
                               device="cuda")
        n = (hi - lo) // 16
        last, caches, states = model.prefill(prompt)
        pools = [torch.zeros(s, dtype=torch.bfloat16, device="cuda")
                 for s in model.pool_shapes(n, 16)]
        tables = torch.arange(n, dtype=torch.int32, device="cuda").view(1, n)
        pos = torch.arange(max(0, min(hi, SPLIT_PROMPT) - lo), device="cuda")
        for j, pool in enumerate(pools):
            pool[:, tables[0, pos // 16].long(), pos % 16] = torch.stack(
                [c[j][0, lo + pos] for c in caches])
        del caches
        rows = torch.arange(1, device="cuda")
        tok, out = last.argmax(-1), []
        for i in range(SPLIT_STEPS):
            out.append(int(tok))
            logits = model.decode_step(
                tok, torch.full((1,), SPLIT_PROMPT + i, device="cuda"), pools,
                tables, states, rows if states else None)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        return out

    rows = []
    for arch in SPLIT_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=SPLIT_LAYERS[arch])
        free_card()
        model = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=0, ctx=ctx)
        for k in (flash_ops.KERNEL, paged_ops.KERNEL, paged_ops.PARTIALS, paged_ops.MERGE):
            k.launches = 0
        ctx.comm.reset()
        t0 = time.perf_counter()
        with torch.inference_mode():
            tokens = greedy(model, rank * share, (rank + 1) * share)
        row = dict(model=arch, rank=rank, tokens=tokens, layers=cfg.n_layers,
                   seconds=time.perf_counter() - t0,
                   launches={"flash_attention": flash_ops.KERNEL.launches,
                             "paged_attention": paged_ops.KERNEL.launches,
                             "paged_attention_partials": paged_ops.PARTIALS.launches,
                             "paged_merge": paged_ops.MERGE.launches},
                   comm={k: dict(v) for k, v in ctx.comm.stats.items()})
        del model
        if rank == 0:
            free_card()
            one = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
            with torch.inference_mode():
                row["unsplit_tokens"] = greedy(one, 0, SPLIT_LEN)
            del one
        rows.append(row)
    with open(Path(out_dir) / f"split.rank{rank}.json", "w") as f:
        json.dump(rows, f)


def long_decode(flash_ops, paged_ops):
    """``long_decode``: zamba2-2.7b's long_500k cell whole on the card (B 1,
    524,288 tokens of seeded cache) through ``dryrun.measure_cell``, its
    decode steps timed against the counted bound (K2 in multiples of the
    shared block's 9 invocations, K1 none); K2's partials and merge held
    against their plain versions and timed at the split run's shapes; then
    the split decode on two gloo ranks, whose greedy tokens must equal the
    unsplit model's on the card, each rank launching the partials and the
    merge once a shared-block invocation (or attention layer) a step and
    one-call K2 never. Returns (timing rows, launches by model and rank)."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import run_ranks

    free_card()
    with first_call("paged_attention") as got:
        _zero_launches(flash_ops, paged_ops)
        res = dryrun.measure_cell("zamba2-2.7b", "long_500k", iters=DRYRUN_ITERS)
        n = _launches(flash_ops, paged_ops)
    m = res["measured"]
    if not m["finite"] or n["flash_attention"] or not n["paged_attention"] \
            or n["paged_attention"] % 9:
        raise AssertionError(f"long_decode: finite {m['finite']}, launches {n}")
    free_card()
    err, rel, shapes = hold_at_cell("long_decode zamba2-2.7b long_500k",
                                    "paged_attention", got, flash_ops, paged_ops)
    del got
    _dryrun_line("long_decode", res, measured_s=m["step_s"],
                 steps_s=m["steps_s"], share_of_bound=m["share_of_bound"],
                 launches=n, device=m["device"],
                 held={"kernel": "paged_attention", "shapes": shapes,
                       "max_abs_err": err, "rel_rms_err": rel})
    launches = {"zamba2-2.7b long_500k 1x1": n}
    free_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    timings = [time_split(paged_ops, mm, gen) for mm in SPLIT_PAGED]
    free_card()
    out = tempfile.mkdtemp(prefix="split_decode_")
    world = SPLIT_MESH[0] * SPLIT_MESH[1]
    try:
        run_ranks(split_rank, world, (out,), backend="gloo", device_type="cuda")
        ranks = [json.loads((Path(out) / f"split.rank{r}.json").read_text())
                 for r in range(world)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for rows in zip(*ranks):
        lead = rows[0]
        for row in rows:
            ln = row["launches"]
            if row["tokens"] != lead["unsplit_tokens"] or ln["paged_attention"] \
                    or not ln["paged_attention_partials"] or not ln["paged_merge"] \
                    or not ln["flash_attention"]:
                raise AssertionError(
                    f"split decode {row['model']} rank {row['rank']}: tokens "
                    f"{row['tokens']} against unsplit {lead['unsplit_tokens']}, "
                    f"launches {ln}")
            emit("split_decode", model=row["model"], rank=row["rank"],
                 reduced={"n_layers": [get_config(row["model"]).n_layers, row["layers"]]},
                 mesh={"data": SPLIT_MESH[0], "model": SPLIT_MESH[1]},
                 positions=[SPLIT_LEN // world, SPLIT_LEN], prompt=SPLIT_PROMPT,
                 steps=SPLIT_STEPS, tokens=row["tokens"],
                 tokens_equal_unsplit=True, seconds=row["seconds"], launches=ln,
                 collectives={k: v["calls"] for k, v in row["comm"].items()})
            launches[f"{row['model']} split rank{row['rank']}"] = ln
    return timings, launches

# the levers phase: the reference's §Perf levers on gloo ranks on the card,
# 2 layers at published widths in fp32, prompts of 12-200 tokens (h2o-danube
# two past its 4,096 window) served through ``TorchRunner`` behind the
# engine, LEVER_STEPS tokens a request
LEVER_LAYERS = 2
LEVER_STEPS = 2   # cut from 4 for the run's time
LEVER_PROMPTS = dict(n=4, isl=(12, 200), seed=3)
LEVER_DANUBE_PROMPTS = (4200, 4260)
# the runner's prefill chunks: prompts of 12-200 tokens take uneven ones
LEVER_ENGINE = dict(max_num_seqs=4, max_num_batched_tokens=512, chunk_size=48,
                    admission_mode="naive")
# a lever run takes at most about 250 engine steps (h2o-danube's two
# 4,200-token prompts in 48-token chunks, one after the other)
LEVER_MAX_STEPS = 2000
# run -> (lever, model, mesh (data, model), the path it takes, other options)
LEVER_RUNS = {
    "serve_2d_tp": ("serve_2d_tp", "llama3.2-3b", (2, 2), "runner", {}),
    "moe_ff_shard": ("moe_ff_shard", "phi3.5-moe-42b-a6.6b", (2, 2), "runner",
                     {"moe_dispatch": "replicated"}),
    "seq_shard_decode": ("seq_shard_decode", "h2o-danube-3-4b", (1, 2), "runner", {}),
    "seq_shard_decode/mla": ("seq_shard_decode", "deepseek-r1-671b", (1, 2), "runner",
                             {}),
    "seq_parallel_norm": ("seq_parallel_norm", "llama3.2-3b", (1, 2), "runner", {}),
    "decode_unroll": ("decode_unroll", "llama3.2-3b", (1, 2), "runner", {}),
    "train_kv_2d": ("train_kv_2d", "llama3.2-3b", (2, 2), "train", {}),
}
# phi3.5-moe in the levers phase: one layer (its baseline gathers 2.5 GB of
# experts a rank a forward through gloo, 30-35 s a layer over the phase's
# prefills and steps), its capacity factor raised to E/top_k so that no
# assignment drops at tp=1 nor in a rank's capacity
LEVER_PHI_LAYERS = 1
# the levers counted on meta over each one's target cells on the 16x16 mesh
# (``dryrun.lever_cells``) beside the baseline grid, in DRYRUN_WORKERS
# processes (45 s for the 76 cells on an 8-core host, train cells first)
DRYRUN_LEVERS = ("serve_2d_tp", "moe_ff_shard", "seq_shard_decode",
                 "seq_parallel_norm", "train_kv_2d")
DRYRUN_WORKERS = 7


def _lever_prompts(cfg, lever):
    """The lever's prompts, seeded: h2o-danube's past its window; else
    ``LEVER_PROMPTS``, whose second half repeats the first half's
    lengths."""
    r = LEVER_PROMPTS
    rng = np.random.default_rng(r["seed"])
    lens = list(LEVER_DANUBE_PROMPTS) if cfg.attention == "swa" else \
        rng.integers(r["isl"][0], r["isl"][1] + 1, size=r["n"] // 2).tolist() * 2
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]


def _lever_config(full):
    """A lever run's config at full width and its cuts: LEVER_LAYERS
    layers (DeepSeek-R1: its first LEVER_LAYERS dense layers, MLA and the
    dense MLP); phi3.5-moe LEVER_PHI_LAYERS, with no capacity drops."""
    if full.moe is None:
        return (dataclasses.replace(full, n_layers=LEVER_LAYERS),
                {"n_layers": [full.n_layers, LEVER_LAYERS]})
    if full.moe.first_dense_layers >= LEVER_LAYERS:
        dense = full.moe.first_dense_layers
        return (dataclasses.replace(full, n_layers=LEVER_LAYERS, moe=dataclasses.replace(
            full.moe, first_dense_layers=LEVER_LAYERS)),
                {"n_layers": [full.n_layers, LEVER_LAYERS],
                 "first_dense_layers": [dense, LEVER_LAYERS]})
    no_drop = full.moe.n_experts / full.moe.top_k
    cfg = dataclasses.replace(full, n_layers=LEVER_PHI_LAYERS, moe=dataclasses.replace(
        full.moe, capacity_factor=no_drop))
    return cfg, {"n_layers": [full.n_layers, LEVER_PHI_LAYERS],
                 "capacity_factor": [full.moe.capacity_factor, no_drop]}


def _lever_kernels():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    return {"flash_attention": flash_ops.KERNEL, "paged_attention": paged_ops.KERNEL,
            "paged_attention_partials": paged_ops.PARTIALS,
            "paged_merge": paged_ops.MERGE}


def lever_rank(rank, runs, out_dir):
    """One rank of the levers phase (``run_ranks`` spawns them on the card
    over gloo): for each run of ``runs`` on this world's mesh, the
    baseline model and the lever's, seeded alike, through its path; the
    kernels' counts and the collectives' counters set to 0 just before each
    run and read just after. Rank 0 then runs the same work at tp=1 on the
    card. Writes its rows to ``out_dir``."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel.sharding import ParallelContext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = _lever_kernels()
    rows, mesh = [], None
    for run in runs:
        lever, arch, (data, tp), path, opts = LEVER_RUNS[run]
        mesh = mesh or make_mesh_for(data * tp, tp, device_type="cuda")
        cfg, reduced = _lever_config(get_config(arch))
        row = dict(run=run, lever=lever, model=arch, rank=rank, mesh=[data, tp],
                   path=path, layers=cfg.n_layers, reduced=reduced, dtype="float32")
        trained = {}
        # training holds the lever to tp=1 alone (sharded_train holds the
        # baseline layout's steps)
        runs_of = (("with_lever", {**opts, lever: True}),) if path == "train" else \
            (("baseline", opts), ("with_lever", {**opts, lever: True}))
        for name, kw in runs_of:
            ctx = ParallelContext(mesh=mesh, **kw)
            free_card()
            for k in kernels.values():
                k.launches = 0
            ctx.comm.reset()
            t0 = time.perf_counter()
            row[name], trained[name] = _lever_run(cfg, ctx, lever, path)
            torch.cuda.synchronize()
            row[name].update(
                seconds=time.perf_counter() - t0,
                launches={n: k.launches for n, k in kernels.items()},
                comm={op: {"calls": v["calls"], "bytes": v["bytes"],
                           "weights": v.get("weights", 0)}
                      for op, v in ctx.comm.stats.items()})
        trained.pop("baseline", None)
        dist.barrier()
        one = None
        if rank == 0:
            free_card()
            row["tp1"], one = _lever_run(cfg, None, lever, path)
        if path == "train":
            row.update(_lever_params(trained["with_lever"], one))
        del trained, one
        dist.barrier()
        rows.append(row)
        if rank == 0:
            print(f"levers: {run} done at {time.perf_counter() - STARTED:.1f} s",
                  file=sys.stderr, flush=True)
    with open(Path(out_dir) / f"levers.rank{rank}.json", "w") as f:
        json.dump(rows, f)


def _lever_run(cfg, ctx, lever, path):
    """One run of a lever's path under ``ctx`` (None: tp=1): (its row, the
    trained model for ``path`` "train", else None)."""
    if path == "train":
        return _lever_train(cfg, ctx)
    return _lever_runner(cfg, ctx, _lever_prompts(cfg, lever), lever), None


def _lever_runner(cfg, ctx, prompts, lever):
    """The prompts served by ``TorchRunner`` behind the engine (sharded
    over ``ctx``'s mesh, or at tp=1 without one), LEVER_STEPS tokens each,
    the leader running the engine and the other ranks following it, on a
    pool that holds them all. The runner takes the reference's bound
    ``max_len`` (``lever_max_len``), so a rank's pool holds its share of
    the reference's cache (its data rank's slots, its share of a sequence
    under ``seq_shard_decode``: half of ``max_len``, which the longer
    sequences pass and so reach the second rank) where the engine's pool
    holds that much, else the engine's pool; plus the pad page where it
    pads. The engine stops after LEVER_MAX_STEPS steps, so a run that
    stalls fails its token check at once. Returns the leader's tokens,
    TTFT and TPOT, and every rank's decode steps, the weights its decode
    steps gathered, its pools' bytes beside the reference's share (the
    formula: rows x max_len / sp positions at the rank's bytes a position)
    and the pools' bytes without ``max_len``."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.launch.serve import pages_to_hold
    from repro_torch.models.transformer import Transformer

    class Runner(TorchRunner):
        """``TorchRunner`` that counts its decode steps and the weights
        they gather (every rank runs ``_decode``)."""
        steps = weights = 0

        def _decode(self, *work):
            stats = ctx.comm.stats if ctx is not None else {}
            before = stats.get("all_gather", {}).get("weights", 0)
            out = super()._decode(*work)
            self.steps += 1
            self.weights += stats.get("all_gather", {}).get("weights", 0) - before
            return out

    requests = [(p, LEVER_STEPS) for p in prompts]
    page = 16
    engine = dict(LEVER_ENGINE, n_pages=pages_to_hold(requests))
    max_len = lever_max_len(requests, ctx)
    runner = Runner(Transformer(cfg, device="cuda", dtype=torch.float32, seed=1,
                                ctx=ctx), device="cuda", max_len=max_len)
    out = {}
    if runner.leads:
        try:
            eng = InferenceEngine(cfg, EngineConfig(**engine), runner,
                                  virtual_clock=False)
            reqs = [eng.submit(p, n) for p, n in requests]
            eng.run(max_steps=LEVER_MAX_STEPS)
        finally:
            runner.close()
        s = eng.metrics.summary()
        out.update(tokens=[r.output for r in reqs], tpot_mean_s=s["tpot_s"]["mean"],
                   ttft_p50_s=s["ttft_s"]["p50"],
                   preemptions=sum(r.n_preemptions for r in reqs),
                   longest=max(len(r.prompt) + len(r.output) for r in reqs))
    else:
        runner.follow()
    # a position's bytes on this rank: every pool's row of one token
    position = sum(int(np.prod(shape)) for shape in runner.model.pool_shapes(1, 1)) \
        * runner.pools[0].element_size()
    pad = page * position if runner.pad_page is not None else 0
    out.update(decode_steps=runner.steps, decode_weight_gathers=runner.weights,
               pool_pages=engine["n_pages"], share_tokens=runner.share_blocks * page,
               max_len=max_len, rows=runner.rows,
               pool_bytes=sum(t.numel() * t.element_size() for t in runner.pools),
               reference_share_bytes=runner.rows * (max_len // runner.sp) * position,
               engine_pool_bytes=engine["n_pages"] * page * position, pad_page_bytes=pad,
               pool_bytes_without_max_len=engine["n_pages"] * page * position + pad,
               state_bytes=sum(t.numel() * t.element_size() for t in runner.states))
    return out


def lever_max_len(requests, ctx):
    """The runner's ``max_len`` for a lever run: the requests' peak
    context, rounded up to whole pages over the cache's sequence axis (so
    that the reference's ``max_len / sp`` positions a rank are whole
    pages, as the port's share is)."""
    from repro_torch.launch.serve import peak_context
    seq = ctx.spec("cache_seq")[0] if ctx is not None and ctx.mesh is not None else None
    step = 16 * (ctx.axis_size(seq) if seq else 1)
    return -(-peak_context(requests) // step) * step


def _lever_train(cfg, ctx):
    """``SHARDED_TRAIN_EQ``'s AdamW steps on its batches from the seeded
    train layout (sharded over ``ctx``'s mesh, or at tp=1 without one):
    (losses, grad norms and step seconds; the trained model)."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    e = SHARDED_TRAIN_EQ
    ocfg = AdamWConfig(lr=e["lr"], warmup_steps=e["warmup"])
    m = Transformer(cfg, device="cuda", dtype=torch.float32, seed=3, layout="train",
                    ctx=ctx)
    state = init_opt_state(m.param_tree(), ocfg)
    step = make_train_step(m, ocfg)
    hist = []
    for i in range(e["steps"]):
        batch = synthetic_batch(i, e["batch"], e["seq"], cfg.vocab, device="cpu")
        if ctx is not None:
            batch = _rank_rows(ctx, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(state, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        hist.append((float(met["loss"]), float(met["grad_norm"]),
                     time.perf_counter() - t0))
    loss, gnorm, secs = map(list, zip(*hist))
    return dict(loss=loss, grad_norm=gnorm, step_s=secs), m


def _lever_params(m, one):
    """The sharded model's parameters after its steps against tp=1's
    (``one``, on rank 0, which broadcasts them leaf by leaf): each rank's
    shard of every leaf against the one the tp=1 leaf maps to
    (``take_shard``): the largest difference, and how many lie beyond
    TRAIN_PARAM_ATOL."""
    import torch.distributed as dist

    from repro_torch.models.transformer import take_shard
    ref = dict(one.named_parameters()) if one is not None else {}
    ctx, cfg = m.ctx, m.cfg
    max_diff, off, n = 0.0, 0, 0
    with torch.no_grad():
        for name, p in m.named_parameters():
            whole = ref[name].detach() if ref else torch.empty(
                m.specs[name][0], dtype=p.dtype, device=p.device)
            dist.broadcast(whole, src=0)
            axes = m.axes[name]
            lead = sum(1 for a in axes if a == "layers")
            want = torch.stack([take_shard(w, axes[lead:], cfg, ctx, ctx.coords(),
                                           "train")
                                for w in whole.flatten(0, lead - 1)]).view(p.shape) \
                if lead else take_shard(whole, axes, cfg, ctx, ctx.coords(), "train")
            d = (p - want).abs()
            max_diff = max(max_diff, float(d.max()))
            off += int((d > TRAIN_PARAM_ATOL).sum())
            n += d.numel()
    return dict(max_param_diff=max_diff, params_beyond_atol=off, params=n)


def levers(counts):
    """``levers``: each §Perf lever of ``LEVER_RUNS`` on gloo ranks on the
    card (four on a (2,2) mesh, then two on (1,2)), its tokens equal the
    same mesh's baseline's and tp=1's; the serving levers through
    ``TorchRunner`` behind the engine (on (2,2) the runner serves "data" 2);
    ``serve_2d_tp`` and ``moe_ff_shard`` gather no weight of theirs in the
    decode steps, ``seq_parallel_norm`` launches K1 and
    ``seq_shard_decode`` K2's partials and merge and never the one-call K2
    (R1's MLA split decode launches no kernel); ``train_kv_2d``'s three
    AdamW steps match tp=1's losses, grad norms and parameters under
    ``train_equality``'s tolerances. One line a run and rank (its tokens,
    launches, collectives by op, each rank's pool bytes and host-clock
    times); then the dry-run's count of each lever's target cells beside
    the baseline's (``levers_dryrun``: FLOPs, bytes, wire by kind, both
    collective terms, the bound and its binding term; ``counts`` from
    ``dryrun_phase``). Returns the launches of each run, summed over its
    ranks."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    t_start = time.perf_counter()
    out = tempfile.mkdtemp(prefix="levers_")
    rows = []
    try:
        for world in (4, 2):
            names = [k for k, v in LEVER_RUNS.items() if v[2][0] * v[2][1] == world]
            if not names:
                continue
            run_ranks(lever_rank, world, (names, out), backend="gloo",
                      device_type="cuda")
            ranks = [json.loads((Path(out) / f"levers.rank{r}.json").read_text())
                     for r in range(world)]
            rows += list(zip(*ranks))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    card_s = time.perf_counter() - t_start
    launches = {}
    for ranks in rows:
        _check_lever(ranks)
        for r in ranks:
            emit("levers", **{k: r[k] for k in ("run", "lever", "model", "rank", "mesh",
                                                 "path", "layers", "reduced",
                                                 "dtype")},
                 baseline=r.get("baseline"), with_lever=r["with_lever"],
                 tp1=r.get("tp1"), **{k: r[k] for k in ("max_param_diff",
                                                        "params_beyond_atol", "params")
                                      if k in r})
            key = f"levers/{r['run']}"
            launches[key] = {n: launches.get(key, {}).get(n, 0) + c
                             for n, c in r["with_lever"]["launches"].items()}
    from repro_torch.launch import dryrun
    for lever in DRYRUN_LEVERS:
        for arch, shape in dryrun.lever_cells(lever):
            emit("levers_dryrun", lever=lever, arch=arch, shape=shape, mesh="16x16",
                 baseline=_lever_count(counts[arch, shape, None]),
                 lever_count=_lever_count(counts[arch, shape, lever]))
    emit("levers_time", card_s=card_s, seconds=time.perf_counter() - t_start)
    return launches


def _lever_count(res):
    r = res["roofline"]
    return dict(flops=res["flops"], hbm_bytes=res["hbm_bytes"],
                wire_bytes=res["collective_wire_bytes"],
                weight_gather_wire=res["collective_weight_wire"],
                t_compute_s=r["t_compute_s"], t_memory_s=r["t_memory_s"],
                t_collective_s=r["t_collective_s"],
                t_collective_hier_s=r["t_collective_hier_s"],
                bound_s=r["step_time_bound_s"], bottleneck=r["bottleneck"],
                bound_hier_s=r["step_time_bound_hier_s"],
                bottleneck_hier=r["bottleneck_hier"])


# the lever runs whose ranks must hold exactly the reference's cache share
# (and the pad page): the runner at "data" 2, and the sequence cut over 2
LEVER_SHARE_RUNS = ("serve_2d_tp", "seq_shard_decode")


def _check_pools(run, name, r):
    """A serving run's pools on rank r: the smaller of the reference's
    share and the engine's pool, plus the pad page; the reference's share
    itself for ``LEVER_SHARE_RUNS``' lever runs."""
    want = min(r["reference_share_bytes"], r["engine_pool_bytes"]) + r["pad_page_bytes"]
    if r["pool_bytes"] != want or (
            name == "with_lever" and run in LEVER_SHARE_RUNS
            and r["pool_bytes"] != r["reference_share_bytes"] + r["pad_page_bytes"]):
        return [f"{name}: pools of {r['pool_bytes']} B, the reference's share "
                f"{r['reference_share_bytes']} B (engine pool {r['engine_pool_bytes']} B, "
                f"pad page {r['pad_page_bytes']} B)"]
    return []


def _check_lever(ranks):
    """Raise unless a run's rows meet the phase's checks (``levers``)."""
    lead = ranks[0]
    run, lever, path = lead["run"], lead["lever"], lead["path"]
    fail = []
    if path == "train":
        one, got = lead["tp1"], lead["with_lever"]
        if not (np.allclose(got["loss"], one["loss"], rtol=TRAIN_LOSS_RTOL, atol=0)
                and np.allclose(got["grad_norm"], one["grad_norm"],
                                rtol=TRAIN_GNORM_RTOL, atol=0)):
            fail.append(f"with_lever: losses or grad norms {got} against tp=1 {one}")
        for r in ranks:
            if r["params_beyond_atol"] > TRAIN_FLIP_SHARE * r["params"]:
                fail.append(f"rank {r['rank']}: {r['params_beyond_atol']} parameters "
                            f"beyond {TRAIN_PARAM_ATOL}")
            if any(r["with_lever"]["launches"].values()):
                fail.append(f"rank {r['rank']}: training launched a kernel")
    else:
        want = lead["tp1"]["tokens"]
        if not all(len(t) == LEVER_STEPS for t in want):
            fail.append(f"tp=1 served {[len(t) for t in want]} tokens")
        fail += _check_pools(run, "tp1", lead["tp1"])
        for r in ranks:
            for name in ("baseline", "with_lever"):
                fail += [f"rank {r['rank']} {m}" for m in _check_pools(run, name, r[name])]
        for name in ("baseline", "with_lever"):
            if lead[name]["tokens"] != want:
                fail.append(f"{name} tokens {lead[name]['tokens']} != tp=1's {want}")
        mla = lead["model"] == "deepseek-r1-671b"
        layers = lead["layers"]
        for r in ranks:
            ln, lv, base = r["with_lever"]["launches"], r["with_lever"], r["baseline"]
            if not lv["decode_steps"]:
                fail.append(f"rank {r['rank']}: no decode step")
            if mla:
                if any(ln.values()):
                    fail.append(f"rank {r['rank']}: MLA launched {ln}")
            elif not ln["flash_attention"]:
                fail.append(f"rank {r['rank']}: K1 did not launch")
            if lever == "serve_2d_tp" and lv["decode_weight_gathers"]:
                fail.append(f"rank {r['rank']}: {lv['decode_weight_gathers']} weight "
                            "gathers in the decode steps")
            if lever == "moe_ff_shard" and (
                    lv["decode_weight_gathers"] != (4 * layers + 1) * lv["decode_steps"]
                    or base["decode_weight_gathers"]
                    != (7 * layers + 1) * base["decode_steps"]):
                # the attention's 4 leaves a layer and the untied head; the
                # baseline also gathers the 3 expert leaves
                fail.append(f"rank {r['rank']}: decode weight gathers "
                            f"{lv['decode_weight_gathers']} in {lv['decode_steps']} "
                            f"steps (baseline {base['decode_weight_gathers']} in "
                            f"{base['decode_steps']})")
            if lever == "seq_shard_decode":
                if not mla and (not ln["paged_attention_partials"] or not ln["paged_merge"]
                                or ln["paged_attention"]):
                    fail.append(f"rank {r['rank']}: launches {ln}")
                if lead["with_lever"]["longest"] <= lv["share_tokens"]:
                    fail.append(f"a rank's share of {lv['share_tokens']} positions "
                                "holds every sequence")
            elif not mla and not ln["paged_attention"]:
                fail.append(f"rank {r['rank']}: K2 did not launch")
    if fail:
        raise AssertionError(f"levers {run}: " + "; ".join(fail))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is False)")
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = kbuild.build([flash_ops.KERNEL.name, flash_ops.NONCAUSAL.name,
                          paged_ops.KERNEL.name, paged_ops.CVT.name, paged_ops.UPCAST.name,
                          paged_ops.SHARE_STATS.name])
    # each library's kernel instances (ptxas's entry functions) with their
    # registers and spills
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "entry function" in ln or "registers" in ln or "spill" in ln]
             for name, log in built.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    max_err = check_kernels(flash_ops, paged_ops)
    q8_err, q8_exact = check_q8(paged_ops)

    gen = torch.Generator(device="cuda").manual_seed(1)
    # K1's rows at the other models' prompts are held by ``check_kernels``,
    # not timed (for the run's time)
    timings = {"flash_attention": [time_flash(flash_ops, c, torch.bfloat16, gen)
                                   for c in RAGGED_FLASH[::-1] + MAIN_FLASH],
               "paged_attention": [time_paged(paged_ops, torch.bfloat16, gen, m)
                                   for m in (LONG_PAGED, MAIN_PAGED, *GQA_PAGED,
                                             ZAMBA_PAGED, MUSICGEN_PAGED,
                                             INTERNVL_PAGED)]}
    # the kernels line takes K1 at S=2048 and K2 at llama3.2-3b's decode batch
    main_row = {"flash_attention": len(RAGGED_FLASH) + len(MAIN_FLASH) - 1,
                "paged_attention": 1}
    for name, rows in timings.items():
        for row in rows:
            emit("timing", kernel=name, **row)
    noncausal_rows = [time_flash(flash_ops, c, torch.bfloat16, gen, causal=False)
                      for c in NONCAUSAL_TIMED]
    for row in noncausal_rows:
        emit("timing", kernel="flash_attention", **row)
    # K1's fp32 instance at the fp32 runs' prompts, SDPA's fp32 path beside
    fp32_rows = [time_flash(flash_ops, c, torch.float32, gen, causal=causal)
                 for c, causal in FP32_FLASH_TIMED]
    for row in fp32_rows:
        emit("timing", kernel="flash_attention", **row)
    # no phase after this one calls the non-causal mode (the main paths'
    # prefills are causal): its count here must stay 0 to the end
    flash_ops.NONCAUSAL.launches = 0
    q8_rows = [time_q8(paged_ops, pages, upcast, gen, m) for pages, upcast, m in Q8_TIMED]
    for row in q8_rows:
        emit("timing", kernel="paged_attention", **row)
    # the sequence split's launches on each half of reasoning lengths at G
    # 16 and of h2o-danube's one kv head a rank (the map over token pairs)
    # over fp8 pages
    split_rows = time_split_q8(paged_ops, torch.float8_e4m3fn, gen, Q8_REASONING[0])
    paired_split_rows = time_split_q8(paged_ops, torch.float8_e4m3fn, gen, Q8_ODD_KV[0])
    for row in split_rows + paired_split_rows:
        emit("timing", kernel="paged_attention split", **row)

    # the fp32 instances' launches (K1's flash_fwd_simt, K2's
    # paged_split_simt and the merge at fp32) on each path that runs them:
    # the in-process equality runs here (their ``by_instance`` "float32"
    # counts around each), the levers below (fp32 models, every launch)
    fp32_paths = {}

    def fp32_counts():
        return {"flash_attention": flash_ops.KERNEL.by_instance["float32"]
                + flash_ops.NONCAUSAL.by_instance["float32"],
                "paged_attention": paged_ops.KERNEL.by_instance["float32"],
                "paged_merge": paged_ops.MERGE.by_instance["float32"]}

    def fp32_path(name, phase):
        before = fp32_counts()
        out = phase()
        fp32_paths[name] = {k: v - before[k] for k, v in fp32_counts().items()}
        return out

    emit("greedy_equality", **fp32_path("greedy_equality", greedy_equality))
    free_card()
    by_model = {}
    launches, model = main_path(flash_ops, paged_ops)
    by_model[model.cfg.name] = launches
    profile_main_path(model)
    del model
    free_card()

    emit("greedy_equality_moe", **fp32_path("greedy_equality_moe", greedy_equality_moe))
    free_card()
    for cfg, reduced, traffic in moe_configs():
        traffic, reduced = fewer_steps(traffic, reduced)
        by_model[cfg.name], model = main_path(flash_ops, paged_ops, cfg,
                                              traffic, reduced)
        if cfg.attention == "mla":
            profile_main_path(model, traffic, decode_only=True)
        del model
        free_card()

    emit("greedy_equality_swa", **fp32_path("greedy_equality_swa", greedy_equality_swa))
    free_card()
    for cfg, reduced, traffic in gqa_configs():
        traffic, reduced = fewer_steps(traffic, reduced)
        by_model[cfg.name], model = main_path(flash_ops, paged_ops, cfg,
                                              traffic, reduced)
        del model
        free_card()

    emit("greedy_equality_hybrid",
         **fp32_path("greedy_equality_hybrid", greedy_equality_hybrid))
    free_card()
    emit("greedy_equality_xlstm", **fp32_path("greedy_equality_xlstm", greedy_equality_xlstm))
    free_card()
    from repro_torch.configs.registry import get_config
    for name, depth, traffic in (("zamba2-2.7b", ZAMBA_MAIN_LAYERS, SERVE_REQUESTS),
                                 ("xlstm-350m", XLSTM_MAIN_BLOCKS, XLSTM_REQUESTS)):
        full = get_config(name)
        cfg = dataclasses.replace(full, n_layers=depth)
        traffic, reduced = fewer_steps(traffic, {"n_layers": [full.n_layers, depth]})
        by_model[cfg.name], model = main_path(flash_ops, paged_ops, cfg, traffic, reduced)
        if cfg.family == "hybrid":
            profile_main_path(model, traffic, decode_only=True)
        del model
        free_card()

    emit("prefix_equality", **fp32_path("prefix_equality", prefix_equality))
    free_card()
    for cfg, reduced, traffic in vlm_audio_configs():
        traffic, reduced = fewer_steps(traffic, reduced)
        by_model[cfg.name], model = main_path(flash_ops, paged_ops, cfg,
                                              traffic, reduced)
        del model
        free_card()
    for admission, n in capacity(flash_ops, paged_ops).items():
        by_model[f"llama3.2-3b capacity {admission}"] = n
    free_card()
    q8_by_model = kv_cache_dtype_phase(flash_ops, paged_ops)
    free_card()
    reasoning_launches, unsplit = reasoning_decode(flash_ops, paged_ops)
    q8_by_model.update(reasoning_launches)
    for key, n in q8_by_model.items():
        by_model[key] = {k: n[k] for k in ("flash_attention", "paged_attention")}
    free_card()
    split_by_rank = split_reasoning(unsplit)
    del unsplit
    for key, n in split_by_rank.items():
        by_model[key] = {"flash_attention": n["flash_attention"],
                         "paged_attention": n["paged_attention_fwd"]}
    free_card()
    danube_by_rank = danube_tp8()
    q8_by_model.update(danube_by_rank)
    for key, n in danube_by_rank.items():
        by_model[key] = {k: n[k] for k in ("flash_attention", "paged_attention")}
    free_card()
    cluster_phase()
    by_model.update(examples_phase(flash_ops, paged_ops))
    free_card()

    train_equality(flash_ops, paged_ops)
    free_card()
    train_main_path(flash_ops, paged_ops)
    free_card()
    train_small(flash_ops, paged_ops)
    free_card()

    sharded("equality")
    free_card()
    by_model.update(sharded("main_path"))
    free_card()
    sharded_train(flash_ops, paged_ops)
    free_card()

    grid_launches, counts = dryrun_phase(flash_ops, paged_ops)
    by_model.update(grid_launches)
    split_timings, split_launches = long_decode(flash_ops, paged_ops)
    by_model.update(split_launches)
    free_card()
    lever_launches = levers(counts)
    by_model.update(lever_launches)
    fp32_paths.update(lever_launches)   # the levers serve and train fp32 models
    free_card()
    emit("fp32_instances", by_path=fp32_paths)

    replaces = {
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
        "paged_attention": "src/repro/kernels/paged_attention/kernel.py:79",
    }
    # K2's two halves, at zamba2's split shape
    for name in ("paged_attention_partials", "paged_merge"):
        timings[name] = [split_timings[0][name]]
        main_row[name] = 0
        replaces[name] = replaces["paged_attention"]
    kernels = []
    for name in ("flash_attention", "paged_attention", "paged_attention_partials",
                 "paged_merge"):
        # flash at S=2048; paged at llama3.2-3b's decode batch
        row = timings[name][main_row[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu"
            if name.startswith("paged") else f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(n.get(name, 0) for n in by_model.values()),
            "launches_by_model": {m: n[name] for m, n in by_model.items() if name in n},
            "max_abs_err": max_err.get(name, row.get("max_abs_err")), "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "library_device_ms": row.get("library_device_ms"),
            "host_ms": row["host_ms"], "shape": row["shape"],
            "dtype": row.get("dtype", "bfloat16"),
            "fp32_launches_by_path": {m: n[name] for m, n in fp32_paths.items()
                                      if n.get(name)}})
    if flash_ops.NONCAUSAL.launches:
        raise AssertionError(f"the main paths launched K1's non-causal instance "
                             f"{flash_ops.NONCAUSAL.launches} times")
    # K1's non-causal instances: their own rows, launched by no main path
    kernels[0]["modes"] = [{
        "mode": "causal=False", "source": "src/repro_torch/csrc/flash_attention_noncausal.cu",
        "launches": flash_ops.NONCAUSAL.launches,
        "max_abs_err": max_err["flash_attention causal=False"],
        **{k: row[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_device_ms")}}
        for row in noncausal_rows]
    # K1's fp32 instance: its launches on the fp32 paths (the equality runs
    # and levers), its rows at ``FP32_FLASH_TIMED`` (the first is the entry's)
    fp32_keys = ("shape", "causal", "window", "ms", "device_ms", "host_ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "library_device_ms")
    fp32_by_path = {m: n["flash_attention"] for m, n in fp32_paths.items()
                    if n.get("flash_attention")}
    kernels.insert(1, {
        "name": "flash_attention fp32 (flash_fwd_simt)", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cuh",
        "library": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": replaces["flash_attention"],
        "launches": sum(fp32_by_path.values()), "launches_by_path": fp32_by_path,
        "max_abs_err": max_err["flash_attention float32"],
        **{k: fp32_rows[0][k] for k in fp32_keys}, "kernel_ms": fp32_rows[0]["ms"],
        "dtype": "float32", "shapes": [{k: r[k] for k in fp32_keys} for r in fp32_rows]})
    # K2 over pages of another dtype, the default mode's cluster (the main
    # paths' fp8 and int8 caches under bf16 weights, at every length), with
    # its rows at the four shapes and the long ones, and its instances of
    # the map over token pairs (" paired": danube_tp8's fp8 cache, one kv
    # head of 120 a rank), with their rows at ``Q8_ODD_KV``; the upcast mode
    # (``decode_unroll``) in its two designs: the cluster (the fp8 serve
    # under ``decode_unroll``), with its rows at ``Q8_UPCAST`` (its paired
    # instances at ``Q8_ODD_KV``'s, which no main path runs), and the split
    # (an fp32 q, fp32 pages under a bf16 q: the equality run's fp32
    # model), timed over fp32 pages
    sources = {"cluster": "src/repro_torch/csrc/paged_cluster.cuh",
               "cluster paired": "src/repro_torch/csrc/paged_cluster.cuh",
               "upcast cluster": "src/repro_torch/csrc/paged_cluster_upcast.cuh",
               "upcast cluster paired": "src/repro_torch/csrc/paged_cluster_upcast.cuh",
               "upcast split": "src/repro_torch/csrc/paged_cvt.cuh"}
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "shape")

    def q8_entry(name, pages, mode, design, rows, launched):
        row = rows[0]   # llama3.2-3b's batch; h2o-danube's one kv head for " paired"
        key = f"{mode} {design}" if mode == "upcast" else design
        counter = "upcast" if mode == "upcast" else "cvt"

        def mine(k):   # "q/pages key": this entry's pages and design
            pair, _, rest = k.partition(" ")
            return _dt(pages) in pair and rest == key
        return {
            "name": name, "route": "cuda", "mode": mode, "design": design,
            "source": sources[key],
            "library": "src/repro_torch/csrc/paged_attention_"
                       + ("upcast.cu" if mode == "upcast" else "cvt.cu"),
            "replaces": replaces["paged_attention"],
            "launches": sum(n[counter].get(i, 0) for n in q8_by_model.values()
                            for i in launched),
            "launches_by_model": {m: sum(n[counter].get(i, 0) for i in launched)
                                  for m, n in q8_by_model.items()},
            "max_abs_err": q8_err[f"bfloat16/{_dt(pages)} {key}"],
            "max_abs_err_by_instance": {k: v for k, v in q8_err.items() if mine(k)},
            # where ``weight_slack`` is 0: no weight lies at a rounding edge
            "max_abs_err_without_slack": {k: v for k, v in q8_exact.items() if mine(k)},
            **{k: row[k] for k in keys}, "kernel_ms": row["ms"], "dtype": "bfloat16",
            "shapes": [{k: r[k] for k in (*keys, "window")} for r in rows]}

    paired_name = ", map over token pairs (D 120 under an odd KV)"
    for pages in (torch.float8_e4m3fn, torch.int8):
        rows = [r for r in q8_rows if r["pages"] == _dt(pages)]
        for mode, design in (("default", "cluster"), ("default", "cluster paired"),
                             ("upcast", "cluster"), ("upcast", "cluster paired")):
            kernels.append(q8_entry(
                f"paged_attention {_dt(pages)} pages"
                + (", upcast (decode_unroll)" if mode == "upcast" else "")
                + (paired_name if design.endswith("paired") else ""), pages, mode, design,
                [r for r in rows if r["mode"] == mode and r["design"] == design],
                [f"bfloat16/{_dt(pages)} {design}"]))
    kernels.append(q8_entry(
        "paged_attention upcast (decode_unroll), split: fp32 pages under a bf16 q, "
        "an fp32 q", torch.float32, "upcast", "split",
        [r for r in q8_rows if r["pages"] == "float32"],
        [f"{q}/{p} split" for q, p in (("bfloat16", "float32"), ("float32", "float8_e4m3fn"),
                                        ("float32", "int8"), ("float32", "bfloat16"))]))
    # K2's sequence split over 8-bit pages (the cluster design), each
    # launch on split_reasoning's path with its row at reasoning lengths'
    # first half (G 16, fp8); the sum is the cvt library's part_sum; the
    # passes' instances of the map over token pairs (no main path's) with
    # their rows at h2o-danube's one kv head a rank
    for suffix, first in (("", split_rows[0]), (" paired", paired_split_rows[0])):
        split_err = q8_err[f"bfloat16/float8_e4m3fn split cluster{suffix}"]
        for name, key, symbol, source, library in (
                ("paged_attention split pass 1 (scores and the share's (m, l))", "pass1",
                 "paged_cvt_share_stats", "src/repro_torch/csrc/paged_split_cluster.cuh",
                 "paged_attention_split.cu"),
                ("paged_attention split pass 2 (the share's rounded weights times v)", "pass2",
                 "paged_cvt_share_values", "src/repro_torch/csrc/paged_split_cluster.cuh",
                 "paged_attention_split.cu"),
                ("paged_attention split sum (the ranks' sums)", "sum", "paged_cvt_sum",
                 "src/repro_torch/csrc/paged_cvt.cuh", "paged_attention_cvt.cu")):
            if suffix and key == "sum":
                continue   # one kernel whatever the map
            inst = f"bfloat16/float8_e4m3fn cluster{suffix}"
            by_rank = {m: n["by_instance"].get(symbol, {}).get(inst, 0) if suffix
                       else n[symbol] for m, n in split_by_rank.items()}
            b_ms, b_by = first["bound_ms"][key], first["bound_by"][key]
            ms, plain_ms = first["ms"][key], first["plain_ms"][key]
            kernels.append({
                "name": name + (paired_name if suffix else ""), "route": "cuda",
                "mode": "default", "design": f"split cluster{suffix}",
                "source": source, "library": f"src/repro_torch/csrc/{library}",
                "replaces": replaces["paged_attention"],
                "launches": sum(by_rank.values()), "launches_by_model": by_rank,
                "max_abs_err": split_err, "ms": ms, "kernel_ms": ms,
                "device_ms": first["device_ms"][key], "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "library_device_ms": None,
                "shape": first["shape"], "dtype": "bfloat16", "pages": first["pages"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
