"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--json PATH]

Phases (each prints its own lines; any failure exits non-zero):

1. device  — a CUDA card is required; prints its name and power limit;
2. build   — compiles the five CUDA sources (unit fold, batched window
             fold, segmented sums, linear scan, flash decode; nvcc,
             sm_90a), one nvcc each, all started together, and the
             feature-hash Triton kernel, from this checkout;
3. kernels — each kernel against its plain PyTorch version on the card,
             at its paths' shapes, and run twice (the two runs must be
             bitwise equal): the unit fold on unpadded rows at the
             serving shapes (B = 256, few-query variant), at the
             consistency replay's U = 1, and at Q = rp offline shapes of
             rp 2,048 (shared-memory variant) to 32,768 (wide
             global-memory variant), bitwise except the EW lanes at
             rtol 1e-5; the feature hash, exact; and, once the serving
             store exists (3b, after phase 4), the batched window fold on
             it (rtol/atol 1e-5, a NaN row that matches no request, a
             +Inf row that request 0 matches) and
             the bucket build over the deployment's action rows
             (rtol 1e-4, NaN prices, out-of-range ids; the segmented-sum
             kernel, its plain version and one ``index_add_`` timed on
             the same prepared inputs at both widths, the kernel's passes
             by name under the profiler); 3c, the model
             kernels at the full hymba-1.5b shapes: the linear scan at
             (8, 1024, 51,200) float32, bitwise, its backward at the
             training micro-batch (2, 2048, 51,200), bitwise, and the
             decode partials
             at B = 8, Hq = 25, Hkv = 5, D = 64 over a bf16 cache of
             2,048 (live ranges from 0 and, as on a sliding-window layer,
             from lo > 0), at the D = 128 decode shapes of
             qwen2-moe-a2.7b (Hq = Hkv = 16), dbrx-132b (Hq 48, Hkv 8;
             its weights do not fit the card) and llava-next-34b (Hq 56,
             Hkv 8) and the head groups of phase 4o's four entries
             (llama3-8b Hq 8 / Hkv 2, dbrx-132b Hq 12 / Hkv 2) over
             float32 and bf16 caches, and at whisper-tiny's
             (Hq = Hkv = 6, D = 64), rtol 1e-4 / atol 1e-5, timed warm
             (one cache) and
             cold in L2 (a rotation of eight caches), beside one
             ``scaled_dot_product_attention`` call; and at phase 4m's
             llama3-8b decode_32k shape (B 8, Hq 32, Hkv 8, D 128, a bf16
             cache of 32,768 with 32,000 live keys) over the whole range
             (beside SDPA), over one sequence shard's piece (a contiguous
             chunk of 8,192 positions, all live), and over a dead
             shard's one key of its piece;
4. main paths, each with the launch counts set to 0 just before it and
             read just after, at deployment size (1.5 M rows; run in
             the order a, b, e, f, g, h, m, i, c, d, j, k, l, o, n):
   a. serving — ``FeatureEngine`` (capacity 1.6 M) bulk load + 4,096 live
             rows, ``request_batch`` at B = 1, 64, 256; the B = 64 batch
             must equal a CPU engine (plain versions) on a copy of the
             store;
   b. offline — ``FeatureEngine.offline()`` over the deployment tables,
             equal to the same call with the plain fold on the card
             (``unit_fold_kernel=False``); the same on a skewed (zipf 1.1)
             variant, whose hot keys' units take the wide variant; then
             ``verify_consistency(bitwise=True)`` on the card over a
             prefix of the tables (every base row replayed as a request);
   e. staged fold — ``FeatureEngine(fused_fold=False)`` on a copy of
             4a's store: ``request_batch`` at B = 1, 64, 256 and
             ``request`` equal 4a's fused features (bitwise, ew at rtol
             1e-5), staged ``offline()`` equals 4b's, and the seed
             baseline (``run_reference_serial``) equals it (counts,
             min/max, hash bitwise; sums within a float32 bound of the
             key history's prefix; the rest at rtol 1e-4 / atol 1e-3)
             and its own CPU run; timed;
   f. long windows — ``LONG_SQL`` (``OPTIONS(long_windows="wl:60s")``)
             over 1.5 M rows of 32 keys, ``use_preagg=True``: bulk load
             and ``ingest_many`` maintain the bucket planes (checked
             against the same folds alone, timed), ``request_batch`` at
             B = 1, 64, 256 equals a CPU engine on copies of the store
             and planes (bitwise, drawdown and EW at rtol 1e-5) and the
             first request equals ``offline()`` over its history; then
             ``verify_consistency(use_preagg=True)`` over every 1200th
             row, the columns the port's certificate classes bitwise
             (which must equal the reference certifier's) bitwise;
   g. serving loop — a retention engine (``retention="auto"``,
             ``compact_every=256``: orders keep 60 s, actions all) with
             both tables bulk-loaded below one time cut and the rows
             after it streamed in ts order: (a) a snapshot serves B = 64
             byte-identically across an ``ingest_many`` that compacts
             orders to its last 60 s, and after ``refresh()`` equals
             a CPU engine on copies of the store and, within the prefix
             bound on the sums, a card engine without retention; (b)
             ``ServeLoop`` under ``SystemClock``: 1,000 open-loop Poisson
             arrivals through a deadline and a count-only loop, then 100
             waves of 64 requests + 64 streamed rows (TP50/99/999,
             resident rows and binlog bounded, one flush's launches and
             busy share); (c) a trace recorded on a CPU engine replays on
             the card with equal bytes and final store; (d)
             ``record_consistency_trace`` over a prefix (integer prices,
             mid-trace eviction) holds ``verify_consistency(bitwise=
             True)`` and replays bitwise;
   h. sharded serving with replicas — the serving deployment over 8 key
             shards with 2 followers each (OpenMLDB's default
             PARTITIONNUM 8, REPLICANUM 3), ``route_slots=1024``,
             ``ship_every=64``, per-shard capacity from the host routing:
             bulk load below 4g's cut, the rest streamed through
             ``ingest_many`` with the hottest key's shard killed halfway
             and healed a quarter later (lag at the kill,
             ``recovery_s``); B = 1, 64, 256 equal to 4a's features
             (bitwise, ew at rtol 1e-5) with 4a's unit-fold and hash
             launches; latency, kernels per batch and busy share beside
             4a's engine, in turns; ``offline_sharded`` bitwise 4b's
             ``offline()``; a rebalance of 4b's zipf tables (rows moved,
             seconds, imbalance before and after, features unchanged);
             ``verify_consistency(bitwise=True, n_shards=8,
             replication=2, kill_shard_at=k)`` over a 2,000-row prefix;
             ``LONG_SQL`` on 8-shard pre-agg planes, B = 64 against 4f;
   m. device mesh — (a) 4h's deployment on a ``Mesh`` of 8 entries
             that all name the card (one shard's state per entry; tables
             and followers checked on their entries): bulk load, the rest
             in 64-row ``ingest_many`` calls per table, B = 1, 64, 256
             equal to 4h's stacked engine (bitwise, ew at rtol 1e-5),
             launches per batch and p50 / p99 beside 4h's in turns,
             ``offline()`` bitwise 4b's, a kill + heal of the hottest
             key's shard (features bitwise before and after,
             ``recovery_s``), ``verify_consistency(bitwise=True,
             mesh=...)`` with a failover over 4h's 2,000-row prefix,
             ``key_shard_mesh()`` over the visible cards against 4a (and
             with two or more cards the 8-shard deployment over them);
             (b) llama3-8b (8.03 G seeded random params) at full width
             and depth against decode_32k's 32,768-position cache filled
             from the seed to 32,000 (no prefill), the cache in pieces
             (``distributed.sharding.device_put`` of a ``meta`` state:
             one contiguous tensor per ("data", "model") mesh entry,
             allocated entry by entry; the bytes each entry holds equal
             to ``per_device_bytes``) on entries that name the card:
             float32 at B = 2 on (1, 4) and (2, 2) meshes, four steps
             through the kernel (entries x 32 launches a token) within
             rtol/atol 2e-4 of the unsharded decode and of the pieces
             through the plain versions; bf16 at B = 8 (decode_32k's
             128, cut to fit the card) on (1, 4), per-token p50 / p99 of
             pieces and unsharded in turns, each turn on a state of its
             own, launches, busy share, peak memory; (d) with two or
             more cards visible, the same over (1, n) distinct cards,
             n = 4 (2 where 2 or 3 are visible): the f32 check, the
             bytes per card, bf16
             at B = 8 n (with four cards a 137.6-GB cache); with one
             card, one line saying (d) did not run;
   i. certifier, preview, pipeline, row format — ``certify`` of the
             smoke script over 4b's gate prefix (its bitwise columns all
             matched by 4b's card gate) and over the 1.5 M rows (C-BUF
             there), of ``LONG_SQL`` in 4f; ``memory_bound`` equal to the
             card store's and 4f's planes' nbytes; ``explain_sharding``
             equal to ``sharded_eligible``; ``preview`` on the card at
             1,000 and 100,000 rows per table (bitwise ``offline()`` on
             the same tail slice, a cached second call that launches
             nothing, cold p50 over 10 calls, a script over the limits
             that launches nothing); ``FeatureDataPipeline`` over the 1.5
             M rows (``materialize()`` bitwise 4b's ``offline()``, 100
             batches of 256 on the card, each the matrix rows at the
             seeded indices); 100,000 action rows through the compact
             codec on the host, and the §7.1 example (255 B against
             Spark's 556);
   c. additive folds — ``store_windowfold`` on the serving store at
             B = 1, 64, 256 and ``bucket_build`` over the action rows;
   d. model serving — hymba-1.5b at full width and depth (random
             weights from a seeded ``torch.Generator``), ``ServingEngine``
             with B = 8 prompts of 1,024 tokens, ``max_len`` 2,048,
             ``generate_greedy`` 32 tokens: in float32 through the
             kernels, then teacher-forced through the kernels and the
             plain versions (prefill and every step's logits within
             rtol/atol 1e-3); then in bf16, timed (prefill, decode per
             token, tokens/s, device busy share under the profiler);
   j. model training — hymba-1.5b at full width and depth (seeded
             random f32 master weights, AdamW), bf16 compute, batch 8 x
             2,048 ``TokenPipeline`` tokens (past the 1,024-token window)
             in 4 microbatches: one step's loss and every gradient leaf
             through the kernels equal to the plain versions (bitwise,
             or within two plain runs' spread if another op is not
             deterministic); then the first 4 steps of an 8-step
             schedule through ``build_train_step``: the first loss
             within 1 nat of ln(vocab), the last below it,
             256 ``linear_scan`` and 128 ``linear_scan_bwd`` launches
             per step; step ms p50, tokens/s, peak memory, busy share;
             then the data-parallel step (``dp_axes=("data",)``) at 4
             layers on a (2, 1) mesh of the card: f32 against the
             one-device step (loss rtol 1e-5, params at
             ``tests/test_torch_train.py``'s bars, twice the scan
             launches), bf16 step p50 beside the one-device step's;
   k. MoE and MLA families — (a) qwen2-moe-a2.7b at full width and depth
             (64 allocated experts, 15.15 G seeded random params), phase
             4d's prompts and cache: in float32 ``generate_greedy`` of
             four tokens through the kernels (exactly 24 x 4
             ``decode_partials`` launches), then teacher-forced through
             the kernels and the plain versions (logits within rtol/atol
             1e-3, argmax the generated tokens); the f32 weights freed
             and the bf16 ones drawn anew from the same seed (the bits of
             the f32 draw cast), timed as in 4d over 16 tokens with the
             peak memory; (b) minicpm3-4b at full width and depth (no
             ported kernel on its path, none launched): the absorbed
             decode's logits at each of four steps equal to a prefill
             over the prompt plus those tokens (float32, within 1e-3),
             then bf16 timed; (c) one
             train step of each at full width and 4 layers (bf16
             compute, f32 master weights and AdamW, batch 2 x 1,024):
             first loss within 1 nat of ln(vocab), gradient norm finite,
             time and peak memory;
   l. VLM, audio and RWKV6 families — seeded bf16 patch and frame
             embeddings stand in for the frontends, as in the reference:
             (a) llava-next-34b (34.39 G params) with B = 2 prompts of
             576 patches + 1,024 tokens: in float32 at 8 of its 60
             layers, ``generate_greedy`` of four tokens through the
             kernels (8 x 4 ``decode_partials`` launches), teacher-forced
             through the kernels and the plain versions (within 1e-3);
             then at full depth in bf16 (the bits of the f32 draw cast),
             timed as in 4d over 16 tokens, 60 launches per token; (b)
             whisper-tiny at full width and depth, 8 utterances of 1,500
             frames, decoder prompts of 224 tokens, ``max_len`` 448:
             the same two checks, 4 launches per token; (c) rwkv6-7b at full width and depth
             (no ported kernel on its path, none launched), 8 prompts
             of 256 tokens: each of four f32 decode steps' logits equal
             to a prefill over the prompt plus those tokens (within
             1e-3), then bf16 timed, and a prefill of 128 tokens profiled (the
             WKV loop's launches and busy share); (d) one train step of
             each at full width and 4 layers, batch 2 x 1,024 positions:
             the first loss within 1 nat of ln(vocab) + s^2 / 2, s = 0.02
             sqrt(d_model) (random logits' logsumexp), gradients finite;
   o. weights in pieces — a parameter tree placed by ``param_pspecs(...,
             strategy="megatron")`` on a (1, 4) mesh (attention heads,
             MLP widths, experts and the vocabulary split four ways),
             served as it is by ``ServingEngine``: (a) on entries that
             all name the card, in float32 at full width, llama3-8b cut
             to 4 layers and dbrx-132b to 2 (two copies of its 31-GB
             tree on the card), B = 2 prompts of 128 tokens and four
             greedy tokens through the kernels (4 entries x layers x 4
             ``decode_partials`` launches, each on its head group),
             teacher-forced logits within 2e-4 of the unsharded model
             and of the pieces through the plain versions, the bytes
             each entry holds equal to ``per_device_bytes``; then
             llama3-8b at full width and depth in bf16, prefill 8 x 1,024
             and 32 tokens, pieces and unsharded in turns (per-token p50
             / p99, launches, busy share, peak memory); (b) where four
             cards are visible, the two f32 checks over four distinct
             cards, then dbrx-132b at full width and depth in bf16 over
             them (131.6 G params drawn piece by piece on each card,
             ~65.8 GB a card): prefill 8 x 1,024, 32 greedy tokens,
             finite logits, 160 ``decode_partials`` launches a token,
             40 on each card; one line saying (b) did not run elsewhere;
   p. training on weights in pieces — the reference's train cell
             (``launch/dryrun.py``): ``TrainState(step=P(),
             params=p_specs, mu=p_specs, nu=p_specs, compress_err=P())``,
             ``p_specs = param_pspecs(..., strategy="megatron")``, placed
             by ``device_put`` and stepped by ``build_train_step(...,
             dp_axes=("data",), mesh=mesh)`` as it is: (a) on entries
             that all name the card, in float32 at full width and 2
             layers, B = 4 x 128 in 2 microbatches: llama3-8b and
             hymba-1.5b on (1, 4) and (2, 2) (two data blocks, each on
             its row's pieces), qwen2-moe-a2.7b on (1, 4); a step from
             the initial state and a step from the whole route's state
             after it, each against the whole tree's step on the card
             (loss and grad norm at rtol 1e-4, params / mu / nu at
             ``tests/test_torch_train.py``'s bars, phase 4j's optimizer;
             the first step's gradients leaf by leaf within 1e-4 of the
             leaf's max |g|), the first step run
             twice from the same state (bitwise equal), bytes per entry
             equal to ``per_device_bytes`` before and after, replicas
             bitwise equal, hymba's SSM (gathered per layer) launching
             ``linear_scan`` / ``linear_scan_bwd`` 2 / 1 times per
             layer, microbatch and data block; then llama3-8b in bf16 at
             4 layers, 8 x 1,024 in 4 microbatches, the whole tree's
             step and the pieces' on (1, 4) timed with CUDA events one
             after the other (their states do not fit together); (b)
             where four cards are visible, llama3-8b at full width and
             depth (8.03 G params drawn piece by piece on each card, f32
             master state and AdamW moments in pieces, bf16 compute)
             over (1, 4) distinct cards, train_4k's 4,096 tokens at
             batch 8 in 4 microbatches, 3 steps: finite losses, the
             first within 1 nat of ln(vocab), per card the bytes (=
             ``per_device_bytes``), peak memory, launches and busy
             share, the step p50; one line saying (b) did not run
             elsewhere;
   n. entry points and step rooflines — (a) the port's CI gates
             (``tools/torch_check_consistency.py --bitwise 4``,
             ``torch_check_replay.py``, ``torch_check_recovery.py 4``)
             return 0 on the card, the fused raw gate launching the unit
             fold in its online replay and its offline side, and the three
             examples (``examples/torch_*.py``) run to their end: wall
             time and kernel launches by name (the wrappers' counts);
             the quickstart once more under the profiler, its launches
             equal to the wrappers' counts but for the GPU records
             kineto reports having dropped out of its capture window;
             (b) one call of four full-width steps
             counted by ``roofline.analyze_step`` on the models that 4d, 4j
             and 4m build (hymba-1.5b bf16 prefill 8 x 1,024 and a decode
             token, its train step 8 x 2,048 in 4 microbatches, the
             llama3-8b decode_32k token unsharded), each against its
             phase's time: FLOPs and bytes, TFLOP/s and TB/s, the share
             of the binding H100 peak, ``model_flops``' useful ratio;
             the same step counted on ``meta`` (the train step: one
             microbatch times 4, plus the update) gives the same FLOPs
             and kernel records, and each kernel's cost records equal
             its profiler launches, as in (a);
             (c) ``launch.dryrun.dryrun_cell("llama3-8b", "decode_32k")``
             on the host;
5. times   — request latency percentiles, offline wall and device time,
             and each kernel's time beside its bound, its plain version's
             time and, where one exists, one PyTorch call's (CUDA events).

The second-to-last line is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  With ``--json PATH`` a
copy of all results (latencies, profiles, per-shape kernel times) is
written to PATH.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import itertools
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# phase 4n: the profiler's CUPTI side (kineto) drops the GPU records
# whose timestamps fall outside its capture window and counts them only
# in an INFO line of its log ("Record counts: Out-of-range = N"); its log
# level is read once, when it starts
os.environ.setdefault("KINETO_LOG_LEVEL", "0")

import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
_T0 = time.perf_counter()          # phase headers: seconds since start

SMOKE_SQL = """
SELECT
  sum(price) OVER w AS s, avg(price) OVER w AS a,
  count(price) OVER w AS c, min(price) OVER w AS mn,
  max(price) OVER w AS mx,
  distinct_count(category) OVER w AS dc,
  drawdown(price) OVER wr AS dd,
  ew_avg(price, 0.5) OVER wr AS ew,
  discrete(category, 1048576) AS cat_h
FROM actions
WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW),
  wr AS (PARTITION BY userid ORDER BY ts
         ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""

DEPLOYMENT = dict(n_actions=1_000_000, n_orders=500_000, n_users=100,
                  horizon_ms=36_000_000, seed=0, with_profile=False)
CAPACITY = 1_600_000
N_LIVE = 4096
BATCHES = (1, 64, 256)
N_LATENCY = 200                    # timed batches per B (p99 = 2nd largest)
SKEW_ALPHA = 1.1                   # zipf skew of the offline variant
CONSISTENCY_ROWS = 5_000           # replayed rows (one request per base row)
WINDOW_MS = 60_000                 # additive folds' request frame
BUCKETS = ((60_000, 600), (1_000, 36_000))   # bucket_build (ms, buckets)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
EW_RTOL = 1e-5                     # 1-ulp expf differences carried by a fold
MODEL_ARCH = "hymba-1.5b"          # model serving (phase 4d), full size
MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN, MODEL_TOKENS = 8, 1024, 2048, 32
MODEL_TOL = 1e-3                   # f32 logits, kernels vs plain versions
# phase 4k: the MoE and MLA families at full width (depth too, except
# the train step: minicpm3-4b's f32 master weights and AdamW alone would
# take ~68 GB), seeded random weights, phase 4d's prompts and cache
MOE_ARCH, MLA_ARCH = "qwen2-moe-a2.7b", "minicpm3-4b"
FAMILY_TOKENS = 4                  # f32 checks: decode steps
FAMILY_BF16_TOKENS = 16            # bf16 timings: decode steps (4k, 4l)
FAMILY_TRAIN_LAYERS = 4
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 2, 1024
# phase 4l: the VLM, audio and RWKV6 families at full width.  llava's
# 68.8 GB of bf16 weights leave room for a batch of 2 (B = 8 would add
# the f32 chunked attention's temporaries past 80 GB), and its f32 check
# runs 8 of 60 layers (21.5 GB; 137 GB at full depth); whisper's decoder
# context is 448 tokens; rwkv6-7b's prompts are RWKV_PROMPT tokens (its
# WKV loop runs token by token, four launches a layer and token) and its
# prefill is profiled over the first 128 (the loop costs the same at
# every step)
VLM_ARCH, AUDIO_ARCH, RWKV_ARCH = "llava-next-34b", "whisper-tiny", "rwkv6-7b"
VLM_BATCH, VLM_F32_LAYERS = 2, 8
AUDIO_PROMPT, AUDIO_MAX_LEN = 224, 448
RWKV_PROMPT, RWKV_PROFILE_TOKENS = 256, 128
# phase 3c: decode_partials also at the decode shapes (Hq, Hkv, D) of
# qwen2-moe-a2.7b (phase 4k), dbrx-132b (263 GB of bf16 weights: it does
# not fit the card, so only its attention shape is run), llava-next-34b
# and whisper-tiny (phase 4l)
DECODE_SHAPES = {"qwen2-moe-a2.7b": (16, 16, 128), "dbrx-132b": (48, 8, 128),
                 "llava-next-34b": (56, 8, 128), "whisper-tiny": (6, 6, 64),
                 # one card's head group of phase 4o's (1, 4) pieces
                 "llama3-8b/4": (8, 2, 128), "dbrx-132b/4": (12, 2, 128)}
# phase 4j: training hymba-1.5b at full width and depth; the sequence is
# longer than its 1,024-token window, so the sliding-window layers mask
# (the first TRAIN_STEPS steps of an 8-step schedule)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 2048, 4, 4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
# the first loss within 1 nat of ln(vocab): untied random logits of
# std 0.02 * sqrt(d_model) = 0.8 add ~0.32 nats to the uniform loss
TRAIN_LOSS_TOL = 1.0
# phase 4j's data-parallel step: hymba-1.5b at full width and DP_LAYERS
# layers, the same batch, on a (DP_BLOCKS, 1) ("data", "model") mesh of
# the card; f32 against the one-device step (loss at DP_LOSS_RTOL, the
# params at tests/test_torch_train.py's bars), then bf16 timed in turns
DP_LAYERS, DP_BLOCKS, DP_STEPS = 4, 2, 3
DP_LOSS_RTOL = 1e-5
DECODE_LIVE = (1025, 1056)         # decode live lengths at positions 1,024+
DECODE_COLD = 8                    # caches rotated for the cold-L2 times
STAGED_REPS = 50                   # timed batches per B, phases 4e and 4f
SEED_TOL = dict(rtol=1e-4, atol=1e-3)   # reduction-order bar (reference)
# the seed baseline sums a window as the difference of two float32
# prefixes over the key's whole history, so its error scales with that
# history's magnitude S, not with the window's value: |diff| <= atol +
# SEED_PREFIX_ULPS * 2^-24 * S for the additive columns
SEED_PREFIX_ULPS = 16
SEED_ADDITIVE = ("s", "a")

# phase 4f: the serving deployment's rows and horizon with 32 keys, the
# most an integer key without a dictionary gets planes for (rule
# C-KEYCARD: the compile-time cardinality is 32), and a long window
LONG_SQL = """
SELECT
  sum(price) OVER wl AS s_l, count(price) OVER wl AS c_l,
  min(price) OVER wl AS mn_l, max(price) OVER wl AS mx_l,
  distinct_count(category) OVER wl AS dc_l,
  drawdown(price) OVER wl AS dd_l, ew_avg(price, 0.5) OVER wl AS ew_l,
  sum(price) OVER w AS s, count(price) OVER w AS c,
  discrete(category, 1048576) AS cat_h
FROM actions
WINDOW wl AS (UNION orders PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 36000s PRECEDING AND CURRENT ROW),
       w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "wl:60s")
"""
DEPLOYMENT_LONG = dict(n_actions=1_000_000, n_orders=500_000, n_users=32,
                       horizon_ms=36_000_000, seed=0, with_profile=False)
# (keys, fine slots, coarse slots, max_coarse_q, max_bucket_rows): what
# the reference builds for LONG_SQL
LONG_PLANES = (32, 632, 41, 39, 128)
LONG_LOOSE = ("dd_l", "ew_l")      # card vs CPU: rtol 1e-5 (EW, drawdown)
LONG_EXACT_OFFLINE = ("c_l", "mn_l", "mx_l", "dc_l")
GATE_STRIDE = 1200                 # the pre-agg gate replays every 1200th row
# the columns the pre-agg gate holds bitwise come from the port's
# certificate of LONG_SQL over the thinned tables (no C-BUF,
# C-PREAGG-EDGE or C-KEYCARD there); this is the class the reference's
# certifier gives them, which the derived list must equal; the other
# columns take the reference's tolerance
GATE_BITWISE = ("c_l", "mn_l", "mx_l", "dc_l", "s", "c", "cat_h")

# phase 4g: the serving loop over the serving deployment with retention.
# Both tables are bulk-loaded below one time cut (8,448 action rows
# before the end) and the rows after it stream in ts order.
LOOP_STREAM = 2 * N_LIVE + max(BATCHES)   # action rows after the cut
COMPACT_EVERY = 256
RETAINED = {"actions": None, "orders": WINDOW_MS}   # wr is a ROWS frame
SNAP_ROWS = 1024           # (a) streamed rows: at least one orders tick
LOOP_BATCH, LOOP_WAIT_MS, LOOP_SLO_MS = 64, 5.0, 25.0
LOOP_SPARSE = 1000         # (b) open-loop requests per batching policy
LOOP_WAVES = 100           # (b) closed loop: waves of 64 requests + 64 rows
TRACE_HISTORY_MS = 20 * 60_000   # (c) history the trace's engines load
TRACE_CAPACITY = 65_536
TRACE_ROWS = 1_600         # (c) streamed rows: two orders ticks or more
GATE_LOOP_ROWS = 3_000     # (d) prefix events; past 60 s, so rows evict
GATE_LOOP_COMPACT = 64

# phase 4h: the serving deployment key-sharded with replicas, as OpenMLDB
# deploys a table by default (PARTITIONNUM 8, REPLICANUM 3: a leader and
# two followers); the same cut and stream as phase 4g
SHARDS, REPLICAS, ROUTE_SLOTS, SHIP_EVERY = 8, 2, 1024, 64
SHARD_HEADROOM = 4096      # rows per shard above the routed rows
SHARD_REPS = 50            # timed batches per B and engine, in turns
SHARD_GATE_ROWS = 2_000    # the failover gate's prefix events

# phase 4m: the device mesh.  (a) 4h's deployment on a Mesh of SHARDS
# entries that all name the card (one shard's state per entry); (b)
# llama3-8b at full width and depth decoding against decode_32k's cache
# of 32,768 positions, every sequence filled from the seed to MESH_LIVE
# (no prefill), sequence-sharded over a (1, MESH_SEQ_SHARDS) ("data",
# "model") mesh of the card; decode_32k's batch of 128 is cut to
# MESH_BATCH (bf16: 34.4 GB of cache + 16.1 GB of weights) and to
# MESH_F32_BATCH for the float32 check (~49 GB)
MESH_ARCH = "llama3-8b"
MESH_SEQ, MESH_LIVE, MESH_SEQ_SHARDS = 32_768, 32_000, 4
MESH_BATCH, MESH_F32_BATCH = 8, 2
MESH_STEPS = 4             # float32 check: decode steps per route
MESH_TOKENS = 16           # bf16: timed tokens per route, in two turns
MESH_TOL = 2e-4            # the reference's bar (tests/test_sharded_decode)
# phase 4o: weights in pieces, param_pspecs(strategy="megatron") on a
# (1, 4) ("data", "model") mesh.  float32 checks at full width, depth
# cut (dbrx-132b's 2 layers are 31 GB a copy; the check holds two), B =
# 2 x 128 prompt tokens and 4 greedy tokens; bf16 timing of llama3-8b at
# full width and depth, 8 x 1,024 and 32 tokens in turns; over four
# cards, dbrx-132b at full width and depth in bf16, the same prompts
PIECES_N = 4
PIECES_TOL = 2e-4
PIECES_F32 = {"llama3-8b": 4, "dbrx-132b": 2}      # arch: layers kept
PIECES_F32_BATCH, PIECES_F32_PROMPT, PIECES_F32_TOKENS = 2, 128, 4
PIECES_ARCH, PIECES_BIG = "llama3-8b", "dbrx-132b"
PIECES_BATCH, PIECES_PROMPT, PIECES_TOKENS = 8, 1024, 32
# phase 4p: training on weights in pieces, megatron.  (a) float32 checks
# at full width cut to TP_LAYERS layers on the meshes of TP_CHECKS (two
# MoE data blocks raise), TP_BATCH x TP_SEQ in TP_MICRO microbatches (4
# rows, so that (2, 2)'s two data blocks each take a row of both
# microbatches); llama3-8b's bf16 step timed at TP_TIME_LAYERS layers,
# TP_TIME_BATCH x TP_TIME_SEQ in TP_TIME_MICRO microbatches; (b) four
# cards: llama3-8b at full size, train_4k's sequence, batch 256 cut to
# TP4_BATCH
TP_CHECKS = {"llama3-8b": ((1, 4), (2, 2)), "qwen2-moe-a2.7b": ((1, 4),),
             "hymba-1.5b": ((1, 4), (2, 2))}
TP_LAYERS, TP_BATCH, TP_SEQ, TP_MICRO = 2, 4, 128, 2
TP_RTOL = 1e-4
# the gradients of the first step, pieces against whole, leaf by leaf:
# max |diff| within TP_GRAD_TOL of the leaf's max |g| (f32 rounding of
# reordered sums).  The optimizer is phase 4j's, TRAIN_OPT: at full
# width the clip scales the gradients by 0.06-0.12, Adam's first step
# lr g / (|g| + eps) turns the rounding of an element whose clipped |g|
# is near eps into a share of lr, and _close_params allows that on 0.1%
# of a leaf (at lr 1e-2, 0.11% of llama3-8b's layer-0 wq)
TP_GRAD_TOL = 1e-4
TP_TIME_LAYERS, TP_TIME_STEPS = 4, 3
TP_TIME_BATCH, TP_TIME_SEQ, TP_TIME_MICRO = 8, 1024, 4
TP4_SEQ, TP4_BATCH, TP4_MICRO, TP4_STEPS = 4096, 8, 4, 3

# phase 4n: the CUDA function (or Triton kernel) that every launch of a
# port kernel runs once, so that its profiler events count the launches
LAUNCH_EVENTS = {"unit_fold": ("uf_few_kernel", "uf_many_kernel"),
                 "feature_hash": ("_hash_kernel",),
                 "batch_windowfold": ("bwf_stats_kernel",),
                 "segagg": ("segagg_hist_kernel",),
                 "linear_scan": ("linear_scan_kernel",),
                 "linear_scan_bwd": ("linear_scan_bwd_kernel",),
                 "decode_partials": ("decode_split_kernel",)}
# the examples' checkpoints (a listed directory of the checkout)
EXAMPLE_CKPT = ROOT / "build" / "chip_smoke" / "torch_offline_demo"

# phase 4i: preview at the default budget (1,000 rows per table) and at
# PREVIEW_ROWS, cold wall p50 over PREVIEW_REPS calls; the training-data
# pipeline's batches; rows through the compact codec
PREVIEW_ROWS, PREVIEW_REPS = 100_000, 10
PIPE_BATCH, PIPE_BATCHES = 256, 100
ROWFMT_ROWS = 100_000


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"== {name}  (at {time.perf_counter() - _T0:.1f} s)")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back runs.

    A wrapper's host work (Python, checks, launches) can take longer than
    its kernels, and then events around a loop time the host.  So the
    stream is first held by a spin kernel (``torch.cuda._sleep``) long
    enough for the host to enqueue all ``reps`` runs; the events then
    bracket device work only."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float = 0.0, atol: float = 1e-6) -> float:
    """Exact (rtol 0) or relative comparison, NaN (NULL) only where the
    plain version has NaN; returns max |diff| over the other entries.
    Computed on ``got``'s device (phase 3c's scans hold ~420 M elements:
    a host copy in float64 took tens of seconds)."""
    got, want = got.detach(), want.detach().to(got.device)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = (got.double() - want.double()).abs().nan_to_num(nan=0.0)
    err = float(diff.max()) if got.numel() else 0.0
    if rtol == 0.0:
        nan = got.isnan()
        ok = torch.equal(nan, want.isnan()) and torch.equal(got[~nan],
                                                            want[~nan])
    else:
        ok = torch.allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    if not ok:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max abs err {err}, rtol {rtol})")
    return err


def same_bits(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Two runs of one kernel on the same inputs: the same bits (NaN at
    the same places)."""
    if not (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num())):
        raise AssertionError(f"{name}: two runs differ")


def bound(cost):
    """The least time of a kernel call (ms, and what sets it): its
    ``ops.cost`` bytes over the memory rate against its operations over
    the float32 rate."""
    t_bytes = cost.nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cost.ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2


def build_all(dev):
    """One nvcc per CUDA source, all started together, beside the Triton
    JIT; returns {source name: seconds}."""
    from repro_torch.kernels import build
    from repro_torch.kernels.batch_windowfold.kernel import SOURCE as BWF
    from repro_torch.kernels.chunked_scan.kernel import SOURCE as LS
    from repro_torch.kernels.feature_hash.kernel import feature_hash_triton
    from repro_torch.kernels.flash_decode.kernel import SOURCE as FD
    from repro_torch.kernels.segagg.kernel import SOURCE as SEG
    from repro_torch.kernels.unit_fold.kernel import SOURCE as UF

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    def triton_jit():
        feature_hash_triton(torch.zeros(8, dtype=torch.int32, device=dev),
                            1024)
        torch.cuda.synchronize()

    sources = (UF, BWF, SEG, LS, FD)
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        jobs = {src.name: pool.submit(timed, build.load_library, src)
                for src in sources}
        jobs["triton feature_hash"] = pool.submit(timed, triton_jit)
        took = {name: job.result() for name, job in jobs.items()}
    for src in sources:
        lib = build.library_path(src)
        log(f"built {lib.name} in {took[src.name]:.1f} s")
        log_path = lib.with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas: {line.strip()}")
    log(f"Triton feature_hash JIT in {took['triton feature_hash']:.1f} s")
    return took


# ---------------------------------------------------------------- phase 3


def fold_block(members, u: int, r: int, nq: int, seed: int, dev):
    """A (U, R) block of gathered units for one window group, lifted as
    the serving path lifts it (unpadded: the kernel makes the identity
    rows past R itself): sorted timestamps with INT_MAX in invalid
    slots, a valid prefix per unit, queries at the last valid row
    (nq = 1) or every row (nq = R).  Every fourth unit holds one NULL
    (NaN) price, at its last valid row in every other such unit,
    elsewhere at random: min/max/drawdown must propagate it (a U = 1
    block: its unit holds the NULL)."""
    from repro_torch.kernels.unit_fold import ops, ref
    from repro_torch.core.lowering.windows import (group_leaf_set,
                                                   unique_leaves)

    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 600_000, (u, r)), axis=1).astype(np.int32)
    n_valid = rng.integers(1, r + 1, u)
    valid = np.arange(r)[None, :] < n_valid[:, None]
    ts = np.where(valid, ts, ref.INT_MAX).astype(np.int32)
    price = rng.uniform(1, 100, (u, r)).astype(np.float32)
    nan_units = np.arange(0, u, 4)
    nan_rows = rng.integers(0, n_valid[nan_units])
    nan_rows[::2] = n_valid[nan_units][::2] - 1
    price[nan_units, nan_rows] = np.nan
    env = {"ts": torch.tensor(ts, device=dev),
           "price": torch.tensor(price, device=dev),
           "category": torch.tensor(rng.integers(0, 8, (u, r)),
                                    dtype=torch.float32, device=dev),
           "__valid__": torch.tensor(valid, device=dev)}
    if nq == 1:
        q = torch.tensor(n_valid - 1, dtype=torch.int32, device=dev)[:, None]
    else:
        q = torch.arange(r, dtype=torch.int32, device=dev).expand(u, r)
    plan, idents = ops.plan_for(
        [m.node.spec for m in members], group_leaf_set(members), "ts",
        [tuple(unique_leaves(m.aggs)) for m in members], device=dev)
    data = [ref.lift_group(g, env, (u, r)).contiguous() for g in plan.groups]
    return plan, idents, data, env["ts"].contiguous(), q.contiguous()


def check_unit_fold(name, block, reps):
    """The kernel on the unpadded block against the plain version on the
    block padded to rp (``ops.pad_rows``, timed with it): bitwise except
    EW at rtol 1e-5, two runs bitwise, NaN folds at the same places."""
    from repro_torch.kernels.unit_fold import ops
    from repro_torch.kernels.unit_fold.kernel import unit_fold_cuda, variant
    from repro_torch.kernels.unit_fold.ref import unit_fold_plain

    plan, idents, data, ts, q = block
    u, r = ts.shape
    kind = variant(plan, r, q.shape[1])

    def plain():
        pdata, pts = ops.pad_rows(idents, data, ts)
        return unit_fold_plain(plan, pdata, idents, pts, q, r)

    got = unit_fold_cuda(plan, data, idents, ts, q)
    again = unit_fold_cuda(plan, data, idents, ts, q)
    torch.cuda.synchronize()
    want = plain()
    err, nulls = 0.0, {}
    for g, a, b, c in zip(plan.groups, got, want, again):
        same_bits(f"unit_fold[{name}/{g.family}]", a, c)
        rtol = EW_RTOL if g.family == "ew" else 0.0
        err = max(err, compare(f"unit_fold[{name}/{g.family}]", a, b, rtol))
        nulls[g.family] = int(a.isnan().sum())
    if not all(nulls.values()):
        raise AssertionError(f"unit_fold[{name}]: a group folded no NULL "
                             f"row ({nulls} NaN folds per family)")
    log(f"unit_fold[{name}] {kind} variant; NaN (NULL) folds per family, "
        f"equal to the plain version's: {nulls}; two runs equal")
    ms = cuda_ms(lambda: unit_fold_cuda(plan, data, idents, ts, q), reps)
    plain_ms = cuda_ms(plain, 2)
    rp = max(2, 1 << (r - 1).bit_length())
    # the bound counts the R real rows the fold needs; the identity rows
    # that pad each unit to rp are the plain layout's cost, shown beside it
    b_ms, b_by = bound(ops.cost(plan, u, r, q.shape[1]))
    padded_ms, _ = bound(ops.cost(plan, u, rp, q.shape[1]))
    widths = [f"{g.family}:{g.kind}:{g.width}" for g in plan.groups]
    log(f"unit_fold[{name}] U={u} R={r} rp={rp} Q={q.shape[1]} "
        f"groups={widths} max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}; "
        f"{padded_ms:.5f} over rows padded to rp)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "variant": kind,
            "bound_ms_padded_rows": padded_ms}


def check_feature_hash(dev, reps):
    from repro_torch.kernels.feature_hash.kernel import feature_hash_triton
    from repro_torch.kernels.feature_hash.ops import cost
    from repro_torch.kernels.feature_hash.ref import feature_hash_ref

    rng = np.random.default_rng(7)
    codes = rng.integers(-2**31, 2**31, 1 << 20, dtype=np.int64)
    codes[:4] = [0, -1, 2**31 - 1, -2**31]
    codes = torch.tensor(codes.astype(np.int32), device=dev)
    dim = 1 << 20
    got = feature_hash_triton(codes, dim)
    want = feature_hash_ref(codes, dim)
    err = compare("feature_hash", got, want)
    ms = cuda_ms(lambda: feature_hash_triton(codes, dim), reps)
    plain_ms = cuda_ms(lambda: feature_hash_ref(codes, dim), 10)
    n = codes.numel()
    b_ms, b_by = bound(cost(n))
    log(f"feature_hash N={n} max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def store_vals(state) -> torch.Tensor:
    """The additive lanes (price, 1) lifted from a store table state."""
    price = state["cols"]["price"]
    return torch.stack([price, torch.ones_like(price)], dim=1).contiguous()


def request_frames(reqs, dev):
    """(key, [ts - WINDOW_MS, ts]) of request rows, int32 on ``dev``."""
    key = torch.tensor([int(r["userid"]) for r in reqs], dtype=torch.int32,
                       device=dev)
    t1 = torch.tensor([int(r["ts"]) for r in reqs], dtype=torch.int32,
                      device=dev)
    return key, t1 - WINDOW_MS, t1


def matched_row(state, key: int, t0: int, t1: int) -> int:
    """A live store row that the request (key, [t0, t1]) matches."""
    n = int(state["count"])
    keys = state["keys"][:n].cpu().numpy()
    ts = state["ts"][:n].cpu().numpy()
    hit = np.flatnonzero((keys == key) & (ts >= t0) & (ts <= t1))
    if hit.size == 0:
        raise AssertionError(f"no live row matches request key {key}")
    return int(hit[0])


def check_batch_windowfold(state, reqs, dev, reps):
    """``store_windowfold`` on the serving store (C = capacity) at each
    request batch: kernel against plain version (rtol/atol 1e-5), twice
    bitwise; then a NaN in a live row that no request matches (row 0,
    in a chunk every request's range misses), which (as in the
    reference's dense product) turns its whole lane NaN; then a +Inf in a
    live row that request 0 matches: that request's lane is +Inf, not
    NaN, and every other request's is Inf (it matches too) or NaN (the
    dense product's 0 * Inf)."""
    from repro_torch.kernels.batch_windowfold import store_windowfold
    from repro_torch.kernels.batch_windowfold.ops import cost

    vals = store_vals(state)
    count = int(state["count"])
    out, err = {}, 0.0
    for b in BATCHES:
        q = request_frames(reqs[:b], dev)
        got = store_windowfold(state, vals, *q, use_kernel=True)
        again = store_windowfold(state, vals, *q, use_kernel=True)
        torch.cuda.synchronize()
        same_bits(f"batch_windowfold[B={b}]", got, again)
        want = store_windowfold(state, vals, *q, use_kernel=False)
        err = max(err, compare(f"batch_windowfold[B={b}]", got, want,
                               rtol=1e-5, atol=1e-5))
        if got.isnan().any():
            raise AssertionError(f"batch_windowfold[B={b}]: NaN folds")
        out[b] = q
    q = out[max(BATCHES)]
    nan_vals = vals.clone()
    nan_vals[0, 0] = float("nan")         # row 0 lies before every frame
    got = store_windowfold(state, nan_vals, *q, use_kernel=True)
    want = store_windowfold(state, nan_vals, *q, use_kernel=False)
    compare("batch_windowfold[NaN row]", got, want, rtol=1e-5, atol=1e-5)
    if not (got[:, 0].isnan().all() and not got[:, 1].isnan().any()):
        raise AssertionError("batch_windowfold: a NaN in an unmatched row "
                             "must turn exactly its lane NaN")
    inf_vals = vals.clone()
    inf_vals[matched_row(state, int(q[0][0]), int(q[1][0]),
                         int(q[2][0])), 0] = float("inf")
    got = store_windowfold(state, inf_vals, *q, use_kernel=True)
    want = store_windowfold(state, inf_vals, *q, use_kernel=False)
    compare("batch_windowfold[Inf row]", got, want, rtol=1e-5, atol=1e-5)
    lane = got[:, 0]
    if not (bool(lane[0] == float("inf"))
            and bool((lane.isnan() | (lane == float("inf"))).all())
            and bool(torch.isfinite(got[:, 1]).all())):
        raise AssertionError("batch_windowfold: a +Inf in a matched row "
                             "must give +Inf to its request, NaN or Inf "
                             "to the others in its lane only")
    log(f"batch_windowfold: kernel == plain (rtol 1e-5) at B={BATCHES} "
        f"over C={vals.shape[0]} store rows ({count} live), two runs "
        f"equal; a NaN in an unmatched row turns its lane NaN in both; a "
        f"+Inf in a matched row gives its request +Inf "
        f"({int((lane == float('inf')).sum())} requests Inf, "
        f"{int(lane.isnan().sum())} NaN)")
    b = max(BATCHES)
    ms = cuda_ms(lambda: store_windowfold(state, vals, *q, use_kernel=True),
                 reps)
    plain_ms = cuda_ms(lambda: store_windowfold(state, vals, *q,
                                                use_kernel=False), 3)
    f = vals.shape[1]
    # least work over the live rows (``ops.cost``); the dense count
    # (three compares and a multiply-add per (request, live row, lane))
    # is shown beside it
    b_ms, b_by = bound(cost(count, b, f))
    dense_ms = b * count * (3 + f) / F32_OPS_PER_S * 1e3
    log(f"batch_windowfold B={b} C={vals.shape[0]} F={f} max_abs_err={err} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
        f"dense_ops_ms={dense_ms:.5f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "dense_ops_ms": dense_ms}


def bucket_inputs(actions, bucket_ms: int, n_buckets: int, dev):
    """The deployment's action rows as bucket-build input: (price,
    quantity) lanes with NULL (NaN) prices in every 100,003rd row from
    row 7, and timestamps pushed out of range (a negative bucket, one
    past the last) in every 50,000th row."""
    vals = np.stack([actions.columns["price"],
                     actions.columns["quantity"]], 1).astype(np.float32)
    vals[7::100_003, 0] = np.nan
    ts = actions.columns["ts"].astype(np.int32).copy()
    ts[::50_000] = -5
    ts[1::50_000] = n_buckets * bucket_ms + 7
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(ts).to(dev))


def check_bucket_build(actions, dev, reps):
    """``bucket_build`` over the action rows at each bucket width: kernel
    against plain version (rtol 1e-4, NaN positions equal), twice
    bitwise, counts exact.  Then, at each width, ``segagg_cuda`` and one
    ``index_add_`` call timed on the same prepared inputs (the lanes with
    the count column, the bucket ids; ``index_add_`` gets them masked and
    widened as it needs), the kernel's passes by name under the profiler,
    and ``bucket_build`` whole (its ``cat``/``div`` included)."""
    from repro_torch.kernels.segagg import bucket_build
    from repro_torch.kernels.segagg.kernel import segagg_cuda
    from repro_torch.kernels.segagg.ops import cost
    from repro_torch.kernels.segagg.ref import segagg_ref

    res, err = {}, 0.0
    for bucket_ms, n_buckets in BUCKETS:
        vals, ts = bucket_inputs(actions, bucket_ms, n_buckets, dev)
        got = bucket_build(vals, ts, bucket_ms, n_buckets, use_kernel=True)
        again = bucket_build(vals, ts, bucket_ms, n_buckets,
                             use_kernel=True)
        torch.cuda.synchronize()
        name = f"bucket_build[{n_buckets} buckets]"
        same_bits(name, got, again)
        want = bucket_build(vals, ts, bucket_ms, n_buckets,
                            use_kernel=False)
        err = max(err, compare(name, got, want, rtol=1e-4, atol=1e-3))
        seg = torch.div(ts, bucket_ms, rounding_mode="floor")
        in_range = int(((seg >= 0) & (seg < n_buckets)).sum())
        if int(got[:, 2].sum()) != in_range or not got[:, 0].isnan().any():
            raise AssertionError(f"{name}: counts or NULL sums wrong")
        res[n_buckets] = (vals, ts, bucket_ms)
    log(f"bucket_build: kernel == plain (rtol 1e-4) at {BUCKETS} over "
        f"{len(actions)} rows, two runs equal, counts exact, NULL prices "
        f"confined to their buckets")
    out = {}
    for bucket_ms, n_buckets in BUCKETS:
        vals, ts, _ = res[n_buckets]
        aug = torch.cat([vals, torch.ones_like(vals[:, :1])], 1).contiguous()
        seg = torch.div(ts, bucket_ms, rounding_mode="floor").to(
            torch.int32).contiguous()
        ok = (seg >= 0) & (seg < n_buckets)
        ids = torch.where(ok, seg, 0).long()
        masked = torch.where(ok[:, None], aug, 0.0)
        zeros = torch.zeros((n_buckets, 3), device=dev)
        ms = cuda_ms(lambda: segagg_cuda(aug, seg, n_buckets), reps)
        lib_ms = cuda_ms(lambda: zeros.clone().index_add_(0, ids, masked),
                         reps)
        ms_again = cuda_ms(lambda: segagg_cuda(aug, seg, n_buckets), reps)
        plain_ms = cuda_ms(lambda: segagg_ref(aug, seg, n_buckets), reps)
        bb_ms = cuda_ms(lambda: bucket_build(vals, ts, bucket_ms, n_buckets,
                                             use_kernel=True), reps)
        bb_plain_ms = cuda_ms(lambda: bucket_build(
            vals, ts, bucket_ms, n_buckets, use_kernel=False), reps)
        passes = kernel_times(lambda: segagg_cuda(aug, seg, n_buckets), 5,
                              ms)
        n = vals.shape[0]
        # least work: the (N, 3) lanes and the ids read once, the (S, 3)
        # sums written once; one add per row and lane (``ops.cost``)
        b_ms, b_by = bound(cost(n, 3, n_buckets))
        log(f"segagg N={n} S={n_buckets} F=3: segagg_cuda ms={ms:.4f} "
            f"(again {ms_again:.4f}), index_add_ library_ms={lib_ms:.4f}, "
            f"plain segagg_ref plain_ms={plain_ms:.4f}, all on the same "
            f"inputs; passes {passes}; bucket_build ms={bb_ms:.4f} (plain "
            f"{bb_plain_ms:.4f}); bound_ms={b_ms:.5f} ({b_by})")
        out[n_buckets] = {"ms": ms, "ms_again": ms_again,
                          "library_ms": lib_ms, "plain_ms": plain_ms,
                          "bucket_build_ms": bb_ms,
                          "bucket_build_plain_ms": bb_plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "passes_ms": passes}
    first = out[BUCKETS[0][1]]
    return {"max_abs_err": err, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]}, out


def check_linear_scan(dev, reps):
    """The SSM prefill scan of hymba-1.5b, (B, T, d_inner * state) =
    (8, 1024, 51,200) float32 with a in (0, 1): kernel against plain
    version bitwise, two runs bitwise."""
    from repro_torch.kernels.chunked_scan.kernel import linear_scan_cuda
    from repro_torch.kernels.chunked_scan.ops import cost
    from repro_torch.kernels.chunked_scan.ref import linear_scan_ref

    gen = torch.Generator(device=dev).manual_seed(13)
    shape = (MODEL_BATCH, MODEL_PROMPT, 51_200)
    a = torch.rand(shape, generator=gen, device=dev) * 0.7 + 0.3
    x = torch.randn(shape, generator=gen, device=dev)
    got = linear_scan_cuda(a, x)
    again = linear_scan_cuda(a, x)
    torch.cuda.synchronize()
    same_bits("linear_scan", got, again)
    want = linear_scan_ref(a, x)
    err = compare("linear_scan", got, want)
    if not torch.isfinite(got).all():
        raise AssertionError("linear_scan: non-finite output")
    del got, again, want
    ms = cuda_ms(lambda: linear_scan_cuda(a, x), reps)
    plain_ms = cuda_ms(lambda: linear_scan_ref(a, x), 2)
    n = a.numel()
    # least work: a and x read once, y written once; a multiply and an
    # add per element (``ops.cost``)
    b_ms, b_by = bound(cost(n))
    log(f"linear_scan {tuple(shape)} f32: kernel == plain (bitwise), two "
        f"runs equal; ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_linear_scan_bwd(dev, reps):
    """The scan's backward at hymba-1.5b's training micro-batch,
    (B / n_micro, T, d_inner * state) = (2, 2048, 51,200) float32, ``y``
    the forward's output: kernel against plain version bitwise (da and
    db), two runs bitwise.  No single PyTorch call computes the reverse
    recurrence (a cumprod/cumsum form divides by running products that
    underflow), so there is no library time."""
    from repro_torch.kernels.chunked_scan.kernel import (
        linear_scan_bwd_cuda, linear_scan_cuda)
    from repro_torch.kernels.chunked_scan.ops import cost
    from repro_torch.kernels.chunked_scan.ref import linear_scan_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(17)
    shape = (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 51_200)
    a = torch.rand(shape, generator=gen, device=dev) * 0.7 + 0.3
    y = linear_scan_cuda(a, torch.randn(shape, generator=gen, device=dev))
    g = torch.randn(shape, generator=gen, device=dev)
    got = linear_scan_bwd_cuda(a, y, g)
    again = linear_scan_bwd_cuda(a, y, g)
    torch.cuda.synchronize()
    want = linear_scan_bwd_ref(a, y, g)
    err = 0.0
    for name, k, r, w in zip(("da", "db"), got, again, want):
        same_bits(f"linear_scan_bwd {name}", k, r)
        err = max(err, compare(f"linear_scan_bwd {name}", k, w))
        if not torch.isfinite(k).all():
            raise AssertionError(f"linear_scan_bwd {name}: non-finite")
    del got, again, want
    ms = cuda_ms(lambda: linear_scan_bwd_cuda(a, y, g), reps)
    plain_ms = cuda_ms(lambda: linear_scan_bwd_ref(a, y, g), 2)
    n = a.numel()
    # least work: a, y and g read once, da and db written once; a
    # multiply and an add for lam and a multiply for da per element
    # (``ops.cost``)
    b_ms, b_by = bound(cost(n, backward=True))
    log(f"linear_scan_bwd {tuple(shape)} f32: kernel == plain (bitwise), "
        f"two runs equal; ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}); library: none (no PyTorch call "
        f"computes the reverse recurrence)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def decode_inputs(dev, sliding: bool, draw: int = 0, heads=(25, 5, 64),
                  kv_dtype=torch.bfloat16):
    """One decode step of a model's attention at positions 1,024+: q
    (8, Hq, D) float32, a cache (8, 2,048, Hkv, D) of ``kv_dtype``, live
    lengths in DECODE_LIVE; ``heads`` = (Hq, Hkv, D), hymba-1.5b's by
    default (DECODE_SHAPES has the others); ``sliding`` starts each live
    range 1,024 keys back, as on a sliding-window layer.  ``draw`` picks
    another seed (another cache)."""
    seed = 17 + sliding + 2 * draw
    if heads != (25, 5, 64):
        seed += 7 * sum(heads)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, (hq, hkv, d) = MODEL_BATCH, heads
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    k, v = (torch.randn((b, MODEL_MAX_LEN, hkv, d), generator=gen,
                        device=dev).to(kv_dtype) for _ in range(2))
    hi = torch.randint(DECODE_LIVE[0], DECODE_LIVE[1] + 1, (b,),
                       generator=gen, device=dev, dtype=torch.int32)
    lo = torch.clamp(hi - 1024, min=0) if sliding else torch.zeros_like(hi)
    return q, k, v, lo, hi


def decode_library(q, k, v, lo, hi):
    """The yardstick (never the port): one
    ``scaled_dot_product_attention`` call with a boolean live-range mask
    and ``enable_gqa``, which returns the finalized attention."""
    pos = torch.arange(k.shape[1], device=k.device)
    mask = ((pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None]))
    return torch.nn.functional.scaled_dot_product_attention(
        q.to(k.dtype)[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :], enable_gqa=True)[:, :, 0]


def rotating(fn, inputs):
    """``fn`` over the argument tuples in turn, one per call."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def check_decode_partials(dev, reps):
    """Kernel against plain version (rtol 1e-4 / atol 1e-5), two runs
    bitwise, at hymba-1.5b's shape for live ranges from 0 (global layers)
    and from lo > 0 (sliding-window layers), and at the D = 128 shapes of
    DECODE_SHAPES (qwen2-moe-a2.7b, dbrx-132b; there also over a float32
    cache, the route phase 4k's f32 check takes); times and bound for
    each bf16 cache, the library call beside them: warm (one cache, as a
    loop over one layer finds it in L2) and cold (a rotation of
    DECODE_COLD caches, 21-67 MB each, past the 50 MB L2 together, as a
    model's layers find theirs)."""
    from repro_torch.kernels.flash_decode.kernel import decode_partials_cuda
    from repro_torch.kernels.flash_decode.ops import cost
    from repro_torch.kernels.flash_decode.ref import (decode_partials_ref,
                                                      finalize_partials)

    def held(name, q, k, v, lo, hi):
        got = decode_partials_cuda(q, k, v, lo, hi)
        again = decode_partials_cuda(q, k, v, lo, hi)
        torch.cuda.synchronize()
        want = decode_partials_ref(q, k, v, lo, hi)
        err = 0.0
        for part, a, b, c in zip("mlo", got, again, want):
            same_bits(f"decode_partials[{name}/{part}]", a, b)
            err = max(err, compare(f"decode_partials[{name}/{part}]", a, c,
                                   rtol=1e-4, atol=1e-5))
        return got, err

    res = {}
    cases = [("global", False, (25, 5, 64)), ("sliding", True, (25, 5, 64))]
    cases += [(name, False, heads) for name, heads in DECODE_SHAPES.items()]
    for name, sliding, heads in cases:
        if heads[2] == 128:
            _, err32 = held(f"{name}/f32", *decode_inputs(
                dev, sliding, heads=heads, kv_dtype=torch.float32))
            log(f"decode_partials[{name}] Hq, Hkv, D = {heads} float32 "
                f"cache: kernel == plain (rtol 1e-4), two runs equal, "
                f"max_abs_err={err32}")
        q, k, v, lo, hi = decode_inputs(dev, sliding, heads=heads)
        got, err = held(name, q, k, v, lo, hi)
        lib = decode_library(q, k, v, lo, hi).float()
        err_lib = float((finalize_partials(*got) - lib).abs().max())
        ms = cuda_ms(lambda: decode_partials_cuda(q, k, v, lo, hi), reps)
        plain_ms = cuda_ms(lambda: decode_partials_ref(q, k, v, lo, hi), 20)
        lib_ms = cuda_ms(lambda: decode_library(q, k, v, lo, hi), reps)
        sets = [decode_inputs(dev, sliding, i, heads)
                for i in range(DECODE_COLD)]
        cold_ms = cuda_ms(rotating(decode_partials_cuda, sets), reps)
        cold_lib_ms = cuda_ms(rotating(decode_library, sets), reps)
        del sets
        passes = kernel_times(lambda: decode_partials_cuda(q, k, v, lo, hi),
                              5, ms)
        live = int((hi - lo).sum())
        b, hq, d = q.shape
        hkv = k.shape[2]
        # least work: each live K and V row read once (bf16), q read and
        # the partials written once; 4 * d flops per live key and head
        # (``ops.cost``)
        b_ms, b_by = bound(cost(b, hq, hkv, d, live, 2))
        log(f"decode_partials[{name}] B={b} Hq={hq} Hkv={hkv} D={d} bf16 "
            f"cache S={k.shape[1]}, {live} live keys: kernel == plain "
            f"(rtol 1e-4), two runs equal, max_abs_err={err}; finalized vs "
            f"SDPA (bf16) max diff {err_lib:.3e}; ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}); cold in L2 over {DECODE_COLD} "
            f"caches: ms={cold_ms:.4f} library_ms={cold_lib_ms:.4f}; "
            f"passes {passes}")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "cold_ms": cold_ms, "cold_library_ms": cold_lib_ms,
                     "passes_ms": passes, "live_keys": live}
    return res


def check_decode_32k(dev, reps):
    """``decode_partials`` at phase 4m's decode shape (llama3-8b: Hq 32,
    Hkv 8, D 128; B = MESH_BATCH over a bf16 cache of MESH_SEQ with
    MESH_LIVE live keys): kernel against plain version (rtol 1e-4 / atol
    1e-5) and two runs bitwise, over the whole live range and over one
    sequence shard's piece (the contiguous chunk [S/4, S/2), its whole
    range: the call the mesh decode makes on an entry); times and
    bounds, one SDPA call beside the whole range, and the one-key range
    a dead shard's piece is given."""
    from repro_torch.kernels.flash_decode.kernel import decode_partials_cuda
    from repro_torch.kernels.flash_decode.ops import cost
    from repro_torch.kernels.flash_decode.ref import decode_partials_ref

    gen = torch.Generator(device=dev).manual_seed(29)
    b, hq, hkv, d = MESH_BATCH, 32, 8, 128
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    k, v = (torch.randn((b, MESH_SEQ, hkv, d), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    s_loc = MESH_SEQ // MESH_SEQ_SHARDS

    def rng(lo, hi):
        return (torch.full((b,), lo, dtype=torch.int32, device=dev),
                torch.full((b,), hi, dtype=torch.int32, device=dev))

    out = {}
    # one sequence shard's piece: a contiguous (B, S/4, Hkv, D) chunk
    kc, vc = (t[:, s_loc:2 * s_loc].contiguous() for t in (k, v))
    for name, (lo, hi) in (("whole", rng(0, MESH_LIVE)),
                           ("shard", rng(0, s_loc)),
                           ("dead", rng(0, 1))):
        if name != "whole":
            k, v = kc, vc
        got = decode_partials_cuda(q, k, v, lo, hi)
        again = decode_partials_cuda(q, k, v, lo, hi)
        want = decode_partials_ref(q, k, v, lo, hi)
        err = 0.0
        for part, x, y, z in zip("mlo", got, again, want):
            same_bits(f"decode_partials[32k/{name}/{part}]", x, y)
            err = max(err, compare(f"decode_partials[32k/{name}/{part}]", x,
                                   z, rtol=1e-4, atol=1e-5))
        del got, again, want
        live = int((hi - lo).sum())
        # least work: each live K and V row read once (bf16), q read and
        # the partials written once; 4 * d flops per live key and head
        # (``ops.cost``)
        b_ms, b_by = bound(cost(b, hq, hkv, d, live, 2))
        r = {"live_keys": live, "max_abs_err": err, "bound_ms": b_ms,
             "bound_by": b_by,
             "ms": cuda_ms(lambda: decode_partials_cuda(q, k, v, lo, hi),
                           reps)}
        if name == "whole":
            r["plain_ms"] = cuda_ms(
                lambda: decode_partials_ref(q, k, v, lo, hi), 3)
            r["library_ms"] = cuda_ms(
                lambda: decode_library(q, k, v, lo, hi), reps)
        out[name] = r
        log(f"decode_partials[32k/{name}] B={b} Hq={hq} Hkv={hkv} D={d} bf16 "
            f"cache S={k.shape[1]}, [{int(lo[0])}, {int(hi[0])}) live ({live} "
            f"keys): kernel == plain (rtol 1e-4), two runs equal, "
            f"max_abs_err={err}; ms={r['ms']:.4f}"
            + (f" plain_ms={r['plain_ms']:.4f} library_ms="
               f"{r['library_ms']:.4f}" if name == "whole" else "")
            + f" bound_ms={b_ms:.5f} ({b_by})")
    del q, k, v, kc, vc
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 4d


def model_prompt(cfg, b=MODEL_BATCH, t=MODEL_PROMPT):
    gen = torch.Generator().manual_seed(5)
    return torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                         dtype=torch.int32).numpy()


def teacher_forced(engine, batch, tokens):
    """Prefill ``batch``, then decode the given tokens; every step's
    logits."""
    out = [engine.prefill(batch)]
    for i in range(tokens.shape[1]):
        out.append(engine.decode(tokens[:, i:i + 1]))
    return out


def check_logits(logits, cfg, b=MODEL_BATCH):
    for i, x in enumerate(logits):
        if x.shape != (b, cfg.vocab_padded) or not np.isfinite(x).all():
            raise AssertionError(f"model logits {i}: shape {x.shape} or "
                                 f"non-finite values")


def model_serving(dev, card):
    """Phase 4d: hymba-1.5b at full width and depth on the card."""
    from repro_torch.configs import get
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine

    cfg = get(MODEL_ARCH)
    prompt = model_prompt(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{MODEL_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} G params drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; B={MODEL_BATCH} prompts of "
        f"{MODEL_PROMPT} tokens, max_len {MODEL_MAX_LEN}, "
        f"{MODEL_TOKENS} greedy tokens")

    # f32: the main path through the kernels, then kernels vs plain
    kern = ServingEngine(cfg, params, max_len=MODEL_MAX_LEN,
                         dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    tokens, counts_f32 = run_path(
        "model serving (f32)",
        lambda: kern.generate_greedy({"tokens": prompt}, MODEL_TOKENS),
        ("linear_scan", "decode_partials"))
    t_f32 = time.perf_counter() - t0
    expect = {"linear_scan": cfg.n_layers,
              "decode_partials": cfg.n_layers * MODEL_TOKENS}
    for k, n in expect.items():
        if counts_f32.get(k) != n:
            raise AssertionError(f"model serving: {counts_f32.get(k)} {k} "
                                 f"launches, expected {n}")
    if tokens.shape != (MODEL_BATCH, MODEL_TOKENS) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_padded:
        raise AssertionError(f"generate_greedy: bad tokens {tokens.shape}")
    got = teacher_forced(kern, {"tokens": prompt}, tokens)
    del kern
    plain = ServingEngine(cfg, params, max_len=MODEL_MAX_LEN,
                          dtype=torch.float32, device=dev, use_kernel=False)
    want = teacher_forced(plain, {"tokens": prompt}, tokens)
    del plain
    check_logits(got, cfg)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.allclose(a, b, rtol=MODEL_TOL, atol=MODEL_TOL):
            raise AssertionError(f"model logits step {i}: kernels != plain "
                                 f"(max diff {np.abs(a - b).max()})")
        err = max(err, float(np.abs(a - b).max()))
    if not np.array_equal(np.stack([x.argmax(-1) for x in got[:-1]], 1),
                          tokens):
        raise AssertionError("teacher-forced kernel run: argmax differs "
                             "from generate_greedy's tokens")
    log(f"f32 generate_greedy {t_f32:.1f} s; teacher-forced prefill + "
        f"{MODEL_TOKENS} steps: kernels == plain versions within "
        f"{MODEL_TOL} (max abs diff {err:.3e}, logits ~"
        f"{float(np.abs(want[0]).max()):.2f}); argmax reproduces the "
        f"generated tokens")

    # bf16: the reference's serving dtype, timed
    params = _cast(params)
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, params, max_len=MODEL_MAX_LEN,
                        dtype=torch.bfloat16, device=dev)
    eng.generate_greedy({"tokens": prompt}, 2)             # warm-up
    t0 = time.perf_counter()
    tok_bf16, counts_bf16 = run_path(
        "model serving (bf16)",
        lambda: eng.generate_greedy({"tokens": prompt}, MODEL_TOKENS),
        ("linear_scan", "decode_partials"))
    t_gen = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.prefill({"tokens": prompt})
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps = []
    for i in range(MODEL_TOKENS):
        t0 = time.perf_counter()
        last = eng.decode(tok_bf16[:, i:i + 1])
        steps.append((time.perf_counter() - t0) * 1e3)
    check_logits([first, last], cfg)
    tok_s = MODEL_BATCH * MODEL_TOKENS / (sum(steps) / 1e3)
    prof_dec = profile_calls(lambda: eng.decode(tok_bf16[:, :1]), 8)
    prof_pre = profile_calls(lambda: eng.prefill({"tokens": prompt}), 1)
    out = {"params_g": n_params / 1e9, "f32_generate_s": t_f32,
           "f32_max_abs_diff": err, "bf16_generate_s": t_gen,
           "bf16_prefill_ms": prefill_ms,
           "bf16_decode_ms_p50": float(np.percentile(steps, 50)),
           "bf16_decode_ms_p99": float(np.percentile(steps, 99)),
           "bf16_decode_ms": steps, "bf16_decode_tokens_per_s": tok_s,
           "launches_f32": counts_f32, "launches_bf16": counts_bf16,
           "profile_decode": prof_dec, "profile_prefill": prof_pre,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"bf16 prefill {prefill_ms:.1f} ms (B={MODEL_BATCH} x "
        f"{MODEL_PROMPT} tokens); decode per token p50 "
        f"{out['bf16_decode_ms_p50']:.2f} ms, p99 "
        f"{out['bf16_decode_ms_p99']:.2f} ms over {MODEL_TOKENS} steps; "
        f"{tok_s:.0f} tokens/s; generate_greedy {t_gen:.2f} s  [{card}]")
    log_profile("decode step (bf16)", prof_dec, card)
    attn = {k: v for k, v in prof_dec["kernel_ms_per_call"].items()
            if "decode_split_kernel" in k or "decode_merge_kernel" in k}
    out["decode_partials_ms_per_step"] = sum(attn.values())
    log(f"decode_partials in a decode step: {sum(attn.values()):.4f} ms of "
        f"{prof_dec['device_ms_per_call']:.3f} ms device time ({attn})  "
        f"[{card}]")
    log_profile("prefill (bf16)", prof_pre, card)
    out["roofline"] = serving_rooflines(cfg, eng, prompt, tok_bf16,
                                        prefill_ms,
                                        out["bf16_decode_ms_p50"], card)
    del eng, params
    torch.cuda.empty_cache()
    return out, {"model_f32": counts_f32, "model_bf16": counts_bf16}


def serving_rooflines(cfg, eng, prompt, tokens, prefill_ms, decode_ms,
                      card):
    """Phase 4n (b) on 4d's bf16 engine: one prefill of the 4d batch and
    one decode token (after the profiled prefill: every row at
    MODEL_PROMPT), against 4d's prefill time and decode p50."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.models import decode_step, forward_prefill

    dev = eng.device
    batch = {"tokens": torch.as_tensor(prompt).to(dev, torch.int32)}
    tok = torch.as_tensor(tokens[:, :1]).to(dev, torch.int32)
    mparams = meta_tree(eng.params)
    pre = step_roofline(
        f"{MODEL_ARCH} prefill (bf16, {MODEL_BATCH} x {MODEL_PROMPT})", cfg,
        ShapeSpec("prefill", MODEL_PROMPT, MODEL_BATCH, "prefill"),
        lambda: forward_prefill(cfg, eng.params, batch,
                                cache_capacity=eng.max_len),
        lambda: forward_prefill(cfg, mparams, meta_tree(batch),
                                cache_capacity=eng.max_len),
        prefill_ms, card)
    state = eng.state
    dec = step_roofline(
        f"{MODEL_ARCH} decode token (bf16, B={MODEL_BATCH}, cache "
        f"{eng.max_len})", cfg,
        ShapeSpec("decode", MODEL_PROMPT + 1, MODEL_BATCH, "decode"),
        lambda: decode_step(cfg, eng.params, state, tok),
        lambda: decode_step(cfg, mparams, meta_tree(state), meta_tree(tok)),
        decode_ms, card)
    return {"prefill": pre, "decode": dec}


# ---------------------------------------------------------------- phase 4j


def busy_share(fn):
    """Device time and busy share of one call of ``fn``, from the
    profiler's raw kernel records (CUDA activity only).  A train step
    launches ~100,000 kernels, and building ``profile_calls``' event
    tree for them takes about a minute; summing the raw records takes
    about a second."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (
                e.end_ns() - e.start_ns()) / 1e6
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "kernels": n,
            "device_busy_share": dev_ms / wall_ms if n else None,
            "top_kernels_ms": [(k[:90], v) for k, v in top]}


def _grads_equal(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(_leaves(a[1]), _leaves(b[1])))


def model_training(dev, card):
    """Phase 4j: hymba-1.5b trained at full width and depth on the card
    (bf16 compute, f32 master weights and AdamW, TokenPipeline tokens)."""
    import math

    from repro_torch.configs import get
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step
    from repro_torch.train.steps import loss_and_grads

    cfg = get(MODEL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = adamw_init(init_params(cfg, torch.Generator(
        device=dev).manual_seed(0), dtype=torch.float32, device=dev))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    batches = [{"tokens": torch.from_numpy(pipe.batch_at(i)["tokens"]).to(
        dev)} for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    log(f"{MODEL_ARCH} training: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, window {cfg.sliding_window}; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches, bf16 compute, "
        f"f32 master + AdamW; state and batches ready in "
        f"{time.perf_counter() - t0:.1f} s")

    # one step's loss and gradients from the initial state, kernel route
    # against the plain route: bitwise, or, if they differ, within the
    # spread of two plain-route runs (another op not deterministic)
    def grads(use_kernel):
        t0 = time.perf_counter()
        out = loss_and_grads(cfg, state.params, batches[0], TRAIN_MICRO,
                             torch.bfloat16, use_kernel)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    kern, t_kern = grads(None)
    plain, t_plain = grads(False)
    bitwise = _grads_equal(kern, plain)
    if bitwise:
        spread = 0.0
        bar = "bitwise"
    else:
        plain2, _ = grads(False)
        pairs = list(zip((kern[0], *_leaves(kern[1])),
                         (plain[0], *_leaves(plain[1])),
                         (plain2[0], *_leaves(plain2[1]))))
        spread = max(float((p - q).abs().max()) for _, p, q in pairs)
        for i, (k, p, q) in enumerate(pairs):
            if float((k - p).abs().max()) > float((p - q).abs().max()):
                raise AssertionError(f"training: leaf {i} kernel route "
                                     f"outside two plain runs' spread")
        del plain2
        bar = f"within the plain route's run-to-run spread ({spread:.3e})"
    loss_k = float(kern[0])
    del kern, plain
    torch.cuda.empty_cache()
    log(f"one step's loss and {len(list(_leaves(state.params)))} gradient "
        f"leaves: kernel route == plain route, {bar}; loss {loss_k:.4f}; "
        f"{t_kern:.1f} s kernel route, {t_plain:.1f} s plain route")

    # the main path: TRAIN_STEPS steps of the train step
    step_fn = build_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                               n_micro=TRAIN_MICRO,
                               compute_dtype=torch.bfloat16)
    losses, norms, step_ms = [], [], []

    def train():
        nonlocal state
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))          # waits
            step_ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(metrics["grad_norm"]))
        return int(metrics["step"])

    torch.cuda.reset_peak_memory_stats()
    steps, counts = run_path("training", train,
                             ("linear_scan", "linear_scan_bwd"))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: counts.get(k, 0) / TRAIN_STEPS
                for k in ("linear_scan", "linear_scan_bwd")}
    expect = {"linear_scan": cfg.n_layers * TRAIN_MICRO * 2,
              "linear_scan_bwd": cfg.n_layers * TRAIN_MICRO}
    if per_step != expect:
        raise AssertionError(f"training: launches per step {per_step}, "
                             f"expected {expect}")
    if steps != TRAIN_STEPS or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"training: step {steps}, losses {losses}, "
                             f"grad norms {norms}")
    ln_v = math.log(cfg.vocab_size)
    if abs(losses[0] - ln_v) > TRAIN_LOSS_TOL or (
            bitwise and losses[0] != loss_k):
        raise AssertionError(f"training: first loss {losses[0]} (ln V = "
                             f"{ln_v:.4f}, the compared step's "
                             f"{loss_k})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: loss did not fall: {losses}")
    p50 = float(np.percentile(step_ms, 50))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3)
    log(f"{TRAIN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(ln V = {ln_v:.4f}); grad norm {norms[0]:.3f} -> {norms[-1]:.3f}; "
        f"step p50 {p50:.1f} ms, {tok_s:.0f} tokens/s; peak memory "
        f"{peak_gb:.2f} GB; launches per step {per_step}  [{card}]")
    prof = busy_share(lambda: step_fn(state, batches[0]))
    log(f"profile train step (bf16, one more step): wall "
        f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms "
        f"({prof['kernels']} kernels), device busy share "
        + (f"{prof['device_busy_share']:.3f}" if prof["kernels"] else
           "not measured (no device events)") + f"  [{card}]")
    for name, ms in prof["top_kernels_ms"]:
        log(f"  device {ms:.2f} ms  {name}")
    # phase 4n (b): one more step counted, against the step p50
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import count_train_step

    roof = step_roofline(
        f"{MODEL_ARCH} train step (bf16, {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{TRAIN_MICRO} microbatches)", cfg,
        ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        lambda: step_fn(state, batches[0]), None, p50, card,
        # one microbatch on meta, times TRAIN_MICRO, plus the update (the
        # dry run's count: the same FLOPs and kernel records as the step)
        meta_cost=lambda: count_train_step(
            cfg, meta_tree(state), meta_tree(batches[0]), TRAIN_MICRO,
            AdamWConfig(**TRAIN_OPT)))
    out = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "step_ms_p50": p50, "tokens_per_s": tok_s, "peak_mem_gb": peak_gb,
           "launches_per_step": per_step, "kernel_vs_plain": bar,
           "kernel_vs_plain_spread": spread, "compare_kernel_s": t_kern,
           "compare_plain_s": t_plain, "profile_step": prof,
           "roofline": roof}
    del state, step_fn
    torch.cuda.empty_cache()
    out["data_parallel"], dp_counts = dp_training(dev, card, batches)
    del batches
    torch.cuda.empty_cache()
    return out, {"training": counts, **dp_counts}


def close_params(label, pairs, lr):
    """``tests/test_torch_train.py``'s ``_close_params`` on the card, leaf
    by leaf over (got, want) pairs: rtol 1e-4 / atol 1e-6, but an element
    whose ~0 gradient's rounding turned Adam's step (2 lr at most), 0.1%
    of a leaf.  Returns (max abs diff, elements off, elements)."""
    worst, n_miss, n_all = 0.0, 0, 0
    for i, (g, w) in enumerate(pairs):
        miss = ~torch.isclose(g, w, rtol=1e-4, atol=1e-6)
        diff = float((g - w).abs().max()) if g.numel() else 0.0
        worst = max(worst, diff)
        n_miss += int(miss.sum())
        n_all += miss.numel()
        if miss.any() and (float((g - w).abs()[miss].max()) > 2 * lr
                           or float(miss.float().mean()) > 1e-3):
            raise AssertionError(f"{label} leaf {i}: {int(miss.sum())} "
                                 f"of {miss.numel()} off, max {diff}")
    return worst, n_miss, n_all


def dp_training(dev, card, batches):
    """Phase 4j's data-parallel step: hymba-1.5b at full width and
    DP_LAYERS layers, batch TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO
    microbatches, on a (DP_BLOCKS, 1) mesh of the card (every
    microbatch's rows in DP_BLOCKS blocks, each block's forward and
    backward apart, averaged on the card): in f32 one step from a state
    against the one-device step from a copy of it (loss within
    DP_LOSS_RTOL, every param leaf at ``tests/test_torch_train.py``'s
    bars, the scan launches doubled); then bf16 steps timed in turns
    (one device, DP, DP, one device), DP_STEPS a turn."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.distributed.fault import tree_map
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(MODEL_ARCH), n_layers=DP_LAYERS)
    mesh = Mesh(np.array([[dev]] * DP_BLOCKS, dtype=object),
                ("data", "model"))
    dp = dict(dp_axes=("data",), mesh=mesh)
    lr = TRAIN_OPT["lr"]

    def step_fn(dtype, **kw):
        return build_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                                n_micro=TRAIN_MICRO, compute_dtype=dtype,
                                **kw)

    state = adamw_init(init_params(cfg, torch.Generator(
        device=dev).manual_seed(0), dtype=torch.float32, device=dev))
    twin = tree_map(lambda t: t.clone(), state)
    (dp_state, dp_m), dp_counts = run_path(
        "training, data parallel (f32)",
        lambda: step_fn(torch.float32, **dp)(state, batches[0]),
        ("linear_scan", "linear_scan_bwd"))
    (one_state, one_m), one_counts = run_path(
        "training, one device (f32)",
        lambda: step_fn(torch.float32)(twin, batches[0]),
        ("linear_scan", "linear_scan_bwd"))
    if {k: dp_counts[k] for k in ("linear_scan", "linear_scan_bwd")} != \
            {k: DP_BLOCKS * one_counts[k]
             for k in ("linear_scan", "linear_scan_bwd")}:
        raise AssertionError(f"4j DP launches {dp_counts}, one device "
                             f"{one_counts}")
    loss_dp, loss_one = float(dp_m["loss"]), float(one_m["loss"])
    if abs(loss_dp - loss_one) > DP_LOSS_RTOL * abs(loss_one):
        raise AssertionError(f"4j DP loss {loss_dp}, one device {loss_one}")
    worst, n_miss, n_all = close_params(
        "4j DP param", zip(_leaves(dp_state.params),
                           _leaves(one_state.params)), lr)
    del state, twin, dp_state, one_state
    torch.cuda.empty_cache()
    log(f"4j data parallel: {MODEL_ARCH} at full width, {DP_LAYERS} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches on a "
        f"({DP_BLOCKS}, 1) mesh of the card, f32: loss {loss_dp:.7f} against "
        f"the one-device step's {loss_one:.7f} (rtol {DP_LOSS_RTOL}); params "
        f"max abs diff {worst:.3e}, {n_miss} of {n_all} elements off rtol "
        f"1e-4 / atol 1e-6 (each within 2 lr); scan launches {dp_counts} "
        f"against {one_counts}  [{card}]")
    # bf16, timed in turns
    state = adamw_init(init_params(cfg, torch.Generator(
        device=dev).manual_seed(0), dtype=torch.float32, device=dev))
    fns = {"one device": step_fn(torch.bfloat16),
           "data parallel": step_fn(torch.bfloat16, **dp)}
    ms = {k: [] for k in fns}
    for route in ("one device", "data parallel", "data parallel",
                  "one device"):
        for i in range(DP_STEPS + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = fns[route](state, batches[i % len(batches)])
            loss = float(m["loss"])                      # waits
            if i:                                        # first: warm-up
                ms[route].append((time.perf_counter() - t1) * 1e3)
            if not np.isfinite(loss):
                raise AssertionError(f"4j DP bf16 loss {loss}")
    del state
    torch.cuda.empty_cache()
    res = {"loss_dp": loss_dp, "loss_one": loss_one, "param_max_diff": worst,
           "param_misses": n_miss, "params": n_all,
           "launches_dp": dp_counts, "launches_one": one_counts,
           "bf16_ms": ms, "phase_s": time.perf_counter() - t0}
    for route, v in ms.items():
        res[f"bf16_p50_{route.replace(' ', '_')}"] = float(
            np.percentile(v, 50))
    log(f"4j data parallel bf16 step p50 {res['bf16_p50_data_parallel']:.1f}"
        f" ms ({DP_BLOCKS} blocks a microbatch) against one device "
        f"{res['bf16_p50_one_device']:.1f} ms, {2 * DP_STEPS} steps each in "
        f"turns; {res['phase_s']:.1f} s  [{card}]")
    return res, {"training_dp_f32": dp_counts,
                 "training_one_f32": one_counts}


# ---------------------------------------------------------------- phase 4k


def _draw(cfg, dev, dtype):
    """Seeded random weights at ``cfg``'s widths: seed 0, as phase 4d.
    ``normal_init`` draws float32 and casts, so a bf16 draw holds the
    bits of the f32 draw cast to bf16 (no f32 copy needs to stay)."""
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       dtype=dtype, device=dev)


def _free():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def model_batch(cfg, tokens, dev):
    """A model batch: the tokens, and seeded bf16 stand-ins on the card
    for the VLM family's patch embeddings and the audio family's frame
    embeddings (the reference's frontends are stubs that take them
    precomputed, ``model_input_spec``)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    b = tokens.shape[0]
    batch = {"tokens": tokens}
    if cfg.vlm is not None:
        batch["patches"] = torch.randn(
            (b, cfg.vlm.n_patches, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(
            (b, cfg.encdec.n_frames, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    return batch


def _kernel_vs_plain(cfg, label, params, batch, dev, card, expect,
                     max_len=MODEL_MAX_LEN):
    """float32 ``generate_greedy`` of FAMILY_TOKENS tokens through the
    kernels (``expect(FAMILY_TOKENS)`` launches exactly), then
    teacher-forced through the kernels and the plain versions: logits
    within MODEL_TOL, argmax the generated tokens.  Returns (seconds of
    the generation, max abs diff, launch counts)."""
    from repro_torch.serve.engine import ServingEngine

    b = batch["tokens"].shape[0]
    kern = ServingEngine(cfg, params, max_len=max_len, dtype=torch.float32,
                         device=dev)
    t0 = time.perf_counter()
    tokens, counts = run_path(
        f"{label} serving (f32)",
        lambda: kern.generate_greedy(batch, FAMILY_TOKENS),
        tuple(expect(FAMILY_TOKENS)))
    t_f32 = time.perf_counter() - t0
    if counts != expect(FAMILY_TOKENS):
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"{expect(FAMILY_TOKENS)}")
    got = teacher_forced(kern, batch, tokens)
    del kern
    _free()
    plain = ServingEngine(cfg, params, max_len=max_len, dtype=torch.float32,
                          device=dev, use_kernel=False)
    want = teacher_forced(plain, batch, tokens)
    del plain
    check_logits(got, cfg, b)
    err = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        if not np.allclose(x, y, rtol=MODEL_TOL, atol=MODEL_TOL):
            raise AssertionError(f"{label} logits step {i}: kernels != "
                                 f"plain (max diff {np.abs(x - y).max()})")
        err = max(err, float(np.abs(x - y).max()))
    if not np.array_equal(np.stack([x.argmax(-1) for x in got[:-1]], 1),
                          tokens):
        raise AssertionError(f"{label}: teacher-forced argmax differs "
                             f"from generate_greedy's tokens")
    log(f"{label} f32 generate_greedy {FAMILY_TOKENS} tokens {t_f32:.1f} "
        f"s; teacher-forced prefill + {FAMILY_TOKENS} steps: kernels == "
        f"plain versions within {MODEL_TOL} (max abs diff {err:.3e}); "
        f"argmax reproduces the generated tokens; launches {counts}  "
        f"[{card}]")
    return t_f32, err, counts


def _decode_vs_prefill(cfg, label, params, batch, dev, card, how):
    """float32 ``generate_greedy`` of FAMILY_TOKENS tokens (no kernel on
    the path, none launched), then the logits of each decode step t
    against a prefill over the prompt plus the first t tokens (within
    MODEL_TOL); ``how`` names the two routes.  Returns (seconds of the
    generation, max abs diff, launch counts)."""
    from repro_torch.serve.engine import ServingEngine

    eng = ServingEngine(cfg, params, max_len=MODEL_MAX_LEN,
                        dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    tokens, counts = run_path(
        f"{label} serving (f32)",
        lambda: eng.generate_greedy(batch, FAMILY_TOKENS), ())
    t_f32 = time.perf_counter() - t0
    if counts:
        raise AssertionError(f"{label}: launched {counts}, expected none")
    got = teacher_forced(eng, batch, tokens)
    check_logits(got, cfg, batch["tokens"].shape[0])
    err = 0.0
    for t in range(1, FAMILY_TOKENS + 1):
        seq = np.concatenate([batch["tokens"], tokens[:, :t]], axis=1)
        ref = eng.prefill(dict(batch, tokens=seq))
        if not np.allclose(got[t], ref, rtol=MODEL_TOL, atol=MODEL_TOL):
            raise AssertionError(
                f"{label} decode step {t}: {how} (max diff "
                f"{np.abs(got[t] - ref).max()})")
        err = max(err, float(np.abs(got[t] - ref).max()))
    del eng
    log(f"{label} f32 generate_greedy {FAMILY_TOKENS} tokens {t_f32:.1f} "
        f"s; decode steps 1..{FAMILY_TOKENS}: {how} within {MODEL_TOL} "
        f"(max abs diff {err:.3e}); no kernel launched  [{card}]")
    return t_f32, err, counts


def _bf16_serving(cfg, label, batch, dev, card, expect, probe=None,
                  max_len=MODEL_MAX_LEN, extra=None):
    """A model in bf16, timed: prefill, decode per token p50 / p99 over
    FAMILY_BF16_TOKENS, tokens/s, one profiled decode step, peak memory.
    ``probe`` = (leaf of the params, the f32 draw's leaf cast to bf16):
    the fresh bf16 draw must hold its bits.  ``extra(engine)`` adds its
    dict of measurements before the engine is freed."""
    from repro_torch.serve.engine import ServingEngine

    b, t = batch["tokens"].shape
    torch.cuda.reset_peak_memory_stats()
    params = _draw(cfg, dev, torch.bfloat16)
    n_params = sum(p.numel() for p in _leaves(params))
    if probe is not None and not torch.equal(probe[0](params), probe[1]):
        raise AssertionError(f"{label}: the bf16 draw is not the f32 draw "
                             f"cast to bf16")
    eng = ServingEngine(cfg, params, max_len=max_len, dtype=torch.bfloat16,
                        device=dev)
    eng.generate_greedy(batch, 2)                          # warm-up
    t0 = time.perf_counter()
    tokens, counts = run_path(f"{label} serving (bf16)",
                              lambda: eng.generate_greedy(
                                  batch, FAMILY_BF16_TOKENS), ())
    t_gen = time.perf_counter() - t0
    if counts != expect(FAMILY_BF16_TOKENS):
        raise AssertionError(f"{label} bf16: launches {counts}, expected "
                             f"{expect(FAMILY_BF16_TOKENS)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.prefill(batch)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps = []
    for i in range(FAMILY_BF16_TOKENS):
        t0 = time.perf_counter()
        last = eng.decode(tokens[:, i:i + 1])
        steps.append((time.perf_counter() - t0) * 1e3)
    check_logits([first, last], cfg, b)
    tok_s = b * FAMILY_BF16_TOKENS / (sum(steps) / 1e3)
    prof_dec = profile_calls(lambda: eng.decode(tokens[:, :1]), 4)
    attn = {k: v for k, v in prof_dec["kernel_ms_per_call"].items()
            if "decode_split_kernel" in k or "decode_merge_kernel" in k}
    out = {"bf16_prefill_ms": prefill_ms, "bf16_generate_s": t_gen,
           "bf16_decode_ms_p50": float(np.percentile(steps, 50)),
           "bf16_decode_ms_p99": float(np.percentile(steps, 99)),
           "bf16_decode_ms": steps, "bf16_decode_tokens_per_s": tok_s,
           "launches_bf16": counts, "profile_decode": prof_dec,
           "decode_partials_ms_per_step": sum(attn.values()),
           "bf16_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params_g": n_params / 1e9}
    inputs = "".join(f" + {k} {tuple(v.shape)}" for k, v in batch.items()
                     if k != "tokens")
    log(f"{label} bf16 prefill {prefill_ms:.1f} ms (B={b} x {t} tokens"
        f"{inputs}); decode per token p50 "
        f"{out['bf16_decode_ms_p50']:.2f} ms, p99 "
        f"{out['bf16_decode_ms_p99']:.2f} ms over {FAMILY_BF16_TOKENS} steps; "
        f"{tok_s:.0f} tokens/s; peak memory {out['bf16_peak_mem_gb']:.2f} "
        f"GB  [{card}]")
    log_profile(f"{label} decode step (bf16)", prof_dec, card)
    log(f"decode_partials in a {label} decode step: "
        f"{out['decode_partials_ms_per_step']:.4f} ms of "
        f"{prof_dec['device_ms_per_call']:.3f} ms device time  [{card}]")
    if extra is not None:
        out.update(extra(eng))
    del eng, params
    _free()
    return out, counts


def _train_step(cfg, label, dev, card, loss_offset=0.0):
    """One train step at the depth of ``cfg`` (bf16 compute, f32 master
    weights and AdamW), batch FAMILY_TRAIN_BATCH x FAMILY_TRAIN_SEQ
    positions (VLM: the patches, then the tokens): the first loss within
    TRAIN_LOSS_TOL of ln(vocab) + ``loss_offset``, the gradients finite
    (their global norm is), timed."""
    import math

    from repro_torch.configs import get
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step

    torch.cuda.reset_peak_memory_stats()
    state = adamw_init(_draw(cfg, dev, torch.float32))
    n_tok = FAMILY_TRAIN_SEQ - (cfg.vlm.n_patches if cfg.vlm else 0)
    tokens = TokenPipeline(cfg.vocab_size, FAMILY_TRAIN_BATCH,
                           n_tok).batch_at(0)["tokens"]
    batch = model_batch(cfg, torch.from_numpy(tokens).to(dev), dev)
    step_fn = build_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                               compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, metrics), counts = run_path(f"{label} train step",
                                        lambda: step_fn(state, batch), ())
    step_s = time.perf_counter() - t0
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    ln_v = math.log(cfg.vocab_size)
    if not (math.isfinite(norm)
            and abs(loss - ln_v - loss_offset) <= TRAIN_LOSS_TOL):
        raise AssertionError(f"{label} train step: loss {loss} (ln V = "
                             f"{ln_v:.4f}, + {loss_offset:.4f}), grad norm "
                             f"{norm}")
    if counts:
        raise AssertionError(f"{label} train step launched {counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(state.params))
    log(f"{label} train step ({cfg.n_layers} of {get(label).n_layers} "
        f"layers, {n_params / 1e9:.3f} G params, batch "
        f"{FAMILY_TRAIN_BATCH} x {FAMILY_TRAIN_SEQ}, bf16 compute): loss "
        f"{loss:.4f} (ln V = {ln_v:.4f}, expected + {loss_offset:.4f}), "
        f"grad norm {norm:.3f} (finite), {step_s * 1e3:.1f} ms, peak "
        f"memory {peak:.2f} GB  [{card}]")
    del state, step_fn, batch
    _free()
    return {"loss": loss, "ln_v": ln_v, "loss_offset": loss_offset,
            "grad_norm": norm, "step_ms": step_s * 1e3, "peak_mem_gb": peak,
            "params_g": n_params / 1e9, "layers": cfg.n_layers}, counts


def _drawn(cfg, label, dev, what=""):
    """The f32 draw of ``cfg``, timed and logged; (params, G params)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _draw(cfg, dev, torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{label}: {cfg.n_layers} layers{what}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads; {n_params / 1e9:.3f} G params drawn in f32 "
        f"in {time.perf_counter() - t0:.1f} s")
    return params, n_params / 1e9


def family_models(dev, card):
    """Phase 4k: the MoE and MLA families at full width on the card."""
    import dataclasses

    from repro_torch.configs import get

    out, paths = {}, {}

    # (a) qwen2-moe-a2.7b at full width and depth: f32 kernel route
    # against the plain route, then bf16 timings from a fresh bf16 draw
    cfg = get(MOE_ARCH)
    batch = {"tokens": model_prompt(cfg)}
    params, n_params = _drawn(cfg, MOE_ARCH, dev,
                              f" ({cfg.moe.n_experts} experts, "
                              f"{cfg.moe.n_experts_padded} allocated, of "
                              f"{cfg.moe.d_expert}, top {cfg.moe.top_k}, "
                              f"{cfg.moe.n_shared} shared)")
    probe = params["layers"][-1]["moe"]["w_down"][7].to(torch.bfloat16)

    def moe_expect(n):
        return {"decode_partials": cfg.n_layers * n}

    t_f32, err, paths["moe_f32"] = _kernel_vs_plain(
        cfg, MOE_ARCH, params, batch, dev, card, moe_expect)
    peak_f32 = torch.cuda.max_memory_allocated() / 1e9
    log(f"{MOE_ARCH} f32 peak memory {peak_f32:.2f} GB  [{card}]")
    del params
    _free()
    moe, paths["moe_bf16"] = _bf16_serving(
        cfg, MOE_ARCH, batch, dev, card, moe_expect,
        probe=(lambda p: p["layers"][-1]["moe"]["w_down"][7], probe))
    del probe
    out[MOE_ARCH] = dict(moe, params_g=n_params, f32_generate_s=t_f32,
                         f32_max_abs_diff=err, f32_peak_mem_gb=peak_f32,
                         launches_f32=paths["moe_f32"])

    # (b) minicpm3-4b at full width and depth: no ported kernel on its
    # path; the absorbed decode held to the expanded prefill in f32
    cfg = get(MLA_ARCH)
    batch = {"tokens": model_prompt(cfg)}
    params, n_params = _drawn(cfg, MLA_ARCH, dev,
                              f" (MLA q rank {cfg.mla.q_rank}, kv rank "
                              f"{cfg.mla.kv_rank}, rope {cfg.mla.rope_dim})")
    t_f32, err_mla, paths["mla_f32"] = _decode_vs_prefill(
        cfg, MLA_ARCH, params, batch, dev, card,
        "absorbed decode == the expanded prefill")
    peak_f32 = torch.cuda.max_memory_allocated() / 1e9
    log(f"{MLA_ARCH} f32 peak memory {peak_f32:.2f} GB  [{card}]")
    del params
    _free()
    mla, paths["mla_bf16"] = _bf16_serving(cfg, MLA_ARCH, batch, dev, card,
                                           lambda n: {})
    out[MLA_ARCH] = dict(mla, params_g=n_params, f32_generate_s=t_f32,
                         f32_absorbed_vs_expanded=err_mla,
                         f32_peak_mem_gb=peak_f32)

    # (c) one train step of each family at full width, depth cut
    for arch in (MOE_ARCH, MLA_ARCH):
        cut = dataclasses.replace(get(arch), n_layers=FAMILY_TRAIN_LAYERS)
        out[arch]["train"], paths[f"train_{arch}"] = _train_step(
            cut, arch, dev, card)
    return out, paths


# ---------------------------------------------------------------- phase 4l


def modal_families(dev, card):
    """Phase 4l: the VLM, audio and RWKV6 families at full width on the
    card (llava-next-34b's f32 check at VLM_F32_LAYERS layers, its batch
    cut to VLM_BATCH; whisper-tiny and rwkv6-7b at full depth)."""
    import dataclasses
    import math

    from repro_torch.configs import get

    out, paths = {}, {}

    # (a) llava-next-34b: f32 kernel route against the plain route at
    # VLM_F32_LAYERS layers, then bf16 at full depth
    t_phase = time.perf_counter()
    full = get(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_F32_LAYERS)
    batch = model_batch(cfg, model_prompt(cfg, VLM_BATCH), dev)
    params, n_params = _drawn(cfg, VLM_ARCH, dev,
                              f" of {full.n_layers} (the f32 check), "
                              f"{cfg.vlm.n_patches} patches")
    probe = params["layers"][-1]["mlp"]["w_down"].to(torch.bfloat16)
    t_f32, err, paths["vlm_f32"] = _kernel_vs_plain(
        cfg, VLM_ARCH, params, batch, dev, card,
        lambda n: {"decode_partials": cfg.n_layers * n})
    peak_f32 = torch.cuda.max_memory_allocated() / 1e9
    log(f"{VLM_ARCH} f32 peak memory {peak_f32:.2f} GB  [{card}]")
    del params
    _free()
    vlm, paths["vlm_bf16"] = _bf16_serving(
        full, VLM_ARCH, batch, dev, card,
        lambda n: {"decode_partials": full.n_layers * n},
        probe=(lambda p: p["layers"][VLM_F32_LAYERS - 1]["mlp"]["w_down"],
               probe))
    del probe
    out[VLM_ARCH] = dict(
        vlm, f32_params_g=n_params, f32_layers=VLM_F32_LAYERS,
        f32_generate_s=t_f32, f32_max_abs_diff=err,
        f32_peak_mem_gb=peak_f32, launches_f32=paths["vlm_f32"],
        phase_s=time.perf_counter() - t_phase)

    # (b) whisper-tiny at full width and depth: 8 utterances of 1,500
    # frames, decoder prompts of AUDIO_PROMPT tokens
    t_phase = time.perf_counter()
    cfg = get(AUDIO_ARCH)
    batch = model_batch(cfg, model_prompt(cfg, t=AUDIO_PROMPT), dev)
    params, n_params = _drawn(cfg, AUDIO_ARCH, dev,
                              f" + {cfg.encdec.n_enc_layers} encoder "
                              f"layers over {cfg.encdec.n_frames} frames")
    probe = params["layers"][-1]["xattn"]["wv"].to(torch.bfloat16)

    def audio_expect(n):
        return {"decode_partials": cfg.n_layers * n}

    t_f32, err, paths["audio_f32"] = _kernel_vs_plain(
        cfg, AUDIO_ARCH, params, batch, dev, card, audio_expect,
        max_len=AUDIO_MAX_LEN)
    peak_f32 = torch.cuda.max_memory_allocated() / 1e9
    del params
    _free()
    audio, paths["audio_bf16"] = _bf16_serving(
        cfg, AUDIO_ARCH, batch, dev, card, audio_expect,
        probe=(lambda p: p["layers"][-1]["xattn"]["wv"], probe),
        max_len=AUDIO_MAX_LEN)
    del probe
    out[AUDIO_ARCH] = dict(audio, params_g=n_params, f32_generate_s=t_f32,
                           f32_max_abs_diff=err, f32_peak_mem_gb=peak_f32,
                           launches_f32=paths["audio_f32"],
                           phase_s=time.perf_counter() - t_phase)

    # (c) rwkv6-7b at full width and depth: no kernel on its path; each
    # decode step held to a prefill over the prompt plus its tokens
    t_phase = time.perf_counter()
    cfg = get(RWKV_ARCH)
    batch = {"tokens": model_prompt(cfg, t=RWKV_PROMPT)}
    params, n_params = _drawn(cfg, RWKV_ARCH, dev)
    probe = params["layers"][-1]["rwkv"]["cm_v"].to(torch.bfloat16)
    t_f32, err_rwkv, paths["rwkv_f32"] = _decode_vs_prefill(
        cfg, RWKV_ARCH, params, batch, dev, card,
        "decode after the prefill == a prefill over the longer prompt")
    peak_f32 = torch.cuda.max_memory_allocated() / 1e9
    log(f"{RWKV_ARCH} f32 peak memory {peak_f32:.2f} GB  [{card}]")
    del params
    _free()
    # the WKV loop's share of a prefill: a profiled prefill over the
    # first RWKV_PROFILE_TOKENS tokens (the loop costs the same at every
    # step: four launches per layer and token)
    short = {"tokens": batch["tokens"][:, :RWKV_PROFILE_TOKENS]}
    loop = 4 * cfg.n_layers * RWKV_PROFILE_TOKENS

    def wkv_share(eng):
        prof = profile_calls(lambda: eng.prefill(short), 1)
        log_profile(f"{RWKV_ARCH} prefill of {RWKV_PROFILE_TOKENS} tokens "
                    f"(bf16)", prof, card)
        log(f"{RWKV_ARCH}: the WKV loop launches {loop} of the "
            f"{prof['kernels_per_call']:.0f} kernels of that prefill "
            f"({4 * cfg.n_layers * RWKV_PROMPT} per {RWKV_PROMPT}-token "
            f"prefill)  [{card}]")
        return {"profile_prefill_short": prof,
                "profile_prefill_tokens": RWKV_PROFILE_TOKENS,
                "wkv_loop_launches_short": loop}

    rwkv, paths["rwkv_bf16"] = _bf16_serving(
        cfg, RWKV_ARCH, batch, dev, card, lambda n: {},
        probe=(lambda p: p["layers"][-1]["rwkv"]["cm_v"], probe),
        extra=wkv_share)
    del probe
    out[RWKV_ARCH] = dict(rwkv, f32_generate_s=t_f32,
                          f32_decode_vs_prefill=err_rwkv,
                          f32_peak_mem_gb=peak_f32,
                          phase_s=time.perf_counter() - t_phase)

    # (d) one train step of each family at full width, depth cut to
    # FAMILY_TRAIN_LAYERS (whisper-tiny's full depth); the first loss is
    # centred on ln V + s^2 / 2, the logsumexp of V random logits of
    # spread s = 0.02 sqrt(d_model) (an untied head of std 0.02 over the
    # unit-RMS final norm): 1.43 nats at llava-next-34b's d_model of 7,168
    for arch in (VLM_ARCH, AUDIO_ARCH, RWKV_ARCH):
        cut = dataclasses.replace(get(arch), n_layers=FAMILY_TRAIN_LAYERS)
        spread = 0.02 * math.sqrt(cut.d_model)
        out[arch]["train"], paths[f"train_{arch}"] = _train_step(
            cut, arch, dev, card, loss_offset=spread ** 2 / 2)
    return out, paths


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v) for v in tree]
    return tree.to(torch.bfloat16)


def profile_calls(fn, n: int):
    """Device time and kernel count of ``n`` calls of ``fn`` from the
    profiler's kernel events, beside the host wall time they took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    dev_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:8]
    return {"wall_ms_per_call": wall_ms / n,
            "device_ms_per_call": dev_ms / n,
            "kernel_ms_per_call": {k: v / 1e3 / n
                                   for k, v in by_name.items()},
            "kernels_per_call": len(kernels) / n,
            "device_busy_share": dev_ms / wall_ms if wall_ms else 0.0,
            "top_kernels_ms_per_call": [(k[:60], v / 1e3 / n)
                                        for k, v in top],
            "top_host_ops_ms_per_call": [(k[:60], v / 1e3 / n, c / n)
                                         for k, v, c in host]}


def kernel_times(fn, n: int, ms: float):
    """{kernel name: device ms per call} of ``fn`` under the profiler,
    held to ``ms``, the call's time from CUDA events: the profiler has
    been seen to keep the kernels of only some of the calls it traced, so
    a trace whose kernels do not add up to within 25% of ``ms`` is taken
    again, and after three such traces the passes are not measured (an
    empty dict)."""
    for _ in range(3):
        prof = profile_calls(fn, n)
        if abs(prof["device_ms_per_call"] - ms) <= 0.25 * ms:
            return dict(prof["top_kernels_ms_per_call"])
    return {}


def log_profile(label: str, prof, card: str) -> None:
    if prof["kernels_per_call"] == 0:
        log(f"profile {label}: no device events (device time not "
            f"measured)")
        return
    log(f"profile {label}: wall {prof['wall_ms_per_call']:.3f} ms, device "
        f"{prof['device_ms_per_call']:.3f} ms "
        f"({prof['kernels_per_call']:.0f} kernels), device busy share "
        f"{prof['device_busy_share']:.3f}  [{card}]")
    for name, ms in prof["top_kernels_ms_per_call"]:
        log(f"  device {ms:.4f} ms  {name}")
    for name, ms, calls in prof["top_host_ops_ms_per_call"]:
        log(f"  host self {ms:.4f} ms  {calls:.0f} calls  {name}")


# ---------------------------------------------------------------- phase 4


def run_path(name: str, fn, expect):
    """Drive one main path with the launch counts set to 0 just before
    it and read just after; every kernel in ``expect`` must have
    launched.  Returns (fn's result, counts)."""
    from repro_torch.kernels import dispatch

    dispatch.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    log(f"launches during the {name} path: {counts}")
    for k in expect:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"{name} path did not launch {k}")
    return out, counts


def slice_table(table, lo: int, hi: int):
    from repro_torch.core.types import Table

    return Table(table.schema, {c: v[lo:hi] for c, v in
                                table.columns.items()}, dicts=table.dicts)


def stride_table(table, k: int):
    """Every ``k``-th row of a table (the whole horizon, thinned)."""
    from repro_torch.core.types import Table

    return Table(table.schema, {c: v[::k] for c, v in
                                table.columns.items()}, dicts=table.dicts)


def compare_features(gpu, cpu, loose=("ew",)) -> float:
    """Per-request features, finite and of one shape: bitwise, except
    the ``loose`` columns at rtol ``EW_RTOL``."""
    if len(gpu) != len(cpu):
        raise AssertionError(f"{len(gpu)} feature rows != {len(cpu)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if set(a) != set(b):
            raise AssertionError(f"features {sorted(a)} != {sorted(b)}")
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if not np.all(np.isfinite(x)):
                raise AssertionError(f"feature {k}[{i}] not finite: {x}")
            if x.shape != y.shape:
                raise AssertionError(f"feature {k}[{i}] shape {x.shape} "
                                     f"!= {y.shape}")
            if k in loose:
                ok = np.allclose(x, y, rtol=EW_RTOL, atol=1e-6)
            else:
                ok = np.array_equal(x, y)
            if not ok:
                raise AssertionError(f"feature {k}[{i}]: {x} != {y}")
            err = max(err, float(np.max(np.abs(x.astype(np.float64) - y))))
    return err


def compare_offline(name: str, got, want, n_rows: int) -> float:
    """Offline features on the card against the plain-fold run: finite
    (the deployment has no NULL), of the base table's length, bitwise
    except ``ew`` (rtol 1e-5)."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: features {list(got)} != "
                             f"{list(want)}")
    err = 0.0
    for k in want:
        x, y = got[k], want[k]
        if x.shape[0] != n_rows or not np.all(np.isfinite(x)):
            raise AssertionError(f"{name}: feature {k} has shape "
                                 f"{x.shape} or non-finite values")
        ok = (np.allclose(x, y, rtol=EW_RTOL, atol=1e-6) if k == "ew"
              else np.array_equal(x, y))
        if not ok:
            raise AssertionError(f"{name}: feature {k} != plain fold")
        err = max(err, float(np.max(np.abs(x.astype(np.float64) - y))))
    return err


def compare_tolerance(name: str, got, want, exact) -> float:
    """Whole-table features: the ``exact`` columns bitwise, the rest at
    ``SEED_TOL`` as the reference's consistency gate reads it (a column
    passes when its max abs diff is within atol or its max diff relative
    to max(|want|, 1) within rtol); returns the max abs diff."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: features {sorted(got)} != "
                             f"{sorted(want)}")
    err = 0.0
    for k in want:
        x = np.asarray(got[k], np.float64)
        y = np.asarray(want[k], np.float64)
        if x.shape != y.shape or not np.all(np.isfinite(x)):
            raise AssertionError(f"{name}: feature {k} has shape {x.shape} "
                                 f"or non-finite values")
        d = np.abs(x - y)
        dmax = float(d.max()) if d.size else 0.0
        rel = float((d / np.maximum(np.abs(y), 1.0)).max()) if d.size \
            else 0.0
        ok = (dmax == 0.0 if k in exact
              else dmax <= SEED_TOL["atol"] or rel <= SEED_TOL["rtol"])
        if not ok:
            raise AssertionError(f"{name}: feature {k} differs (max abs "
                                 f"{dmax}, rel {rel})")
        err = max(err, dmax)
    return err


def key_abs_totals(tables, col: str = "price") -> np.ndarray:
    """Per key, the sum of |col| over its rows in every table: the
    magnitude a prefix over the key's history reaches."""
    keys = [t.columns["userid"] for t in tables.values()]
    tot = np.zeros(int(max(k.max() for k in keys)) + 1)
    for t, k in zip(tables.values(), keys):
        np.add.at(tot, k, np.abs(t.columns[col].astype(np.float64)))
    return tot


def key_history_abs(tables, col: str = "price") -> np.ndarray:
    """Per base row, the sum of |col| over its key's rows in every
    table: the magnitude the seed baseline's prefixes reach."""
    return key_abs_totals(tables, col)[tables["actions"].columns["userid"]]


def compare_seed(got, want, tables) -> float:
    """The seed baseline against ``offline()``: the additive columns
    within the prefix bound, every other column as
    ``compare_tolerance`` (count, distinct count, min, max and the hash
    bitwise)."""
    bar = SEED_TOL["atol"] + SEED_PREFIX_ULPS * 2.0**-24 * key_history_abs(
        tables)
    err = 0.0
    for k in SEED_ADDITIVE:
        d = np.abs(np.asarray(got[k], np.float64) - want[k])
        if not np.all(d <= bar):
            raise AssertionError(f"seed baseline: {k} beyond the prefix "
                                 f"bound (max abs {float(d.max())})")
        err = max(err, float(d.max()))
    rest = [k for k in want if k not in SEED_ADDITIVE]
    return max(err, compare_tolerance(
        "seed baseline", {k: got[k] for k in rest},
        {k: want[k] for k in rest},
        exact=("c", "dc", "mn", "mx", "cat_h")))


def store_arrays(eng):
    """An engine's store as numpy arrays (``load_store_from``'s input)."""
    return {t: {"keys": st["keys"].cpu().numpy(),
                "ts": st["ts"].cpu().numpy(),
                "count": st["count"].cpu().numpy(),
                "cols": {c: v.cpu().numpy() for c, v in st["cols"].items()}}
            for t, st in eng.store.tables.items()}


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def same_tree(name: str, a, b) -> None:
    for x, y in zip(_leaves(a), _leaves(b)):
        same_bits(name, x, y)


def latencies(fn, rows, reps: int):
    """Host-inclusive p50/p99 of ``fn(rows[:b])`` per B (CUDA events;
    every call ends by copying features to the host)."""
    out = {}
    for b in BATCHES:
        for _ in range(3):
            fn(rows[:b])
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(rows[:b])
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        out[b] = {"p50_ms": float(np.percentile(samples, 50)),
                  "p99_ms": float(np.percentile(samples, 99))}
    return out


def log_latency(label: str, lat, reps: int, card: str) -> None:
    for b, r in lat.items():
        log(f"{label} B={b}: p50 {r['p50_ms']:.3f} ms, p99 "
            f"{r['p99_ms']:.3f} ms over {reps} batches  [{card}]")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phase 4e


def staged_path(tables, eng, reqs, served, off, card):
    """The staged fold (``fused_fold=False``) on a copy of 4a's store:
    ``request_batch`` and ``request`` against 4a's fused features,
    ``offline()`` against 4b's, and the seed baseline
    (``run_reference_serial``) at the reduction-order bar."""
    from repro_torch.core import multiwindow
    from repro_torch.serve.engine import FeatureEngine

    n_act = len(tables["actions"])
    staged = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                           fused_fold=False, device="cuda")
    staged.load_store_from(store_arrays(eng))

    def serve():
        return ({b: staged.request_batch(reqs[:b]) for b in BATCHES},
                staged.request(reqs[0]))

    (got, one), counts = run_path("staged serving", serve,
                                  ("feature_hash",))
    paths = {"staged_serving": counts}
    err = max(compare_features(got[b], served[b]) for b in BATCHES)
    compare_features([one], got[1], loose=())
    t0 = time.perf_counter()
    st_off, counts = run_path("staged offline", staged.offline,
                              ("feature_hash",))
    t_off_first = time.perf_counter() - t0
    paths["staged_offline"] = counts
    err_off = compare_offline("staged offline", st_off, off, n_act)
    _, t_off = timed(staged.offline)
    t0 = time.perf_counter()
    seed, counts = run_path(
        "seed baseline",
        lambda: multiwindow.run_reference_serial(staged.cs, tables,
                                                 device="cuda"),
        ("feature_hash",))
    t_seed = time.perf_counter() - t0
    paths["seed_baseline"] = counts
    err_seed = compare_seed(seed, st_off, tables)
    # the same baseline in plain torch on the host CPU: the same bits
    # (ew within rtol 1e-5)
    t0 = time.perf_counter()
    compare_offline("seed baseline on the CPU", seed,
                    multiwindow.run_reference_serial(staged.cs, tables,
                                                     device="cpu"), n_act)
    t_seed_cpu = time.perf_counter() - t0
    for name, c in paths.items():
        if c.get("unit_fold", 0):
            raise AssertionError(f"{name} launched the unit-fold kernel")
    log(f"staged request_batch B={BATCHES} equal 4a's fused features "
        f"(bitwise; ew within rtol {EW_RTOL}, max abs diff {err}); "
        f"request(row 0) equals B=1 bitwise; staged offline equals 4b's "
        f"(max abs diff {err_off}); seed baseline equals it (c, dc, mn, "
        f"mx, cat_h bitwise; s, a within {SEED_PREFIX_ULPS} float32 ulps "
        f"of the key history's |price| sum; the rest at rtol "
        f"{SEED_TOL['rtol']} / atol {SEED_TOL['atol']}; max abs diff "
        f"{err_seed}) and its own CPU run (bitwise, ew within rtol "
        f"{EW_RTOL}; {t_seed_cpu:.1f} s on the host)")
    lat = latencies(staged.request_batch, reqs, STAGED_REPS)
    log_latency("staged request_batch", lat, STAGED_REPS, card)
    prof = profile_calls(lambda: staged.request_batch(reqs[:256]), 3)
    log_profile("staged request_batch B=256", prof, card)
    log(f"staged offline over {n_act + len(tables['orders'])} rows: first "
        f"call {t_off_first:.2f} s (plan + upload + fold), plan cached "
        f"{t_off * 1e3:.1f} ms; seed baseline {t_seed * 1e3:.1f} ms  "
        f"[{card}]")
    return {"latency": lat, "profile_b256": prof,
            "offline_first_s": t_off_first, "offline_cached_ms": t_off * 1e3,
            "seed_baseline_ms": t_seed * 1e3}, paths


# ---------------------------------------------------------------- phase 4f


def long_windows(card):
    """``use_preagg`` serving of LONG_SQL at deployment size: planes
    maintained by bulk load and ingest, requests against a CPU engine on
    copies of the store and planes and against ``offline()``, and
    ``verify_consistency(use_preagg=True)`` over every GATE_STRIDE-th
    row, its bitwise columns from the port's certificate.  Also returns the B = 64
    features (phase 4h holds its sharded planes to them) and the script,
    the planes' nbytes and the gate's certificate (phase 4i)."""
    from repro_torch.core import (certify, compile_script, replay_online,
                                  verify_consistency)
    from repro_torch.data.synthetic import make_action_tables
    from repro_torch.serve.engine import FeatureEngine

    tables = make_action_tables(**DEPLOYMENT_LONG)
    actions, orders = tables["actions"], tables["orders"]
    n_act = len(actions)
    hist_end = n_act - N_LIVE - max(BATCHES)
    eng = FeatureEngine(LONG_SQL, tables, capacity=CAPACITY,
                        use_preagg=True, fused_fold=True, device="cuda")
    cs = eng.cs
    wi, pa = next((i, w.preagg) for i, w in enumerate(cs.windows)
                  if w.preagg is not None)
    shape = (pa.n_keys, pa.n_fine, pa.n_coarse, pa.max_coarse_q,
             pa.max_bucket_rows)
    if shape != LONG_PLANES:
        raise AssertionError(f"pre-agg planes {shape} != {LONG_PLANES}")
    hist = slice_table(actions, 0, hist_end)
    _, t_load = timed(lambda: (eng.bulk_load("actions", hist),
                               eng.bulk_load("orders", orders)))

    def update(pre, name, t):
        # the engine's own inputs: every stored column as float32
        return cs.preagg_update_many(
            pre, name, t.columns["userid"], t.columns["ts"],
            {c: t.columns[c].astype(np.float32) for c in eng._need[name]})

    def fold_loaded():
        pre = cs.init_preagg_states("cuda")
        for name, t in (("actions", hist), ("orders", orders)):
            pre = update(pre, name, t)
        return pre

    planes, t_planes_load = timed(fold_loaded)
    same_tree("planes after bulk_load", planes, eng.pre_states)
    prof_update = profile_calls(lambda: update(
        cs.init_preagg_states("cuda"), "actions", hist), 1)
    del planes
    before = tree_to(eng.pre_states, "cuda")
    live = [actions.row(i) for i in range(hist_end, hist_end + N_LIVE)]
    _, t_ingest = timed(lambda: eng.ingest_many("actions", live))
    live_t = slice_table(actions, hist_end, hist_end + N_LIVE)
    again, t_planes_ingest = timed(lambda: update(before, "actions",
                                                  live_t))
    same_tree("planes after ingest_many", again, eng.pre_states)
    del before, again
    plane_bytes = pa.plane_bytes(eng.pre_states[wi])
    plane_nbytes = sum(t.nbytes for st in eng.pre_states.values()
                       for lvl in ("fine", "coarse")
                       for t in (*st[lvl].values(), st[f"{lvl}_epoch"]))
    log(f"pre-agg planes {LONG_PLANES[:3]} (keys, fine, coarse slots), "
        f"{plane_bytes} bytes; bulk_load {hist_end + len(orders)} rows "
        f"{t_load:.2f} s, of which planes {t_planes_load:.2f} s; "
        f"update_many over the loaded actions: {prof_update['kernels_per_call']:.0f} "
        f"launches, wall {prof_update['wall_ms_per_call']:.0f} ms; "
        f"ingest_many {N_LIVE} rows {t_ingest:.3f} s, of which planes "
        f"{t_planes_ingest:.3f} s  [{card}]")

    base = hist_end + N_LIVE
    reqs = [dict(actions.row(i)) for i in range(base, base + max(BATCHES))]
    served, counts = run_path(
        "long windows", lambda: {b: eng.request_batch(reqs[:b])
                                 for b in BATCHES},
        ("unit_fold", "feature_hash"))
    paths = {"long_windows": counts}
    cpu = FeatureEngine(LONG_SQL, tables, capacity=CAPACITY,
                        use_preagg=True, fused_fold=True, device="cpu")
    cpu.load_store_from(store_arrays(eng))
    cpu.pre_states = tree_to(eng.pre_states, "cpu")
    err = compare_features(served[64], cpu.request_batch(reqs[:64]),
                           loose=LONG_LOOSE)
    del cpu
    # the first request row sees exactly the history offline() sees for
    # it: the stored actions and every order
    off = cs.offline({"actions": slice_table(actions, 0, base + 1),
                      "orders": orders}, device="cuda")
    err_off = compare_tolerance(
        "first request vs offline",
        {k: np.asarray(v)[None] for k, v in served[1][0].items()},
        {k: v[-1:] for k, v in off.items()}, exact=LONG_EXACT_OFFLINE)
    log(f"long-window B=64 card equal to the CPU engine (bitwise; "
        f"{LONG_LOOSE} within rtol {EW_RTOL}; max abs diff {err}); first "
        f"request equal to offline() ({LONG_EXACT_OFFLINE} bitwise, the "
        f"rest within rtol {SEED_TOL['rtol']} / atol {SEED_TOL['atol']}; "
        f"max abs diff {err_off})")
    lat = latencies(eng.request_batch, reqs, STAGED_REPS)
    log_latency("long-window request_batch", lat, STAGED_REPS, card)
    prof = profile_calls(lambda: eng.request_batch(reqs[:256]), 3)
    log_profile("long-window request_batch B=256", prof, card)
    for b in (1, 64):
        p = profile_calls(lambda: eng.request_batch(reqs[:b]), 3)
        log(f"long-window request_batch B={b}: "
            f"{p['kernels_per_call']:.0f} launches per batch, device busy "
            f"share {p['device_busy_share']:.3f}  [{card}]")
    del eng

    thin = {name: stride_table(t, GATE_STRIDE) for name, t in tables.items()}
    n_thin = sum(len(t) for t in thin.values())
    gate_cs = compile_script(LONG_SQL, tables=thin)
    cert, t_cert = timed(lambda: certify(gate_cs, tables=thin))
    gate_bitwise = tuple(cert.bitwise_columns("preagg"))
    log(f"pre-agg gate's bitwise columns from the port's certificate of "
        f"LONG_SQL over {n_thin} thinned rows ({t_cert:.3f} s): "
        f"{gate_bitwise}; GATE_BITWISE (the reference certifier's class): "
        f"{GATE_BITWISE}  [{card}]")
    if gate_bitwise != GATE_BITWISE:
        raise AssertionError(f"certified pre-agg bitwise columns "
                             f"{gate_bitwise} != {GATE_BITWISE}")
    t0 = time.perf_counter()
    online, counts = run_path(
        "pre-agg gate", lambda: replay_online(gate_cs, thin, use_preagg=True,
                                              device="cuda"),
        ("unit_fold", "feature_hash"))
    rep = verify_consistency(gate_cs, thin, use_preagg=True, bitwise=False,
                             online_outputs=online, device="cuda")
    t_gate = time.perf_counter() - t0
    paths["preagg_gate"] = counts
    gate_off = gate_cs.offline(thin, device="cuda")
    for k in gate_bitwise:
        if not np.array_equal(online[k], gate_off[k]):
            raise AssertionError(f"pre-agg gate: {k} not bitwise")
    if not rep.passed:
        raise AssertionError(f"verify_consistency(use_preagg=True): {rep}")
    log(f"verify_consistency(use_preagg=True) on the card over {n_thin} "
        f"rows (every {GATE_STRIDE}th): {rep}; {gate_bitwise} bitwise; "
        f"{t_gate:.1f} s  [{card}]")
    # what phase 4i holds the certifier's memory bound and classes to
    long_cert = {"cs": cs, "plane_nbytes": plane_nbytes,
                 "gate_cert": cert, "gate_certify_s": t_cert}
    return {"plane_bytes": plane_bytes, "latency": lat,
            "profile_b256": prof, "bulk_load_s": t_load,
            "planes_load_s": t_planes_load, "update_many": prof_update,
            "ingest_s": t_ingest, "planes_ingest_s": t_planes_ingest,
            "gate_rows": n_thin, "gate_s": t_gate,
            "gate_bitwise": list(gate_bitwise)}, paths, served[64], long_cert


# ---------------------------------------------------------------- phase 4g


def merged_stream(tables, lo_ts: int):
    """Rows of both tables with ts >= ``lo_ts`` as (table, row) in the
    offline order: ts, then orders before actions, then arrival."""
    ev = []
    for name, t in tables.items():
        ts = t.columns["ts"]
        start = int(np.searchsorted(ts, lo_ts, side="left"))
        ev += [(int(ts[i]), name != "orders", i, name)
               for i in range(start, len(t))]
    ev.sort()
    return [(name, tables[name].row(i)) for _, _, i, name in ev]


def table_runs(stream, max_rows: int = 1 << 30):
    """Consecutive rows of one table as ingest batches (table, rows)."""
    out = []
    for name, row in stream:
        if not out or out[-1][0] != name or len(out[-1][1]) >= max_rows:
            out.append((name, []))
        out[-1][1].append(row)
    return out


def same_features(name: str, a, b) -> None:
    """Byte-identical per-request features."""
    if len(a) != len(b):
        raise AssertionError(f"{name}: {len(a)} rows != {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if set(x) != set(y):
            raise AssertionError(f"{name}: features differ")
        for k in x:
            if np.asarray(x[k]).tobytes() != np.asarray(y[k]).tobytes():
                raise AssertionError(f"{name}: {k}[{i}] {x[k]} != {y[k]}")


def compare_retained(got, want, bar) -> float:
    """A retention engine against one without: counts, distinct counts,
    min, max, drawdown and the hash bitwise, ``ew`` within ``EW_RTOL``,
    the sums within ``bar`` (eviction moves the prefix anchor)."""
    err = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        for k in y:
            a = np.asarray(x[k], np.float64)
            b = np.asarray(y[k], np.float64)
            d = float(np.max(np.abs(a - b)))
            if k in SEED_ADDITIVE:
                ok = d <= bar[i]
            elif k == "ew":
                ok = np.allclose(a, b, rtol=EW_RTOL, atol=1e-6)
            else:
                ok = np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
            if not ok:
                raise AssertionError(f"retention vs none: {k}[{i}] {x[k]} "
                                     f"!= {y[k]}")
            err = max(err, d)
    return err


def open_loop(loop, arrivals, rows) -> None:
    """Open-loop load: arrivals fire on schedule whether or not earlier
    requests completed; the loop steps whenever a flush is due (the
    arrival loop of ``benchmarks/bench_serve_loop.py``)."""
    clock = loop.clock
    t0 = clock.now()
    i = 0
    while i < len(arrivals) or loop.batcher.queue:
        now = clock.now()
        if i < len(arrivals) and now - t0 >= arrivals[i]:
            loop.submit(rows[i % len(rows)], now=now)
            i += 1
            continue
        if loop.batcher.ready(now):
            loop.step(now=now)
            continue
        if i >= len(arrivals):
            loop.run_until_idle()
            break
        time.sleep(50e-6)
    loop.flush()


def warm_loop(loop, rows) -> None:
    """Plan every pad class the loop can hit on its snapshot, then drop
    the samples."""
    b = 1
    while b <= loop.batch_size:
        loop.engine.request_batch(rows[:b], snapshot=loop.snap)
        b *= 2
    loop.reset_stats()


def loop_pcts(loop):
    p = loop.latency_percentiles()
    return {k: p[k] for k in ("TP50", "TP99", "TP999", "max_ms")}


def int_priced(tables):
    """Copies of ``tables`` with integer-valued float32 prices (every
    sum exact, whatever rows a compaction removed)."""
    from repro_torch.core.types import Table

    return {name: Table(t.schema, {
        c: (np.floor(v).astype(np.float32) if c == "price" else v.copy())
        for c, v in t.columns.items()}, dicts=t.dicts)
        for name, t in tables.items()}


def serving_loop(tables, card):
    """``ServeLoop`` over a retention engine at deployment size: (a)
    snapshot isolation across a compaction, (b) latency under the loop,
    (c) a CPU-recorded trace replayed on the card, (d) the consistency
    gate through the loop."""
    from repro_torch.core import verify_consistency
    from repro_torch.kernels import dispatch
    from repro_torch.serve import (ServeLoop, SystemClock, TraceRecorder,
                                   VirtualClock, load_trace,
                                   record_consistency_trace, replay,
                                   save_trace)
    from repro_torch.serve.engine import FeatureEngine
    from repro_torch.serve.trace import (outputs_in_base_order,
                                         store_state_arrays)

    actions, orders = tables["actions"], tables["orders"]
    ts_a, ts_o = actions.columns["ts"], orders.columns["ts"]
    cut_ts = int(ts_a[len(actions) - LOOP_STREAM])
    cut_a = int(np.searchsorted(ts_a, cut_ts, side="left"))
    cut_o = int(np.searchsorted(ts_o, cut_ts, side="left"))
    stream = merged_stream(tables, cut_ts)
    kw = dict(fused_fold=True, retention="auto",
              compact_every=COMPACT_EVERY)
    eng = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY, device="cuda",
                        **kw)
    if eng.retention_ms != RETAINED:
        raise AssertionError(f"retention {eng.retention_ms} != {RETAINED}")
    _, t_load = timed(lambda: (
        eng.bulk_load("actions", slice_table(actions, 0, cut_a)),
        eng.bulk_load("orders", slice_table(orders, 0, cut_o))))
    plain = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                          fused_fold=True, device="cuda")
    plain.load_store_from(store_arrays(eng))
    compactions = []
    store_evict = eng.store.evict

    def timed_evict(table, horizon):
        before = eng.store.n_rows(table)
        _, dt = timed(lambda: store_evict(table, horizon))
        compactions.append({"table": table, "before": before,
                            "after": eng.store.n_rows(table), "s": dt})

    eng.store.evict = timed_evict
    log(f"4g cut at ts {cut_ts}: bulk_load {cut_a} actions + {cut_o} "
        f"orders in {t_load:.1f} s; {len(stream)} rows stream after it; "
        f"retention {eng.retention_ms}, compact_every {COMPACT_EVERY}")

    # (a) snapshot isolation across a compaction
    ahead = [dict(r) for name, r in stream[SNAP_ROWS:SNAP_ROWS + 512]
             if name == "actions"]
    probe = ahead[:LOOP_BATCH]
    snap = eng.snapshot()

    def isolation():
        first = eng.request_batch(probe, snapshot=snap)
        for name, rows in table_runs(stream[:SNAP_ROWS]):
            eng.ingest_many(name, rows)
            plain.ingest_many(name, rows)
        again = eng.request_batch(probe, snapshot=snap)
        snap.refresh()
        return first, again, eng.request_batch(probe, snapshot=snap)

    (first, again, fresh), counts = run_path(
        "serving loop: snapshot", isolation, ("unit_fold", "feature_hash"))
    paths = {"loop_snapshot": counts}
    same_features("old snapshot across the compaction", first, again)
    if not compactions or compactions[0]["table"] != "orders":
        raise AssertionError(f"no orders compaction in (a): {compactions}")
    cpu = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        fused_fold=True, device="cpu")
    cpu.load_store_from(store_arrays(eng))
    err_cpu = compare_features(fresh, cpu.request_batch(probe))
    del cpu
    key_abs = key_abs_totals(tables)[[int(r["userid"]) for r in probe]]
    bar = SEED_TOL["atol"] + SEED_PREFIX_ULPS * 2.0**-24 * key_abs
    err_plain = compare_retained(fresh, plain.request_batch(probe), bar)
    del plain
    c0 = compactions[0]
    log(f"(a) snapshot served B={LOOP_BATCH} byte-identical before and "
        f"after ingest_many of {SNAP_ROWS} streamed rows; first orders "
        f"compaction {c0['before']} -> {c0['after']} resident rows in "
        f"{c0['s'] * 1e3:.2f} ms ({len(compactions)} compactions, "
        f"{sum(x['table'] == 'orders' for x in compactions)} of orders); "
        f"refreshed: equal to a CPU engine on copies of the store "
        f"(bitwise, ew within rtol {EW_RTOL}; max abs diff {err_cpu}); "
        f"against a card engine without retention: c, dc, mn, mx, dd, "
        f"cat_h bitwise, s and a within {SEED_PREFIX_ULPS} ulps of the "
        f"key history (max abs diff {err_plain})  [{card}]")

    # (b) latency under the loop, SystemClock
    b1 = []
    for _ in range(60):
        t0 = time.perf_counter()
        eng.request_batch(probe[:1], snapshot=snap)
        b1.append((time.perf_counter() - t0) * 1e3)
    p50_b1 = float(np.percentile(b1[10:], 50))
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(2 * p50_b1 * 1e-3,
                                         size=LOOP_SPARSE))

    def latency():
        out = {"b1_p50_ms": p50_b1, "gap_ms": 2 * p50_b1}
        for mode, wait in (("deadline", LOOP_WAIT_MS), ("count_only", None)):
            loop = ServeLoop(eng, clock=SystemClock(), batch_size=LOOP_BATCH,
                             max_wait_ms=wait, slo_ms=LOOP_SLO_MS)
            warm_loop(loop, ahead)
            open_loop(loop, arrivals, ahead)
            out[mode] = dict(loop_pcts(loop), **{
                k: loop.stats[k] for k in ("served", "deadline_flushes",
                                           "size_flushes", "forced_flushes",
                                           "deadline_misses")})
        loop = ServeLoop(eng, clock=SystemClock(), batch_size=LOOP_BATCH,
                         max_wait_ms=LOOP_WAIT_MS, slo_ms=LOOP_SLO_MS)
        warm_loop(loop, ahead)
        pos = SNAP_ROWS
        for _ in range(LOOP_WAVES):
            wave = [dict(r) for name, r in stream[pos:pos + 256]
                    if name == "actions"][:LOOP_BATCH]
            for r in wave:
                loop.submit(r)
            loop.step()
            for name, rows in table_runs(stream[pos:pos + LOOP_BATCH]):
                loop.ingest(name, rows)
            loop.drain_ingest()
            pos += LOOP_BATCH
        loop.run_until_idle()
        out["mixed"] = dict(loop_pcts(loop), **{
            k: loop.stats[k] for k in ("served", "snapshot_swaps",
                                       "ingest_applies", "deadline_misses",
                                       "backpressure_applies")})
        out["mixed"]["ingest"] = eng.ingest_stats()
        out["resident_orders"] = eng.store.n_rows("orders")
        out["resident_actions"] = eng.store.n_rows("actions")
        out["binlog"] = len(eng.store.binlog)
        before = dispatch.launch_counts()
        for r in probe:
            loop.submit(r)
        loop.step()
        after = dispatch.launch_counts()
        out["flush_launches"] = {k: after[k] - before.get(k, 0)
                                 for k in after}
        out["profile_flush"] = profile_calls(
            lambda: ([loop.submit(r) for r in probe], loop.step()), 5)
        # the loop's own cost: a flush through it (64 submits + step)
        # against request_batch on the same snapshot, in turns
        via_loop, direct = [], []
        for _ in range(50):
            t0 = time.perf_counter()
            for r in probe:
                loop.submit(r)
            loop.step()
            via_loop.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            eng.request_batch(probe, snapshot=loop.snap)
            direct.append((time.perf_counter() - t0) * 1e3)
        out["flush_loop_ms"] = float(np.median(via_loop))
        out["flush_direct_ms"] = float(np.median(direct))
        t0 = time.perf_counter()
        for _ in range(1000):
            loop.snap.refresh()
        out["refresh_us"] = (time.perf_counter() - t0) * 1e3
        return out

    lat, counts = run_path("serving loop: latency", latency,
                           ("unit_fold", "feature_hash"))
    paths["loop_latency"] = counts
    # resident orders: at most a window's worth after a tick, plus the
    # rows of one tick interval and one ingest chunk
    per_window = int(np.max(np.searchsorted(ts_o, ts_o + WINDOW_MS,
                                            side="right")
                            - np.arange(len(ts_o))))
    if lat["resident_orders"] > per_window + COMPACT_EVERY + LOOP_BATCH:
        raise AssertionError(f"orders not bounded: {lat['resident_orders']}"
                             f" > {per_window} + {COMPACT_EVERY} + "
                             f"{LOOP_BATCH}")
    if lat["binlog"] > 2 * COMPACT_EVERY + LOOP_BATCH:
        raise AssertionError(f"binlog not bounded: {lat['binlog']}")
    fl = lat["flush_launches"]
    if fl.get("unit_fold", 0) != 2 or fl.get("feature_hash", 0) != 1:
        raise AssertionError(f"one flush launched {fl}")
    for mode in ("deadline", "count_only", "mixed"):
        r = lat[mode]
        rest = {k: v for k, v in r.items()
                if k not in ("TP50", "TP99", "TP999", "max_ms")}
        log(f"(b) {mode}: TP50 {r['TP50']:.3f} / TP99 {r['TP99']:.3f} / "
            f"TP999 {r['TP999']:.3f} / max {r['max_ms']:.3f} ms; {rest}  "
            f"[{card}]")
    log(f"(b) sparse arrivals: Poisson, mean gap {lat['gap_ms']:.3f} ms (2x "
        f"the B=1 p50 {lat['b1_p50_ms']:.3f} ms); after the mixed loop: "
        f"{lat['resident_orders']} orders and {lat['resident_actions']} "
        f"actions resident, binlog {lat['binlog']} entries; "
        f"{len(compactions)} compactions in all, orders ones "
        f"{[round(x['s'] * 1e3, 2) for x in compactions if x['table'] == 'orders']} ms")
    log(f"(b) one flush of B={LOOP_BATCH}: launches {fl}; median of 50 "
        f"through the loop {lat['flush_loop_ms']:.3f} ms, request_batch "
        f"on the same snapshot {lat['flush_direct_ms']:.3f} ms; snapshot "
        f"refresh {lat['refresh_us']:.2f} us  [{card}]")
    log_profile(f"loop flush B={LOOP_BATCH}", lat["profile_flush"], card)

    # (c) a CPU-recorded trace replayed on the card
    lo_ts = cut_ts - TRACE_HISTORY_MS
    hist = {name: slice_table(t, int(np.searchsorted(
        t.columns["ts"], lo_ts, side="left")), cut)
        for (name, t), cut in zip((("actions", actions),
                                   ("orders", orders)), (cut_a, cut_o))}

    def trace_engine(device):
        e = FeatureEngine(SMOKE_SQL, tables, capacity=TRACE_CAPACITY,
                          device=device, **kw)
        for name, t in hist.items():
            e.bulk_load(name, t)
        return e

    loop_kw = dict(batch_size=LOOP_BATCH, max_wait_ms=LOOP_WAIT_MS,
                   slo_ms=LOOP_SLO_MS,
                   service_model=lambda n: 1.0 + 0.02 * n)
    rec, clock = TraceRecorder(), VirtualClock()
    t0 = time.perf_counter()
    rec_loop = ServeLoop(trace_engine("cpu"), clock=clock, recorder=rec,
                         **loop_kw)
    chunks = table_runs(stream[:TRACE_ROWS], max_rows=16)
    t = 0.0
    for k, (name, rows) in enumerate(chunks):
        t += 2e-3
        if k % 2 == 0:
            rec_loop.submit(ahead[(k // 2) % len(ahead)], now=t)
        rec_loop.ingest(name, rows, now=t)
        rec_loop.step(now=t)
        if k % 50 == 49:
            rec_loop.flush(now=t)
    rec_loop.flush(now=t + 1.0)
    rec_loop.drain_ingest(now=t + 1.0)
    t_rec = time.perf_counter() - t0
    n_orders = sum(name == "orders" for name, _ in stream[:TRACE_ROWS])
    if n_orders < 2 * COMPACT_EVERY or rec_loop.engine.store._binlog_base \
            == 0:
        raise AssertionError(f"the trace crossed no two orders ticks "
                             f"({n_orders} orders rows)")
    path = ROOT / "build" / "chip_smoke" / "loop_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_trace(rec.events, str(path))
    t0 = time.perf_counter()
    card_loop, counts = run_path(
        "serving loop: trace replay",
        lambda: replay(load_trace(str(path)),
                       lambda: trace_engine("cuda"), **loop_kw),
        ("unit_fold", "feature_hash"))
    t_replay = time.perf_counter() - t0
    paths["loop_replay"] = counts
    if card_loop.stats != rec_loop.stats:
        raise AssertionError(f"replay stats {card_loop.stats} != "
                             f"{rec_loop.stats}")
    ids = sorted(rec_loop.results)
    if sorted(card_loop.results) != ids:
        raise AssertionError("replay served other request ids")
    err_trace = compare_features([card_loop.results[i] for i in ids],
                                 [rec_loop.results[i] for i in ids])
    for (pa, a), (pb, b) in zip(store_state_arrays(card_loop.engine),
                                store_state_arrays(rec_loop.engine)):
        if pa != pb or a.tobytes() != b.tobytes():
            raise AssertionError(f"replayed store differs at {pa}")
    log(f"(c) trace of {len(rec.events)} events ({len(ids)} requests, "
        f"{TRACE_ROWS} streamed rows, {n_orders} orders rows) recorded on "
        f"the CPU in {t_rec:.1f} s, replayed on the card in "
        f"{t_replay:.1f} s: stats {card_loop.stats}; features equal "
        f"(bitwise, ew within rtol {EW_RTOL}; max abs diff {err_trace}); "
        f"final store bitwise")
    del rec_loop, card_loop

    # (d) the consistency gate through the loop
    gate = int_priced(prefix_tables(tables, GATE_LOOP_ROWS))
    n_gate = sum(len(t) for t in gate.values())

    def gate_engine():
        return FeatureEngine(SMOKE_SQL, gate, capacity=2 * n_gate,
                             fused_fold=True, retention="auto",
                             compact_every=GATE_LOOP_COMPACT, device="cuda")

    t0 = time.perf_counter()
    (g_loop, events, rids), counts = run_path(
        "serving loop: gate",
        lambda: record_consistency_trace(gate_engine(), gate),
        ("unit_fold", "feature_hash"))
    t_gate = time.perf_counter() - t0
    paths["loop_gate"] = counts
    g_cs = g_loop.engine.cs
    out = outputs_in_base_order(g_loop, rids, gate, g_cs)
    rep = verify_consistency(g_cs, gate, bitwise=True, online_outputs=out,
                             device="cuda")
    if not (rep.passed and rep.bitwise_equal):
        raise AssertionError(f"loop-driven gate: {rep}")
    evicted = n_gate - sum(g_loop.engine.store.n_rows(n) for n in gate)
    if evicted <= 0:
        raise AssertionError("the loop-driven gate evicted no row")
    gpath = path.with_name("gate_trace.json")
    save_trace(events, str(gpath))
    t0 = time.perf_counter()
    again = replay(load_trace(str(gpath)), gate_engine, batch_size=1,
                   max_wait_ms=0.0, slo_ms=1e6)
    t_again = time.perf_counter() - t0
    out2 = outputs_in_base_order(again, rids, gate, g_cs)
    for k in out:
        if out2[k].tobytes() != out[k].tobytes():
            raise AssertionError(f"gate replay: {k} differs")
    for (pa, a), (_, b) in zip(store_state_arrays(again.engine),
                               store_state_arrays(g_loop.engine)):
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"gate replay store differs at {pa}")
    log(f"(d) record_consistency_trace on the card over {n_gate} rows "
        f"({len(rids)} requests; integer prices; {evicted} rows evicted "
        f"mid-trace, compact_every {GATE_LOOP_COMPACT}): {rep} in "
        f"{t_gate:.1f} s; replayed again in {t_again:.1f} s, bitwise "
        f"equal outputs and store  [{card}]")
    c_orders = [x for x in compactions if x["table"] == "orders"]
    return {"cut_ts": cut_ts, "bulk_load_s": t_load,
            "compactions": compactions,
            "first_compaction": c_orders[0], "err_cpu": err_cpu,
            "err_no_retention": err_plain, "latency": lat,
            "trace": {"events": len(rec.events), "requests": len(ids),
                      "record_s": t_rec, "replay_s": t_replay,
                      "max_abs_err": err_trace},
            "gate": {"rows": n_gate, "requests": len(rids),
                     "evicted": evicted, "s": t_gate,
                     "replay_s": t_again}}, paths


# ---------------------------------------------------------------- phase 4i


def tail_tables(tables, n: int):
    """The newest ``n`` rows of each table (the tables are sorted by ts):
    the slice preview runs on."""
    for t in tables.values():
        if np.any(np.diff(t.columns["ts"]) < 0):
            raise AssertionError("deployment table not sorted by ts")
    return {name: slice_table(t, max(0, len(t) - n), len(t))
            for name, t in tables.items()}


def certifier_preview_pipeline(tables, eng, off, prefix, rep_raw, long_cert,
                               card):
    """Phase 4i: the deploy-time certifier against 4b's and 4f's card
    gates and the card's store and planes, Online Preview Mode and the
    training-data pipeline on the card, and the compact row format (§7.1,
    host only).  Returns (results, launch counts per path)."""
    from repro_torch.core import certify, compile_script
    from repro_torch.core.analysis import explain_sharding, memory_bound
    from repro_torch.core.preview import PreviewLimits, preview
    from repro_torch.data import FeatureDataPipeline
    from repro_torch.storage import CompactRowCodec, row_size_spark

    res = {}
    # (a) the certificate
    cert, t_prefix = timed(lambda: certify(
        compile_script(SMOKE_SQL, tables=prefix), tables=prefix))
    raw = cert.bitwise_columns("raw")
    matched = [k for k in cert.features if k not in rep_raw.mismatched]
    if not set(raw) <= set(matched):
        raise AssertionError(f"certified bitwise {raw} not all matched by "
                             f"4b's gate (mismatched {rep_raw.mismatched})")
    log(f"4i certify SMOKE_SQL over 4b's {sum(map(len, prefix.values()))}-"
        f"row prefix in {t_prefix:.3f} s: raw bitwise {raw}, all matched "
        f"bitwise by 4b's gate on the card  [{card}]")
    full, t_full = timed(lambda: certify(eng.cs, tables=tables))
    classes = {k: (e["raw"], sorted({h["rule"] for h in e["rules"]}))
               for k, e in full.consistency["columns"].items()}
    log(f"4i certify SMOKE_SQL over the {sum(map(len, tables.values()))} "
        f"deployment rows in {t_full:.3f} s: {classes}  [{card}]")
    gate = long_cert["gate_cert"]
    log(f"4i certify LONG_SQL over the thinned tables "
        f"({long_cert['gate_certify_s']:.3f} s, in 4f): pre-agg bitwise "
        f"{gate.bitwise_columns('preagg')}, the pre-agg gate's bitwise "
        f"columns (GATE_BITWISE, the reference certifier's: {GATE_BITWISE})"
        f"  [{card}]")
    store_nbytes = sum(t.nbytes for t in _leaves(eng.store.tables))
    mem = memory_bound(eng.cs, capacity=CAPACITY)
    mem_long = memory_bound(long_cert["cs"], capacity=CAPACITY)
    if mem["store_bytes"] != store_nbytes:
        raise AssertionError(f"memory_bound store {mem['store_bytes']} != "
                             f"the card store's {store_nbytes} bytes")
    if mem_long["preagg_bytes"] != long_cert["plane_nbytes"]:
        raise AssertionError(f"memory_bound planes {mem_long['preagg_bytes']}"
                             f" != the card planes' "
                             f"{long_cert['plane_nbytes']} bytes")
    tree = explain_sharding(eng.cs)
    if tree["eligible"] != eng.cs.sharded_eligible()[0]:
        raise AssertionError(f"explain_sharding {tree} != sharded_eligible")
    log(f"4i memory_bound: store {mem['store_bytes']} bytes = the card "
        f"store's tensors ({CAPACITY} slots x 2 tables); LONG_SQL planes "
        f"{mem_long['preagg_bytes']} bytes = 4f's planes on the card; "
        f"explain_sharding eligible={tree['eligible']} (SMOKE_SQL, 4h's "
        f"script)")
    res["certify_s"] = {"prefix": t_prefix, "deployment": t_full,
                        "long_gate": long_cert["gate_certify_s"]}
    res["classes_deployment"] = classes
    res["store_bytes"], res["preagg_bytes"] = (mem["store_bytes"],
                                               mem_long["preagg_bytes"])

    # (b) preview
    res["preview"] = {}
    counts = {}
    for n in (PreviewLimits().max_rows_per_table, PREVIEW_ROWS):
        limits = PreviewLimits(max_rows_per_table=n)
        first, c = run_path(f"preview ({n} rows per table)", lambda: preview(
            SMOKE_SQL, tables, limits=limits, device="cuda"),
            ("unit_fold", "feature_hash"))
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        hit, c_hit = run_path(f"preview ({n} rows, cached)", lambda: preview(
            SMOKE_SQL, tables, limits=limits, device="cuda"), ())
        if first.cache_hit or not hit.cache_hit or c_hit:
            raise AssertionError(f"preview cache: first {first.cache_hit}, "
                                 f"second {hit.cache_hit}, {c_hit}")
        tail = tail_tables(tables, n)
        want = compile_script(SMOKE_SQL, tables=tables).offline(tail,
                                                                "cuda")
        same_features(f"preview ({n} rows) vs offline()", [first.features],
                      [want])
        if first.n_rows != n or not first.truncated:
            raise AssertionError(f"preview rows {first.n_rows}")
        walls = []
        for _ in range(PREVIEW_REPS):
            _, wall = timed(lambda: preview(SMOKE_SQL, tables, limits=limits,
                                            use_cache=False, device="cuda"))
            walls.append(wall * 1e3)
        res["preview"][n] = {"p50_ms": float(np.percentile(walls, 50)),
                             "launches_per_call": c}
        log(f"4i preview SMOKE_SQL at {n} rows per table: features equal "
            f"offline() on the same tail slice on the card (bitwise); "
            f"second call a cache hit (no launch); cold p50 "
            f"{res['preview'][n]['p50_ms']:.3f} ms over {PREVIEW_REPS} "
            f"calls (use_cache=False), launches per call {c}  [{card}]")
    over, c_over = run_path("preview over the limits", lambda: preview(
        SMOKE_SQL, tables, limits=PreviewLimits(max_windows=1),
        device="cuda"), ())
    if over.ok or c_over:
        raise AssertionError(f"over-limit preview: {over.violations}, "
                             f"{c_over}")
    log(f"4i preview over the limits (max_windows=1): {over.violations}, "
        f"no launch")
    paths = {"preview": counts}

    # (c) the training-data pipeline
    pipe = FeatureDataPipeline(compile_script(SMOKE_SQL, tables=tables),
                               tables, batch_size=PIPE_BATCH)
    (feats, t_mat), c = run_path("pipeline", lambda: timed(pipe.materialize),
                                 ("unit_fold", "feature_hash"))
    paths["pipeline"] = c
    same_features("pipeline materialize() vs 4b offline()", [feats], [off])
    mat, t_matrix = timed(pipe.feature_matrix)
    batches, t_batches = timed(lambda: list(pipe.batches(PIPE_BATCHES)))
    rng = np.random.default_rng(0)
    labels = (mat[:, 0] > np.median(mat[:, 0])).astype(np.int32)
    for i, b in enumerate(batches):
        idx = rng.integers(0, mat.shape[0], PIPE_BATCH)
        if b["features"].device.type != pipe.device.type or not (
                np.array_equal(b["features"].cpu().numpy(), mat[idx])
                and np.array_equal(b["labels"].cpu().numpy(), labels[idx])):
            raise AssertionError(f"pipeline batch {i} != matrix rows at the "
                                 f"seeded indices")
    res["pipeline"] = {"materialize_s": t_mat, "matrix_shape": mat.shape,
                       "matrix_s": t_matrix, "batches_s": t_batches}
    log(f"4i FeatureDataPipeline over {len(mat)} rows: materialize() "
        f"{t_mat:.3f} s, equal to 4b's offline() bitwise, launches {c}; "
        f"feature_matrix {mat.shape} {t_matrix:.3f} s; {PIPE_BATCHES} "
        f"batches of {PIPE_BATCH} on the card {t_batches:.3f} s, each the "
        f"matrix rows at the seeded indices  [{card}]")

    # (d) the compact row format, host only
    actions = tables["actions"]
    cats = actions.dicts["category"]
    rows = [dict(r, category=cats.decode(int(r["category"])))
            for r in map(actions.row, range(ROWFMT_ROWS))]
    rows = [{k: (float(v) if k == "price" else v if k == "category"
                 else int(v)) for k, v in r.items()} for r in rows]
    codec = CompactRowCodec(actions.schema)
    bufs, t_enc = timed(lambda: [codec.encode(r) for r in rows])
    back, t_dec = timed(lambda: [codec.decode(b) for b in bufs])
    if back != rows:
        raise AssertionError("compact codec round trip changed a row")
    spark = sum(row_size_spark(actions.schema, r) for r in rows[:1000])
    compact = sum(len(b) for b in bufs[:1000])
    res["row_format"] = {"encode_us_per_row": t_enc / ROWFMT_ROWS * 1e6,
                         "decode_us_per_row": t_dec / ROWFMT_ROWS * 1e6,
                         "paper_example": paper_row_sizes(),
                         "compact_bytes_per_row": compact / 1000,
                         "spark_bytes_per_row": spark / 1000}
    log(f"4i compact rows (host only, no device): {ROWFMT_ROWS} action "
        f"rows encoded {res['row_format']['encode_us_per_row']:.2f} us/row, "
        f"decoded {res['row_format']['decode_us_per_row']:.2f} us/row, "
        f"round trip equal; {compact / 1000:.1f} B/row against Spark's "
        f"{spark / 1000:.1f}; §7.1 example {res['row_format']['paper_example']}"
        f" (compact, Spark)  [host of {card}]")
    return res, paths


def paper_row_sizes():
    """The §7.1 example row (20 ints, 20 floats, 20 one-byte strings, 5
    timestamps): (compact bytes, Spark bytes), which must be (255, 556)."""
    from repro_torch.core.types import Column, ColumnType, TableSchema
    from repro_torch.storage import row_size_compact, row_size_spark

    kinds = (("i", ColumnType.INT, 20), ("f", ColumnType.FLOAT, 20),
             ("s", ColumnType.STRING, 20), ("t", ColumnType.TIMESTAMP, 5))
    schema = TableSchema("paper", tuple(Column(f"{p}{i}", t) for p, t, n
                                        in kinds for i in range(n)))
    row = {}
    for i in range(20):
        row[f"i{i}"], row[f"f{i}"], row[f"s{i}"] = i, float(i), "x"
    for i in range(5):
        row[f"t{i}"] = 1_000_000 + i
    sizes = (row_size_compact(schema, row), row_size_spark(schema, row))
    if sizes != (255, 556):
        raise AssertionError(f"§7.1 example: {sizes} != (255, 556)")
    return sizes


# ---------------------------------------------------------------- phase 4h


def shard_counts(key_cols, assignment=None):
    """Per-shard row counts of each key column under the routing a
    ``ShardedOnlineStore`` of ``SHARDS`` shards starts with (the static
    hash) or under ``assignment``, computed on the host."""
    from repro_torch.storage.timestore import ShardedOnlineStore

    router = ShardedOnlineStore(1, n_shards=SHARDS, n_route_slots=ROUTE_SLOTS,
                                device="cpu")
    if assignment is not None:
        router.assignment = assignment
    return [np.bincount(router.owner_of_keys(k), minlength=SHARDS)
            for k in key_cols]


def shard_capacity(counts) -> int:
    """Per-shard capacity: the largest shard of any table, plus headroom,
    rounded up to a multiple of 1,024."""
    top = int(max(int(c.max()) for c in counts)) + SHARD_HEADROOM
    return (top + 1023) // 1024 * 1024


def paired_latencies(engines, rows, reps: int):
    """p50/p99 of ``request_batch(rows[:b])`` per engine and B, the
    engines timed in turns (a, b, b, a) within this call (CUDA events;
    every call ends by copying features to the host)."""
    out = {name: {} for name in engines}
    order = list(engines) + list(engines)[::-1]
    for b in BATCHES:
        samples = {name: [] for name in engines}
        for name in order:
            fn = engines[name].request_batch
            for _ in range(3):
                fn(rows[:b])
            for _ in range(reps // 2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(rows[:b])
                end.record()
                end.synchronize()
                samples[name].append(start.elapsed_time(end))
        for name, v in samples.items():
            out[name][b] = {"p50_ms": float(np.percentile(v, 50)),
                            "p99_ms": float(np.percentile(v, 99))}
    return out


def sharded_replicas(tables, skewed, eng, served, serving_counts, off,
                     offline_counts, long_b64, card):
    """Phase 4h: the serving deployment over ``SHARDS`` key shards with
    ``REPLICAS`` followers each: bulk load below 4g's cut, stream the rest
    (a kill + heal of the hottest key's shard mid-stream), B = 1, 64, 256
    against 4a's features and launches, latency beside 4a's engine in
    turns, ``offline_sharded`` against 4b, a rebalance of the zipf table
    set, the failover gate over a prefix, and the long-window script's
    sharded planes against 4f.  Returns the sharded engine too (phase 4m
    holds its mesh engine to it)."""
    from repro_torch.core import compile_script, verify_consistency
    from repro_torch.core.union import LoadBalancer
    from repro_torch.data.synthetic import make_action_tables
    from repro_torch.serve.engine import FeatureEngine
    from repro_torch.storage.timestore import route_slots

    actions, orders = tables["actions"], tables["orders"]
    n_act = len(actions)
    hist_end = n_act - N_LIVE - max(BATCHES)
    live_end = hist_end + N_LIVE                 # 4a's stored actions
    ts_a, ts_o = actions.columns["ts"], orders.columns["ts"]
    cut_ts = int(ts_a[n_act - LOOP_STREAM])
    cut_a = int(np.searchsorted(ts_a, cut_ts, side="left"))
    cut_o = int(np.searchsorted(ts_o, cut_ts, side="left"))
    counts = shard_counts([actions.columns["userid"][:live_end],
                           orders.columns["userid"]])
    cap = shard_capacity(counts)
    kw = dict(n_shards=SHARDS, replication=REPLICAS, route_slots=ROUTE_SLOTS,
              ship_every=SHIP_EVERY, fused_fold=True)
    sh = FeatureEngine(SMOKE_SQL, tables, capacity=cap, device="cuda", **kw)
    _, t_load = timed(lambda: (
        sh.bulk_load("actions", slice_table(actions, 0, cut_a)),
        sh.bulk_load("orders", slice_table(orders, 0, cut_o))))
    stream = merged_stream({"actions": slice_table(actions, 0, live_end),
                            "orders": orders}, cut_ts)
    runs = table_runs(stream, max_rows=64)
    hot = int(np.bincount(actions.columns["userid"][:live_end]).argmax())
    victim = int(sh.store.owner_of_keys([hot])[0])
    kill_at, heal_at = len(runs) // 2, (3 * len(runs)) // 4
    t0 = time.perf_counter()
    for i, (name, rows) in enumerate(runs):
        if i == kill_at:
            killed = sh.kill_shard(victim)
        if i == heal_at:
            (rec,) = sh.heal()
        sh.ingest_many(name, rows)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    per_shard = {t: sh.store.n_rows_per_shard(t).tolist()
                 for t in ("actions", "orders")}
    for t, routed in zip(("actions", "orders"), counts):
        if per_shard[t] != routed.tolist():
            raise AssertionError(f"4h {t} per shard {per_shard[t]} != the "
                                 f"host routing {routed.tolist()}")
    repl = sh.replication_stats()
    log(f"4h: {SHARDS} shards x capacity {cap} (largest routed shard "
        f"{max(int(c.max()) for c in counts)}), {REPLICAS} followers each, "
        f"ship every {SHIP_EVERY} rows; bulk_load {cut_a + cut_o} rows "
        f"{t_load:.2f} s; streamed {len(stream)} rows in {len(runs)} "
        f"ingest_many calls {t_stream:.2f} s; rows per shard {per_shard}  "
        f"[{card}]")
    log(f"4h failover: killed shard {victim} (owner of the hottest key "
        f"{hot}) after {kill_at} of {len(runs)} ingest calls, lag at the "
        f"kill {killed['lag_at_kill']} entries, healed after {heal_at}: "
        f"replica {rec.replica} promoted, {rec.replayed_entries} entries "
        f"replayed, recovery_s {rec.recovery_s:.4f}  [{card}]")

    reqs = [dict(actions.row(i)) for i in
            range(live_end, live_end + max(BATCHES))]
    got, counts_sh = run_path(
        "sharded serving", lambda: {b: sh.request_batch(reqs[:b])
                                    for b in BATCHES},
        ("unit_fold", "feature_hash"))
    paths = {"sharded_serving": counts_sh}
    for k in ("unit_fold", "feature_hash"):
        if counts_sh.get(k) != serving_counts.get(k):
            raise AssertionError(f"4h: sharded batches launched "
                                 f"{counts_sh.get(k)} {k}, 4a "
                                 f"{serving_counts.get(k)}")
    err = max(compare_features(got[b], served[b]) for b in BATCHES)
    log(f"4h B=1/64/256 after kill + heal equal to 4a's never-killed "
        f"unsharded engine (bitwise; ew within rtol {EW_RTOL}; max abs "
        f"diff {err}); launches {counts_sh} = 4a's {serving_counts}")
    lat = paired_latencies({"unsharded": eng, "sharded": sh}, reqs,
                           SHARD_REPS)
    prof = {}
    for name, e in (("unsharded", eng), ("sharded", sh)):
        log_latency(f"4h {name} request_batch", lat[name], SHARD_REPS, card)
        for b in BATCHES:
            p = profile_calls(lambda: e.request_batch(reqs[:b]), 3)
            prof[f"{name}/B{b}"] = {
                k: p[k] for k in ("kernels_per_call", "device_busy_share",
                                  "device_ms_per_call", "wall_ms_per_call")}
            log(f"4h {name} B={b}: {p['kernels_per_call']:.0f} kernels per "
                f"batch, device {p['device_ms_per_call']:.3f} ms, busy "
                f"share {p['device_busy_share']:.3f}  [{card}]")

    off_sh, counts_off = run_path("offline sharded", sh.offline,
                                  ("unit_fold",))
    paths["offline_sharded"] = counts_off
    if counts_off["unit_fold"] != offline_counts["unit_fold"]:
        raise AssertionError(f"4h offline_sharded: {counts_off} launches, "
                             f"offline() {offline_counts}")
    for k in off:
        if not np.array_equal(off_sh[k], off[k]):
            raise AssertionError(f"4h offline_sharded: {k} != offline()")
    _, t_off = timed(sh.offline)
    log(f"4h offline_sharded({SHARDS}) over {n_act + len(orders)} rows "
        f"bitwise equal to 4b's offline(), {counts_off['unit_fold']} "
        f"unit-fold launches as there; {t_off * 1e3:.1f} ms per call "
        f"(plan cached)  [{card}]")
    del off_sh
    torch.cuda.empty_cache()

    # rebalance on the zipf table set: the LPT the store will run, from
    # the same slot loads, sizes the shards before the load
    keys = [skewed[t].columns["userid"] for t in ("actions", "orders")]
    router = LoadBalancer(ROUTE_SLOTS, SHARDS, split_threshold=float("inf"))
    router.observe(sum(np.bincount(route_slots(k, ROUTE_SLOTS),
                                   minlength=ROUTE_SLOTS).astype(np.float64)
                       for k in keys))
    before = shard_counts(keys)
    after = shard_counts(keys, router.rebalance())
    cap_r = shard_capacity(before + after)
    rb = FeatureEngine(SMOKE_SQL, skewed, capacity=cap_r, n_shards=SHARDS,
                       route_slots=ROUTE_SLOTS, fused_fold=True,
                       device="cuda")
    for t in ("actions", "orders"):
        rb.bulk_load(t, skewed[t])
    probe = [dict(skewed["actions"].row(len(skewed["actions"]) - 1 - i))
             for i in range(64)]
    owner0 = rb.store.owner_of_keys(np.concatenate(keys))
    ahead = rb.request_batch(probe)
    rows_before = sum(rb.store.n_rows_per_shard(t) for t in ("actions",
                                                             "orders"))
    moved, t_rebal = timed(rb.rebalance)
    rows_after = sum(rb.store.n_rows_per_shard(t) for t in ("actions",
                                                            "orders"))
    n_moved = int((rb.store.owner_of_keys(np.concatenate(keys))
                   != owner0).sum())
    same_features("4h rebalance", rb.request_batch(probe), ahead)
    imb = [float(r.max() / r.mean()) for r in (rows_before, rows_after)]
    if not moved or imb[1] >= imb[0]:
        raise AssertionError(f"4h rebalance: moved={moved}, imbalance "
                             f"{imb[0]:.3f} -> {imb[1]:.3f}")
    log(f"4h rebalance (zipf {SKEW_ALPHA}, capacity {cap_r}): {n_moved} "
        f"rows moved in {t_rebal:.3f} s; rows per shard "
        f"{rows_before.tolist()} -> {rows_after.tolist()}; imbalance "
        f"(max / mean) {imb[0]:.3f} -> {imb[1]:.3f}; B=64 bitwise equal "
        f"before and after  [{card}]")
    del rb
    torch.cuda.empty_cache()

    # the failover gate over a prefix: the owner of base request k is
    # killed and failed over just before serving it
    prefix = prefix_tables(tables, SHARD_GATE_ROWS)
    n_req = len(prefix["actions"])
    t0 = time.perf_counter()
    rep, counts_gate = run_path(
        "sharded failover gate",
        lambda: verify_consistency(
            compile_script(SMOKE_SQL, tables=prefix), prefix, bitwise=True,
            n_shards=SHARDS, replication=REPLICAS,
            kill_shard_at=n_req // 2, device="cuda"),
        ("unit_fold", "feature_hash"))
    t_gate = time.perf_counter() - t0
    paths["sharded_gate"] = counts_gate
    if not (rep.passed and rep.bitwise_equal):
        raise AssertionError(f"4h failover gate: {rep}")
    log(f"4h verify_consistency(bitwise, n_shards={SHARDS}, replication="
        f"{REPLICAS}, kill_shard_at={n_req // 2}) over a {SHARD_GATE_ROWS}-"
        f"row prefix ({n_req} requests): {rep}; {t_gate:.1f} s  [{card}]")

    # the long-window script on sharded planes against 4f's engine
    long_t = make_action_tables(**DEPLOYMENT_LONG)
    la, lo = long_t["actions"], long_t["orders"]
    l_hist = len(la) - N_LIVE - max(BATCHES)
    l_counts = shard_counts([la.columns["userid"][:l_hist + N_LIVE],
                             lo.columns["userid"]])
    lsh = FeatureEngine(LONG_SQL, long_t, capacity=shard_capacity(l_counts),
                        use_preagg=True, fused_fold=True, n_shards=SHARDS,
                        route_slots=ROUTE_SLOTS, device="cuda")
    _, t_lload = timed(lambda: (
        lsh.bulk_load("actions", slice_table(la, 0, l_hist)),
        lsh.bulk_load("orders", lo)))
    lsh.ingest_many("actions", [la.row(i) for i in
                                range(l_hist, l_hist + N_LIVE)])
    base = l_hist + N_LIVE
    lreqs = [dict(la.row(i)) for i in range(base, base + 64)]
    lgot, counts_long = run_path("sharded long windows",
                                 lambda: lsh.request_batch(lreqs),
                                 ("unit_fold", "feature_hash"))
    paths["sharded_long_windows"] = counts_long
    err_l = compare_features(lgot, long_b64, loose=LONG_LOOSE)
    log(f"4h long windows on {SHARDS}-shard planes: bulk_load "
        f"{l_hist + len(lo)} rows {t_lload:.2f} s; B=64 equal to 4f's "
        f"unsharded engine (bitwise; {LONG_LOOSE} within rtol {EW_RTOL}; "
        f"max abs diff {err_l})  [{card}]")
    del lsh
    torch.cuda.empty_cache()
    return {"capacity": cap, "rows_per_shard": per_shard,
            "bulk_load_s": t_load, "stream_s": t_stream,
            "stream_rows": len(stream), "killed": killed,
            "promotion": {"shard": rec.shard, "replica": rec.replica,
                          "replayed_entries": rec.replayed_entries,
                          "recovery_s": rec.recovery_s},
            "replication": {k: repl[k] for k in (
                "max_lag_seen", "n_shipped", "safe_offset")},
            "latency": lat, "profile": prof, "offline_ms": t_off * 1e3,
            "rebalance": {"rows_moved": n_moved, "s": t_rebal,
                          "imbalance": imb, "capacity": cap_r,
                          "rows_before": rows_before.tolist(),
                          "rows_after": rows_after.tolist()},
            "gate": {"rows": SHARD_GATE_ROWS, "requests": n_req,
                     "s": t_gate},
            "long_bulk_load_s": t_lload}, paths, sh


# ---------------------------------------------------------------- phase 4m


def mesh_placed(eng, mesh) -> None:
    """Every shard's tables on its mesh entry's device, one shard each;
    every follower on the entry (s + 1 + r) % n."""
    from repro_torch.distributed.sharding import canonical_device

    entries = list(mesh.devices.flat)
    for t, parts in eng.store.tables.items():
        for s, st in enumerate(parts):
            if st["keys"].shape[0] != 1 or \
                    st["keys"].device != canonical_device(entries[s]):
                raise AssertionError(f"4m {t} shard {s} lies on "
                                     f"{st['keys'].device}, not {entries[s]}")
    if eng.repl is not None:
        for (s, r), f in eng.repl.followers.items():
            if f.device is not entries[(s + 1 + r) % len(entries)]:
                raise AssertionError(f"4m follower ({s}, {r}) on the wrong "
                                     f"mesh entry")


def mesh_features(tables, sh, served, paths, shard_res, off, dev, card):
    """Phase 4m (a): 4h's deployment (SHARDS shards, REPLICAS followers,
    ROUTE_SLOTS, SHIP_EVERY) on a ``Mesh`` of SHARDS entries naming the
    card: bulk load below 4g's cut, the rest through ``ingest_many`` in
    chunks of 64 per table; B = 1, 64, 256 against 4h's stacked engine
    ``sh`` (bitwise, ew at rtol 1e-5), launches beside 4h's, latency in
    turns with ``sh``; ``offline()`` bitwise 4b's; a kill + heal of the
    hottest key's shard; the failover gate on the mesh over 4h's prefix;
    ``key_shard_mesh()`` over the visible cards (one on a one-card host)
    against 4a's features, and with two or more cards the SHARDS-shard
    deployment over them."""
    from repro_torch.core import compile_script, verify_consistency
    from repro_torch.distributed.sharding import (Mesh, cuda_devices,
                                                  key_shard_mesh)
    from repro_torch.serve.engine import FeatureEngine

    actions, orders = tables["actions"], tables["orders"]
    n_act = len(actions)
    live_end = n_act - max(BATCHES)
    cut_ts = int(actions.columns["ts"][n_act - LOOP_STREAM])
    cut_a = int(np.searchsorted(actions.columns["ts"], cut_ts, side="left"))
    cut_o = int(np.searchsorted(orders.columns["ts"], cut_ts, side="left"))
    kw = dict(replication=REPLICAS, route_slots=ROUTE_SLOTS,
              ship_every=SHIP_EVERY, fused_fold=True)
    mesh = Mesh([dev] * SHARDS, ("shard",))
    me = FeatureEngine(SMOKE_SQL, tables, capacity=sh.store.capacity,
                       mesh=mesh, **kw)
    _, t_load = timed(lambda: (
        me.bulk_load("actions", slice_table(actions, 0, cut_a)),
        me.bulk_load("orders", slice_table(orders, 0, cut_o))))
    rest = {"actions": slice_table(actions, cut_a, live_end),
            "orders": slice_table(orders, cut_o, len(orders))}
    n_calls = 0
    t0 = time.perf_counter()
    for name, t in rest.items():
        rows = [t.row(i) for i in range(len(t))]
        for i in range(0, len(rows), 64):
            me.ingest_many(name, rows[i:i + 64])
            n_calls += 1
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    for t in ("actions", "orders"):
        if me.store.n_rows_per_shard(t).tolist() != \
                sh.store.n_rows_per_shard(t).tolist():
            raise AssertionError(f"4m {t}: rows per shard differ from 4h's")
    mesh_placed(me, mesh)
    log(f"4m mesh of {SHARDS} entries naming {dev}: bulk_load "
        f"{cut_a + cut_o} rows {t_load:.2f} s; streamed "
        f"{sum(len(t) for t in rest.values())} rows in {n_calls} "
        f"ingest_many calls {t_stream:.2f} s; rows per shard equal 4h's; "
        f"every shard's tables on its entry, followers on (s + 1 + r) % "
        f"{SHARDS}  [{card}]")

    reqs = [dict(actions.row(i)) for i in
            range(live_end, live_end + max(BATCHES))]
    got, counts_m = run_path(
        "mesh serving", lambda: {b: me.request_batch(reqs[:b])
                                 for b in BATCHES},
        ("unit_fold", "feature_hash"))
    out_paths = {"mesh_serving": counts_m}
    err = max(compare_features(got[b], sh.request_batch(reqs[:b]))
              for b in BATCHES)
    per_b = {}
    for b in BATCHES:
        _, per_b[b] = run_path(f"mesh serving B={b}",
                               lambda b=b: me.request_batch(reqs[:b]), ())
    log(f"4m B=1/64/256 equal to 4h's stacked engine (bitwise; ew within "
        f"rtol {EW_RTOL}; max abs diff {err}); launches for the three "
        f"batches {counts_m} (4h: {paths['sharded_serving']}); per batch "
        f"{per_b}")
    lat = paired_latencies({"stacked": sh, "mesh": me}, reqs, SHARD_REPS)
    prof = {}
    for name, e in (("stacked", sh), ("mesh", me)):
        log_latency(f"4m {name} request_batch", lat[name], SHARD_REPS, card)
    for b in BATCHES:
        p = profile_calls(lambda: me.request_batch(reqs[:b]), 3)
        prof[f"mesh/B{b}"] = {k: p[k] for k in (
            "kernels_per_call", "device_busy_share", "device_ms_per_call",
            "wall_ms_per_call")}
        log(f"4m mesh B={b}: {p['kernels_per_call']:.0f} kernels per batch "
            f"(4h stacked {shard_res['profile'][f'sharded/B{b}']['kernels_per_call']:.0f}), "
            f"device {p['device_ms_per_call']:.3f} ms, busy share "
            f"{p['device_busy_share']:.3f}  [{card}]")

    off_m, counts_off = run_path("mesh offline", me.offline, ("unit_fold",))
    out_paths["mesh_offline"] = counts_off
    for k in off:
        if not np.array_equal(off_m[k], off[k]):
            raise AssertionError(f"4m mesh offline: {k} != 4b's offline()")
    del off_m
    _, t_off = timed(me.offline)
    log(f"4m mesh offline() over {n_act + len(orders)} rows bitwise equal to "
        f"4b's; {counts_off['unit_fold']} unit-fold launches (4h stacked "
        f"{paths['offline_sharded']['unit_fold']}); {t_off * 1e3:.1f} ms per "
        f"call (plan cached)  [{card}]")

    hot = int(np.bincount(actions.columns["userid"][:live_end]).argmax())
    victim = int(me.store.owner_of_keys([hot])[0])
    before = me.request_batch(reqs[:64])
    me.ship_replicas()        # the followers' tail and a heartbeat
    killed = me.kill_shard(victim)
    (rec,) = me.heal()
    mesh_placed(me, mesh)
    same_features("4m kill + heal", me.request_batch(reqs[:64]), before)
    log(f"4m kill of shard {victim} (owner of the hottest key {hot}; lag "
        f"{killed['lag_at_kill']}) + heal: replica {rec.replica} promoted, "
        f"{rec.replayed_entries} entries replayed, recovery_s "
        f"{rec.recovery_s:.4f}; B=64 bitwise equal before and after  "
        f"[{card}]")
    del me
    torch.cuda.empty_cache()

    prefix = prefix_tables(tables, SHARD_GATE_ROWS)
    n_req = len(prefix["actions"])
    t0 = time.perf_counter()
    rep, counts_gate = run_path(
        "mesh failover gate",
        lambda: verify_consistency(
            compile_script(SMOKE_SQL, tables=prefix), prefix, bitwise=True,
            mesh=Mesh([dev] * SHARDS, ("shard",)), replication=REPLICAS,
            kill_shard_at=n_req // 2),
        ("unit_fold", "feature_hash"))
    t_gate = time.perf_counter() - t0
    out_paths["mesh_gate"] = counts_gate
    if not (rep.passed and rep.bitwise_equal):
        raise AssertionError(f"4m mesh failover gate: {rep}")
    log(f"4m verify_consistency(bitwise, mesh of {SHARDS} entries, "
        f"replication={REPLICAS}, kill_shard_at={n_req // 2}) over a "
        f"{SHARD_GATE_ROWS}-row prefix ({n_req} requests): {rep}; "
        f"{t_gate:.1f} s (4h stacked {shard_res['gate']['s']:.1f} s)  "
        f"[{card}]")

    # key_shard_mesh(): one shard per visible card, 4a's store
    cards = cuda_devices()
    one = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        mesh=key_shard_mesh(), fused_fold=True)
    hist_end = live_end - N_LIVE
    one.bulk_load("actions", slice_table(actions, 0, hist_end))
    one.bulk_load("orders", orders)
    one.ingest_many("actions", [actions.row(i)
                                for i in range(hist_end, live_end)])
    got_one, counts_one = run_path(
        "key_shard_mesh serving", lambda: {b: one.request_batch(reqs[:b])
                                           for b in BATCHES},
        ("unit_fold", "feature_hash"))
    out_paths["key_shard_mesh_serving"] = counts_one
    err_one = max(compare_features(got_one[b], served[b]) for b in BATCHES)
    del one
    torch.cuda.empty_cache()
    log(f"4m key_shard_mesh() over {len(cards)} visible card(s): "
        f"{len(cards)} shard(s) of 4a's store, B=1/64/256 equal to 4a's "
        f"(bitwise; ew within rtol {EW_RTOL}; max abs diff {err_one})  "
        f"[{card}]")
    multi = None
    if len(cards) >= 2:
        grid = Mesh([cards[i % len(cards)] for i in range(SHARDS)],
                    ("shard",))
        mc = FeatureEngine(SMOKE_SQL, tables, capacity=sh.store.capacity,
                           mesh=grid, **kw)
        mc.bulk_load("actions", slice_table(actions, 0, live_end))
        mc.bulk_load("orders", orders)
        mesh_placed(mc, grid)
        multi = max(compare_features(mc.request_batch(reqs[:b]),
                                     sh.request_batch(reqs[:b]))
                    for b in BATCHES)
        del mc
        log(f"4m {SHARDS}-shard deployment over {len(cards)} cards: "
            f"B=1/64/256 equal to 4h's (max abs diff {multi})")
    return {"bulk_load_s": t_load, "stream_s": t_stream,
            "ingest_calls": n_calls, "launches_per_batch": per_b,
            "latency": lat, "profile": prof, "offline_ms": t_off * 1e3,
            "promotion": {"shard": rec.shard, "replica": rec.replica,
                          "replayed_entries": rec.replayed_entries,
                          "recovery_s": rec.recovery_s},
            "gate": {"rows": SHARD_GATE_ROWS, "requests": n_req,
                     "s": t_gate},
            "visible_cards": len(cards), "multi_card_err": multi}, out_paths


def mesh_states(cfg, b, dtype, mesh, dev):
    """The ``meta`` decode state of ``b`` rows at MESH_SEQ positions, its
    specs (``cache_pspecs``, whose K/V spec at this length is the
    decode's own: entry (d, s) holds data block d, chunk s) and its
    filler: ``fill(state)`` draws every K/V block of ``mesh``'s grid from
    the seed in entry order, into a piece on the generator's card or
    through one piece-shaped buffer there (a whole cache's block, a
    piece on another card: the same values either way), and sets every
    length to MESH_LIVE."""
    from repro_torch.distributed.sharding import (Placed, cache_pspecs,
                                                  shard_slices)
    from repro_torch.models.model import init_decode_state
    from repro_torch.models.sharded_decode import decode_cache_spec

    meta = init_decode_state(cfg, b, MESH_SEQ, dtype=dtype, device="meta")
    specs = cache_pspecs(cfg, meta, mesh)
    kv = decode_cache_spec(b, mesh)
    if any(lc["attn"][k] != kv for lc in specs["layers"] for k in "kv"):
        raise AssertionError(f"4m: cache_pspecs {specs['layers'][0]} is "
                             f"not the decode's {kv}")
    shape = (b, MESH_SEQ, cfg.n_kv_heads, cfg.head_dim)
    blocks = [shard_slices(shape, kv, mesh, i)
              for i in np.ndindex(mesh.devices.shape)]

    def fill(state):
        gen = torch.Generator(device=dev).manual_seed(23)
        buf = None
        for lc in state["layers"]:
            for t in (lc["attn"]["k"], lc["attn"]["v"]):
                parts = (list(t.pieces.flat) if isinstance(t, Placed)
                         else [t[sl] for sl in blocks])
                for part in parts:
                    if part.is_contiguous() and part.device == gen.device:
                        part.normal_(generator=gen)
                        continue
                    # a whole cache's block, or a piece on another card
                    if buf is None:
                        buf = torch.empty(part.shape, dtype=part.dtype,
                                          device=gen.device)
                    part.copy_(buf.normal_(generator=gen))
        state["len"] = torch.full((b,), MESH_LIVE, dtype=torch.int32,
                                  device=dev)
        return state

    return specs, meta, fill


def mesh_decode(dev, card):
    """Phase 4m (b) and (d): llama3-8b at full width and depth, every
    sequence's cache filled from the seed to MESH_LIVE of MESH_SEQ
    positions, one decode token at a time on a cache in pieces (one
    contiguous tensor per mesh entry, allocated from ``meta``) and on a
    whole cache.  (b) entries that all name the card: in float32 at
    MESH_F32_BATCH on (1, 4) and (2, 2) meshes, MESH_STEPS steps of
    seeded tokens through the kernel, against the unsharded decode and
    the pieces through the plain versions (logits within MESH_TOL),
    entries x layers x steps launches, the bytes each entry holds equal
    to ``per_device_bytes``; then in bf16 at MESH_BATCH on (1, 4),
    per-token p50 / p99 of pieces and unsharded in turns (each turn its
    own state), launches a token, busy share, peak memory.  (d) with two
    or more cards, the same over (1, n) distinct cards, n = 4 where four
    are visible, else 2: the f32 check and the bytes per card, then bf16
    at MESH_BATCH x n rows (with 4 cards a cache no one card holds)."""
    from repro_torch.configs import get
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import (Mesh, device_put,
                                                  entry_bytes,
                                                  named_shardings,
                                                  per_device_bytes)
    from repro_torch.models.model import decode_step, init_decode_state

    cfg = get(MESH_ARCH)

    def grid(shape, devices=None):
        devs = np.empty(shape, dtype=object)
        for i in np.ndindex(shape):
            devs[i] = dev if devices is None else devices[i[-1]]
        return Mesh(devs, ("data", "model"))

    def new_state(b, dtype, mesh, pieces):
        """(state, filled from the seed in ``mesh``'s block order; pieces
        on ``mesh`` or whole on the card), and the bytes per entry placed
        against ``per_device_bytes`` (None when whole)."""
        specs, meta, fill = mesh_states(cfg, b, dtype, mesh, dev)
        if not pieces:
            return fill(init_decode_state(cfg, b, MESH_SEQ, dtype=dtype,
                                          device=dev)), None
        state = device_put(meta, named_shardings(specs, mesh))
        placed = entry_bytes(state)
        want = per_device_bytes(meta, specs, mesh)
        if not (placed == want).all():
            raise AssertionError(f"4m: bytes per entry {placed.tolist()}, "
                                 f"per_device_bytes {want}")
        return fill(state), want

    def tokens(b, n, seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, (n, b, 1), generator=gen,
                             dtype=torch.int32)

    def run(params, state, toks, mesh, use_kernel=None):
        out = []
        with runtime.use_mesh(mesh):
            for t in toks:
                logits, state = decode_step(cfg, params, state, t.to(dev),
                                            use_kernel=use_kernel)
                out.append(logits.float().cpu())
        return torch.stack(out)

    def f32_check(params, mesh, label):
        """The pieces through the kernel against the unsharded decode and
        the pieces through the plain versions, one state at a time."""
        n_entries = mesh.devices.size
        toks = tokens(MESH_F32_BATCH, MESH_STEPS, 5)
        state, per_entry = new_state(MESH_F32_BATCH, torch.float32, mesh,
                                     True)
        got, counts = run_path(f"pieces decode {label} (f32)",
                               lambda: run(params, state, toks, mesh),
                               ("decode_partials",))
        want_launch = n_entries * cfg.n_layers * MESH_STEPS
        if counts.get("decode_partials") != want_launch:
            raise AssertionError(f"4m {label}: {counts} launches, expected "
                                 f"{want_launch} decode_partials")
        check_logits([x.numpy() for x in got], cfg, MESH_F32_BATCH)
        plain, counts_plain = run_path(
            f"pieces decode {label}, plain versions (f32)",
            lambda: run(params, new_state(MESH_F32_BATCH, torch.float32,
                                          mesh, True)[0], toks, mesh,
                        use_kernel=False), ())
        if counts_plain.get("decode_partials", 0):
            raise AssertionError(f"4m {label}: plain route launched "
                                 f"decode_partials")
        del state
        _free()
        one_state = new_state(MESH_F32_BATCH, torch.float32, mesh, False)[0]
        one, counts_one = run_path(f"unsharded decode {label} (f32)",
                                   lambda: run(params, one_state, toks,
                                               None),
                                   ("decode_partials",))
        del one_state
        _free()
        err_one = compare(f"4m pieces {label} vs unsharded", got, one,
                          rtol=MESH_TOL, atol=MESH_TOL)
        err_plain = compare(f"4m pieces {label} vs plain", got, plain,
                            rtol=MESH_TOL, atol=MESH_TOL)
        log(f"4m {MESH_ARCH} f32 B={MESH_F32_BATCH}, cache {MESH_SEQ} "
            f"filled to {MESH_LIVE}, in pieces on {label}: {MESH_STEPS} "
            f"steps ({counts['decode_partials']} decode_partials launches "
            f"= {n_entries} entries x {cfg.n_layers} layers x "
            f"{MESH_STEPS}, {counts_one['decode_partials']} unsharded) "
            f"within {MESH_TOL} of the unsharded decode (max abs diff "
            f"{err_one}) and of the plain versions ({err_plain}); bytes "
            f"per entry = per_device_bytes = {per_entry}  [{card}]")
        return {"err_unsharded": err_one, "err_plain": err_plain,
                "entry_bytes": per_entry, "launches": counts,
                "launches_unsharded": counts_one}

    t_phase = time.perf_counter()
    params = _draw(cfg, dev, torch.float32)
    n_params = sum(p.numel() for p in _leaves(params))
    torch.cuda.reset_peak_memory_stats()
    res = {"params_g": n_params / 1e9, "f32": {}}
    counts_all = {}
    for shape in ((1, MESH_SEQ_SHARDS), (2, 2)):
        label = f"({shape[0]}, {shape[1]}) of the card"
        r = f32_check(params, grid(shape), label)
        res["f32"][f"{shape[0]}x{shape[1]}"] = r
        counts_all[f"pieces_decode_f32_{shape[0]}x{shape[1]}"] = \
            r["launches"]
        counts_all[f"unsharded_decode_f32_{shape[0]}x{shape[1]}"] = \
            r["launches_unsharded"]
    res["f32_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    _free()

    # bf16: timed in turns (unsharded, pieces, pieces, unsharded), each
    # turn on a state of its own (the whole cache and its pieces together
    # would not fit beside the weights)
    torch.cuda.reset_peak_memory_stats()
    params = _draw(cfg, dev, torch.bfloat16)
    mesh = grid((1, MESH_SEQ_SHARDS))
    toks = tokens(MESH_BATCH, 2 * MESH_TOKENS + 16, 7).to(dev)
    it = iter(toks)
    times = {"unsharded": [], "pieces": []}
    launches, busy = {}, {}
    for turn, route in enumerate(("unsharded", "pieces", "pieces",
                                  "unsharded")):
        on = mesh if route == "pieces" else None
        state = new_state(MESH_BATCH, torch.bfloat16, mesh,
                          route == "pieces")[0]

        def step():
            nonlocal state
            with runtime.use_mesh(on):
                logits, state = decode_step(cfg, params, state, next(it))
            return logits

        step()                                          # warm-up
        for _ in range(MESH_TOKENS // 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step()
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
        check_logits([logits.float().cpu().numpy()], cfg, MESH_BATCH)
        if turn >= 2:                  # each route's second turn
            _, launches[route] = run_path(f"{route} decode token (bf16)",
                                          step, ("decode_partials",))
            busy[route] = busy_share(step)
        if turn == 3:
            # phase 4n (b): one unsharded token counted, against its p50
            from repro_torch.configs import ShapeSpec

            tok = toks[0]
            at = int(state["len"][0])
            p50 = float(np.percentile(times["unsharded"], 50))
            res["roofline"] = step_roofline(
                f"{MESH_ARCH} decode_32k token (bf16, B={MESH_BATCH}, cache "
                f"{MESH_SEQ} at {at}, unsharded)", cfg,
                ShapeSpec("decode", at + 1, MESH_BATCH, "decode"),
                lambda: decode_step(cfg, params, state, tok),
                lambda: decode_step(cfg, meta_tree(params), meta_tree(state),
                                    meta_tree(tok)), p50, card)
            res["len_at_end"] = at
        del state
        _free()
    if launches["pieces"]["decode_partials"] != \
            MESH_SEQ_SHARDS * launches["unsharded"]["decode_partials"]:
        raise AssertionError(f"4m bf16 launches {launches}")
    res["bf16_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["launches"] = launches
    res["busy"] = {r: {k: v for k, v in b.items() if k != "top_kernels_ms"}
                   for r, b in busy.items()}
    for route, v in times.items():
        res[f"{route}_ms_p50"] = float(np.percentile(v, 50))
        res[f"{route}_ms_p99"] = float(np.percentile(v, 99))
        res[f"{route}_ms"] = v
        log(f"4m {MESH_ARCH} bf16 B={MESH_BATCH} decode ({route}"
            + (f", (1, {MESH_SEQ_SHARDS}) of the card" if route == "pieces"
               else "") + f") per token p50 {res[f'{route}_ms_p50']:.2f} ms, "
            f"p99 {res[f'{route}_ms_p99']:.2f} ms over {len(v)} tokens in two "
            f"turns (PERF.md §5's earlier record on this shape: the "
            f"clipped whole-cache mesh 80.32, unsharded 49.80); "
            f"{launches[route]['decode_partials']} decode_partials "
            f"a token; {busy[route]['kernels']} kernels, device "
            f"{busy[route]['device_ms']:.2f} ms, busy share "
            f"{busy[route]['device_busy_share']:.3f}  [{card}]")
    log(f"4m {MESH_ARCH} bf16 peak memory {res['bf16_peak_gb']:.2f} GB (a "
        f"cache of {MESH_BATCH} x {MESH_SEQ} at a time); phase 4m (b) "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    counts_all["pieces_decode_bf16"] = launches["pieces"]
    counts_all["unsharded_decode_bf16"] = launches["unsharded"]
    del params
    _free()
    res["distinct"], counts = mesh_decode_distinct(cfg, grid, new_state,
                                                   tokens, run, card)
    counts_all.update(counts)
    return res, counts_all


def mesh_decode_distinct(cfg, grid, new_state, tokens, run, card):
    """Phase 4m (d): the pieces over (1, n) distinct cards, n = 4 where
    four are visible, else 2 (a count the sequence divides by); one line
    saying so where only one is visible."""
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import cuda_devices
    from repro_torch.models.model import decode_step

    cards = cuda_devices()
    if len(cards) < 2:
        log(f"4m (d) did not run: {len(cards)} CUDA device visible; the "
            f"pieces over distinct cards need two or more (phase 4m (b) "
            f"ran them on entries that repeat this card)  [{card}]")
        return {"ran": False, "cards": len(cards)}, {}
    t0 = time.perf_counter()
    n = 4 if len(cards) >= 4 else 2          # 32,768 positions divide by n
    cards = cards[:n]
    dev = cards[0]
    mesh = grid((1, n), cards)
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[:n]
    out = {"ran": True, "cards": names}

    def held():
        return [torch.cuda.memory_allocated(c) for c in cards]

    params = _draw(cfg, dev, torch.float32)
    toks = tokens(MESH_F32_BATCH, MESH_STEPS, 5)
    before = held()
    state, per_entry = new_state(MESH_F32_BATCH, torch.float32, mesh, True)
    grew = [a - b for a, b in zip(held(), before)]
    got, counts = run_path(f"pieces decode over {n} cards (f32)",
                           lambda: run(params, state, toks, mesh),
                           ("decode_partials",))
    if counts.get("decode_partials") != n * cfg.n_layers * MESH_STEPS:
        raise AssertionError(f"4m (d): {counts} launches")
    del state
    _free()
    one_state = new_state(MESH_F32_BATCH, torch.float32, mesh, False)[0]
    one = run(params, one_state, toks, None)
    del one_state, params
    _free()
    err = compare(f"4m (d) pieces over {n} cards vs unsharded", got, one,
                  rtol=MESH_TOL, atol=MESH_TOL)
    log(f"4m (d) {MESH_ARCH} f32 B={MESH_F32_BATCH} in pieces over {n} "
        f"cards {names}: within {MESH_TOL} of the unsharded decode on "
        f"{dev} (max abs diff {err}); {counts['decode_partials']} "
        f"decode_partials launches; bytes per card = per_device_bytes = "
        f"{per_entry}, allocated {grew}")
    out.update(f32_err=err, entry_bytes=per_entry, allocated=grew,
               launches_f32=counts)
    params = _draw(cfg, dev, torch.bfloat16)
    b = MESH_BATCH * n
    state, per_entry = new_state(b, torch.bfloat16, mesh, True)
    it = iter(tokens(b, MESH_TOKENS + 2, 7).to(dev))

    def step():
        nonlocal state
        with runtime.use_mesh(mesh):
            logits, state = decode_step(cfg, params, state, next(it))
        return logits

    step()
    ms = []
    for _ in range(MESH_TOKENS):
        for c in cards:
            torch.cuda.synchronize(c)
        t1 = time.perf_counter()
        logits = step()
        for c in cards:
            torch.cuda.synchronize(c)
        ms.append((time.perf_counter() - t1) * 1e3)
    check_logits([logits.float().cpu().numpy()], cfg, b)
    _, launches = run_path(f"pieces decode token over {n} cards (bf16)",
                           step, ("decode_partials",))
    peaks = [torch.cuda.max_memory_allocated(c) / 1e9 for c in cards]
    out.update(batch=b, cache_gb=2 * cfg.n_layers * b * MESH_SEQ
               * cfg.n_kv_heads * cfg.head_dim * 2 / 1e9,
               bf16_ms=ms, bf16_ms_p50=float(np.percentile(ms, 50)),
               bf16_ms_p99=float(np.percentile(ms, 99)),
               bf16_entry_bytes=per_entry, launches_bf16=launches,
               peak_gb=peaks, phase_s=time.perf_counter() - t0)
    log(f"4m (d) {MESH_ARCH} bf16 B={b} in pieces over {n} cards (cache "
        f"{out['cache_gb']:.1f} GB, {per_entry / 1e9:.2f} GB a card): "
        f"per token p50 {out['bf16_ms_p50']:.2f} ms, p99 "
        f"{out['bf16_ms_p99']:.2f} ms over {MESH_TOKENS} tokens; "
        f"{launches['decode_partials']} decode_partials a token; peak "
        f"{[round(p, 2) for p in peaks]} GB; {out['phase_s']:.1f} s  "
        f"{names}")
    del state, params
    _free()
    return out, {"pieces_decode_f32_distinct": counts,
                 "pieces_decode_bf16_distinct": launches}


# ---------------------------------------------------------------- phase 4o


def pieces_mesh(devices):
    """A (1, n) ("data", "model") mesh over ``devices`` (entries may
    repeat a device)."""
    from repro_torch.distributed.sharding import Mesh

    return Mesh(np.array([list(devices)], dtype=object), ("data", "model"))


def place_megatron(cfg, params, mesh):
    """``params`` placed by ``param_pspecs(strategy="megatron")`` on
    ``mesh`` (a ``meta`` tree: zero pieces, allocated entry by entry),
    and the bytes each entry holds, equal to ``per_device_bytes``."""
    from repro_torch.distributed.sharding import (device_put, entry_bytes,
                                                  named_shardings,
                                                  param_pspecs,
                                                  per_device_bytes)

    specs = param_pspecs(cfg, params, mesh, strategy="megatron")
    placed = device_put(params, named_shardings(specs, mesh))
    held = entry_bytes(placed)
    want = per_device_bytes(params, specs, mesh)
    if not (held == want).all():
        raise AssertionError(f"4o {cfg.name}: bytes per entry "
                             f"{held.tolist()}, per_device_bytes {want}")
    return placed, want


def busy_by_card(fn):
    """One call of ``fn`` under the profiler (CUDA activity): per card,
    its records, ``decode_partials`` launches (the split kernel's
    records, ``LAUNCH_EVENTS``), device ms and busy share of the call's
    wall time."""
    from repro_torch.distributed.sharding import cuda_devices
    from torch.profiler import ProfilerActivity, profile

    cards = cuda_devices()
    for c in cards:
        torch.cuda.synchronize(c)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for c in cards:
            torch.cuda.synchronize(c)
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        r = per.setdefault(int(e.device_index()), {
            "kernels": 0, "decode_partials": 0, "device_ms": 0.0})
        r["kernels"] += 1
        r["device_ms"] += (e.end_ns() - e.start_ns()) / 1e6
        r["decode_partials"] += any(
            p in e.name() for p in LAUNCH_EVENTS["decode_partials"])
    for r in per.values():
        r["busy_share"] = r["device_ms"] / wall_ms
    return {"wall_ms": wall_ms, "cards": dict(sorted(per.items()))}


def pieces_f32(arch, where, mesh, dev, card):
    """Phase 4o's float32 check of ``arch`` at full width and
    PIECES_F32[arch] layers: the params drawn whole on ``dev`` (seed 0),
    placed on ``mesh``; ``generate_greedy`` of PIECES_F32_TOKENS through
    the pieces and the kernels (entries x layers x tokens
    ``decode_partials`` launches, the cache in KV-head pieces on the
    mesh's devices), then teacher-forced through the pieces (kernels,
    then plain versions) and the unsharded model: logits within
    PIECES_TOL."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.distributed.sharding import Placed, canonical_device
    from repro_torch.serve.engine import ServingEngine

    cfg = dataclasses.replace(get(arch), n_layers=PIECES_F32[arch])
    n = mesh.devices.size
    label = f"4o {arch} ({cfg.n_layers} layers) in pieces over {where}"
    params = _draw(cfg, dev, torch.float32)
    placed, per_entry = place_megatron(cfg, params, mesh)
    batch = {"tokens": model_prompt(cfg, PIECES_F32_BATCH,
                                    PIECES_F32_PROMPT)}
    max_len = PIECES_F32_PROMPT + PIECES_F32_TOKENS
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, placed, max_len=max_len, dtype=torch.float32)
    tokens, counts = run_path(
        f"{label} (f32)",
        lambda: eng.generate_greedy(batch, PIECES_F32_TOKENS),
        ("decode_partials",))
    want_launch = n * cfg.n_layers * PIECES_F32_TOKENS
    if counts.get("decode_partials") != want_launch:
        raise AssertionError(f"{label}: {counts} launches, expected "
                             f"{want_launch} decode_partials")
    k0 = eng.state["layers"][0]["attn"]["k"]
    if not isinstance(k0, Placed) or [t.device for t in k0.pieces.flat] \
            != [canonical_device(d) for d in mesh.devices.flat]:
        raise AssertionError(f"{label}: the cache is not in KV-head pieces "
                             f"on the mesh's devices ({k0!r})")
    got = teacher_forced(eng, batch, tokens)
    del eng
    _free()
    plain = teacher_forced(ServingEngine(cfg, placed, max_len=max_len,
                                         dtype=torch.float32,
                                         use_kernel=False), batch, tokens)
    del placed
    _free()
    one = teacher_forced(ServingEngine(cfg, params, max_len=max_len,
                                       dtype=torch.float32, device=dev),
                         batch, tokens)
    del params
    _free()
    check_logits(got, cfg, PIECES_F32_BATCH)
    errs = {}
    for name, want in (("unsharded", one), ("plain", plain)):
        errs[name] = max(compare(f"{label} vs {name} step {i}",
                                 torch.from_numpy(x), torch.from_numpy(y),
                                 rtol=PIECES_TOL, atol=PIECES_TOL)
                         for i, (x, y) in enumerate(zip(got, want)))
    if not np.array_equal(np.stack([x.argmax(-1) for x in got[:-1]], 1),
                          tokens):
        raise AssertionError(f"{label}: teacher-forced argmax differs from "
                             f"generate_greedy's tokens")
    secs = time.perf_counter() - t0
    log(f"{label} f32 B={PIECES_F32_BATCH} x {PIECES_F32_PROMPT} + "
        f"{PIECES_F32_TOKENS} greedy tokens: prefill and decode logits "
        f"within {PIECES_TOL} of the unsharded model (max abs diff "
        f"{errs['unsharded']}) and of the pieces through the plain versions "
        f"({errs['plain']}); {counts['decode_partials']} decode_partials "
        f"launches = {n} entries x {cfg.n_layers} layers x "
        f"{PIECES_F32_TOKENS}; bytes per entry = per_device_bytes = "
        f"{per_entry}; {secs:.1f} s  [{card}]")
    return {"err_unsharded": errs["unsharded"], "err_plain": errs["plain"],
            "entry_bytes": per_entry, "launches": counts, "s": secs}


def pieces_bf16_turns(dev, card):
    """Phase 4o (a)'s timing: llama3-8b at full width and depth in bf16,
    whole on the card and in pieces on (1, 4) entries of it, prefill
    PIECES_BATCH x PIECES_PROMPT and PIECES_TOKENS decode tokens a route
    in two turns (unsharded, pieces, pieces, unsharded; seeded tokens):
    prefill ms and per-token p50 / p99, one token's launches and busy
    share each route's second turn, peak memory."""
    from repro_torch.configs import get
    from repro_torch.serve.engine import ServingEngine

    cfg = get(PIECES_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = _draw(cfg, dev, torch.bfloat16)
    placed, per_entry = place_megatron(cfg, params,
                                       pieces_mesh([dev] * PIECES_N))
    max_len = PIECES_PROMPT + PIECES_TOKENS
    engines = {"unsharded": ServingEngine(cfg, params, max_len=max_len,
                                          dtype=torch.bfloat16, device=dev),
               "pieces": ServingEngine(cfg, placed, max_len=max_len,
                                       dtype=torch.bfloat16)}
    batch = {"tokens": model_prompt(cfg, PIECES_BATCH, PIECES_PROMPT)}
    gen = torch.Generator().manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (PIECES_TOKENS // 2 + 2,
                                             PIECES_BATCH, 1),
                         generator=gen, dtype=torch.int32).numpy()
    for eng in engines.values():                              # warm-up
        eng.generate_greedy({"tokens": batch["tokens"][:, :16]}, 2)
    res = {r: {"prefill_ms": [], "ms": []} for r in engines}
    launches, busy = {}, {}
    for turn, route in enumerate(("unsharded", "pieces", "pieces",
                                  "unsharded")):
        eng = engines[route]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = eng.prefill(batch)
        res[route]["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        for i in range(PIECES_TOKENS // 2):
            t0 = time.perf_counter()
            last = eng.decode(toks[i])
            res[route]["ms"].append((time.perf_counter() - t0) * 1e3)
        check_logits([first, last], cfg, PIECES_BATCH)
        if turn >= 2:                          # each route's second turn
            _, launches[route] = run_path(
                f"4o {PIECES_ARCH} {route} decode token (bf16)",
                lambda: eng.decode(toks[-2]), ("decode_partials",))
            busy[route] = busy_share(lambda: eng.decode(toks[-1]))
        eng.state = None
        _free()
    if launches["pieces"]["decode_partials"] != \
            PIECES_N * launches["unsharded"]["decode_partials"]:
        raise AssertionError(f"4o bf16 launches {launches}")
    out = {"entry_bytes": per_entry, "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "busy": {r: {k: v for k, v in b.items() if k != "top_kernels_ms"}
                    for r, b in busy.items()}}
    for route, r in res.items():
        out[route] = dict(r, ms_p50=float(np.percentile(r["ms"], 50)),
                          ms_p99=float(np.percentile(r["ms"], 99)))
        log(f"4o {PIECES_ARCH} bf16 B={PIECES_BATCH} ({route}"
            + (f", (1, {PIECES_N}) of the card" if route == "pieces"
               else "") + f"): prefill {r['prefill_ms'][0]:.1f} / "
            f"{r['prefill_ms'][1]:.1f} ms (x {PIECES_PROMPT} tokens), per "
            f"token p50 {out[route]['ms_p50']:.2f} ms, p99 "
            f"{out[route]['ms_p99']:.2f} ms over {len(r['ms'])} tokens in "
            f"two turns; {launches[route]['decode_partials']} "
            f"decode_partials a token; {busy[route]['kernels']} kernels, "
            f"device {busy[route]['device_ms']:.2f} ms, busy share "
            f"{busy[route]['device_busy_share']:.3f}  [{card}]")
    log(f"4o {PIECES_ARCH} bf16 peak memory {out['peak_gb']:.2f} GB (the "
        f"whole tree and its pieces; bytes per entry {per_entry})  "
        f"[{card}]")
    del engines, params, placed
    _free()
    return out


def pieces_distinct(card):
    """Phase 4o (b): over four distinct cards where four are visible (one
    line saying it did not run otherwise): the f32 checks of (a), then
    dbrx-132b at full width and depth in bf16, drawn piece by piece on
    each card (``fill_placed``, seed 0): bytes per card against
    ``per_device_bytes``, prefill PIECES_BATCH x PIECES_PROMPT, then
    PIECES_TOKENS greedy tokens (finite logits), one token's launches
    (PIECES_N x 40 ``decode_partials``) and, by card, its records,
    launches and busy share; peak memory per card."""
    from repro_torch.configs import get
    from repro_torch.distributed.sharding import cuda_devices
    from repro_torch.models import fill_placed, init_params
    from repro_torch.serve.engine import ServingEngine

    cards = cuda_devices()
    if len(cards) < PIECES_N:
        log(f"4o (b) did not run: {len(cards)} CUDA device visible; weights "
            f"in pieces over distinct cards need {PIECES_N} (phase 4o (a) "
            f"ran them on entries that repeat this card)  [{card}]")
        return {"ran": False, "cards": len(cards)}, {}
    t_b = time.perf_counter()
    cards = cards[:PIECES_N]
    dev = cards[0]
    mesh = pieces_mesh(cards)
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[:PIECES_N]
    out = {"ran": True, "cards": names, "f32": {}}
    counts = {}
    for arch in PIECES_F32:
        r = pieces_f32(arch, f"{PIECES_N} cards", mesh, dev, card)
        out["f32"][arch] = r
        counts[f"pieces_f32_{arch}_distinct"] = r["launches"]

    cfg = get(PIECES_BIG)
    t0 = time.perf_counter()
    meta = init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                       device="meta")
    placed, per_card = place_megatron(cfg, meta, mesh)
    fill_placed(cfg, placed, seed=0)
    for c in cards:
        torch.cuda.synchronize(c)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(meta))
    allocated = [torch.cuda.memory_allocated(c) for c in cards]
    eng = ServingEngine(cfg, placed, max_len=PIECES_PROMPT + PIECES_TOKENS
                        + 4, dtype=torch.bfloat16)
    batch = {"tokens": model_prompt(cfg, PIECES_BATCH, PIECES_PROMPT)}
    eng.generate_greedy({"tokens": batch["tokens"][:, :16]}, 2)  # warm-up
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    first = eng.prefill(batch)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = np.argmax(first, axis=-1)[:, None].astype(np.int32)
    ms = []
    for _ in range(PIECES_TOKENS):
        t0 = time.perf_counter()
        last = eng.decode(tok)
        ms.append((time.perf_counter() - t0) * 1e3)
        tok = np.argmax(last, axis=-1)[:, None].astype(np.int32)
    check_logits([first, last], cfg, PIECES_BATCH)
    _, launches = run_path(f"4o (b) {PIECES_BIG} decode token over "
                           f"{PIECES_N} cards (bf16)",
                           lambda: eng.decode(tok), ("decode_partials",))
    want = PIECES_N * cfg.n_layers
    if launches.get("decode_partials") != want:
        raise AssertionError(f"4o (b): {launches} launches, expected {want} "
                             f"decode_partials a token")
    by_card = busy_by_card(lambda: eng.decode(tok))
    peaks = [torch.cuda.max_memory_allocated(c) / 1e9 for c in cards]
    out.update(params_g=n_params / 1e9, entry_bytes=per_card,
               allocated=allocated, init_s=init_s, prefill_ms=prefill_ms,
               ms=ms, ms_p50=float(np.percentile(ms, 50)),
               ms_p99=float(np.percentile(ms, 99)), launches=launches,
               by_card=by_card, peak_gb=peaks)
    log(f"4o (b) {PIECES_BIG} at full width and depth, bf16, in pieces over "
        f"{PIECES_N} cards {names}: {out['params_g']:.2f} G params drawn "
        f"piece by piece in {init_s:.1f} s, bytes per card = "
        f"per_device_bytes = {per_card} ({per_card / 1e9:.2f} GB; "
        f"allocated {allocated}); prefill {prefill_ms:.1f} ms (B="
        f"{PIECES_BATCH} x {PIECES_PROMPT}); per token p50 "
        f"{out['ms_p50']:.2f} ms, p99 {out['ms_p99']:.2f} ms over "
        f"{PIECES_TOKENS} greedy tokens; {launches['decode_partials']} "
        f"decode_partials a token; by card {by_card['cards']} over "
        f"{by_card['wall_ms']:.2f} ms; peak {[round(p, 2) for p in peaks]} "
        f"GB")
    del eng, placed
    _free()
    out["phase_s"] = time.perf_counter() - t_b
    counts["pieces_bf16_distinct"] = launches
    return out, counts


def param_pieces(dev, card):
    """Phase 4o: (a) on (1, 4) entries of the card, the f32 checks and
    the bf16 timing; (b) over four distinct cards where four are
    visible."""
    mesh = pieces_mesh([dev] * PIECES_N)
    res = {"f32": {}}
    counts = {}
    t0 = time.perf_counter()
    for arch in PIECES_F32:
        r = pieces_f32(arch, f"(1, {PIECES_N}) of the card", mesh, dev, card)
        res["f32"][arch] = r
        counts[f"pieces_f32_{arch}"] = r["launches"]
    res["bf16"] = pieces_bf16_turns(dev, card)
    for route, c in res["bf16"]["launches"].items():
        counts[f"pieces_bf16_{route}"] = c
    res["a_s"] = time.perf_counter() - t0
    res["distinct"], more = pieces_distinct(card)
    counts.update(more)
    return res, counts


# ---------------------------------------------------------------- phase 4p


def state_specs(cfg, params, mesh):
    """The reference's train cell (``launch/dryrun.py``): params, mu and
    nu placed by ``param_pspecs(strategy="megatron")`` (ZeRO-3), the step
    and the residuals replicated (``P()``)."""
    from repro_torch.distributed.fault import tree_map
    from repro_torch.distributed.sharding import PartitionSpec, param_pspecs
    from repro_torch.train import TrainState

    p_specs = param_pspecs(cfg, params, mesh, strategy="megatron")
    return TrainState(step=PartitionSpec(), params=p_specs, mu=p_specs,
                      nu=p_specs, compress_err=tree_map(
                          lambda _: PartitionSpec(), params))


def place_state(label, state, specs, mesh):
    """``state`` placed by ``specs`` on ``mesh`` (new pieces), and the
    bytes each entry holds, which must equal ``per_device_bytes``."""
    from repro_torch.distributed.sharding import (device_put, entry_bytes,
                                                  named_shardings,
                                                  per_device_bytes)

    placed = device_put(state, named_shardings(specs, mesh))
    held = entry_bytes(placed)
    want = per_device_bytes(state, specs, mesh)
    if not (held == want).all():
        raise AssertionError(f"{label}: bytes per entry {held.tolist()}, "
                             f"per_device_bytes {want}")
    return placed, want


def _replicas_equal(tree) -> bool:
    from repro_torch.distributed.fault import tree_flatten
    from repro_torch.distributed.sharding import blocks

    return all(torch.equal(x.pieces[e], x.pieces[entries[0]])
               for x in tree_flatten(tree)[0] for entries in blocks(x)
               for e in entries[1:])


def grads_against_whole(label, cfg, placed, params, batch, dev):
    """The f32 gradients of the placed state (gathered leaf by leaf)
    against those of the whole ``params`` it was placed from: per leaf,
    max |diff| within TP_GRAD_TOL of the leaf's max |g|.  Returns the
    largest ratio and the grad norm."""
    from repro_torch.distributed.sharding import gather
    from repro_torch.train.steps import loss_and_grads

    _, gp = loss_and_grads(cfg, placed.params, batch, TP_MICRO,
                           torch.float32, dp_axes=("data",))
    got = [gather(x, dev) for x in _leaves(gp)]
    del gp
    _, gw = loss_and_grads(cfg, params, batch, TP_MICRO, torch.float32)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, _leaves(gw))):
        top = float(w.abs().max())
        ratio = float((g - w).abs().max()) / top if top else 0.0
        if ratio > TP_GRAD_TOL:
            raise AssertionError(f"{label} gradient leaf {i}: max |diff| "
                                 f"{ratio} of its max |g| {top}")
        worst = max(worst, ratio)
    norm = float(torch.sqrt(sum(torch.sum(w * w) for w in _leaves(gw))))
    del got, gw
    _free()
    return {"max_diff_of_max": worst, "grad_norm": norm}


def train_pieces_check(arch, shape, dev, card):
    """Phase 4p (a)'s float32 check of ``arch`` at full width and
    TP_LAYERS layers on a ``shape`` ("data", "model") mesh of the card.
    Step 1: the initial state placed twice; the first copy's gradients
    against the whole params' leaf by leaf (``grads_against_whole``),
    its step kept as the bits to match; the second copy's step (the
    launches counted) bitwise the first's and against the whole state's
    step.  Step 2: the whole route's state after step 1, placed, against
    the whole route's next step.  Each step: loss and grad norm at
    TP_RTOL, params / mu / nu at ``close_params`` (phase 4j's
    optimizer), the same placed leaves, bytes per entry =
    ``per_device_bytes``, replicas equal.  At most one whole state and
    one placed state live at a time (a (2, 2) mesh holds two copies)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.distributed.fault import tree_flatten
    from repro_torch.distributed.sharding import (Mesh, blocks, entry_bytes,
                                                  gather)
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(arch), n_layers=TP_LAYERS)
    mesh = Mesh(np.full(shape, dev, dtype=object), ("data", "model"))
    n_dp = shape[0]
    label = f"4p {arch} ({TP_LAYERS} layers) on {shape} of the card"
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TP_BATCH, TP_SEQ),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    params0 = _draw(cfg, dev, torch.float32)
    specs = state_specs(cfg, params0, mesh)
    opt = AdamWConfig(**TRAIN_OPT)
    step_w = build_train_step(cfg, opt, n_micro=TP_MICRO,
                              compute_dtype=torch.float32)
    step_p = build_train_step(cfg, opt, n_micro=TP_MICRO,
                              compute_dtype=torch.float32,
                              dp_axes=("data",), mesh=mesh)
    scans = ("linear_scan", "linear_scan_bwd") if cfg.ssm else ()
    want_scans = {"linear_scan": 2 * cfg.n_layers * TP_MICRO * n_dp,
                  "linear_scan_bwd": cfg.n_layers * TP_MICRO * n_dp}
    res = {"steps": [], "launches": []}

    def first_pieces(tree):
        return [x.pieces[e[0]] for x in tree_flatten(tree)[0]
                for e in blocks(x)]

    # step 1 from the initial state, first on a copy: its gradients,
    # then its loss and params kept to hold the counted run to
    twin, per_entry = place_state(label, adamw_init(params0), specs, mesh)
    res["grads"] = grads_against_whole(label, cfg, twin, params0, batch,
                                       dev)
    twin, m2 = step_p(twin, batch)
    first = (m2["loss"], [t.clone() for t in first_pieces(twin.params)])
    del twin, m2
    _free()
    placed, _ = place_state(label, adamw_init(params0), specs, mesh)
    whole = None
    for k in range(2):
        leaves = tree_flatten(placed)[0]
        (new, m), counts = run_path(
            f"{label} step {k + 1} (f32)", lambda: step_p(placed, batch),
            scans)
        res["launches"].append(counts)
        if scans and {c: counts.get(c, 0) for c in scans} != want_scans:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want_scans}")
        if [id(x) for x in tree_flatten(new)[0]] != [id(x) for x in leaves] \
                or not (entry_bytes(new) == per_entry).all() \
                or not _replicas_equal(new):
            raise AssertionError(f"{label}: the stepped state is not the "
                                 f"same placed leaves with equal replicas "
                                 f"and {per_entry} bytes an entry")
        if k == 0:
            if not (torch.equal(m["loss"], first[0]) and all(
                    torch.equal(a, b) for a, b in
                    zip(first_pieces(new.params), first[1]))):
                raise AssertionError(f"{label}: two runs of the step from "
                                     f"one state differ")
            del first
            whole = adamw_init(params0)
            del params0
        whole, mw = step_w(whole, batch)
        errs = {}
        for name in ("loss", "grad_norm"):
            got, want = float(m[name]), float(mw[name])
            if abs(got - want) > TP_RTOL * abs(want):
                raise AssertionError(f"{label} step {k + 1}: {name} {got}, "
                                     f"whole tree {want}")
            errs[name] = abs(got - want) / abs(want)
        for field in ("params", "mu", "nu"):
            errs[field] = close_params(
                f"{label} step {k + 1} {field}",
                ((gather(x, dev), w) for x, w in zip(
                    _leaves(getattr(new, field)),
                    _leaves(getattr(whole, field)))), TRAIN_OPT["lr"])
        res["steps"].append(dict(errs, value=float(m["loss"])))
        del new, placed, leaves
        _free()
        if k == 0:
            # step 2 from the whole route's state after step 1
            placed, _ = place_state(label, whole, specs, mesh)
    res.update(entry_bytes=per_entry, s=time.perf_counter() - t0)
    log(f"{label}, f32, B={TP_BATCH} x {TP_SEQ} in {TP_MICRO} microbatches"
        + (f" x {n_dp} data blocks" if n_dp > 1 else "") + ": 2 steps "
        f"(from the initial state, and from the whole route's state after "
        f"it) against the whole tree's: loss {[r['value'] for r in res['steps']]}"
        f", loss / grad norm rel. diff "
        f"{[(r['loss'], r['grad_norm']) for r in res['steps']]}, "
        f"params / mu / nu (max abs diff, elements off, elements) "
        f"{[[r[f] for f in ('params', 'mu', 'nu')] for r in res['steps']]}; "
        f"first step's gradients within {res['grads']['max_diff_of_max']:.3e}"
        f" of each leaf's max |g| (grad norm {res['grads']['grad_norm']:.4f}"
        f"); two runs bitwise; bytes per entry = per_device_bytes = "
        f"{per_entry} before and after; launches {res['launches'][0]}; "
        f"{res['s']:.1f} s  [{card}]")
    del whole
    _free()
    return res


def _timed_steps(step, state, batch, n):
    """CUDA-event ms of ``n`` steps after one warm-up step."""
    out = []
    state, m = step(state, batch)
    float(m["loss"])
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"4p bf16 loss {float(m['loss'])}")
    return out


def train_pieces_timing(dev, card):
    """Phase 4p (a)'s timing: llama3-8b at full width and TP_TIME_LAYERS
    layers, bf16 compute on f32 master weights, TP_TIME_BATCH x
    TP_TIME_SEQ in TP_TIME_MICRO microbatches: the whole tree's step,
    then (the first state freed) the pieces' on (1, 4) entries of the
    card, each TP_TIME_STEPS steps after a warm-up, CUDA events; peak
    memory of each route."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step

    cfg = dataclasses.replace(get(PIECES_ARCH), n_layers=TP_TIME_LAYERS)
    mesh = pieces_mesh([dev] * PIECES_N)
    gen = torch.Generator(device=dev).manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (TP_TIME_BATCH, TP_TIME_SEQ),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    opt = AdamWConfig(**TRAIN_OPT)
    out = {}
    for route in ("whole", "pieces"):
        _free()
        torch.cuda.reset_peak_memory_stats()
        state = adamw_init(_draw(cfg, dev, torch.float32))
        kw = {}
        if route == "pieces":
            state, _ = place_state("4p timing", state, state_specs(
                cfg, state.params, mesh), mesh)
            kw = dict(dp_axes=("data",), mesh=mesh)
        _free()
        step = build_train_step(cfg, opt, n_micro=TP_TIME_MICRO,
                                compute_dtype=torch.bfloat16, **kw)
        ms = _timed_steps(step, state, batch, TP_TIME_STEPS)
        out[route] = {"ms": ms, "ms_p50": float(np.percentile(ms, 50)),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state, step
    _free()
    for route, r in out.items():
        log(f"4p {PIECES_ARCH} ({TP_TIME_LAYERS} layers) bf16 train step, "
            f"{TP_TIME_BATCH} x {TP_TIME_SEQ} in {TP_TIME_MICRO} "
            f"microbatches, {route}"
            + (f" on (1, {PIECES_N}) of the card" if route == "pieces"
               else "") + f": p50 {r['ms_p50']:.1f} ms over "
            f"{TP_TIME_STEPS} steps {[round(x, 1) for x in r['ms']]} (CUDA "
            f"events), peak memory {r['peak_gb']:.2f} GB  [{card}]")
    return out


def train_pieces_distinct(card):
    """Phase 4p (b): where four cards are visible (one line saying it did
    not run otherwise), llama3-8b at full width and depth trained over
    (1, 4) distinct cards: params drawn piece by piece on each card
    (``fill_placed``, seed 0), ``adamw_init`` of them (f32 master state
    and moments in pieces, step on card 0), bf16 compute, TP4_BATCH x
    TP4_SEQ in TP4_MICRO microbatches, TP4_STEPS steps: finite losses,
    the first within TRAIN_LOSS_TOL of ln(vocab); per card the bytes
    (= ``per_device_bytes``), peak memory, and one more step's launches
    and busy share (``busy_by_card``); the step p50 (host clock, every
    card synchronised)."""
    import math

    from repro_torch.configs import get
    from repro_torch.distributed.sharding import (cuda_devices, device_put,
                                                  entry_bytes,
                                                  named_shardings,
                                                  param_pspecs,
                                                  per_device_bytes)
    from repro_torch.models import fill_placed, init_params
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step

    cards = cuda_devices()
    if len(cards) < PIECES_N:
        log(f"4p (b) did not run: {len(cards)} CUDA device visible; training "
            f"on weights in pieces over distinct cards needs {PIECES_N} "
            f"(phase 4p (a) ran it on entries that repeat this card)  "
            f"[{card}]")
        return {"ran": False, "cards": len(cards)}
    t_b = time.perf_counter()
    cards = cards[:PIECES_N]
    mesh = pieces_mesh(cards)
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[:PIECES_N]
    cfg = get(PIECES_ARCH)
    t0 = time.perf_counter()
    meta = init_params(cfg, torch.Generator(), dtype=torch.float32,
                       device="meta")
    specs = param_pspecs(cfg, meta, mesh, strategy="megatron")
    placed = fill_placed(cfg, device_put(meta, named_shardings(specs, mesh)),
                         seed=0)
    state = adamw_init(placed)
    del placed
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(meta))
    held = entry_bytes((state.params, state.mu, state.nu))
    want = per_device_bytes((meta, meta, meta), (specs, specs, specs), mesh)
    if not (held == want).all():
        raise AssertionError(f"4p (b): bytes per card {held.tolist()}, "
                             f"per_device_bytes {want}")
    gen = np.random.default_rng(7)
    batches = [{"tokens": torch.from_numpy(gen.integers(
        0, cfg.vocab_size, (TP4_BATCH, TP4_SEQ)).astype(np.int32)).to(
        cards[0])} for _ in range(TP4_STEPS + 1)]
    step = build_train_step(cfg, AdamWConfig(**TRAIN_OPT), n_micro=TP4_MICRO,
                            compute_dtype=torch.bfloat16, dp_axes=("data",),
                            mesh=mesh)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    losses, ms = [], []
    for batch in batches[:TP4_STEPS]:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        for c in cards:
            torch.cuda.synchronize(c)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    ln_v = math.log(cfg.vocab_size)
    if not all(map(math.isfinite, losses)) or \
            abs(losses[0] - ln_v) > TRAIN_LOSS_TOL:
        raise AssertionError(f"4p (b): losses {losses} (ln V = {ln_v:.4f})")
    peaks = [torch.cuda.max_memory_allocated(c) / 1e9 for c in cards]
    by_card = busy_by_card(lambda: step(state, batches[-1]))
    if not (entry_bytes((state.params, state.mu, state.nu)) == want).all():
        raise AssertionError("4p (b): bytes per card changed by the steps")
    out = {"ran": True, "cards": names, "params_g": n_params / 1e9,
           "init_s": init_s, "entry_bytes": want, "losses": losses,
           "ms": ms, "ms_p50": float(np.percentile(ms, 50)),
           "peak_gb": peaks, "by_card": by_card}
    log(f"4p (b) {PIECES_ARCH} at full width and depth trained in pieces "
        f"over {PIECES_N} cards {names}: {out['params_g']:.3f} G params "
        f"drawn piece by piece and AdamW state made in {init_s:.1f} s; "
        f"params + mu + nu per card = per_device_bytes = {want} "
        f"({want / 1e9:.2f} GB); bf16, {TP4_BATCH} x {TP4_SEQ} in "
        f"{TP4_MICRO} microbatches: losses {losses} (ln V = {ln_v:.4f}); "
        f"step p50 {out['ms_p50']:.1f} ms over {TP4_STEPS} steps "
        f"{[round(x, 1) for x in ms]}; peak memory by card "
        f"{[round(p, 2) for p in peaks]} GB; one more step by card "
        f"(kernels, device ms, busy share) "
        f"{[(r['kernels'], round(r['device_ms'], 1), round(r['busy_share'], 3)) for r in by_card['cards'].values()]}"
        f" over {by_card['wall_ms']:.1f} ms")
    del state, batches, step
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_b
    return out


def train_pieces(dev, card):
    """Phase 4p: (a) on entries of the card, the f32 checks and the bf16
    timing; (b) over four distinct cards where four are visible."""
    res = {"checks": {}}
    counts = {}
    t0 = time.perf_counter()
    for arch, shapes in TP_CHECKS.items():
        for shape in shapes:
            r = train_pieces_check(arch, shape, dev, card)
            res["checks"][f"{arch} {shape}"] = r
            for k, c in enumerate(r["launches"]):
                counts[f"train_pieces_{arch}_{shape[0]}x{shape[1]}_{k}"] = c
    res["bf16"] = train_pieces_timing(dev, card)
    res["a_s"] = time.perf_counter() - t0
    res["distinct"] = train_pieces_distinct(card)
    return res, counts


# ---------------------------------------------------------------- phase 4n


def launch_events(prof):
    """({port kernel: launches}, all kernels) from a profiler's raw CUDA
    kernel records (``LAUNCH_EVENTS``)."""
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    counts = {k: sum(any(p in n for p in pats) for n in names)
              for k, pats in LAUNCH_EVENTS.items()}
    return {k: v for k, v in counts.items() if v}, len(names)


KINETO_LINE = re.compile(r"^[A-Z]+:\S+ \S+ \d+:\d+ \S+\.cpp:\d+\]")


def profiled(fn):
    """(fn's result, wall s, {port kernel: launches}, kernels, dropped) of
    one call under the profiler (CUDA activity only).  ``dropped`` is
    kineto's own count of the GPU records it left out of the trace as
    out of its capture window, read from its log (file descriptor 2 is
    held in a temporary file meanwhile; every other line is written back
    to standard error): the trace holds every launch but those."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as held:
        os.dup2(held.fileno(), 2)
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            held.seek(0)
            text = held.read().decode(errors="replace")
    dropped = 0
    for line in text.splitlines():
        if KINETO_LINE.match(line):
            m = re.search(r"Out-of-range = (\d+)", line)
            dropped += int(m.group(1)) if m else 0
        else:
            print(line, file=sys.stderr)
    return (out, wall) + launch_events(prof) + (dropped,)


def check_launches(label, records, launches, dropped):
    """The profiler's launches of each port kernel equal its records (the
    wrappers' counts, or the cost records), but for records kineto says
    it dropped: never more, and the launches it missed at most
    ``dropped``.  Returns the missed launches by kernel."""
    missed = {k: n - launches.get(k, 0) for k, n in records.items()
              if n != launches.get(k, 0)}
    extra = {k: n for k, n in launches.items() if k not in records}
    if extra or any(v < 0 for v in missed.values()) or \
            sum(missed.values()) > dropped:
        raise AssertionError(f"4n {label}: records {records}, profiler "
                             f"launches {launches}, kineto dropped "
                             f"{dropped} records out of its window")
    return missed


def meta_tree(tree):
    """The same tree with every tensor a ``meta`` tensor of its shape and
    dtype (named tuples, dicts, lists kept)."""
    from repro_torch.distributed.fault import tree_map

    return tree_map(lambda t: torch.empty_like(t, device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def step_roofline(label, cfg, shape, step, meta_step, ms, card,
                  meta_cost=None):
    """Phase 4n (b): count one call of ``step`` on the card under
    ``roofline.StepCounter`` (and the profiler) and one of ``meta_step``
    (the same step on ``meta`` tensors), or take ``meta_cost()`` (the
    step's count on ``meta`` by other means); the FLOPs and the kernel
    records must be equal, and each kernel's cost records equal to its
    launches in the profile.
    ``ms`` is the step's time measured without the counter by its
    phase.  Returns the row: counted FLOPs and bytes, achieved rates,
    the share of the binding peak over ``ms`` and which sets it, and
    ``model_flops``' useful ratio."""
    from repro_torch.roofline import StepCounter, analyze_step
    from repro_torch.roofline.report import (HBM_BW, PEAK_FLOPS,
                                             model_flops_of)

    t0 = time.perf_counter()
    with StepCounter() as counter:
        _, _, launches, n_kernels, dropped = profiled(step)
    cost = counter.result()
    records = {k: int(v["calls"]) for k, v in cost.kernels.items()}
    missed = check_launches(label, records, launches, dropped)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    meta = analyze_step(meta_step) if meta_cost is None else meta_cost()
    t_meta = time.perf_counter() - t0
    if meta.flops != cost.flops:
        raise AssertionError(f"4n {label}: {cost.flops} FLOPs counted on "
                             f"the card, {meta.flops} on meta")
    if meta.kernels != cost.kernels:
        raise AssertionError(f"4n {label}: cost records {records}, meta "
                             f"{meta.kernels}")
    sec = ms / 1e3
    t_flops, t_bytes = cost.flops / PEAK_FLOPS, cost.hbm_bytes / HBM_BW
    useful = model_flops_of(cfg, shape) / cost.flops
    row = {"label": label, "flops": cost.flops, "bytes": cost.hbm_bytes,
           "meta_flops": meta.flops, "meta_bytes": meta.hbm_bytes,
           "ms": ms, "tflop_s": cost.flops / sec / 1e12,
           "tb_s": cost.hbm_bytes / sec / 1e12,
           "share": max(t_flops, t_bytes) / sec,
           "bound_by": "FLOPs" if t_flops >= t_bytes else "bytes",
           "useful_ratio": useful, "records": records,
           "profiler_launches": launches, "kernels": n_kernels,
           "kineto_dropped": dropped, "profiler_missed": missed,
           "kernel_flops": {k: v["flops"] for k, v in cost.kernels.items()},
           "kernel_bytes": {k: v["bytes"] for k, v in cost.kernels.items()},
           "count_card_s": t_card, "count_meta_s": t_meta}
    log(f"4n roofline {label}: {cost.flops:.4e} FLOPs, {cost.hbm_bytes:.4e} "
        f"bytes counted (meta: {meta.flops:.4e} FLOPs, {meta.hbm_bytes:.4e} "
        f"bytes); {ms:.3f} ms -> {row['tflop_s']:.3f} TFLOP/s, "
        f"{row['tb_s']:.4f} TB/s; {row['share']:.4f} of the {row['bound_by']} "
        f"peak (H100 SXM 989 TFLOP/s bf16, 3.35 TB/s); model_flops useful "
        f"ratio {useful:.4f}; kernel records {records}, profiler launches "
        f"{launches} of {n_kernels} kernels (kineto dropped {dropped} "
        f"records out of its window); counted in {t_card:.1f} s on "
        f"the card, {t_meta:.1f} s on meta  [{card}]")
    return row


def entry_points(card):
    """Phase 4n (a): the port's CI gates and examples on the card, as a
    user runs them (``tools/torch_*.py``, ``examples/torch_*.py``): each
    gate's ``main()`` returns 0, each example runs to its end; wall time
    and kernel launches by name (the wrappers' counts, reset before each
    run).  The fused raw gate (the last ``verify_consistency`` of the
    consistency gate) must launch the unit fold on both executors: in
    its online replay and in its offline side.  Then the quickstart (the
    README's first command) once more under the profiler: its launches
    of each port kernel equal the wrappers' counts, but for the records
    kineto reports having dropped (``check_launches``)."""
    for path in (ROOT, ROOT / "examples"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch_offline_training
    import torch_online_serving
    import torch_quickstart
    from tools import (torch_check_consistency, torch_check_recovery,
                       torch_check_replay)
    from repro_torch.core import consistency
    from repro_torch.kernels import dispatch

    def unit_folds():
        return dispatch.launch_counts().get("unit_fold", 0)

    gate_calls, online = [], []
    real_verify = torch_check_consistency.verify_consistency
    real_replay = consistency.replay_online

    def verify(*args, **kwargs):
        n0 = unit_folds()
        out = real_verify(*args, **kwargs)
        gate_calls.append(unit_folds() - n0)
        return out

    def replay(*args, **kwargs):
        n0 = unit_folds()
        out = real_replay(*args, **kwargs)
        online.append(unit_folds() - n0)
        return out

    def quickstart():
        return torch_quickstart.main(["--device", "cuda"])

    runs = (
        ("torch_check_consistency --bitwise 4", lambda:
         torch_check_consistency.main(4, bitwise=True, device="cuda"), 0),
        ("torch_check_replay", lambda: torch_check_replay.main(
            device="cuda"), 0),
        ("torch_check_recovery 4", lambda: torch_check_recovery.main(
            4, device="cuda"), 0),
        ("torch_quickstart", quickstart, None),
        ("torch_online_serving", lambda: torch_online_serving.main(
            ["--device", "cuda"]), None),
        ("torch_offline_training", lambda: torch_offline_training.main(
            ["--device", "cuda", "--ckpt-dir", str(EXAMPLE_CKPT)]), None))
    out, paths = {}, {}
    for i, (name, fn, want) in enumerate(runs):
        if i == 0:      # the consistency gate, its calls recorded
            torch_check_consistency.verify_consistency = verify
            consistency.replay_online = replay
        try:
            dispatch.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dispatch.launch_counts()
        finally:
            torch_check_consistency.verify_consistency = real_verify
            consistency.replay_online = real_replay
        if want is not None and result != want:
            raise AssertionError(f"4n {name} returned {result}")
        out[name] = {"wall_s": wall, "launches": counts}
        paths[f"4n {name}"] = counts
        log(f"4n {name}: {'rc 0' if want == 0 else 'ran to its end'} in "
            f"{wall:.2f} s; kernel launches {counts}  [{card}]")
    if len(gate_calls) != 5 or len(online) != 5 or \
            not (0 < online[-1] < gate_calls[-1]):
        raise AssertionError(f"4n fused raw gate: unit-fold launches per "
                             f"gate call {gate_calls}, online replays "
                             f"{online}")
    log(f"4n fused raw gate: {online[-1]} unit-fold launches in its online "
        f"replay, {gate_calls[-1] - online[-1]} in its offline side")
    if out["torch_online_serving"]["launches"].get("decode_partials", 0) < 1 \
            or out["torch_quickstart"]["launches"].get("unit_fold", 0) < 1:
        raise AssertionError("4n examples: no decode_partials or unit_fold "
                             "launch")
    out["fused_gate_unit_folds"] = {"online": online[-1],
                                    "offline": gate_calls[-1] - online[-1]}
    dispatch.reset_launch_counts()
    _, wall, launches, n_kernels, dropped = profiled(quickstart)
    counts = dispatch.launch_counts()
    missed = check_launches("torch_quickstart (profiled)", counts,
                            launches, dropped)
    out["torch_quickstart_profiled"] = {
        "wall_s": wall, "launches": launches, "wrapper_launches": counts,
        "kernels": n_kernels, "kineto_dropped": dropped,
        "profiler_missed": missed}
    log(f"4n torch_quickstart under the profiler: {wall:.2f} s; kernel "
        f"launches (profiler) {launches} of {n_kernels} kernels, the "
        f"wrappers' {counts}; kineto dropped {dropped} records out of its "
        f"window, {sum(missed.values())} of them port launches  [{card}]")
    return out, paths


def dryrun_check(card):
    """Phase 4n (c): one cell of the dry run, on the host beside the card
    (``meta`` tensors, a 16 x 16 mesh of meta entries)."""
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.roofline.report import cell_report

    t0 = time.perf_counter()
    rec = dryrun_cell("llama3-8b", "decode_32k", False)
    wall = time.perf_counter() - t0
    if rec["status"] != "OK":
        raise AssertionError(f"4n dryrun: {rec}")
    rep = cell_report(rec)
    log(f"4n dryrun llama3-8b decode_32k 16x16 (meta): "
        f"{rec['flops_loop_aware']:.4e} FLOPs, "
        f"{rec['hbm_bytes_loop_aware']:.4e} bytes, "
        f"{rec['memory']['argument_bytes'] / 1e9:.3f} GB of arguments per "
        f"device; terms (H100 peaks) compute {rep['t_compute_s']:.3e} s, "
        f"memory {rep['t_memory_s']:.3e} s, {rep['dominant']}-bound, "
        f"roofline fraction {rep['roofline_fraction']:.4f}; {wall:.1f} s "
        f"on the host  [{card}]")
    return {"record": {k: v for k, v in rec.items() if k != "notes"},
            "report": rep, "wall_s": wall}


def widest_units(cs, tables):
    """(widest rp, [(rp, variant)] per unit block) of an offline plan."""
    from repro_torch.core.lowering import drivers
    from repro_torch.core.lowering.windows import (group_leaf_set,
                                                   unique_leaves)
    from repro_torch.kernels.unit_fold import ops
    from repro_torch.kernels.unit_fold.kernel import variant

    lws, _, _ = drivers.plan_offline(cs, tables)
    blocks = []
    for gl in lws:
        plan, _ = ops.plan_for(
            [m.node.spec for m in gl.members], group_leaf_set(gl.members),
            gl.members[0].node.spec.order_by,
            [tuple(unique_leaves(m.aggs)) for m in gl.members])
        for b in gl.blocks:
            rp = b.idx.shape[1]
            blocks.append((rp, variant(plan, rp, rp)))
    return max(rp for rp, _ in blocks), blocks


def prefix_tables(tables, n_rows: int):
    """The first ``n_rows`` events of the deployment (both tables cut at
    one timestamp)."""
    ts = np.sort(np.concatenate([t.columns["ts"] for t in tables.values()]))
    cut = ts[min(n_rows, ts.shape[0]) - 1]
    return {name: slice_table(t, 0, int(np.searchsorted(
        t.columns["ts"], cut, side="right")))
        for name, t in tables.items()}


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", dest="json_path", default=None,
                        help="also write all results to this file")
    json_path = parser.parse_args(argv).json_path
    t_start = time.perf_counter()
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import compile_script, verify_consistency
    from repro_torch.core.lowering.windows import group_windows
    from repro_torch.data.synthetic import make_action_tables
    from repro_torch.kernels.batch_windowfold import store_windowfold
    from repro_torch.kernels.segagg import bucket_build
    from repro_torch.serve.engine import FeatureEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase("2 build")
    build_s = build_all(dev)

    phase("3 kernels against plain versions")
    small = make_action_tables(n_actions=64, n_orders=32, n_users=4,
                               horizon_ms=60_000, seed=0,
                               with_profile=False)
    cs = compile_script(SMOKE_SQL, tables=small)
    groups = {g[0].node.spec.name: g for g in group_windows(cs.windows)}
    total = {name: len(g[0].sources) * max(m.online_buffer for m in g) + 1
             for name, g in groups.items()}
    res_w = check_unit_fold("w", fold_block(groups["w"], 256, total["w"],
                                            1, 1, dev), 50)
    res_wr = check_unit_fold("wr", fold_block(groups["wr"], 256,
                                              total["wr"], 1, 2, dev), 50)
    # the consistency replay's shape: one unit, one query
    replay = {name: check_unit_fold(f"{name}/U1", fold_block(
        groups[name], 1, total[name], 1, seed, dev), 200)
        for name, seed in (("w", 7), ("wr", 8))}
    # offline shapes, Q = rp, every leaf family: rp = 2048 (the uniform
    # deployment's units, shared memory), 8192 and 16384 (w's min/max
    # sparse table past shared memory: the wide variant; wr's levels fit
    # up to 8192) and 32768 (the wide variant for both)
    offline_shapes = {}
    for name, u, r, seed in (("w/rp2048", 64, 2048, 3),
                             ("wr/rp2048", 64, 2048, 4),
                             ("w/rp8192", 8, 8192, 5),
                             ("wr/rp8192", 8, 8192, 6),
                             ("w/rp16384", 4, 16384, 9),
                             ("wr/rp16384", 4, 16384, 10),
                             ("w/rp32768", 2, 32768, 11),
                             ("wr/rp32768", 2, 32768, 12)):
        offline_shapes[name] = check_unit_fold(
            name, fold_block(groups[name.split("/")[0]], u, r, r, seed,
                             dev), 3)
    for name in ("w/rp32768", "wr/rp32768"):
        if offline_shapes[name]["variant"] != "wide":
            raise AssertionError(f"unit_fold[{name}] did not take the wide "
                                 f"variant")
    res_fh = check_feature_hash(dev, 50)

    phase("3c model kernels against plain versions (hymba-1.5b shapes, "
          "the decode shapes of 4k, 4l and 4m)")
    res_ls = check_linear_scan(dev, 10)
    res_lsb = check_linear_scan_bwd(dev, 10)
    res_fd = check_decode_partials(dev, 50)
    res_fd32 = check_decode_32k(dev, 20)
    torch.cuda.empty_cache()

    phase("4a serving path at deployment size")
    t0 = time.perf_counter()
    tables = make_action_tables(**DEPLOYMENT)
    actions, orders = tables["actions"], tables["orders"]
    n_act = len(actions)
    hist_end = n_act - N_LIVE - max(BATCHES)
    log(f"tables: {n_act} actions + {len(orders)} orders in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        fused_fold=True, device="cuda")
    eng.bulk_load("actions", slice_table(actions, 0, hist_end))
    eng.bulk_load("orders", orders)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.ingest_many("actions", [actions.row(i) for i in
                                range(hist_end, hist_end + N_LIVE)])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    stored = eng.store.n_rows("actions") + eng.store.n_rows("orders")
    log(f"bulk_load {stored - N_LIVE} rows in {t_load:.1f} s; ingest_many "
        f"{N_LIVE} rows in {t_ingest:.2f} s; {stored} rows stored")
    reqs = [dict(actions.row(i)) for i in
            range(hist_end + N_LIVE, hist_end + N_LIVE + max(BATCHES))]
    served, counts = run_path(
        "serving", lambda: {b: eng.request_batch(reqs[:b])
                            for b in BATCHES},
        ("unit_fold", "feature_hash"))
    paths = {"serving": counts}
    for b, feats in served.items():
        if len(feats) != b or set(feats[0]) != set(cs.feature_names):
            raise AssertionError(f"request_batch B={b}: bad output shape")
    cpu = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        fused_fold=True, device="cpu")
    cpu.load_store_from(store_arrays(eng))
    err = compare_features(served[64], cpu.request_batch(reqs[:64]))
    del cpu
    log(f"B=64 card vs CPU plain path: equal (bitwise; ew within rtol "
        f"{EW_RTOL}), max abs diff {err}")

    phase("4b offline path at deployment size")
    t0 = time.perf_counter()
    off, counts = run_path("offline", eng.offline, ("unit_fold",))
    t_off_cold = time.perf_counter() - t0
    paths["offline"] = counts
    plain_cs = compile_script(SMOKE_SQL, tables=tables,
                              unit_fold_kernel=False)
    err_off = compare_offline("offline", off,
                              plain_cs.offline(tables, device="cuda"), n_act)
    del plain_cs
    rp_uniform, blocks_uniform = widest_units(eng.cs, tables)
    log(f"offline over {n_act + len(orders)} rows: {len(off)} features x "
        f"{n_act} rows equal the plain fold on the card (bitwise; ew "
        f"within rtol {EW_RTOL}), max abs diff {err_off}; unit blocks "
        f"(rp, variant): {blocks_uniform}; first call {t_off_cold:.2f} s "
        f"(plan + upload + fold)")

    skewed = make_action_tables(**dict(DEPLOYMENT, zipf_alpha=SKEW_ALPHA))
    skew_eng = FeatureEngine(SMOKE_SQL, skewed, capacity=64,
                             fused_fold=True, device="cuda")
    t0 = time.perf_counter()
    off_skew, counts = run_path("offline (skewed)", skew_eng.offline,
                                ("unit_fold",))
    t_skew = time.perf_counter() - t0
    paths["offline_skewed"] = counts
    rp_skew, blocks_skew = widest_units(skew_eng.cs, skewed)
    n_wide = sum(v == "wide" for _, v in blocks_skew)
    if n_wide == 0 or counts["unit_fold"] != len(blocks_skew):
        raise AssertionError(f"skewed offline: {n_wide} wide blocks, "
                             f"{counts['unit_fold']} launches for "
                             f"{len(blocks_skew)} blocks")
    plain_cs = compile_script(SMOKE_SQL, tables=skewed,
                              unit_fold_kernel=False)
    err_skew = compare_offline("offline (skewed)", off_skew,
                               plain_cs.offline(skewed, device="cuda"),
                               len(skewed["actions"]))
    del plain_cs
    log(f"offline skewed (zipf {SKEW_ALPHA}): widest unit rp={rp_skew}; "
        f"{n_wide} of {len(blocks_skew)} unit blocks took the wide "
        f"variant {blocks_skew}; equal to the plain fold (max abs diff "
        f"{err_skew}); first call {t_skew:.2f} s")

    prefix = prefix_tables(tables, CONSISTENCY_ROWS)
    n_prefix = sum(len(t) for t in prefix.values())
    t0 = time.perf_counter()
    rep, counts = run_path(
        "consistency",
        lambda: verify_consistency(compile_script(SMOKE_SQL, tables=prefix),
                                   prefix, bitwise=True, device="cuda"),
        ("unit_fold",))
    t_cons = time.perf_counter() - t0
    paths["consistency"] = counts
    if not (rep.passed and rep.bitwise_equal):
        raise AssertionError(f"verify_consistency on the card: {rep}")
    log(f"verify_consistency on the card over {n_prefix} rows "
        f"({len(prefix['actions'])} requests): {rep} in {t_cons:.1f} s")

    phase("4e staged fold path at deployment size")
    staged, counts = staged_path(tables, eng, reqs, served, off, card)
    paths.update(counts)
    torch.cuda.empty_cache()

    phase("4f long windows (pre-aggregation) at deployment size")
    longw, counts, long_b64, long_cert = long_windows(card)
    paths.update(counts)
    torch.cuda.empty_cache()

    phase("4g serving loop at deployment size")
    t0 = time.perf_counter()
    loop_res, counts = serving_loop(tables, card)
    paths.update(counts)
    log(f"phase 4g took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    phase("4h sharded serving with replicas at deployment size")
    t0 = time.perf_counter()
    shard_res, counts, sh = sharded_replicas(
        tables, skewed, eng, served, paths["serving"], off,
        paths["offline"], long_b64, card)
    paths.update(counts)
    del long_b64
    t_4h = time.perf_counter() - t0
    shard_res["phase_s"] = t_4h
    log(f"phase 4h took {t_4h:.1f} s")
    torch.cuda.empty_cache()

    phase(f"4m device mesh: 4h's deployment on a mesh of {SHARDS} entries, "
          f"{MESH_ARCH} decode sequence-sharded over {MESH_SEQ_SHARDS}")
    t0 = time.perf_counter()
    mesh_res, counts = mesh_features(tables, sh, served, paths, shard_res,
                                     off, dev, card)
    paths.update(counts)
    del sh
    torch.cuda.empty_cache()
    t_4ma = time.perf_counter() - t0
    mesh_res["decode"], counts = mesh_decode(dev, card)
    paths.update(counts)
    mesh_res["phase_s"] = time.perf_counter() - t0
    log(f"phase 4m took {mesh_res['phase_s']:.1f} s ((a) {t_4ma:.1f} s)")

    phase("4i certifier, preview, training-data pipeline, row format")
    t0 = time.perf_counter()
    deploy_res, counts = certifier_preview_pipeline(
        tables, eng, off, prefix, rep, long_cert, card)
    paths.update(counts)
    del long_cert
    deploy_res["phase_s"] = time.perf_counter() - t0
    log(f"phase 4i took {deploy_res['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    phase("4c additive folds (store_windowfold, bucket_build)")
    state = eng.store.tables["actions"]
    vals = store_vals(state)

    def additive():
        folds = {b: store_windowfold(state, vals,
                                     *request_frames(reqs[:b], dev))
                 for b in BATCHES}
        buckets = {s: bucket_build(*bucket_inputs(actions, ms, s, dev), ms,
                                   s) for ms, s in BUCKETS}
        return folds, buckets

    (folds, buckets), counts = run_path(
        "additive folds", additive, ("batch_windowfold", "segagg"))
    paths["additive"] = counts
    for b, out in folds.items():
        if tuple(out.shape) != (b, 2) or out.isnan().any() or not bool(
                (out[:, 1] == out[:, 1].round()).all()):
            raise AssertionError(f"store_windowfold B={b}: bad output")
    for s, out in buckets.items():
        if tuple(out.shape) != (s, 3):
            raise AssertionError(f"bucket_build S={s}: bad output")

    phase("3b additive-fold kernels against plain versions")
    res_bwf = check_batch_windowfold(state, reqs, dev, 20)
    res_seg, seg_shapes = check_bucket_build(actions, dev, 20)

    phase(f"4d model serving ({MODEL_ARCH}, full width and depth)")
    model, counts = model_serving(dev, card)
    paths.update(counts)

    phase(f"4j model training ({MODEL_ARCH}, full width and depth)")
    t0 = time.perf_counter()
    training, counts = model_training(dev, card)
    paths.update(counts)
    training["phase_s"] = time.perf_counter() - t0
    log(f"phase 4j took {training['phase_s']:.1f} s")

    phase(f"4k MoE and MLA families ({MOE_ARCH}, {MLA_ARCH}, full width)")
    t0 = time.perf_counter()
    families, counts = family_models(dev, card)
    paths.update(counts)
    families["phase_s"] = time.perf_counter() - t0
    log(f"phase 4k took {families['phase_s']:.1f} s")

    phase(f"4l VLM, audio and RWKV6 families ({VLM_ARCH}, {AUDIO_ARCH}, "
          f"{RWKV_ARCH}, full width)")
    t0 = time.perf_counter()
    modal, counts = modal_families(dev, card)
    paths.update(counts)
    modal["phase_s"] = time.perf_counter() - t0
    log(f"phase 4l took {modal['phase_s']:.1f} s (llava "
        f"{modal[VLM_ARCH]['phase_s']:.1f}, whisper "
        f"{modal[AUDIO_ARCH]['phase_s']:.1f}, rwkv "
        f"{modal[RWKV_ARCH]['phase_s']:.1f}, train steps the rest)")

    phase(f"4o weights in pieces ({PIECES_ARCH}, {PIECES_BIG}; "
          f"param_pspecs megatron over {PIECES_N} entries)")
    t0 = time.perf_counter()
    pieces, counts = param_pieces(dev, card)
    paths.update(counts)
    pieces["phase_s"] = time.perf_counter() - t0
    log(f"phase 4o took {pieces['phase_s']:.1f} s ((a) {pieces['a_s']:.1f} "
        f"s)")

    phase(f"4p training on weights in pieces ({', '.join(TP_CHECKS)}; "
          f"param_pspecs megatron, the train cell's state)")
    t0 = time.perf_counter()
    train_pieces_res, counts = train_pieces(dev, card)
    paths.update(counts)
    train_pieces_res["phase_s"] = time.perf_counter() - t0
    log(f"phase 4p took {train_pieces_res['phase_s']:.1f} s ((a) "
        f"{train_pieces_res['a_s']:.1f} s)")

    phase("4n entry points (tools/torch_*, examples/torch_*), the "
          "roofline of whole steps, the dry run")
    t0 = time.perf_counter()
    entry = {}
    entry["entry_points"], counts = entry_points(card)
    paths.update(counts)
    rows = {"prefill": model["roofline"]["prefill"],
            "decode": model["roofline"]["decode"],
            "train": training["roofline"],
            "decode_32k": mesh_res["decode"]["roofline"]}
    for name, r in rows.items():
        log(f"4n step {name}: {r['flops']:.4e} FLOPs, {r['bytes']:.4e} bytes,"
            f" {r['ms']:.3f} ms, {r['tflop_s']:.3f} TFLOP/s, {r['tb_s']:.4f} "
            f"TB/s, {r['share']:.4f} of the {r['bound_by']} peak, useful "
            f"ratio {r['useful_ratio']:.4f}  [{card}]")
    entry["dryrun"] = dryrun_check(card)
    counted_s = sum(r["count_card_s"] + r["count_meta_s"]
                    for r in rows.values())
    entry["rooflines"] = rows
    entry["phase_s"] = time.perf_counter() - t0 + counted_s
    log(f"phase 4n took {entry['phase_s']:.1f} s ({counted_s:.1f} s of it "
        f"counting steps inside 4d, 4j and 4m)")

    phase("5 times")
    latency = latencies(eng.request_batch, reqs, N_LATENCY)
    log_latency("request_batch", latency, N_LATENCY, card)
    prof = profile_calls(lambda: eng.request_batch(reqs[:256]), 5)
    log_profile("request_batch B=256", prof, card)
    t0 = time.perf_counter()
    for _ in range(3):
        eng.offline()
    t_off = (time.perf_counter() - t0) / 3
    prof_off = profile_calls(eng.offline, 2)
    log(f"offline (plan cached) over {n_act + len(orders)} rows: wall "
        f"{t_off * 1e3:.1f} ms per call, {paths['offline']['unit_fold']} "
        f"unit-fold launches per call  [{card}]")
    log_profile("offline", prof_off, card)
    uf = {k: res_w[k] + res_wr[k] for k in ("ms", "plain_ms", "bound_ms")}
    launches = {k: sum(c.get(k, 0) for c in paths.values())
                for k in ("unit_fold", "feature_hash", "batch_windowfold",
                          "segagg", "linear_scan", "linear_scan_bwd",
                          "decode_partials")}
    kernels = [
        {"name": "unit_fold", "route": "cuda",
         "source": "src/repro_torch/kernels/unit_fold/csrc/unit_fold.cu",
         "replaces": "src/repro/kernels/unit_fold/kernel.py:278",
         "launches": launches["unit_fold"],
         "max_abs_err": max([res_w["max_abs_err"], res_wr["max_abs_err"]]
                            + [r["max_abs_err"] for r in
                               (*offline_shapes.values(),
                                *replay.values())]),
         "ms": uf["ms"], "plain_ms": uf["plain_ms"],
         "bound_ms": uf["bound_ms"], "bound_by": res_w["bound_by"],
         "library_ms": None},
        {"name": "feature_hash", "route": "triton",
         "source": "src/repro_torch/kernels/feature_hash/kernel.py",
         "replaces": "src/repro/kernels/feature_hash/kernel.py:32",
         "launches": launches["feature_hash"],
         "max_abs_err": res_fh["max_abs_err"], "ms": res_fh["ms"],
         "plain_ms": res_fh["plain_ms"], "bound_ms": res_fh["bound_ms"],
         "bound_by": res_fh["bound_by"], "library_ms": None},
        {"name": "batch_windowfold", "route": "cuda",
         "source": "src/repro_torch/kernels/batch_windowfold/csrc/"
                   "batch_windowfold.cu",
         "replaces": "src/repro/kernels/batch_windowfold/kernel.py:66",
         "launches": launches["batch_windowfold"], **res_bwf},
        {"name": "segagg", "route": "cuda",
         "source": "src/repro_torch/kernels/segagg/csrc/segagg.cu",
         "replaces": "src/repro/kernels/segagg/kernel.py:57",
         "launches": launches["segagg"], **res_seg},
        {"name": "linear_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/chunked_scan/csrc/"
                   "linear_scan.cu",
         "replaces": "src/repro/kernels/chunked_scan/kernel.py:68",
         "launches": launches["linear_scan"], **res_ls},
        {"name": "linear_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/chunked_scan/csrc/"
                   "linear_scan.cu",
         "replaces": "src/repro/kernels/chunked_scan/kernel.py:68",
         "launches": launches["linear_scan_bwd"], **res_lsb},
        {"name": "decode_partials", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_decode/csrc/"
                   "flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:77",
         "launches": launches["decode_partials"],
         **{k: v for k, v in res_fd["global"].items()
            if k not in ("live_keys", "cold_ms", "cold_library_ms",
                         "passes_ms")}},
    ]
    log(f"unit_fold main-path shapes (w + wr, B=256): ms {uf['ms']:.4f}, "
        f"plain {uf['plain_ms']:.4f}, bound {uf['bound_ms']:.5f}  [{card}]")
    for name, r in replay.items():
        log(f"unit_fold replay {name} (U=1, Q=1, {r['variant']}): ms "
            f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f}  [{card}]")
    for name, r in offline_shapes.items():
        log(f"unit_fold offline {name} ({r['variant']}): ms {r['ms']:.4f}, "
            f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f}  "
            f"[{card}]")
    log(f"feature_hash 2^20 codes: ms {res_fh['ms']:.4f}, plain "
        f"{res_fh['plain_ms']:.4f}, bound {res_fh['bound_ms']:.5f}  "
        f"[{card}]")
    log(f"linear_scan (8, 1024, 51,200): ms {res_ls['ms']:.4f}, plain "
        f"{res_ls['plain_ms']:.4f}, bound {res_ls['bound_ms']:.5f}  [{card}]")
    log(f"linear_scan_bwd (2, 2048, 51,200): ms {res_lsb['ms']:.4f}, plain "
        f"{res_lsb['plain_ms']:.4f}, bound {res_lsb['bound_ms']:.5f}  "
        f"[{card}]")
    for name, r in res_fd.items():
        log(f"decode_partials {name} ({r['live_keys']} live keys): ms "
            f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f}; cold in L2 "
            f"ms {r['cold_ms']:.4f}, library {r['cold_library_ms']:.4f}  "
            f"[{card}]")
    for name, r in res_fd32.items():
        log(f"decode_partials 32k/{name} ({r['live_keys']} live keys): ms "
            f"{r['ms']:.4f}"
            + (f", plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}"
               if "plain_ms" in r else "")
            + f", bound {r['bound_ms']:.5f}  [{card}]")
    for n_buckets, r in seg_shapes.items():
        log(f"segagg S={n_buckets}: ms {r['ms']:.4f}, index_add_ "
            f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f}; passes {r['passes_ms']}  [{card}]")
    log(f"launches per path: {paths}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if json_path:
        out = pathlib.Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "card": card, "kernels": kernels, "latency": latency,
            "build_s": build_s,
            "unit_fold_shapes": dict(offline_shapes, w=res_w, wr=res_wr,
                                     **{f"{k}/U1": v
                                        for k, v in replay.items()}),
            "profile_requests": prof, "profile_offline": prof_off,
            "offline": {"wall_ms_cached": t_off * 1e3,
                        "first_call_s": t_off_cold,
                        "skewed_first_call_s": t_skew,
                        "blocks_uniform": blocks_uniform,
                        "blocks_skewed": blocks_skew,
                        "widest_rp_skewed": rp_skew,
                        "consistency_rows": n_prefix,
                        "consistency_s": t_cons},
            "launches_per_path": paths, "model_serving": model,
            "model_training": training, "linear_scan_bwd": res_lsb,
            "family_models": families, "modal_families": modal,
            "staged": staged, "long_windows": longw,
            "serving_loop": loop_res, "sharded": shard_res,
            "certifier_preview_pipeline": deploy_res,
            "decode_partials_shapes": res_fd, "segagg_shapes": seg_shapes,
            "decode_partials_32k": res_fd32, "mesh": mesh_res,
            "param_pieces": pieces, "train_pieces": train_pieces_res,
            "entry_points_rooflines": entry,
            "load_s": t_load, "ingest_s": t_ingest}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
