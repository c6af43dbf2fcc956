#!/usr/bin/env python3
"""Smoke run of the torch port (pybnesian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints its findings, and a failing phase raises, so
the script exits non-zero and prints no result:

0. environment: torch, CUDA, nvcc and the card (name, power limit, SM
   count, max SM clock);
1. build: nvcc compiles every source of csrc/ for sm_90a, all at once,
   and prints each source's registers and the functions that spill;
2. the CV pairs kernel (``ckde_cv_pairs``) against its plain torch version
   on the card: small ragged cases, then timed with its launch plan and
   bound: the bench shape, config3b's shape (G 4, 10k × 10k, dpad 2) and
   the main path's own inputs; each timed shape, and the CV path's shape at
   100,000 rows (G 150, 90,000 × 10,000, dpad 3), also timed with the train
   axis split 1, 2, 4 and 8 ways, each output held bit-equal to the planned
   launch's; program 0 of the bench shape and of the main path's inputs
   (G 150) bit-equal alone (G 1) and run again; the main path's inputs
   through two ``_scaled_dot_product_efficient_attention`` calls (the
   library yardstick: time and error, not a gate);
3. the port's ``flash_cv_selfcheck`` on the card;
4. the CV path: ``CVLikelihood.local_score_batch`` on bench.py's workload
   (10,000 rows × 5 float32 columns, 15 CKDE families, 10 folds, normal
   reference bandwidth) — one warm call and 3 calls through the kernel
   whose scores are held against the port's float64 path (their mean rate
   printed), then 30 timed calls (their median rate), the family set
   rotated throughout, each call launching the whitening, pairs and
   fold-reduce kernels — then a semiparametric mix of linear-Gaussian and
   CKDE families (its linear-Gaussian families through the LG kernel,
   ``lg_cv_stats``), the LG kernel held to its plain version on the mix's
   and every one-parent linear-Gaussian family (:func:`compare_lg`); then
   the whitening kernel (``ckde_cv_whiten``) and the
   fold-reduce kernel (``ckde_cv_fold_reduce``) against their plain
   versions on the first batch's inputs (G 150, 9,000 × 1,000, dpad 3),
   timed with their bounds, and stage 1's device operations and device
   time by the plain torch route and by the kernel, beside the whole
   float32 CV call's (``torch.profiler``); the whitening and LG kernels
   at every cluster size S (1, 2, 4, 8) on those inputs and on the mix's
   and the one-parent LG families: bit-equal to the planned launch,
   timed, and each family alone and in its batch, with each kernel's
   registers and spills from the build; the fold reduce at every cluster
   size S (1 to min(K, 8)) on those inputs and, against its plain version
   and timed, on rows made from a seed at the 100,000-row call's shape
   (F 15, K 10, 10,000 test rows, -inf and NaN rows of weight 0, one
   degenerate fold), each S bit-equal to the planned launch;
5. the KDE kernel (``kde_logl``) against its plain version: small ragged
   cases (G 1 and 2, d 1 to 20, an all-invalid first train tile) and the
   TPU kernel's own shape (10,240 × 10,240 rows, d 3), timed with its
   launch plan and bound, split 1, 2, 4 and 8 ways (bit-equal), bit-equal
   alone and inside G 150, and one efficient-attention call beside it;
6. the exp-chain probe (``exp_chain``) against its plain version and its
   accurate-``expf`` rate; then every timed kernel's bound (the larger of
   its exps over the SFU's 16 ``ex2`` per clock per SM at the max SM clock,
   its FP32 operations over 67 TFLOP/s, and its bytes over 3.35 TB/s) and
   its share of that bound;
7. the fitted-model path at config3b's size: an 8-node SemiparametricBN
   chain (CKDE at x0, x2, x4, x6; linear-Gaussian at the odd nodes) fitted
   on 10,000 float32 rows, ``model.slogl`` on 10,000 more (warm, then 6
   timed calls through the pairs kernel), ``model.logl`` against the
   port's float64 path, every CKDE ``cpd.logl`` and a 3-variable KDE
   through the KDE kernel, and ``model.sample``;
8. structure learning at config3b's size: ``hc`` on a SemiparametricBN
   over 10,000 float32 rows of the same 8-column chain, with the default
   ValidatedLikelihood (holdout 0.2, 10 folds) and operators (arcs and
   node types), one warm run and one timed run, every CKDE family through
   the whitening, pairs and fold-reduce kernels (CV and holdout channels),
   every linear-Gaussian family through the LG kernel (the validation
   channel's seed and updates through the holdout batch, so the search
   launches no KDE kernel); held
   against a float64 run of the same call on the card (plain routes): the
   same operators, or a first differing pair whose float64 deltas are
   within :data:`TIE_ATOL`; the five kernels against their plain versions
   on the inputs the run's score builds at the run's shapes (CV folds
   7,200 × 800, holdout 8,000 × 2,000; the LG kernel on both channels at
   F 1–56, and on degenerate inputs, within :data:`LG_RTOL` with the
   −inf/NaN pattern exact, timed at the CV channel's 56 one-parent
   families); the float32 scores of the cache pass's families and of both
   validation routes against the float64 run's at :data:`SCORE_RTOL`,
   with their cross-batch difference (the cache pass's families in one
   batch, then each alone; a gate: every family's score, CKDE and
   linear-Gaussian, is the same bits, and for the one-parent CKDE families
   the whitening kernel's outputs and the pairs kernel's rows too; the
   same gate for the float32 BIC batch and the holdout channel's
   linear-Gaussian batch) and two-route difference (the holdout batch
   against a fitted factor per node; a gate: the validation cache that
   ``hc`` seeds holds every node's batch value bit for bit, on the start
   and the learned model); the whitening and the fold reduce (the
   learned model's families, both channels) and the LG kernel (every
   one-parent family, both channels) at every S, bit-equal to the planned
   launch, timed, and (whitening, LG) each family alone and in its batch;
   one LG CV call's host ms on both
   routes;
   a ``score="cv-lik"`` search (no validation
   guard): its iterations and how many of its steps undo an earlier one;
   and BIC, the GaussianNetwork default, against float64, then its ``hc``;
9. UCV bandwidths at 10,000 float32 rows of the bench data, 10 folds: (a)
   ``UCV().bandwidth`` and ``diag_bandwidth`` of 1, 2 and 3 columns, the
   float32 search beside a float64 search on the card, the UCV score at
   each result no worse than at the normal-reference start; (b)
   ``CVLikelihood.local_score_batch`` with UCV as the CKDE selector
   (through ``Arguments``) on one family each of 0, 1 and 2 parents: the
   float32 scores against a float64 score GIVEN THE SAME per-fold
   bandwidths at :data:`SCORE_RTOL`, the scores of the two searches' own
   bandwidths beside them, and the whitening (its given-bandwidths
   route), pairs and fold-reduce kernels against their plain versions on
   these inputs (G = families × folds); each float32 search (one per
   family width) is ONE launch of the search kernel (``ucv_search``), run
   with CUDA's sync debug mode at "error" (no device read inside it), and
   no float64 search launches a UCV kernel; the kernel is held to its
   plain version, the host loop, on the searches' own problems
   (:func:`ucv_search_check`: its objective and bit-equal pair sums, its
   first :data:`UCV_SEARCH_STEPS` steps, the whole search no worse than
   the plain one's plus ``fatol`` and the plain loop's bits in x, f,
   start, iterations, evaluations and each problem's lane evaluations,
   the same bits alone, in the batch and rerun; timed with two bounds: one
   evaluation a lane-iteration, and the evaluations each lane's search
   needed, beside the schedule's efficiency against the pair kernel's rate
   at full load; then the split of its block-time between tile work, lane
   steps and waiting, from an instrumented build of its source,
   ``tools/kernel_sweeps.py``'s, outside every timed window) and the CV
   scores of its bandwidths to
   those of the plain search's at :data:`SCORE_RTOL`; the float32
   searches then run as the plain host loop on the card (timed, and again
   recording the pair-sums kernel's inputs), and the UCV pair-sums kernel
   (``ucv_pair_sums``) is held against its plain version at
   :data:`UCV_RTOL` on those inputs (per shape the first launch, the last
   and the one of the smallest bandwidth, with the range of bandwidths
   visited printed beside :data:`UCV_FACTORS_CHECKED`) and
   on an all-invalid problem, two invalid rows,
   N 4,097 and 100, d 1, 16, 17 and 20 and a NaN row, one problem's sums
   bit-equal alone, inside 30
   problems, padded with invalid rows and run again, and its times at
   (10, 9,000, 3) with its bound and two efficient-attention calls beside
   it; the starts kernel (``ucv_starts``), which formed each width's
   search inputs in one launch, held to its plain version on the score's
   own device tensors (starts at :data:`STARTS_RTOL`, rows, mask, counts
   and ``ok`` exactly) for (b)'s families and bench.py's 15 (50 problems
   a launch), and timed on the latter beside its plain version and its
   bound; (c) one family with a
   user-defined selector (a scaled covariance); (d) ``KDE(vars,
   UCV()).fit`` (a search-kernel launch) and its ``logl`` through the KDE
   kernel; (e) ``UCVScorer`` on the float32 frame, one pair-sums launch a
   score, against float64 at :data:`SCORE_RTOL`. Every search's
   iterations per problem, objective evaluations and seconds are printed,
   with the share of them spent in the pair sums: the evaluations times
   one ``ucv_pair_sums_batch`` call's own time at the search's shape (the
   searches themselves run untimed inside);
10. discrete networks on config2's data (20 nodes, 10,000 rows,
   cardinality 3): the native core must build; ``hc`` on a DiscreteBN with
   ``score="bic"`` and ``score="bde"`` as shipped, without a callback and
   with one (which forces the Python loop), learning the same arcs; the
   native loop and the Python loop on the native tier learning the same
   arcs from the same scores; the Python loop on the card's tier learning
   one graph with and without a callback, of the native tier's skeleton
   and total score; BIC and BDe of the 380 one-parent families by
   ``ops/discrete.py`` on the card against the native core at
   :data:`DISCRETE_RTOL`; ``hc`` with ``score="bge"`` on phase 8's
   continuous frame; the native core timed against the card per batch
   over F in {8, 64, 380} families × {10k, 100k, 1M} rows; and per search
   (20 nodes × {10k, 30k, 60k, 100k, 1M} rows: the native loop, the Python
   loop on each tier), the grid that sets
   ``discrete_native.NATIVE_BELOW_ROW_ITEMS``;
11. hybrid networks on config3b's chain at 10,000 float32 rows with two
   categorical columns d0 and d1 (3 categories each; every continuous
   node's mean shifts with d0, the even nodes' with d1): (a) a
   SemiparametricBN with d0 a parent of every continuous node and d1 of
   the even ones, so 4 HCKDE nodes of 9 configurations and 4
   CLinearGaussianCPD nodes of 3, fitted, then ``model.logl``/``slogl``
   on 10,000 more rows against float64 and against Σ ``cpd.logl``, each
   configuration's own CKDE (the KDE kernel) against its HCKDE's rows
   (the pairs kernel, one launch for all 9), the launches of one
   ``HCKDE.logl`` and one ``model.logl``; (b) ``hc`` on a SemiparametricBN
   with ``score="validated-lik"`` over the 10 columns against float64 by
   the tie rule; (c) a CLGNetwork's fit and logl against float64, and its
   ``hc`` with ``score="validated-lik"``; then both kernels against their
   plain versions on the inputs that (a) to (c) gave them, the first
   launch of each shape (:class:`Recording`, which also requires every
   call of a wrapper to launch once), with the launches of each
   entry point (one ``HCKDE.logl``, one ``model.logl``, the ``slogl``
   calls, Σ ``cpd.logl``, each configuration's CKDE, ``hc``);
12. dynamic networks on an AR(2) series of 5 variables with cross-lags,
   10,000 float32 rows: a DynamicSemiparametricBN with CKDE nodes in the
   static and the transition network (fit, ``logl`` against float64,
   ``slogl``, and ``sample`` of 200 rows as a check of its shape and
   values, not a measurement), then DMMHC over DynamicLinearCorrelation
   with a DynamicValidatedLikelihood (the pairs kernel), its static and
   transition arcs; then both kernels against their plain versions on the
   inputs that these calls gave them, at each shape launched;
13. the constraint-based learners: PC over LinearCorrelation on config4's
   data (50 nodes, 100,000 rows) and over ChiSquare on config4b's (25
   discrete nodes, 50,000 rows, the native core), each called on the test
   itself, through a counter with ``pvalue_batch`` (the batched route PC
   takes for the test itself) and one test at a time, all three learning
   the same PDAG: tests, tests/s, arcs and edges; MMHC on a
   SemiparametricBN over phase 8's frame with the validated likelihood,
   against float64 by the tie rule, then each kernel it launched against
   its plain version on the inputs that MMHC gave it, at each shape;
14. the last two independence tests: (a) one ``pair_stats`` batch and one
   ``fused_z`` batch of each z size 1, 2 and 4 on config4's data (100,000
   rows, the batched path's lane count), float32 on the card against the
   same draws of the first :data:`RCOT_CPU_LANES` lanes through the same
   functions in float64 on the CPU (the
   statistic's relative and the p-value's absolute error, at
   :data:`RCOT_STAT_RTOL` and :data:`RCOT_PVALUE_ATOL`), with how many lanes
   a float32 conditioning solve would lose to NaN; (b) PC over
   ``RCoT(df, seed=0)`` on all of config 4 (50 nodes), warmed up as
   ``bench_rcot`` does, through the batched counter, twice: tests, tests/s,
   every p-value in [0, 1], the same PDAG; (c) PC over
   ``KMutualInformation(k=10, seed=0, samples=1000)`` on config4's first
   2,000 rows × 6 columns, batched and one test at a time: the same PDAG and
   p-values; (d) MMHC over RCoT on a SemiparametricBN over phase 8's frame,
   against float64 by the tie rule, each kernel it launched held at every
   shape it launched it at (path ``independence``);
15. posterior inference at config 5 (benchmarks/config5_inference.py: a
   CLGNetwork A -> X -> Y over 2,000 rows, float64): the log-density and
   its gradient on the card against the CPU at the init and 16 seeded
   points (:data:`LOGDENSITY_RTOL`), the CUDA-graph replay of the gradient
   against the eager one, and both timed; ``nuts`` (one chain, 300
   samples, 200 warmup, max_depth 6: samples/s, mean leapfrogs, accept
   rate); ``sample_chains`` with four NUTS chains (R-hat and ESS printed,
   Y's slope within :data:`SLOPE_ATOL` of its MLE); ``hmc``, ``smc`` and
   ``advi`` (finite, ADVI's mean within :data:`ADVI_ATOL` of NUTS's on the
   continuous blocks);
16. the multi-device layer (``parallel``, ``runtime``) on virtual shards of
   the card, at config 6's sizes (benchmarks/config6_scaling.py): (a)
   ``device_info`` and ``default_mesh``; (b) ``sharded_ckde_cv`` on a fam
   mesh of 8 shards at config 6's weak-scaling inputs (4,000 rows × 4
   columns, 5 folds, 8 families a shard), then bench.py's workload on 5
   shards, each family held to the unsharded kernel route and the plain
   form at :data:`SHARD_RTOL`; (c) ``sharded_batched_bic`` and
   ``sharded_lg_fit`` at 65,536 rows × 8 columns, 32 families, data 8,
   against a 1×1 mesh; (d) ``sharded_kde_slogl`` at 16,384 × 1,024 rows,
   d 3, data 8, against one shard and the plain version; (e)
   ``sample_chains_sharded`` NUTS on config 6's density over 4 shards,
   each shard against its own ``nuts_chains`` run, then config 5's
   four chains sharded, timed beside the same four chains batched at the
   same draws; (f)
   ``dryrun_multichip(8)`` over 8 virtual shards; (g) a one-rank NCCL
   process group, an all-reduce and (c) on ``global_mesh``; (h) (b)–(d)
   on the real mesh over every card when there is more than one (else a
   line saying why not). Every launch of both kernels in (b), (d), (f)
   and (h) is path ``parallel``, recorded and held to the plain version.

A kernel's time (``ms``) is the median of CUDA-event windows of one
launch each; ``batched_ms`` is the median per launch of windows of
:data:`KERNEL_BATCH` back-to-back launches, in which the card runs one
launch while the host issues the next, so that it holds no launch
latency. Each path (4, 6, 7, 8, 9, 11, 12, 13, 14, 16) runs with every launch count
set to 0 just before it and read just after. A JSON object with each kernel's launches
on those paths, its error against its plain version, its times, its plain
version's time, its bound and its library yardstick's time (``library_ms``:
the efficient-attention calls of phases 2, 5 and 9, a ``torch.einsum`` of
the LG kernel's Gram stage; none for the exp chain, the CV whitening,
the fold sums and the UCV starts) comes two lines before the
last, then the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
Needs CUDA; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

KERNELS = {  # wrapper name: (source, the TPU kernel it replaces)
    "ckde_cv_pairs": ("pybnesian_tpu_torch/csrc/ckde_cv.cu",
                      "pybnesian_tpu/ops/pallas_kde.py:77"),
    "kde_logl": ("pybnesian_tpu_torch/csrc/ckde_cv.cu",
                 "pybnesian_tpu/ops/pallas_kde.py:36"),
    "exp_chain": ("pybnesian_tpu_torch/csrc/exp_chain.cu",
                  "benchmarks/micro_exp_roofline.py:90"),
    "ucv_pair_sums": ("pybnesian_tpu_torch/csrc/ucv_pairs.cu",
                      "pybnesian_tpu/ops/kde.py:507 (XLA-fused, no Pallas "
                      "kernel)"),
    "ckde_cv_whiten": ("pybnesian_tpu_torch/csrc/cv_whiten.cu",
                       "pybnesian_tpu/ops/kde.py:303 (XLA-fused, no Pallas "
                       "kernel)"),
    "ckde_cv_fold_reduce": ("pybnesian_tpu_torch/csrc/cv_whiten.cu",
                            "pybnesian_tpu/ops/kde.py:404 (XLA-fused, no "
                            "Pallas kernel)"),
    "lg_cv_stats": ("pybnesian_tpu_torch/csrc/lg_cv.cu",
                    "pybnesian_tpu/ops/gaussian.py:118 and :44 (XLA-fused, "
                    "no Pallas kernel)"),
    "ucv_search": ("pybnesian_tpu_torch/csrc/ucv_pairs.cu",
                   "pybnesian_tpu/kde/ucv.py:106 and :171 with "
                   "pybnesian_tpu/ops/nelder_mead.py:24 (XLA-fused, no "
                   "Pallas kernel)"),
    "ucv_starts": ("pybnesian_tpu_torch/csrc/cv_whiten.cu",
                   "pybnesian_tpu/learning/scores/likelihood.py:414-433 "
                   "(host NumPy, no Pallas kernel)"),
}
PAIR_TOL = 1e-3       # max abs difference per test row, kernel vs plain
SCORE_RTOL = 1e-4     # float32 kernel route vs float64 plain route
EXP_TOL = 1e-5        # max abs difference of the exp chain, kernel vs plain
UCV_RTOL = 1e-5       # relative difference per UCV pair sum, kernel vs plain
                      # (float32 terms summed in another order, float64
                      # above a thread's 1,024 terms in both); also the UCV
                      # search kernel's objective, x and f against its plain
                      # version's (float32 whitening and sums in other
                      # orders)
UCV_SEARCH_STEPS = (1, 2, 3, 5)  # max_iter of the search kernel's first
                      # steps, held to its plain version's
UCV_SEARCH_RUNS = 5   # CUDA-event windows of a search's ``ms``
UCV_DOT_D = 16        # widest d of the UCV kernel's dot form (ucv_pairs.cu)
UCV_FACTORS_CHECKED = (1.25, 1.0, 0.5, 0.25, 0.125, 0.0625)  # bandwidths as
# factors of the normal reference, at which tools/ucv_dot_form_error.py
# emulates the dot form's error on the CPU
WHITEN_TOL = {        # the CV whitening, kernel vs plain, per output
    "jtr": 2e-6, "zv_tr": 2e-6, "jte": 2e-6, "zv_te": 2e-6,  # relative and
    # absolute: one float32 rounding of a float64 value formed in another
    # order on each side, so at most an ulp apart
    "lndiff": 1e-12,  # relative, float64 on both sides
    "lm_const": 2e-7,  # relative, one rounding of a float64 log
}                     # neg, wte, no_ev, ok and every NaN: exactly
STARTS_RTOL = 1e-12   # the UCV starts kernel's float64 starts vs its plain
                      # version's (float64 sums in another order); its rows,
                      # mask, counts and ok are copies, held exactly
LG_RTOL = 2e-7        # the LG kernel vs its plain version run in float64 on
                      # the same float32 inputs: one float32 rounding of a
                      # float64 score, BIC or Gram entry
REDUCE_RTOL = 2e-7    # the fold sums, kernel vs plain: float64 sums of the
                      # same float32 rows in another order, rounded once
ROW_TOL = 1e-3        # per-row logl: float32 kernel routes vs float64 plain,
                      # and the model's batched route vs its factors' routes
TIMED_RUNS = 10
KERNEL_BATCH = 20     # back-to-back launches per window of ``batched_ms``
SPLITS = (1, 2, 4, 8)  # train-axis splits of the sweep
CV_RUNS = 30
MODEL_RUNS = 6
HC_ROWS = 10_000      # config3b's size (BASELINE.md config 3: 10k rows)
HC_PATIENCE = 5
HC_MAX_ITERS = 200
TIE_ATOL = 1e-2       # nats: float64 deltas of two operators that float32 may
                      # order either way. A delta sums up to four local scores
                      # (two nodes, before and after), and on an H100 one
                      # float32 score of this data moves by at most 2e-3
                      # nats between batches and routes (cross-batch and
                      # two-route differences below)
DISCRETE_RTOL = 1e-9  # float64 discrete scores: the card vs the native core
UCV_WORSE_RTOL = {"float32": 1e-4, "float64": 1e-9}  # a search's result vs
                      # its start, both scored in float64
DISCRETE_NODES = 20   # benchmarks/config2_discrete_hc.py: 20 nodes,
DISCRETE_ROWS = 10_000  # 10,000 rows, cardinality 3
DYNAMIC_VARIABLES = 5  # phase 12: an AR(2) series of 5 variables,
DYNAMIC_ORDER = 2      # Markovian order 2
DYNAMIC_SAMPLE_ROWS = 200  # a check of dynamic sample's shape and values,
                           # not a measurement of it at the series' length
PC_NODES = 50          # benchmarks/config4_pc.py: 50 nodes,
PC_ROWS = 100_000      # 100,000 rows
CHI_NODES = 25         # benchmarks/config4b_discrete_pc.py: 25 nodes,
CHI_ROWS = 50_000      # 50,000 rows, cardinality 3
RCOT_Z_SIZES = (1, 2, 4)  # phase 14 (a): fused_z batches (z size 0 is
                          # pair_stats)
RCOT_CPU_LANES = 8        # lanes of each batch also run on the CPU in float64
RCOT_STAT_RTOL = 1e-3     # the card's float32 features (float64 algebra)
RCOT_PVALUE_ATOL = 1e-3   # against float64 on the CPU, the same draws; an
                          # H100 gave at most 2.037e-04 and 4.327e-05
                          # (PERF.md, section 6)
KMI_ROWS = 2_000       # phase 14 (c): config4's first 2,000 rows
KMI_COLUMNS = 6        # and 6 columns
KMI_K = 10
KMI_SAMPLES = 1000
CONFIG5_ROWS = 2_000   # benchmarks/config5_inference.py: 2,000 rows,
NUTS_SAMPLES = 300     # 300 samples after
NUTS_WARMUP = 200      # 200 warmup steps,
NUTS_DEPTH = 6         # max_depth 6
LOGDENSITY_POINTS = 16
LOGDENSITY_RTOL = 1e-9  # float64 log-density and gradient, card vs CPU
CHAINS = 4
CHAIN_SAMPLES = 300
CHAIN_WARMUP = 200
RHAT_TARGET = 1.05     # split R-hat of the continuous parameters: printed,
                       # not a gate (the sampler is the reference's, whose
                       # chains do not reach it at these sizes; PERF.md)
SLOPE_ATOL = 0.05      # Y's posterior slope against its MLE
SMC_PARTICLES = 256    # tests/inference/test_config5_e2e.py's SMC
SMC_STEPS = 10
ADVI_STEPS = 1000
ADVI_ATOL = 0.1        # ADVI's mean against NUTS's, continuous blocks
MESH_SHARDS = 8        # phase 16: config 6's largest mesh (:178)
C6_ROWS = 4_000        # config6_scaling.py:60-64: 4,000 rows,
C6_COLUMNS = 4         # 4 columns,
C6_FOLDS = 5           # 5 folds,
C6_FAMS_PER_SHARD = 8  # 8 families a shard
C6_BIC = (65_536, 8, 32)     # :115 rows, columns, families
C6_KDE = (16_384, 1_024, 3)  # :137 train rows, test rows, d
C6_NUTS = (8, 50, 50, 6)     # :158-171 dim, samples, warmup, max_depth
C6_NUTS_SHARDS = 4
C5_SHARDED_SAMPLES = 100  # config 5's four chains, batched and sharded, both
C5_SHARDED_WARMUP = 100   # cut from phase 15's 300 / 200: shards run in turn
SHARD_RTOL = 1e-4      # a sharded float32 score against the unsharded
                       # kernel route and the plain form, per family
GRID_FAMILIES = (8, 64, 380)
GRID_ROWS = (10_000, 100_000, 1_000_000)
SEARCH_GRID_ROWS = (10_000, 30_000, 60_000, 100_000, 1_000_000)
# (G, ntr, nte, d) of the Pallas KDE kernel's measured shape (pallas_kde.py:11)
KDE_TPU_SHAPE = (1, 10_240, 10_240, 3)
# (G, ntr, nte, dpad) of config3b's model.slogl: one program per CKDE node
CONFIG3B_PAIRS_SHAPE = (4, 10_000, 10_000, 2)
# (G, ntr, nte, dpad) of the CV path at 100,000 rows: 15 families x 10
# folds, the widest family (two parents) padded to 3 columns
CV_100K_PAIRS_SHAPE = (150, 90_000, 10_000, 3)
# published peaks of one H100 SXM (NVIDIA's data sheet; PERF.md)
SFU_EX2_PER_CLOCK_PER_SM = 16
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def make_data(n=10_000, d=5, seed=0, dtype=np.float32):
    """bench.py's data (bench.py:31), as a dict of numpy columns."""
    rng = np.random.default_rng(seed)
    cols = {}
    base = rng.normal(0, 1, n)
    for i in range(d):
        noise = rng.normal(0, 0.6, n)
        if i == 0:
            cols[f"x{i}"] = base + noise
        else:
            prev = cols[f"x{i-1}"]
            cols[f"x{i}"] = np.sin(0.8 * prev) + 0.5 * prev + noise
    return {k: v.astype(dtype) for k, v in cols.items()}


def families(d, shift=1):
    """bench.py's 15 candidate families (bench.py:47)."""
    fams = []
    names = [f"x{i}" for i in range(d)]
    for i, v in enumerate(names):
        fams.append((v, []))
        fams.append((v, [names[(i + shift) % d]]))
        fams.append((v, [names[(i + shift) % d], names[(i + shift + 1) % d]]))
    return fams


def config3b_data(n, seed, d=8):
    """benchmarks/config3b_logl_evals.py's data (:34-49), as a dict of
    float32 numpy columns."""
    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.normal(0, 1, n)
    cols["x0"] = prev
    for i in range(1, d):
        prev = np.sin(0.8 * prev) + 0.5 * prev + rng.normal(0, 0.6, n)
        cols[f"x{i}"] = prev
    return {k: v.astype(np.float32) for k, v in cols.items()}


def counters():
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        ckde_cv_fold_reduce, ckde_cv_whiten, ucv_starts)
    from pybnesian_tpu_torch.ops.exp_chain import exp_chain
    from pybnesian_tpu_torch.ops.kde_kernel import kde_logl
    from pybnesian_tpu_torch.ops.lg_cv_kernel import lg_cv_stats
    from pybnesian_tpu_torch.ops.ucv_kernel import ucv_pair_sums_cuda
    from pybnesian_tpu_torch.ops.ucv_search_kernel import ucv_search_cuda

    return {"ckde_cv_pairs": ckde_cv_pairs, "kde_logl": kde_logl,
            "exp_chain": exp_chain, "ucv_pair_sums": ucv_pair_sums_cuda,
            "ckde_cv_whiten": ckde_cv_whiten,
            "ckde_cv_fold_reduce": ckde_cv_fold_reduce,
            "lg_cv_stats": lg_cv_stats, "ucv_search": ucv_search_cuda,
            "ucv_starts": ucv_starts}


def reset_counts():
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counts():
    return {name: w.launches for name, w in counters().items()}


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return proc.stdout.strip()


def phase_environment(torch):
    """The card: its ``nvidia-smi`` name and power limit line, its SM count
    and its max SM clock in Hz (for the SFU bound)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    from pybnesian_tpu_torch.ops.cuda_build import nvcc as find_nvcc

    nvcc = find_nvcc()
    nvcc_version = run([nvcc, "--version"]).splitlines()[-1]
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    max_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                         "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say("0 environment", python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc_version),
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), sms=sms, max_sm_mhz=max_mhz)
    print(smi, flush=True)
    return {"smi": smi, "sms": sms, "max_sm_hz": max_mhz * 1e6}


def bound(card, exps, ops, nbytes, f64_ops=0.0):
    """(ms, what bounds it): the least time the card could take for work of
    ``exps`` SFU exps, ``ops`` FP32 operations (an FMA is 2), ``nbytes``
    bytes, each input read once and each output written once, and
    ``f64_ops`` FP64 operations."""
    times = {
        "sfu": exps / (card["sms"] * SFU_EX2_PER_CLOCK_PER_SM
                       * card["max_sm_hz"]),
        "fp32": ops / FP32_OPS_PER_S,
        "bytes": nbytes / HBM_BYTES_PER_S,
        "fp64": f64_ops / FP64_OPS_PER_S,
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def pairs_work(args):
    """(exps, FP32 ops, bytes) that one ckde_cv_pairs call on ``args``
    needs: every pair of a test row and a valid train row takes one exp for
    the joint and, in programs with evidence, one for the marginal; its
    distance is 3 ops per column, the scale 1, each logsumexp step 2, the
    marginal's correction 4."""
    G, ntr, dpad = args[0].shape
    nte = args[3].shape[1]
    valid = (args[1] == 0).sum(1).double()
    marg = (args[5] <= 0.5).double()
    pairs = float(valid.sum()) * nte
    marg_pairs = float((valid * marg).sum()) * nte
    exps = pairs + marg_pairs
    ops = pairs * (3 * dpad + 3) + marg_pairs * 6
    nbytes = 4 * (G * ntr * (dpad + 2) + G * nte * (dpad + 2) + 2 * G
                  + G * nte)
    return exps, ops, nbytes


def kde_work(args):
    """(exps, FP32 ops, bytes) of one kde_logl call on ``args``: one exp per
    pair of a test row and a valid train row, 3 ops per column, 3 more."""
    G, ntr, d = args[0].shape
    nte = args[2].shape[1]
    pairs = float((args[1] > 0).sum()) * nte
    nbytes = 4 * (G * ntr * (d + 1) + G * nte * d + G + G * nte)
    return pairs, pairs * (3 * d + 3), nbytes


def timing_fields(card, case):
    """The timed case's fields: times, launch plan (where the kernel has
    one), bound and shares."""
    bound_ms, by = bound(card, *case["work"])
    fields = {"kernel_ms": f"{case['ms']:.4f}",
              "kernel_batched_ms": f"{case['batched_ms']:.4f}",
              "plain_ms": f"{case['plain_ms']:.4f}"}
    if "plan" in case:
        rows, group, split = case["plan"]
        fields.update(plan_R_T_S=f"{rows},{group},{split}", cluster=split)
    return {**fields, "bound_ms": f"{bound_ms:.4f}", "bound_by": by,
            "bound_share": f"{bound_ms / case['ms']:.4f}",
            "batched_bound_share": f"{bound_ms / case['batched_ms']:.4f}"}


def ptxas_spills(report):
    """The functions that an ``nvcc -Xptxas -v`` report shows spilling
    registers to local memory."""
    spilling, name = [], None
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[1]
        elif "spill stores" in line:
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                spilling.append(name)
    return spilling


def ptxas_functions(report):
    """{kernel: "registers/spill stores/spill loads"} of an ``nvcc -Xptxas
    -v`` report, each kernel by its name and template width
    (``whiten_kernel<3>``)."""
    out, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
            name = (None if m is None else
                    m[1] + (f"<{m[2]}>" if m[2] else ""))
        elif name and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            out[name] = [None, stores, loads]
        elif name and "Used" in line and name in out:
            out[name][0] = line.split("Used", 1)[1].split()[0]
            out[name] = "/".join(out[name])
            name = None
    return out


def say_ptxas(phase, source, kernel):
    """Prints each instantiation of ``kernel`` in ``source``'s build (the
    report that cuda_build keeps beside the library): its registers, spill
    store and spill load bytes, and the ptxas lines of any that spills."""
    from pybnesian_tpu_torch.ops import cuda_build

    report = cuda_build.build(source)["ptxas"]
    funcs = ptxas_functions(report)
    mine = {k: v for k, v in funcs.items() if k.startswith(kernel)}
    spilling = sorted(k for k, v in mine.items()
                      if v.split("/")[1:] != ["0", "0"])
    say(phase, source=source, kernel=kernel,
        registers_spill_stores_loads=repr(mine), spilling=repr(spilling))
    lines = report.splitlines()
    for name in spilling:  # the ptxas lines of each spilling instance
        mangled = name.replace("<", "ILi").replace(">", "E")
        for i, line in enumerate(lines):
            if "Function properties for" in line and mangled in line:
                say(phase, ptxas=repr(" | ".join(
                    x.strip() for x in lines[i:i + 3])))


def kernel_sweeps():
    """``tools/kernel_sweeps.py`` of this checkout, as a module."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import kernel_sweeps as sweeps

    return sweeps


def phase_build():
    """One nvcc per source, all started together, and the search kernel's
    instrumented copy (``tools/kernel_sweeps.py``) beside them. Returns
    that copy's library."""
    from pybnesian_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda_build.SOURCES) + 1) as pool:
        stamped = pool.submit(kernel_sweeps().search_stamped)
        infos = list(pool.map(cuda_build.build, cuda_build.SOURCES))
        stamped = stamped.result()
    wall = time.perf_counter() - t0
    for source, info in zip(cuda_build.SOURCES, infos):
        cuda_build.load(source)
        regs = sorted({
            line.split("Used", 1)[1].split(",")[0].strip()
            for line in info["ptxas"].splitlines() if "Used" in line
        })
        say("1 build", source=source, built=info["built"],
            seconds=f"{info['seconds']:.2f}", ptxas_used=repr(regs),
            spilling=repr(ptxas_spills(info["ptxas"])),
            library=os.path.basename(info["path"]))
    say("1 build", sources=len(infos), wall_s=f"{wall:.2f}",
        instrumented="ucv_pairs.cu (tools/kernel_sweeps.py search)")
    return stamped


def pair_inputs(torch, G, ntr, nte, dpad, seed, scale=3.0):
    """Random kernel inputs on the card: ~10% null train rows, every third
    program evidence-free."""
    rng = np.random.default_rng(seed)
    jtr = rng.normal(0, scale, (G, ntr, dpad)).astype(np.float32)
    jte = rng.normal(0, scale, (G, nte, dpad)).astype(np.float32)
    neg = np.where(rng.random((G, ntr)) < 0.1, -np.inf, 0.0).astype(np.float32)
    no_ev = (np.arange(G) % 3 == 1).astype(np.float32)
    lm_const = np.log(np.maximum((neg == 0).sum(1), 1)).astype(np.float32)
    arrays = [jtr, neg, np.ascontiguousarray(jtr[..., -1]), jte,
              np.ascontiguousarray(jte[..., -1]), no_ev, lm_const]
    return [torch.as_tensor(a, device="cuda") for a in arrays]


def cuda_median_ms(torch, fn, runs=TIMED_RUNS, batch=1):
    """Median ms per call of ``fn`` over ``runs`` CUDA-event windows of
    ``batch`` back-to-back calls each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def time_kernel(torch, fn):
    """``ms`` (one launch per window) and ``batched_ms`` of a kernel."""
    return {"ms": cuda_median_ms(torch, fn),
            "batched_ms": cuda_median_ms(torch, fn, batch=KERNEL_BATCH)}


def split_sweep(torch, launch, args, want, plan, phase, label):
    """Times ``launch`` (a kernel's uncounted launcher) on ``args`` with the
    plan's train axis forced to each split of :data:`SPLITS`, one launch
    per window, each output held bit-equal to ``want``, the planned
    launch's output on the same inputs: the split only decides which block
    sweeps which of the fixed leaves of the reduction."""
    times = {}
    for split in SPLITS:
        forced = (*plan[:2], split)
        got = launch(*args, forced)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            raise AssertionError(f"{label} split {split}: not bit-equal to "
                                 f"the planned launch (max abs diff {err})")
        times[f"S{split}_ms"] = (
            f"{cuda_median_ms(torch, lambda: launch(*args, forced)):.4f}")
    say(phase, case=label, planned_S=plan[2], **times)


def compare_pairs(torch, args, label, card=None, phase="2 kernel",
                  quiet=False):
    """The kernel against its plain version on ``args``; timed, with its
    launch plan and bound, when ``card`` is given; printed unless
    ``quiet``."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import (
        _launch, _launch_plan, ckde_cv_pairs, ckde_cv_pairs_reference)

    got = ckde_cv_pairs(*args)
    want = ckde_cv_pairs_reference(*args)
    torch.cuda.synchronize()
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{label}: NaN in kernel or plain output")
    err = float((got - want).abs().max())
    if not err <= PAIR_TOL:
        raise AssertionError(f"{label}: max abs diff {err} > {PAIR_TOL}")
    G, ntr, dpad = args[0].shape
    nte = args[3].shape[1]
    fields = {"case": label, "G_ntr_nte_dpad": f"{G}x{ntr}x{nte}x{dpad}",
              "max_abs_err": f"{err:.3e}"}
    result = {"err": err}
    if card is not None:
        result.update(
            time_kernel(torch, lambda: ckde_cv_pairs(*args)),
            plain_ms=cuda_median_ms(torch,
                                    lambda: ckde_cv_pairs_reference(*args)),
            work=pairs_work(args),
            plan=_launch_plan(G, ntr, nte, dpad, card["sms"]))
        fields.update(timing_fields(card, result))
    if not quiet:
        say(phase, **fields)
    if card is not None:
        split_sweep(torch, _launch, args, got, result["plan"], "2 split",
                    label)
    return result


def hold_batch_independence(torch, wrapper, args, label, phase):
    """Program 0 of a launch of ``wrapper`` on ``args`` (G programs) held
    bit-equal to the same program launched alone (G 1), and the launch to
    itself run again: a program's float32 result depends on its own inputs
    only."""
    together = wrapper(*args)
    alone = wrapper(*[a[:1].contiguous() for a in args])
    again = wrapper(*args)
    torch.cuda.synchronize()
    if not (torch.equal(together[:1], alone) and torch.equal(together, again)):
        raise AssertionError(f"{label}: program 0 alone, inside G "
                             f"{args[0].shape[0]} and run again is not "
                             "bit-equal")
    say(phase, case=label, G=args[0].shape[0],
        program0_bit_equal_alone_in_batch_and_rerun=True)


WHITEN_NAMES = ("jtr", "neg", "zv_tr", "jte", "zv_te", "no_ev", "lm_const",
                "wte", "lndiff", "ok")


def whiten_work(args, bandwidths=None):
    """(exps, FP32 ops, bytes, FP64 ops) of one ckde_cv_whiten call on
    ``args``: each input read once (the data, its null mask, the folds'
    indices and masks, the family columns, the bandwidths), each output
    written once ((ntr + nte) × (dpad + 2) floats a program and four
    scalars); per program and row of width d, 2d + 2 float64 operations
    for the mean, 3d + d(d + 1) for the covariance (rule bandwidths only)
    and 2d² + 2d for the whitening, d the family's own width."""
    data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask = (
        args)
    n, D = data.shape
    F, dpad = col_idx.shape
    K, ntr = tr_idx.shape
    nte = te_idx.shape[1]
    G = F * K
    nbytes = (8 * n * D + 12 * F * dpad + 12 * K * (ntr + nte)
              + (0 if bandwidths is None else 4 * G * dpad * dpad)
              + 4 * G * (ntr + nte) * (dpad + 2) + 20 * G)
    d = col_mask.double().sum(1).cpu()
    per_row = 2 * d + 2 + 2 * d * d + 2 * d
    if bandwidths is None:
        per_row += 3 * d + d * (d + 1)
    f64_ops = K * float(((ntr + nte) * per_row).sum())
    return 0.0, 0.0, nbytes, f64_ops


def reduce_work(args):
    """(exps, FP32 ops, bytes, FP64 ops) of one ckde_cv_fold_reduce call:
    the rows and weights read once (4 bytes each), lndiff and ok, the F
    results; 3 float64 operations a test row."""
    out = args[0]
    F, K, nte = out.shape
    return (0.0, 0.0, 8 * F * K * nte + 12 * F * K + 4 * F,
            3.0 * F * K * nte)


def compare_whiten(torch, args, label, card=None, phase="4 main path",
                   quiet=False, rule="nr", bandwidths=None):
    """The whitening kernel against its plain version on ``args``: each
    output at its :data:`WHITEN_TOL` (exactly where it has none), every NaN
    in the same place; timed, with its bound, when ``card`` is given;
    printed unless ``quiet``. ``err`` is the largest difference of a
    whitened value."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        ckde_cv_whiten, ckde_cv_whiten_reference)

    kw = {"rule": rule, "bandwidths": bandwidths}
    got = ckde_cv_whiten(*args, **kw)
    want = ckde_cv_whiten_reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(WHITEN_NAMES, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label} {name}: {g.dtype} {tuple(g.shape)}"
                                 f" against {w.dtype} {tuple(w.shape)}")
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{label} {name}: NaN in other places")
        tol = WHITEN_TOL.get(name, 0.0)
        try:
            torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                       equal_nan=True)
        except AssertionError as e:
            raise AssertionError(f"{label} {name}: {e}") from None
        if name in ("jtr", "zv_tr", "jte", "zv_te"):
            diff = (g.double() - w.double()).abs()
            diff = diff[torch.isfinite(diff)]
            if diff.numel():
                err = max(err, float(diff.max()))
    F, dpad = args[2].shape
    K, ntr = args[4].shape
    fields = {"case": label, "F_K_ntr_nte_dpad":
              f"{F}x{K}x{ntr}x{args[6].shape[1]}x{dpad}",
              "route": "rule " + str(rule) if bandwidths is None
              else "given bandwidths",
              "max_abs_err": f"{err:.3e}",
              "nan_programs": int(torch.isnan(got[8]).sum())}
    result = {"err": err}
    if card is not None:
        result.update(
            time_kernel(torch, lambda: ckde_cv_whiten(*args, **kw)),
            plain_ms=cuda_median_ms(
                torch, lambda: ckde_cv_whiten_reference(*args, **kw)),
            work=whiten_work(args, bandwidths))
        fields.update(timing_fields(card, result))
    if not quiet:
        say(phase, kernel="ckde_cv_whiten", **fields)
    return result


def reduce_inputs(torch, parts):
    """The fold reduce's arguments after a whitening call's ``parts``: the
    pairs kernel's rows on them, then wte, lndiff and ok."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs

    wte, lndiff, ok = parts[7:]
    return [ckde_cv_pairs(*parts[:7]).reshape(wte.shape), wte, lndiff, ok]


def compare_reduce(torch, args, label, card=None, phase="4 main path",
                   quiet=False):
    """The fold-reduce kernel against its plain version's float64 sums of
    the same float32 rows at :data:`REDUCE_RTOL`; timed, with its bound,
    when ``card`` is given; printed unless ``quiet``."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _sm_count
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        _reduce_plan, ckde_cv_fold_reduce, ckde_cv_fold_reduce_reference)

    out, wte, lndiff, ok = args
    got = ckde_cv_fold_reduce(*args)
    want = ckde_cv_fold_reduce_reference(out.double(), wte.double(), lndiff,
                                         ok.double())
    torch.cuda.synchronize()
    try:
        torch.testing.assert_close(got.double(), want, rtol=REDUCE_RTOL,
                                   atol=0, equal_nan=True)
    except AssertionError as e:
        raise AssertionError(f"{label} fold reduce: {e}") from None
    diff = (got.double() - want).abs()
    diff = diff[torch.isfinite(diff)]
    err = float(diff.max()) if diff.numel() else 0.0
    F, K, nte = out.shape
    fields = {"case": label, "F_K_nte": f"{F}x{K}x{nte}",
              "cluster": _reduce_plan(F, K, _sm_count(out.device)),
              "max_abs_err": f"{err:.3e}",
              "nan_families": int(torch.isnan(got).sum())}
    result = {"err": err}
    if card is not None:
        result.update(
            time_kernel(torch, lambda: ckde_cv_fold_reduce(*args)),
            plain_ms=cuda_median_ms(
                torch, lambda: ckde_cv_fold_reduce_reference(*args)),
            work=reduce_work(args))
        fields.update(timing_fields(card, result))
    if not quiet:
        say(phase, kernel="ckde_cv_fold_reduce", **fields)
    return result


def reduce_rows(torch, F, K, nte, seed):
    """Fold-reduce arguments made from ``seed``: rows of log-likelihood
    values, weights 1 (a few 0.5) with about one row in 7 at 0, those rows
    -inf or NaN in turn (both count 0), lndiff around -1.4, and one
    degenerate fold (ok 0: NaN for its family)."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(-4.0, 2.0, (F, K, nte)).astype(np.float32)
    wte = np.where(rng.random((F, K, nte)) < 0.05, 0.5, 1.0)
    zero = rng.random((F, K, nte)) < 1 / 7
    wte[zero] = 0.0
    rows[zero] = np.where(np.arange(zero.sum()) % 2 == 0, -np.inf, np.nan)
    ok = np.ones((F, K))
    ok[F // 2, K // 2] = 0.0
    lndiff = rng.normal(-1.4, 0.3, (F, K))
    return [torch.as_tensor(rows, device="cuda"),
            torch.as_tensor(wte, dtype=torch.float32, device="cuda"),
            torch.as_tensor(lndiff, device="cuda"),
            torch.as_tensor(ok, dtype=torch.float32, device="cuda")]


def reduce_split_sweep(torch, args, label, phase):
    """The fold reduce on ``args`` at every cluster size S it takes (1 to
    min(K, 8)), each result held bit-equal to the planned launch's and
    timed (one launch per window)."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _sm_count
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        _reduce_plan, ckde_cv_fold_reduce)

    F, K, _ = args[0].shape
    want = ckde_cv_fold_reduce(*args).view(torch.int32)
    times = {}
    for split in range(1, min(K, 8) + 1):
        got = ckde_cv_fold_reduce(*args, split=split)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want):
            raise AssertionError(f"fold reduce {label} S {split}: not "
                                 "bit-equal to the planned launch")
        ms = cuda_median_ms(
            torch, lambda: ckde_cv_fold_reduce(*args, split=split))
        times[f"S{split}_ms"] = f"{ms:.4f}"
    say(phase, kernel="ckde_cv_fold_reduce", case=label,
        planned_S=_reduce_plan(F, K, _sm_count(args[0].device)),
        bit_equal_at_every_S=True, **times)


def lg_inputs_cv(engine, fams):
    """``lg_cv_stats``'s arguments for (variable, parents) families ``fams``
    on a CV engine's folds, as its ``lg_batch`` builds them."""
    pos = {c: i for i, c in enumerate(engine.df.continuous_columns())}
    values, valid, train, test, vi, pi, pm = engine.lg_inputs(
        [(pos[v], [pos[p] for p in ps]) for v, ps in fams])
    return [values, valid, train, vi, pi, pm, values, valid, test]


def lg_inputs_holdout(holdout, fams):
    """``lg_cv_stats``'s arguments for (variable, parents) families ``fams``
    on a HoldoutLikelihood's split, as its ``local_score_batch`` builds
    them: one fold of every training row, every test row."""
    from pybnesian_tpu_torch.ops.gaussian import family_tensors

    train, test = holdout.training_data(), holdout.test_data()
    cont = train.continuous_columns()
    pos = {c: i for i, c in enumerate(cont)}
    tv, tvalid = train.device_matrix(cont, device=holdout.device)
    sv, svalid = test.device_matrix(cont, device=holdout.device)
    fam_t = family_tensors([(pos[v], [pos[p] for p in ps]) for v, ps in fams],
                           np.float32, holdout.device)
    return [tv, tvalid, None, *fam_t, sv, svalid, None]


def lg_edge_inputs(torch, args):
    """Degenerate inputs cut from CV ``args``: column 0 constant (0.0), a
    NaN cell in column 1, fold 0 with two training rows; families with
    column 0 only as their variable (a constant parent would make the
    Cholesky's verdict a matter of rounding)."""
    from pybnesian_tpu_torch.ops.gaussian import family_tensors

    values, valid, train, test = (args[0].clone(), args[1], args[2].clone(),
                                  args[8])
    values[:, 0] = 0.0
    values[5, 1] = math.nan
    keep = torch.nonzero(train[0])[:2, 0]
    train[0] = 0.0
    train[0, keep] = 1.0
    fams = [(0, []), (0, [2]), (1, []), (1, [2]), (2, [3]), (3, [2, 4]),
            (4, [])]
    fam_t = family_tensors(fams, np.float32, values.device)
    return [values, valid, train, *fam_t, values, valid, test]


def lg_work(args):
    """(exps, FP32 ops, bytes, FP64 ops) of one ``lg_cv_stats`` call: each
    input read once (the values and validity of both frames, the fold
    masks, the family tensors), each output written once (the Grams, BICs,
    fold sums and scores); per program, each train row of
    its fold W (W + 1) + W float64 operations for the Gram (an FMA counted
    2) and each test row 2 (k + 1) + 8 for its mean and log-likelihood,
    W = k + 2 for the family's own k parents."""
    tr_values, _, train, _, parent_idx, parent_mask, te_values, _, test = (
        args)
    n, D = tr_values.shape
    F, P = parent_idx.shape
    K = 1 if train is None else train.shape[0]
    G, W = F * K, P + 2
    k = parent_mask.double().sum(1).cpu()
    w = k + 2.0
    rows_tr = float(n * K if train is None else (train > 0).sum())
    f64_ops = rows_tr * float((w * (w + 1.0) + w).sum())
    nbytes = (8 * n * D + (0 if train is None else 4 * K * n) + 8 * F
              + 12 * F * P + 8 * G * (W * W + 1))
    if te_values is not None:
        m = te_values.shape[0]
        rows_te = float(m * K if test is None else (test > 0).sum())
        f64_ops += rows_te * float((2.0 * (k + 1.0) + 8.0).sum())
        nbytes += ((0 if te_values is tr_values else 8 * m * D)
                   + (0 if test is None else 4 * K * m) + 8 * G + 4 * F)
    return 0.0, 0.0, nbytes, f64_ops


def lg_rel(got, want, label):
    """(max relative, max absolute) difference of ``got`` against the
    float64 ``want`` over want's finite entries; raises unless every
    non-finite entry (−inf, +inf, NaN) and every zero is the same in
    both."""
    g = got.double().cpu().flatten()
    w = want.double().cpu().flatten()
    fin = w.isfinite()
    odd = ~fin & ~w.isnan()
    if not (bool((g.isfinite() == fin).all())
            and bool((g.isnan() == w.isnan()).all())
            and bool((g[odd] == w[odd]).all())):
        raise AssertionError(f"{label}: the -inf/NaN pattern differs from "
                             "the plain version's")
    g, w = g[fin], w[fin]
    zero = w == 0
    if not bool((g[zero] == 0).all()):
        raise AssertionError(f"{label}: a zero of the plain version is not "
                             "zero")
    if not len(w):
        return 0.0, 0.0
    diff = (g - w).abs()
    return (float((diff[~zero] / w[~zero].abs()).max()) if bool((~zero).any())
            else 0.0), float(diff.max())


def lg_library_ms(torch, args):
    """One ``torch.einsum`` of the Gram stage alone, float32, on the same
    inputs (the weights and design built beforehand, untimed): the library
    yardstick of the LG kernel."""
    from pybnesian_tpu_torch.ops.gaussian import _family_design

    tr_values, tr_valid, train, vi, pi, pm = args[:6]
    design, w = _family_design(tr_values, tr_valid, vi, pi, pm)
    wtr = w[:, None, :] if train is None else w[:, None, :] * train[None]
    return cuda_median_ms(torch, lambda: torch.einsum(
        "fkn,fni,fnj->fkij", wtr, design, design))


def compare_lg(torch, args, label, card=None, phase="8 hc lg kernel",
               quiet=False):
    """The LG kernel (``lg_cv_stats``) against its plain version run in
    float64 on the same float32 inputs, on the card: every score, every
    (family, fold) BIC and Gram entry, and ``family_grams``'s Grams and row
    counts over the training rows, each within :data:`LG_RTOL` relative
    (one float32 rounding), the −inf/NaN pattern and the zeros exact. Timed,
    with its bound, plain version and library yardstick, when ``card`` is
    given. ``err``: the largest absolute difference of a score or BIC."""
    from pybnesian_tpu_torch.ops.gaussian import family_grams, lg_fold_stats
    from pybnesian_tpu_torch.ops.lg_cv_kernel import lg_cv_stats

    got = lg_cv_stats(*args)
    f64 = [a.double() if a is not None and a.is_floating_point() else a
           for a in args]
    want = lg_fold_stats(*f64)
    grams32 = family_grams(*args[:2], *args[3:6])
    grams64 = family_grams(*f64[:2], *f64[3:6])
    torch.cuda.synchronize()
    rels, errs = {}, []
    pairs = {"bic": (got.bic.float(), want.bic),
             "gram": (got.gram.float(), want.gram),
             "family_grams": (grams32[0], grams64[0]),
             "family_n_eff": (grams32[1], grams64[1])}
    if want.scores is not None:
        pairs["score"] = (got.scores, want.scores)
    for name, (g, w) in pairs.items():
        rels[name], err = lg_rel(g, w, f"lg {label} {name}")
        if name in ("bic", "score"):
            errs.append(err)
        if not rels[name] <= LG_RTOL:
            raise AssertionError(f"lg {label} {name}: relative diff "
                                 f"{rels[name]} > {LG_RTOL}")
    F, P = args[4].shape
    K = 1 if args[2] is None else args[2].shape[0]
    n_te = 0 if args[6] is None else args[6].shape[0]
    fields = {"case": label,
              "F_K_P_ntr_nte": f"{F}x{K}x{P}x{args[0].shape[0]}x{n_te}",
              **{f"{k}_max_rel": f"{v:.3e}" for k, v in rels.items()},
              "neg_inf_scores": (int((want.scores == -math.inf).sum())
                                 if want.scores is not None else None),
              "max_abs_err": f"{max(errs):.3e}"}
    result = {"err": max(errs)}
    if card is not None:
        result.update(time_kernel(torch, lambda: lg_cv_stats(*args)),
                      plain_ms=cuda_median_ms(
                          torch, lambda: lg_fold_stats(*args)),
                      work=lg_work(args),
                      library_ms=lg_library_ms(torch, args))
        fields.update(timing_fields(card, result),
                      library="torch.einsum of the Gram stage, float32",
                      library_ms=f"{result['library_ms']:.4f}")
    if not quiet:
        say(phase, **fields)
    return result


def same_bits(torch, got, want):
    """Whether two tensors are the same bits: NaN in the same places, the
    rest equal."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))


def hold_same_bits(torch, got, want, label):
    """Each tensor of ``got`` the same bits as ``want``'s (NaN in the same
    places, the rest equal)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if not same_bits(torch, g, w):
            raise AssertionError(f"{label}: output {i} is not bit-equal")


def whiten_split_sweep(torch, args, kw, label, phase):
    """The whitening on ``args`` at every cluster size S of :data:`SPLITS`,
    each output held bit-equal to the planned launch's and timed (one
    launch per window)."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _sm_count
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        _launch_plan, ckde_cv_whiten)

    want = ckde_cv_whiten(*args, **kw)
    times = {}
    for split in SPLITS:
        got = ckde_cv_whiten(*args, split=split, **kw)
        torch.cuda.synchronize()
        hold_same_bits(torch, got, want, f"whiten {label} S {split}")
        ms = cuda_median_ms(
            torch, lambda: ckde_cv_whiten(*args, split=split, **kw))
        times[f"S{split}_ms"] = f"{ms:.4f}"
    planned = _launch_plan(args[2].shape[0] * args[4].shape[0],
                           args[4].shape[1], args[2].shape[1],
                           _sm_count(args[0].device))
    say(phase, kernel="ckde_cv_whiten", case=label, planned_S=planned,
        bit_equal_at_every_S=True, **times)


def lg_split_sweep(torch, args, label, phase):
    """``lg_cv_stats`` on ``args`` at every cluster size S of
    :data:`SPLITS`, its scores, Grams and BICs held bit-equal to the
    planned launch's and timed (one launch per window)."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _sm_count
    from pybnesian_tpu_torch.ops.lg_cv_kernel import _launch_plan, lg_cv_stats

    want = lg_cv_stats(*args)
    times = {}
    for split in SPLITS:
        got = lg_cv_stats(*args, split=split)
        torch.cuda.synchronize()
        hold_same_bits(torch, got, want, f"lg {label} S {split}")
        ms = cuda_median_ms(torch, lambda: lg_cv_stats(*args, split=split))
        times[f"S{split}_ms"] = f"{ms:.4f}"
    K = 1 if args[2] is None else args[2].shape[0]
    F, P = args[4].shape
    chunk, planned = _launch_plan(F, K, P + 2, args[0].shape[0],
                                  _sm_count(args[0].device))
    say(phase, kernel="lg_cv_stats", case=label, planned_chunk=chunk,
        planned_S=planned, bit_equal_at_every_S=True, **times)


def whiten_alone_in_batch(torch, engine, fams, label, phase):
    """At every S: each family's whitened parts in the batch of ``fams``
    the same bits as the family's own launch (its own width)."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    args, kw = engine_whiten_inputs(torch, engine, fams)
    K = args[4].shape[0]
    for split in SPLITS:
        together = ckde_cv_whiten(*args, split=split, **kw)
        for f, fam in enumerate(fams):
            a1, kw1 = engine_whiten_inputs(torch, engine, [fam])
            alone = ckde_cv_whiten(*a1, split=split, **kw1)
            w = a1[2].shape[1]
            g = slice(f * K, (f + 1) * K)
            mine = [together[0][g, :, :w], together[1][g], together[2][g],
                    together[3][g, :, :w], *(t[g] for t in together[4:7]),
                    *(t[f] for t in together[7:])]
            theirs = [alone[0], alone[1], alone[2], alone[3],
                      *alone[4:7], *(t[0] for t in alone[7:])]
            hold_same_bits(torch, theirs, mine,
                           f"whiten {label} family {f} S {split}")
    say(phase, kernel="ckde_cv_whiten", case=label, families=len(fams),
        alone_in_batch_bit_equal_at_every_S=True)


def lg_alone_in_batch(torch, make_args, fams, label, phase):
    """At every S: each family's score, BIC and Gram entries in the batch
    of ``fams`` the same bits as in the family's own launch;
    ``make_args(fams)`` builds ``lg_cv_stats``'s arguments."""
    from pybnesian_tpu_torch.ops.lg_cv_kernel import lg_cv_stats

    for split in SPLITS:
        together = lg_cv_stats(*make_args(fams), split=split)
        for f, fam in enumerate(fams):
            alone = lg_cv_stats(*make_args([fam]), split=split)
            w = len(fam[1]) + 2
            pairs = [(alone.bic[0], together.bic[f]),
                     (alone.gram[0, :, :w - 1, :w - 1],
                      together.gram[f, :, :w - 1, :w - 1]),
                     (alone.gram[0, :, :w - 1, -1],
                      together.gram[f, :, :w - 1, -1]),
                     (alone.gram[0, :, -1, -1], together.gram[f, :, -1, -1])]
            if together.scores is not None:
                pairs.append((alone.scores[0], together.scores[f]))
            hold_same_bits(torch, [a for a, _ in pairs], [b for _, b in pairs],
                           f"lg {label} family {f} S {split}")
    say(phase, kernel="lg_cv_stats", case=label, families=len(fams),
        alone_in_batch_bit_equal_at_every_S=True)


def device_kernels(torch, fn):
    """(device operations, their summed device ms, names) of one call of
    ``fn`` after a warm one, under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    ms = sum(e.time_range.end - e.time_range.start for e in ops) / 1e3
    return len(ops), ms, [e.name for e in ops]


def efficient_attention_lse(torch, q, k, scale=1.0):
    """(B, M) natural-log logsumexp over keys of ``scale * q @ k.T`` from
    ``torch.ops.aten._scaled_dot_product_efficient_attention`` (one head;
    q (B, M, e), k (B, N, e) zero-padded to 8 columns). A yardstick only:
    the port never calls it."""
    e = -(-q.shape[-1] // 8) * 8
    q = torch.nn.functional.pad(q, (0, e - q.shape[-1]))[:, None]
    k = torch.nn.functional.pad(k, (0, e - k.shape[-1]))[:, None]
    v = torch.zeros_like(k)
    lse = torch.ops.aten._scaled_dot_product_efficient_attention(
        q.contiguous(), k.contiguous(), v, None, True, scale=scale)[1]
    return lse[:, 0, : q.shape[2]]


def padded_lse_operands(torch, te, tr, keep):
    """q = [te, 1] and k = [tr, -|tr|^2 / 2 (-1e30 where not ``keep``)]:
    q . k = -|te - tr|^2 / 2 + |te|^2 / 2 on the kept rows."""
    ones = torch.ones_like(te[..., :1])
    last = torch.where(keep, -0.5 * (tr * tr).sum(-1), -1e30)
    return (torch.cat([te, ones], -1).contiguous(),
            torch.cat([tr, last[..., None]], -1).contiguous())


def library_pairs(torch, args):
    """Kernel #1's function by two efficient-attention calls (the joint,
    the marginal) on ``args``: ms of the two calls, and their result's max
    abs error against the plain version."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs_reference

    jtr, neg, ztr, jte, zte, no_ev, lm_const = args
    qj, kj = padded_lse_operands(torch, jte, jtr, neg == 0)
    # the marginal drops the variable: q = [te, 1, -zte],
    # k = [tr, -|tr|^2 / 2 + ztr^2 / 2, ztr]
    qm = torch.cat([qj, -zte[..., None]], -1)
    km = torch.cat([kj[..., :-1], (kj[..., -1] + 0.5 * ztr * ztr)[..., None],
                    ztr[..., None]], -1)

    def calls():
        return (efficient_attention_lse(torch, qj, kj),
                efficient_attention_lse(torch, qm, km))

    lj, lm = calls()
    half = 0.5 * (jte * jte).sum(-1)
    got = (lj - half) - torch.where(no_ev[:, None] > 0.5, lm_const[:, None],
                                    lm - half + 0.5 * zte * zte)
    err = float((got - ckde_cv_pairs_reference(*args)).abs().max())
    return cuda_median_ms(torch, calls), err


def library_kde(torch, args):
    """Kernel #2's function by one efficient-attention call on ``args``:
    its ms and its result's max abs error against the plain version."""
    from pybnesian_tpu_torch.ops.kde_kernel import kde_logl_reference

    train, valid, test, lognorm = args
    q, k = padded_lse_operands(torch, test, train, valid > 0)
    got = (efficient_attention_lse(torch, q, k)
           - 0.5 * (test * test).sum(-1) + lognorm[:, None])
    err = float((got - kde_logl_reference(*args)).abs().max())
    return cuda_median_ms(torch, lambda: efficient_attention_lse(torch, q, k)
                          ), err


def phase_kernel(torch, main_args, card):
    """Small cases, then the timed shapes; returns the timed cases'
    results by label."""
    # (a) small cases: ragged ntr and nte, evidence-free programs, a program
    # whose second 256-row train tile is all padding, dpad 1/2/4/8
    for dpad in (1, 2, 4, 8):
        args = pair_inputs(torch, 4, 600, 77, dpad, seed=dpad)
        args[1][2, 256:512] = -math.inf
        compare_pairs(torch, args, f"small-dpad{dpad}")
    # (b) the bench shape: 150 (family, fold) programs, 9000 × 1000 rows;
    # (c) config3b's model.slogl shape; (d) the main path's own inputs:
    # the whitened parts of its first batch
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs

    bench_args = pair_inputs(torch, 150, 9000, 1000, 4, seed=7)
    cases = {
        "bench-shape": compare_pairs(torch, bench_args, "bench-shape", card),
        "config3b-shape": compare_pairs(
            torch, pair_inputs(torch, *CONFIG3B_PAIRS_SHAPE, seed=8),
            "config3b-shape", card),
        "main-path-inputs": compare_pairs(torch, main_args,
                                          "main-path-inputs", card),
    }
    hold_batch_independence(torch, ckde_cv_pairs, bench_args, "bench-shape",
                            "2 kernel")
    hold_batch_independence(torch, ckde_cv_pairs, main_args,
                            "main-path-inputs", "2 kernel")
    library_ms, library_err = library_pairs(torch, main_args)
    cases["main-path-inputs"].update(library_ms=library_ms)
    say("2 kernel", case="main-path-inputs",
        library="2 calls of _scaled_dot_product_efficient_attention",
        library_ms=f"{library_ms:.4f}",
        library_max_abs_err=f"{library_err:.3e}",
        kernel_ms=f"{cases['main-path-inputs']['ms']:.4f}")
    # (e) the CV path's shape at 100,000 rows, too large for the plain
    # version's timing: the forced splits against the planned launch
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _launch, _launch_plan

    args = pair_inputs(torch, *CV_100K_PAIRS_SHAPE, seed=9)
    want = ckde_cv_pairs(*args)
    if not torch.isfinite(want).all():
        raise AssertionError("cv-100k-shape: non-finite kernel output")
    split_sweep(torch, _launch, args, want,
                _launch_plan(*CV_100K_PAIRS_SHAPE, card["sms"]), "2 split",
                "cv-100k-shape")
    return cases


def main_path_pair_inputs(torch, frame32, k):
    """The kernel's arguments for the main path's first batch."""
    from pybnesian_tpu_torch import CVLikelihood

    return engine_pair_inputs(torch, CVLikelihood(frame32, k=k, seed=0)._engine,
                              families(frame32.num_columns))


def engine_whiten_inputs(torch, engine, fams):
    """The whitening kernel's arguments and keywords for the (variable,
    parents) families ``fams`` under the normal reference rule, built by a
    score's own fold engine (its device cache) as the score builds them."""
    from pybnesian_tpu_torch.learning.scores.likelihood import _family_columns

    pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask = (
        engine._device_cv_cache()
    )
    col_idx, col_mask = _family_columns(fams, pos)
    return [data, null_mask, torch.as_tensor(col_idx, device="cuda"),
            torch.as_tensor(col_mask, dtype=torch.float32, device="cuda"),
            tr_idx, tr_mask, te_idx, te_mask], {"rule": "nr"}


def engine_pair_inputs(torch, engine, fams):
    """The pairs kernel's arguments for the (variable, parents) families
    ``fams`` under the normal reference rule: the route's own whitened
    parts, the whitening kernel's outputs on
    :func:`engine_whiten_inputs`."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    args, kw = engine_whiten_inputs(torch, engine, fams)
    return list(ckde_cv_whiten(*args, **kw)[:7])


def phase_selfcheck():
    from pybnesian_tpu_torch.ops.kde import flash_cv_selfcheck

    ok, diff = flash_cv_selfcheck(device="cuda")
    if not ok:
        raise AssertionError(f"flash_cv_selfcheck failed: max abs diff {diff}")
    say("3 selfcheck", ok=ok, max_abs_diff=f"{diff:.3e}")


def check_scores(got, want, label):
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: non-finite scores {got}")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if not rel <= SCORE_RTOL:
        raise AssertionError(f"{label}: max rel diff {rel} > {SCORE_RTOL}")
    return rel


def phase_main_path(torch, frame32, frame64, k, card):
    """The CV path at bench.py's workload, then a semiparametric mix (its
    linear-Gaussian families through the LG kernel); the LG kernel held to
    its plain version on the mix's and every one-parent linear-Gaussian
    family; then the whitening and fold-reduce kernels held to their plain
    versions on its first batch's inputs and timed, with stage 1's device
    operations by the plain torch route and by the kernel. Returns the
    path's launches (the CKDE calls and the mix), the two kernels' checked
    and timed cases and the LG kernel's largest error."""
    from pybnesian_tpu_torch import (
        CKDEType, CVLikelihood, KDENetwork, LinearGaussianCPDType,
        SemiparametricBN)
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        ckde_cv_fold_reduce, ckde_cv_whiten, ckde_cv_whiten_reference)
    from pybnesian_tpu_torch.ops.kde import ckde_cv_alldevice_flash
    from pybnesian_tpu_torch.ops.lg_cv_kernel import lg_cv_stats

    cols = frame32.column_names()
    d = len(cols)
    score = CVLikelihood(frame32, k=k, seed=0)
    reference = CVLikelihood(frame64, k=k, seed=0)
    if score.device.type != "cuda":
        raise AssertionError(f"score runs on {score.device}, not cuda")
    model = KDENetwork(cols)
    ckde = CKDEType()
    # warm call + 3 checked calls + CV_RUNS timed calls, the family set
    # rotated as in bench.py:67-88; valid shifts are 1..d-2, so with d = 5
    # every third call reuses a family set (nothing caches scores)
    shifts = [1 + c % (d - 2) for c in range(4 + CV_RUNS)]
    batches = [[(v, ps, ckde) for v, ps in families(d, s)] for s in shifts]
    results, elapsed, grew = [], [], []
    stages = (ckde_cv_whiten, ckde_cv_pairs, ckde_cv_fold_reduce)
    reset_counts()
    for batch in batches:
        before = [w.launches for w in stages]
        t0 = time.perf_counter()
        results.append(score.local_score_batch(model, batch))
        elapsed.append(time.perf_counter() - t0)
        grew.append(tuple(w.launches - b for w, b in zip(stages, before)))
    if not all(min(g) > 0 for g in grew):
        raise AssertionError(f"whitening, pairs and reduce launches per "
                             f"call {grew}: a call did not go through the "
                             "three kernels")
    rel = max(
        check_scores(got, reference.local_score_batch(model, batch),
                     f"kde shift {s}")
        for got, batch, s in zip(results[:4], batches[:4], shifts[:4])
    )
    if not all(np.all(np.isfinite(got)) for got in results):
        raise AssertionError("non-finite scores in the timed calls")
    checked, timed = elapsed[1:4], elapsed[4:]
    rate = len(batches[0]) / statistics.mean(checked)
    median_rate = len(batches[0]) / statistics.median(timed)
    say("4 main path", network="KDENetwork", families=len(batches[0]),
        folds=k, rows=frame32.num_rows, launches_per_call=sorted(set(grew)),
        warm_s=f"{elapsed[0]:.4f}",
        checked_s=repr([round(t, 6) for t in checked]),
        family_scores_per_s_mean3=f"{rate:.2f}",
        timed_calls=len(timed),
        median_call_ms=f"{statistics.median(timed) * 1e3:.4f}",
        family_scores_per_s_median30=f"{median_rate:.2f}",
        max_rel_vs_f64=f"{rel:.3e}")

    # semiparametric mix: linear-Gaussian and CKDE families in one batch
    lg = LinearGaussianCPDType()
    spbn = SemiparametricBN(cols)
    mix = [(v, ps, lg if f % 2 else ckde)
           for f, (v, ps) in enumerate(families(d, 1))]
    before = (ckde_cv_pairs.launches, lg_cv_stats.launches)
    got = score.local_score_batch(spbn, mix)
    if (ckde_cv_pairs.launches, lg_cv_stats.launches) == before:
        raise AssertionError("the semiparametric batch did not launch the "
                             "pairs and LG kernels")
    launches = read_counts()
    rel = check_scores(got, reference.local_score_batch(spbn, mix),
                       "semiparametric mix")
    say("4 main path", network="SemiparametricBN", families=len(mix),
        lg=sum(1 for _, _, t in mix if t == lg),
        ckde=sum(1 for _, _, t in mix if t == ckde),
        max_rel_vs_f64=f"{rel:.3e}", launches=launches)
    # the LG kernel on the mix's linear-Gaussian families at phase 4's
    # size (10,000 rows, 10 folds), then on every one-parent family
    lg_fams = [(v, ps) for v, ps, t in mix if t == lg]
    lg_cases = (("main-path-lg-families", lg_fams),
                ("main-path-one-parent", [(v, [p]) for v in cols
                                          for p in cols if p != v]))
    lg_err = max(
        compare_lg(torch, lg_inputs_cv(score._engine, fams), label,
                   phase="4 main path")["err"]
        for label, fams in lg_cases)
    # both redesigned kernels at every cluster size S: bit-equal to the
    # planned launch, timed, and each family alone and in its batch
    say_ptxas("4 main path", "lg_cv.cu", "lg_kernel")
    for label, fams in lg_cases:
        lg_split_sweep(torch, lg_inputs_cv(score._engine, fams), label,
                       "4 main path")
        lg_alone_in_batch(torch, lambda fs: lg_inputs_cv(score._engine, fs),
                          fams, label, "4 main path")

    # the whitening and fold reduce on the first batch's inputs (G 150):
    # against their plain versions, timed; stage 1 on the card by the plain
    # torch route (the route before its kernel, its statistics now
    # float64) and by the kernel, and the whole float32 CV call
    args, kw = engine_whiten_inputs(torch, score._engine,
                                    [(v, ps) for v, ps, _ in batches[0]])
    whiten = compare_whiten(torch, args, "main-path-inputs", card, **kw)
    say_ptxas("4 main path", "cv_whiten.cu", "whiten_kernel")
    whiten_split_sweep(torch, args, kw, "main-path-inputs", "4 main path")
    whiten_alone_in_batch(torch, score._engine,
                          [(v, ps) for v, ps, _ in batches[0]],
                          "main-path-inputs", "4 main path")
    parts = ckde_cv_whiten(*args, **kw)
    reduce_args = reduce_inputs(torch, parts)
    reduce = compare_reduce(torch, reduce_args, "main-path-inputs", card)
    say_ptxas("4 main path", "cv_whiten.cu", "fold_reduce_kernel")
    reduce_split_sweep(torch, reduce_args, "main-path-inputs", "4 main path")
    # the 100,000-row CV call's fold sums (F 15, K 10, 10,000 test rows a
    # fold) on rows made from a seed
    rows_100k = reduce_rows(torch, len(batches[0]), k, 10_000, seed=100_000)
    compare_reduce(torch, rows_100k, "rows-100k", card)
    reduce_split_sweep(torch, rows_100k, "rows-100k", "4 main path")
    del rows_100k
    plain_ops, plain_ms, _ = device_kernels(
        torch, lambda: ckde_cv_whiten_reference(*args, **kw))
    kernel_ops, kernel_ms, _ = device_kernels(
        torch, lambda: ckde_cv_whiten(*args, **kw))
    call_ops, call_ms, names = device_kernels(
        torch, lambda: ckde_cv_alldevice_flash(*args, **kw))
    say("4 main path", stage="1 whitening", programs=parts[0].shape[0],
        plain_route_device_ops=plain_ops,
        plain_route_device_ms=f"{plain_ms:.4f}",
        kernel_device_ops=kernel_ops, kernel_device_ms=f"{kernel_ms:.4f}",
        cv_call_device_ops=call_ops, cv_call_device_ms=f"{call_ms:.4f}",
        cv_call_ops=repr([n[:40] for n in names]),
        median_call_ms=f"{statistics.median(timed) * 1e3:.4f}",
        card=repr(card["smi"]))
    return launches, whiten, reduce, lg_err


def kde_inputs(torch, G, ntr, nte, d, seed, scale=2.0):
    """Random KDE-kernel inputs on the card: ~10% invalid train rows."""
    rng = np.random.default_rng(seed)
    train = rng.normal(0, scale, (G, ntr, d)).astype(np.float32)
    test = rng.normal(0, scale, (G, nte, d)).astype(np.float32)
    valid = (rng.random((G, ntr)) > 0.1).astype(np.float32)
    lognorm = rng.normal(-3.0, 0.5, G).astype(np.float32)
    return [torch.as_tensor(a, device="cuda")
            for a in (train, valid, test, lognorm)]


def compare_kde(torch, args, label, card=None, phase="5 kde kernel",
                quiet=False):
    """The kernel against its plain version on ``args``; timed, with its
    launch plan and bound, when ``card`` is given; printed unless
    ``quiet``."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _launch_plan
    from pybnesian_tpu_torch.ops.kde_kernel import (
        _launch, kde_logl, kde_logl_reference)

    got = kde_logl(*args)
    want = kde_logl_reference(*args)
    torch.cuda.synchronize()
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{label}: NaN in kernel or plain output")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    err = float((got - want).abs().max())
    if not err <= PAIR_TOL:
        raise AssertionError(f"{label}: max abs diff {err} > {PAIR_TOL}")
    G, ntr, d = args[0].shape
    nte = args[2].shape[1]
    fields = {"case": label, "G_ntr_nte_d": f"{G}x{ntr}x{nte}x{d}",
              "max_abs_err": f"{err:.3e}"}
    result = {"err": err}
    if card is not None:
        result.update(
            time_kernel(torch, lambda: kde_logl(*args)),
            plain_ms=cuda_median_ms(torch,
                                    lambda: kde_logl_reference(*args)),
            work=kde_work(args),
            plan=_launch_plan(G, ntr, nte, d, card["sms"]))
        fields.update(timing_fields(card, result))
    if not quiet:
        say(phase, **fields)
    if card is not None:
        split_sweep(torch, _launch, args, got, result["plan"],
                    "5 kde split", label)
    return result


def phase_kde_kernel(torch, card):
    """Small ragged cases, then the TPU kernel's shape (pallas_kde.py:11),
    timed; returns the timed case's result with the largest error."""
    errs = []
    for G in (1, 2):
        for d in (1, 2, 3, 8, 16, 20):
            args = kde_inputs(torch, G, 600, 77, d, seed=10 * G + d)
            args[1][0, :256] = 0.0  # an all-invalid first train tile
            errs.append(compare_kde(torch, args, f"small-G{G}-d{d}")["err"])
    from pybnesian_tpu_torch.ops.kde_kernel import kde_logl

    args = kde_inputs(torch, *KDE_TPU_SHAPE, seed=1)
    result = compare_kde(torch, args, "tpu-docstring-shape", card)
    result["err"] = max(errs + [result["err"]])
    # the same program inside G 150 (the CV path's program count)
    hold_batch_independence(
        torch, kde_logl, [a.expand(150, *a.shape[1:]).contiguous()
                          for a in args],
        "tpu-docstring-shape", "5 kde kernel")
    result["library_ms"], library_err = library_kde(torch, args)
    say("5 kde kernel", case="tpu-docstring-shape",
        library="_scaled_dot_product_efficient_attention",
        library_ms=f"{result['library_ms']:.4f}",
        library_max_abs_err=f"{library_err:.3e}",
        kernel_ms=f"{result['ms']:.4f}")
    return result


def phase_exp_chain(torch, card, timed_cases):
    """The probe against its plain version, its accurate-``expf`` rate and
    its bound; then each timed kernel case (``timed_cases``: label →
    result) against its bound."""
    from pybnesian_tpu_torch.ops.exp_chain import (
        CHAIN, REPEATS, SHAPE, exp_chain, exp_chain_reference)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(-np.abs(rng.normal(size=SHAPE)).astype(np.float32),
                        device="cuda")
    got = exp_chain(x)
    want = exp_chain_reference(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= EXP_TOL):
        raise AssertionError(f"exp chain: max abs diff {err} > {EXP_TOL}")
    plain_ms = cuda_median_ms(torch, lambda: exp_chain_reference(x))
    reset_counts()
    times = time_kernel(torch, lambda: exp_chain(x))
    launches = read_counts()
    if launches["exp_chain"] == 0:
        raise AssertionError("the probe did not launch its kernel")
    n = SHAPE[0] * SHAPE[1]
    exps = n * CHAIN * REPEATS
    # per step: two FMAs and an add around the exp; x read, out written
    result = {"err": err, **times, "plain_ms": plain_ms,
              "work": (exps, 5 * exps, 8 * n), "plan": None}
    ms = times["batched_ms"]
    say("6 exp chain", shape=f"{SHAPE[0]}x{SHAPE[1]}", chain=CHAIN,
        repeats=REPEATS, max_abs_err=f"{err:.3e}",
        kernel_ms=f"{times['ms']:.4f}", kernel_batched_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        accurate_expf_gexp_per_s=f"{exps / (ms * 1e-3) / 1e9:.2f}",
        launches=launches)
    for label, case in {**timed_cases, "exp_chain": result}.items():
        exps, ops, nbytes = case["work"]
        bound_ms, by = bound(card, exps, ops, nbytes)
        say("6 bound", case=label, exps=f"{exps:.6g}", fp32_ops=f"{ops:.6g}",
            bytes=f"{nbytes:.6g}", kernel_ms=f"{case['ms']:.4f}",
            kernel_batched_ms=f"{case['batched_ms']:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=by,
            bound_share=f"{bound_ms / case['ms']:.4f}",
            batched_bound_share=f"{bound_ms / case['batched_ms']:.4f}",
            gexp_per_s=f"{exps / (case['ms'] * 1e-3) / 1e9:.2f}",
            plan_R_T_S=",".join(map(str, case["plan"] or ["none"])))
    return result, launches


def phase_model_path(torch):
    """config3b's workload (benchmarks/config3b_logl_evals.py:34-49): an
    8-node SemiparametricBN chain with CKDE at the even nodes, fitted on
    10,000 float32 rows and evaluated on 10,000 more."""
    from pybnesian_tpu_torch import (
        KDE, CKDEType, DataFrame, SemiparametricBN, interop)
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs

    d, n = 8, 10_000
    train, test = config3b_data(n, 0), config3b_data(n, 1)
    train32, test32 = DataFrame.wrap(train), DataFrame.wrap(test)
    train64 = DataFrame.wrap({k: v.astype(np.float64)
                              for k, v in train.items()})
    test64 = DataFrame.wrap({k: v.astype(np.float64)
                             for k, v in test.items()})
    names = list(train)
    ckde_nodes = names[0::2]
    model = SemiparametricBN(
        names, [(names[i], names[i + 1]) for i in range(d - 1)],
        [(v, CKDEType()) for v in ckde_nodes],
    )
    model.fit(train32)
    # the same fitted model in float64, the plain route's reference
    model64 = interop.fitted_network(**as_float64(
        interop.network_state(model)))

    reset_counts()
    model.slogl(test32)  # warm
    elapsed, grew, values = [], [], []
    for _ in range(MODEL_RUNS):
        before = ckde_cv_pairs.launches
        t0 = time.perf_counter()
        values.append(model.slogl(test32))
        elapsed.append(time.perf_counter() - t0)
        grew.append(ckde_cv_pairs.launches - before)
    if not all(g > 0 for g in grew):
        raise AssertionError(f"pairs-kernel launches per slogl {grew}")
    rate = d * n / statistics.mean(elapsed)

    logl = model.logl(test32)
    logl64 = model64.logl(test64)
    if not np.all(np.isfinite(logl)):
        raise AssertionError("model.logl: non-finite rows")
    err_model = float(np.max(np.abs(logl - logl64)))
    if not err_model <= ROW_TOL:
        raise AssertionError(f"model.logl vs float64: {err_model} > {ROW_TOL}")
    slogl64 = model64.slogl(test64)
    say("7 model path", network="SemiparametricBN", nodes=d,
        ckde=len(ckde_nodes), train_rows=n, test_rows=n,
        slogl_s=repr([round(t, 6) for t in elapsed]),
        factor_row_evals_per_s=f"{rate:.2f}",
        slogl=f"{values[-1]:.6f}", slogl_f64=f"{slogl64:.6f}",
        logl_max_abs_vs_f64=f"{err_model:.3e}", pairs_launches=grew)

    from pybnesian_tpu_torch.ops.kde_kernel import kde_logl

    before = kde_logl.launches
    factors = sum(np.asarray(model.cpd(v).logl(test32)) for v in names)
    if kde_logl.launches - before != len(ckde_nodes):
        raise AssertionError("cpd.logl of the CKDE nodes launched the KDE "
                             f"kernel {kde_logl.launches - before} times")
    err_factors = float(np.max(np.abs(factors - logl)))
    if not err_factors <= ROW_TOL:
        raise AssertionError(
            f"Σ cpd.logl vs model.logl: {err_factors} > {ROW_TOL}")
    kde32, kde64 = KDE(["x0", "x1", "x2"]), KDE(["x0", "x1", "x2"])
    kde32.fit(train32)
    kde64.fit(train64)
    before = kde_logl.launches
    got = kde32.logl(test32)
    if kde_logl.launches == before:
        raise AssertionError("KDE.logl did not launch the KDE kernel")
    err_kde = float(np.max(np.abs(got - kde64.logl(test64))))
    if not (np.all(np.isfinite(got)) and err_kde <= ROW_TOL):
        raise AssertionError(f"KDE.logl vs float64: {err_kde} > {ROW_TOL}")

    t0 = time.perf_counter()
    sample = model.sample(1000, seed=0)
    sample_s = time.perf_counter() - t0
    cols = sample.to_pandas()
    if cols.shape != (1000, d) or not np.all(np.isfinite(cols.to_numpy())):
        raise AssertionError("model.sample: wrong shape or non-finite")
    launches = read_counts()
    say("7 model path", factors_vs_model_max_abs=f"{err_factors:.3e}",
        kde3_max_abs_vs_f64=f"{err_kde:.3e}", sample_rows=len(cols),
        sample_s=f"{sample_s:.4f}", launches=launches)
    return launches


def dag_order(nodes, arcs):
    """A topological order of ``nodes`` under ``arcs``; raises on a cycle."""
    parents = {n: set() for n in nodes}
    for s, t in arcs:
        parents[t].add(s)
    order = []
    while len(order) < len(nodes):
        ready = [n for n in nodes if n not in order and parents[n] <= set(order)]
        if not ready:
            raise AssertionError(f"the learned graph has a cycle: {arcs}")
        order += ready
    return order


def counting_validated_likelihood():
    """A ValidatedLikelihood that counts the families it scores and keeps
    every score it returns (both channels)."""
    from pybnesian_tpu_torch import ValidatedLikelihood

    class CountingValidatedLikelihood(ValidatedLikelihood):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.families = 0
            self.scores = []

        def _keep(self, values):
            values = np.atleast_1d(np.asarray(values, np.float64))
            self.families += len(values)
            self.scores.append(values)

        def local_score_batch(self, model, families):
            out = super().local_score_batch(model, families)
            self._keep(out)
            return out

        def local_score_node_type(self, model, node_type, variable, parents):
            out = super().local_score_node_type(model, node_type, variable,
                                                parents)
            self._keep(out)
            return out

        def vlocal_score_batch(self, model, families):
            out = super().vlocal_score_batch(model, families)
            self._keep(out)
            return out

        def vlocal_score_node_type(self, model, node_type, variable, parents):
            out = super().vlocal_score_node_type(model, node_type, variable,
                                                 parents)
            self._keep(out)
            return out

    return CountingValidatedLikelihood


class StepRecorder:
    """hc callback: each iteration's operator and the model after it
    (iteration 0: the start model; the last call: the model returned)."""

    def __init__(self):
        self.operators, self.models, self.iterations = [], [], 0

    def call(self, model, operator, score, iteration):
        self.operators.append(operator)
        self.models.append(model.clone())
        self.iterations = iteration


def learn(torch, frame, search=None):
    """One search on ``frame`` as a user calls it, with the counting score
    and a recorder: (model, score, recorder, wall seconds).
    ``search(score, recorder)`` runs it; by default ``hc`` on a
    SemiparametricBN."""
    from pybnesian_tpu_torch import SemiparametricBNType, hc

    if search is None:
        def search(score, recorder):
            return hc(frame, bn_type=SemiparametricBNType(), score=score,
                      callback=recorder, seed=0, patience=HC_PATIENCE,
                      max_iters=HC_MAX_ITERS)

    recorder = StepRecorder()
    t0 = time.perf_counter()
    score = counting_validated_likelihood()(frame, 0.2, 10, 0)
    model = search(score, recorder)
    torch.cuda.synchronize()
    return model, score, recorder, time.perf_counter() - t0


def graph_of(model):
    return (sorted(model.arcs()),
            {n: model.node_type(n).ToString() for n in model.nodes()})


def op_key(op):
    from pybnesian_tpu_torch import interop

    state = interop.operator_state(op)
    return None if state is None else state[:3]


def delta_in(score, before, op):
    """``op``'s score delta from the model ``before``, by ``score``'s own
    local scores of the nodes it changes."""
    after = before.clone()
    op.apply(after)
    return sum(score.local_score(after, n) - score.local_score(before, n)
               for n in op.nodes_changed(after))


def compare_runs(run32, run64, phase="8 hc"):
    """Holds the float32 run against the float64 run: the same operators,
    or, where the two sequences first differ, two operators that float32
    may order either way (float64 deltas within :data:`TIE_ATOL` nats).
    Where one run stops and the other goes on, the two must still return
    the same graph. Returns the fields to print, with the first differing
    operators and their float64 deltas."""
    (model32, _, rec32, _), (model64, score64, rec64, _) = run32, run64
    same_graph = graph_of(model32) == graph_of(model64)
    fields = {"vs_f64": "same graph" if same_graph else "differs"}
    first = next((i for i, (a, b) in enumerate(itertools.zip_longest(
        map(op_key, rec32.operators), map(op_key, rec64.operators),
        fillvalue="stopped")) if a != b), None)
    fields["same_operators"] = first is None
    if first is None:
        if not same_graph:
            raise AssertionError("the same operators gave different graphs")
        return fields
    fields["first_differing_iteration"] = first
    op32, op64 = (rec.operators[first] if first < len(rec.operators) else None
                  for rec in (rec32, rec64))
    fields.update(op_f32=repr(op32 and op32.ToString()),
                  op_f64=repr(op64 and op64.ToString()))
    if op32 is None or op64 is None:
        if not same_graph:
            say(phase, **fields)
            raise AssertionError("one run stopped where the other went on, "
                                 "and their graphs differ")
        return fields
    before = rec64.models[first - 1]
    d32 = delta_in(score64, before, op32)
    d64 = delta_in(score64, before, op64)
    gap = abs(d32 - d64)
    fields.update(op_f32_delta_f64=f"{d32:.9g}", op_f64_delta_f64=f"{d64:.9g}",
                  tie_gap=f"{gap:.3e}", tie_rel=f"{gap / abs(d64):.3e}")
    if not gap <= TIE_ATOL:
        say(phase, **fields)
        raise AssertionError("the float32 and float64 runs chose different "
                             f"operators {gap} nats apart, more than a "
                             f"float32 tie ({TIE_ATOL} nats)")
    return fields


def reversals(recorder):
    """How many operators of a run undo an earlier one (an arc added and
    later removed, flipped back, a node type changed back)."""
    undo, count = set(), 0
    for i, op in enumerate(recorder.operators[1:-1], start=1):
        key = op_key(op)
        if key in undo:
            count += 1
        undo.add(op_key(op.opposite(recorder.models[i - 1])))
    return count


def cv_lik_search(torch, frame):
    """``hc`` with ``score="cv-lik"``: the CV channel alone, no validation
    guard, patience 0; whether float32 noise makes it undo its own steps
    or run to ``max_iters``."""
    from pybnesian_tpu_torch import SemiparametricBNType, hc

    recorder = StepRecorder()
    t0 = time.perf_counter()
    hc(frame, bn_type=SemiparametricBNType(), score="cv-lik", seed=0,
       callback=recorder, max_iters=HC_MAX_ITERS)
    torch.cuda.synchronize()
    return {"cv_lik_wall_s": f"{time.perf_counter() - t0:.4f}",
            "cv_lik_iterations": recorder.iterations,
            "cv_lik_reached_max_iters": recorder.iterations >= HC_MAX_ITERS,
            "cv_lik_reversals": reversals(recorder)}


def batch_sources(torch, engine, fams):
    """Where a CKDE family's float32 CV score can pick up its batch: the
    route's own whitened parts (the whitening kernel's outputs: the pairs
    kernel's inputs and the fold reduce's) of each of ``fams`` built inside
    one batch of all of them and built alone, and the pairs kernel's
    per-row outputs on each, compared bit for bit. The pairs kernel itself
    is held batch-independent in phases 2 and 5."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    K = len(engine.folds)
    args, kw = engine_whiten_inputs(torch, engine, fams)
    together = ckde_cv_whiten(*args, **kw)
    rows = ckde_cv_pairs(*together[:7])
    unequal_inputs, unequal_rows = set(), 0
    for f, fam in enumerate(fams):
        args, kw = engine_whiten_inputs(torch, engine, [fam])
        alone = ckde_cv_whiten(*args, **kw)
        part = slice(f * K, (f + 1) * K)
        mine = [t[part] for t in together[:7]] + [t[f:f + 1]
                                                   for t in together[7:]]
        unequal_inputs |= {n for n, t, a in zip(WHITEN_NAMES, mine, alone)
                           if not torch.equal(t, a)}
        unequal_rows += not torch.equal(rows[part], ckde_cv_pairs(*alone[:7]))
    return {"batch_source_families": len(fams),
            "whitened_inputs_not_bit_equal": repr(sorted(unequal_inputs)),
            "kernel_rows_not_bit_equal_families": unequal_rows}


def cross_batch(torch, score, score64, model):
    """The float32 CV scores of the cache pass's families — each node alone
    (linear-Gaussian and CKDE) and each one-parent family (linear-Gaussian,
    and CKDE as a CKDE node's update scores it) — in one batch, held against
    the float64 score's on the same folds, then scored each in a batch of
    its own: max abs and relative difference of the two float32 batchings,
    and of their CKDE and linear-Gaussian families apart; then
    :func:`batch_sources` on the one-parent CKDE families. A gate: every
    family's score, CKDE and linear-Gaussian, is the same bits alone and in
    the batch, and the CKDE families' whitened parts too."""
    from pybnesian_tpu_torch import CKDEType, LinearGaussianCPDType

    nodes = model.nodes()
    fams = []
    for nt in (LinearGaussianCPDType(), CKDEType()):
        fams += [(v, [], nt) for v in nodes]
        fams += [(t, [s], nt) for t in nodes for s in nodes if s != t]
    together = score.local_score_batch(model, fams)
    rel64 = check_scores(together, score64.local_score_batch(model, fams),
                         "cache-pass families vs float64")
    alone = np.array([score.local_score_batch(model, [f])[0] for f in fams])
    rel_alone = check_scores(alone, together, "cache-pass families alone")
    diff = np.abs(together - alone)
    rel = diff / np.abs(alone)
    ckde = np.array([f[2] == CKDEType() for f in fams])
    one_parent = [(v, ps) for v, ps, nt in fams if ps and nt == CKDEType()]
    sources = batch_sources(torch, score.cv_lik._engine, one_parent)
    ckde_gap = float(diff[ckde].max())
    lg_gap = float(diff[~ckde].max())
    if (ckde_gap != 0.0 or lg_gap != 0.0
            or sources["whitened_inputs_not_bit_equal"] != "[]"):
        raise AssertionError(
            f"a score moves with its batch: cross_batch_ckde_max_abs "
            f"{ckde_gap:.3e}, cross_batch_lg_max_abs {lg_gap:.3e}, "
            f"whitened_inputs_not_bit_equal "
            f"{sources['whitened_inputs_not_bit_equal']}")
    return {**sources,
            "cross_batch_families": len(fams),
            "cache_pass_max_rel_vs_f64": f"{rel64:.3e}",
            "cross_batch_max_abs": f"{diff.max():.3e}",
            "cross_batch_max_rel": f"{rel_alone:.3e}",
            "cross_batch_ckde_max_abs": f"{ckde_gap:.3e}",
            "cross_batch_ckde_max_rel": f"{rel[ckde].max():.3e}",
            "cross_batch_lg_max_abs": f"{diff[~ckde].max():.3e}",
            "cross_batch_lg_max_rel": f"{rel[~ckde].max():.3e}"}


def two_routes(score, score64, model, label):
    """The validation channel's two routes on ``model``'s nodes — the
    holdout batch (``vlocal_score_batch``, CKDE nodes through the pairs
    kernel) and a fitted factor per node (``vlocal_score``, CKDE nodes
    through the KDE kernel) — each held against the float64 score's, then
    against each other: max abs and relative difference. A gate: the
    validation cache that ``hc`` seeds (``cache_vlocal_scores``) holds
    every node's batch value, bit for bit, and ``vlocal_score`` where that
    is not finite, the route its updates take."""
    from pybnesian_tpu_torch.learning.operators import LocalScoreCache

    nodes = model.nodes()
    fams = [(n, model.parents(n)) for n in nodes]
    batch = score.vlocal_score_batch(model, fams)
    single = np.array([score.vlocal_score(model, n) for n in nodes])
    cache = LocalScoreCache()
    cache.cache_vlocal_scores(model, score)
    seeded = np.array([cache.local_score(model, n) for n in nodes])
    want = np.where(np.isfinite(batch), batch, single)
    if not np.array_equal(seeded, want):
        raise AssertionError(
            f"{label}: the validation cache differs from the hold-out "
            f"batch by {np.abs(seeded - want).max():.3e} nats")
    rel_batch = check_scores(batch, score64.vlocal_score_batch(model, fams),
                             f"{label} holdout batch vs float64")
    rel_single = check_scores(
        single, np.array([score64.vlocal_score(model, n) for n in nodes]),
        f"{label} fitted factors vs float64")
    rel = check_scores(batch, single, f"{label} two routes")
    return {f"{label}_batch_max_rel_vs_f64": f"{rel_batch:.3e}",
            f"{label}_factors_max_rel_vs_f64": f"{rel_single:.3e}",
            f"{label}_two_route_max_abs":
                f"{np.abs(batch - single).max():.3e}",
            f"{label}_two_route_max_rel": f"{rel:.3e}",
            f"{label}_cache_equals_the_batch": True}


def lg_batch_independence(torch, score, frame32, model):
    """The float32 ``batched_bic`` (``BIC.local_score_batch``) and the
    holdout channel's linear-Gaussian batch (``vlocal_score_batch``) of the
    cache pass's linear-Gaussian families — each node alone and each
    one-parent family — scored in one batch, then each in a batch of its
    own. A gate: every family's score is the same bits both ways."""
    from pybnesian_tpu_torch import BIC, LinearGaussianCPDType

    nodes = model.nodes()
    lg = LinearGaussianCPDType()
    fams = [(v, [], lg) for v in nodes]
    fams += [(t, [s], lg) for t in nodes for s in nodes if s != t]
    fields = {}
    for name, fn in (("bic", BIC(frame32).local_score_batch),
                     ("holdout_lg", score.vlocal_score_batch)):
        together = fn(model, fams)
        alone = np.array([fn(model, [f])[0] for f in fams])
        if not np.all(np.isfinite(together)):
            raise AssertionError(f"{name}: non-finite scores {together}")
        gap = float(np.abs(together - alone).max())
        if gap != 0.0:
            raise AssertionError(f"a float32 {name} score moves with its "
                                 f"batch: {gap:.3e}")
        fields[f"{name}_cross_batch_families"] = len(fams)
        fields[f"{name}_cross_batch_max_abs"] = f"{gap:.3e}"
    return fields


def lg_host_ms(torch, score, score64, model, runs=10):
    """Host ms of one LG CV call (``_KFoldEngine.lg_batch``, to its scores
    on the host) on the cache pass's linear-Gaussian families: the float32
    kernel route and the float64 plain route, medians of ``runs``."""
    nodes = model.nodes()
    fams = [(v, []) for v in nodes]
    fams += [(t, [s]) for t in nodes for s in nodes if s != t]
    out = {}
    for tag, sc in (("kernel_f32", score), ("plain_f64", score64)):
        engine = sc.cv_lik._engine
        pos = {c: i for i, c in enumerate(engine.df.continuous_columns())}
        batch = [(pos[v], [pos[p] for p in ps]) for v, ps in fams]
        engine.lg_batch(batch)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            engine.lg_batch(batch)
            times.append(time.perf_counter() - t0)
        out[f"lg_cv_host_ms_{tag}"] = f"{statistics.median(times) * 1e3:.4f}"
    out["lg_cv_host_ms_families"] = len(fams)
    return out


def hc_kde_inputs(torch, score, model):
    """(label, arguments) of the KDE kernel for the validation update of
    each CKDE node of ``model`` that has parents, built as ``CKDE.logl``
    builds them: the joint and the marginal KDE fitted on the holdout's
    training part and whitened, evaluated on its test part, as two
    programs (G 2), the marginal zero-padded to the joint's width."""
    from pybnesian_tpu_torch import CKDE, CKDEType

    train, test = score.training_data(), score.validation_data()
    cases = []
    for v in model.nodes():
        ps = model.parents(v)
        if not ps or model.node_type(v) != CKDEType():
            continue
        cpd = CKDE(v, ps)
        cpd.fit(train)
        joint, marg = cpd.kde_joint(), cpd.kde_marg()
        mat = np.nan_to_num(test.to_numpy([v, *ps], drop_null=False,
                                          dtype=np.float64), nan=0.0)
        jtr, mtr = joint.whitened_training(), marg.whitened_training()
        pad = jtr.shape[1] - mtr.shape[1]
        tr = torch.stack([jtr, torch.nn.functional.pad(mtr, (0, pad))]
                         ).contiguous()
        te = torch.stack([
            joint._to_device(joint._whiten(mat)),
            torch.nn.functional.pad(marg._to_device(marg._whiten(mat[:, 1:])),
                                    (0, pad)),
        ]).contiguous()
        valid = torch.ones(tr.shape[:2], dtype=torch.float32, device="cuda")
        lognorm = torch.tensor([float(joint._lognorm), float(marg._lognorm)],
                               dtype=torch.float32, device="cuda")
        cases.append((f"hc-update-{v}", [tr, valid, te, lognorm]))
    return cases


def hc_kernel_cases(torch, score, model, card):
    """The kernels against their plain versions at the shapes ``hc`` gives
    them, on inputs that the run's own score builds: the whitening, pairs
    and fold-reduce kernels on the CV channel's folds and on the holdout
    split, for every node alone (the cache pass's node-type families), for
    ``model``'s families, and for its widest family alone; the KDE kernel
    on each validation update of a CKDE node of ``model``; the LG kernel
    on both channels for those families and every one-parent family, and
    on degenerate inputs (:func:`lg_edge_inputs`). Returns each kernel's
    largest error, and the LG kernel's case timed at the CV channel's
    one-parent families (F 56, K 10, 8,000 rows)."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    nodes = model.nodes()
    learned = [(v, model.parents(v)) for v in nodes]
    batches = {"nodes": [(v, []) for v in nodes], "learned": learned,
               "widest": [max(learned, key=lambda f: len(f[1]))]}
    errs = dict.fromkeys(("ckde_cv_whiten", "ckde_cv_pairs",
                          "ckde_cv_fold_reduce"), 0.0)
    for channel, engine in (("cv", score.cv_lik._engine),
                            ("holdout", score.holdout_lik._engine)):
        for label, fams in batches.items():
            case = f"hc-{channel}-{label}"
            args, kw = engine_whiten_inputs(torch, engine, fams)
            parts = ckde_cv_whiten(*args, **kw)
            for name, err in (
                    ("ckde_cv_whiten", compare_whiten(
                        torch, args, case, phase="8 hc kernel", **kw)),
                    ("ckde_cv_pairs", compare_pairs(
                        torch, list(parts[:7]), case, phase="8 hc kernel")),
                    ("ckde_cv_fold_reduce", compare_reduce(
                        torch, reduce_inputs(torch, parts), case,
                        phase="8 hc kernel"))):
                errs[name] = max(errs[name], err["err"])
    cases = hc_kde_inputs(torch, score, model)
    if not cases:
        raise AssertionError("the learned model has no CKDE node with parents")
    errs["kde_logl"] = max(
        compare_kde(torch, args, label, phase="8 hc kernel")["err"]
        for label, args in cases)
    # the LG kernel on both channels: every node alone, the learned
    # families, the widest alone, every one-parent family (the cache
    # pass's, timed), and degenerate inputs cut from it
    one_parent = [(t, [s]) for t in nodes for s in nodes if s != t]
    lg_cases = []
    for label, fams in {**batches, "one-parent": one_parent}.items():
        lg_cases.append((f"hc-cv-{label}",
                         lg_inputs_cv(score.cv_lik._engine, fams)))
        lg_cases.append((f"hc-holdout-{label}",
                         lg_inputs_holdout(score.holdout_lik, fams)))
    timed_args = lg_inputs_cv(score.cv_lik._engine, one_parent)
    lg_cases.append(("hc-cv-degenerate", lg_edge_inputs(torch, timed_args)))
    errs["lg_cv_stats"] = max(
        compare_lg(torch, args, label)["err"] for label, args in lg_cases)
    timed = compare_lg(torch, timed_args, "hc-cv-one-parent-timed", card)
    return errs, timed


def split_cases(torch, score, model):
    """The cluster kernels at every cluster size S on the inputs that
    ``hc``'s score builds: the whitening and the fold reduce of
    ``model``'s families on the CV and holdout channels and the LG kernel
    on every one-parent family of both (the cache pass's), bit-equal to
    the planned launch and timed, and (whitening, LG) each family alone
    and in its batch; the builds' registers and spills of the whitening
    and LG kernels."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    say_ptxas("8 hc", "cv_whiten.cu", "whiten_kernel")
    say_ptxas("8 hc", "lg_cv.cu", "lg_kernel")
    nodes = model.nodes()
    learned = [(v, model.parents(v)) for v in nodes]
    for channel, engine in (("cv", score.cv_lik._engine),
                            ("holdout", score.holdout_lik._engine)):
        args, kw = engine_whiten_inputs(torch, engine, learned)
        whiten_split_sweep(torch, args, kw, f"hc-{channel}-learned", "8 hc")
        reduce_split_sweep(
            torch, reduce_inputs(torch, ckde_cv_whiten(*args, **kw)),
            f"hc-{channel}-learned", "8 hc")
        whiten_alone_in_batch(torch, engine, learned,
                              f"hc-{channel}-learned", "8 hc")
    one_parent = [(t, [s]) for t in nodes for s in nodes if s != t]
    for label, make in (
            ("hc-cv-one-parent",
             lambda fs: lg_inputs_cv(score.cv_lik._engine, fs)),
            ("hc-holdout-one-parent",
             lambda fs: lg_inputs_holdout(score.holdout_lik, fs))):
        lg_split_sweep(torch, make(one_parent), label, "8 hc")
        lg_alone_in_batch(torch, make, one_parent, label, "8 hc")


def bic_check(torch, frame32, frame64):
    """BIC, ``hc``'s default score on a GaussianNetwork (linear-Gaussian
    families, no kernel): its batched route on the card in float32 held
    against float64 on every family of up to one parent and each inner
    node's two neighbours; then that ``hc`` in float32 (no float64 graph to
    hold it to: BIC scores an arc and its reversal alike, so float32 breaks
    exact ties)."""
    from pybnesian_tpu_torch import BIC, GaussianNetwork, GaussianNetworkType, hc

    cols = frame32.column_names()
    fams = [(v, []) for v in cols]
    fams += [(t, [s]) for t in cols for s in cols if s != t]
    fams += [(cols[i], [cols[i - 1], cols[i + 1]])
             for i in range(1, len(cols) - 1)]
    model = GaussianNetwork(cols)
    bic = BIC(frame32)
    if bic.device.type != "cuda":
        raise AssertionError(f"BIC runs on {bic.device}, not cuda")
    rel = check_scores(bic.local_score_batch(model, fams),
                       BIC(frame64).local_score_batch(model, fams),
                       "BIC vs float64")
    recorder = StepRecorder()
    t0 = time.perf_counter()
    learned = hc(frame32, bn_type=GaussianNetworkType(), callback=recorder,
                 max_iters=HC_MAX_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dag_order(learned.nodes(), learned.arcs())
    if not recorder.iterations < HC_MAX_ITERS:
        raise AssertionError(f"BIC hc ran to max_iters ({HC_MAX_ITERS})")
    return {"bic_families": len(fams), "bic_max_rel_vs_f64": f"{rel:.3e}",
            "bic_hc_wall_s": f"{wall:.4f}",
            "bic_hc_iterations": recorder.iterations,
            "bic_hc_arcs": len(learned.arcs())}


def phase_hc(torch, card):
    """hc at config3b's size: a warm float32 run, the timed float32 run
    (launch counts from it alone), a float64 run of the same call; both
    kernels against their plain versions at the run's shapes; the float32
    scores against the float64 run's, with their cross-batch and two-route
    differences; BIC on the card. Returns the launches and each kernel's
    largest error here."""
    from pybnesian_tpu_torch import DataFrame
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs

    data = config3b_data(HC_ROWS, seed=2)
    frame32 = DataFrame.wrap(data)
    frame64 = DataFrame.wrap({k: v.astype(np.float64)
                              for k, v in data.items()})
    warm = learn(torch, frame32)
    reset_counts()
    run32 = learn(torch, frame32)
    launches = read_counts()
    model, score, recorder, wall = run32
    if graph_of(model) != graph_of(warm[0]):
        raise AssertionError("two float32 runs learned different graphs")
    if not recorder.iterations < HC_MAX_ITERS:
        raise AssertionError(f"hc ran to max_iters ({HC_MAX_ITERS})")
    scores = np.concatenate(score.scores)
    # the chain has no degenerate family, so no score may be -inf
    if not np.all(np.isfinite(scores)):
        raise AssertionError(f"{int((~np.isfinite(scores)).sum())} "
                             "non-finite scores in the float32 run")
    dag_order(model.nodes(), model.arcs())
    # every validation score comes from the holdout batch: no KDE kernel
    for name in ("ckde_cv_pairs", "ckde_cv_whiten", "ckde_cv_fold_reduce",
                 "lg_cv_stats"):
        if launches[name] == 0:
            raise AssertionError(f"hc did not launch {name}")
    t0 = time.perf_counter()
    run64 = learn(torch, frame64)
    wall64 = time.perf_counter() - t0
    compared = compare_runs(run32, run64)
    arcs, types = graph_of(model)
    say("8 hc", network="SemiparametricBN", rows=HC_ROWS,
        columns=len(data), patience=HC_PATIENCE, warm_s=f"{warm[3]:.4f}",
        wall_s=f"{wall:.4f}", iterations=recorder.iterations,
        families_scored=score.families,
        family_scores_per_s=f"{score.families / wall:.2f}",
        launches=launches,
        pairs_launches_per_iteration=(
            f"{launches['ckde_cv_pairs'] / recorder.iterations:.2f}"),
        f64_wall_s=f"{wall64:.4f}", f64_iterations=run64[2].iterations,
        **compared)
    say("8 hc", arcs=repr(arcs),
        ckde=repr(sorted(n for n, t in types.items() if t == "CKDEFactor")),
        lg=repr(sorted(n for n, t in types.items()
                       if t == "LinearGaussianFactor")))
    errs, lg_timed = hc_kernel_cases(torch, score, model, card)
    split_cases(torch, score, model)
    before = ckde_cv_pairs.launches
    start, score64 = recorder.models[0], run64[1]
    fields = cross_batch(torch, score, score64, start)
    fields.update(lg_batch_independence(torch, score, frame32, start))
    fields.update(two_routes(score, score64, start, "start"))
    fields.update(two_routes(score, score64, model, "learned"))
    if ckde_cv_pairs.launches == before:
        raise AssertionError("the cross-batch scores did not launch the "
                             "pairs kernel")
    fields.update(lg_host_ms(torch, score, score64, start))
    fields.update(cv_lik_search(torch, frame32))
    say("8 hc", **fields)
    say("8 hc", **bic_check(torch, frame32, frame64))
    return launches, errs, lg_timed


def frame_as(frame, dtype):
    """``frame``'s columns cast to ``dtype``, as a new DataFrame."""
    from pybnesian_tpu_torch import DataFrame

    return DataFrame.wrap({
        c: frame.to_numpy([c], drop_null=False, dtype=dtype)[:, 0]
        for c in frame.column_names()})


def pair_sums_ms(torch, frame, problems, rows, columns):
    """Milliseconds of one ``ucv_pair_sums_batch`` call alone (CUDA
    events, median) on a (problems, rows, columns) block of the frame's
    standardised leading columns, in the frame's dtype: what one objective
    evaluation of a search of that shape spends in the pair sums."""
    from pybnesian_tpu_torch.ops.kde import ucv_pair_sums_batch

    x = frame.to_numpy(frame.column_names()[:columns], drop_null=True)[:rows]
    w = torch.as_tensor((x - x.mean(0)) / x.std(0), device="cuda")
    w = w[None].expand(problems, -1, -1).contiguous()
    return cuda_median_ms(torch, lambda: ucv_pair_sums_batch(w))


def search_fields(torch, frame, searches, seconds):
    """The printed fields of the :class:`UCVSearch` records of searches
    over ``frame`` that took ``seconds`` together. ``pair_sums_share`` is
    the searches' evaluations times one pair-sum call's own time at their
    shape (:func:`pair_sums_ms`), over ``seconds``: the search itself runs
    untimed inside."""
    pair = sum(
        s.evaluations * pair_sums_ms(torch, frame, len(s.x), rows,
                                     columns) / 1e3
        for s, rows, columns in searches)
    iters = [int(i) for s, _r, _c in searches for i in s.iterations]
    return {"searches": len(searches),
            "problems": sum(len(s.x) for s, _r, _c in searches),
            "iterations_per_problem": repr(iters) if len(iters) <= 12 else
            f"min{min(iters)}/median{int(statistics.median(iters))}"
            f"/max{max(iters)}",
            "objective_evaluations": sum(s.evaluations
                                         for s, _r, _c in searches),
            "lane_evaluations": sum(int(s.lane_evaluations.sum())
                                    for s, _r, _c in searches),
            "search_s": f"{seconds:.4f}", "pair_sums_s": f"{pair:.4f}",
            "pair_sums_share": f"{pair / seconds:.4f}"}


def ucv_selector_check(torch, frame32, frame64):
    """(a): the two bandwidth selectors of 1, 2 and 3 columns, float32
    beside float64, each result scored in float64 against its start."""
    from pybnesian_tpu_torch import UCV, NormalReferenceRule
    from pybnesian_tpu_torch.kde.ucv import UCVScorer

    names = frame32.column_names()
    for d in (1, 2, 3):
        cols = names[:d]
        scorer = UCVScorer(frame64, cols)
        if scorer.device.type != "cuda":
            raise AssertionError(f"UCV runs on {scorer.device}, not cuda")
        nr = NormalReferenceRule()
        starts = {"full": scorer.score_unconstrained(
                      nr.bandwidth(frame64, cols)),
                  "diagonal": scorer.score_diagonal(
                      nr.diag_bandwidth(frame64, cols))}
        for kind in ("full", "diagonal"):
            found, fields = {}, {}
            for frame, dtype in ((frame32, "float32"), (frame64, "float64")):
                selector = UCV()
                t0 = time.perf_counter()
                h = (selector.bandwidth(frame, cols) if kind == "full"
                     else selector.diag_bandwidth(frame, cols))
                wall = time.perf_counter() - t0
                search = selector.last_search
                if search.dtype != dtype:
                    raise AssertionError(f"a {dtype} frame searched in "
                                         f"{search.dtype}")
                score = (scorer.score_unconstrained(h) if kind == "full"
                         else scorer.score_diagonal(h))
                slack = UCV_WORSE_RTOL[dtype] * abs(starts[kind])
                if not (np.all(np.isfinite(h))
                        and score <= starts[kind] + slack):
                    raise AssertionError(
                        f"UCV {kind} d={d} {dtype}: score {score} at the "
                        f"result, {starts[kind]} at the start")
                found[dtype] = h
                tag = dtype[-2:]
                shown = search_fields(
                    torch, frame, [(search, frame.num_rows, d)], wall)
                fields.update({
                    f"score_f{tag}": f"{score:.9g}",
                    f"iterations_f{tag}": int(search.iterations[0]),
                    f"evaluations_f{tag}": search.evaluations,
                    f"wall_s_f{tag}": f"{wall:.4f}",
                    f"pair_sums_share_f{tag}": shown["pair_sums_share"]})
            rel = float(np.max(np.abs(found["float32"] - found["float64"]))
                        / np.max(np.abs(found["float64"])))
            say("9 ucv", selector=kind, columns=d, rows=frame32.num_rows,
                score_start=f"{starts[kind]:.9g}",
                f32_vs_f64_max_rel=f"{rel:.3e}", **fields)


def ucv_whiten_inputs(torch, engine, fams, h_maps):
    """The whitening kernel's arguments and keywords for (variable,
    parents) families scored with the per-fold bandwidths ``h_maps``,
    built by the score's own fold engine and the scoring path's own
    helpers."""
    from pybnesian_tpu_torch.learning.scores.likelihood import (
        _family_bandwidths)

    pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask = (
        engine._device_cv_cache()
    )
    col_idx, col_mask, H = _family_bandwidths(fams, h_maps, pos)
    return [data, null_mask, torch.as_tensor(col_idx, device="cuda"),
            torch.as_tensor(col_mask, dtype=torch.float32, device="cuda"),
            tr_idx, tr_mask, te_idx, te_mask], {
        "rule": None,
        "bandwidths": torch.as_tensor(H, dtype=torch.float32,
                                      device="cuda")}


def vech_width(nv):
    """d of a vech vector of d (d + 1) / 2 entries."""
    return (math.isqrt(8 * nv + 1) - 1) // 2


def add_counts(*counts):
    return {name: sum(c[name] for c in counts) for name in counts[0]}


class UcvRecording:
    """While active, every launch of the UCV kernel through ``ops/kde.py``
    (``ucv_pair_sums_batch``) is counted and, per shape, the arguments of
    the first launch, of the last and of the smallest bandwidth (the launch
    whose smallest :func:`ucv_bandwidth_factor` over its problems is the
    least, chosen on the card with no host read) copied, with each launch's
    smallest factor: work on every launch, so a timed run goes without
    it."""

    def __enter__(self):
        import torch

        from pybnesian_tpu_torch.ops import kde as kde_ops

        self._ops, self._wrapper = kde_ops, kde_ops.ucv_pair_sums_cuda
        self.launches, self.first, self.last = 0, {}, {}
        self.smallest, self.factors = {}, []

        def recording(white, valid=None):
            shape = (tuple(white.shape), valid is not None)
            self.launches += 1
            args = (white.clone(), None if valid is None else valid.clone())
            if shape not in self.first:
                self.first[shape] = args
            factor = ucv_bandwidth_factor(white, valid).min()
            self.factors.append(factor)
            if shape not in self.smallest:
                self.smallest[shape] = (factor, *args)
            else:
                least, w, v = self.smallest[shape]
                take = factor < least
                self.smallest[shape] = (
                    torch.where(take, factor, least),
                    torch.where(take, args[0], w),
                    None if v is None else torch.where(take, args[1], v))
            self.last[shape] = args
            return self._wrapper(white, valid)

        kde_ops.ucv_pair_sums_cuda = recording
        return self

    def __exit__(self, *exc):
        self._ops.ucv_pair_sums_cuda = self._wrapper

    def factor_range(self):
        """(smallest, largest) over the launches of each launch's smallest
        bandwidth factor."""
        import torch

        least = torch.stack(self.factors).double().cpu()
        return float(least.min()), float(least.max())


def ucv_bandwidth_factor(white, valid=None):
    """Per problem of a UCV launch's whitened rows (B, N, d), the bandwidth
    as a factor of the normal-reference one ((4 / (n (d +
    2)))^(2 / (d + 4)) times the covariance): 1 / sqrt(rule · s²), with s²
    the valid rows' mean squared distance from their mean per column,
    which is 1 / (rule · f²) for the bandwidth f² · rule · Σ. A card
    tensor (B,), read by nobody until the caller wants it."""
    import torch

    w = white.double()
    keep = (torch.ones(white.shape[:2], dtype=torch.float64,
                       device=white.device) if valid is None
            else (valid > 0).double())
    n = keep.sum(1).clamp_min(1.0)
    mean = (w * keep[..., None]).sum(1) / n[:, None]
    d = white.shape[2]
    s2 = (((w - mean[:, None]) ** 2).sum(-1) * keep).sum(1) / (n * d)
    rule = (4.0 / (n * (d + 2))) ** (2.0 / (d + 4))
    return 1.0 / torch.sqrt(rule * s2)


def ucv_work(white, valid):
    """(exps, FP32 ops, bytes) of one ucv_pair_sums call: one exp per valid
    pair i < j; per pair, by the form that runs (an FMA counted 2), up to
    16 columns the dot form's add and d FMAs for the exponent, wider the
    difference form's subtraction and FMA per column, then an add and an
    FMA for the two sums (2 d + 4 operations, or 3 d + 3); the rows (and
    the mask) read once, two sums a problem written."""
    B, N, d = white.shape
    n = (np.full(B, float(N)) if valid is None
         else (valid > 0).sum(1).double().cpu().numpy())
    pairs = float((n * (n - 1) / 2).sum())
    nbytes = 4 * B * N * d + (0 if valid is None else 4 * B * N) + 8 * B
    per_pair = 2 * d + 4 if d <= UCV_DOT_D else 3 * d + 3
    return pairs, pairs * per_pair, nbytes


def ucv_rel_err(got, want):
    """Max relative difference per sum (NaN where one side is NaN and the
    other is not), and the max absolute difference."""
    rel, err = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.double().cpu(), w.double().cpu()
        nan = g.isnan() | w.isnan()
        if not bool((g.isnan() == w.isnan()).all()):
            return math.nan, math.nan
        diff = (g - w)[~nan].abs()
        if len(diff):
            rel = max(rel, float((diff / w[~nan].abs().clamp_min(1e-30))
                                 .max()))
            err = max(err, float(diff.max()))
    return rel, err


def library_ucv(torch, white):
    """The UCV sums of every-row-valid ``white`` by two efficient-attention
    calls (scales 1/2 and 1 for the 2H and H terms; each row's sum over
    all j less its own term 1, halved): ms of the two calls, and the
    results' max relative error against the plain version."""
    from pybnesian_tpu_torch.ops.ucv_kernel import ucv_pair_sums_reference

    keep = torch.ones(white.shape[:2], dtype=torch.bool, device=white.device)
    q, k = padded_lse_operands(torch, white, white, keep)

    def calls():
        return (efficient_attention_lse(torch, q, k, scale=0.5),
                efficient_attention_lse(torch, q, k, scale=1.0))

    half = 0.5 * (white * white).sum(-1).double()
    n = white.shape[1]
    got = [((torch.exp(lse.double() - s * half).sum(1) - n) / 2)
           for lse, s in zip(calls(), (0.5, 1.0))]
    rel, _err = ucv_rel_err(got, ucv_pair_sums_reference(white))
    return cuda_median_ms(torch, calls), rel


def ucv_kernel_check(torch, card, visits):
    """The UCV kernel against its plain version on the inputs that the
    float32 searches gave it when they ran as the plain host loop on the
    card (``visits``, that run's :class:`UcvRecording`; the
    search kernel sums its pairs with this kernel's tile body and order),
    per shape: the first launch, the last and the one of the smallest
    bandwidth, with the range of bandwidths the launches visited printed
    beside the range that ``tools/ucv_dot_form_error.py`` emulates; and on
    edge cases
    cut from the widest of them: an all-invalid problem, one with exactly
    two invalid rows, N odd and not a multiple of the tile, N below one
    tile, d 1, 16, 17 and 20, a NaN row;
    one problem's sums bit-equal alone, inside a 30-problem batch, padded
    with invalid rows, and run again; the kernel timed at the widest
    search shape with its bound, plain version and library yardstick."""
    from pybnesian_tpu_torch.ops.ucv_kernel import (
        ucv_pair_sums_cuda, ucv_pair_sums_reference)

    def hold(white, valid, label):
        got = ucv_pair_sums_cuda(white, valid)
        want = ucv_pair_sums_reference(white, valid)
        torch.cuda.synchronize()
        rel, err = ucv_rel_err(got, want)
        if not rel <= UCV_RTOL:
            raise AssertionError(f"ucv {label}: relative diff {rel} > "
                                 f"{UCV_RTOL} (kernel {got}, plain {want})")
        say("9 ucv kernel", case=label, B_N_d="x".join(map(str, white.shape)),
            masked=valid is not None, max_rel_err=f"{rel:.3e}",
            max_abs_err=f"{err:.3e}")
        errs.append(err)
        return got

    if not visits.first:
        raise AssertionError("the UCV searches recorded no kernel launch")
    errs = []
    for shape, (w, v) in visits.first.items():
        d = w.shape[2]
        hold(w, v, f"search-inputs-{d}d")
        hold(*visits.last[shape], f"search-last-{d}d")
        least, *wv = visits.smallest[shape]
        hold(*wv, f"search-smallest-bandwidth-{d}d-factor-"
             f"{float(least):.4f}")
    low, high = visits.factor_range()
    say("9 ucv kernel", launches_plain_searches=visits.launches,
        bandwidth_factors_visited=f"{low:.4f}..{high:.4f}",
        bandwidth_factors_emulated=f"{min(UCV_FACTORS_CHECKED)}.."
                                   f"{max(UCV_FACTORS_CHECKED)}",
        visited_within_emulated=(low >= min(UCV_FACTORS_CHECKED)
                                 and high <= max(UCV_FACTORS_CHECKED)))
    white, _ = max(visits.first.values(), key=lambda wv: wv[0].shape[2])
    B, N, d = white.shape
    three = white[:3].contiguous()
    valid = torch.ones((3, N), dtype=torch.float32, device="cuda")
    valid[0] = 0.0                       # all invalid
    valid[1, [7, N // 2]] = 0.0          # exactly two invalid rows
    got = hold(three, valid, "invalid-rows")
    if not (float(got[0][0]) == 0.0 and float(got[1][0]) == 0.0):
        raise AssertionError(f"ucv all-invalid problem gave {got}")
    odd = 4097                           # odd, not a multiple of 256
    hold(white[:2, :odd].contiguous(), None, f"N{odd}")
    hold(white[:2, :, :1].contiguous(), None, "d1")
    hold(white[:2, :100].contiguous(), None, "N100")  # below one tile
    rng = np.random.default_rng(9)
    for width, scale in ((16, 1.0), (17, 1.0), (20, 0.3)):
        wide = torch.as_tensor(rng.normal(0, scale, (2, 3001, width)),
                               device="cuda", dtype=torch.float32)
        hold(wide, None, f"d{width}")
    nan = white[:2, :1001].clone()
    nan[1, 500, 0] = math.nan            # a NaN row: problem 1 NaN
    got = hold(nan, None, "nan-row")
    if not (all(bool(s[1].isnan()) for s in got)
            and all(bool(s[0].isfinite()) for s in got)):
        raise AssertionError(f"ucv NaN row gave {got}")

    # one problem alone, inside 30, padded with invalid rows, run twice
    batch = torch.cat([white, 0.5 * white, 2.0 * white])[:30].contiguous()
    alone = ucv_pair_sums_cuda(white[:1].contiguous())
    inside = ucv_pair_sums_cuda(batch)
    again = ucv_pair_sums_cuda(batch)
    pad = torch.cat([white[:1], torch.zeros((1, 1000, d), device="cuda")], 1)
    pad_valid = torch.ones(pad.shape[:2], device="cuda")
    pad_valid[:, N:] = 0.0
    padded = ucv_pair_sums_cuda(pad.contiguous(), pad_valid)
    torch.cuda.synchronize()
    same = all(torch.equal(alone[i], inside[i][:1])
               and torch.equal(inside[i], again[i])
               and torch.equal(alone[i], padded[i]) for i in range(2))
    if not same:
        raise AssertionError("ucv: problem 0 alone, inside 30, padded and "
                             "run again is not bit-equal")
    say("9 ucv kernel", case="problem 0", batch=len(batch),
        bit_equal_alone_in_batch_padded_and_rerun=True)

    result = {"err": max(errs),
              **time_kernel(torch, lambda: ucv_pair_sums_cuda(white)),
              "plain_ms": cuda_median_ms(
                  torch, lambda: ucv_pair_sums_reference(white)),
              "work": ucv_work(white, None), "plan": None}
    result["library_ms"], library_rel = library_ucv(torch, white)
    bound_ms, by = bound(card, *result["work"])
    say("9 ucv kernel", case=f"search-inputs-{d}d",
        B_N_d="x".join(map(str, white.shape)),
        kernel_ms=f"{result['ms']:.4f}",
        kernel_batched_ms=f"{result['batched_ms']:.4f}",
        plain_ms=f"{result['plain_ms']:.4f}",
        library="2 calls of _scaled_dot_product_efficient_attention",
        library_ms=f"{result['library_ms']:.4f}",
        library_max_rel_err=f"{library_rel:.3e}",
        bound_ms=f"{bound_ms:.4f}", bound_by=by,
        bound_share=f"{bound_ms / result['ms']:.4f}",
        batched_bound_share=f"{bound_ms / result['batched_ms']:.4f}")
    return result


class SearchRecording:
    """While active, every UCV search that ``kde/ucv.py`` sends to the
    search kernel (``ucv_search_cuda``) runs with CUDA's sync debug mode at
    "error", so that a device read inside it raises; each call's arguments
    are copied and its device time taken by CUDA events (read after the
    run, with no host wait inside it)."""

    def __enter__(self):
        import torch

        from pybnesian_tpu_torch.kde import ucv as ucv_module

        self._module, self._wrapper = ucv_module, ucv_module.ucv_search_cuda
        self.calls, self.events = [], []

        def recording(X, valid, Ns, x0s, d, diagonal, max_iter):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                out = self._wrapper(X, valid, Ns, x0s, d, diagonal, max_iter)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            self.calls.append((X.clone(), None if valid is None
                               else valid.clone(), Ns.clone(), x0s.clone(),
                               d, diagonal, max_iter))
            self.events.append((start, end))
            return out

        ucv_module.ucv_search_cuda = recording
        return self

    def __exit__(self, *exc):
        self._module.ucv_search_cuda = self._wrapper

    def device_ms(self):
        return [start.elapsed_time(end) for start, end in self.events]


class PlainSearches:
    """While active, a float32 UCV search on the card takes the plain host
    loop (``ucv_search_reference``, whose evaluations launch the pair-sums
    kernel), the route of the searches before the search kernel."""

    def __enter__(self):
        from pybnesian_tpu_torch.kde import ucv as ucv_module
        from pybnesian_tpu_torch.ops.ucv_search_kernel import (
            ucv_search_reference)

        self._module, self._wrapper = ucv_module, ucv_module.ucv_search_cuda
        ucv_module.ucv_search_cuda = ucv_search_reference
        return self

    def __exit__(self, *exc):
        self._module.ucv_search_cuda = self._wrapper


def search_work(X, valid, nv, evaluations):
    """(exps, FP32 ops, bytes) a UCV search of these problems needs at
    least, given ``evaluations`` (B,): per problem that many ``ucv_work``
    pair-sum evaluations of its valid rows; the rows read once, the results
    written once. With each problem's nv + 1 starting vertices and one
    evaluation an iteration (the reflection alone) it is the bound kept
    from the first version; with each problem's ``lane_evaluations`` the
    evaluations its own search needed (the second points and shrinks
    too)."""
    B, N, d = X.shape
    n = (np.full(B, float(N)) if valid is None
         else (valid > 0).sum(1).double().cpu().numpy())
    evals = evaluations.double().cpu().numpy()
    pairs = float((evals * n * (n - 1) / 2).sum())
    per_pair = 2 * d + 4 if d <= UCV_DOT_D else 3 * d + 3
    nbytes = (4 * B * N * d + (0 if valid is None else 4 * B * N)
              + 4 * B * (nv + 3))
    return pairs, pairs * per_pair, nbytes


def ucv_search_check(torch, card, calls, device_ms, stamped):
    """The search kernel (``ucv_search``) against its plain version, the
    host loop, on the problems of the float32 searches of (b) (one call per
    family width, copied by :class:`SearchRecording`): (1) its objective at
    the start, at 0.8 and 1.25 times it and at its own optimum within
    :data:`UCV_RTOL` of the plain objective, and its pair sums on its own
    whitened rows the same bits as the pair-sums kernel's; (2) x, f and
    iterations at :data:`UCV_SEARCH_STEPS` against the plain loop's; (3)
    the whole search per problem no worse than the plain search's best
    plus its ``fatol``, nor than its start, and the same bits as the plain
    search's (x, f, start, iterations, evaluations and lane evaluations),
    with both searches' times; (5) problems 0 and B - 1 alone the same
    bits as in the batch, and a second run the same bits; each
    instantiation's registers and spills from the build. Then the widest
    search timed with its bounds and the schedule's efficiency (its lane
    evaluations times the pair kernel's ms per problem at full load, over
    its ms), and each search's block-time split from ``stamped`` (the
    instrumented build), outside the timed windows. Returns the
    kernels-line result at the widest search, with its error the largest
    of (1) and its bound that of the lane evaluations."""
    from pybnesian_tpu_torch.ops.ucv_kernel import ucv_pair_sums_cuda
    from pybnesian_tpu_torch.ops.ucv_search_kernel import (
        ucv_objective_reference, ucv_search_cuda, ucv_search_evaluate,
        ucv_search_reference)

    say_ptxas("9 ucv search kernel", "ucv_pairs.cu", "ucv_search_kernel")
    errs = []
    for (X, valid, Ns, x0, d, diagonal, max_iter), dev_ms in zip(calls,
                                                                  device_ms):
        B, N, _ = X.shape
        shape = f"{B}x{N}x{d}"
        got = ucv_search_cuda(X, valid, Ns, x0, d, diagonal, max_iter)
        points = torch.stack([x0, 0.8 * x0, 1.25 * x0, got.x], 1)
        f, sums, white = ucv_search_evaluate(
            X, valid, Ns, x0, points.contiguous(), d, diagonal, white=True)
        want = ucv_objective_reference(X, valid, Ns, x0, points, d, diagonal)
        rel = max_rel(f, want)
        hold_rel(rel, UCV_RTOL, f"ucv_search {shape}: objective")
        errs.append(float((f - want).abs().max()))
        for p in range(points.shape[1]):
            s2h, sh = ucv_pair_sums_cuda(white[:, p].contiguous(), valid)
            if not (torch.equal(s2h, sums[:, p, 0])
                    and torch.equal(sh, sums[:, p, 1])):
                raise AssertionError(f"ucv_search {shape}: its pair sums on "
                                     "its own whitened rows differ from "
                                     "the pair-sums kernel's")
        steps = {}
        for max_steps in UCV_SEARCH_STEPS:
            k = ucv_search_cuda(X, valid, Ns, x0, d, diagonal, max_steps)
            p = ucv_search_reference(X, valid, Ns, x0, d, diagonal,
                                     max_steps)
            rx, rf = max_rel(k.x, p.x), max_rel(k.f, p.f)
            hold_rel(max(rx, rf), UCV_RTOL,
                     f"ucv_search {shape} max_iter {max_steps}: x and f")
            if not torch.equal(k.iterations, p.iterations):
                raise AssertionError(f"ucv_search {shape} max_iter "
                                     f"{max_steps}: iterations "
                                     f"{k.iterations.tolist()} against "
                                     f"{p.iterations.tolist()}")
            steps[max_steps] = f"{max(rx, rf):.2e}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ucv_search_reference(X, valid, Ns, x0, d, diagonal,
                                     max_iter)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        fatol = 1e-4 * plain.start.abs() + 1e-12
        if not bool((got.f <= plain.f + fatol).all()
                    and (got.f <= got.start).all()):
            raise AssertionError(f"ucv_search {shape}: f best {got.f} "
                                 f"against the plain search's {plain.f} "
                                 f"and the start {got.start}")
        for name, g, w in zip(got._fields, got, plain):
            if not same_bits(torch, g, w):
                raise AssertionError(f"ucv_search {shape}: {name} "
                                     f"{g.tolist()} against the plain "
                                     f"loop's {w.tolist()}")
        again = ucv_search_cuda(X, valid, Ns, x0, d, diagonal, max_iter)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        for b in (0, B - 1):
            n = int(Ns[b])
            one = ucv_search_cuda(
                X[b:b + 1, :n].contiguous(), None, Ns[b:b + 1].contiguous(),
                x0[b:b + 1].contiguous(), d, diagonal, max_iter)
            same &= (torch.equal(one.x[0], got.x[b])
                     and torch.equal(one.f[0], got.f[b])
                     and int(one.iterations[0]) == int(got.iterations[b]))
        if not same:
            raise AssertionError(f"ucv_search {shape}: a problem alone, in "
                                 "its batch and run again is not the same "
                                 "bits")
        say("9 ucv search kernel", case=f"search-inputs-{d}d", B_N_d=shape,
            objective_max_rel_err=f"{rel:.3e}",
            sums_bit_equal_to_pair_kernel=True,
            first_steps_max_rel=repr(steps),
            iterations_kernel=repr(got.iterations.tolist()),
            iterations_plain=repr(plain.iterations.tolist()),
            evaluations_kernel=int(got.evaluations),
            evaluations_plain=int(plain.evaluations),
            lane_evaluations_kernel=repr(got.lane_evaluations.tolist()),
            lane_evaluations_plain=repr(plain.lane_evaluations.tolist()),
            same_bits_as_plain_loop=True,
            f_best_max_rel_vs_plain=f"{max_rel(got.f, plain.f):.3e}",
            no_worse_than_plain_plus_fatol=True,
            bit_equal_alone_in_batch_and_rerun=True,
            device_ms=f"{dev_ms:.3f}", plain_s=f"{plain_s:.4f}")

    X, valid, Ns, x0, d, diagonal, max_iter = max(calls,
                                                  key=lambda c: c[4])

    def search():
        return ucv_search_cuda(X, valid, Ns, x0, d, diagonal, max_iter)

    got = search()
    result = {"err": max(errs),
              "ms": cuda_median_ms(torch, search, runs=UCV_SEARCH_RUNS),
              "batched_ms": cuda_median_ms(torch, search, runs=2, batch=3),
              "plain_ms": cuda_median_ms(
                  torch, lambda: ucv_search_reference(
                      X, valid, Ns, x0, d, diagonal, max_iter), runs=3),
              "work": search_work(X, valid, x0.shape[1],
                                  got.lane_evaluations),
              "library_ms": None}
    bound_ms, by = bound(card, *result["work"])
    first_ms = bound(card, *search_work(
        X, valid, x0.shape[1], x0.shape[1] + 1 + got.iterations))[0]
    one_eval = bound(card, *ucv_work(X, valid))[0]
    # the pair kernel at full load: the rows the search whitens at its
    # start, its B problems ten times over in one launch (many waves), timed
    # in windows of KERNEL_BATCH launches
    white = ucv_search_evaluate(X, valid, Ns, x0, x0[:, None].contiguous(),
                                d, diagonal, white=True)[2][:, 0]
    white = white.repeat(10, 1, 1).contiguous()
    valid10 = None if valid is None else valid.repeat(10, 1).contiguous()
    per_lane_ms = cuda_median_ms(
        torch, lambda: ucv_pair_sums_cuda(white, valid10),
        batch=KERNEL_BATCH) / white.shape[0]
    lane_evals = int(got.lane_evaluations.sum())
    efficiency = lane_evals * per_lane_ms / result["ms"]
    say("9 ucv search kernel", case=f"search-inputs-{d}d",
        B_N_d="x".join(map(str, X.shape)),
        kernel_ms=f"{result['ms']:.4f}",
        kernel_batched_ms=f"{result['batched_ms']:.4f}",
        plain_ms=f"{result['plain_ms']:.4f}",
        plain_over_kernel=f"{result['plain_ms'] / result['ms']:.2f}",
        iterations_max=int(got.iterations.max()),
        ms_per_iteration=f"{result['ms'] / int(got.iterations.max()):.4f}",
        lane_evaluations=lane_evals,
        bound_ms=f"{bound_ms:.4f}", bound_by=by,
        bound_share=f"{bound_ms / result['ms']:.4f}",
        one_per_lane_iteration_bound_ms=f"{first_ms:.4f}",
        one_per_lane_iteration_bound_share=f"{first_ms / result['ms']:.4f}",
        batch_evaluations_times_one_bound_ms=(
            f"{int(got.evaluations) * one_eval:.4f}"),
        pair_kernel_ms_per_lane_evaluation=f"{per_lane_ms:.5f}",
        schedule_efficiency=f"{efficiency:.4f}",
        library="none computes it")
    sweeps = kernel_sweeps()
    with sweeps.StampedSearches(torch, stamped) as stamps:
        for X, valid, Ns, x0, d, diagonal, max_iter in calls:
            for fields in sweeps.search_split_of(
                    stamps, lambda: ucv_search_cuda(
                        X, valid, Ns, x0, d, diagonal, max_iter),
                    "x".join(map(str, X.shape)),
                    2 if d <= UCV_DOT_D else 4):
                say("9 ucv search stamps", **fields)
    return result


def starts_work(G, ntr, d):
    """(exps, FP32 ops, bytes, FP64 ops) of one ucv_starts call of G
    problems of d columns over ntr train rows a fold, as csrc/cv_whiten.cu
    states its bound: per problem and train row its d cells, d null cells,
    mask and index read (8d + 12 bytes) and its d floats and mask written
    (4(d + 1)); 2d + 2 float64 operations for the mean and 2d + d(d + 1)
    for the covariance."""
    rows = float(G) * ntr
    return (0.0, 0.0, rows * (8 * d + 12 + 4 * (d + 1)),
            rows * (4 * d + 2 + d * (d + 1)))


def ucv_starts_check(torch, card, engine, fams, label):
    """The UCV starts kernel (``ucv_starts``) against its plain version on
    the CV engine's own device tensors, one call per family width of
    ``fams`` as the score makes it: the float64 starts within
    :data:`STARTS_RTOL`, NaN in the same places, the rows, mask, counts and
    ``ok`` exactly; timed beside the plain version (torch on the card) and
    the bound when ``card`` is given. Returns each width's result, keyed by
    the width."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        ucv_starts, ucv_starts_reference)

    pos, data, null_mask, tr_idx, tr_mask, _te, _tm = (
        engine._device_cv_cache())
    K, ntr = tr_idx.shape
    by_d = {}
    for v, ps in fams:
        by_d.setdefault(len(ps) + 1, []).append((v, ps))
    results = {}
    for d, fs in sorted(by_d.items()):
        cols = torch.tensor([[pos[c] for c in (v, *ps)] for v, ps in fs],
                            dtype=torch.int64, device=data.device)
        args = (data, null_mask, cols, tr_idx, tr_mask)
        got = ucv_starts(*args)
        want = ucv_starts_reference(*args)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, w in zip(("X", "valid", "Ns", "starts", "ok"), got,
                              want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(
                    f"{label} d {d} {name}: {g.dtype} {tuple(g.shape)} "
                    f"against {w.dtype} {tuple(w.shape)}")
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                raise AssertionError(f"{label} d {d} {name}: NaN in other "
                                     "places")
            if name == "starts":
                try:
                    torch.testing.assert_close(g, w, rtol=STARTS_RTOL,
                                               atol=1e-15, equal_nan=True)
                except AssertionError as e:
                    raise AssertionError(f"{label} d {d} starts: {e}") from None
                diff = (g - w).abs()
                diff = diff[torch.isfinite(diff)]
                if diff.numel():
                    err = max(err, float(diff.max()))
            elif not torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)):
                raise AssertionError(f"{label} d {d} {name}: not the plain "
                                     "version's bits")
        fields = {"case": label, "F_K_ntr_d": f"{len(fs)}x{K}x{ntr}x{d}",
                  "starts_max_abs_err": f"{err:.3e}",
                  "problems_ok": f"{int(got[4].sum())}/{len(fs) * K}"}
        result = {"err": err}
        if card is not None:
            result.update(
                time_kernel(torch, lambda: ucv_starts(*args)),
                plain_ms=cuda_median_ms(
                    torch, lambda: ucv_starts_reference(*args)),
                work=starts_work(len(fs) * K, ntr, d))
            fields.update(timing_fields(card, result))
        say("9 ucv kernel", kernel="ucv_starts", **fields)
        results[d] = result
    return results


def phase_ucv(torch, frame32, frame64, k, card, stamped):
    """UCV and custom bandwidth selectors on the card. Returns the
    launches of its path — the entry points of (b) in float32, (c), (d)
    and (e), each driven with the counts at 0 and read just after — the
    whitening, pairs and fold-reduce kernels' errors on the UCV-scored
    inputs (the given-bandwidths route), and the checked and timed cases
    of the UCV pair-sums kernel (:func:`ucv_kernel_check`) and of the
    search kernel (:func:`ucv_search_check`, whose block-time split runs on
    ``stamped``, the instrumented build)."""
    from pybnesian_tpu_torch import (
        KDE, UCV, Arguments, BandwidthSelector, CKDEType, CVLikelihood,
        DataFrame, KDENetwork, Kwargs)

    ucv_selector_check(torch, frame32, frame64)

    # (b) one family of each width, every node's CKDE selecting with UCV
    names = frame32.column_names()
    fams = [(names[0], []), (names[1], [names[0]]),
            (names[2], [names[0], names[1]])]
    typed = [(v, ps, CKDEType()) for v, ps in fams]
    model = KDENetwork(names)
    frames = {"f32": frame32, "f64": frame64}
    scores = {tag: CVLikelihood(frame, k=k, seed=0,
                                construction_args=Arguments(
                  {CKDEType(): Kwargs(bandwidth_selector=UCV())}))
              for tag, frame in frames.items()}
    own, walls, counted = {}, {}, {}
    for tag, score in scores.items():
        with SearchRecording() as rec:
            reset_counts()
            t0 = time.perf_counter()
            own[tag] = score.local_score_batch(model, typed)
            walls[tag] = time.perf_counter() - t0
            counted[tag] = read_counts()
        if tag == "f32":
            searched = rec
    launches_b = counted["f32"]
    for name in ("ckde_cv_pairs", "ucv_search", "ckde_cv_whiten",
                 "ckde_cv_fold_reduce", "ucv_starts"):
        if launches_b[name] == 0:
            raise AssertionError(f"the UCV-selected families did not launch "
                                 f"{name}")
    # one launch of the search kernel per family width, each run with the
    # sync debug mode at "error" (SearchRecording): no device read inside;
    # and one of the starts kernel per width, which formed its inputs
    widths = len({len(ps) for _v, ps in fams})
    if not launches_b["ucv_search"] == len(searched.calls) == widths:
        raise AssertionError(f"ucv_search launched {launches_b['ucv_search']}"
                             f" times ({len(searched.calls)} recorded) for "
                             f"{widths} family widths")
    if launches_b["ucv_starts"] != widths:
        raise AssertionError(f"ucv_starts launched {launches_b['ucv_starts']}"
                             f" times for {widths} family widths")
    if launches_b["ucv_pair_sums"] != 0:
        raise AssertionError("the float32 searches launched the pair-sums "
                             "kernel outside the search kernel")
    if (counted["f64"]["ucv_search"] or counted["f64"]["ucv_pair_sums"]
            or counted["f64"]["ucv_starts"]):
        raise AssertionError("the float64 searches launched a UCV kernel")
    say("9 ucv", path="CVLikelihood+UCV", searches_f32=len(searched.calls),
        ucv_search_launches=launches_b["ucv_search"],
        device_reads_inside_a_search=0,
        search_device_ms=repr([round(ms, 3)
                               for ms in searched.device_ms()]))
    if not all(np.all(np.isfinite(v)) for v in own.values()):
        raise AssertionError(f"non-finite UCV scores {own}")
    # reported, not held to a tolerance: the two searches stop at
    # different bandwidths
    rel_own = float(np.max(np.abs(own["f32"] - own["f64"])
                           / np.abs(own["f64"])))

    # The entry point's two halves run again apart, outside the counted
    # run: the searches (they are deterministic, so these are the entry
    # point's own bandwidths, iterations and evaluations), then the scoring
    # of given bandwidths.
    untyped = [(v, ps, None) for v, ps in fams]
    fold_rows = frame32.num_rows - frame32.num_rows // k
    given = None
    for tag, score in scores.items():
        t0 = time.perf_counter()
        h_maps, searches = score._engine._ucv_bandwidths(untyped)
        search_s = time.perf_counter() - t0
        if sorted(h_maps) != list(range(len(fams))):
            raise AssertionError(f"UCV found bandwidths for {sorted(h_maps)}")
        if tag == "f32":
            given = [h_maps[i] for i in range(len(fams))]
        say("9 ucv", path="CVLikelihood+UCV", dtype=tag, families=len(fams),
            folds=k, rows=frame32.num_rows, programs=len(fams) * k,
            wall_s=f"{walls[tag]:.4f}", **search_fields(
                torch, frames[tag],
                [(s, fold_rows, vech_width(s.x.shape[1])) for s in searches],
                search_s))
    # the float32 searches by the plain host loop on the card, as before
    # the search kernel: timed, then again untimed, recording the inputs of
    # the pair-sums kernel and the bandwidths the searches visit
    with PlainSearches():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_maps, plain_searches = scores["f32"]._engine._ucv_bandwidths(
            untyped)
        plain_s = time.perf_counter() - t0
        with UcvRecording() as visits:
            scores["f32"]._engine._ucv_bandwidths(untyped)
    say("9 ucv", path="CVLikelihood+UCV", dtype="f32 plain host loop",
        families=len(fams), **search_fields(
            torch, frame32,
            [(s, fold_rows, vech_width(s.x.shape[1]))
             for s in plain_searches], plain_s))
    # the float32 search's bandwidths, scored by both dtypes
    t0 = time.perf_counter()
    s32 = scores["f32"]._engine._ckde_host_batch(typed, h_maps=given)
    scoring_s = time.perf_counter() - t0
    s64 = scores["f64"]._engine._ckde_host_batch(typed, h_maps=given)
    rel_given = check_scores(s32, s64, "UCV scores, the same bandwidths")
    # gate 4: the CV scores of the kernel's bandwidths against those of
    # the plain search's
    s_plain = scores["f32"]._engine._ckde_host_batch(
        typed, h_maps=[plain_maps[i] for i in range(len(fams))])
    rel_routes = float(np.max(np.abs(s32 - s_plain) / np.abs(s_plain)))
    if not (np.all(np.isfinite(s_plain)) and rel_routes <= SCORE_RTOL):
        raise AssertionError(f"UCV scores of the kernel's bandwidths {s32} "
                             f"against the plain search's {s_plain}")
    if not np.allclose(s32, own["f32"], rtol=SCORE_RTOL):
        raise AssertionError("the float32 search is not reproducible: "
                             f"{s32} vs {own['f32']}")
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    wargs, wkw = ucv_whiten_inputs(torch, scores["f32"]._engine, fams, given)
    parts = ckde_cv_whiten(*wargs, **wkw)
    errs = {
        "ckde_cv_whiten": compare_whiten(torch, wargs, "ucv-cv-families",
                                         phase="9 ucv kernel", **wkw)["err"],
        "ckde_cv_pairs": compare_pairs(torch, list(parts[:7]),
                                       "ucv-cv-families",
                                       phase="9 ucv kernel")["err"],
        "ckde_cv_fold_reduce": compare_reduce(
            torch, reduce_inputs(torch, parts), "ucv-cv-families",
            phase="9 ucv kernel")["err"],
    }
    # the starts kernel on (b)'s families, then timed on the benchmark's
    # (bench.py's 15 families: 5 a width, 50 problems a launch)
    engine = scores["f32"]._engine
    checked = ucv_starts_check(torch, None, engine, fams, "ucv-cv-families")
    starts = ucv_starts_check(torch, card, engine, families(len(names)),
                              "kde5-15-families")
    errs["ucv_starts"] = max(r["err"] for r in [*checked.values(),
                                                *starts.values()])
    ucv = ucv_kernel_check(torch, card, visits)
    search = ucv_search_check(torch, card, searched.calls,
                              searched.device_ms(), stamped)
    say("9 ucv", path="CVLikelihood+UCV", scoring_s_f32=f"{scoring_s:.4f}",
        scores_f32=repr([round(float(x), 3) for x in s32]),
        same_bandwidths_max_rel_vs_f64=f"{rel_given:.3e}",
        kernel_vs_plain_search_scores_max_rel=f"{rel_routes:.3e}",
        own_scores_f32=repr([round(float(x), 3) for x in own["f32"]]),
        own_scores_f64=repr([round(float(x), 3) for x in own["f64"]]),
        own_bandwidths_max_rel=f"{rel_own:.3e}",
        launches=launches_b)

    # (c) a user's selector: the host route of _ckde_host_batch
    class ScaledCovariance(BandwidthSelector):
        def bandwidth(self, df, variables):
            return 0.05 * np.atleast_2d(df.cov(list(variables)))

    def custom_score(frame):
        return CVLikelihood(frame, k=k, seed=0, construction_args=Arguments(
            {CKDEType(): Kwargs(bandwidth_selector=ScaledCovariance())}))

    score = custom_score(frame32)
    reset_counts()
    t0 = time.perf_counter()
    got = score.local_score_batch(model, typed[2:])
    wall = time.perf_counter() - t0
    launches_c = read_counts()
    if launches_c["ckde_cv_pairs"] == 0:
        raise AssertionError("the custom-selector family did not launch the "
                             "pairs kernel")
    rel = check_scores(got, custom_score(frame64).local_score_batch(
        model, typed[2:]), "custom selector vs float64")
    say("9 ucv", path="CVLikelihood+custom selector", families=1,
        wall_s=f"{wall:.4f}", score=f"{got[0]:.6f}",
        max_rel_vs_f64=f"{rel:.3e}", launches=launches_c)

    # (d) a UCV-fitted KDE, evaluated through the KDE kernel
    test = make_data(seed=1)
    cols = names[:2]
    selector = UCV()
    kde32 = KDE(cols, selector)
    test32 = DataFrame.wrap(test)
    reset_counts()
    t0 = time.perf_counter()
    kde32.fit(frame32)
    fit_s = time.perf_counter() - t0
    fitted = selector.last_search
    got = kde32.logl(test32)
    launches_d = read_counts()
    for name in ("kde_logl", "ucv_search"):
        if launches_d[name] == 0:
            raise AssertionError(f"KDE(UCV).fit and logl did not launch "
                                 f"{name}")
    kde64 = KDE(cols)
    kde64.fit_with_bandwidth(
        frame64.to_numpy(cols, drop_null=True, dtype=np.float64),
        kde32.bandwidth)
    want = kde64.logl(DataFrame.wrap(
        {c: v.astype(np.float64) for c, v in test.items()}))
    err_kde = float(np.max(np.abs(got - want)))
    if not (np.all(np.isfinite(got)) and err_kde <= ROW_TOL):
        raise AssertionError(f"UCV KDE.logl vs float64: {err_kde} > {ROW_TOL}")
    say("9 ucv", path="KDE(UCV).fit+logl", columns=len(cols),
        fit_s=f"{fit_s:.4f}", iterations=int(fitted.iterations[0]),
        evaluations=fitted.evaluations,
        logl_max_abs_vs_f64=f"{err_kde:.3e}", launches=launches_d)

    # (e) the UCV score of a bandwidth on the float32 frame (UCVScorer):
    # one launch of the pair-sums kernel a score
    from pybnesian_tpu_torch import NormalReferenceRule
    from pybnesian_tpu_torch.kde.ucv import UCVScorer

    reset_counts()
    scored = {}
    for d in (1, 2, 3):
        h = NormalReferenceRule().bandwidth(frame64, names[:d])
        scored[d] = UCVScorer(frame32, names[:d]).score_unconstrained(h)
    launches_e = read_counts()
    if launches_e["ucv_pair_sums"] != 3:
        raise AssertionError(f"UCVScorer launched the pair-sums kernel "
                             f"{launches_e['ucv_pair_sums']} times for 3 "
                             "scores")
    rel = max(abs(scored[d] / UCVScorer(frame64, names[:d])
                  .score_unconstrained(NormalReferenceRule().bandwidth(
                      frame64, names[:d])) - 1.0) for d in scored)
    if not rel <= SCORE_RTOL:
        raise AssertionError(f"UCVScorer float32 vs float64: {rel}")
    say("9 ucv", path="UCVScorer float32", columns="1,2,3",
        max_rel_vs_f64=f"{rel:.3e}", launches=launches_e)
    return (add_counts(launches_b, launches_c, launches_d, launches_e), errs,
            ucv, search, starts[max(starts)])


def discrete_data(n=DISCRETE_ROWS, d=DISCRETE_NODES, seed=0, fresh=0.3):
    """benchmarks/config2_discrete_hc.py's data (:34-45): a chain of
    cardinality-3 columns, each copying the one before it or, with
    probability ``fresh``, drawing afresh. A port DataFrame, built without
    pandas. With 0.35, benchmarks/config4b_discrete_pc.py's (:31-41)."""
    from pybnesian_tpu_torch.data import Column, DataFrame

    rng = np.random.default_rng(seed)
    cols = []
    prev = rng.integers(0, 3, n)
    for i in range(d):
        flip = rng.random(n) < fresh
        cur = np.where(flip, rng.integers(0, 3, n), prev)
        cols.append(Column(f"v{i}", cur.astype(np.int32), ("x", "y", "z")))
        prev = cur
    return DataFrame(cols)


def grid_families(names, F):
    """F families over ``names``: variable f mod d, with f mod 4 parents
    (0 to 3), the next columns round the ring."""
    d = len(names)
    return [(names[f % d], [names[(f + 1 + j) % d] for j in range(f % 4)])
            for f in range(F)]


def host_median_s(fn, runs=3):
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def discrete_batch_grid():
    """The native core against the card, BIC and BDe, per batch over the
    grid of family counts and row counts: seconds per
    ``local_score_batch`` of a score on each tier, host clock (the card's
    calls end in the copy of the scores to the host), median of 3 after a
    warm call. The codes are on the card before the clock starts, as they
    are from a score's second batch on."""
    from pybnesian_tpu_torch import BIC, BDe, DiscreteBN

    for n in GRID_ROWS:
        frame = discrete_data(n=n, seed=1)
        names = frame.column_names()
        model = DiscreteBN(names)
        tiers = {kind: {"native": make(frame, native=True),
                        "card": make(frame, native=False)}
                 for kind, make in (("bic", BIC), ("bde", BDe))}
        for F in GRID_FAMILIES:
            fams = grid_families(names, F)
            fields = {}
            for kind, by_tier in tiers.items():
                want = by_tier["native"].local_score_batch(model, fams)
                got = by_tier["card"].local_score_batch(model, fams)
                rel = float(np.max(np.abs(got - want) / np.abs(want)))
                if not rel <= DISCRETE_RTOL:
                    raise AssertionError(f"grid {kind} F={F} n={n}: card vs "
                                         f"native {rel} > {DISCRETE_RTOL}")
                t = {tier: host_median_s(
                         lambda: score.local_score_batch(model, fams))
                     for tier, score in by_tier.items()}
                fields.update({f"{kind}_native_ms": f"{t['native'] * 1e3:.3f}",
                               f"{kind}_card_ms": f"{t['card'] * 1e3:.3f}",
                               f"{kind}_card_wins": t["card"] < t["native"]})
            say("10 batch grid", families=F, rows=n, row_items=F * n,
                **fields)


def discrete_search_grid():
    """Whole searches on each tier over :data:`SEARCH_GRID_ROWS` rows of
    config2's 20 nodes: ``hc`` with a new score per call (its codes are
    built, or copied to the card, inside the clock, as a user's call
    does), median of 3 after a warm call. The native tier runs the core's
    own loop, and the Python loop when a callback asks for it; the card's
    tier always runs the Python loop. Beside them what the shipped rule
    (:func:`discrete_native.takes_frame`) chooses."""
    from pybnesian_tpu_torch import BIC, BDe, DiscreteBNType, hc
    from pybnesian_tpu_torch.learning.scores import discrete_native

    for n in SEARCH_GRID_ROWS:
        frame = discrete_data(n=n, seed=1)
        d = frame.num_columns
        for kind, make in (("bic", BIC), ("bde", BDe)):
            def search(native, callback=None):
                return hc(frame, bn_type=DiscreteBNType(),
                          score=make(frame, native=native),
                          callback=callback)

            if make(frame, native=False).device.type != "cuda":
                raise AssertionError(f"{kind}'s device tier is not the card")
            native_loop = host_median_s(lambda: search(True))
            python_native = host_median_s(
                lambda: search(True, StepRecorder()))
            python_card = host_median_s(lambda: search(False))
            say("10 search grid", score=kind, nodes=d, rows=n,
                rows_x_columns2=n * d * d,
                native_loop_s=f"{native_loop:.4f}",
                python_loop_native_tier_s=f"{python_native:.4f}",
                python_loop_card_tier_s=f"{python_card:.4f}",
                card_beats_native_loop=python_card < native_loop,
                card_beats_python_native=python_card < python_native,
                rule_takes_native=discrete_native.takes_frame(n, d))
    say("10 search grid", rule_native_below_rows_x_columns2=(
        discrete_native.NATIVE_BELOW_ROW_ITEMS))


def phase_discrete(torch):
    """Discrete networks: the native core, both hc loops on both tiers,
    the card's batched scores against the core's, BGe, and the two
    crossover grids."""
    from pybnesian_tpu_torch import (
        BIC, BDe, DataFrame, DiscreteBN, DiscreteBNType,
        GaussianNetworkType, hc)
    from pybnesian_tpu_torch.learning.scores import discrete_native

    if not discrete_native.available():
        raise AssertionError("the native discrete core did not build: "
                             f"{discrete_native.load_error()}")
    frame = discrete_data()
    names = frame.column_names()
    bn = DiscreteBNType()

    def arcs(model):
        return sorted(model.arcs())

    def timed(**kwargs):
        before = discrete_native.hc_discrete.calls
        t0 = time.perf_counter()
        model = hc(frame, bn_type=bn, **kwargs)
        seconds = time.perf_counter() - t0
        dag_order(model.nodes(), model.arcs())
        return model, seconds, discrete_native.hc_discrete.calls - before

    for name, make in (("bic", BIC), ("bde", BDe)):
        # as shipped: the score chosen by its name, its tier by the rule.
        # A callback forces the Python loop; both calls must learn the
        # same arcs, whichever tier the rule takes.
        by_rule_native = make(frame).native_tier()
        plain, plain_s, core_loops = timed(score=name)
        recorder = StepRecorder()
        watched, watched_s, _ = timed(score=name, callback=recorder)
        if core_loops != int(by_rule_native):
            raise AssertionError(
                f"hc score={name}: the rule takes the "
                f"{'native' if by_rule_native else 'card'} tier but the "
                f"core's loop ran {core_loops} times")
        if arcs(plain) != arcs(watched):
            raise AssertionError(f"hc score={name}: with and without a "
                                 "callback it learned different arcs")
        # each tier by choice: the core's loop and the Python loop see the
        # same scores on the native tier, bit for bit
        native, native_s, core_loops = timed(score=make(frame, native=True))
        if core_loops != 1:
            raise AssertionError(f"hc score={name}: the native loop did not "
                                 "run on the native tier")
        python, python_s, _ = timed(score=make(frame, native=True),
                                    callback=StepRecorder())
        if arcs(native) != arcs(python):
            raise AssertionError(f"hc score={name}: the native and the Python "
                                 "loop learned different arcs")
        card, card_s, core_loops = timed(score=make(frame, native=False))
        card_watched, _, _ = timed(score=make(frame, native=False),
                                   callback=StepRecorder())
        if core_loops or arcs(card) != arcs(card_watched):
            raise AssertionError(f"hc score={name}: the card's tier ran the "
                                 "core's loop, or learned two graphs")
        # the tiers' float64 scores differ in the last bits, and BIC and
        # BDe score an arc and its reversal alike: across tiers such a tie
        # may break the other way, to a Markov-equivalent graph
        score = make(frame)
        total, total_card = score.score(native), score.score(card)
        if ({frozenset(a) for a in native.arcs()}
                != {frozenset(a) for a in card.arcs()}
                or not abs(total_card - total) <= DISCRETE_RTOL * abs(total)):
            raise AssertionError(
                f"hc score={name}: the card's tier learned another skeleton "
                f"or score ({total_card} vs {total})")
        if not native.num_arcs() >= DISCRETE_NODES - 1:
            raise AssertionError(f"hc score={name} learned "
                                 f"{native.num_arcs()} arcs of a 20-node chain")
        say("10 discrete", hc_score=name, nodes=len(names),
            rows=frame.num_rows, arcs=plain.num_arcs(),
            rule_takes_native=by_rule_native,
            by_rule_s=f"{plain_s:.4f}",
            by_rule_with_callback_s=f"{watched_s:.4f}",
            by_rule_same_arcs=True, python_iterations=recorder.iterations,
            native_loop_s=f"{native_s:.4f}",
            python_loop_native_tier_s=f"{python_s:.4f}",
            native_tier_same_arcs=True,
            python_loop_card_tier_s=f"{card_s:.4f}",
            card_tier_same_arcs_as_native=arcs(card) == arcs(native),
            card_tier_same_skeleton_and_score=True,
            total_score=f"{total:.6f}")

    # the card's batched scores against the native core's
    fams = [(t, [s]) for t in names for s in names if s != t]
    model = DiscreteBN(names)
    for make in (BIC, BDe):
        on_card = make(frame, native=False)
        if on_card.device.type != "cuda":
            raise AssertionError(f"{on_card.ToString()} runs on "
                                 f"{on_card.device}, not cuda")
        got = on_card.local_score_batch(model, fams)
        want = make(frame, native=True).local_score_batch(model, fams)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        if not (np.all(np.isfinite(got)) and rel <= DISCRETE_RTOL):
            raise AssertionError(f"{on_card.ToString()} on the card vs the "
                                 f"native core: {rel} > {DISCRETE_RTOL}")
        say("10 discrete", score=on_card.ToString(), families=len(fams),
            card_vs_native_max_rel=f"{rel:.3e}")

    # BGe on phase 8's continuous frame
    cont = DataFrame.wrap(config3b_data(HC_ROWS, seed=2))
    recorder = StepRecorder()
    t0 = time.perf_counter()
    learned = hc(cont, bn_type=GaussianNetworkType(), score="bge",
                 callback=recorder, max_iters=HC_MAX_ITERS)
    wall = time.perf_counter() - t0
    dag_order(learned.nodes(), learned.arcs())
    if not 0 < recorder.iterations < HC_MAX_ITERS:
        raise AssertionError(f"BGe hc took {recorder.iterations} iterations")
    say("10 discrete", hc_score="bge", rows=HC_ROWS,
        columns=cont.num_columns, iterations=recorder.iterations,
        arcs=learned.num_arcs(), wall_s=f"{wall:.4f}")
    discrete_batch_grid()
    discrete_search_grid()


# ---------------------------------------------------------------- phase 11
def hybrid_data(n, seed, dtype=np.float32, d=8, categories=3):
    """config3b's chain (benchmarks/config3b_logl_evals.py:34-49) with two
    categorical columns, d0 and d1, of ``categories`` uniform categories
    each: every continuous node's mean shifts with d0, the even nodes' also
    with d1. A port DataFrame, continuous columns in ``dtype``."""
    from pybnesian_tpu_torch.data import Column, DataFrame

    rng = np.random.default_rng(seed)
    codes = [rng.integers(0, categories, n) for _ in range(2)]
    shifts = [np.linspace(-1.5, 1.5, categories),
              np.linspace(1.0, -1.0, categories)]
    cols = []
    prev = rng.normal(0, 1, n)
    for i in range(d):
        if i:
            prev = np.sin(0.8 * prev) + 0.5 * prev + rng.normal(0, 0.6, n)
        prev = prev + shifts[0][codes[0]]
        if i % 2 == 0:
            prev = prev + shifts[1][codes[1]]
        cols.append(Column(f"x{i}", prev.astype(dtype)))
    values = tuple(f"k{c}" for c in range(categories))
    cols += [Column(f"d{j}", c.astype(np.int32), values)
             for j, c in enumerate(codes)]
    return DataFrame(cols)


def launches_since(before):
    return {k: v - before[k] for k, v in read_counts().items()}


class Recording:
    """From :meth:`start` to :meth:`stop`, every launch of the two KDE
    kernels and of the CV whitening and fold-reduce kernels through
    ``ops/kde.py`` (where the port calls those four wrappers), and of the
    LG kernel through ``ops/gaussian.py`` (where the port calls its
    wrapper), is recorded as it passes: per kernel, how many calls and
    how many launches it made (the wrapper's own count before and after
    each call), and a copy of the first call's arguments and keywords of
    each shape of arguments. Every call must launch once, or not at all
    when an argument is empty (as in a batch of no programs). The copies are
    made on the card's stream, once per new shape. A path runs between the
    two calls; a phase that fails ends the script, so nothing restores the
    wrappers then."""

    NAMES = ("ckde_cv_pairs", "kde_logl", "ckde_cv_whiten",
             "ckde_cv_fold_reduce", "lg_cv_stats")

    def __init__(self):
        self.launches = dict.fromkeys(self.NAMES, 0)
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.first = {n: {} for n in self.NAMES}

    def start(self):
        from pybnesian_tpu_torch.ops import gaussian
        from pybnesian_tpu_torch.ops import kde as kde_ops

        self._modules = {n: gaussian if n == "lg_cv_stats" else kde_ops
                         for n in self.NAMES}
        self._wrappers = {n: getattr(m, n) for n, m in self._modules.items()}
        for name, wrapper in self._wrappers.items():
            setattr(self._modules[name], name,
                    self._recording(name, wrapper))
        return self

    def stop(self):
        """Restores the wrappers; returns the launch counts read now."""
        for name, wrapper in self._wrappers.items():
            setattr(self._modules[name], name, wrapper)
        return read_counts()

    def _recording(self, name, wrapper):
        def clone(a):
            return a.clone() if hasattr(a, "clone") else a

        def recording(*args, **kwargs):
            shape = (tuple(getattr(a, "shape", None) for a in args),
                     tuple((k, tuple(getattr(v, "shape", (repr(v),))))
                           for k, v in sorted(kwargs.items())))
            before = wrapper.launches
            out = wrapper(*args, **kwargs)
            launched = wrapper.launches - before
            empty = any(getattr(a, "numel", lambda: 1)() == 0
                        for a in (*args, *kwargs.values()))
            if launched > 1 or (launched == 0 and not empty):
                raise AssertionError(
                    f"a call of {name} launched {launched} times (empty "
                    f"argument: {empty})")
            self.calls[name] += 1
            self.launches[name] += launched
            if shape not in self.first[name]:
                self.first[name][shape] = (
                    [clone(a) for a in args],
                    {k: clone(v) for k, v in kwargs.items()})
            return out
        return recording


def hold_recorded(torch, rec, counted, label, phase):
    """Each kernel that ``rec`` saw launched, against its plain version on
    the first launch's inputs of every shape it was launched at.
    ``counted`` is the path's launch counts over the same calls: every
    launch the counters saw must have been recorded. Returns each launched
    kernel's largest error."""
    compare = {"ckde_cv_pairs": compare_pairs, "kde_logl": compare_kde,
               "ckde_cv_whiten": compare_whiten,
               "ckde_cv_fold_reduce": compare_reduce,
               "lg_cv_stats": compare_lg}
    for name, n in rec.launches.items():
        if n != counted[name]:
            raise AssertionError(f"{label}: {name} counted {counted[name]} "
                                 f"launches, recorded {n}")
    errs = {}
    for name in Recording.NAMES:
        if not rec.first[name]:
            continue
        errs[name] = max(compare[name](torch, args, label, phase=phase,
                                       quiet=True, **kwargs)["err"]
                         for args, kwargs in rec.first[name].values())
        say(phase, path=label, kernel=name, launches=counted[name],
            calls=rec.calls[name], shapes_held=len(rec.first[name]),
            max_abs_err=f"{errs[name]:.3e}")
    return errs


def as_float64(state):
    """A network's :func:`interop.network_state` with every CKDE factor,
    inside hybrid factors and dynamic networks too, set to evaluate in
    float64: the same fitted model on the plain route."""
    if "static" in state:
        return dict(state, static=as_float64(state["static"]),
                    transition=as_float64(state["transition"]))

    def cpd64(cpd):
        if cpd is None:
            return None
        if "factors" in cpd:
            return dict(cpd, factors=[cpd64(f) for f in cpd["factors"]])
        return dict(cpd, dtype="float64") if "dtype" in cpd else cpd

    return dict(state, cpds={n: cpd64(c) for n, c in state["cpds"].items()})


def phase_hybrid(torch):
    """Hybrid networks on config3b's chain with two categorical columns:
    (a) a fitted SemiparametricBN of 4 HCKDE and 4 CLinearGaussianCPD nodes,
    ``logl`` and ``slogl`` against float64, each configuration's own CKDE
    against its HCKDE; (b) ``hc`` on a SemiparametricBN against float64 by
    the tie rule; (c) a CLGNetwork's fit, slogl and ``hc``. Then both
    kernels against their plain versions on the inputs that (a) to (c)
    gave them, at each shape launched. Returns the path's launches and each
    kernel's largest error."""
    from pybnesian_tpu_torch import (
        CKDE, CLGNetwork, CLGNetworkType, CLinearGaussianCPD, DataFrame,
        DiscreteFactorType, HCKDE, LinearGaussianCPDType, SemiparametricBN,
        CKDEType, hc, interop)

    train32, test32 = hybrid_data(HC_ROWS, 0), hybrid_data(HC_ROWS, 1)
    train64 = hybrid_data(HC_ROWS, 0, np.float64)
    test64 = hybrid_data(HC_ROWS, 1, np.float64)
    names = [c for c in train32.column_names() if c.startswith("x")]
    arcs = ([(names[i], names[i + 1]) for i in range(len(names) - 1)]
            + [("d0", v) for v in names] + [("d1", v) for v in names[0::2]])
    types = [("d0", DiscreteFactorType()), ("d1", DiscreteFactorType())]
    types += [(v, CKDEType() if i % 2 == 0 else LinearGaussianCPDType())
              for i, v in enumerate(names)]

    reset_counts()
    rec = Recording().start()
    # (a) the fitted model
    t0 = time.perf_counter()
    model = SemiparametricBN(train32.column_names(), arcs, types)
    model.fit(train32)
    fit_s = time.perf_counter() - t0
    hckde = [v for v in names if type(model.cpd(v)) is HCKDE]
    clg = [v for v in names if type(model.cpd(v)) is CLinearGaussianCPD]
    configs = sorted({len(model.cpd(v)._factors) for v in hckde}), sorted(
        {len(model.cpd(v)._factors) for v in clg})
    if (len(hckde), len(clg), configs) != (4, 4, ([9], [3])):
        raise AssertionError(f"HCKDE nodes {hckde}, CLG nodes {clg}, "
                             f"configurations {configs}")
    before = read_counts()
    node = model.cpd(hckde[0])
    one = node.logl(test32)
    one_hckde = launches_since(before)
    before = read_counts()
    logl = model.logl(test32)
    one_model = launches_since(before)
    before = read_counts()
    model.slogl(test32)  # warm
    elapsed = []
    for _ in range(MODEL_RUNS):
        t0 = time.perf_counter()
        value = model.slogl(test32)
        elapsed.append(time.perf_counter() - t0)
    slogl_launches = launches_since(before)
    rate = train32.num_columns * HC_ROWS / statistics.mean(elapsed)
    model64 = interop.fitted_network(**as_float64(
        interop.network_state(model)))
    logl64 = model64.logl(test64)
    if not (np.all(np.isfinite(logl)) and np.all(np.isfinite(logl64))):
        raise AssertionError("hybrid model.logl: non-finite rows")
    err_model = float(np.max(np.abs(logl - logl64)))
    before = read_counts()
    factors = sum(np.asarray(model.cpd(v).logl(test32))
                  for v in model.nodes())
    factor_launches = launches_since(before)
    err_factors = float(np.max(np.abs(factors - logl)))
    if not (err_model <= ROW_TOL and err_factors <= ROW_TOL):
        raise AssertionError(f"hybrid model.logl vs float64 {err_model}, "
                             f"vs Σ cpd.logl {err_factors} > {ROW_TOL}")
    # each configuration's own CKDE (kernel #2) against the HCKDE's rows
    # (kernel #1, all configurations in one launch)
    evidence = node._discrete_evidence
    codes = {e: test32.col(e).values for e in evidence}
    err_configs, before = 0.0, read_counts()
    for c in range(len(node._factors)):
        assignment = node._assignment_from_config(c)
        rows = np.flatnonzero(np.logical_and.reduce([
            codes[e] == node._discrete_values[e].index(assignment.value(e))
            for e in evidence]))
        sub = node.conditional_factor(assignment)
        if type(sub) is not CKDE:
            raise AssertionError(f"configuration {c}: {type(sub).__name__}")
        got = np.asarray(sub.logl(test32.take(rows)))
        err_configs = max(err_configs, float(np.max(np.abs(got - one[rows]))))
    config_launches = launches_since(before)
    if not err_configs <= ROW_TOL:
        raise AssertionError(f"configurations' CKDE.logl vs HCKDE.logl: "
                             f"{err_configs} > {ROW_TOL}")
    say("11 hybrid", network="SemiparametricBN", rows=HC_ROWS,
        columns=train32.num_columns, hckde=repr(hckde), clg=repr(clg),
        hckde_configurations=9, clg_configurations=3, fit_s=f"{fit_s:.4f}",
        slogl_s=repr([round(t, 6) for t in elapsed]),
        factor_row_evals_per_s=f"{rate:.2f}", slogl=f"{value:.6f}",
        slogl_f64=f"{model64.slogl(test64):.6f}",
        logl_max_abs_vs_f64=f"{err_model:.3e}",
        factors_vs_model_max_abs=f"{err_factors:.3e}",
        configurations_vs_hckde_max_abs=f"{err_configs:.3e}",
        launches_one_hckde_logl=one_hckde, launches_one_model_logl=one_model,
        launches_slogl_calls=MODEL_RUNS + 1, launches_slogl=slogl_launches,
        launches_cpd_logl_sum=factor_launches,
        launches_configurations=config_launches)

    # (b) hc on a SemiparametricBN over the 10 columns
    before = read_counts()
    run32 = learn(torch, train32)
    hc_launches = launches_since(before)
    run64 = learn(torch, train64)
    learned, score, recorder, wall = run32
    dag_order(learned.nodes(), learned.arcs())
    if not recorder.iterations < HC_MAX_ITERS:
        raise AssertionError(f"hybrid hc ran to max_iters ({HC_MAX_ITERS})")
    compared = compare_runs(run32, run64, "11 hybrid")
    arcs32, types32 = graph_of(learned)
    say("11 hybrid", hc="SemiparametricBNType", score="validated-lik",
        wall_s=f"{wall:.4f}", iterations=recorder.iterations,
        families_scored=score.families, launches=hc_launches,
        f64_wall_s=f"{run64[3]:.4f}", f64_iterations=run64[2].iterations,
        **compared)
    say("11 hybrid", arcs=repr(arcs32), ckde=repr(sorted(
        n for n, t in types32.items() if t == "CKDEFactor")))

    # (c) the CLG network: fit, slogl, hc
    before = read_counts()
    clgnet = CLGNetwork(train32.column_names(), arcs)
    clgnet.fit(train32)
    clg_logl = clgnet.logl(test32)
    clgnet64 = CLGNetwork(train64.column_names(), arcs)
    clgnet64.fit(train64)
    err_clg = float(np.max(np.abs(clg_logl - clgnet64.logl(test64))))
    if not (np.all(np.isfinite(clg_logl)) and err_clg <= ROW_TOL):
        raise AssertionError(f"CLGNetwork.logl vs float64: {err_clg}")

    def clg_search(frame):
        def search(score, recorder):
            return hc(frame, bn_type=CLGNetworkType(), score=score,
                      callback=recorder, seed=0, patience=HC_PATIENCE,
                      max_iters=HC_MAX_ITERS)
        return search

    # no float64 run: a CLG search launches no kernel, and its linear-
    # Gaussian scores are float64 on both dtypes' routes
    clg32 = learn(torch, train32, clg_search(train32))
    clg_launches = launches_since(before)
    dag_order(clg32[0].nodes(), clg32[0].arcs())
    if not clg32[2].iterations < HC_MAX_ITERS:
        raise AssertionError(f"CLG hc ran to max_iters ({HC_MAX_ITERS})")
    say("11 hybrid", network="CLGNetwork", slogl=f"{clgnet.slogl(test32):.6f}",
        logl_max_abs_vs_f64=f"{err_clg:.3e}", hc_wall_s=f"{clg32[3]:.4f}",
        hc_iterations=clg32[2].iterations, hc_arcs=clg32[0].num_arcs(),
        launches=clg_launches)
    launches = rec.stop()
    for name in ("ckde_cv_pairs", "kde_logl"):
        if launches[name] == 0:
            raise AssertionError(f"the hybrid path did not launch {name}")
    say("11 hybrid", launches=launches)
    # both kernels on the inputs this path built, at each of its shapes
    return launches, hold_recorded(torch, rec, launches, "hybrid",
                                   "11 hybrid kernel")


# ---------------------------------------------------------------- phase 12
def dynamic_data(n, seed, dtype=np.float32, d=DYNAMIC_VARIABLES):
    """An AR(2) series of ``d`` variables with cross-lags: each variable
    leans on its own two lags and, through config3b's sine, on the
    previous variable's first lag. A port DataFrame in ``dtype``."""
    from pybnesian_tpu_torch import DataFrame

    rng = np.random.default_rng(seed)
    eps = rng.normal(0, 0.5, (n, d))
    x = np.zeros((n, d))
    for t in range(2, n):
        x[t] = 0.5 * x[t - 1] - 0.3 * x[t - 2] + eps[t]
        x[t, 1:] += np.sin(0.8 * x[t - 1, :-1])
    return DataFrame.wrap({f"y{j}": x[:, j].astype(dtype) for j in range(d)})


def phase_dynamic(torch):
    """Dynamic networks on an AR(2) series: a DynamicSemiparametricBN with
    CKDE nodes in both networks (fit, logl, slogl against float64, sample)
    and DMMHC with a DynamicValidatedLikelihood. Then both kernels against
    their plain versions on the inputs that these calls gave them, at each
    shape launched. Returns the path's launches and each kernel's largest
    error."""
    from pybnesian_tpu_torch import (
        DMMHC, CKDEType, DynamicDataFrame, DynamicLinearCorrelation,
        DynamicSemiparametricBN, DynamicValidatedLikelihood,
        SemiparametricBNType, interop)

    m = DYNAMIC_ORDER
    train32, test32 = dynamic_data(HC_ROWS, 0), dynamic_data(HC_ROWS, 1)
    test64 = dynamic_data(HC_ROWS, 1, np.float64)
    names = train32.column_names()

    def lag(v, k):
        return f"{v}_t_{k}"

    reset_counts()
    rec = Recording().start()
    t0 = time.perf_counter()
    dbn = DynamicSemiparametricBN(names, m)
    static, trans = dbn.static_bn(), dbn.transition_bn()
    for j, v in enumerate(names):
        trans.add_arc(lag(v, 1), lag(v, 0))
        trans.add_arc(lag(v, 2), lag(v, 0))
        static.add_arc(lag(v, 2), lag(v, 1))
        if j:
            trans.add_arc(lag(names[j - 1], 1), lag(v, 0))
            static.add_arc(lag(names[j - 1], 2), lag(v, 1))
        if j % 2 == 0:
            trans.set_node_type(lag(v, 0), CKDEType())
            static.set_node_type(lag(v, 1), CKDEType())
    dbn.fit(train32)
    fit_s = time.perf_counter() - t0
    before = read_counts()
    t0 = time.perf_counter()
    logl = dbn.logl(test32)
    logl_s = time.perf_counter() - t0
    one_logl = launches_since(before)
    slogl = dbn.slogl(test32)
    dbn64 = interop.fitted_network(**as_float64(interop.network_state(dbn)))
    logl64 = dbn64.logl(test64)
    if not (np.all(np.isfinite(logl)) and np.all(np.isfinite(logl64))):
        raise AssertionError("dynamic logl: non-finite rows")
    err = float(np.max(np.abs(logl - logl64)))
    if not err <= ROW_TOL:
        raise AssertionError(f"dynamic logl vs float64: {err} > {ROW_TOL}")
    t0 = time.perf_counter()
    sample = dbn.sample(DYNAMIC_SAMPLE_ROWS, seed=0).to_pandas()
    sample_s = time.perf_counter() - t0
    if sample.shape != (DYNAMIC_SAMPLE_ROWS, len(names)) or not np.all(
            np.isfinite(sample.to_numpy())):
        raise AssertionError("dynamic sample: wrong shape or non-finite")
    say("12 dynamic", network="DynamicSemiparametricBN", rows=HC_ROWS,
        variables=len(names), markovian_order=m,
        ckde_transition=sum(trans.node_type(n) == CKDEType()
                            for n in trans.nodes()),
        fit_s=f"{fit_s:.4f}", logl_s=f"{logl_s:.4f}", slogl=f"{slogl:.6f}",
        slogl_f64=f"{dbn64.slogl(test64):.6f}",
        logl_max_abs_vs_f64=f"{err:.3e}", launches_one_logl=one_logl,
        smoke_sample_rows=len(sample), smoke_sample_s=f"{sample_s:.4f}")

    before = read_counts()
    ddf = DynamicDataFrame(train32, m)
    t0 = time.perf_counter()
    learned = DMMHC().estimate(
        DynamicLinearCorrelation(ddf), bn_type=SemiparametricBNType(),
        score=DynamicValidatedLikelihood(ddf, seed=0), markovian_order=m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dmmhc_launches = launches_since(before)
    for net in (learned.static_bn(), learned.transition_bn()):
        dag_order(net.nodes() + list(getattr(net, "interface_nodes",
                                             lambda: [])()), net.arcs())
    if dmmhc_launches["ckde_cv_pairs"] == 0:
        raise AssertionError("DMMHC did not launch ckde_cv_pairs")
    say("12 dynamic", dmmhc_wall_s=f"{wall:.4f}",
        static_arcs=repr(sorted(learned.static_bn().arcs())),
        transition_arcs=repr(sorted(learned.transition_bn().arcs())),
        ckde=repr(sorted(n for n in learned.transition_bn().nodes()
                         if learned.transition_bn().node_type(n)
                         == CKDEType())),
        launches=dmmhc_launches)
    launches = rec.stop()
    say("12 dynamic", launches=launches)
    return launches, hold_recorded(torch, rec, launches, "dynamic",
                                   "12 dynamic kernel")


# ---------------------------------------------------------------- phase 13
def config4_data(n=PC_ROWS, d=PC_NODES, seed=0):
    """benchmarks/config4_pc.py's data (:33-45): a chain of Gaussian
    columns, each leaning on the one before it with probability 0.6 and
    on the one before that with probability 0.3. A dict of float64
    columns."""
    rng = np.random.default_rng(seed)
    cols = {}
    order = [f"v{i}" for i in range(d)]
    for i, name in enumerate(order):
        base = rng.normal(0, 1, n)
        if i >= 1 and rng.random() < 0.6:
            base += 0.8 * cols[order[i - 1]]
        if i >= 2 and rng.random() < 0.3:
            base += 0.5 * cols[order[i - 2]]
        cols[name] = base
    return cols


class CountingTest:
    """An independence test that counts its p-values. It has ``pvalue``
    alone, so PC tests one at a time
    (benchmarks/config4b_discrete_pc.py ``_Counting(batched=False)``)."""

    def __init__(self, inner):
        self.inner, self.count = inner, 0
        self.pvalues = {}  # (x, y, z) -> the p-value returned

    def pvalue(self, x, y, *z):
        self.count += 1
        p = self.inner.pvalue(x, y, *z)
        self.pvalues[(x, y, tuple(z))] = p
        return p

    def variable_names(self):
        return self.inner.variable_names()

    def num_variables(self):
        return self.inner.num_variables()

    def name(self, i):
        return self.inner.name(i)

    def has_variables(self, v):
        return self.inner.has_variables(v)


class BatchedCountingTest(CountingTest):
    """A :class:`CountingTest` with ``pvalue_batch`` on the class, as
    config4's ``_CountingTest`` has it (benchmarks/config4_pc.py:49-70), so
    that PC takes the batched route it takes for the test itself."""

    def pvalue_batch(self, triples):
        triples = list(triples)
        self.count += len(triples)
        out = self.inner.pvalue_batch(triples)
        self.pvalues.update(((x, y, tuple(z)), p)
                            for (x, y, z), p in zip(triples, out))
        return out


def pc_run(test, batched):
    """PC as config4's ``bench_ours`` calls it (benchmarks/config4_pc.py:
    73-81), or one test at a time: (pdag, the counting test, seconds)."""
    from pybnesian_tpu_torch import PC
    from pybnesian_tpu_torch.learning.algorithms.pc import _has_real_batch

    counting = (BatchedCountingTest if batched else CountingTest)(test)
    # the batched run takes the route PC takes for ``test`` itself
    if _has_real_batch(counting) != (batched and _has_real_batch(test)):
        raise AssertionError(f"PC takes the wrong route (batched={batched})")
    t0 = time.perf_counter()
    pdag = PC().estimate(counting, alpha=0.05)
    return pdag, counting, time.perf_counter() - t0


def pdag_of(pdag):
    return (sorted(pdag.arcs()),
            sorted(tuple(sorted(e)) for e in pdag.edges()))


def phase_constraint(torch):
    """The constraint-based learners: PC over LinearCorrelation on
    config4's data and over ChiSquare on config4b's, each as the user calls
    it, batched with a counter and one test at a time (the same PDAG);
    MMHC on a SemiparametricBN over phase 8's frame, float32 against
    float64 by the tie rule, then each kernel it launched against its
    plain version on the inputs that MMHC gave it, at each shape.
    Returns the path's launches and each kernel's largest error."""
    from pybnesian_tpu_torch import (
        MMHC, PC, ChiSquare, DataFrame, LinearCorrelation,
        SemiparametricBNType)

    reset_counts()
    rec = Recording().start()
    for label, make in (
            ("LinearCorrelation", lambda: LinearCorrelation(config4_data())),
            ("ChiSquare", lambda: ChiSquare(discrete_data(
                CHI_ROWS, CHI_NODES, fresh=0.35)))):
        t0 = time.perf_counter()
        test = make()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        direct = PC().estimate(test, alpha=0.05)
        direct_s = time.perf_counter() - t0
        pdag, counted, seconds = pc_run(test, batched=True)
        serial, serial_counted, serial_s = pc_run(test, batched=False)
        tests, serial_tests = counted.count, serial_counted.count
        if not pdag_of(direct) == pdag_of(pdag) == pdag_of(serial):
            raise AssertionError(f"PC over {label}: the direct, batched and "
                                 "one-at-a-time runs learned different "
                                 "PDAGs")
        say("13 constraint", pc=label, nodes=test.num_variables(),
            rows=test.df.num_rows, setup_s=f"{setup_s:.4f}",
            direct_pc_s=f"{direct_s:.4f}", tests=tests,
            pc_s=f"{seconds:.4f}", tests_per_s=f"{tests / seconds:.1f}",
            serial_tests=serial_tests, serial_pc_s=f"{serial_s:.4f}",
            serial_tests_per_s=f"{serial_tests / serial_s:.1f}",
            arcs=pdag.num_arcs(), edges=pdag.num_edges(), same_pdag=True)

    data = config3b_data(HC_ROWS, seed=2)
    frames = {"float32": DataFrame.wrap(data), "float64": DataFrame.wrap(
        {k: v.astype(np.float64) for k, v in data.items()})}

    def mmhc(frame):
        def search(score, recorder):
            return MMHC().estimate(
                LinearCorrelation(frame), bn_type=SemiparametricBNType(),
                score=score, callback=recorder, max_iters=HC_MAX_ITERS)
        return search

    before = read_counts()
    run32 = learn(torch, frames["float32"], mmhc(frames["float32"]))
    mmhc_launches = launches_since(before)
    run64 = learn(torch, frames["float64"], mmhc(frames["float64"]))
    model, score, recorder, wall = run32
    dag_order(model.nodes(), model.arcs())
    if mmhc_launches["ckde_cv_pairs"] == 0:
        raise AssertionError("MMHC did not launch ckde_cv_pairs")
    arcs, types = graph_of(model)
    say("13 constraint", mmhc="SemiparametricBNType", score="validated-lik",
        rows=HC_ROWS, wall_s=f"{wall:.4f}", iterations=recorder.iterations,
        families_scored=score.families, launches=mmhc_launches,
        f64_wall_s=f"{run64[3]:.4f}",
        **compare_runs(run32, run64, "13 constraint"))
    say("13 constraint", arcs=repr(arcs), ckde=repr(sorted(
        n for n, t in types.items() if t == "CKDEFactor")))
    launches = rec.stop()
    say("13 constraint", launches=launches)
    return launches, hold_recorded(torch, rec, launches, "constraint",
                                   "13 constraint kernel")


# ---------------------------------------------------------------- phase 14
def rcot_batch_args(test, size, seed):
    """One batch of ``test``'s (an RCoT over config4's data) lane count
    for tests conditioned on ``size`` columns: lane j tests v_j against
    v_{j+1} given the next ``size`` columns. The draws follow the batched
    path's rule (W scaled by each column's median-heuristic width, float32)
    from ``default_rng(seed)``: (host arrays, lanes)."""
    names = test.variable_names()
    _, lanes = test._lanes(size)
    cols = {c: test._full_col(c) for c in names}
    pos = {c: i for i, c in enumerate(names)}
    rng = np.random.default_rng(seed)
    trip = [(names[j % len(names)], names[(j + 1) % len(names)],
             tuple(names[(j + 2 + i) % len(names)] for i in range(size)))
            for j in range(lanes)]
    f = test.num_xy

    def draw(shape, scale):
        return (rng.standard_normal(shape) / scale).astype(np.float32)

    args = {
        "xc": np.array([pos[x] for x, _, _ in trip]),
        "Wx": draw((lanes, f), np.array([test._sigma1(x, cols[x])
                                          for x, _, _ in trip])[:, None]),
        "bx": rng.uniform(0, 2 * np.pi, (lanes, f)).astype(np.float32),
        "yc": np.array([pos[y] for _, y, _ in trip]),
        "Wy": draw((lanes, f), np.array([test._sigma1(y, cols[y])
                                          for _, y, _ in trip])[:, None]),
        "by": rng.uniform(0, 2 * np.pi, (lanes, f)).astype(np.float32),
    }
    if size:
        args["zc"] = np.array([[pos[c] for c in z] for _, _, z in trip])
        args["Wz"] = draw((lanes, size, test.num_z), np.array([
            test._sigmaz(z, np.column_stack([cols[c] for c in z]))
            for _, _, z in trip])[:, None, None])
        args["bz"] = rng.uniform(0, 2 * np.pi,
                                 (lanes, test.num_z)).astype(np.float32)
    return args, lanes


def float32_cholesky_nans(torch, data, args):
    """How many lanes of a ``fused_z`` batch (its tensor arguments
    ``args`` after ``data``) would get NaN from a float32 conditioning
    solve, as the reference computes it: czz of the float32 z features
    plus the ridge, not positive definite."""
    from pybnesian_tpu_torch.learning.independences import rcot
    from pybnesian_tpu_torch.ops.linalg import cholesky_or_nan

    zc, Wz, bz = args[-3:]
    fz = rcot._featk(data, zc, Wz, bz)
    czz = rcot._cov(fz, fz)
    eye = torch.eye(czz.shape[-1], dtype=czz.dtype, device=czz.device)
    L = cholesky_or_nan(czz + rcot._RIDGE * eye)
    return int(torch.isnan(L).any(-1).any(-1).sum())


def rcot_batches(torch, df4):
    """(a): one ``pair_stats`` batch and one ``fused_z`` batch of each z
    size on config4's data, on the card in float32 and on the CPU in
    float64 on the same draws: the statistics' largest relative error and
    the p-values' largest absolute error, and the card's time per batch."""
    from pybnesian_tpu_torch import RCoT
    from pybnesian_tpu_torch.learning.independences.rcot import (
        fused_z, pair_stats)
    from pybnesian_tpu_torch.utils.chisquaresum import (
        chisq_sum_pvalues_batch)

    test = RCoT(df4, seed=0)
    names = test.variable_names()
    mat = np.column_stack([test._full_col(c) for c in names])
    n = len(mat)
    data = {"cuda": torch.from_numpy(mat.astype(np.float32)).cuda(),
            "cpu": torch.from_numpy(mat)}
    for size in (0, *RCOT_Z_SIZES):
        args, lanes = rcot_batch_args(test, size, seed=size)
        order = ["xc", "Wx", "bx", "yc", "Wy", "by"] + (
            ["zc", "Wz", "bz"] if size else [])
        fn = fused_z if size else pair_stats

        def run(dev, dtype, lanes_run):
            ts = [torch.from_numpy(args[k][:lanes_run]).to(dev) for k in order]
            ts = [t if k.endswith("c") else t.to(dtype)
                  for k, t in zip(order, ts)]
            sta, eigs = (t.cpu().double().numpy() for t in fn(data[dev], *ts))
            sta = sta if size else n * sta
            return ts, sta, chisq_sum_pvalues_batch(
                eigs, sta, force_hbe=test.num_z == 1 and size > 0)

        ts, s32, p32 = run("cuda", torch.float32, lanes)
        ms = cuda_median_ms(torch, lambda: fn(data["cuda"], *ts), runs=3)
        nan32 = float32_cholesky_nans(torch, data["cuda"], ts) if size else 0
        # a lane's result does not depend on its batch
        _, s64, p64 = run("cpu", torch.float64, RCOT_CPU_LANES)
        rel = float(np.max(np.abs(s32[:RCOT_CPU_LANES] - s64) / np.abs(s64)))
        perr = float(np.max(np.abs(p32[:RCOT_CPU_LANES] - p64)))
        say("14 independence", batch="pair_stats" if size == 0 else "fused_z",
            z_size=size, lanes=lanes, rows=n, float32_cholesky_nan_lanes=nan32,
            card_ms=f"{ms:.3f}",
            ms_per_test=f"{ms / lanes:.4f}", stat_max_rel_err=f"{rel:.3e}",
            pvalue_max_abs_err=f"{perr:.3e}")
        if not (np.all(np.isfinite(s32)) and rel <= RCOT_STAT_RTOL
                and perr <= RCOT_PVALUE_ATOL):
            raise AssertionError(
                f"RCoT batch z={size}: float32 on the card against float64 "
                f"on the CPU: statistic rel err {rel}, p-value err {perr} "
                f"(gates {RCOT_STAT_RTOL}, {RCOT_PVALUE_ATOL})")


def rcot_pc(df4):
    """(b): PC over RCoT(df4, seed=0) as config4's ``bench_rcot`` runs it
    (warm-up batches of z sizes 0, 1, 2, 3 and 5 first), through the
    batched counter: (pdag, counting test, seconds, warm-up seconds)."""
    from pybnesian_tpu_torch import RCoT

    test = RCoT(df4, seed=0)
    names = test.variable_names()
    t0 = time.perf_counter()
    for z in ([], ["v2"], ["v2", "v3"], ["v2", "v3", "v4"],
              ["v2", "v3", "v4", "v5", "v6"]):
        test.pvalue_batch([(names[0], names[1], tuple(z))])
    warm = time.perf_counter() - t0
    pdag, counted, seconds = pc_run(test, batched=True)
    return pdag, counted, seconds, warm


def kmi_pc(df):
    """(c): PC over KMutualInformation batched and one test at a time: the
    same PDAG and the same p-value for every test both ran; where two
    differ, a shuffled estimate must tie the observed one within 1e-12."""
    from pybnesian_tpu_torch import KMutualInformation

    test = KMutualInformation(df, k=KMI_K, seed=0, samples=KMI_SAMPLES)
    pdag, batched, b_s = pc_run(test, batched=True)
    serial_pdag, serial, s_s = pc_run(test, batched=False)
    if pdag_of(pdag) != pdag_of(serial_pdag):
        raise AssertionError("PC over KMutualInformation: the batched and "
                             "one-at-a-time runs learned different PDAGs")
    common = batched.pvalues.keys() & serial.pvalues.keys()
    differ = [t for t in common if batched.pvalues[t] != serial.pvalues[t]]
    for x, y, z in differ:
        draws, dz = test._draws(x, z)
        ys = test._ranked[:, test._pos[y]]
        vals = test._estimates(draws[None], ys[None],
                               None if dz is None else dz[None])[0]
        gap = float(np.min(np.abs(vals[1:] - vals[0])))
        say("14 independence", kmi_differs=repr((x, y, z)),
            batched=batched.pvalues[(x, y, z)],
            serial=serial.pvalues[(x, y, z)], closest_tie=f"{gap:.3e}")
        if gap > 1e-12:
            raise AssertionError(f"KMutualInformation {(x, y, z)}: batched "
                                 "and serial p-values differ with no tie")
    say("14 independence", pc="KMutualInformation", rows=test.df.num_rows,
        columns=test.num_variables(), k=KMI_K, samples=KMI_SAMPLES,
        tests=batched.count, pc_s=f"{b_s:.4f}",
        tests_per_s=f"{batched.count / b_s:.2f}", serial_tests=serial.count,
        serial_pc_s=f"{s_s:.4f}",
        serial_tests_per_s=f"{serial.count / s_s:.2f}",
        tests_in_both=len(common), pvalues_differ=len(differ),
        arcs=pdag.num_arcs(), edges=pdag.num_edges(), same_pdag=True)


def phase_independence(torch):
    """The last two independence tests: (a) RCoT's batched algebra on
    config4's data, float32 on the card against float64 on the CPU; (b) PC
    over RCoT on all of config 4, twice with one seed; (c) PC over
    KMutualInformation on config4's first columns and rows, batched
    against one test at a time; (d) MMHC over RCoT on a SemiparametricBN
    over phase 8's frame, float32 against float64 by the tie rule, then
    each kernel it launched against its plain version on the inputs that
    MMHC gave it. Returns (d)'s launches and each kernel's largest
    error."""
    from pybnesian_tpu_torch import MMHC, RCoT, DataFrame, SemiparametricBNType

    t_phase = time.perf_counter()
    df4 = config4_data()
    rcot_batches(torch, df4)

    runs = [rcot_pc(df4) for _ in range(2)]
    (pdag, counted, seconds, warm), (again, *_) = runs
    pvals = np.array(list(counted.pvalues.values()))
    if not np.all((pvals >= 0) & (pvals <= 1)):
        raise AssertionError("PC over RCoT: a p-value outside [0, 1]")
    if pdag_of(pdag) != pdag_of(again):
        raise AssertionError("PC over RCoT: two runs with seed 0 learned "
                             "different PDAGs")
    say("14 independence", pc="RCoT", nodes=PC_NODES, rows=PC_ROWS,
        warmup_s=f"{warm:.4f}", tests=counted.count, pc_s=f"{seconds:.4f}",
        tests_per_s=f"{counted.count / seconds:.1f}",
        second_run_pc_s=f"{runs[1][2]:.4f}",
        second_run_tests_per_s=f"{runs[1][1].count / runs[1][2]:.1f}",
        pvalues_in_unit_interval=True, arcs=pdag.num_arcs(),
        edges=pdag.num_edges(), same_pdag_twice=True)

    kmi_pc({c: v[:KMI_ROWS] for c, v in list(df4.items())[:KMI_COLUMNS]})

    data = config3b_data(HC_ROWS, seed=2)
    frames = {"float32": DataFrame.wrap(data), "float64": DataFrame.wrap(
        {k: v.astype(np.float64) for k, v in data.items()})}

    def mmhc(frame):
        def search(score, recorder):
            return MMHC().estimate(
                RCoT(frame, seed=0), bn_type=SemiparametricBNType(),
                score=score, callback=recorder, max_iters=HC_MAX_ITERS)
        return search

    reset_counts()
    rec = Recording().start()
    run32 = learn(torch, frames["float32"], mmhc(frames["float32"]))
    mmhc_launches = read_counts()
    run64 = learn(torch, frames["float64"], mmhc(frames["float64"]))
    model, score, recorder, wall = run32
    dag_order(model.nodes(), model.arcs())
    if mmhc_launches["ckde_cv_pairs"] == 0:
        raise AssertionError("MMHC over RCoT did not launch ckde_cv_pairs")
    arcs, types = graph_of(model)
    say("14 independence", mmhc="SemiparametricBNType", test="RCoT",
        score="validated-lik", rows=HC_ROWS, wall_s=f"{wall:.4f}",
        iterations=recorder.iterations, families_scored=score.families,
        launches=mmhc_launches, f64_wall_s=f"{run64[3]:.4f}",
        **compare_runs(run32, run64, "14 independence"))
    say("14 independence", arcs=repr(arcs), ckde=repr(sorted(
        n for n, t in types.items() if t == "CKDEFactor")))
    launches = rec.stop()
    errs = hold_recorded(torch, rec, launches, "independence",
                         "14 independence kernel")
    say("14 independence", wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return launches, errs


# ---------------------------------------------------------------- phase 15
def config5_frame(n=CONFIG5_ROWS, seed=0):
    """benchmarks/config5_inference.py's data (:29-37): A a two-category
    column, X leaning on A, Y on X. A pandas frame."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    a = pd.Categorical.from_codes(rng.integers(0, 2, n), ["lo", "hi"])
    x = np.where(a.codes == 1, 1.0, -1.0) + rng.normal(0, 0.5, n)
    y = 0.8 * x + rng.normal(0, 0.4, n)
    return pd.DataFrame({"A": a, "X": x, "Y": y})


def logdensity_check(torch, model, df, layout, logp, init):
    """``logp`` and its gradient on the card against the CPU's at ``init``
    and at 16 seeded points near it: the largest relative errors."""
    from torch.func import grad_and_value

    from pybnesian_tpu_torch import use_device
    from pybnesian_tpu_torch.inference import make_logdensity

    hmc = sys.modules["pybnesian_tpu_torch.inference.hmc"]

    with use_device("cpu"):
        logp_cpu, layout_cpu, init_cpu = make_logdensity(model, df,
                                                         dtype=np.float64)
    if layout_cpu.slices != layout.slices or not torch.equal(
            init_cpu, init.cpu()):
        raise AssertionError("make_logdensity: the card's layout or init "
                             "differs from the CPU's")
    rng = np.random.default_rng(0)
    points = init_cpu[None] + torch.from_numpy(
        0.1 * rng.standard_normal((LOGDENSITY_POINTS, len(init_cpu))))
    worst_v = worst_g = 0.0
    for p in torch.cat([init_cpu[None], points]):
        g_card, v_card = grad_and_value(logp)(p.cuda())
        g_cpu, v_cpu = grad_and_value(logp_cpu)(p)
        worst_v = max(worst_v, abs(float(v_card) - float(v_cpu))
                      / abs(float(v_cpu)))
        worst_g = max(worst_g, float((g_card.cpu() - g_cpu).abs().max()
                                     / g_cpu.abs().max()))
    # the samplers replay the gradient from a CUDA graph: the same numbers
    vg = hmc._value_and_grad(logp)
    graphed = hmc._graphed(vg, init)
    same = all(torch.equal(a, b) for p in points[:4]
               for a, b in zip(graphed(p.cuda()), vg(p.cuda())))
    eager_ms = cuda_median_ms(torch, lambda: vg(init), runs=20)
    graph_ms = cuda_median_ms(torch, lambda: graphed(init), runs=20)
    say("15 inference", logdensity_points=LOGDENSITY_POINTS + 1,
        dim=len(init_cpu), value_max_rel_err=f"{worst_v:.3e}",
        grad_max_rel_err=f"{worst_g:.3e}", graphed_equals_eager=same,
        gradient_ms=f"{eager_ms:.4f}", graphed_gradient_ms=f"{graph_ms:.4f}")
    if not same:
        raise AssertionError("the CUDA graph's gradient differs from the "
                             "eager one")
    if not (worst_v <= LOGDENSITY_RTOL and worst_g <= LOGDENSITY_RTOL):
        raise AssertionError("make_logdensity on the card differs from the "
                             f"CPU by more than {LOGDENSITY_RTOL}")


def phase_inference(torch):
    """Posterior inference at config 5 (benchmarks/config5_inference.py:
    a CLGNetwork A -> X -> Y over 2,000 rows, float64): the log-density and
    its gradient on the card against the CPU; NUTS with one chain; four
    NUTS chains through ``sample_chains`` with R-hat and ESS; HMC, SMC and
    ADVI on the same density."""
    from pybnesian_tpu_torch import CLGNetwork
    from pybnesian_tpu_torch.inference import (
        advi, effective_sample_size, hmc, make_logdensity, nuts,
        potential_scale_reduction, sample_chains, smc)
    from pybnesian_tpu_torch.learning.parameters import mle_lineargaussian

    t_phase = time.perf_counter()
    df = config5_frame()
    model = CLGNetwork(["A", "X", "Y"], [("A", "X"), ("X", "Y")])
    logp, layout, init = make_logdensity(model, df, dtype=np.float64)
    if not init.is_cuda:
        raise AssertionError("make_logdensity did not place its data on "
                             "the card")
    logdensity_check(torch, model, df, layout, logp, init)
    dim = len(init)
    # the continuous blocks: X's CLG configurations and Y's regression
    cont = [i for node in ("X", "Y")
            for i in range(*layout.slices[node][:2])]
    y_lo = layout.slices["Y"][0]
    mle_slope = float(mle_lineargaussian(df, "Y", ["X"]).beta[1])

    def card(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    nuts(logp, init, card(99), num_samples=5, num_warmup=5,
         max_depth=NUTS_DEPTH)  # first-call set-up, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, info = nuts(logp, init, card(1), num_samples=NUTS_SAMPLES,
                         num_warmup=NUTS_WARMUP, max_depth=NUTS_DEPTH)
    samples = samples.cpu()
    nuts_s = time.perf_counter() - t0
    if not bool(torch.isfinite(samples).all()):
        raise AssertionError("NUTS drew a non-finite sample")
    say("15 inference", sampler="nuts", chains=1, samples=NUTS_SAMPLES,
        warmup=NUTS_WARMUP, max_depth=NUTS_DEPTH, wall_s=f"{nuts_s:.4f}",
        samples_per_s=f"{NUTS_SAMPLES / nuts_s:.2f}",
        mean_leapfrogs=f"{info['mean_leapfrogs']:.2f}",
        leapfrogs_per_s=f"{info['mean_leapfrogs'] * NUTS_SAMPLES / nuts_s:.1f}",
        accept_rate=f"{float(info['accept_rate']):.4f}",
        y_slope=f"{float(samples[:, y_lo + 1].mean()):.5f}",
        mle_slope=f"{mle_slope:.5f}")
    nuts_mean = samples.mean(0)

    t0 = time.perf_counter()
    chains, cinfo = sample_chains(logp, init, card(2), num_chains=CHAINS,
                                  method="nuts", num_samples=CHAIN_SAMPLES,
                                  num_warmup=CHAIN_WARMUP,
                                  max_depth=NUTS_DEPTH)
    chains = chains.cpu().numpy()
    chains_s = time.perf_counter() - t0
    rhat = [potential_scale_reduction(chains[:, :, i]) for i in range(dim)]
    ess = [effective_sample_size(chains[:, :, i]) for i in range(dim)]
    slope = float(chains[:, :, y_lo + 1].mean())
    say("15 inference", sampler="sample_chains nuts", chains=CHAINS,
        samples=CHAIN_SAMPLES, warmup=CHAIN_WARMUP, wall_s=f"{chains_s:.4f}",
        samples_per_s=f"{CHAINS * CHAIN_SAMPLES / chains_s:.2f}",
        mean_leapfrogs=repr(np.round(cinfo["mean_leapfrogs"].cpu().numpy(),
                                     2).tolist()),
        accept_rate=repr(np.round(cinfo["accept_rate"].cpu().numpy(),
                                  4).tolist()),
        rhat=repr(np.round(rhat, 4).tolist()),
        ess=repr(np.round(ess, 1).tolist()),
        y_slope=f"{slope:.5f}", mle_slope=f"{mle_slope:.5f}")
    worst = max(rhat[i] for i in cont)
    say("15 inference", continuous_max_rhat=f"{worst:.4f}",
        rhat_below=RHAT_TARGET, met=bool(worst < RHAT_TARGET))
    if not (np.all(np.isfinite(rhat)) and np.all(np.isfinite(ess))
            and abs(slope - mle_slope) <= SLOPE_ATOL):
        raise AssertionError(f"sample_chains: a non-finite R-hat or ESS, or "
                             f"Y's slope {slope} against the MLE "
                             f"{mle_slope} (gate {SLOPE_ATOL})")

    t0 = time.perf_counter()
    hs, hinfo = hmc(logp, init, card(3), num_samples=NUTS_SAMPLES,
                    num_warmup=NUTS_WARMUP)
    hs = hs.cpu()
    hmc_s = time.perf_counter() - t0

    rng = torch.Generator(device="cuda").manual_seed(4)
    particles0 = init[None] + 0.3 * torch.randn(
        (SMC_PARTICLES, dim), generator=rng, dtype=init.dtype, device="cuda")
    t0 = time.perf_counter()
    particles, log_w, log_z = smc(
        lambda t: -0.5 * ((t - init) ** 2).sum() * 1e-2, logp, particles0,
        card(5), num_steps=SMC_STEPS, leapfrog_steps=5, step_size=0.02)
    torch.cuda.synchronize()
    smc_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mu, sigma, elbo = advi(logp, init, card(6), num_steps=ADVI_STEPS)
    mu = mu.cpu()
    advi_s = time.perf_counter() - t0
    advi_gap = float((mu[cont] - nuts_mean[cont]).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (
        hs, particles, log_w, log_z, mu, sigma, elbo))
    say("15 inference", sampler="hmc", samples=NUTS_SAMPLES,
        warmup=NUTS_WARMUP, wall_s=f"{hmc_s:.4f}",
        samples_per_s=f"{NUTS_SAMPLES / hmc_s:.2f}",
        accept_rate=f"{float(hinfo['accept_rate']):.4f}")
    say("15 inference", sampler="smc", particles=SMC_PARTICLES,
        steps=SMC_STEPS, wall_s=f"{smc_s:.4f}",
        log_evidence=f"{float(log_z):.4f}")
    say("15 inference", sampler="advi", steps=ADVI_STEPS,
        wall_s=f"{advi_s:.4f}", steps_per_s=f"{ADVI_STEPS / advi_s:.1f}",
        final_elbo=f"{float(elbo[-1]):.4f}",
        mu_vs_nuts_max_abs=f"{advi_gap:.4f}", finite=finite)
    if not finite or advi_gap > ADVI_ATOL:
        raise AssertionError(f"HMC, SMC or ADVI gave non-finite results, or "
                             f"ADVI's mean is {advi_gap} from NUTS's on the "
                             f"continuous blocks (gate {ADVI_ATOL})")
    say("15 inference", wall_s=f"{time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------- phase 16
def fold_inputs(torch, data, cols, K, rng, pad=256):
    """benchmarks/config6_scaling.py's CV layout (make_inputs, :67-99) on
    the card: K folds of a permutation drawn from ``rng``, train and test
    rows padded to a multiple of ``pad`` with masked rows, one family per
    list of column indices of ``cols`` (evidence first, variable last)."""
    n, _ = data.shape
    folds = np.array_split(rng.permutation(n), K)
    ntr = -(-max(n - len(f) for f in folds) // pad) * pad
    nte = -(-max(len(f) for f in folds) // pad) * pad
    tr_idx = np.zeros((K, ntr), np.int64)
    tr_mask = np.zeros((K, ntr), np.float32)
    te_idx = np.zeros((K, nte), np.int64)
    te_mask = np.zeros((K, nte), np.float32)
    for k, te in enumerate(folds):
        tr = np.concatenate([f for j, f in enumerate(folds) if j != k])
        tr_idx[k, : len(tr)], tr_mask[k, : len(tr)] = tr, 1.0
        te_idx[k, : len(te)], te_mask[k, : len(te)] = te, 1.0
    width = max(len(c) for c in cols)
    col_idx = np.zeros((len(cols), width), np.int64)
    col_mask = np.zeros((len(cols), width), np.float32)
    for f, c in enumerate(cols):
        col_idx[f, : len(c)], col_mask[f, : len(c)] = c, 1.0
    return tuple(torch.as_tensor(a, device="cuda") for a in (
        data.astype(np.float32), np.zeros(data.shape, np.float32), col_idx,
        col_mask, tr_idx, tr_mask, te_idx, te_mask))


def config6_cv_inputs(torch, n_fams):
    """config6_scaling.py's weak-scaling inputs (:60-99): 4,000 rows × 4
    float32 columns, 5 folds, ``n_fams`` families of 1 or 2 columns."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(C6_ROWS, C6_COLUMNS))
    cols = [[f % C6_COLUMNS] + ([(f + 1) % C6_COLUMNS] if f % 2 else [])
            for f in range(n_fams)]
    return fold_inputs(torch, data, cols, C6_FOLDS, rng)


def max_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / want.abs()).max())


def hold_rel(err, gate, what):
    if not err <= gate:
        raise AssertionError(f"{what}: relative error {err} > {gate}")


class Counted:
    """The ``parallel`` path's launches: each call of :meth:`run` is a
    window with the counts set to 0 just before it and read just after,
    and every kernel launch recorded (:class:`Recording`); the windows'
    launches add up in ``launches``. The comparisons between windows are
    not counted."""

    def __init__(self, torch):
        self.torch = torch
        self.rec = Recording()
        self.launches = dict.fromkeys(read_counts(), 0)

    def run(self, fn):
        reset_counts()
        self.rec.start()
        try:
            out = fn()
            self.torch.cuda.synchronize()
        finally:
            self.rec.stop()
        for name, n in read_counts().items():
            self.launches[name] += n
        return out


def sharded_cv_check(torch, card, counted, mesh, args, label):
    """``sharded_ckde_cv`` on ``mesh`` against the unsharded kernel route
    and the plain form, per family; both timed."""
    from pybnesian_tpu_torch.ops.kde import (ckde_cv_alldevice,
                                             ckde_cv_alldevice_flash)
    from pybnesian_tpu_torch.parallel import sharded_ckde_cv

    got = counted.run(lambda: sharded_ckde_cv(mesh, *args))
    flash = ckde_cv_alldevice_flash(*args)
    plain = ckde_cv_alldevice(*args)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: a non-finite sharded score")
    e_flash, e_plain = max_rel(got, flash), max_rel(got, plain)
    hold_rel(e_flash, SHARD_RTOL, f"{label} against the unsharded kernel")
    hold_rel(e_plain, SHARD_RTOL, f"{label} against the plain form")
    F = len(got)
    sharded_ms = host_median_s(lambda: (sharded_ckde_cv(mesh, *args),
                                        torch.cuda.synchronize()), 5) * 1e3
    flash_ms = host_median_s(lambda: (ckde_cv_alldevice_flash(*args),
                                      torch.cuda.synchronize()), 5) * 1e3
    say("16 parallel", case=label, mesh=mesh.shape, families=F,
        G_per_shard=F // mesh.shape["fam"] * args[4].shape[0],
        ntr_nte=f"{args[4].shape[1]}x{args[6].shape[1]}",
        rel_err_vs_unsharded=f"{e_flash:.3e}",
        rel_err_vs_plain=f"{e_plain:.3e}", sharded_ms=f"{sharded_ms:.4f}",
        unsharded_ms=f"{flash_ms:.4f}",
        sharded_family_scores_per_s=f"{F / sharded_ms * 1e3:.1f}",
        card=repr(card["smi"]))


def config6_bic_inputs(torch):
    """config6_scaling.py bench_bic_data_axis's inputs (:115-131): 65,536
    rows × 8 float32 columns, 32 families of 2 parents."""
    rng = np.random.default_rng(1)
    n, d, F = C6_BIC
    fam = np.arange(F)
    return tuple(torch.as_tensor(a, device="cuda") for a in (
        rng.normal(size=(n, d)).astype(np.float32),
        np.ones((n, d), np.float32),
        fam % d, np.stack([(fam + 1) % d, (fam + 2) % d], 1),
        np.ones((F, 2), np.float32)))


def sharded_bic_check(torch, card, mesh, label):
    """``sharded_lg_fit`` and ``sharded_batched_bic`` on ``mesh`` against
    a 1×1 mesh (the dry run's tolerances); both timed."""
    from pybnesian_tpu_torch.parallel import (data_fam_mesh,
                                              sharded_batched_bic,
                                              sharded_lg_fit)

    args = config6_bic_inputs(torch)
    one = data_fam_mesh(1, fam=1, devices=[mesh.home])

    def step(m):
        return (*sharded_lg_fit(m, *args), sharded_batched_bic(m, *args))

    got, want = step(mesh), step(one)
    ms = {m: host_median_s(lambda: (step(m), torch.cuda.synchronize()),
                           5) * 1e3 for m in (mesh, one)}
    tols = ((1e-4, 1e-5), (1e-4, 1e-5), (1e-4, 1e-4))
    for name, g, w, (rtol, atol) in zip(("betas", "variances", "scores"),
                                        got, want, tols):
        if not torch.allclose(g.cpu(), w.cpu(), rtol=rtol, atol=atol):
            raise AssertionError(f"{label}: {name} differ from the 1x1 mesh")
    if not bool(torch.isfinite(got[2]).all()):
        raise AssertionError(f"{label}: a non-finite BIC score")
    say("16 parallel", case=label, mesh=mesh.shape,
        rows_columns_families="x".join(map(str, C6_BIC)),
        scores_max_rel_err=f"{max_rel(got[2], want[2]):.3e}",
        betas_max_abs_err=f"{float((got[0] - want[0]).abs().max()):.3e}",
        sharded_ms=f"{ms[mesh]:.4f}", one_shard_ms=f"{ms[one]:.4f}",
        card=repr(card["smi"]))


def kde_slogl_check(torch, card, counted, mesh, label):
    """``sharded_kde_slogl`` at config6_scaling.py bench_kde_data_axis's
    size (:137-150: 16,384 train × 1,024 test rows, d 3) on ``mesh``
    against one shard and the plain version; both timed."""
    from pybnesian_tpu_torch.ops.kde_kernel import kde_logl_reference
    from pybnesian_tpu_torch.parallel import (data_fam_mesh,
                                              sharded_kde_slogl)

    rng = np.random.default_rng(2)
    ntr, nte, d = C6_KDE
    train = torch.as_tensor(rng.normal(size=(ntr, d)).astype(np.float32),
                            device="cuda")
    test = torch.as_tensor(rng.normal(size=(nte, d)).astype(np.float32),
                           device="cuda")
    one = data_fam_mesh(1, fam=1, devices=[mesh.home])
    got = counted.run(lambda: sharded_kde_slogl(mesh, train, test, -1.0))
    want = sharded_kde_slogl(one, train, test, -1.0)
    plain = kde_logl_reference(
        train[None], torch.ones((1, ntr), device="cuda"), test[None],
        torch.tensor([-1.0], device="cuda")).sum()
    e_one, e_plain = max_rel(got[None], want[None]), max_rel(got[None],
                                                             plain[None])
    hold_rel(e_one, 1e-5, f"{label} against one shard")
    hold_rel(e_plain, SHARD_RTOL, f"{label} against the plain version")
    ms = {m: host_median_s(lambda: (sharded_kde_slogl(m, train, test, -1.0),
                                    torch.cuda.synchronize()), 5) * 1e3
          for m in (mesh, one)}
    say("16 parallel", case=label, mesh=mesh.shape,
        ntr_nte_d=f"{ntr}x{nte}x{d}", slogl=f"{float(got):.4f}",
        rel_err_vs_one_shard=f"{e_one:.3e}",
        rel_err_vs_plain=f"{e_plain:.3e}", sharded_ms=f"{ms[mesh]:.4f}",
        one_shard_ms=f"{ms[one]:.4f}", card=repr(card["smi"]))


def sharded_nuts_check(torch, card):
    """``sample_chains_sharded`` NUTS over 4 virtual shards of the card:
    config6_scaling.py's density (:158-171: dim 8, 50 samples, 50 warmup,
    max_depth 6), each shard against its own ``nuts_chains`` run; then
    config 5's density, one chain a shard, timed beside ``sample_chains``
    with its four chains batched at the same draws. Each timed call comes
    after an untimed short call of the same kind, and holds its own
    CUDA-graph captures: one for the batched chains, one a shard."""
    from pybnesian_tpu_torch import CLGNetwork
    from pybnesian_tpu_torch.inference import make_logdensity, sample_chains
    from pybnesian_tpu_torch.inference.hmc import (_shard_draws, nuts_chains,
                                                   sample_chains_sharded)
    from pybnesian_tpu_torch.parallel import make_mesh

    shards = C6_NUTS_SHARDS
    mesh = make_mesh({"data": shards}, devices=[torch.device("cuda:0")]
                     * shards)
    dim, samples_n, warmup, depth = C6_NUTS
    kw = dict(num_samples=samples_n, num_warmup=warmup, max_depth=depth)

    def logdensity(theta):
        return -0.5 * torch.sum(torch.square(theta - 1.0))

    init = torch.zeros(dim, device="cuda")
    short = dict(num_samples=5, num_warmup=5, max_depth=depth)
    sample_chains_sharded(logdensity, init, 4, mesh, method="nuts", **short)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, info = sample_chains_sharded(logdensity, init, 4, mesh,
                                          method="nuts", **kw)
    samples = samples.cpu()
    wall = time.perf_counter() - t0
    inits, seeds = _shard_draws(init, 4, shards, shards)
    worst, same = 0.0, True
    for s in range(shards):
        gen = torch.Generator(device="cuda").manual_seed(seeds[s])
        one, _ = nuts_chains(logdensity, inits[s: s + 1], gen, **kw)
        one = one.cpu()
        same &= bool(torch.equal(samples[s: s + 1], one))
        worst = max(worst, float((samples[s: s + 1] - one).abs().max()))
    if not (bool(torch.isfinite(samples).all()) and worst <= 1e-5):
        raise AssertionError(f"sharded NUTS: a shard differs from its own "
                             f"nuts_chains run by {worst}")
    say("16 parallel", case="sample_chains_sharded config6", shards=shards,
        dim=dim, samples=samples_n, warmup=warmup, max_depth=depth,
        wall_s=f"{wall:.4f}", graph_captures=shards,
        samples_per_s=f"{shards * samples_n / wall:.2f}",
        mean_leapfrogs=repr(np.round(info["mean_leapfrogs"].cpu().numpy(),
                                     2).tolist()),
        max_abs_diff_vs_own_run=f"{worst:.3e}", bit_equal=same,
        card=repr(card["smi"]))

    model = CLGNetwork(["A", "X", "Y"], [("A", "X"), ("X", "Y")])
    logp, _, init5 = make_logdensity(model, config5_frame(), dtype=np.float64)
    runs = {
        "sample_chains batched": lambda **k: sample_chains(
            logp, init5, torch.Generator(device="cuda").manual_seed(2),
            num_chains=shards, method="nuts", **k),
        "sample_chains_sharded": lambda **k: sample_chains_sharded(
            logp, init5, 2, mesh, method="nuts", **k)}
    for label, draw in runs.items():
        draw(num_samples=5, num_warmup=5, max_depth=NUTS_DEPTH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chains, cinfo = draw(num_samples=C5_SHARDED_SAMPLES,
                             num_warmup=C5_SHARDED_WARMUP,
                             max_depth=NUTS_DEPTH)
        chains = chains.cpu()
        wall = time.perf_counter() - t0
        if not bool(torch.isfinite(chains).all()):
            raise AssertionError(f"{label} at config 5: a non-finite sample")
        say("16 parallel", case=f"{label} config5", chains=shards,
            samples=C5_SHARDED_SAMPLES, warmup=C5_SHARDED_WARMUP,
            graph_captures=shards if "sharded" in label else 1,
            wall_s=f"{wall:.4f}",
            samples_per_s=f"{shards * C5_SHARDED_SAMPLES / wall:.2f}",
            mean_leapfrogs=repr(np.round(
                cinfo["mean_leapfrogs"].cpu().numpy(), 2).tolist()),
            card=repr(card["smi"]))


def nccl_check(torch, card):
    """A one-rank NCCL process group on the card: an all-reduce through
    it, then (c) on ``global_mesh`` of 8 virtual shards."""
    import socket

    from pybnesian_tpu_torch.runtime import distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    if not distributed.initialize(f"127.0.0.1:{port}", 1, 0):
        raise AssertionError("initialize did not start a process group")
    try:
        backend = torch.distributed.get_backend()
        x = torch.arange(4.0, device="cuda")
        torch.distributed.all_reduce(x)
        if backend != "nccl" or x.tolist() != [0.0, 1.0, 2.0, 3.0]:
            raise AssertionError(f"one-rank group: backend {backend}, "
                                 f"all_reduce gave {x.tolist()}")
        summary = distributed.process_summary()
        mesh = distributed.global_mesh(local_devices=["cuda:0"]
                                       * MESH_SHARDS)
        sharded_bic_check(torch, card, mesh,
                          "(g) global_mesh bic + lg_fit")
    finally:
        distributed.shutdown()
    say("16 parallel", case="(g) one-rank process group", backend=backend,
        summary=repr(summary), wall_s=f"{time.perf_counter() - t0:.2f}")


def phase_parallel(torch, card):
    """The multi-device layer at config 6's sizes on virtual shards of the
    card (a)-(g), and on the real mesh over every card (h) where there is
    more than one. Returns the ``parallel`` path's launches (the sharded
    calls and the dry run) and each kernel's largest error against its
    plain version at the shapes launched."""
    from pybnesian_tpu_torch.entry import dryrun_multichip
    from pybnesian_tpu_torch.parallel import make_mesh
    from pybnesian_tpu_torch.runtime import default_mesh, device_info

    t_phase = time.perf_counter()
    reset_counts()
    info = device_info()
    mesh = default_mesh()
    if info["backend"] != "cuda" or mesh.home != torch.device("cuda:0"):
        raise AssertionError(f"device_info {info}, default mesh {mesh}")
    say("16 parallel", case="(a)", device_info=repr(info),
        default_mesh=repr(mesh))
    counted = Counted(torch)
    cuda0 = torch.device("cuda:0")
    fam8 = make_mesh({"data": 1, "fam": MESH_SHARDS},
                     devices=[cuda0] * MESH_SHARDS)
    sharded_cv_check(torch, card, counted, fam8,
                     config6_cv_inputs(torch, C6_FAMS_PER_SHARD
                                       * MESH_SHARDS), "(b) config6 ckde_cv")
    bench = make_data()
    names = list(bench)
    bench_cols = [[names.index(c) for c in (*ps, v)]
                  for v, ps in families(len(names))]
    fam5 = make_mesh({"data": 1, "fam": 5}, devices=[cuda0] * 5)
    sharded_cv_check(torch, card, counted, fam5, fold_inputs(
        torch, np.stack([bench[c] for c in names], 1), bench_cols, 10,
        np.random.default_rng(0), pad=1), "(b) bench.py ckde_cv")
    data8 = make_mesh({"data": MESH_SHARDS, "fam": 1},
                      devices=[cuda0] * MESH_SHARDS)
    sharded_bic_check(torch, card, data8, "(c) bic + lg_fit")
    kde_slogl_check(torch, card, counted, data8, "(d) kde_slogl")
    sharded_nuts_check(torch, card)
    t0 = time.perf_counter()
    counted.run(lambda: dryrun_multichip(MESH_SHARDS,
                                         devices=[cuda0] * MESH_SHARDS))
    say("16 parallel", case="(f) dryrun_multichip", n_devices=MESH_SHARDS,
        virtual_shards_of="cuda:0", passed=True,
        wall_s=f"{time.perf_counter() - t0:.2f}")
    nccl_check(torch, card)
    cards = torch.cuda.device_count()
    if cards > 1:
        every = [torch.device("cuda", i) for i in range(cards)]
        real = make_mesh({"data": 1, "fam": cards}, devices=every)
        sharded_cv_check(torch, card, counted, real, config6_cv_inputs(
            torch, C6_FAMS_PER_SHARD * cards), "(h) real-mesh ckde_cv")
        real_data = make_mesh({"data": cards, "fam": 1}, devices=every)
        sharded_bic_check(torch, card, real_data,
                          "(h) real-mesh bic + lg_fit")
        kde_slogl_check(torch, card, counted, real_data,
                        "(h) real-mesh kde_slogl")
    else:
        say("16 parallel", case="(h) real mesh over every card",
            run=False, reason=f"{cards} card visible")
    for name in ("ckde_cv_pairs", "kde_logl"):
        if counted.launches[name] == 0:
            raise AssertionError(f"the parallel path did not launch {name}")
    errs = hold_recorded(torch, counted.rec, counted.launches, "parallel",
                         "16 parallel kernel")
    say("16 parallel", launches=counted.launches,
        wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return counted.launches, errs


def main():
    import torch

    t_start = time.perf_counter()
    card = phase_environment(torch)
    from pybnesian_tpu_torch import DataFrame

    stamped = phase_build()
    k = 10
    data = make_data()
    frame32 = DataFrame.wrap(data)
    frame64 = DataFrame.wrap(
        {c: v.astype(np.float64) for c, v in data.items()})
    pairs_args = main_path_pair_inputs(torch, frame32, k)
    pairs_cases = phase_kernel(torch, pairs_args, card)
    phase_selfcheck()
    cv_launches, whiten, reduce, lg_cv_err = phase_main_path(
        torch, frame32, frame64, k, card)
    kde = phase_kde_kernel(torch, card)
    probe, probe_launches = phase_exp_chain(torch, card, {
        "ckde_cv_pairs main-path-inputs": pairs_cases["main-path-inputs"],
        "ckde_cv_pairs config3b-shape": pairs_cases["config3b-shape"],
        "kde_logl tpu-docstring-shape": kde,
    })
    model_launches = phase_model_path(torch)
    hc_launches, hc_errs, lg = phase_hc(torch, card)
    ucv_launches, ucv_errs, ucv, ucv_search, ucv_starts = phase_ucv(
        torch, frame32, frame64, k, card, stamped)
    phase_discrete(torch)
    t_new = time.perf_counter()
    hybrid_launches, hybrid_errs = phase_hybrid(torch)
    dynamic_launches, dynamic_errs = phase_dynamic(torch)
    constraint_launches, constraint_errs = phase_constraint(torch)
    say("11-13", wall_s=f"{time.perf_counter() - t_new:.1f}")
    t_new = time.perf_counter()
    independence_launches, independence_errs = phase_independence(torch)
    phase_inference(torch)
    say("14-15", wall_s=f"{time.perf_counter() - t_new:.1f}")
    parallel_launches, parallel_errs = phase_parallel(torch, card)
    paths = {"cv": cv_launches, "probe": probe_launches,
             "model": model_launches, "hc": hc_launches,
             "ucv": ucv_launches, "hybrid": hybrid_launches,
             "dynamic": dynamic_launches, "constraint": constraint_launches,
             "independence": independence_launches,
             "parallel": parallel_launches}
    for name in ("ckde_cv_pairs", "kde_logl", "ucv_pair_sums",
                 "ckde_cv_whiten", "ckde_cv_fold_reduce", "ucv_search",
                 "ucv_starts"):
        if ucv_launches[name] == 0:
            raise AssertionError(f"the UCV path did not launch {name}")
    # every launch of paths 11-14 and 16 was held at its shape
    # (hold_recorded)
    new_errs = (hc_errs, ucv_errs, hybrid_errs, dynamic_errs,
                constraint_errs, independence_errs, parallel_errs)

    def worst(name, *errs):
        return max([*errs] + [e[name] for e in new_errs if name in e])

    pairs = dict(pairs_cases["main-path-inputs"], err=worst(
        "ckde_cv_pairs", *(c["err"] for c in pairs_cases.values())))
    kde = dict(kde, err=worst("kde_logl", kde["err"]))
    results = {"ckde_cv_pairs": pairs, "kde_logl": kde, "exp_chain": probe,
               "ucv_pair_sums": ucv,
               "ckde_cv_whiten": dict(whiten, err=worst("ckde_cv_whiten",
                                                        whiten["err"])),
               "ckde_cv_fold_reduce": dict(reduce, err=worst(
                   "ckde_cv_fold_reduce", reduce["err"])),
               "lg_cv_stats": dict(lg, err=worst("lg_cv_stats", lg["err"],
                                                 lg_cv_err)),
               "ucv_search": ucv_search,
               "ucv_starts": dict(ucv_starts, err=worst("ucv_starts",
                                                        ucv_starts["err"]))}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {p: counts[name] for p, counts in paths.items()
                   if counts[name]}
        if not by_path:
            raise AssertionError(f"{name}: launched on no path")
        result = results[name]
        bound_ms, by = bound(card, *result["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": result["err"],
            "ms": result["ms"], "batched_ms": result["batched_ms"],
            "plain_ms": result["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes" if by == "bytes" else "operations",
            # one efficient-attention call (#2) or two (#1, the UCV sums):
            # their logsumexp output; one torch.einsum of the LG kernel's
            # Gram stage; nothing computes the exp chain, the CV whitening,
            # the fold sums, the UCV search or its starts
            "library_ms": result.get("library_ms"),
        })
    say("all phases", wall_s=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
