"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port (never JAX, never ``repro``):

1. the card's name and power limit; TF32 off; the kernel library build
   (registers and spills from nvcc's report); K6, K7 and K8 each run only
   their own kernels (K8 its three launches, once each a call), and a
   paligemma-3b prefill runs K6 once per layer and no other attention
   kernel (torch.profiler, in a fresh process of this script:
   ``--lm-ran``);
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes (64 CUs x 40 WFs, 64 tables x 128 slots, 10 V/f
   states, 1024-block Table II programs), from numpy-seeded inputs: the
   PC-table pair (K1's I_pred and hit mask, K2's tables) at int64 and
   int32 slots with tensor and float scalars, each wrapper call one
   kernel launch (torch.profiler), and what a v1 epoch launches on the
   card; the fused epoch in families pc/reactive (K3), also at
   the README's 304 x 40; the fork family (K4) for every traced id in
   both math modes and in one call of 300 mixed rows, and at the
   managers' layout (16 CUs x 40 WFs, 16 tables, the two ``for_model``
   step programs: every traced id, and the four pcstall rows of a 2 x 2
   ``grid_report``); then each K4 row against K3 run as that row's
   mechanism (bit for bit, at another CTA width); K5 (the fork family
   with the reference's tiling: K4's kernels) at 304 x 40 in blocks of 38
   against the reference's blocked pair; rows alone against the same
   rows among 42 and among 8 (two CTA widths each), bit for bit; K6 at
   the glm4-9b and phi3-mini-3.8b prefills (bf16 and f32) and at the
   musicgen-medium, granite-moe-1b-a400m, qwen2-moe-a2.7b and
   hymba-1.5b prefills (bf16; hymba's with its 1024-token window) and at
   the paligemma-3b prefill (bf16 and f32: head dim 256, 8 over 1 heads,
   prefix-LM over its 256 patch embeddings), K7 at
   the rwkv6-3b prefill, and K8 (the selective scan) at the hymba-1.5b
   prefill, at a decode step (S = 1), at hymba-1.5b's training layout
   (B 4, S 4096; two calls bit for bit, timed beside its bound and split
   by its three launches) and with a chunk whose decay product
   underflows to 0, each from a non-zero state;
3. times of every kernel (the one method: ``scripts/devtime.py``):
   device time per call against its bound, the per-call time with the
   host, the plain version's and, for K6, ``scaled_dot_product_attention``
   (under K6's mask as a boolean tensor where the row has a window or a
   prefix);
   K1 and K2 as the v1 epoch calls them (int64 slots, 0-dim scalars),
   their kernels alone (torch.profiler) and the launch floor
   (``torch.cuda._sleep(1)`` by the same method);
   the epoch calls (K3, K4, K5) split by kernel (pass A, pass B,
   epilogue) and K7's into its kernel and its memset with torch.profiler;
   two K7 calls agree bit for bit, and two K8 calls; K8's backward kernel
   against its plain version (the reverse token loop) at hymba-1.5b's
   training layout (B 4, S 4096, 25 heads of 64, N 16) and at an odd one
   (head dim 16, N 8, S 1001), from a non-zero h0 and g_hout, two calls
   bit for bit, timed beside its bound; K7's backward kernel against its
   plain version and against autograd through K7's plain version at
   rwkv6-3b's training layout (B 4, T 4096, 40 heads of 64, chunk 128,
   u (H, hd)) and at an odd one (head dim 128 at chunk 64, u (B, H, hd)),
   both with a non-zero gS, two calls bit for bit, timed beside its bound
   and the plain version's time, and split by its three launches;
4. the quickstart path through ``examples_torch/quickstart.py``:
   ``run_workload`` of static17, crisp, pcstall and oracle on ``comd``
   for 600 epochs, with the fused epoch kernel's
   launches counted (crisp and pcstall run K3; static17 and the oracle
   run the unfused body, as in the reference); pcstall with
   ``use_pallas="v1"`` (the PC-table pair; its wall and ms per epoch);
   whole runs of the kernel engine (K3 for crisp and pcstall, the pair
   for pcstall v1) against the unfused engine;
5. the README's ``SimConfig(n_cu=304, n_wf=40, pallas_block_cu=38)``
   through ``run_workload`` with crisp and pcstall on K3, held against
   the unfused engine;
6. the registry's axis-liveness audit (22 audits on the host, timed
   alone), then the sweep path, the paper's Fig-15 suite through
   ``run_grid`` (ten
   workloads x eight mechanisms x 800 epochs, ``suite_metrics``): one K4
   call of 40 rows per epoch, no K3 launch, the reference's dispatch
   accounting, the paper's orderings, and each mechanism's geomean ED2P
   and mean accuracy beside the JAX reference's;
7. the sweep's bitwise contracts on the card (suite = one-point grid =
   per-point grid = streamed) and kernel grid against unfused grid;
8. the runtime path: ``DVFSService`` serving ``dvfs_request_stream(32,
   seed=7)`` at an MI300X-sized ``SimConfig(n_cu=304, n_wf=40,
   pallas_block_cu=38)`` for 400 epochs (the fork family in the
   reference's tiling, K5, one call per epoch; static17 unfused), jobs per second and latency
   percentiles, streamed rows bitwise equal to the one-shot ``run_grid``,
   and the mean report beside the JAX reference's; then
   ``DVFSManager.for_model`` for llama3-405b and qwen2-moe-a2.7b at its
   default 16 CUs (K4): ``report`` and a 2 x 2 ``grid_report``;
9. the LM serving path: ``launch.serve.serve`` of glm4-9b, rwkv6-3b,
   phi3-mini-3.8b, musicgen-medium (audio), granite-moe-1b-a400m and
   qwen2-moe-a2.7b (moe), hymba-1.5b (hybrid) and paligemma-3b (vlm: 256
   bf16 patch embeddings, then 1792 tokens) at their published widths
   and depths (random
   weights from a seed), batch 4, a 2048-token prompt, greedy tokens (16
   for the first two, 8 for the rest), telemetry streamed to
   ``DVFSService.for_model`` (K4 at 16 CUs): prefill seconds, decode ms
   per token, K6 (flash attention; head dim 128, 96 for phi3, 64 for
   musicgen, granite-moe and hymba, 256 with a 256-key prefix for
   paligemma) or K7 (chunked WKV) once per layer of the prefill, and for
   hymba K8 (the selective scan) once per layer of
   the prefill and of each decode step, the moe prefills' dropped pairs,
   finite logits, the DVFS
   report; the same serve without the DVFS stream; then per model a
   token-by-token decode of 256 tokens (4 for the moe models, where their
   prefill can drop no pair) against the prefill's logits, the model in
   f32 cut to its first 8 layers (a depth cut that keeps the script in its
   time with phase 12) to 2e-2 (as the reference's tests hold it) and in
   bf16 at full depth to a fixed
   limit (paligemma's on its text-only path at head dim 256: a token
   decode cannot rebuild a bidirectional prefix of patch embeddings), and
   where the device time of a prefill and of a decode step
   goes (K6/K7/K8, the MoE layer's expert products and its dispatch and
   combine, the other matrix products, the rest);
10. engine and grid wall times;
11. K4 against its plain version at the learn path's layout (32 CUs x
    40 WFs, 32 tables: the factory dataset's 32 pcstall rows and the
    deployment sweep's 16 crisp and 16 pcstall rows); then the learn
    path, ``repro_torch.learn``'s ``run_pipeline`` (the
    CLI's, with the reference's assertions) at the full
    ``DatasetConfig()`` (8 workloads x seeds (0, 1) x epoch_us (1, 10),
    32 CUs, 240 epochs, ~442k rows): the factory dataset through
    ``run_grid`` (PCSTALL's 32 rows on K4, one call per epoch; the oracle
    unfused), a second generation bitwise equal to the first, both heads
    fitted (400 steps, batch 4096, probe loss falling), registered with
    the axis-liveness audit (two audits each), and swept by
    ``run_grid(dedup=True)`` beside crisp and pcstall over the 8
    workloads x {ed2p, deadline05} (K4 for crisp and pcstall, at most two
    fork-family builds, the reference's ``DISPATCH_ROWS``); every learned
    grid row bit for bit its per-point ``run_sim``; each head's
    validation choice accuracy, deployed mean frequency and ED2P against
    pcstall per workload (reported, not gated); PCSTALL's traces of the
    factory sweep on the kernel engine against the unfused engine, every
    element at the kernel-vs-plain limits; and a 2-workload dataset from
    each engine, PCSTALL's rows element by element;
12. the training path: K6's gradient (``FlashAttention``: the forward on
    K6, which also writes each row's log-sum-exp, the backward on K6's
    backward kernels, ``csrc/flash_attention_bwd.cu``) against autograd
    through the plain version in f32, from f32 and bf16 inputs, at
    musicgen-medium's training layout (B 4, S 4096, 24 heads of 64,
    causal), paligemma's (B 1, S 2048, 8 over 1 heads of 256, prefix 256)
    and hymba's (B 1, S 2048, 25 over 5 heads of 64, window 1024), two
    backward calls bit for bit; K6 at musicgen's training layout against
    its plain version, timed beside its bound and the library, and K6's
    backward kernel there against its plain version on the same
    log-sum-exp, timed beside its bound, the plain version's time and the
    library's backward (autograd of ``scaled_dot_product_attention``);
    musicgen-medium at full
    width through ``launch.train.train`` (TRAIN_4K's 4096 tokens, its 256
    sequences a step cut to 8 in 2 microbatches, 4 steps, warmup 1,
    DVFS on): finite losses, the first within 1.0 of ln 2048, every
    parameter moved, finite grad norms, 192 K6 launches a step (48
    layers x 2 microbatches x forward and remat recompute) and 96 of the
    backward, the DVFS
    report, step seconds, tokens/s and peak memory, the step counted on
    meta tensors by ``repro_torch.roofline`` (FLOPs and bytes, the
    model-FLOP share of the measured step, the useful ratio, its K6 and
    K6 backward calls equal to the card's 192 and 96 launches a step;
    counted by ``python3 chip_smoke.py --roofline``, a child process on
    the host started as the phase begins), the final checkpoint
    (~21.8 GB of npz under a temporary directory, after a check of the
    free disk space) restored bit for bit, save and restore seconds, one
    step's device time by class (K6, the attention backward's kernels,
    GEMMs, the rest); then granite-moe-1b-a400m through ``make_train_step``
    (2 steps at 4 x 2048): finite loss, MoE aux loss and grad norm, every
    parameter moved; then hymba-1.5b and rwkv6-3b at full width through
    ``launch.train.train`` (8 x 4096 tokens a step in 2 microbatches, 2
    steps, remat full, DVFS on, no checkpoint): finite losses, the first
    within 1.0 of ln V, finite grad norms, every parameter moved, per
    layer and microbatch K6 and K8 twice and K6's and K8's backwards once
    (hymba)
    or K7 twice and its backward once (rwkv), step seconds, tokens/s and
    peak memory, and one step's device time by class (K6, the attention
    backward, K7, K7's backward, K8, K8's backward, GEMMs, the rest);
then the kernel summary. Each phase prints the seconds since the start.

Prints a ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line; so does a machine without CUDA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))

import torch  # noqa: E402

import devtime as DT  # noqa: E402
from examples_torch import quickstart as QUICKSTART  # noqa: E402

from repro_torch import no_tf32  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import power as PWR  # noqa: E402
from repro_torch.analysis import deps as DEPS  # noqa: E402
from repro_torch.core import mechanisms as MECH  # noqa: E402
from repro_torch.core import predictors as PRED  # noqa: E402
from repro_torch.core import simulate as SIM  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.core.workloads import Program, get_workload  # noqa: E402
from repro_torch.configs import TRAIN_4K, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train.train_step import (init_state,  # noqa: E402
                                          make_train_step)
from repro_torch.data.pipeline import dvfs_request_stream  # noqa: E402
from repro_torch.dvfs_runtime.manager import DVFSManager  # noqa: E402
from repro_torch.dvfs_runtime.service import DVFSService  # noqa: E402
from repro_torch.dvfs_runtime.telemetry import arch_program  # noqa: E402
from repro_torch.kernels import epoch_fused as KEF  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rwkv_chunk as RC  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.launch.input_specs import input_specs  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.roofline.analysis import analyze, roofline_terms  # noqa: E402
from repro_torch.roofline.report import model_flops  # noqa: E402
from repro_torch.learn import dataset as LDS  # noqa: E402
from repro_torch.models import model as LM  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.kernels import pc_table as KPT  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
# each kernel's work and the H100's data-sheet peaks (the roofline bound
# of each kernel)
from repro_torch.roofline.work import (PEAK_FLOPS_BF16,  # noqa: E402
                                       PEAK_FLOPS_F32, attention_bwd_flops,
                                       attention_flops, bound_ms,
                                       epoch_flops, fork_flops, nbytes,
                                       rwkv_bwd_flops, rwkv_flops,
                                       scan_bwd_flops, scan_flops)

# main-path shapes (SimConfig defaults)
CU, WF, NF, T_TABLES, ENTRIES, P = 64, 40, 10, 64, 128, 1024
N_EPOCHS = 600
# v1 epochs whose launches on the card phase 2 counts
V1_PROFILED = 5
# kernel vs plain version on the card: discrete outputs equal; floats
# |a - b| <= ATOL + RTOL |b| (the two sum in different orders: warp trees
# and a fixed-order block reduction against torch's reductions)
RTOL, ATOL = 1e-5, 1e-4
# whole runs, kernel engine vs unfused engine: run-level work and energy
AGG_TOL = 1e-3
EPOCH_FAMS = [("pc", False, None), ("pc", True, None),
              ("reactive", False, "stall"), ("reactive", False, "crisp"),
              ("reactive", True, None)]
# the paper's Fig-15 suite as benchmarks/paper_figs.py runs it
# (WORKLOADS_FAST and FAST_MECHS, copied: this script imports nothing of
# the reference)
FIG15_WORKLOADS = ["comd", "hpgmg", "lulesh", "xsbench", "hacc", "quickS",
                   "dgemm", "BwdBN", "BwdPool", "FwdSoft"]
FIG15_MECHS = ("static13", "static17", "static22", "crisp", "accreac",
               "pcstall", "accpc", "oracle")
FIG15_EPOCHS = 800
# the JAX reference's Fig-15 numbers on the same suite, computed on the CPU
# by `PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/fig15_reference.py`
# (jax 0.9.0): geomean ED2P vs static 1.7 GHz, mean prediction accuracy
REF_FIG15_ED2P = {"static13": 1.0833245515823364, "static17": 1.0,
                  "static22": 0.9346031546592712, "crisp": 0.882896900177002,
                  "accreac": 0.8576440811157227,
                  "pcstall": 0.8805471658706665, "accpc": 0.862924337387085,
                  "oracle": 0.862209677696228}
REF_FIG15_ACC = {"crisp": 0.8202141046524047, "accreac": 0.8211552262306213,
                 "pcstall": 0.9707660734653473, "accpc": 0.9714100241661072,
                 "oracle": 0.9980913400650024}
# the port's geomean ED2P against the reference's, per mechanism: the
# closed loop is chaotic and the two engines round differently (ROADMAP,
# "Stated differences"); on an H100 80GB HBM3 at 700 W the gap reads at
# most 0.0016
FIG15_ED2P_GAP = 2e-3
# what the reference's run_grid counts in DISPATCH_ROWS for that suite:
# ten workloads x (four traced ids | one spec) on a one-point grid
FIG15_DISPATCH_ROWS = {"grid_forks": 40, "grid_static13": 10,
                       "grid_static17": 10, "grid_static22": 10,
                       "grid_oracle": 10}
# the smaller grid of the exactness phase
EXACT_WORKLOADS = ["comd", "hacc", "dgemm"]
EXACT_GRID = {"epoch_us": [1.0, 10.0], "objective": ["ed2p", "edp"]}
EXACT_EPOCHS = 200
# the runtime path: an AMD MI300X-sized GPU (8 XCDs x 38 CUs = 304 CUs),
# one XCD per K5 block, 40 WFs per CU and per-CU V/f domains as in the
# paper; the request stream and service knobs of ROADMAP's runtime slice
SVC_SIM = SIM.SimConfig(n_cu=304, n_wf=40, pallas_block_cu=38, n_epochs=400)
SVC_REQUESTS, SVC_SEED, SVC_BATCH, SVC_COALESCE_S = 32, 7, 8, 0.001
SVC_WORKLOADS = ("comd", "xsbench", "lulesh", "minife")
# the JAX reference's mean report over the same stream, computed on the CPU
# by `PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/service_reference.py`
# (jax 0.9.0); printed beside the port's, not gated (the closed loop is
# chaotic, and the reference runs its unfused engine)
REF_SVC = {"ed2p_norm": 0.9187865853309631,
           "energy_norm": 1.0860943794250488,
           "delay_norm": 0.9250905513763428,
           "accuracy": 0.9696191046386957}
MANAGER_ARCHS = ("llama3-405b", "qwen2-moe-a2.7b")
MANAGER_CU = 16  # DVFSManager.for_model's default
# the LM serving path: both models at their published widths and depths,
# batch 4, a prompt of 2048 tokens (it takes both kernels' paths in the
# reference: the chunked WKV needs S > 128, the block-pair attention
# S > 1024), 32 greedy tokens, telemetry to DVFSService.for_model
SERVE_ARCHS = ("glm4-9b", "rwkv6-3b", "phi3-mini-3.8b", "musicgen-medium",
               "granite-moe-1b-a400m", "qwen2-moe-a2.7b", "hymba-1.5b",
               "paligemma-3b")
SERVE_BATCH, SERVE_PROMPT = 4, 2048
# greedy tokens per serve, within the run's time limit
SERVE_GEN = {"glm4-9b": 16, "rwkv6-3b": 16, "phi3-mini-3.8b": 8,
             "musicgen-medium": 8, "granite-moe-1b-a400m": 8,
             "qwen2-moe-a2.7b": 8, "hymba-1.5b": 8, "paligemma-3b": 8}
# K6's row of each attention model's prefill (batch 4, 2048 tokens in
# bf16, the model's sliding window or prefix where it has one) and the
# numpy seed of its inputs; those of K6_F32 also in f32
K6_ROWS = {"glm4-9b": ("flash_attention", 41),
           "phi3-mini-3.8b": ("flash_attention[hd96]", 43),
           "musicgen-medium": ("flash_attention[musicgen-medium]", 44),
           "granite-moe-1b-a400m": ("flash_attention[granite-moe-1b-a400m]",
                                    45),
           "qwen2-moe-a2.7b": ("flash_attention[qwen2-moe-a2.7b]", 46),
           "hymba-1.5b": ("flash_attention[hymba-1.5b]", 47),
           "paligemma-3b": ("flash_attention[paligemma-3b]", 49)}
# K8 at the hymba-1.5b prefill (its mamba heads: 25 heads of 64 over the
# d_model = 1600 channels, state 16) and the numpy seed of its inputs
K8_ARCH, K8_SEED = "hymba-1.5b", 48
K6_F32 = ("glm4-9b", "phi3-mini-3.8b", "paligemma-3b")
# the vlm whose whole prefill --lm-ran profiles, and the names of an
# attention kernel of torch's (SDPA's flash, memory-efficient or cuDNN
# kernels) that must not stand in for K6 there
VLM_ARCH = "paligemma-3b"
LIBRARY_ATTENTION = ("fmha", "flash_fwd", "attention", "cudnn", "sdpa",
                     "efficient")
# the README's 304-CU configuration on the one-row path (K3)
WIDE_SIM = SIM.SimConfig(n_cu=304, n_wf=40, pallas_block_cu=38,
                         n_epochs=300)
# decode token by token against the prefill's logits, as the reference's
# tests/test_models.py holds it (rtol = atol = 2e-2; the model in f32)
DECODE_S, DECODE_TOL = 256, 2e-2
# the moe models' decode check runs at a 4-token prompt: a pair drops only
# where an expert takes more than its capacity max(int(S k 1.25 / E), 4)
# of the prefill's S k pairs, and an expert takes at most one pair per
# token, so at S <= 4 nothing can drop whatever the routing. At 256 the
# random weights route most tokens alike (the causal attention's running
# mean is a component every token shares): on an H100 80GB HBM3 this
# script reads 25,664 of 49,152 pairs dropped for granite-moe (capacity
# 80 against a mean load of 64) and 7,299 of 24,576 for qwen2-moe
# (capacity 21 against 17). The prefill drops pairs that decode (one
# token, capacity 4, k distinct experts) keeps, so the two differ there by
# the reference's own semantics; the drops at 256 and at the 2048-token
# serve are printed.
MOE_DECODE_S = 4
# the f32 decode check runs on the model cut to its first 8 layers (depth
# only: every width and every kernel of a layer stay), so that the script
# keeps its time limit with the training phase (12); the bf16 check runs
# at full depth
F32_DECODE_LAYERS = 8
# the same check with the models in bf16, as they are served, holds the
# largest |decode - prefill| logit gap to a fixed limit. In bf16 at full
# width the arithmetic alone moves the logits: on an H100 80GB HBM3 at
# 700 W scripts/decode_gap_probe.py reads 0.359 (glm4-9b) and 0.319
# (rwkv6-3b), and the same prefill in a batch of 4 against alone, where
# only cuBLAS's summation order changes, 0.319 and 0.289. The limit is
# ~1.4x the largest sound reading; a fault in a kernel or a cache moves
# logits of max |logit| 4.5-6.3 by their own size.
BF16_DECODE_TOL = 0.5
# K6 against its plain version: f32 to 2e-5 (the two sum in different
# orders); bf16 at the output's rounding (one bf16 ulp, 2^-7 relative,
# between two f32 results that round apart). K7 to 1e-4, the reference's
# bound for its chunked kernel against the exact scan.
K6_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
K7_TOL = 1e-4
# cuBLAS's matrix-product kernels by name (nvjet: CUDA 12.8's Hopper GEMMs)
GEMM_NAMES = ("gemm", "gemv", "nvjet", "cutlass", "xmma")

# the learn path (phase 11) at DatasetConfig()'s widths: 32 CUs x 40 WFs,
# a table per CU, eight workloads
LEARN_CU = 32
LEARN_WORKLOADS = list(LDS.DatasetConfig().workloads)
# PCSTALL's trace channels, held kernel engine against unfused engine
# element by element at the kernel-vs-plain limits (the kernel follows the
# unfused body's arithmetic: whole runs within 1.4e-10 over 600 epochs).
# true_sens is the difference of the two end fork rows' instructions over
# (f_max - f_min) T, which the kernel sums in the lean order: its rounding
# scales with the rows, not with the difference, so it is held to ATOL +
# RTOL x the run's largest |true_sens| (on an H100 80GB HBM3 at 700 W it
# reads 3.4e-3, 3.8x the elementwise limit, where |true_sens| reaches
# ~3700)
LEARN_TRACE_CHANNELS = ("work", "energy", "err", "fidx", "true_sens",
                        "hit_rate")
# the two engines' 2-workload datasets, PCSTALL's rows: each feature and
# target column to ATOL + RTOL x the column's largest |value|. A column is
# an EMA or a difference of trace channels (i0 = work / T - sens x f), so
# its error scales with the channels', not with its own value after the
# cancellation: on the CPU the lean true_sens moves i0 by 3.8e-3 where
# work / T reaches 6.0e4. The labels' share is stated apart (a label is
# an argmin over costs computed from y)
LEARN_FIDX_AGREE = 0.999
# the training phase (12): musicgen-medium at full width through
# launch.train.train, TRAIN_4K's 4096 tokens with its 256 sequences a step
# cut to 8 (two microbatches of 4) so that a step fits the run's time
TRAIN_ARCH = "musicgen-medium"
TRAIN_SHAPE = ShapeConfig("train_card", TRAIN_4K.seq_len, 8, "train")
TRAIN_STEPS, TRAIN_MB = 4, 2
K6_TRAIN_ROW = "flash_attention[musicgen-medium train]"
K6_BWD_ROW = "flash_attention_bwd[musicgen-medium train]"
# the ssm and hybrid families at full width through launch.train.train:
# the same 8 x 4096 tokens a step in 2 microbatches, 2 steps, DVFS on, no
# checkpoint (the musicgen round trip covers the module)
SCAN_TRAIN_ARCHS = ("hymba-1.5b", "rwkv6-3b")
SCAN_TRAIN_STEPS, SCAN_TRAIN_MB = 2, 2
# K8's backward against its plain version, (B, S, H, hd, N): hymba-1.5b's
# training layout (a microbatch of 4 x 4096), an odd one (head dim 16,
# state 8, S not a multiple of the kernel's 32-token chunk), S one chunk,
# one chunk and a token, and under one chunk, and a chunk whose decay
# product underflows to 0 (K8_BWD_UNDERFLOW: dt in (2, 3) at A = -2 over
# the second chunk); each output within 1e-4 of its largest magnitude +
# 1e-5 |ref| (the kernel sums over channels, heads and tokens in other
# orders than the plain version)
K8_BWD_ROW = "ssm_scan_bwd"
K8_BWD_LAYOUTS = {"hymba-1.5b train": (4, 4096, 25, 64, 16),
                  "odd": (2, 1001, 3, 16, 8),
                  "S = chunk": (2, 32, 25, 64, 16),
                  "S = chunk + 1": (2, 33, 5, 32, 8),
                  "S < chunk": (3, 20, 4, 128, 16),
                  "underflow": (2, 101, 25, 64, 16)}
K8_BWD_UNDERFLOW = "underflow"
K8_BWD_TOL = (1e-5, 1e-4)
K8_BWD_KERNELS = ("ssm_scan_bwd_increments", "ssm_scan_bwd_chains",
                  "ssm_scan_bwd_grads")
# K8's three launches, and its layouts past the serve path's against its
# plain version, (B, S, H, hd, N, underflow): hymba-1.5b's training
# layout (a microbatch of 4 x 4096) and a chunk whose decay product
# underflows to 0 (dt in (2, 3) at A = -2 over the second FWD_CHUNK-token
# chunk)
K8_KERNELS = ("ssm_scan_fwd_increments", "ssm_scan_fwd_chains",
              "ssm_scan_fwd_outputs")
K8_FWD_LAYOUTS = {"train": (4, 4096, 25, 64, 16, False),
                  "underflow": (2, 3 * SS.FWD_CHUNK + 5, 25, 64, 16, True)}
# K7's backward kernel against its plain version and against autograd
# through K7's plain version, (B, T, H, hd, chunk, u per batch row):
# rwkv6-3b's training microbatch (4 x 4096, 40 heads of 64, chunk 128, u
# (H, hd)) and an odd layout (head dim 128 at chunk 64, u (B, H, hd), four
# chunks), both with a non-zero gS; each gradient to 1e-4 of its largest
# magnitude (products in three TF32 terms, and sums over the chunk and
# the chunks in other orders; TF32 off in the plain versions)
K7_BWD_ROW = "rwkv_chunked_bwd"
K7_BWD_LAYOUTS = {"rwkv6-3b train": (4, 4096, 40, 64, 128, False),
                  "odd": (2, 256, 3, 128, 64, True)}
K7_BWD_TOL = 1e-4
K7_BWD_KERNELS = ("rwkv_chunk_bwd_increments", "rwkv_chunk_bwd_chains",
                  "rwkv_chunk_bwd_grads")
# granite-moe-1b-a400m through make_train_step: 2 steps at 4 x 2048
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN_SHAPE = ShapeConfig("train_moe", 2048, 4, "train")
# K6's gradient at the zoo's training layouts: (B, S, H, Hkv, hd, window,
# prefix); musicgen's (GQA-free, causal), paligemma's (the prefix, head
# dim 256), hymba's (GQA 5, the window)
K6_GRAD_LAYOUTS = {"musicgen-medium": (4, 4096, 24, 24, 64, 0, 0),
                   "paligemma-3b": (1, 2048, 8, 1, 256, 0, 256),
                   "hymba-1.5b": (1, 2048, 25, 5, 64, 1024, 0)}
# dq, dk, dv of the Function against autograd through the plain version
# in f32, over each one's largest magnitude: f32 to 1e-4 (sums of up to
# 4096 terms in other orders; TF32 off), bf16 to 2e-2 (K6's bf16 output
# enters D = rowsum(dout * out), and each gradient is rounded to bf16: a
# few bf16 ulps of the largest element)
K6_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FAILURES = []
START = time.perf_counter()
# the kernels of each epoch call (csrc/epoch_fused.cu): passes A and B,
# and the epilogue for the families with a table
TILED = {"pc": ("epoch_pass_a<0>", "epoch_pass_b<0>", "epoch_epilogue<0>"),
         "reactive": ("epoch_pass_a<1>", "epoch_pass_b<1>"),
         "fork": ("epoch_pass_a<2>", "epoch_pass_b<2>", "epoch_epilogue<2>")}


def mark(phase: str) -> None:
    """Print the seconds since the script started, as a phase starts."""
    print(f"[phase {phase}] starts at {time.perf_counter() - START:.1f} s",
          flush=True)


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, *, rtol=RTOL, atol=ATOL, scale=None):
    """Kernel output against plain output: returns the max abs error.
    ``scale`` (broadcast to ``want``) adds ``rtol * scale`` to the limit
    for a difference of larger operands, held at their magnitude."""
    g, w = got.detach().cpu(), want.detach().cpu()
    if not g.is_floating_point():
        same = torch.equal(g, w.to(g.dtype))
        bad = int((g != w.to(g.dtype)).sum())
        check(same, f"{name}: equal ({bad} differ)")
        return 0.0
    err = (g.double() - w.double()).abs()
    lim = atol + rtol * w.double().abs()
    if scale is not None:
        lim = lim + rtol * scale.detach().cpu().double()
    worst = float((err / lim).max()) if err.numel() else 0.0
    check(bool((err <= lim).all()),
          f"{name}: max_abs_err {float(err.max()):.3e} "
          f"(worst err/limit {worst:.3f})")
    return float(err.max())


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def table_case(seed, dev, cu=CU, tables=T_TABLES):
    CU, T_TABLES = cu, tables
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    tbl = [f32(rng.uniform(0, 60, (T_TABLES, ENTRIES))),
           f32(rng.uniform(0, 40, (T_TABLES, ENTRIES))),
           f32((rng.uniform(size=(T_TABLES, ENTRIES)) > 0.4)
               * rng.integers(1, 9, (T_TABLES, ENTRIES)))]
    tid = torch.as_tensor(np.arange(CU) % T_TABLES, dtype=torch.int32).to(dev)
    idx = torch.as_tensor(rng.integers(0, ENTRIES, (CU, WF)),
                          dtype=torch.int32).to(dev)
    fb = [f32(rng.uniform(0, 60, (CU, WF))), f32(rng.uniform(0, 40, (CU, WF)))]
    return tbl, tid, idx, fb


def epoch_case(family, fork_est, model, seed, dev, cu=CU, tables=T_TABLES):
    """One full ``epoch_fused`` operand set: the comd program plus
    randomised carry state (``cu`` CUs x 40 WFs, CU c on table c %
    ``tables``)."""
    CU = cu
    rng = np.random.default_rng(seed)
    prog = get_workload("comd", P=P, device=dev)
    sim = SIM.SimConfig()
    ax = sim.axes(dev)
    F = PWR.freqs_ghz(ax.power, NF)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    pos = f32(rng.uniform(0, P * 4 * 3, (CU, WF)))
    eps = SIM._epoch_noise(pos, P, 0)
    args = (prog.i0_rate, prog.sens_rate, prog.cum3.T.contiguous(), pos, F,
            eps, F[torch.as_tensor(rng.integers(0, NF, CU)).to(dev)]
            .contiguous(), f32(rng.uniform(0, 50, CU)), f32(30.0))
    kw = dict(p_blocks=P, epoch_us=ax.epoch_us, sigma=ax.sigma,
              cap_per_ghz=ax.cap_per_ghz, membw=ax.membw, obj=ax.obj,
              lat_us=PWR.transition_latency_us(ax.epoch_us, ax.power),
              power=ax.power, family=family, fork_estimator=fork_est,
              cu_model=model, offset_blocks=sim.offset_blocks,
              table_ema=ax.table_ema)
    if family == "pc":
        tbl, tid, _, fb = table_case(seed + 1, dev, cu, tables)
        kw.update(table=PRED.PCTable(*tbl), tid=tid, wf_i0=fb[0],
                  wf_sens=fb[1])
    else:
        kw.update(react_i0=f32(rng.uniform(500, 3000, CU)),
                  react_sens=f32(rng.uniform(300, 2000, CU)))
    return args, kw


def fork_rows_case(ids, names, seed, dev, *, lens=None, cu=CU, wf=WF,
                   tables=T_TABLES, objs=("ed2p", "edp", "perfcap10"),
                   regimes=(PWR.PowerConfig(),
                            PWR.PowerConfig(f_max=2.0, c_eff=1.1))):
    """``epoch_fused_rows`` operands at the main shapes (or ``cu`` x
    ``wf`` with ``tables`` tables, CU c on table c % tables): one row per
    traced id in ``ids``, row r on program ``names[r % len]`` (a Table II
    workload name, or a ``Program``) (logical lengths ``lens``, padded to
    the longest), objective ``objs[r % len]`` and power regime
    ``regimes[r % len]``, other sweep scalars drawn from a numpy seed."""
    CU, WF, T_TABLES = cu, wf, tables
    rng = np.random.default_rng(seed)
    R = len(ids)
    lens = lens or [n.n_blocks if isinstance(n, Program) else P
                    for n in names]
    progs = [n if isinstance(n, Program) else get_workload(n, P=L, device=dev)
             for n, L in zip(names, lens)]
    Pp = max(lens)
    padded = [SW.pad_program(p, Pp) for p in progs]
    prog_idx = np.arange(R) % len(names)
    F, scal, pw = [], [], []
    for r in range(R):
        reg = regimes[r % len(regimes)]
        epoch_us = float(rng.choice([1.0, 10.0]))
        F.append(PWR.freqs_ghz(reg, NF).numpy())
        scal.append([epoch_us, 0.06, 5500.0, 160_000.0,
                     float(rng.choice([0.5, 0.3])),
                     *SIM.objective_weights(objs[r % len(objs)]),
                     PWR.transition_latency_us(epoch_us, reg)])
        pw.append([getattr(reg, f) for f in PWR.PowerAxes._fields])
    p_blocks = np.asarray(lens, np.int32)[prog_idx]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

    F = np.asarray(F, np.float32)
    pos = f32(np.stack([rng.uniform(0, L * 4 * 3, (CU, WF))
                        for L in p_blocks]))
    eps = SIM._epoch_noise(pos, i32(p_blocks)[:, None, None],
                           i32(rng.integers(0, 3, R))[:, None, None])
    tbl = [f32(rng.uniform(0, 60, (R, T_TABLES, ENTRIES))),
           f32(rng.uniform(0, 40, (R, T_TABLES, ENTRIES))),
           f32((rng.uniform(size=(R, T_TABLES, ENTRIES)) > 0.4)
               * rng.integers(1, 9, (R, T_TABLES, ENTRIES)))]
    args = (torch.stack([p.i0_rate for p in padded]),
            torch.stack([p.sens_rate for p in padded]),
            torch.stack([p.cum3.T for p in padded]).contiguous(),
            i32(prog_idx), pos, f32(F), eps.contiguous(),
            f32(F[np.arange(R)[:, None], rng.integers(0, NF, (R, CU))]),
            f32(rng.uniform(0, 50, (R, CU))), f32(rng.uniform(20, 40, R)))
    kw = dict(p_blocks=i32(p_blocks), mech=i32(ids), scal=f32(scal),
              power=f32(pw), table=PRED.PCTable(*tbl),
              tid=i32(np.arange(CU) % T_TABLES),
              wf_i0=f32(rng.uniform(0, 60, (R, CU, WF))),
              wf_sens=f32(rng.uniform(0, 40, (R, CU, WF))),
              react_i0=f32(rng.uniform(500, 3000, (R, CU))),
              react_sens=f32(rng.uniform(300, 2000, (R, CU))),
              offset_blocks=8, react_models=SIM._REACT_MODELS,
              pc_ids=SIM._PC_IDS, id_ctr_pc=SIM._ID_CTR_PC)
    return args, kw


def out_fields(out, r=None):
    """An ``EpochOut`` (or its row ``r``) as {name: tensor}."""
    res = {}
    for name in out._fields:
        v = getattr(out, name)
        if v is None:
            continue
        if name == "table":
            for k in ("i0", "sens", "count"):
                res[f"table.{k}"] = getattr(v, k) if r is None \
                    else getattr(v, k)[r]
        else:
            res[name] = v if r is None else v[r]
    return res


def rows_bytes(args, kw, out):
    """Bytes a fork-rows call must move: each input read once (the
    programs once each, however many rows share them), each output
    written once."""
    ins = list(args) + [kw[k] for k in ("p_blocks", "mech", "scal", "power",
                                        "tid", "wf_i0", "wf_sens",
                                        "react_i0", "react_sens")]
    ins += list(kw["table"])
    outs = list(out_fields(out).values())
    return nbytes(*ins) + nbytes(*outs)


def epoch_bytes(args, kw, out):
    ins = list(args) + [kw.get("react_i0"), kw.get("react_sens"),
                        kw.get("tid"), kw.get("wf_i0"), kw.get("wf_sens")]
    if kw.get("table") is not None:
        ins += list(kw["table"])
    outs = [out.pos, out.wf_i0, out.wf_sens, out.react_i0, out.react_sens,
            out.f_sel, out.e_acc, out.t_acc, out.work, out.energy, out.err,
            out.fidx, out.true_sens, out.hit_rate]
    if out.table is not None:
        outs += list(out.table)
    return nbytes(*ins) + nbytes(*outs) + 4 * (9 + 11)


def k6_window(cfg):
    """The window K6 runs at in ``cfg``'s prefill (0: causal only)."""
    return cfg.window if cfg.attn_kind == "swa" else 0


def k6_prefix(cfg):
    """The prefix K6 runs at in ``cfg``'s prefill: the vision frontend's
    patch embeddings (0: none)."""
    return cfg.n_patches if cfg.frontend == "vision" else 0


def k6_mask(cfg, S, dev):
    """K6's mask at ``cfg``'s prefill as a boolean (S, S) tensor, (causal
    & window) | prefix, for the library's attention."""
    i = torch.arange(S, device=dev)
    keep = i[None, :] <= i[:, None]
    if k6_window(cfg):
        keep = keep & (i[None, :] > i[:, None] - k6_window(cfg))
    return keep | (i[None, :] < k6_prefix(cfg))


def prefill_batch(cfg, B, S, seed, dev):
    """A prefill's inputs at total length S from a numpy seed: S tokens,
    or for the vision frontend ``n_patches`` bf16 patch embeddings and S -
    n_patches tokens."""
    rng = np.random.default_rng(seed)
    n = k6_prefix(cfg)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S - n))).to(dev)}
    if n:
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)).to(dev, torch.bfloat16)
    return batch


def qkv_case(cfg, dtypes, seed, dev):
    """q, k, v at ``cfg``'s prefill (batch 4, 2048 tokens) from a numpy
    seed, in each of ``dtypes``."""
    rng = np.random.default_rng(seed)
    hd = cfg.resolved_head_dim
    qkv = [rng.standard_normal(s).astype(np.float32)
           for s in ((SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, hd),
                     (SERVE_BATCH, SERVE_PROMPT, cfg.n_kv_heads, hd),
                     (SERVE_BATCH, SERVE_PROMPT, cfg.n_kv_heads, hd))]
    return {dt: [torch.as_tensor(a).to(dev, dt) for a in qkv]
            for dt in dtypes}


def lm_cases(dev, f32=True):
    """K6 at every attention model's prefill ({row: (cfg, {dtype: (q, k,
    v)})}: bf16, and f32 for ``K6_F32`` where ``f32``) and K7 at the
    rwkv6-3b prefill, from numpy seeds."""
    rwkv = get_config("rwkv6-3b")
    k6 = {}
    for arch, (key, seed) in K6_ROWS.items():
        cfg = get_config(arch)
        dts = (torch.bfloat16, torch.float32) if f32 and arch in K6_F32 \
            else (torch.bfloat16,)
        k6[key] = (cfg, qkv_case(cfg, dts, seed, dev))
    rng = np.random.default_rng(42)
    B, S = SERVE_BATCH, SERVE_PROMPT
    hd = rwkv.resolved_head_dim
    H = rwkv.d_model // hd
    rk = [rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5
          for _ in range(3)]
    # the model's decays sit near exp(-exp(-1)) ~ 0.69; this covers more
    rk.append(rng.uniform(0.6, 0.999, (B, S, H, hd)).astype(np.float32))
    rk.append(rng.standard_normal((H, hd)).astype(np.float32) * 0.1)
    k7 = [torch.as_tensor(a).to(dev) for a in rk]
    return k6, k7, scan_cases(dev)


def scan_cases(dev):
    """K8's operands at the hymba-1.5b prefill (batch 4, 2048 tokens) and
    at a decode step (S = 1), from a numpy seed: xh, dt, B_, C_, A and a
    non-zero start state h0, f32 as ``models.ssm.ssm_scan`` passes them
    (dt over the softplus range, A < 0)."""
    cfg = get_config(K8_ARCH)
    hd, N = cfg.resolved_head_dim, cfg.ssm.state_size
    H = cfg.d_model * cfg.ssm.expand // hd
    rng = np.random.default_rng(K8_SEED)
    out = {}
    for key, S in (("prefill", SERVE_PROMPT), ("decode", 1)):
        B = SERVE_BATCH
        arrs = (rng.standard_normal((B, S, H, hd)),
                rng.uniform(0.01, 1.5, (B, S, H)),
                rng.standard_normal((B, S, N)),
                rng.standard_normal((B, S, N)),
                -rng.uniform(0.2, 2.0, H),
                rng.standard_normal((B, H, hd, N)) * 0.5)
        out[key] = [torch.as_tensor(a.astype(np.float32)).to(dev)
                    for a in arrs]
    return out


def lm_counts():
    """K6, K7 and K8 launches, and the epoch kernels' by family."""
    return (FA.flash_attention_bshd.launches, RC.rwkv_chunked_bthd.launches,
            SS.ssm_scan.launches, dict(KEF.epoch_fused.launches_by_family))


def reset_lm_counts():
    FA.flash_attention_bshd.launches = 0
    FA.flash_attention_bshd_bwd.launches = 0
    RC.rwkv_chunked_bthd.launches = 0
    RC.rwkv_chunked_bthd_bwd.launches = 0
    SS.ssm_scan.launches = 0
    SS.ssm_scan_bwd.launches = 0
    MOE.moe_layer.dropped = 0
    KEF.epoch_fused.launches_by_family = dict.fromkeys(
        KEF.epoch_fused.launches_by_family, 0)


def kernel_split(fn, reps=1):
    """Device time of ``fn`` by kernel class from one torch.profiler run,
    in ms per call: K6, K7, K8, K8's backward kernel, the MoE layer's
    expert products and its dispatch and combine (every kernel launched
    inside the ``moe.experts`` or the ``moe.dispatch`` / ``moe.combine``
    profiler ranges), K6's backward (its kernels by name, and what its
    plain version launches inside ``flash_attention.bwd``),
    K7's backward (its kernels by name, and what its plain version
    launches inside ``rwkv_chunk.bwd``), the other matrix products,
    and the rest. None if it reports no device time.

    It reads the profiler's raw events (``kineto_results``): building
    its event tree (``prof.events()``) costs tens of seconds for a
    training step. A kernel belongs to the operator it is linked to (its
    correlation id), and that operator to the range whose span holds it
    on the operator's thread."""
    import bisect

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(("K6", "K7", "K8", "K8_bwd", "experts",
                         "dispatch/combine", "attn_bwd", "K7_bwd", "gemm",
                         "other"), 0.0)
    spans = {"moe.experts": "experts", "moe.dispatch": "dispatch/combine",
             "moe.combine": "dispatch/combine",
             "flash_attention.bwd": "attn_bwd", "rwkv_chunk.bwd": "K7_bwd"}
    own = {"flash_attention_kernel": "K6", "flash_attention_bwd": "attn_bwd",
           "rwkv_chunk_kernel": "K7", "rwkv_chunk_bwd_": "K7_bwd",
           "ssm_scan_fwd_": "K8",
           "ssm_scan_bwd_": "K8_bwd"}
    ops, ranges, kernels = {}, {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if "cuda" in str(ev.device_type()).lower():
            # a range's span on the card is not a kernel
            if not ev.is_user_annotation() and name not in spans:
                kernels.append(ev)
        elif ev.linked_correlation_id() == 0 and not ev.is_hidden_event():
            # an operator or a range on the host, by its correlation id
            ops[ev.correlation_id()] = ev
            if name in spans:
                ranges.setdefault(ev.start_thread_id(), []).append(
                    (ev.start_ns(), ev.end_ns(), spans[name]))
    for r in ranges.values():
        r.sort()
    starts = {t: [r[0] for r in rs] for t, rs in ranges.items()}

    def span_of(op):
        """The range whose span holds ``op`` on its thread, or None (the
        ranges do not nest: the last one to start before ``op`` is the
        only candidate)."""
        t = op.start_thread_id()
        i = bisect.bisect_right(starts.get(t, []), op.start_ns()) - 1
        if i >= 0 and ranges[t][i][1] >= op.end_ns():
            return ranges[t][i][2]
        return None

    # the card's work by name; K6-K8 and their backwards are
    # launched through ctypes, so no operator of torch's owns them, and the
    # rest by the operator (and its profiler range) that launched it; what
    # no operator launched besides them (K7's memset) is the rest
    for ev in kernels:
        dur = ev.duration_ns() / 1e3
        name = ev.name()
        cls = next((c for tag, c in own.items() if tag in name), None)
        if cls is None:
            op = ops.get(ev.linked_correlation_id())
            cls = span_of(op) if op is not None else None
            if cls is None:
                low = name.lower()
                cls = "gemm" if op is not None and any(
                    g in low for g in GEMM_NAMES) else "other"
        out[cls] += dur
    if sum(out.values()) <= 0:
        return None
    return {k: v / reps / 1e3 for k, v in out.items()}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

# ms per call with the host: events over back-to-back calls
time_events = DT.events_ms


def device_ms(fn, what, reps=100):
    """Device time per call of ``fn`` by the one method of every kernel
    row (``scripts/devtime.py``: CUDA events around ``reps`` calls queued
    behind a spin kernel); a reading the method refuses fails a check and
    leaves the row without a time (nothing stands in)."""
    ms = DT.device_ms(fn, reps)
    check(ms is not None, f"{what}: device time (the host queued its "
                          f"{reps} calls inside the spin)")
    return ms


def lm_ran_child() -> int:
    """``--lm-ran``: what K6 (bf16, at every attention model's prefill),
    K7 (at the rwkv6-3b prefill) and K8 (at the hymba-1.5b prefill) run
    on the card, from torch.profiler sessions of five calls each, and what
    one bf16 paligemma-3b prefill at full width (batch 4, 256 patch
    embeddings and 1792 tokens) runs, in this fresh process (the library
    built by the parent); prints {row: {name: records}}."""
    dev = torch.device("cuda", 0)
    no_tf32()
    K.library()
    k6_in, k7_in, k8_in = lm_cases(dev, f32=False)
    out = {key: DT.kernel_counts(
        lambda qkv=cases[torch.bfloat16], w=k6_window(cfg),
        p=k6_prefix(cfg): FA.flash_attention_bshd(
            *qkv, causal=True, window=w, prefix_len=p), 5)
        for key, (cfg, cases) in k6_in.items()}
    out["rwkv_chunked"] = DT.kernel_counts(
        lambda: RC.rwkv_chunked_bthd(*k7_in), 5)
    out["ssm_scan"] = DT.kernel_counts(
        lambda: SS.ssm_scan(*k8_in["prefill"]), 5)
    del k6_in, k7_in, k8_in
    cfg = get_config(VLM_ARCH)
    params = LM.init_params(cfg, 0, dev)
    batch = prefill_batch(cfg, SERVE_BATCH, SERVE_PROMPT, 10, dev)
    out[f"{VLM_ARCH} prefill"] = DT.kernel_counts(
        lambda: LM.prefill(params, cfg, batch), 1)
    print(json.dumps(out), flush=True)
    return 0


def roofline_child() -> int:
    """``--roofline``: phase 12's musicgen-medium training step
    (TRAIN_SHAPE in TRAIN_MB microbatches, remat full) counted on meta
    tensors by ``roofline.analysis.analyze``, on the host alone (no card,
    nothing allocated) beside the parent's work; prints the count and
    its seconds as one JSON line."""
    cfg = get_config(TRAIN_ARCH)
    tc = TrainConfig(microbatches=TRAIN_MB)
    t0 = time.perf_counter()
    out = analyze(make_train_step(cfg, tc),
                  *input_specs(cfg, TRAIN_SHAPE, tc))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def roofline_check(cfg, roof, mean_s, k6_per_step, bwd_per_step,
                   card) -> None:
    """The count of ``roofline_child`` for the step the card trained: its
    FLOPs and bytes, the model-FLOP share of the measured step (6 N D
    over its seconds over the bf16 peak) and the useful ratio (model
    FLOPs over counted FLOPs); checks that the counter's K6 calls and K6
    backward calls a step equal the card's launches a step."""
    out, err = roof.communicate(timeout=600)
    lines = out.strip().splitlines()
    check(roof.returncode == 0 and bool(lines),
          f"the --roofline child counted {cfg.name}'s step (exit "
          f"{roof.returncode}) {err.strip()[-2000:]}")
    if roof.returncode != 0 or not lines:
        return
    a = json.loads(lines[-1])
    terms = roofline_terms(a)
    mf = model_flops(cfg, TRAIN_SHAPE)
    calls = {k: v["calls"] for k, v in a["kernels"].items()}
    print(f"roofline train {cfg.name} (one step, {TRAIN_SHAPE.global_batch}"
          f" x {TRAIN_SHAPE.seq_len} tokens in {TRAIN_MB} microbatches, "
          f"remat {cfg.remat}; roofline.analysis on meta tensors, "
          f"{a['seconds']:.1f} s on the host): {a['flops'] / 1e12:.2f} "
          f"TFLOP counted (matrix products {a['matmul_flops'] / 1e12:.2f}, "
          + ", ".join(f"{k} {v['flops'] / 1e12:.2f} in {v['calls']} calls"
                      for k, v in a["kernels"].items())
          + f"), {a['hbm_bytes'] / 1e9:.1f} GB of HBM writes and kernel "
          f"traffic, {a['aten_ops']} aten ops; at the H100's peaks compute "
          f"{terms['t_compute_s']:.3f} s, memory {terms['t_memory_s']:.3f} "
          f"s; model FLOPs 6 N D {mf / 1e12:.2f} TFLOP; model-FLOP share "
          f"{mf / mean_s / PEAK_FLOPS_BF16:.4%} of 989 TFLOP/s at the "
          f"measured {mean_s:.3f} s a step; useful ratio "
          f"{mf / a['flops']:.4f} on {card}", flush=True)
    check(calls.get("flash_attention") == k6_per_step,
          f"roofline train {cfg.name}: the counter's K6 calls a step "
          f"{calls.get('flash_attention')} == the card's {k6_per_step} "
          f"launches a step")
    check(calls.get("flash_attention_bwd") == bwd_per_step,
          f"roofline train {cfg.name}: the counter's K6 backward calls a "
          f"step {calls.get('flash_attention_bwd')} == the card's "
          f"{bwd_per_step} backward launches a step")


def lm_ran_on_card() -> dict:
    """What K6, K7 and K8 run on the card, each by name and records, from
    ``lm_ran_child`` in a process of its own. A long process's profiler
    sessions can keep no record at all (late in this one they did, for
    both kernels, in sessions of either kind); a fresh process's keep
    them. A child whose sessions kept nothing is run once more."""
    out = {}
    for _ in range(2):
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--lm-ran"], capture_output=True, text=True,
                           timeout=600)
        lines = p.stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            print(f"--lm-ran exited {p.returncode}: "
                  f"{p.stderr.strip()[-2000:]}", flush=True)
            continue
        out = json.loads(lines[-1])
        if all(out.values()):
            break
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def reset_k4() -> None:
    """Zero the fused epoch's launch counts (K3/K4/K5 and K4's rows)."""
    KEF.epoch_fused.launches = 0
    KEF.epoch_fused.launches_by_family = dict.fromkeys(
        KEF.epoch_fused.launches_by_family, 0)
    KEF.epoch_fused.fork_rows = 0


def timed(fn):
    """``fn()`` and its host wall in seconds, the queue drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def k4_learn_cases(dev, fork_row) -> None:
    """K4 against its plain version at the learn path's shapes (32 CUs x
    40 WFs, a table per CU, its eight workloads, the default regime): the
    factory dataset's 32 pcstall rows (ed2p) and the deployment sweep's
    16 crisp and 16 pcstall rows (each over workloads x {ed2p,
    deadline05})."""
    crisp, pcstall = SIM.FORK_MECH_IDS["crisp"], SIM.FORK_MECH_IDS["pcstall"]
    two = [w for w in LEARN_WORKLOADS for _ in range(2)]
    for tag, ids, names, objs in (
            ("32 pcstall rows", [pcstall] * 32, LEARN_WORKLOADS, ("ed2p",)),
            ("16 crisp + 16 pcstall rows", [crisp] * 16 + [pcstall] * 16,
             two, ("ed2p", "deadline05"))):
        args, kw = fork_rows_case(ids, names, 28, dev, cu=LEARN_CU,
                                  tables=LEARN_CU, objs=objs,
                                  regimes=(PWR.PowerConfig(),))
        got = out_fields(KEF.epoch_fused_rows(*args, **kw))
        want = out_fields(KEF.epoch_fused_rows_ref(*args, **kw))
        torch.cuda.synchronize()
        for field, w in want.items():
            fork_row["max_abs_err"] = max(fork_row["max_abs_err"], compare(
                f"epoch_fused[fork,{LEARN_CU} x {WF} learn path,{tag}]."
                f"{field}", got[field], w))


def learn_phase(dev, card) -> None:
    """Phase 11: the learn pipeline (``repro_torch.learn.__main__
    .run_pipeline``, which asserts the reference's invariants) at the
    full ``DatasetConfig()`` on the card, with this script's own checks:
    K4's launches in each stage, the audit at registration, a second
    dataset bitwise equal, learned grid rows bit for bit their
    ``run_sim``, and the kernel engine beside the unfused one."""
    from repro_torch.learn import __main__ as LCLI

    cfg = LDS.DatasetConfig(device=dev)
    n_runs = len(cfg.workloads) * len(cfg.seeds) * len(cfg.epoch_us)
    n_rows = n_runs * 2 * (cfg.n_epochs - cfg.warmup) * cfg.n_cu
    walls, k4, audits = {}, {}, {}

    @contextlib.contextmanager
    def stage(name):
        reset_k4()
        misses = DEPS.axis_liveness.cache_info().misses
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        k4[name] = (dict(KEF.epoch_fused.launches_by_family),
                    KEF.epoch_fused.fork_rows)
        audits[name] = DEPS.axis_liveness.cache_info().misses - misses

    res = LCLI.run_pipeline(cfg, ("linear", "mlp"), steps=400,
                            sweep_workloads=cfg.workloads, stage=stage)
    data, meta, grid = res["data"], res["meta"], res["grid"]
    progs = res["progs"]
    objs = list(LCLI.SWEEP_OBJECTIVES)
    W, G = len(progs), len(objs)

    def k4_line(name):
        fams, rows = k4[name]
        per = rows / max(fams["fork"], 1)
        return (f"K4 launches {fams['fork']} ({per:.0f} rows each), K3 "
                f"{fams['pc'] + fams['reactive']}", fams, per)

    line, fams, per = k4_line("dataset")
    print(f"learn dataset: {data['x'].shape[0]} rows from {n_runs} runs in "
          f"{walls['dataset']:.2f} s wall; {line} on {card}", flush=True)
    check(data["x"].shape[0] == n_rows
          and all(np.isfinite(data[k]).all() for k in ("x", "y", "t_us")),
          f"learn dataset: {n_rows} finite rows")
    check(fams["fork"] == cfg.n_epochs and per == n_runs
          and fams["pc"] + fams["reactive"] == 0,
          f"learn dataset: K4 launched once per epoch ({cfg.n_epochs}) for "
          f"PCSTALL's {n_runs} rows")
    data2, meta2 = LDS.generate_dataset(cfg)
    check(meta2 == meta and data2.keys() == data.keys()
          and all(np.array_equal(data2[k], data[k]) for k in data),
          "learn dataset: a second generation is bitwise equal")
    del data2

    for kind, (_, curves) in res["fits"].items():
        name, probe = LCLI.KIND_NAMES[kind], curves["probe"]
        print(f"learn fit {kind}: 400 steps x 4096 rows in "
              f"{walls['fit ' + kind]:.2f} s wall; probe loss "
              f"{probe[0]:.4f} -> {probe[-1]:.4f}; val_choice_acc "
              f"{curves['val_choice_acc']:.4f}; "
              f"{k4_line('fit ' + kind)[0]} on {card}", flush=True)
        spec = res["specs"][kind]
        print(f"learn register {name}: {walls['register ' + name]:.2f} s "
              f"wall, {audits['register ' + name]} audits", flush=True)
        check(audits["register " + name] == 2
              and DEPS.axis_liveness(spec).exact,
              f"learn register {name}: audited under both engines, "
              f"exec_axes derived exactly")

    line, fams, per = k4_line("sweep")
    print(f"learn sweep: {W} workloads x {G} objectives x (crisp, pcstall, "
          f"learned_lin, learned_mlp) at {cfg.n_cu} CUs x {cfg.n_epochs} "
          f"epochs in {walls['sweep']:.2f} s wall; {line}; TRACE_COUNTS "
          f"{dict(SW.TRACE_COUNTS)}, DISPATCH_ROWS {dict(SW.DISPATCH_ROWS)} "
          f"on {card}", flush=True)
    check(fams["fork"] == cfg.n_epochs and per == W * G * 2
          and fams["pc"] + fams["reactive"] == 0,
          f"learn sweep: K4 launched once per epoch for crisp and "
          f"pcstall's {W * G * 2} rows")
    check(all(np.isfinite(v).all() for o in grid.values()
              for trs in o.values() for tr in trs.values()
              for v in tr.values()), "learn sweep: traces finite")
    sim = cfg.sim()
    same = True
    for obj in objs:
        one = dataclasses.replace(sim, objective=obj)
        for w, prog in progs.items():
            for spec in res["specs"].values():
                alone = SIM.run_sim(prog, one, spec)
                row = grid[(obj,)][w][spec.name]
                same &= alone.keys() == row.keys() and all(
                    np.array_equal(alone[k], row[k]) for k in alone)
    check(same, "learn sweep: every learned grid row bit for bit its "
                "per-point run_sim")
    met = SW.suite_metrics(None, sim, ("pcstall",) + tuple(
        s.name for s in res["specs"].values()), n=2, traces=grid[("ed2p",)],
        baseline="pcstall")
    for kind, (_, curves) in res["fits"].items():
        n = res["specs"][kind].name
        mean_f = float(np.mean([np.take(meta["freqs_ghz"],
                                        grid[("ed2p",)][w][n]["fidx"]
                                        .astype(int)).mean()
                                for w in progs]))
        print(f"learn {n}: val_choice_acc {curves['val_choice_acc']:.4f}, "
              f"deployed_mean_f {mean_f:.4f} GHz, ED2P vs pcstall "
              + ", ".join(f"{w} {met[w][n]['ednp_norm']:.4f}"
                          for w in progs), flush=True)
        MECH.unregister(n)

    # the kernel engine beside the unfused engine: PCSTALL's traces of
    # the factory sweep (K4's 32 rows against the unfused body), every
    # element
    axes = {"epoch_us": list(cfg.epoch_us)}
    tk = SW.run_grid(progs, sim, axes, ("pcstall",), seeds=list(cfg.seeds))
    tu = SW.run_grid(progs, dataclasses.replace(sim, use_pallas=False),
                     axes, ("pcstall",), seeds=list(cfg.seeds))
    worst, fidx_eq, fidx_n = {}, 0, 0
    for key in tk:
        for w in progs:
            a, b = tk[key][w]["pcstall"], tu[key][w]["pcstall"]
            for ch in LEARN_TRACE_CHANNELS:
                if ch == "fidx":
                    fidx_eq += int(np.sum(a[ch] == b[ch]))
                    fidx_n += a[ch].size
                    continue
                x, y = a[ch].astype(np.float64), b[ch].astype(np.float64)
                d = np.abs(x - y)
                scale = np.abs(y).max() if ch == "true_sens" else np.abs(y)
                r = float(np.max(d / (ATOL + RTOL * scale)))
                m = worst.get(ch, (0.0, 0.0))
                worst[ch] = (max(m[0], float(d.max())), max(m[1], r))
    print("learn engines, PCSTALL traces of the factory sweep (kernel vs "
          "unfused, " + f"{n_runs} rows): fidx equal {fidx_eq}/{fidx_n}; "
          + ", ".join(f"{ch} max |d| {v[0]:.3e} ({v[1]:.3f} of the limit)"
                      for ch, v in worst.items()), flush=True)
    check(fidx_eq == fidx_n and all(v[1] <= 1.0 for v in worst.values()),
          f"learn engines: PCSTALL traces fidx equal, floats within "
          f"{ATOL} + {RTOL}|ref| (true_sens: x the run's max |ref|)")

    # the two engines' datasets at 2 workloads: PCSTALL's rows (policy 1)
    cfg2 = dataclasses.replace(cfg, workloads=cfg.workloads[:2])
    dk, _ = LDS.generate_dataset(cfg2)
    du, _ = LDS.generate_dataset(dataclasses.replace(cfg2,
                                                     use_pallas=False))
    pc = du["policy"] == 1
    ratio = {}
    for k in ("x", "y"):
        a, b = dk[k][pc].astype(np.float64), du[k][pc].astype(np.float64)
        d = np.abs(a - b).max(axis=0)
        ratio[k] = (float(d.max()), float(np.max(
            d / (ATOL + RTOL * np.abs(b).max(axis=0)))))
    agree = float(np.mean(dk["fidx"][pc] == du["fidx"][pc]))
    print(f"learn engines, 2-workload dataset, PCSTALL's {int(pc.sum())} "
          f"rows: x max |d| {ratio['x'][0]:.3e} ({ratio['x'][1]:.3f} of the "
          f"limit), y {ratio['y'][0]:.3e} ({ratio['y'][1]:.3f}); fidx "
          f"agreement {agree:.6f}", flush=True)
    check(ratio["x"][1] <= 1.0 and ratio["y"][1] <= 1.0,
          f"learn engines: dataset x and y within {ATOL} + {RTOL} x each "
          f"column's max |ref|")
    check(agree >= LEARN_FIDX_AGREE,
          f"learn engines: dataset fidx agreement >= {LEARN_FIDX_AGREE}")


# ---------------------------------------------------------------------------
# phase 12: training
# ---------------------------------------------------------------------------


def k6_grad_checks(dev, card) -> None:
    """K6's gradient (``FlashAttention``: the forward on K6, one launch
    that also writes each row's log-sum-exp; the backward on K6's
    backward kernels, one call) against autograd through the plain
    version in f32, at the three training layouts, from f32 and from bf16
    inputs; a second backward on the same inputs bit for bit the first."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          "TF32 is off for the f32 gradient checks")
    for arch, (B, S, H, Hkv, hd, w, pre) in K6_GRAD_LAYOUTS.items():
        rng = np.random.default_rng(S + H)
        arrs = [rng.standard_normal(shp).astype(np.float32)
                for shp in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                            (B, S, H, hd))]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.as_tensor(a).to(dev, dt) for a in arrs)
            # a batch row at a time: the rows' gradients are independent,
            # and a row's graph holds its (H, S, block) tiles
            want = [torch.empty(t.shape, dtype=torch.float32, device=dev)
                    for t in (q, k, v)]

            def plain():
                for b in range(B):
                    qs, ks, vs = (t[b:b + 1].float().requires_grad_()
                                  for t in (q, k, v))
                    out = FA.flash_attention_bshd_ref(
                        qs, ks, vs, causal=True, window=w, prefix_len=pre)
                    for dst, g in zip(want, torch.autograd.grad(
                            out, (qs, ks, vs), do[b:b + 1].float())):
                        dst[b:b + 1] = g
            # the plain version's time (its forward and autograd), timed
            # by the events around its one call
            plain_ms = time_events(plain, reps=1, warm=0)
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
            n = (FA.flash_attention_bshd.launches,
                 FA.flash_attention_bshd_bwd.launches)
            out = FA.FlashAttention.apply(qs, ks, vs, True, w, pre, 128)
            got = torch.autograd.grad(out, (qs, ks, vs), do,
                                      retain_graph=True)
            again = torch.autograd.grad(out, (qs, ks, vs), do)
            torch.cuda.synchronize()
            check((FA.flash_attention_bshd.launches,
                   FA.flash_attention_bshd_bwd.launches)
                  == (n[0] + 1, n[1] + 2),
                  f"K6 gradient at {arch}'s layout: one K6 launch (the "
                  f"forward), one backward call for each of two gradients")
            tag = (f"at {arch}'s training layout (B {B} S {S} H {H} Hkv "
                   f"{Hkv} hd {hd} window {w} prefix {pre}, "
                   f"{str(dt).split('.')[-1]})")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K6 gradient {tag}: two backward calls bit for bit")
            errs = []
            for name, a, b_ in zip("qkv", got, want):
                errs.append(float((a.float() - b_).abs().max()
                                  / b_.abs().max()))
                check(a.dtype == dt and errs[-1] < K6_GRAD_TOL[dt],
                      f"K6 gradient d{name} {tag}: {errs[-1]:.3e} of its "
                      f"largest magnitude (limit {K6_GRAD_TOL[dt]})")
            print(f"K6 gradient at {arch}'s layout ({str(dt).split('.')[-1]}"
                  f"; backward kernel): dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
                  f"dv {errs[2]:.3e} of each one's largest magnitude against "
                  f"autograd through the plain version in f32 "
                  f"({plain_ms:.1f} ms, its forward and backward, events) "
                  f"on {card}", flush=True)
            del q, k, v, do, want, qs, ks, vs, out, got, again
        torch.cuda.empty_cache()


def k6_train_row(dev, card, rows) -> None:
    """K6 at musicgen-medium's training layout (bf16, B 4, S 4096, 24
    heads of 64, causal) against its plain version, its device time, the
    plain version's, the library's causal attention and its bound; and
    K6's backward kernel at the same layout: against its plain version,
    its device time beside its bound, the plain version's and the
    library's backward (autograd of ``scaled_dot_product_attention``'s
    causal attention in bf16, the same function)."""
    B, S, H, Hkv, hd, _, _ = K6_GRAD_LAYOUTS[TRAIN_ARCH]
    rng = np.random.default_rng(44)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shp).astype(
        np.float32)).to(dev, torch.bfloat16) for shp in (
            (B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, H, hd)))
    got = FA.flash_attention_bshd(q, k, v)
    want = FA.flash_attention_bshd_ref(q, k, v)
    torch.cuda.synchronize()
    rtol, atol = K6_TOL[torch.bfloat16]
    row = rows[K6_TRAIN_ROW] = dict(max_abs_err=compare(
        f"{K6_TRAIN_ROW}[bf16, B {B} S {S} H {H} hd {hd} causal]",
        got.float(), want.float(), rtol=rtol, atol=atol))
    del want
    row["ms"] = device_ms(lambda: FA.flash_attention_bshd(q, k, v),
                          K6_TRAIN_ROW)
    row["plain_ms"] = time_events(
        lambda: FA.flash_attention_bshd_ref(q, k, v), reps=3, warm=1)
    ops = attention_flops(B, S, H, hd)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes(q, k, v, q), ops,
                                                PEAK_FLOPS_BF16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"] = time_events(
        lambda: sdpa(qt, kt, vt, is_causal=True), reps=20, warm=3)
    if row["ms"] is not None:
        print(f"time {K6_TRAIN_ROW}: device {row['ms'] * 1e3:.2f} us per "
              f"call, plain {row['plain_ms'] * 1e3:.1f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
              f"scaled_dot_product_attention {row['library_ms'] * 1e3:.2f} "
              f"us on {card}", flush=True)
    # K6's backward kernel at the same layout: against its plain version
    # on the same inputs and log-sum-exp, its device time beside its bound,
    # the plain version's and the library's backward (dq, dk, dv of one
    # retained graph of scaled_dot_product_attention per call)
    out, lse = FA.flash_attention_bshd(q, k, v, return_lse=True)
    grads = FA.flash_attention_bshd_bwd(q, k, v, out, do, lse)
    want = FA.flash_attention_bshd_bwd_ref(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    tol = K6_GRAD_TOL[torch.bfloat16]
    brow = rows[K6_BWD_ROW] = dict(max_abs_err=0.0)
    for name, g, wt in zip("qkv", grads, want):
        top = float(wt.float().abs().max())
        brow["max_abs_err"] = max(brow["max_abs_err"], compare(
            f"{K6_BWD_ROW}.d{name} (bf16 against the plain version's bf16 "
            f"on the same lse; {tol} of its largest |ref| {top:.3e})",
            g.float(), wt.float(), rtol=0.0, atol=tol * top))
    del want
    bwd = lambda: FA.flash_attention_bshd_bwd(  # noqa: E731
        q, k, v, out, do, lse)
    brow["ms"] = device_ms(bwd, K6_BWD_ROW, reps=20)
    brow["plain_ms"] = time_events(lambda: FA.flash_attention_bshd_bwd_ref(
        q, k, v, out, do, lse), reps=3, warm=1)
    bwd_ops = attention_bwd_flops(B, S, H, hd)
    brow["bound_ms"], brow["bound_by"] = bound_ms(
        nbytes(q, k, v, out, do, lse, *grads), bwd_ops, PEAK_FLOPS_BF16)
    ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lib_out = sdpa(ql, kl, vl, is_causal=True)
    dot = do.transpose(1, 2)
    brow["library_ms"] = time_events(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dot, retain_graph=True), reps=20, warm=3)
    if brow["ms"] is not None:
        print(f"time {K6_BWD_ROW} (flash_attention_bshd_bwd, the kernel): "
              f"device {brow['ms']:.4f} ms per call, plain "
              f"{brow['plain_ms']:.2f} ms (events), bound "
              f"{brow['bound_ms']:.4f} ms ({brow['bound_by']}; "
              f"{bwd_ops / 1e9:.1f} GFLOP of 5 products, this design does "
              f"7), {brow['ms'] / brow['bound_ms']:.2f}x; library backward "
              f"(autograd of scaled_dot_product_attention, causal, bf16) "
              f"{brow['library_ms']:.4f} ms (events), ours "
              f"{brow['ms'] / brow['library_ms']:.2f}x, on {card}",
              flush=True)
    del q, k, v, do, got, out, lse, grads, qt, kt, vt, ql, kl, vl, lib_out
    del dot
    torch.cuda.empty_cache()


def _state_leaves(state):
    out = {"params/" + k: p for k, p in state["params"].named_parameters()}
    out.update({"m/" + k: t for k, t in state["opt"].m.items()})
    out.update({"v/" + k: t for k, t in state["opt"].v.items()})
    out["count"], out["step"] = state["opt"].count, state["step"]
    return out


def run_train(cfg, tc, steps, dev, card, save_final=True):
    """``launch.train.train`` of ``cfg`` at TRAIN_SHAPE from fresh counts
    and peak memory, DVFS on: prints its losses, step seconds, tokens/s,
    peak memory and DVFS report; checks finite losses (the first within
    1.0 of ln V), finite grad norms and the report. Returns (state, log,
    the mean seconds of a step after the first)."""
    arch = cfg.name
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_lm_counts()
    log = {}
    t0 = time.perf_counter()
    state, losses = train(cfg, tc, TRAIN_SHAPE, steps=steps, resume=False,
                          dvfs=True, log_every=1, device=dev, log=log,
                          save_final=save_final)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    run = log["steps"]
    secs = [x["seconds"] for x in run]
    tokens = TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len
    steady = secs[1:] or secs
    mean_s = sum(steady) / len(steady)
    save = f"final save {log['save_s']:.2f} s; " if "save_s" in log else ""
    print(f"train {arch}: losses {[round(x, 4) for x in losses]}, "
          f"grad_norm {[round(x['grad_norm'], 4) for x in run]}, lr "
          f"{[x['lr'] for x in run]} on {card}", flush=True)
    print(f"time train {arch}: step seconds {[round(x, 3) for x in secs]} "
          f"(the first with the first call's set-up), {mean_s:.3f} s a step "
          f"over steps 2-{len(secs)}, {tokens / mean_s:.0f} tokens/s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {save}train() {wall:.1f} s "
          f"on {card}", flush=True)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab)) < 1.0,
          f"train {arch}: {len(losses)} finite losses, the first "
          f"{losses[0]:.4f} within 1.0 of ln {cfg.vocab} = "
          f"{math.log(cfg.vocab):.4f}")
    check(all(math.isfinite(x["grad_norm"]) for x in run),
          f"train {arch}: grad_norm finite")
    rep = log.get("dvfs", {})
    check(bool(rep) and all(math.isfinite(rep[k]) for k in
                            ("ed2p_norm", "energy_norm", "accuracy"))
          and rep["step_time"]["n_steps"] == steps,
          f"train {arch}: DVFS report ({rep.get('step_time')})")
    if rep:
        print(f"train {arch} DVFS report: ED2P {rep['ed2p_norm']:.4f} energy "
              f"{rep['energy_norm']:.4f} delay {rep['delay_norm']:.4f} "
              f"accuracy {rep['accuracy']:.4f}, mean step "
              f"{rep['step_time']['mean_step_s']:.3f} s on {card}",
              flush=True)
    return state, log, mean_s


def moved_check(cfg, state, fresh_params) -> None:
    """Every parameter of the trained ``state`` differs from its initial
    value in ``fresh_params``."""
    trained = dict(state["params"].named_parameters())
    still = [k for k, p in fresh_params.named_parameters()
             if torch.equal(p, trained[k])]
    check(not still, f"train {cfg.name}: every parameter moved "
                     f"({len(still)} did not: {still[:4]})")


def step_split(cfg, tc, state, mean_s, dev, card):
    """One more training step of ``state`` under torch.profiler: its
    device time by class (``kernel_split``), printed and returned (None
    where the profiler reported none)."""
    step = make_train_step(cfg, tc)
    batch = make_batch(cfg, TRAIN_SHAPE, tc.total_steps,
                       microbatches=tc.microbatches, device=dev)
    mark(f"12, {cfg.name}'s profiled step")
    split = kernel_split(lambda: step(state, batch))
    if split is None:
        print(f"train {cfg.name}: the profiler reported no device time",
              flush=True)
        return
    tot = sum(split.values())
    print(f"time train {cfg.name} one step's device time (profiler): "
          f"{tot:.1f} ms (a step {mean_s * 1e3:.1f} ms of wall above): "
          + ", ".join(f"{k} {v:.1f} ms ({v / tot:.1%})"
                      for k, v in split.items() if v > 0)
          + f" on {card}", flush=True)
    return split


def train_forward_bound(cfg, split, calls, card) -> None:
    """K8's (hybrid) or K7's (rwkv) forward at its training layout (a
    microbatch of 4 x 4096): its bound from ``roofline.work`` (inputs read
    and outputs written once, f32; ``scan_flops`` / ``rwkv_flops``)
    beside its mean device time per call in the profiled step (``calls``
    launches a step)."""
    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    if cfg.family == "hybrid":
        B, S, H, hd, N = K8_BWD_LAYOUTS["hymba-1.5b train"]
        cls, tag = "K8", f"ssm_scan[B {B} S {S} H {H} hd {hd} N {N}]"
        nb = nbytes(e(B, S, H, hd), e(B, S, H), e(B, S, N), e(B, S, N),
                    e(H), e(B, H, hd, N), e(B, S, H, hd), e(B, H, hd, N))
        ops = scan_flops(B, S, H, hd, N)
    else:
        B, S, H, hd, C, _ = K7_BWD_LAYOUTS["rwkv6-3b train"]
        cls, tag = "K7", f"rwkv_chunked[B {B} T {S} H {H} hd {hd} C {C}]"
        nb = nbytes(*(e(B, S, H, hd) for _ in range(4)), e(H, hd),
                    e(B, S, H, hd), e(B, H, hd, hd))
        ops = rwkv_flops(B * H, S, hd)
    bound, by = bound_ms(nb, ops)
    ms = split[cls] / calls if split else None
    print(f"time {tag} at the training layout: bound {bound:.4f} ms ({by}; "
          f"{nb / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), device "
          + (f"{ms:.4f} ms per call ({ms / bound:.2f}x; {calls} calls a "
             f"step)" if ms is not None else "not measured")
          + f" on {card}", flush=True)


def train_phase(dev, card, rows, roof) -> None:
    """musicgen-medium at full width through ``launch.train.train`` (K6
    forward and recompute, the DVFS manager, the final checkpoint
    restored bit for bit), its step against the count of ``roof`` (the
    ``--roofline`` child), one step's device time by class, then
    granite-moe-1b-a400m through ``make_train_step``."""
    cfg = get_config(TRAIN_ARCH)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tc = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=1,
                         microbatches=TRAIN_MB, checkpoint_every=0,
                         checkpoint_dir=ckdir)
        # the checkpoint: params as f32, m and v (4 bytes each), count, step
        need = 12 * cfg.n_params
        free = shutil.disk_usage(ckdir).free
        print(f"train {TRAIN_ARCH}: {cfg.n_params / 1e9:.3f} B parameters, "
              f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads"
              f" of {cfg.resolved_head_dim}; shape {TRAIN_SHAPE.global_batch}"
              f" x {TRAIN_SHAPE.seq_len} a step in {TRAIN_MB} microbatches "
              f"(TRAIN_4K's {TRAIN_4K.seq_len} tokens; its "
              f"{TRAIN_4K.global_batch} sequences a step cut to "
              f"{TRAIN_SHAPE.global_batch}), {TRAIN_STEPS} steps, remat "
              f"{cfg.remat}; checkpoint ~{need / 1e9:.1f} GB, "
              f"{free / 1e9:.1f} GB free under {ckdir} on {card}",
              flush=True)
        check(free >= need * 1.05,
              f"train {TRAIN_ARCH}: {free / 1e9:.1f} GB free under {ckdir} "
              f"for its ~{need / 1e9:.1f} GB checkpoint")
        if free < need * 1.05:
            return
        state, log, mean_s = run_train(cfg, tc, TRAIN_STEPS, dev, card)
        n6 = FA.flash_attention_bshd.launches
        nb = FA.flash_attention_bshd_bwd.launches
        rows[K6_TRAIN_ROW]["launches"] = n6
        rows[K6_BWD_ROW]["launches"] = nb
        # every layer of every microbatch, forward and the full remat's
        # recompute: 192 a step; the backward once: 96
        per_step = cfg.n_layers * TRAIN_MB * 2
        check(n6 == TRAIN_STEPS * per_step,
              f"train {TRAIN_ARCH}: K6 {n6} launches == {TRAIN_STEPS} steps "
              f"x {per_step} ({cfg.n_layers} layers x {TRAIN_MB} "
              f"microbatches x forward and recompute)")
        check(nb == TRAIN_STEPS * per_step // 2,
              f"train {TRAIN_ARCH}: K6 backward {nb} launches == "
              f"{TRAIN_STEPS} steps x {per_step // 2} ({cfg.n_layers} layers "
              f"x {TRAIN_MB} microbatches)")
        roofline_check(cfg, roof, mean_s, n6 // TRAIN_STEPS,
                       nb // TRAIN_STEPS, card)
        # the parameters moved from the initial state, and the final
        # checkpoint restores bit for bit into it
        fresh = init_state(cfg, tc, tc.seed, dev)
        moved_check(cfg, state, fresh["params"])
        ck_bytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*.npz"))
        t0 = time.perf_counter()
        fresh, last = CK.restore(fresh, ckdir)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        a, b = _state_leaves(fresh), _state_leaves(state)
        differ = [k for k in a if not torch.equal(a[k].detach(),
                                                  b[k].detach())]
        check(last == TRAIN_STEPS - 1 and not differ,
              f"train {TRAIN_ARCH}: the step-{last} checkpoint "
              f"({ck_bytes / 1e9:.2f} GB of npz) restores bit for bit "
              f"({len(differ)} of {len(a)} leaves differ)")
        print(f"time train {TRAIN_ARCH} checkpoint: save {log['save_s']:.2f}"
              f" s, restore {t_restore:.2f} s for {ck_bytes / 1e9:.2f} GB "
              f"(the read warm: just written) on {card}", flush=True)
        del fresh, a, b
        torch.cuda.empty_cache()
        # one step's device time by class (torch.profiler): K6 forward and
        # recompute, the attention backward, the other matrix products,
        # the rest
        step_split(cfg, tc, state, mean_s, dev, card)
        del state
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # granite-moe-1b-a400m: the MoE aux loss in a full-width step
    cfg = get_config(MOE_TRAIN_ARCH)
    tc = TrainConfig(total_steps=2, warmup_steps=1, microbatches=1)
    state = init_state(cfg, tc, 0, dev)
    before = {k: p.detach().clone()
              for k, p in state["params"].named_parameters()}
    step = make_train_step(cfg, tc)
    reset_lm_counts()
    secs, mets = [], []
    for i in range(2):
        batch = make_batch(cfg, MOE_TRAIN_SHAPE, i, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        mets.append({k: float(x) for k, x in m.items()})
        secs.append(time.perf_counter() - t0)
    n6 = FA.flash_attention_bshd.launches
    nb = FA.flash_attention_bshd_bwd.launches
    still = [k for k, p in state["params"].named_parameters()
             if torch.equal(p, before[k])]
    print(f"time train {MOE_TRAIN_ARCH} (make_train_step, "
          f"{MOE_TRAIN_SHAPE.global_batch} x {MOE_TRAIN_SHAPE.seq_len}, one "
          f"microbatch): step seconds {[round(x, 3) for x in secs]}, losses "
          f"{[round(x['loss'], 4) for x in mets]}, aux "
          f"{[round(x['aux'], 4) for x in mets]}, grad_norm "
          f"{[round(x['grad_norm'], 4) for x in mets]}, K6 {n6} launches, "
          f"K6 backward {nb} on {card}", flush=True)
    check(all(math.isfinite(x[k]) for x in mets
              for k in ("loss", "aux", "grad_norm"))
          and all(x["aux"] > 0 for x in mets),
          f"train {MOE_TRAIN_ARCH}: loss, aux and grad_norm finite, aux > 0")
    check(n6 == 2 * cfg.n_layers * 2 and nb == 2 * cfg.n_layers,
          f"train {MOE_TRAIN_ARCH}: K6 {n6} launches == 2 steps x "
          f"{cfg.n_layers} layers x forward and recompute, K6 backward {nb} "
          f"== 2 steps x {cfg.n_layers} layers")
    check(not still, f"train {MOE_TRAIN_ARCH}: every parameter moved "
                     f"({len(still)} did not: {still[:4]})")
    del state, before, step, batch
    torch.cuda.empty_cache()


def scan_bwd_case(B, S, H, hd, N, seed, dev, underflow=False,
                  chunk=SS.BWD_CHUNK):
    """K8's operands as ``scan_cases`` makes them (a non-zero h0) and the
    output gradients gy and g_hout, from a numpy seed; with ``underflow``
    dt in (2, 3) over the second ``chunk`` tokens (the backward's chunk
    by default) and A = -2, so that the chunk's decay product underflows
    to 0."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, hd)),
            rng.uniform(0.01, 1.5, (B, S, H)),
            rng.standard_normal((B, S, N)),
            rng.standard_normal((B, S, N)),
            -rng.uniform(0.2, 2.0, H),
            rng.standard_normal((B, H, hd, N)) * 0.5,
            rng.standard_normal((B, S, H, hd)),
            rng.standard_normal((B, H, hd, N))]
    if underflow:
        L = chunk
        arrs[1][:, L:2 * L] = rng.uniform(2.0, 3.0, arrs[1][:, L:2 * L].shape)
        arrs[4][:] = -2.0
    return [torch.as_tensor(a.astype(np.float32)).to(dev) for a in arrs]


def k8_fwd_rows(dev, card, rows) -> None:
    """K8 against its plain version (``ssm_scan_ref``, the token loop) at
    ``K8_FWD_LAYOUTS``: y and h_out within RTOL / ATOL, finite, two calls
    bit for bit (where a chunk's decay product underflows, that it is 0 in
    f32); at hymba-1.5b's training layout its device time beside its
    bound, split by its three launches."""
    row = rows["ssm_scan"]
    for i, (key, (B, S, H, hd, N, under)) in enumerate(
            K8_FWD_LAYOUTS.items()):
        args = scan_bwd_case(B, S, H, hd, N, 80 + i, dev, underflow=under,
                             chunk=SS.FWD_CHUNK)[:6]
        got = SS.ssm_scan(*args)
        again = SS.ssm_scan(*args)
        want = SS.ssm_scan_ref(*args)
        torch.cuda.synchronize()
        tag = f"ssm_scan[{key}: B {B} S {S} H {H} hd {hd} N {N}]"
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{tag}: y and h_out finite")
        row["max_abs_err"] = max(row["max_abs_err"],
                                 compare(f"{tag}.y", got[0], want[0]),
                                 compare(f"{tag}.h_out", got[1], want[1]))
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: two calls bitwise equal")
        if under:
            L = SS.FWD_CHUNK
            prod = torch.exp(args[1][:, L:2 * L] * args[4]).prod(1)
            check(float(prod.max()) == 0.0,
                  f"{tag}: the second chunk's decay product underflows to "
                  f"0 in f32")
        nb = nbytes(*args, *got)
        del got, again, want
        if key != "train":
            continue
        ops = scan_flops(B, S, H, hd, N)
        bound, by = bound_ms(nb, ops)
        ms = device_ms(lambda: SS.ssm_scan(*args), tag, reps=20)
        split = DT.kernel_means(lambda: SS.ssm_scan(*args), K8_KERNELS,
                                reps=20)
        if ms is not None:
            print(f"time {tag}: device {ms * 1e3:.2f} us per call, bound "
                  f"{bound * 1e3:.2f} us ({by}; {nb / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP), {ms / bound:.2f}x; by launch "
                  + ", ".join(f"{n} {m:.4f} ms ({c} records)"
                              for n, (m, c) in split.items()
                              if m is not None)
                  + f" on {card}", flush=True)


def k8_bwd_rows(dev, card, rows) -> None:
    """K8's backward kernel against its plain version (``ssm_scan_bwd_ref``,
    the reverse token loop) at ``K8_BWD_LAYOUTS``, every output, each
    finite; two calls bit for bit; at hymba-1.5b's training layout its
    device time beside its bound and the plain version's, and its split
    by launch."""
    row = rows[K8_BWD_ROW] = dict(max_abs_err=0.0)
    names = ("dxh", "ddt", "dB_", "dC_", "dA", "dh0")
    rtol, atol = K8_BWD_TOL
    for i, (key, (B, S, H, hd, N)) in enumerate(K8_BWD_LAYOUTS.items()):
        args = scan_bwd_case(B, S, H, hd, N, 60 + i, dev,
                             underflow=key == K8_BWD_UNDERFLOW)
        got = SS.ssm_scan_bwd(*args)
        again = SS.ssm_scan_bwd(*args)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{K8_BWD_ROW}[{key}]: every output finite")
        # the plain version (a Python loop over the tokens), timed by the
        # events around its one call
        want = []
        plain_ms = time_events(lambda: want.append(SS.ssm_scan_bwd_ref(
            *args)), reps=1, warm=0)
        want = want[0]
        tag = f"{K8_BWD_ROW}[{key}: B {B} S {S} H {H} hd {hd} N {N}]"
        for name, g, w in zip(names, got, want):
            top = float(w.abs().max())
            row["max_abs_err"] = max(row["max_abs_err"], compare(
                f"{tag}.{name} (largest |ref| {top:.3e})", g, w, rtol=rtol,
                atol=atol * top))
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: two calls bitwise equal")
        del again, want
        if i == 0:
            row["nbytes"] = nbytes(*args, *got)
            row["ops"] = scan_bwd_flops(B, S, H, hd, N)
            row["bound_ms"], row["bound_by"] = bound_ms(row["nbytes"],
                                                        row["ops"])
            row["ms"] = device_ms(lambda: SS.ssm_scan_bwd(*args),
                                  K8_BWD_ROW, reps=20)
            row["plain_ms"] = plain_ms
            split = DT.kernel_means(lambda: SS.ssm_scan_bwd(*args),
                                    K8_BWD_KERNELS, reps=20)
            if row["ms"] is not None:
                print(f"time {K8_BWD_ROW} at {tag}: device "
                      f"{row['ms'] * 1e3:.2f} us per call, plain "
                      f"{row['plain_ms'] * 1e3:.1f} us, bound "
                      f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}; "
                      f"{row['nbytes'] / 1e6:.1f} MB, "
                      f"{row['ops'] / 1e9:.2f} GFLOP), "
                      f"{row['ms'] / row['bound_ms']:.2f}x; by launch "
                      + ", ".join(f"{n} {m:.4f} ms ({c} records)"
                                  for n, (m, c) in split.items()
                                  if m is not None)
                      + f" on {card}", flush=True)
        del args, got
        torch.cuda.empty_cache()


def k7_bwd_rows(dev, card, rows) -> None:
    """K7's backward kernel (``rwkv_chunked_bthd_bwd``) at
    ``K7_BWD_LAYOUTS`` against its plain version
    (``rwkv_chunked_bthd_bwd_ref``) and against autograd through K7's plain
    version, every gradient; two calls bit for bit; at rwkv6-3b's training
    microbatch its device time beside its bound and the plain version's,
    and its split by launch."""
    row = rows[K7_BWD_ROW] = dict(max_abs_err=0.0)
    for i, (key, (B, T, H, hd, C, u_b)) in enumerate(
            K7_BWD_LAYOUTS.items()):
        rng = np.random.default_rng(70 + i)

        def f32(a):
            return torch.as_tensor(a.astype(np.float32)).to(dev)
        r, k, v, gy = (f32(rng.standard_normal((B, T, H, hd)) * 0.5)
                       for _ in range(4))
        w = f32(rng.uniform(0.6, 0.999, (B, T, H, hd)))
        u = f32(rng.standard_normal((B, H, hd) if u_b else (H, hd)) * 0.1)
        gS = f32(rng.standard_normal((B, H, hd, hd)) * 0.1)
        args = (r, k, v, w, u, gy, gS)
        got = RC.rwkv_chunked_bthd_bwd(*args, chunk=C)
        again = RC.rwkv_chunked_bthd_bwd(*args, chunk=C)
        tag = (f"{K7_BWD_ROW}[{key}: B {B} T {T} H {H} hd {hd} C {C}, u "
               f"{tuple(u.shape)}]")
        # the plain version, timed by the events around its one call
        want = []
        plain_ms = time_events(lambda: want.append(
            RC.rwkv_chunked_bthd_bwd_ref(*args, chunk=C)), reps=1, warm=0)
        want = want[0]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: two calls bitwise equal")
        for name, g, wt in zip("rkvwu", got, want):
            err = float((g - wt).abs().max() / wt.abs().max())
            row["max_abs_err"] = max(row["max_abs_err"],
                                     float((g - wt).abs().max()))
            check(g.shape == wt.shape and err < K7_BWD_TOL,
                  f"{tag}.d{name} against the plain version: {err:.3e} of "
                  f"its largest magnitude (limit {K7_BWD_TOL})")
        del want, again
        ins = [t.clone().requires_grad_() for t in args[:5]]
        y, S = RC.rwkv_chunked_bthd_ref(*ins, chunk=C, return_state=True)
        want = torch.autograd.grad((y, S), ins, (gy, gS))
        del y, S, ins
        for name, g, wt in zip("rkvwu", got, want):
            err = float((g - wt).abs().max() / wt.abs().max())
            check(g.shape == wt.shape and err < K7_BWD_TOL,
                  f"{tag}.d{name} against autograd through the plain "
                  f"version: {err:.3e} of its largest magnitude (limit "
                  f"{K7_BWD_TOL})")
        del want
        if i == 0:
            row["nbytes"] = nbytes(*args, *got)
            row["ops"] = rwkv_bwd_flops(B * H, T, hd)
            row["bound_ms"], row["bound_by"] = bound_ms(row["nbytes"],
                                                        row["ops"])
            row["ms"] = device_ms(lambda: RC.rwkv_chunked_bthd_bwd(
                *args, chunk=C), K7_BWD_ROW, reps=20)
            row["plain_ms"] = plain_ms
            split = DT.kernel_means(lambda: RC.rwkv_chunked_bthd_bwd(
                *args, chunk=C), K7_BWD_KERNELS, reps=20)
            if row["ms"] is not None:
                print(f"time {tag}: device {row['ms']:.4f} ms per call, "
                      f"plain {row['plain_ms']:.3f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                      f"{row['nbytes'] / 1e9:.3f} GB, "
                      f"{row['ops'] / 1e9:.2f} GFLOP), "
                      f"{row['ms'] / row['bound_ms']:.2f}x; by launch "
                      + ", ".join(f"{n} {m:.4f} ms ({c} records)"
                                  for n, (m, c) in split.items()
                                  if m is not None)
                      + f" on {card}", flush=True)
        del args, got, r, k, v, w, u, gy, gS
        torch.cuda.empty_cache()


def scan_train_phase(dev, card, rows) -> None:
    """hymba-1.5b and rwkv6-3b at full width through ``launch.train.train``
    (8 x 4096 tokens a step in 2 microbatches, 2 steps, DVFS on, no
    checkpoint): ``run_train``'s checks, every parameter moved, K6 / K6
    backward / K7 / K7 backward / K8 / K8 backward launches per layer and
    microbatch, and one step's device time by class."""
    for arch in SCAN_TRAIN_ARCHS:
        cfg = get_config(arch)
        mb, steps = SCAN_TRAIN_MB, SCAN_TRAIN_STEPS
        tc = TrainConfig(total_steps=steps, warmup_steps=1, microbatches=mb,
                         checkpoint_every=0)
        print(f"train {arch}: {cfg.n_params / 1e9:.3f} B parameters, "
              f"{cfg.n_layers} layers, d {cfg.d_model}; shape "
              f"{TRAIN_SHAPE.global_batch} x {TRAIN_SHAPE.seq_len} a step in "
              f"{mb} microbatches, {steps} steps, remat {cfg.remat}, no "
              f"checkpoint, on {card}", flush=True)
        state, _, mean_s = run_train(cfg, tc, steps, dev, card,
                                     save_final=False)
        got = (FA.flash_attention_bshd.launches,
               FA.flash_attention_bshd_bwd.launches,
               RC.rwkv_chunked_bthd.launches,
               RC.rwkv_chunked_bthd_bwd.launches, SS.ssm_scan.launches,
               SS.ssm_scan_bwd.launches)
        want = tuple(steps * cfg.n_layers * mb * n for n in (
            (2, 1, 0, 0, 2, 1) if cfg.family == "hybrid"
            else (0, 0, 2, 1, 0, 0)))
        check(got == want,
              f"train {arch}: launches K6 {got[0]}, K6 backward {got[1]}, K7 "
              f"{got[2]}, K7 backward {got[3]}, K8 {got[4]}, K8 backward "
              f"{got[5]} == {want} ({steps} steps x {cfg.n_layers} layers x "
              f"{mb} microbatches x (forward and recompute; the backwards "
              f"once))")
        if cfg.family == "hybrid":
            rows[K8_BWD_ROW]["launches"] = got[5]
        else:
            rows[K7_BWD_ROW]["launches"] = got[3]
        moved_check(cfg, state, LM.init_params(cfg, tc.seed, dev))
        torch.cuda.empty_cache()
        split = step_split(cfg, tc, state, mean_s, dev, card)
        train_forward_bound(cfg, split, 2 * cfg.n_layers * mb, card)
        del state
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    # ---- 1. TF32 off, build ------------------------------------------------
    mark("1")
    no_tf32()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is off")
    t0 = time.perf_counter()
    K.library()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc build {K.BUILD['seconds']:.1f} s)", flush=True)
    for line in K.BUILD["log"].splitlines():
        k8 = re.search(r"Function properties for .*?(ssm_scan_fwd_"
                       r"(?:increments|outputs))ILi(\d+)ELi(\d+)E", line)
        if k8:
            print(f"  {k8.group(1)}<hd {k8.group(2)}, N {k8.group(3)}>")
            continue
        k7b = re.search(r"Function properties for .*?(rwkv_chunk_bwd_"
                        r"(?:increments|chains|grads))ILi(\d+)E", line)
        if k7b:
            print(f"  {k7b.group(1)}<hd {k7b.group(2)}>")
            continue
        kb = re.search(r"Function properties for .*?(flash_attention_bwd_"
                       r"(?:dkdv_wgmma|dq_wgmma|dkdv_f32|dq_f32|dkdv|dq|"
                       r"dot))I(.*?)EEv", line)
        if kb:
            args = re.findall(r"Li(\d+)E", kb.group(2)) or [
                "bf16" if "bfloat16" in kb.group(2) else "f32"]
            print(f"  {kb.group(1)}<{', '.join(args)}>")
            continue
        k6 = re.search(r"Function properties for .*?"
                       r"flash_attention_kernel_wgmmaILi(\d+)ELb([01])E", line)
        if k6:
            print(f"  flash_attention_kernel_wgmma<hd {k6.group(1)}, "
                  f"prefix {'yes' if k6.group(2) == '1' else 'no'}>")
            continue
        fn = re.search(r"Function properties for .*?(epoch_pass_a|"
                       r"epoch_pass_b|"
                       r"epoch_epilogue|pc_table_\w+?_kernel|"
                       r"flash_attention_kernel_wgmma|"
                       r"flash_attention_kernel|rwkv_chunk_kernel|"
                       r"ssm_scan_fwd_chains)"
                       r"(ILi(\d+)E|I(13__nv_bfloat16|f)Li(\d+)|I([ix])E)?",
                       line)
        if fn:
            tmpl = fn.group(3) or (fn.group(4) and (
                ("bf16" if fn.group(4) != "f" else "f32")
                + f", {fn.group(5)}")) or (
                    fn.group(6) and {"i": "int32", "x": "int64"}[fn.group(6)])
            print("  " + fn.group(1) + (f"<{tmpl}>" if tmpl else ""))
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    # K6 runs only its tensor-core kernel, K7 only its kernel and its
    # reset (torch.profiler, in a process of their own)
    lm_ran = lm_ran_on_card()
    for key, _ in K6_ROWS.values():
        ran = sorted(n for n in lm_ran.get(key, {})
                     if "flash_attention" in n)
        check(len(ran) == 1 and "flash_attention_kernel_wgmma" in ran[0],
              f"{key} bf16 ran only the tensor-core kernel: {ran}")
    ran = sorted(lm_ran.get("rwkv_chunked", {}))
    k7_names = [n for n in ran if "rwkv_chunk_kernel" in n]
    check(len(k7_names) == 1 and set(ran) <= set(k7_names)
          | {"Memset (Device)"},
          f"rwkv_chunked ran only K7's kernel and its memset: {ran}")
    # K8: its three launches, one record each per call of the five, and
    # nothing else
    ran = lm_ran.get("ssm_scan", {})
    check(len(ran) == len(K8_KERNELS) and all(
        sum(c for n, c in ran.items() if k in n) == 5 for k in K8_KERNELS),
          f"ssm_scan ran K8's three kernels, one record each per call, and "
          f"nothing else: {ran}")
    # a whole paligemma prefill: K6 (its bf16 kernel) once per layer, and
    # no attention kernel of the library in its place
    ran = lm_ran.get(f"{VLM_ARCH} prefill", {})
    k6 = {n: c for n, c in ran.items() if "flash_attention_kernel" in n}
    other = sorted(n for n in ran if n not in k6 and any(
        t in n.lower() for t in LIBRARY_ATTENTION))
    layers = get_config(VLM_ARCH).n_layers
    check(len(k6) == 1 and "flash_attention_kernel_wgmma" in next(iter(k6))
          and sum(k6.values()) == layers and not other,
          f"{VLM_ARCH} prefill ran K6 once per layer ({layers}) and no "
          f"other attention kernel: {k6}, others {other}")

    # ---- 2. kernels against their plain versions -------------------------
    mark("2")
    rows = {}
    tbl, tid, idx32, fb = table_case(7, dev)
    F = PWR.freqs_ghz(PWR.DEFAULT, NF, device=dev)
    # the slots and scalars as the main path passes them: int64 slots,
    # 0-dim tensors on the card; int32 slots and floats are held too
    idx = idx32.long()
    kp = dict(epoch_us=torch.tensor(1.0, device=dev),
              cap_per_ghz=torch.tensor(5500.0, device=dev))
    ema = torch.tensor(0.5, device=dev)
    shp = (T_TABLES, CU // T_TABLES * WF)
    upd_in = (idx.reshape(shp), fb[0].reshape(shp), fb[1].reshape(shp))
    want, want_hit = REF.pc_table_predict_ref(*tbl, tid, idx, *fb, F, **kp,
                                              return_hit=True)
    want_upd = REF.pc_table_update_ref(*tbl, *upd_in, ema=ema)
    k1_err = k2_err = 0.0
    for ix, scal in ((idx, "tensor"), (idx32, "tensor"), (idx, "float"),
                     (idx32, "float")):
        tag = f"{str(ix.dtype).split('.')[-1]} slots, {scal} scalars"
        pk = kp if scal == "tensor" else dict(epoch_us=1.0,
                                              cap_per_ghz=5500.0)
        got, hit = KPT.pc_table_predict(*tbl, tid, ix, *fb, F, **pk,
                                        return_hit=True)
        upd = KPT.pc_table_update(*tbl, ix.reshape(shp), *upd_in[1:],
                                  ema=ema if scal == "tensor" else 0.5)
        torch.cuda.synchronize()
        k1_err = max(k1_err, compare(f"pc_table_predict[{tag}]", got, want))
        check(torch.equal(hit, want_hit),
              f"pc_table_predict[{tag}].hit: equal to the plain version's "
              f"({int((hit != want_hit).sum())} differ)")
        k2_err = max([k2_err] + [
            compare(f"pc_table_update[{tag}].{k}", g, w)
            for k, g, w in zip(("i0", "sens", "count"), upd, want_upd)])
    rows["pc_table_predict"] = dict(
        max_abs_err=k1_err, nbytes=nbytes(*tbl, tid, idx, *fb, F, got, hit),
        ops=2 * CU * WF + 5 * CU * NF)
    rows["pc_table_update"] = dict(
        max_abs_err=k2_err, nbytes=nbytes(*tbl, *upd_in, *upd),
        ops=3 * T_TABLES * shp[1] + 12 * T_TABLES * ENTRIES)
    # one wrapper call is one kernel and nothing else on the card (traced
    # before any other profiler session of this process: CUPTI drops
    # records once a process has traced a few thousand)
    for key, fn in (
            ("pc_table_predict", lambda: KPT.pc_table_predict(
                *tbl, tid, idx, *fb, F, **kp, return_hit=True)),
            ("pc_table_update", lambda: KPT.pc_table_update(
                *tbl, *upd_in, ema=ema))):
        ran = DT.kernel_counts(fn, 4)
        check(len(ran) == 1 and f"{key}_kernel" in next(iter(ran))
              and sum(ran.values()) == 4,
              f"{key}: 4 calls ran 4 launches of one kernel: {ran}")
    # what a v1 pcstall epoch (64 x 40, comd) runs on the card
    v1_sim = SIM.SimConfig(n_epochs=N_EPOCHS, use_pallas="v1")
    v1_prog = get_workload("comd", device=dev)
    st_v1, ax_v1 = v1_sim.static_part(), v1_sim.axes(dev)
    v1_step = SIM._make_step(v1_prog, v1_prog.n_blocks, 0, st_v1, ax_v1,
                             "pcstall")
    v1_box = [SIM.init_carry(v1_prog.n_blocks, st_v1, dev)]

    def v1_epoch():
        v1_box[0], _ = v1_step(v1_box[0])

    ran = DT.kernel_counts(v1_epoch, V1_PROFILED)
    pair = sorted((re.search(r"pc_table_\w+_kernel", n).group(0), c)
                  for n, c in ran.items() if "pc_table_" in n)
    check(len(pair) == 2 and all(c == V1_PROFILED for _, c in pair),
          f"v1 epoch: one K1 and one K2 launch each: {pair}")
    v1_per_epoch = sum(ran.values()) / V1_PROFILED
    print(f"v1 epoch (pcstall, 64 x 40): {v1_per_epoch:.1f} launches on the "
          f"card per epoch over {V1_PROFILED} epochs (torch.profiler), of "
          f"them K1 and K2 one each; {len(ran)} distinct on {card}",
          flush=True)
    del v1_box, v1_step

    def epoch_vs(tag, key, got, want):
        errs = []
        for field in got._fields:
            g, w = getattr(got, field), getattr(want, field)
            if g is None:
                continue
            if field == "table":
                for k, gg, ww in zip(("i0", "sens", "count"), g, w):
                    errs.append(compare(f"{tag}.table.{k}", gg, ww))
            else:
                errs.append(compare(f"{tag}.{field}", g, w))
        row = rows.setdefault(key, dict(max_abs_err=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], max(errs))
        return row

    epoch_inputs = {}
    for fam, fork_est, model in EPOCH_FAMS:
        for lean in (True, False):
            args, kw = epoch_case(fam, fork_est, model, 11, dev)
            kw["lean"] = lean
            got = KEF.epoch_fused(*args, **kw)
            want = KEF.epoch_fused_ref(*args, **kw)
            torch.cuda.synchronize()
            tag = f"epoch_fused[{fam},{model or ('fork-est' if fork_est else '')},lean={lean}]"
            key = f"epoch_fused[{fam}]"
            row = epoch_vs(tag, key, got, want)
            if lean and key not in epoch_inputs:
                epoch_inputs[key] = (args, kw)
                row["nbytes"] = epoch_bytes(args, kw, got)
                row["ops"] = epoch_flops(fam)

    # ---- 2a. K3 at the README's 304 x 40 (two CUs per CTA) -------------
    mark("2a")
    for fam, fork_est, model in EPOCH_FAMS:
        args, kw = epoch_case(fam, fork_est, model, 13, dev,
                              cu=WIDE_SIM.n_cu, tables=WIDE_SIM.n_cu)
        got = KEF.epoch_fused(*args, **kw)
        want = KEF.epoch_fused_ref(*args, **kw)
        torch.cuda.synchronize()
        key = f"epoch_fused[{fam}@304]"
        row = epoch_vs(f"epoch_fused[{fam},{model or fork_est},304 x 40]",
                       key, got, want)
        if key not in epoch_inputs:
            epoch_inputs[key] = (args, kw)
            row["nbytes"] = epoch_bytes(args, kw, got)
            row["ops"] = epoch_flops(fam, WIDE_SIM.n_cu, WF, WIDE_SIM.n_cu)

    # ---- 2b. K4: the fork family over grid rows ---------------------------
    mark("2b")
    fork_row = rows.setdefault("epoch_fused[fork]", dict(max_abs_err=0.0))
    ids7 = list(range(7))
    for lean in (True, False):
        args, kw = fork_rows_case(ids7, ["comd"], 21, dev)
        kw["lean"] = lean
        got = out_fields(KEF.epoch_fused_rows(*args, **kw))
        want = out_fields(KEF.epoch_fused_rows_ref(*args, **kw))
        torch.cuda.synchronize()
        for field, w in want.items():
            fork_row["max_abs_err"] = max(fork_row["max_abs_err"], compare(
                f"epoch_fused[fork,ids 0-6,lean={lean}].{field}",
                got[field], w))
    mix_ids = [int(i) for i in np.random.default_rng(5).integers(0, 7, 300)]
    mix_names = FIG15_WORKLOADS[:5]
    args, kw = fork_rows_case(mix_ids, mix_names, 22, dev,
                              lens=[1024, 768, 512, 896, 640])
    n0 = KEF.epoch_fused.launches_by_family["fork"]
    got = out_fields(KEF.epoch_fused_rows(*args, **kw))
    check(KEF.epoch_fused.launches_by_family["fork"] == n0 + 1,
          "epoch_fused[fork]: 300 rows in one call")
    want = out_fields(KEF.epoch_fused_rows_ref(*args, **kw))
    torch.cuda.synchronize()
    for field, w in want.items():
        fork_row["max_abs_err"] = max(fork_row["max_abs_err"], compare(
            f"epoch_fused[fork,300 mixed rows].{field}", got[field], w))
    # K4 at the managers' layout: each CU on its own warp and table. The
    # step programs are compute-bound, so a reactive row's react_i0 (the
    # CU's fork totals less sens x f, over T) is the small remainder of
    # operands of the order of the CU's committed work: held at that
    # scale, as true_sens is in tests/test_torch_cuda.py
    mgr_progs = [arch_program(get_config(a), TRAIN_4K, device=dev)
                 for a in MANAGER_ARCHS]
    pcstall = SIM.FORK_MECH_IDS["pcstall"]
    for tag, ids in (("ids 0-6", ids7), ("4 pcstall rows", [pcstall] * 4)):
        args, kw = fork_rows_case(ids, mgr_progs, 27, dev, cu=MANAGER_CU,
                                  tables=MANAGER_CU)
        got = out_fields(KEF.epoch_fused_rows(*args, **kw))
        want = out_fields(KEF.epoch_fused_rows_ref(*args, **kw))
        torch.cuda.synchronize()
        i0_scale = 2 * want["work"].abs().amax(-1, keepdim=True) \
            / kw["scal"][:, :1]
        for field, w in want.items():
            fork_row["max_abs_err"] = max(fork_row["max_abs_err"], compare(
                f"epoch_fused[fork,{MANAGER_CU} x {WF} managers' programs,"
                f"{tag}].{field}", got[field], w,
                scale=i0_scale if field == "react_i0" else None))
    # each K4 row against K3 run as that row's mechanism, same inputs: one
    # chain of device functions, so bit for bit, at two CTA widths
    args, kw = fork_rows_case(ids7, ["comd"], 23, dev)
    widths7 = (KEF.cta_width(CU, len(ids7)), KEF.cta_width(CU, 1))
    check(widths7[0] != widths7[1], f"CTA widths {widths7} differ")
    fork = out_fields(KEF.epoch_fused_rows(*args, **kw))
    for m in ids7:
        spec = SIM.MECH.get(SIM.FORK_MECHS[m])
        sc = kw["scal"][m]
        one = dict(p_blocks=P, epoch_us=sc[0], sigma=sc[1],
                   cap_per_ghz=sc[2], membw=sc[3], table_ema=sc[4],
                   obj=sc[5:8], lat_us=sc[8],
                   power=PWR.PowerAxes(*kw["power"][m].unbind(0)),
                   family=spec.family, fork_estimator=spec.fork_estimator,
                   cu_model=spec.cu_model, offset_blocks=8)
        groups = {"table": ("table.i0", "table.sens", "table.count",
                            "wf_i0", "wf_sens"),
                  "react": ("react_i0", "react_sens")}
        if spec.family == "pc":
            one.update(table=PRED.PCTable(*(t[m] for t in kw["table"])),
                       tid=kw["tid"], wf_i0=kw["wf_i0"][m],
                       wf_sens=kw["wf_sens"][m])
            live, dead = groups["table"], groups["react"]
        else:
            one.update(react_i0=kw["react_i0"][m],
                       react_sens=kw["react_sens"][m])
            live, dead = groups["react"], groups["table"]
        k3 = out_fields(KEF.epoch_fused(
            args[0][0], args[1][0], args[2][0], args[4][m], args[5][m],
            args[6][m], args[7][m], args[8][m], args[9][m:m + 1], **one))
        torch.cuda.synchronize()
        tag = f"K4 row id {m} vs K3 {spec.name}"
        differ = [f for f in live + ("pos", "fidx", "f_sel", "work",
                                     "energy", "err", "e_acc", "true_sens")
                  if not torch.equal(fork[f][m], k3[f])]
        check(not differ, f"{tag} (CTA width {widths7[0]} vs "
              f"{widths7[1]}): bitwise in every output K3 writes"
              + (f" (differ in {differ})" if differ else ""))
        inputs = {"table.i0": kw["table"].i0[m],
                  "table.sens": kw["table"].sens[m],
                  "table.count": kw["table"].count[m],
                  "wf_i0": kw["wf_i0"][m], "wf_sens": kw["wf_sens"][m],
                  "react_i0": kw["react_i0"][m],
                  "react_sens": kw["react_sens"][m]}
        check(all(torch.equal(fork[f][m], inputs[f]) for f in dead),
              f"{tag}: dead state {dead[0].split('.')[0]} passed through "
              f"bitwise")

    # ---- 2c. K5: the fork family in the reference's tiling (K4's kernels;
    mark("2c")
    # block_cu checked and inert), 304 x 40 / 38, against the reference's
    # blocked pair
    blk_row = rows.setdefault("epoch_fused[fork_blocked]",
                              dict(max_abs_err=0.0))
    blk_cu = SVC_SIM.pallas_block_cu
    wide = dict(cu=SVC_SIM.n_cu, wf=SVC_SIM.n_wf, tables=SVC_SIM.n_cu)

    def blocked_vs_plain(tag, args, kw):
        got = out_fields(KEF.epoch_fused_rows(*args, **kw, block_cu=blk_cu))
        want = out_fields(KEF.epoch_fused_rows_blocked_ref(
            *args, **kw, block_cu=blk_cu))
        torch.cuda.synchronize()
        for field, w in want.items():
            blk_row["max_abs_err"] = max(blk_row["max_abs_err"], compare(
                f"epoch_fused[fork_blocked,{tag}].{field}", got[field], w))

    args, kw = fork_rows_case(ids7, ["comd", "lulesh"], 24, dev, **wide)
    blocked_vs_plain("ids 0-6", args, kw)
    mix8 = [0, 1, 2, 3, 4, 5, 6, 5]
    args8, kw8 = fork_rows_case(mix8, list(SVC_WORKLOADS), 25, dev,
                                lens=[1024, 768, 896, 512], **wide)
    n0 = KEF.epoch_fused.launches_by_family["fork"]
    blocked_vs_plain("R=8 mixed", args8, kw8)
    check(KEF.epoch_fused.launches_by_family["fork"] == n0 + 1,
          "epoch_fused[fork_blocked]: 8 rows in one call")

    # a row's bits do not depend on the CTA width the launcher picks: rows
    # alone against the same rows among 42 at 64 x 40 and among 8 at the
    # service's 304 x 40
    def one_row(args, kw, r):
        a1 = tuple(x[r:r + 1] if i not in (0, 1, 2) else x
                   for i, x in enumerate(args))
        k1 = dict(kw)
        for f in ("p_blocks", "mech", "scal", "power", "wf_i0", "wf_sens",
                  "react_i0", "react_sens"):
            k1[f] = kw[f][r:r + 1]
        k1["table"] = PRED.PCTable(*(t[r:r + 1] for t in kw["table"]))
        return a1, k1

    args42, kw42 = fork_rows_case(ids7 * 6, ["comd", "lulesh"], 26, dev)
    for tag, (a, k), cu, rs in (("42 at 64 x 40", (args42, kw42), CU,
                                 range(7)),
                                ("8 at 304 x 40", (args8, kw8), SVC_SIM.n_cu,
                                 (0, 5))):
        many = out_fields(KEF.epoch_fused_rows(*a, **k))
        w_many, w_one = KEF.cta_width(cu, len(k["mech"])), \
            KEF.cta_width(cu, 1)
        check(w_many != w_one, f"rows among {tag}: CTA widths {w_many} and "
              f"{w_one} differ")
        differ = []
        for r in rs:
            a1, k1 = one_row(a, k, r)
            alone = out_fields(KEF.epoch_fused_rows(*a1, **k1))
            differ += [(r, f) for f in alone
                       if not torch.equal(alone[f][0], many[f][r])]
        torch.cuda.synchronize()
        check(not differ, f"rows {list(rs)} among {tag} (CTA width "
              f"{w_many}) bitwise == each row alone (width {w_one})"
              + (f" (differ in {differ})" if differ else ""))

    # ---- 2d. K6, K7 and K8 at the LM prefill shapes ----------------------
    mark("2d")
    k6_in, k7_in, k8_in = lm_cases(dev)
    for key, (cfg, cases) in k6_in.items():
        k6_row = rows.setdefault(key, dict(max_abs_err=0.0))
        w, pre = k6_window(cfg), k6_prefix(cfg)
        for dt, (q, k, v) in cases.items():
            got = FA.flash_attention_bshd(q, k, v, causal=True, window=w,
                                          prefix_len=pre)
            want = FA.flash_attention_bshd_ref(q, k, v, causal=True,
                                               window=w, prefix_len=pre)
            torch.cuda.synchronize()
            rtol, atol = K6_TOL[dt]
            k6_row["max_abs_err"] = max(k6_row["max_abs_err"], compare(
                f"{key}[{str(dt).split('.')[-1]}, B {SERVE_BATCH} S "
                f"{SERVE_PROMPT} H {cfg.n_heads} Hkv {cfg.n_kv_heads} hd "
                f"{cfg.resolved_head_dim} window {w} prefix {pre}]",
                got.float(), want.float(), rtol=rtol, atol=atol))
            del got, want
        q, k, v = cases[torch.bfloat16]
        k6_row["nbytes"] = nbytes(q, k, v, q)
        k6_row["ops"] = attention_flops(SERVE_BATCH, SERVE_PROMPT,
                                        q.shape[2], q.shape[3], w, pre)
    k7_row = rows.setdefault("rwkv_chunked", dict(max_abs_err=0.0))
    got, S_got = RC.rwkv_chunked_bthd(*k7_in, return_state=True)
    want, S_want = RC.rwkv_chunked_bthd_ref(*k7_in, return_state=True)
    torch.cuda.synchronize()
    k7_row["max_abs_err"] = max(
        compare(f"rwkv_chunked[B {SERVE_BATCH} T {SERVE_PROMPT} H 40 hd 64 "
                f"C 128].y", got, want, rtol=K7_TOL, atol=K7_TOL),
        compare("rwkv_chunked[...].S_T", S_got, S_want, rtol=K7_TOL,
                atol=K7_TOL))
    B7, T7, H7, hd7 = k7_in[0].shape
    k7_row["nbytes"] = nbytes(*k7_in, got)
    k7_row["ops"] = rwkv_flops(B7 * H7, T7, hd7)
    del got, want, S_got, S_want
    # K8 at the hymba-1.5b prefill and at a decode step, from a non-zero
    # state: y and the final state at the kernel limits RTOL / ATOL (f32,
    # each step rounded as the plain version's; y's sum over the state in
    # an order torch's einsum need not keep)
    k8_row = rows.setdefault("ssm_scan", dict(max_abs_err=0.0))
    for case, args in k8_in.items():
        y, h_out = SS.ssm_scan(*args)
        y_ref, h_ref = SS.ssm_scan_ref(*args)
        torch.cuda.synchronize()
        B8, S8, H8, hd8 = args[0].shape
        N8 = args[2].shape[-1]
        tag = f"ssm_scan[{case}: B {B8} S {S8} H {H8} hd {hd8} N {N8}]"
        k8_row["max_abs_err"] = max(
            k8_row["max_abs_err"], compare(f"{tag}.y", y, y_ref),
            compare(f"{tag}.h_out", h_out, h_ref))
        if case == "prefill":
            k8_row["nbytes"] = nbytes(*args, y, h_out)
            k8_row["ops"] = scan_flops(B8, S8, H8, hd8, N8)
        del y, h_out, y_ref, h_ref
    torch.cuda.empty_cache()

    # ---- 3. times ----------------------------------------------------------
    mark("3")
    times = {}
    # K1 and K2 as the v1 epoch calls them: int64 slots, 0-dim scalars on
    # the card, the hit mask
    times["pc_table_predict"] = (
        lambda: KPT.pc_table_predict(*tbl, tid, idx, *fb, F, **kp,
                                     return_hit=True),
        lambda: REF.pc_table_predict_ref(*tbl, tid, idx, *fb, F, **kp,
                                         return_hit=True),
        ("pc_table_predict_kernel",))
    times["pc_table_update"] = (
        lambda: KPT.pc_table_update(*tbl, *upd_in, ema=ema),
        lambda: REF.pc_table_update_ref(*tbl, *upd_in, ema=ema),
        ("pc_table_update_kernel",))
    for key, (args, kw) in epoch_inputs.items():
        fam = key[len("epoch_fused["):-1].split("@")[0]
        times[key] = (lambda a=args, k=kw: KEF.epoch_fused(*a, **k),
                      lambda a=args, k=kw: KEF.epoch_fused_ref(*a, **k),
                      TILED[fam])
    # K4 at the Fig-15 grid's layout: its 10 programs x the 4 traced ids
    ids40 = [SIM.FORK_MECH_IDS[m] for m in ("crisp", "accreac", "pcstall",
                                            "accpc")]
    args40, kw40 = fork_rows_case([i for i in ids40 for _ in range(10)],
                                  FIG15_WORKLOADS, 31, dev)
    out40 = KEF.epoch_fused_rows(*args40, **kw40)
    fork_row["nbytes"] = rows_bytes(args40, kw40, out40)
    fork_row["ops"] = fork_flops(40)
    times["epoch_fused[fork]"] = (
        lambda: KEF.epoch_fused_rows(*args40, **kw40),
        lambda: KEF.epoch_fused_rows_ref(*args40, **kw40), TILED["fork"])
    # K5 at the service's layout: 8 rows at 304 x 40 in blocks of 38
    blk_row["nbytes"] = rows_bytes(args8, kw8, KEF.epoch_fused_rows(
        *args8, **kw8, block_cu=blk_cu))
    blk_row["ops"] = fork_flops(8, SVC_SIM.n_cu, SVC_SIM.n_wf, SVC_SIM.n_cu)
    times["epoch_fused[fork_blocked]"] = (
        lambda: KEF.epoch_fused_rows(*args8, **kw8, block_cu=blk_cu),
        lambda: KEF.epoch_fused_rows_blocked_ref(*args8, **kw8,
                                                 block_cu=blk_cu),
        TILED["fork"])
    # K6 at every attention model's prefill in bf16 (the served dtype),
    # K7 at the rwkv6-3b prefill, K8 at the hymba-1.5b prefill
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, (cfg, cases) in k6_in.items():
        q, k, v = cases[torch.bfloat16]
        w, pre = k6_window(cfg), k6_prefix(cfg)
        times[key] = (
            lambda q=q, k=k, v=v, w=w, pre=pre: FA.flash_attention_bshd(
                q, k, v, causal=True, window=w, prefix_len=pre),
            lambda q=q, k=k, v=v, w=w, pre=pre: FA.flash_attention_bshd_ref(
                q, k, v, causal=True, window=w, prefix_len=pre),
            ("flash_attention_kernel_wgmma",))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # the library's causal attention; with a sliding window or a
        # prefix, its attention under K6's mask as a boolean tensor
        lib_kw = dict(is_causal=True)
        if w or pre:
            lib_kw = dict(attn_mask=k6_mask(cfg, SERVE_PROMPT, dev))
        rows[key]["library_ms"] = time_events(
            lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib_kw),
            reps=50, warm=5)
        lib_err = (sdpa(qt, kt, vt, enable_gqa=True, **lib_kw)
                   .transpose(1, 2).float()
                   - FA.flash_attention_bshd(q, k, v, window=w,
                                             prefix_len=pre).float()
                   ).abs().max()
        print(f"library scaled_dot_product_attention (bf16, causal"
              f"{f', window {w}' if w else ''}"
              f"{f', prefix {pre}' if pre else ''}"
              f"{' as a mask' if w or pre else ''}) at "
              f"{key}'s prefill: {rows[key]['library_ms'] * 1e3:.2f} us per "
              f"call, max |K6 - library| {float(lib_err):.3e} on {card}",
              flush=True)
    # K7: one memset (the tickets and the chain's flags) and one kernel
    times["rwkv_chunked"] = (
        lambda: RC.rwkv_chunked_bthd(*k7_in),
        lambda: RC.rwkv_chunked_bthd_ref(*k7_in),
        ("rwkv_chunk_kernel", "Memset (Device)"))
    # K8: three launches; its plain version is a loop over the 2048 tokens
    times["ssm_scan"] = (
        lambda: SS.ssm_scan(*k8_in["prefill"]),
        lambda: SS.ssm_scan_ref(*k8_in["prefill"]), K8_KERNELS)
    rates = dict.fromkeys(k6_in, PEAK_FLOPS_BF16)
    # the least device time a call of one launch can take
    floor_ms = device_ms(lambda: torch.cuda._sleep(1), "launch floor")
    for key, (kern, plain, names) in times.items():
        ev = time_events(kern)
        dv = device_ms(kern, key)
        row = rows[key]
        row["events_ms"] = ev
        row["ms"] = dv
        slow = "fork" in key or "@" in key or key in rates \
            or key in ("rwkv_chunked", "ssm_scan")
        row["plain_ms"] = time_events(plain, reps=3 if slow else 50,
                                      warm=1 if slow else 5)
        row["bound_ms"], row["bound_by"] = bound_ms(
            row["nbytes"], row["ops"], rates.get(key, PEAK_FLOPS_F32))
        if dv is None:
            continue
        print(f"time {key}: device {dv * 1e3:.2f} us per call, "
              f"{ev * 1e3:.2f} us per call with the host (events), plain "
              f"{row['plain_ms'] * 1e3:.1f} us, bound "
              f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}) "
              f"on {card}", flush=True)
        if key.startswith("pc_table") and floor_ms is not None:
            print(f"time {key}: the launch floor (torch.cuda._sleep(1), "
                  f"the same method) {floor_ms * 1e3:.2f} us per call "
                  f"beside the bound {row['bound_ms'] * 1e3:.4f} us on "
                  f"{card}", flush=True)
        if len(names) > 1 or key.startswith("pc_table"):
            means = DT.kernel_means(kern, names)
            print(f"time {key} by kernel (profiler, mean over the records "
                  f"kept of 100): " + ", ".join(
                      f"{n} {m * 1e3:.2f} us ({c})" for n, (m, c)
                      in means.items() if m is not None)
                  + f" on {card}", flush=True)
    # K4 on one row (the quickstart's size of a grid)
    args1, kw1 = fork_rows_case([SIM.FORK_MECH_IDS["pcstall"]], ["comd"], 32,
                                dev)
    k4_r1 = lambda: KEF.epoch_fused_rows(*args1, **kw1)  # noqa: E731
    r1_dev = device_ms(k4_r1, "epoch_fused[fork] R=1")
    if r1_dev is not None:
        print(f"time epoch_fused[fork] R=1 (pcstall row): device "
              f"{r1_dev * 1e3:.2f} us per call, "
              f"{time_events(k4_r1) * 1e3:.2f} us per call (events) on "
              f"{card}", flush=True)
    # K6 in bf16 against its bound and the library, and in f32 (the
    # CUDA-core kernel) against the f32 rate's bound
    for key, (cfg, cases) in k6_in.items():
        r = rows[key]
        f32_ms = None
        if torch.float32 in cases:
            qf, kf, vf = cases[torch.float32]
            f32_ms = device_ms(lambda: FA.flash_attention_bshd(
                qf, kf, vf, causal=True, window=k6_window(cfg),
                prefix_len=k6_prefix(cfg)), f"{key} f32", reps=10)
            f32_bound, _ = bound_ms(nbytes(qf, kf, vf, qf), r["ops"])
        if r["ms"] is not None:
            print(f"{key} bf16 (tensor cores): {r['ms'] * 1e3:.2f} us "
                  f"against its bound {r['bound_ms'] * 1e3:.2f} us (bf16 "
                  f"tensor-core rate), {r['ms'] / r['bound_ms']:.2f}x; "
                  f"against scaled_dot_product_attention "
                  f"{r['library_ms'] * 1e3:.2f} us, "
                  f"{r['ms'] / r['library_ms']:.2f}x, on {card}", flush=True)
        if f32_ms is not None:
            print(f"{key} f32 (CUDA cores, flash_attention_kernel): "
                  f"{f32_ms * 1e3:.2f} us (device) against its bound "
                  f"{f32_bound * 1e3:.2f} us (f32 rate outside the tensor "
                  f"cores), {f32_ms / f32_bound:.2f}x, on {card}",
                  flush=True)
    # two K7 calls agree bit for bit (the state is summed in chunk order;
    # integer atomics only)
    y1, S1 = RC.rwkv_chunked_bthd(*k7_in, return_state=True)
    y2, S2 = RC.rwkv_chunked_bthd(*k7_in, return_state=True)
    torch.cuda.synchronize()
    check(torch.equal(y1, y2) and torch.equal(S1, S2),
          "rwkv_chunked: two calls bitwise equal")
    # two K8 calls agree bit for bit (no atomics; each channel's state in
    # one thread's registers, the chunks chained in order), and its time
    # per prefill
    y1, S1 = SS.ssm_scan(*k8_in["prefill"])
    y2, S2 = SS.ssm_scan(*k8_in["prefill"])
    torch.cuda.synchronize()
    check(torch.equal(y1, y2) and torch.equal(S1, S2),
          "ssm_scan: two calls bitwise equal")
    r8 = rows["ssm_scan"]
    if r8["ms"] is not None:
        L8 = get_config(K8_ARCH).n_layers
        print(f"ssm_scan (K8) at the {K8_ARCH} prefill: {r8['ms'] * 1e3:.2f} "
              f"us against its bound {r8['bound_ms'] * 1e3:.2f} us "
              f"({r8['bound_by']}), {r8['ms'] / r8['bound_ms']:.2f}x; "
              f"{L8} launches per prefill, {L8 * r8['ms']:.3f} ms; decode "
              f"step (S = 1): {L8} launches of "
              f"{time_events(lambda: SS.ssm_scan(*k8_in['decode'])) * 1e3:.2f}"
              f" us (events) on {card}", flush=True)
    del k6_in, k8_in, y1, y2, S1, S2
    torch.cuda.empty_cache()
    # K8 at its training layout and with an underflowing chunk, then K8's
    # and K7's backward kernels against their plain versions, timed
    k8_fwd_rows(dev, card, rows)
    k8_bwd_rows(dev, card, rows)
    k7_bwd_rows(dev, card, rows)

    # ---- 4. the quickstart path -------------------------------------------
    mark("4")
    prog = get_workload("comd", device=dev)
    for fn in (KEF.epoch_fused, KPT.pc_table_predict, KPT.pc_table_update):
        fn.launches = 0
    reset_lm_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # examples_torch/quickstart.py: run_workload of static17, crisp,
    # pcstall and oracle on comd, printing its table
    res = QUICKSTART.main(device=dev, n_epochs=N_EPOCHS)
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    v2_launches = dict(KEF.epoch_fused.launches_by_family)
    print(f"main path wall (examples_torch/quickstart.py) {main_wall:.2f} s "
          f"on {card}")
    vals = [v for m, r in res.items() for k, v in r.items()
            if not (k == "accuracy" and m.startswith("static"))]
    check(bool(np.isfinite(vals).all()), "main path metrics finite")
    check(res["oracle"]["accuracy"] > res["pcstall"]["accuracy"]
          > res["crisp"]["accuracy"], "accuracy oracle > pcstall > crisp")
    check(res["pcstall"]["ednp_norm"] < 1.0, "pcstall ED2P vs static < 1")
    check(KEF.epoch_fused.launches == 2 * N_EPOCHS,
          f"epoch_fused launches {KEF.epoch_fused.launches} == "
          f"{2 * N_EPOCHS}")
    want_launches = dict.fromkeys(v2_launches, 0)
    want_launches.update(pc=N_EPOCHS, reactive=N_EPOCHS)
    check(v2_launches == want_launches,
          f"epoch_fused launches by family {v2_launches}")
    check(KPT.pc_table_predict.launches == 0
          and KPT.pc_table_update.launches == 0,
          "no PC-table kernel launches on the fused path")

    # the PC-table kernel path
    for fn in (KEF.epoch_fused, KPT.pc_table_predict, KPT.pc_table_update):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_v1 = SIM.run_sim(prog, v1_sim, "pcstall")
    torch.cuda.synchronize()
    v1_wall = time.perf_counter() - t0
    print(f"v1 pcstall run ({N_EPOCHS} epochs, comd, 64 x 40): wall "
          f"{v1_wall:.3f} s, {v1_wall / N_EPOCHS * 1e3:.3f} ms per epoch; "
          f"{v1_per_epoch:.1f} launches on the card per epoch (phase 2) on "
          f"{card}", flush=True)
    v1_launches = (KPT.pc_table_predict.launches,
                   KPT.pc_table_update.launches)
    check(v1_launches == (N_EPOCHS, N_EPOCHS) and
          KEF.epoch_fused.launches == 0,
          f"v1 launches (predict, update) {v1_launches} == "
          f"({N_EPOCHS}, {N_EPOCHS})")
    check(all(np.isfinite(v).all() for v in tr_v1.values()),
          "v1 run outputs finite")
    rows["pc_table_predict"]["launches"] = v1_launches[0]
    rows["pc_table_update"]["launches"] = v1_launches[1]
    rows["epoch_fused[pc]"]["launches"] = v2_launches["pc"]
    rows["epoch_fused[reactive]"]["launches"] = v2_launches["reactive"]

    # whole runs: kernel engine against the unfused engine
    def agg_dev(what, a, b):
        flips = np.where((a["fidx"] != b["fidx"]).any(1))[0]
        for k in ("work", "energy"):
            dev_rel = abs(float(a[k].sum(dtype=np.float64))
                          - float(b[k].sum(dtype=np.float64))) \
                / abs(float(b[k].sum(dtype=np.float64)))
            check(dev_rel <= AGG_TOL,
                  f"{what} kernel vs unfused run {k} rel dev {dev_rel:.3e} "
                  f"(first fidx divergence at epoch "
                  f"{flips[0] if len(flips) else 'none'})")

    for mech in ("pcstall", "crisp"):
        a = SIM.run_sim(prog, SIM.SimConfig(n_epochs=N_EPOCHS), mech)
        b = SIM.run_sim(prog, SIM.SimConfig(n_epochs=N_EPOCHS,
                                            use_pallas=False), mech)
        agg_dev(mech, a, b)
        if mech == "pcstall":
            # the PC-table pair's run (K1's hit mask feeds the update)
            agg_dev("pcstall v1", tr_v1, b)

    # ---- 5. the README's 304-CU row on the one-row path (K3) ------------
    mark("5")
    KEF.epoch_fused.launches_by_family = dict.fromkeys(
        KEF.epoch_fused.launches_by_family, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wres = SIM.run_workload(prog, WIDE_SIM, mechanisms=("crisp", "pcstall"))
    torch.cuda.synchronize()
    wide_wall = time.perf_counter() - t0
    wide_launches = dict(KEF.epoch_fused.launches_by_family)
    print(f"run_workload at {WIDE_SIM.n_cu} x {WIDE_SIM.n_wf} / "
          f"{WIDE_SIM.pallas_block_cu} x {WIDE_SIM.n_epochs} epochs "
          f"(crisp, pcstall on K3): {wide_wall:.2f} s wall; "
          + ", ".join(f"{m} accuracy {r['accuracy']:.3f} ED2P "
                      f"{r['ednp_norm']:.3f}" for m, r in wres.items())
          + f" on {card}", flush=True)
    want_launches = dict.fromkeys(wide_launches, 0)
    want_launches.update(pc=WIDE_SIM.n_epochs, reactive=WIDE_SIM.n_epochs)
    check(wide_launches == want_launches,
          f"304-CU run_workload: K3 launches {wide_launches}")
    check(all(np.isfinite(list(r.values())).all() for r in wres.values()),
          "304-CU run_workload metrics finite")
    for mech in ("pcstall", "crisp"):
        a = SIM.run_sim(prog, WIDE_SIM, mech)
        b = SIM.run_sim(prog, dataclasses.replace(WIDE_SIM, use_pallas=False),
                        mech)
        agg_dev(f"{mech} at 304 x 40 / 38", a, b)
    rows["epoch_fused[pc@304]"]["launches"] = wide_launches["pc"]
    rows["epoch_fused[reactive@304]"]["launches"] = wide_launches["reactive"]

    # ---- 6. the sweep path: the Fig-15 suite through run_grid ------------
    mark("6")
    # the registry's axis-liveness audit (a static analysis on the host's
    # CPU at a tiny shape), which run_grid's dedup guard consults once per
    # spec and engine: run and timed alone, so the Fig-15 wall holds the
    # sweep only
    misses = DEPS.axis_liveness.cache_info().misses
    t0 = time.perf_counter()
    audited = [r for point in (DEPS.TINY_CONFIG, DEPS.TINY_CONFIG_V2)
               for r in DEPS.audit_registry(point)]
    t_audit = time.perf_counter() - t0
    n_audit = DEPS.axis_liveness.cache_info().misses - misses
    print(f"registry audit: {n_audit} audits ({len(MECH.specs())} specs x 2 "
          f"engines) in {t_audit:.2f} s wall on the host", flush=True)
    check(all(r.exact for r in audited),
          "registry audit: every builtin's exec_axes derived exactly")
    progs15 = {w: get_workload(w, device=dev) for w in FIG15_WORKLOADS}
    sim15 = SIM.SimConfig(n_epochs=FIG15_EPOCHS)
    SW.reset_counters()
    for fn in (KEF.epoch_fused, KPT.pc_table_predict, KPT.pc_table_update):
        fn.launches = 0
    KEF.epoch_fused.launches_by_family = dict.fromkeys(
        KEF.epoch_fused.launches_by_family, 0)
    KEF.epoch_fused.fork_rows = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traces = SW.run_grid(progs15, sim15, {"epoch_us": [1.0]},
                         FIG15_MECHS)[(1.0,)]
    torch.cuda.synchronize()
    fig15_wall = time.perf_counter() - t0
    fig15_launches = dict(KEF.epoch_fused.launches_by_family)
    fig15_rows = KEF.epoch_fused.fork_rows
    fig15_k12 = (KPT.pc_table_predict.launches, KPT.pc_table_update.launches)
    dispatch = dict(SW.DISPATCH_ROWS)
    met = SW.suite_metrics(None, sim15, FIG15_MECHS, n=2, traces=traces)
    ed2p = {m: float(np.exp(np.mean([np.log(met[w][m]["ednp_norm"])
                                     for w in FIG15_WORKLOADS])))
            for m in FIG15_MECHS}
    acc = {m: float(np.mean([met[w][m]["accuracy"]
                             for w in FIG15_WORKLOADS]))
           for m in FIG15_MECHS if m in REF_FIG15_ACC}
    print(f"Fig-15 suite: {len(FIG15_WORKLOADS)} workloads x "
          f"{len(FIG15_MECHS)} mechanisms x {FIG15_EPOCHS} epochs at "
          f"{CU} x {WF} through run_grid: {fig15_wall:.2f} s wall "
          f"({fig15_wall / FIG15_EPOCHS * 1e3:.3f} ms per epoch) on {card}")
    print(f"{'mechanism':10s} {'ED2P port':>10s} {'ED2P ref':>9s} "
          f"{'gap':>8s} {'acc port':>9s} {'acc ref':>8s} {'gap':>8s}")
    for m in FIG15_MECHS:
        line = (f"{m:10s} {ed2p[m]:10.4f} {REF_FIG15_ED2P[m]:9.4f} "
                f"{ed2p[m] - REF_FIG15_ED2P[m]:+8.4f}")
        if m in acc:
            line += (f" {acc[m]:9.4f} {REF_FIG15_ACC[m]:8.4f} "
                     f"{acc[m] - REF_FIG15_ACC[m]:+8.4f}")
        print(line)
    check(all(np.isfinite(v).all() for trs in traces.values()
              for tr in trs.values() for v in tr.values()),
          "Fig-15 traces finite")
    check(fig15_launches["fork"] == FIG15_EPOCHS
          and fig15_rows == FIG15_EPOCHS * 40,
          f"Fig-15: K4 calls {fig15_launches['fork']} == {FIG15_EPOCHS},"
          f" {fig15_rows / max(fig15_launches['fork'], 1):.0f} rows each "
          f"(40)")
    check(sum(fig15_launches.values()) == fig15_launches["fork"]
          and fig15_k12 == (0, 0),
          f"Fig-15: no K1-K3 launches ({fig15_launches}, "
          f"{fig15_k12})")
    check(dispatch == FIG15_DISPATCH_ROWS,
          f"Fig-15 DISPATCH_ROWS {dispatch} == {FIG15_DISPATCH_ROWS}")
    check(acc["oracle"] > acc["pcstall"] > acc["crisp"],
          "Fig-15 mean accuracy oracle > pcstall > crisp")
    check(ed2p["pcstall"] < 1.0, "Fig-15 pcstall geomean ED2P vs static17 "
                                 "< 1")
    check(all(abs(ed2p[m] - REF_FIG15_ED2P[m]) <= FIG15_ED2P_GAP
              for m in FIG15_MECHS),
          f"Fig-15 geomean ED2P within {FIG15_ED2P_GAP} of the reference's")
    rows["epoch_fused[fork]"]["launches"] = fig15_launches["fork"]

    # ---- 7. the sweep's bitwise contracts on the card ---------------------
    mark("7")
    progs3 = {w: get_workload(w, device=dev) for w in EXACT_WORKLOADS}
    cfg3 = SIM.SimConfig(n_epochs=EXACT_EPOCHS)
    mech3 = ("static17", "crisp", "accreac", "pcstall", "accpc", "oracle")

    def same(a, b):
        return all(np.array_equal(a[w][m][k], b[w][m][k])
                   for w in a for m in a[w] for k in a[w][m])

    grid = SW.run_grid(progs3, cfg3, EXACT_GRID, mech3)
    suite = SW.run_suite(progs3, cfg3, mech3)
    check(same(suite, SW.run_grid(progs3, cfg3, [{}], mech3)[()]),
          "run_suite bitwise == one-point run_grid")
    check(all(same(grid[key], SW.run_grid(
        progs3, cfg3, [dict(zip(EXACT_GRID, key))], mech3)[key])
        for key in grid), "every run_grid row bitwise == its per-point grid")
    ex = SW.GridExecutor(cfg3, mech3, p_max=P, buckets=(2, 4, 8))
    jobs = [(progs3[w], dict(zip(EXACT_GRID, key)))
            for w in EXACT_WORKLOADS for key in grid]
    streamed = []
    for i in range(0, len(jobs), 3):
        streamed += ex.dispatch(jobs[i:i + 3]).traces()
    check(all(same({0: tr}, {0: grid[tuple(ov.values())][pr.name]})
              for (pr, ov), tr in zip(jobs, streamed)),
          "GridExecutor streamed rows (buckets 2/4/8) bitwise == run_grid")
    grid_u = SW.run_grid(progs3, dataclasses.replace(cfg3, use_pallas=False),
                         EXACT_GRID, mech3)
    worst = {}
    for k in ("work", "energy"):
        a = sum(float(grid[key][w][m][k].sum(dtype=np.float64))
                for key in grid for w in progs3 for m in mech3)
        b = sum(float(grid_u[key][w][m][k].sum(dtype=np.float64))
                for key in grid for w in progs3 for m in mech3)
        worst[k] = abs(a - b) / abs(b)
        check(worst[k] <= AGG_TOL, f"kernel grid vs unfused grid run-level "
                                   f"{k} rel dev {worst[k]:.3e}")

    # ---- 8. the runtime path: the 304-CU service stream, the managers -----
    mark("8")
    stream = list(dvfs_request_stream(SVC_REQUESTS, seed=SVC_SEED,
                                      device=dev))
    svc_progs = {w: get_workload(w, device=dev) for w in SVC_WORKLOADS}
    with DVFSService(SVC_SIM, max_batch=SVC_BATCH,
                     coalesce_s=SVC_COALESCE_S) as svc:
        for fn in (KEF.epoch_fused, KPT.pc_table_predict,
                   KPT.pc_table_update):
            fn.launches = 0
        KEF.epoch_fused.launches_by_family = dict.fromkeys(
            KEF.epoch_fused.launches_by_family, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = svc.map(stream)
        svc_wall = time.perf_counter() - t0
        svc_stats = svc.stats()
    svc_launches = dict(KEF.epoch_fused.launches_by_family)
    svc_k12 = (KPT.pc_table_predict.launches, KPT.pc_table_update.launches)
    one_shot = SW.run_grid(svc_progs, SVC_SIM, {"epoch_us": [1.0, 10.0]},
                           ("static17", "pcstall"))
    same_rows = all(
        np.array_equal(res["traces"][m][k],
                       one_shot[(ax["epoch_us"],)][prog.name][m][k])
        for (prog, ax, _), res in zip(stream, served)
        for m in ("static17", "pcstall") for k in res["traces"][m])
    svc_mean = {f: float(np.mean([r["report"][f] for r in served]))
                for f in REF_SVC}
    print(f"service: {SVC_REQUESTS} requests at {SVC_SIM.n_cu} x "
          f"{SVC_SIM.n_wf} x {SVC_SIM.n_epochs} epochs (K5 blocks of "
          f"{SVC_SIM.pallas_block_cu}): {svc_wall:.2f} s wall, "
          f"{svc_stats['jobs_per_sec']:.3f} jobs/s, p50 "
          f"{svc_stats['p50_latency_s']:.3f} s, p99 "
          f"{svc_stats['p99_latency_s']:.3f} s, {svc_stats['batches']} "
          f"batches (mean {svc_stats['mean_batch']:.2f}) on {card}",
          flush=True)
    for f in REF_SVC:
        print(f"  mean pcstall {f}: port {svc_mean[f]:.4f}, reference "
              f"{REF_SVC[f]:.4f} ({svc_mean[f] - REF_SVC[f]:+.4f})")
    check(svc_stats["jobs"] == SVC_REQUESTS, "service resolved every request")
    check(svc_launches["fork"] > 0
          and svc_launches["pc"] == svc_launches["reactive"] == 0
          and svc_k12 == (0, 0),
          f"service: K5 calls {svc_launches['fork']} > 0, no other "
          f"epoch kernel ({svc_launches}, {svc_k12})")
    check(svc_launches["fork"] == svc_stats["batches"] * SVC_SIM.n_epochs,
          f"service: one K5 call per epoch per batch "
          f"({svc_launches['fork']} == {svc_stats['batches']} x "
          f"{SVC_SIM.n_epochs})")
    check(same_rows, "service streamed rows bitwise == one-shot run_grid")
    check(all(np.isfinite([r["report"][f] for f in REF_SVC]).all()
              and abs(sum(r["report"]["freq_timeshare"]) - 1.0) < 1e-2
              for r in served), "service reports finite, residency sums to 1")
    rows["epoch_fused[fork_blocked]"]["launches"] = svc_launches["fork"]

    mgr_reports, mgr_launches = {}, {}
    for arch in MANAGER_ARCHS:
        KEF.epoch_fused.launches_by_family = dict.fromkeys(
            KEF.epoch_fused.launches_by_family, 0)
        t0 = time.perf_counter()
        mgr = DVFSManager.for_model(get_config(arch), TRAIN_4K, device=dev)
        rep = mgr.report()
        grid_rep = mgr.grid_report(epoch_us=(1.0, 10.0),
                                   objectives=("ed2p", "edp"))
        wall = time.perf_counter() - t0
        mgr_launches[arch] = dict(KEF.epoch_fused.launches_by_family)
        mgr_reports[arch] = (rep, grid_rep, wall)
        print(f"manager {arch} (train_4k, {mgr.sim.n_cu} CUs x "
              f"{mgr.sim.n_wf} WFs x {mgr.sim.n_epochs} epochs): report + "
              f"2 x 2 grid_report {wall:.2f} s on {card}", flush=True)
        for key, r in [("report", rep)] + list(grid_rep.items()):
            print(f"  {key}: ED2P {r['ed2p_norm']:.4f} energy "
                  f"{r['energy_norm']:.4f} delay {r['delay_norm']:.4f} "
                  f"accuracy {r['accuracy']:.4f}")
        check(mgr_launches[arch]["fork"] > 0,
              f"manager {arch}: K4 launches {mgr_launches[arch]['fork']} "
              f"> 0")
        check(all(np.isfinite([r["ed2p_norm"], r["energy_norm"],
                               r["accuracy"]]).all()
                  and abs(sum(r["freq_timeshare"]) - 1.0) < 1e-2
                  for r in [rep] + list(grid_rep.values())),
              f"manager {arch}: reports finite, residency sums to 1")
        check(rep["ed2p_norm"] == grid_rep[(1.0, "ed2p")]["ed2p_norm"],
              f"manager {arch}: report == its grid point")

    # ---- 9. the LM serving path: K6 (dense, audio, moe, hybrid, vlm), K7
    mark("9")
    # (rwkv6-3b), K8 (hybrid) ----------------------------------------------
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        L_ = cfg.n_layers
        hybrid = cfg.family == "hybrid"
        kernel = "K7" if cfg.family == "ssm" else \
            "K6 and K8" if hybrid else "K6"
        gen = SERVE_GEN[arch]
        # launches per prefill (K6, K7, K8) and per decode step (K8)
        want = (0, L_, 0) if cfg.family == "ssm" else (L_, 0, L_ if hybrid
                                                        else 0)
        want_step = L_ if hybrid else 0
        torch.cuda.empty_cache()
        reset_lm_counts()
        t0 = time.perf_counter()
        rep = serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    gen=gen, seed=0, dvfs=True, device=dev)
        wall = time.perf_counter() - t0
        n6, n7, n8, fams = lm_counts()
        d = rep["dvfs"]
        print(f"serve {arch} ({cfg.n_layers} layers x d {cfg.d_model}, "
              f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, gen "
              f"{gen}, dvfs): prefill {rep['prefill_s']:.4f} s, "
              f"decode {rep['decode_s_per_tok'] * 1e3:.3f} ms/token, "
              f"{wall:.2f} s wall incl. init and DVFS on {card}",
              flush=True)
        print(f"  launches: K6 {n6}, K7 {n7}, K8 {n8} (the prefill and {gen} "
              f"decode steps); K4 {fams['fork']}"
              f"; DVFS ED2P {d['ed2p_norm']:.4f} energy "
              f"{d['energy_norm']:.4f} delay {d['delay_norm']:.4f} accuracy"
              f" {d['accuracy']:.4f}, {rep['dvfs_requests']} requests, "
              f"steps {d['step_time']['n_steps']}", flush=True)
        if cfg.moe is not None:
            # decode never drops (one token, capacity 4): all the prefill's
            pairs = cfg.n_layers * SERVE_BATCH * SERVE_PROMPT * cfg.moe.top_k
            dropped = int(MOE.moe_layer.dropped)
            print(f"  dropped pairs in the prefill: {dropped} of {pairs} "
                  f"({dropped / pairs:.4%}; {cfg.moe.num_experts} experts "
                  f"top-{cfg.moe.top_k}, capacity "
                  f"{MOE.expert_capacity(SERVE_PROMPT, cfg.moe, 1.25)})",
                  flush=True)
        served = (want[0], want[1], want[2] + gen * want_step)
        check((n6, n7, n8) == served,
              f"serve {arch}: K6 {n6}, K7 {n7}, K8 {n8} launches == "
              f"{served} (one per layer of the one prefill; K8 also one per "
              f"layer of each of the {gen} decode steps)")
        check(fams["fork"] > 0 and fams["pc"] == fams["reactive"] == 0,
              f"serve {arch}: DVFSService.for_model ran K4 "
              f"({fams['fork']} launches, no other epoch kernel)")
        check(bool(torch.isfinite(rep["prefill_logits"]).all())
              and bool(torch.isfinite(rep["last_logits"]).all())
              and tuple(rep["prefill_logits"].shape)
              == (SERVE_BATCH, cfg.vocab)
              and tuple(rep["tokens"].shape)
              == (SERVE_BATCH, gen + 1),
              f"serve {arch}: logits finite, shapes")
        check(all(np.isfinite([d["ed2p_norm"], d["energy_norm"],
                               d["accuracy"]]))
              and abs(sum(d["freq_timeshare"]) - 1.0) < 1e-2,
              f"serve {arch}: DVFS report finite, residency sums to 1")
        if cfg.family == "ssm":
            rows["rwkv_chunked"]["launches"] = n7
        else:
            rows[K6_ROWS[arch][0]]["launches"] = n6
        if hybrid:
            rows["ssm_scan"]["launches"] = n8
        del rep

        # decode without the DVFS stream: the same loop, no service threads
        # beside it
        torch.cuda.empty_cache()
        rep = serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    gen=gen, seed=0, dvfs=False, device=dev)
        print(f"serve {arch} without dvfs: prefill {rep['prefill_s']:.4f} s, "
              f"decode {rep['decode_s_per_tok'] * 1e3:.3f} ms/token on "
              f"{card}", flush=True)
        del rep

        # each kernel inside the model: decode the prompt's tokens one by
        # one from an empty cache and land on the prefill's logits, in f32
        # to 2e-2 and in bf16 to BF16_DECODE_TOL; 256 tokens, 4 for the moe
        # models (MOE_DECODE_S), whose prefill must drop no pair there. The
        # bf16 prefill in a batch of 4 against alone is printed beside it as
        # a reading, not a limit. A token decode cannot rebuild the vlm's
        # bidirectional prefix of patch embeddings, so paligemma's check
        # runs on the same weights with frontend "none": its text-only
        # path, K6 at head dim 256 without a prefix (the prefix is held by
        # its K6 row above and by the CPU tests against the reference).
        check_s = DECODE_S if cfg.moe is None else MOE_DECODE_S
        for dtype in ("bfloat16", "float32"):
            t_check = time.perf_counter()
            vcfg = dataclasses.replace(cfg, dtype=dtype)
            if dtype == "float32":
                vcfg = dataclasses.replace(vcfg, n_layers=min(
                    cfg.n_layers, F32_DECODE_LAYERS))
            dcfg = dataclasses.replace(vcfg, frontend="none")
            # launches per prefill and per decode step at this depth
            want_d = tuple(vcfg.n_layers if w else 0 for w in want)
            want_step_d = vcfg.n_layers if want_step else 0
            torch.cuda.empty_cache()
            params = LM.init_params(dcfg, 1, dev)
            toks = torch.as_tensor(np.random.default_rng(8).integers(
                0, cfg.vocab, (SERVE_BATCH, DECODE_S))).to(dev)
            n0 = lm_counts()[:3]
            MOE.moe_layer.dropped = 0
            full = LM.prefill(params, dcfg, {"tokens": toks[:1, :check_s]})
            check(lm_counts()[:3] == tuple(a + b for a, b in zip(n0,
                                                                 want_d)),
                  f"{arch} {dtype} prefill at S {check_s}: one {kernel} "
                  f"launch per layer ({vcfg.n_layers} layers)")
            if cfg.moe is not None:
                dropped = int(MOE.moe_layer.dropped)
                check(dropped == 0, f"{arch} {dtype} prefill at S "
                      f"{check_s}: {dropped} dropped pairs == 0")
                LM.prefill(params, dcfg, {"tokens": toks[:1]})
                print(f"  {arch} {dtype} prefill at S {DECODE_S} (a "
                      f"reading): {int(MOE.moe_layer.dropped)} dropped pairs "
                      f"of {cfg.n_layers * DECODE_S * cfg.moe.top_k}",
                      flush=True)
            cache = LM.init_cache(dcfg, 1, check_s, device=dev)
            n0 = lm_counts()[:3]
            for i in range(check_s):
                logits, cache = LM.decode_step(params, dcfg, cache,
                                               toks[:1, i])
            del cache
            check(lm_counts()[:3] == (n0[0], n0[1],
                                      n0[2] + check_s * want_step_d),
                  f"{arch} {dtype} decode x {check_s}: {want_step_d} K8 "
                  f"launches per step, no K6 or K7")
            tag = (f"{arch} {dtype} ({vcfg.n_layers} layers) decode x "
                   f"{check_s} vs prefill logits")
            if dtype == "float32":
                compare(tag, logits, full, rtol=DECODE_TOL, atol=DECODE_TOL)
            else:
                four = LM.prefill(params, dcfg,
                                  {"tokens": toks[:, :check_s]})
                gap = float((logits.double() - full.double()).abs().max())
                spread = float((four[:1].double() - full.double()).abs().max())
                agree = torch.equal(logits.argmax(-1), full.argmax(-1))
                check(gap <= BF16_DECODE_TOL,
                      f"{tag}: max_abs_err {gap:.3e} <= {BF16_DECODE_TOL} "
                      f"(prefill in a batch of 4 against alone: "
                      f"{spread:.3e}); max |logit| "
                      f"{float(full.abs().max()):.3f}, argmax "
                      f"{'agrees' if agree else 'differs'}")
                del four
                # where a prefill's (the vlm's with its patch embeddings)
                # and a decode step's device time goes, in the served dtype
                pbatch = prefill_batch(vcfg, SERVE_BATCH, SERVE_PROMPT, 9,
                                       dev)
                LM.prefill(params, vcfg, pbatch)
                split = kernel_split(lambda: LM.prefill(
                    params, vcfg, pbatch))
                dcache = LM.init_cache(dcfg, SERVE_BATCH,
                                       SERVE_PROMPT + gen,
                                       fill=SERVE_PROMPT, device=dev)
                dsplit = kernel_split(lambda: LM.decode_step(
                    params, dcfg, dcache, pbatch["tokens"][:, 0]), reps=8)
                del dcache
                for what, sp in (("prefill", split),
                                 ("decode step", dsplit)):
                    if sp is None:
                        print(f"  {arch} {what}: profiler reported no "
                              f"device time")
                        continue
                    tot = sum(sp.values())
                    print(f"  {arch} {what} device time {tot:.3f} ms: "
                          + ", ".join(f"{k} {v:.3f} ms ({v / tot:.1%})"
                                      for k, v in sp.items() if v > 0)
                          + f" on {card}", flush=True)
            del params
            print(f"  {arch} {dtype} decode check ({vcfg.n_layers} layers) "
                  f"took {time.perf_counter() - t_check:.1f} s", flush=True)
        torch.cuda.empty_cache()

    # ---- 10. engine and grid wall times, the kernel summary ---------------
    mark("10")
    for up in (False, True):
        cfg = SIM.SimConfig(n_epochs=100, use_pallas=up)
        SIM.run_sim(prog, cfg, "pcstall")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SIM.run_sim(prog, cfg, "pcstall")
        per = (time.perf_counter() - t0) / 100
        print(f"time engine use_pallas={up}: {per * 1e3:.3f} ms per epoch "
              f"(pcstall, 64x40, host wall incl. sync) on {card}",
              flush=True)
    print(f"time Fig-15 grid use_pallas=True: {fig15_wall:.2f} s wall, "
          f"{fig15_wall / FIG15_EPOCHS * 1e3:.3f} ms per epoch on {card}",
          flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    SW.run_grid(progs15, dataclasses.replace(sim15, use_pallas=False),
                {"epoch_us": [1.0]}, FIG15_MECHS)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    print(f"time Fig-15 grid use_pallas=False: {wall_u:.2f} s wall, "
          f"{wall_u / FIG15_EPOCHS * 1e3:.3f} ms per epoch on {card}",
          flush=True)

    # ---- 11. the learn path ------------------------------------------------
    mark("11")
    k4_learn_cases(dev, rows["epoch_fused[fork]"])
    learn_phase(dev, card)

    # ---- 12. training ------------------------------------------------------
    mark("12")
    # musicgen's step counted on meta tensors in a process of its own, on
    # the host, while this one trains on the card
    roof = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--roofline"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        k6_grad_checks(dev, card)
        mark("12, K6's training row")
        k6_train_row(dev, card, rows)
        mark("12, musicgen-medium and granite-moe")
        train_phase(dev, card, rows, roof)
    finally:
        if roof.poll() is None:
            roof.kill()
            roof.wait()
    mark("12, hymba-1.5b and rwkv6-3b")
    scan_train_phase(dev, card, rows)

    replaces = {
        "pc_table_predict": "src/repro/kernels/pc_table.py:67",
        "pc_table_update": "src/repro/kernels/pc_table.py:132",
        "epoch_fused[pc]": "src/repro/kernels/epoch_fused.py:748",
        "epoch_fused[reactive]": "src/repro/kernels/epoch_fused.py:748",
        "epoch_fused[pc@304]": "src/repro/kernels/epoch_fused.py:748",
        "epoch_fused[reactive@304]": "src/repro/kernels/epoch_fused.py:748",
        "epoch_fused[fork]": "src/repro/kernels/epoch_fused.py:748",
        "epoch_fused[fork_blocked]": "src/repro/kernels/epoch_fused.py:648",
        **{key: "src/repro/kernels/flash_attention.py:73"
           for key in [k for k, _ in K6_ROWS.values()] + [K6_TRAIN_ROW]},
        "rwkv_chunked": "src/repro/kernels/rwkv_chunk.py:79",
        # K8 replaces no TPU kernel: the reference's scan is a lax.scan;
        # its backward, XLA's transpose of that scan
        "ssm_scan": "src/repro/models/ssm.py:16",
        K8_BWD_ROW: "src/repro/models/ssm.py:16",
        # K7's backward replaces no TPU kernel: the reference's Pallas K7
        # has no backward, and its gradient is XLA's transpose of the
        # chunked time mix
        K7_BWD_ROW: "src/repro/models/rwkv.py:77",
        # K6's backward replaces no TPU kernel: XLA's transpose of the
        # reference's jnp attention
        K6_BWD_ROW: "src/repro/models/layers.py:122",
    }
    sources = dict.fromkeys(
        ("epoch_fused[pc]", "epoch_fused[reactive]", "epoch_fused[pc@304]",
         "epoch_fused[reactive@304]", "epoch_fused[fork]",
         "epoch_fused[fork_blocked]"),
        "src/repro_torch/kernels/csrc/epoch_fused.cu")
    sources.update(
        pc_table_predict="src/repro_torch/kernels/csrc/pc_table.cu",
        pc_table_update="src/repro_torch/kernels/csrc/pc_table.cu",
        rwkv_chunked="src/repro_torch/kernels/csrc/rwkv_chunk.cu",
        ssm_scan="src/repro_torch/kernels/csrc/ssm_scan.cu",
        ssm_scan_bwd="src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        rwkv_chunked_bwd="src/repro_torch/kernels/csrc/rwkv_chunk_bwd.cu",
        **{K6_BWD_ROW: "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"},
        **{key: "src/repro_torch/kernels/csrc/flash_attention.cu"
           for key in [k for k, _ in K6_ROWS.values()] + [K6_TRAIN_ROW]})
    kernels = []
    for key in replaces:
        r = rows[key]
        check(r.get("launches", 0) > 0, f"{key} launched on its path")
        check(r.get("ms") is not None, f"{key} has a device time")
        kernels.append({
            "name": key, "route": "cuda", "source": sources[key],
            "replaces": replaces[key], "launches": r.get("launches", 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
    mark("end")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:",
              file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--lm-ran": lm_ran_child, "--roofline": roofline_child}.get(
        " ".join(sys.argv[1:]), main)())
