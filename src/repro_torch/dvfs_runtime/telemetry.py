"""Arch-derived workload programs (port of ``repro.dvfs_runtime.telemetry``):
map a model's train/serve step onto a PCSTALL program.

Each op class of the step becomes a run of PC blocks. Its block count
follows its share of the step's time, and its frequency sensitivity its
arithmetic intensity against the ridge point ``PEAK_FLOPS / HBM_BW``:
compute-bound ops scale with core frequency, memory-bound ops do not, and
collective-bound ops become near-insensitive "async" blocks. The resulting
``Program`` plugs into ``repro_torch.core.simulate`` like a Table II
workload; a training step is a small, iteratively re-executed program, so a
PC-indexed table converges within a few steps.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.workloads import Program, _finalize

# The reference's program-construction parameters (``PEAK_FLOPS``,
# ``HBM_BW`` and ``ICI_BW`` of ``repro/roofline/hlo_analysis.py``), copied
# so that ``arch_program`` builds the reference's Program. They set the
# ridge point and the op classes' time shares of the modelled step; they
# describe no device this port runs on.
PEAK_FLOPS = 197e12
HBM_BW = 819e9
ICI_BW = 50e9

RIDGE = PEAK_FLOPS / HBM_BW  # flops/byte


def _op(name: str, flops: float, bytes_: float, coll_bytes: float = 0.0):
    return (name, flops, bytes_, coll_bytes)


def step_ops(cfg: ModelConfig, shape: ShapeConfig
             ) -> List[Tuple[str, float, float, float]]:
    """Analytic (flops, hbm bytes, collective bytes) per op class for one
    step of this (arch x shape) cell, whole-model (per layer x L)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        S_ctx, S = shape.seq_len, 1
    else:
        S_ctx = S
    T = B * S  # tokens touched this step
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    H, Hkv = max(cfg.n_heads, 1), max(cfg.n_kv_heads, 1)
    bt = 2  # bf16
    ops: List[Tuple[str, float, float, float]] = []
    train_mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd

    if cfg.attn_kind != "none":
        qkv_p = d * (H + 2 * Hkv) * hd
        ops.append(_op("qkv_proj", 2 * T * qkv_p * train_mult * L,
                       (qkv_p * bt + T * d * bt) * L, 0))
        eff_ctx = min(cfg.window, S_ctx) if cfg.attn_kind == "swa" else S_ctx
        attn_f = 4 * T * eff_ctx * H * hd * train_mult * L
        attn_b = (T * H * hd * bt + B * eff_ctx * Hkv * hd * 2 * bt) * L
        ops.append(_op("attention", attn_f, attn_b, 0))
        o_p = H * hd * d
        ops.append(_op("o_proj", 2 * T * o_p * train_mult * L,
                       (o_p * bt + T * d * bt) * L, 0))
    if cfg.family in ("ssm", "hybrid"):
        n = cfg.ssm.state_size if cfg.ssm else 16
        ssm_f = T * d * n * 8 * train_mult * L
        ops.append(_op("ssm_scan", ssm_f,
                       (T * d * bt * 3 + d * d * bt) * L, 0))
        ops.append(_op("mix_proj", 2 * T * 4 * d * d * train_mult * L,
                       4 * d * d * bt * L, 0))
    if cfg.moe is not None:
        e = cfg.moe
        ef = 2 * T * e.top_k * 3 * d * e.expert_d_ff * train_mult * L
        ew = e.num_experts * 3 * d * e.expert_d_ff * bt * L
        # all-to-all dispatch+combine over the EP axis
        a2a = 2 * T * d * bt * L
        ops.append(_op("moe_ffn", ef, ew + T * d * bt * L, 0))
        ops.append(_op("moe_a2a", T * d * 0.1, T * d * bt * L, a2a))
        if e.num_shared:
            fs = e.num_shared * (e.shared_d_ff or e.expert_d_ff)
            ops.append(_op("shared_ffn", 2 * T * 3 * d * fs * train_mult * L,
                           3 * d * fs * bt * L, 0))
    else:
        ops.append(_op("ffn", 2 * T * 3 * d * cfg.d_ff * train_mult * L,
                       (3 * d * cfg.d_ff * bt + T * d * bt) * L, 0))
    ops.append(_op("norms_rope", T * d * 20 * L, T * d * bt * 4 * L, 0))
    ops.append(_op("logits", 2 * T * d * cfg.vocab * train_mult,
                   cfg.vocab * d * bt + T * cfg.vocab * 4, 0))
    if shape.kind == "train":
        # gradient reduce-scatter/all-gather over DP axes
        pbytes = cfg.n_params * 4
        ops.append(_op("grad_reduce", pbytes * 0.01, pbytes, pbytes))
        ops.append(_op("optimizer", cfg.n_params * 8, cfg.n_params * 16, 0))
    return ops


def arch_program(cfg: ModelConfig, shape: ShapeConfig, n_blocks: int = 1024,
                 chips: int = 256, device: DeviceLike = "cuda") -> Program:
    """Compile the step op list into a PCSTALL Program on ``device``: block
    counts by op time share, sensitivity by arithmetic intensity."""
    ops = step_ops(cfg, shape)
    times, core_shares, mem_fracs = [], [], []
    for name, f, b, cb in ops:
        t_comp = f / (chips * PEAK_FLOPS)
        t_mem = b / (chips * HBM_BW)
        t_coll = cb / (chips * ICI_BW)
        t = max(t_comp, t_mem, t_coll, 1e-12)
        times.append(t)
        ai = f / max(b, 1.0)
        core = float(ai / (ai + RIDGE))
        if t_coll == t:  # collective-bound: async, frequency-insensitive
            core *= 0.1
        core_shares.append(core)
        mem_fracs.append(min(max(t_mem, t_coll) / t, 1.0))
    times = np.asarray(times)
    shares = times / times.sum()
    i0 = np.zeros(n_blocks)
    sens = np.zeros(n_blocks)
    mem = np.zeros(n_blocks)
    pos = 0
    rate = 100.0
    for (name, *_), share, core, mf in zip(ops, shares, core_shares,
                                           mem_fracs):
        ln = max(int(round(share * n_blocks)), 1)
        r = rate  # uniform instruction rate; sensitivity split by core share
        sens[pos:pos + ln] = core * r / 1.7
        i0[pos:pos + ln] = (1 - core) * r
        mem[pos:pos + ln] = mf
        pos += ln
        if pos >= n_blocks:
            break
    if pos < n_blocks:  # pad with the last op's character
        sens[pos:] = sens[pos - 1]
        i0[pos:] = i0[pos - 1]
        mem[pos:] = mem[pos - 1]
    return _finalize(f"{cfg.name}:{shape.name}", i0, sens, mem, device)
