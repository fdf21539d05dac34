"""``repro_torch.roofline`` (the port's counterpart of ``repro.roofline``)
on the CPU.

* ``model_flops_per_device`` equals the reference's at one device for
  every (arch x shape) cell.
* ``analyze`` of a two-layer MLP counts the FLOPs and the HBM bytes that
  the reference's ``hlo_analysis.analyze`` counts in the optimized HLO of
  the same function.
* A glm4-9b and a hymba-1.5b smoke prefill (hymba's window cut below the
  prompt so that it masks) on ``meta`` tensors: matrix products plus K6's
  and K8's formulas equal a hand count, to 1e-6 relative; K6 and K8 once
  per layer, and no launch counted.
* The ``meta`` branches of the K6, K7 and K8 wrappers and K8's backward
  (and K6's gradient): outputs of the right shape and dtype, each call's
  work in the counter, the card's refusals; on CPU tensors every wrapper
  still returns its plain version's output bit for bit.
* ``roofline_terms`` and the report's rows at a smoke size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.roofline import hlo_analysis as JHLO
from repro.roofline import report as JREPORT
from repro_torch.configs import (ARCH_IDS, get_config, get_smoke_config,
                                 shapes_for)
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rwkv_chunk as RC
from repro_torch.kernels import ssm_scan as SS
from repro_torch.launch import input_specs as IS
from repro_torch.roofline import analysis as AN
from repro_torch.roofline import report as REPORT
from repro_torch.roofline import work as W
from repro_torch.train.train_step import make_prefill_step

CELLS = [(arch, s.name) for arch in ARCH_IDS
         for s in shapes_for(get_config(arch))]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch,shape_name", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_per_device_matches_reference(arch, shape_name):
    assert jget_config(arch).n_active_params == \
        get_config(arch).n_active_params
    assert REPORT.model_flops_per_device(arch, shape_name, 1) == \
        JREPORT.model_flops_per_device(arch, shape_name, 1)


def test_analyze_mlp_matches_reference_hlo_count():
    """relu(x @ w1) @ w2: the reference counts the two dots' FLOPs and the
    outputs of its top-level ops (two dots and the relu fusion); the
    port's aten ops are the same three."""
    shapes = ((32, 64), (64, 128), (128, 16))

    def jf(x, w1, w2):
        return jax.nn.relu(x @ w1) @ w2
    txt = jax.jit(jf).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                               for s in shapes)).compile().as_text()
    want = JHLO.analyze(txt)
    got = AN.analyze(lambda x, w1, w2: torch.relu(x @ w1) @ w2,
                     *(_meta(*s) for s in shapes))
    assert got["flops"] == want["flops"] == 2 * 32 * 128 * (64 + 16)
    assert got["hbm_bytes"] == want["hbm_bytes"]
    for key in want:
        assert got[key] == want[key], key
    assert got["kernels"] == {} and got["aten_ops"] == 3


def test_analyze_refuses_data():
    with pytest.raises(ValueError, match="meta"):
        AN.analyze(lambda x: x + 1, torch.ones(2))


def _causal_pairs(S, W):
    return W * (W + 1) // 2 + (S - W) * W


def _dense_layer_flops(cfg, B, S, window):
    """Matrix products and K6 of one attention layer of a prefill (B, S):
    the q, k, v and output projections, the SwiGLU's three products, and
    K6's two products over the kept (query, key) pairs."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    proj = 2 * B * S * d * (2 * H * hd + 2 * Hkv * hd)
    mlp = 3 * 2 * B * S * d * cfg.d_ff
    attn = 4 * B * H * hd * _causal_pairs(S, window or S)
    return proj + mlp, attn


@pytest.mark.parametrize("arch", ["glm4-9b", "hymba-1.5b"])
def test_smoke_prefill_count_equals_hand_count(arch):
    cfg = get_smoke_config(arch)
    B, S = 2, 64
    window = 0
    if cfg.attn_kind == "swa":
        window = 16
        cfg = dataclasses.replace(cfg, window=window)
    params, batch = IS.input_specs(cfg, ShapeConfig("p", S, B, "prefill"))
    n6, n8 = FA.flash_attention_bshd.launches, SS.ssm_scan.launches
    got = AN.analyze(make_prefill_step(cfg), params, batch)
    assert (FA.flash_attention_bshd.launches, SS.ssm_scan.launches) == \
        (n6, n8)
    mm_layer, k6_layer = _dense_layer_flops(cfg, B, S, window)
    mm = cfg.n_layers * mm_layer + 2 * B * cfg.d_model * cfg.vocab
    kernels = {"flash_attention": (cfg.n_layers, cfg.n_layers * k6_layer)}
    if cfg.family == "hybrid":
        d, hd, N = cfg.d_model, cfg.resolved_head_dim, cfg.ssm.state_size
        di = d * cfg.ssm.expand
        Hm = di // hd
        # w_in, w_dt, w_b and w_c, w_out
        mm += cfg.n_layers * 2 * B * S * (d * 2 * di + di * Hm + 2 * di * N
                                          + di * d)
        kernels["ssm_scan"] = (cfg.n_layers, cfg.n_layers * B * S * Hm
                               * (hd * (5 * N + 1) + 2))
    assert got["matmul_flops"] == pytest.approx(mm, rel=1e-6)
    assert {k: (v["calls"], v["flops"]) for k, v in
            got["kernels"].items()} == kernels
    want = mm + sum(f for _, f in kernels.values())
    assert got["flops"] == pytest.approx(want, rel=1e-6)
    assert got["hbm_bytes"] > 0 and got["collective_bytes"] == 0.0


def _k6_args(dt=torch.float32, device="cpu", B=2, S=64, H=4, Hkv=2,
             hd=16):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g).to(device, dt) for shape
                   in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                       (B, S, H, hd)))
    return q, k, v, do


def _scan_args(device="cpu", B=2, S=12, H=3, hd=16, N=8):
    g = torch.Generator().manual_seed(1)
    xh = torch.randn(B, S, H, hd, generator=g)
    dt = torch.rand(B, S, H, generator=g) + 0.01
    B_, C_ = torch.randn(B, S, N, generator=g), torch.randn(B, S, N,
                                                            generator=g)
    A = -torch.rand(H, generator=g) - 0.2
    h0 = torch.randn(B, H, hd, N, generator=g)
    gy = torch.randn(B, S, H, hd, generator=g)
    gh = torch.randn(B, H, hd, N, generator=g)
    return [t.to(device) for t in (xh, dt, B_, C_, A, h0, gy, gh)]


def _rwkv_args(device="cpu", B=2, T=32, H=2, hd=16):
    g = torch.Generator().manual_seed(2)
    r, k, v = (torch.randn(B, T, H, hd, generator=g) * 0.5 for _ in range(3))
    w = torch.rand(B, T, H, hd, generator=g) * 0.3 + 0.6
    u = torch.randn(H, hd, generator=g) * 0.1
    return [t.to(device) for t in (r, k, v, w, u)]


def test_cpu_outputs_are_the_plain_versions_bit_for_bit():
    """On CPU tensors the wrappers with a meta branch return exactly their
    plain versions' outputs."""
    q, k, v, _ = _k6_args()
    for kw in ({}, {"window": 8}, {"prefix_len": 5}):
        assert torch.equal(
            FA.flash_attention_bshd(q, k, v, blk_k=16, **kw),
            FA.flash_attention_bshd_ref(q, k, v, blk_k=16, **kw))
    qb, kb, vb = (t.transpose(1, 2).reshape(-1, 64, 16) for t in (q, q, q))
    assert torch.equal(FA.flash_attention_bhsd(qb, kb, vb, blk_k=32),
                       FA.flash_attention_ref(qb, kb, vb, blk_k=32))
    r, k7, v7, w, u = _rwkv_args()
    y, S = RC.rwkv_chunked_bthd(r, k7, v7, w, u, chunk=8, return_state=True)
    y_ref, S_ref = RC.rwkv_chunked_bthd_ref(r, k7, v7, w, u, chunk=8,
                                            return_state=True)
    assert torch.equal(y, y_ref) and torch.equal(S, S_ref)
    bh = [t.transpose(1, 2).reshape(4, 32, 16) for t in (r, k7, v7, w)]
    ub = u.expand(2, 2, 16).reshape(4, 16)
    assert torch.equal(RC.rwkv_chunked(*bh, ub, chunk=8),
                       RC.rwkv_chunked_ref(*bh, ub, chunk=8))
    args = _scan_args()
    for a, b in zip(SS.ssm_scan(*args[:6]), SS.ssm_scan_ref(*args[:6])):
        assert torch.equal(a, b)
    for a, b in zip(SS.ssm_scan_bwd(*args), SS.ssm_scan_bwd_ref(*args)):
        assert torch.equal(a, b)


def test_meta_branches_count_each_call_by_formula():
    counts = (FA.flash_attention_bshd.launches, RC.rwkv_chunked_bthd.launches,
              SS.ssm_scan.launches, SS.ssm_scan_bwd.launches)
    q, k, v, do = _k6_args(torch.bfloat16, "meta", S=256, hd=64)
    r, k7, v7, w, u = _rwkv_args("meta", T=256, hd=64)
    xh, dt, B_, C_, A, h0, gy, gh = _scan_args("meta", S=40, hd=32)
    bh = _meta(2, 256, 64, dtype=torch.bfloat16)
    with W.WorkCounter() as c:
        out = FA.flash_attention_bshd(q, k, v, window=64)
        out_bh = FA.flash_attention_bhsd(bh, bh, bh, causal=False)
        dq, dk, dv = FA.flash_attention_bshd_bwd(q, k, v, out, do,
                                                 window=64)
        y7, S7 = RC.rwkv_chunked_bthd(r, k7, v7, w, u, return_state=True)
        y8, h8 = SS.ssm_scan(xh, dt, B_, C_, A, h0)
        g8 = SS.ssm_scan_bwd(xh, dt, B_, C_, A, h0, gy, gh)
    assert counts == (FA.flash_attention_bshd.launches,
                      RC.rwkv_chunked_bthd.launches, SS.ssm_scan.launches,
                      SS.ssm_scan_bwd.launches)
    for got, like in ((out, q), (dq, q), (dk, k), (dv, v), (y7, r), (y8, xh),
                      (h8, h0), *zip(g8, (xh, dt, B_, C_, A, h0))):
        assert got.is_meta and got.shape == like.shape \
            and got.dtype == like.dtype
    assert out_bh.shape == bh.shape and S7.shape == (2, 2, 64, 64)
    k6 = 4 * 2 * 4 * 64 * _causal_pairs(256, 64)
    k6_bh = 4 * 2 * 64 * 256 * 256     # no mask: every pair
    assert c.kernels == {
        "flash_attention": {"calls": 2, "flops": k6 + k6_bh,
                            "bytes": W.nbytes(q, k, v, q, bh, bh, bh, bh)},
        "flash_attention_bwd": {"calls": 1, "flops": int(2.5 * k6),
                                "bytes": W.nbytes(q, k, v, q, q, q, k, v)},
        "rwkv_chunked": {"calls": 1,
                         "flops": 2 * 2 * 256 * (5 * 64 * 64 + 5 * 64),
                         "bytes": W.nbytes(r, k7, v7, w, u, y7, S7)},
        "ssm_scan": {"calls": 1,
                     "flops": 2 * 40 * 3 * (32 * (5 * 8 + 1) + 2),
                     "bytes": W.nbytes(xh, dt, B_, C_, A, h0, y8, h8)},
        "ssm_scan_bwd": {"calls": 1,
                         "flops": 2 * 40 * 3 * (32 * (11 * 8 + 5) + 4),
                         "bytes": W.nbytes(xh, dt, B_, C_, A, h0, gy, gh,
                                           *g8)}}


def test_meta_branches_refuse_what_the_card_refuses():
    q, k, v, _ = _k6_args(torch.bfloat16, "meta", hd=48)
    with pytest.raises(ValueError, match="head dim 48"):
        FA.flash_attention_bshd(q, k, v)
    with pytest.raises(ValueError, match="f32 or bf16"):
        FA.flash_attention_bshd(*(t.half() for t in (q, k, v)))
    args = _scan_args("meta", hd=24)
    with pytest.raises(ValueError, match="hd 24"):
        SS.ssm_scan(*args[:6])
    r, k7, v7, w, u = _rwkv_args("meta")
    with pytest.raises(ValueError, match="zero state"):
        RC.rwkv_chunked_bthd(r, k7, v7, w, u, S0=_meta(2, 2, 16, 16))


def test_k6_gradient_on_meta_counts_forward_and_backward():
    """K6's Function on meta tensors: one forward and one backward in the
    counter, gradients of the inputs' shapes, nothing launched."""
    q, k, v, do = _k6_args(torch.bfloat16, "meta")
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n = FA.flash_attention_bshd.launches
    with W.WorkCounter() as c:
        out = FA.FlashAttention.apply(q, k, v, True, 0, 0, 64)
        grads = torch.autograd.grad(out, (q, k, v), do)
    assert FA.flash_attention_bshd.launches == n
    assert {k_: v_["calls"] for k_, v_ in c.kernels.items()} == \
        {"flash_attention": 1, "flash_attention_bwd": 1}
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_roofline_terms_against_h100_peaks():
    t = AN.roofline_terms({"flops": 989e12, "hbm_bytes": 6.7e12,
                           "collective_bytes": 0.0})
    assert t == {"t_compute_s": 1.0, "t_memory_s": 2.0,
                 "t_collective_s": 0.0, "dominant": "t_memory_s",
                 "roofline_fraction": 0.5}
    assert AN.roofline_terms({"flops": 67e12, "hbm_bytes": 0.0,
                              "collective_bytes": 0.0},
                             W.PEAK_FLOPS_F32)["dominant"] == "t_compute_s"


def test_report_rows_at_a_smoke_size():
    """Each kind of step counted end to end at a smoke size (rwkv6's train
    step through K7, its backward in PyTorch operations, and remat), the
    model FLOPs 6 N D / 2 N D / 2 N B, and the markdown table."""
    cfg = get_smoke_config("rwkv6-3b")
    rows = [REPORT.cell_row("rwkv6-3b", cfg, s, TrainConfig(microbatches=2))
            for s in (ShapeConfig("train", 64, 4, "train"),
                      ShapeConfig("prefill", 64, 2, "prefill"),
                      ShapeConfig("decode", 64, 2, "decode"))]
    N = cfg.n_active_params
    assert [r["model_flops_dev"] for r in rows] == \
        [6.0 * N * 256, 2.0 * N * 128, 2.0 * N * 2]
    for r in rows:
        assert r["counted_flops_dev"] > 0 and r["fits_80gb"]
        assert r["t_collective_s"] == 0.0
        assert np.isclose(r["useful_ratio"],
                          r["model_flops_dev"] / r["counted_flops_dev"])
    md = REPORT.to_markdown(rows).splitlines()
    assert len(md) == 2 + len(rows) and md[2].startswith("| rwkv6-3b | train")
