"""The gradients of K7 and K8 against the live JAX package on the CPU, at
smoke sizes: ``kernels.ssm_scan.SsmScan`` (K8's Function: its plain
forward and ``ssm_scan_bwd_ref`` here) against ``jax.vjp`` of the
reference's ``models.ssm.ssm_scan``, and ``kernels.rwkv_chunk.RwkvChunk``
(K7's Function: its plain forward and ``rwkv_chunked_bthd_bwd``) through
the port's ``time_mix_chunked`` against ``jax.vjp`` of the reference's,
both from numpy-seeded inputs; each backward also against autograd
through its own plain forward, and K7's under the 1e-38 clamp against
the same chunk math in f64.

Bounds: every gradient to 1e-5 of its largest magnitude (f32 on both
sides, the same function summed in other orders; measured <= 5e-7 for
the scan and <= 1e-6 through the time-mix), and the forward's outputs to
1e-5 likewise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.models import rwkv as JR
from repro.models import ssm as JS
from repro_torch.kernels import rwkv_chunk as RC
from repro_torch.kernels import ssm_scan as SS
from repro_torch.models import rwkv as TR

torch.set_num_threads(1)
TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _scan_case(B, S, H, hd, N, seed):
    """xh, dt, B_, C_, A, a non-zero h0, and the output gradients gy and
    g_hout, as numpy f32 (dt over the softplus range, A < 0)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal((B, S, H, hd)).astype(f),
            rng.uniform(0.01, 1.5, (B, S, H)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            -rng.uniform(0.2, 2.0, H).astype(f),
            (rng.standard_normal((B, H, hd, N)) * 0.5).astype(f),
            rng.standard_normal((B, S, H, hd)).astype(f),
            rng.standard_normal((B, H, hd, N)).astype(f)]


SCAN_SHAPES = [(2, 13, 3, 16, 8),    # S past one backward tile of 8
               (1, 40, 2, 32, 16),
               (3, 8, 4, 16, 16)]    # S one tile


@pytest.mark.parametrize("B,S,H,hd,N", SCAN_SHAPES)
def test_ssm_scan_function_matches_jax_vjp(B, S, H, hd, N):
    """dxh, ddt, dB_, dC_, dA and dh0 of the port's ``SsmScan`` (plain on
    the CPU) against ``jax.vjp`` of the reference's ``ssm_scan``, from a
    non-zero h0 and with a g_hout."""
    arrs = _scan_case(B, S, H, hd, N, seed=S + hd)
    ins, (gy, gh) = arrs[:6], arrs[6:]
    (yj, hj), vjp = jax.vjp(JS.ssm_scan, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    tin = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = SS.SsmScan.apply(*tin)
    assert _rel(y, yj) < TOL and _rel(h, hj) < TOL
    got = torch.autograd.grad((y, h), tin, (torch.from_numpy(gy),
                                            torch.from_numpy(gh)))
    for name, g, w in zip(("xh", "dt", "B_", "C_", "A", "h0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) < TOL, (name, _rel(g, w))


@pytest.mark.parametrize("B,S,H,hd,N", SCAN_SHAPES[:2])
def test_ssm_scan_bwd_ref_matches_autograd(B, S, H, hd, N):
    """``ssm_scan_bwd_ref`` against autograd through ``ssm_scan_ref``
    (f32), every output."""
    arrs = [torch.from_numpy(a) for a in _scan_case(B, S, H, hd, N, 7)]
    ins = [t.clone().requires_grad_() for t in arrs[:6]]
    y, h = SS.ssm_scan_ref(*ins)
    want = torch.autograd.grad((y, h), ins, (arrs[6], arrs[7]))
    got = SS.ssm_scan_bwd_ref(*arrs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) < TOL


def test_ssm_scan_saves_nothing_without_grad():
    """Over frozen inputs (serving) the Function builds no graph; on the
    CPU no launch counter moves."""
    args = [torch.from_numpy(a) for a in _scan_case(1, 5, 2, 16, 8, 1)[:6]]
    n = (SS.ssm_scan.launches, SS.ssm_scan_bwd.launches)
    y, h = SS.SsmScan.apply(*args)
    assert y.grad_fn is None and h.grad_fn is None
    assert (SS.ssm_scan.launches, SS.ssm_scan_bwd.launches) == n


# ---------------------------------------------------------------------------
# K7 through the time-mix
# ---------------------------------------------------------------------------

def _tm_layer(seed: int):
    """Layer 0's time-mix leaves of the reference's rwkv6-3b smoke config
    in f32 (numpy) from ``jax.random.key(seed)``, and an input x (1, 64,
    d)."""
    cfg = dataclasses.replace(j_smoke("rwkv6-3b"), dtype="float32")
    params = JM.init_params(cfg, jax.random.key(seed))
    tm = {k: np.array(v[0], dtype=np.float32)
          for k, v in params["layers"]["tm"].items()}
    x = np.random.default_rng(seed).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32)
    return cfg, tm, x


@pytest.mark.parametrize("seed", [4, 5])
def test_time_mix_chunked_grad_matches_jax_vjp(seed):
    """The gradients of the chunked time-mix (chunk 16, S = 64: K7's
    Function from the zero state) to x, the carry-in and every time-mix
    leaf (``wr``/``wk``/``wv``/``w0``/``wa``/``wb``/``u`` carry dr, dk, dv,
    dw and du) against ``jax.vjp`` of the reference's, with output
    gradients for y, the final state and the carry-out."""
    cfg, tm, x = _tm_layer(seed)
    hd = cfg.resolved_head_dim
    H = cfg.d_model // hd
    rng = np.random.default_rng(11)
    xp = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gS = rng.standard_normal((1, H, hd, hd)).astype(np.float32)
    gl = rng.standard_normal(xp.shape).astype(np.float32)
    keys = sorted(tm)

    def jf(x, xp, *leaves):
        return JR.time_mix_chunked(x, xp, jnp.zeros((1, H, hd, hd)),
                                   dict(zip(keys, leaves)), H, hd, chunk=16)
    outs, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(xp),
                        *(jnp.asarray(tm[k]) for k in keys))
    want = vjp(tuple(map(jnp.asarray, (gy, gS, gl))))
    tin = [torch.from_numpy(a).requires_grad_()
           for a in (x, xp, *(tm[k] for k in keys))]
    got_outs = TR.time_mix_chunked(tin[0], tin[1], None,
                                   dict(zip(keys, tin[2:])), H, hd,
                                   chunk=16)
    for g, w in zip(got_outs, outs):
        assert _rel(g, w) < TOL
    got = torch.autograd.grad(got_outs, tin, tuple(
        map(torch.from_numpy, (gy, gS, gl))), allow_unused=True,
        materialize_grads=True)
    for name, g, w in zip(["x", "x_prev", *keys], got, want):
        assert _rel(g, w) < TOL, (name, _rel(g, w))


def _chunk_f64(r, k, v, w, u, C):
    """The chunk math of ``rwkv_chunked_ref`` in f64 throughout (y, S_T),
    from the zero state: the reference's ``log(max(w, 1e-38))`` with a
    clamp that holds (1e-38 is a normal f64)."""
    B, T, H, hd = r.shape

    def bh(t):
        return t.transpose(1, 2).reshape(B * H, T, hd)
    r, k, v, w = map(bh, (r, k, v, w))
    u = u.expand(B, H, hd).reshape(B * H, hd)
    S = torch.zeros((B * H, hd, hd), dtype=torch.float64)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool), -1)
    ys = []
    for c0 in range(0, T, C):
        rc, kc, vc, wc = (t[:, c0:c0 + C] for t in (r, k, v, w))
        logw = torch.log(torch.clamp(wc, min=1e-38))
        cum = torch.cumsum(logw, 1)
        rP = rc * torch.exp(cum - logw)
        A = torch.where(tri, rP @ (kc * torch.exp(-cum)).transpose(1, 2),
                        0.0)
        ys.append(A @ vc + (rc * u[:, None] * kc).sum(-1, keepdim=True)
                  * vc + rP @ S)
        total = cum[:, -1]
        S = torch.exp(total)[..., None] * S + (
            kc * torch.exp(total[:, None] - cum)).transpose(1, 2) @ vc
    return (torch.cat(ys, 1).reshape(B, H, T, hd).transpose(1, 2),
            S.reshape(B, H, hd, hd))


def test_rwkv_chunked_bwd_under_the_clamp():
    """Decays under the 1e-38 clamp (w = 0 and 1e-40, at a chunk's last
    token and inside one, the rest in (0.999, 1) so that the f32 forward
    stays finite): the backward is finite, dw is exactly 0 where the
    clamp stops the gradient, and every gradient matches autograd through
    the same chunk math in f64 (``_chunk_f64``) to 1e-5 of its largest
    magnitude. Not against the reference here: on XLA's CPU 1e-38 is a
    denormal and is flushed to zero, so the reference's clamp is 0, its
    ``log`` -inf and its forward NaN at such a w (checked below); the
    port keeps the clamp the reference states."""
    B, T, H, hd, C = 2, 64, 2, 16, 16
    rng = np.random.default_rng(3)
    f = np.float32
    r, k, v, gy = (rng.standard_normal((B, T, H, hd)).astype(f) * 0.5
                   for _ in range(4))
    w = rng.uniform(0.999, 1.0, (B, T, H, hd)).astype(f)
    under = [(0, 15, 0, 3), (1, 47, 1, 0), (0, 40, 1, 7), (1, 20, 0, 5)]
    for i, idx in enumerate(under):
        w[idx] = 0.0 if i % 2 == 0 else 1e-40
    u = rng.standard_normal((H, hd)).astype(f) * 0.1
    gS = rng.standard_normal((B, H, hd, hd)).astype(f)
    ts = [torch.from_numpy(a) for a in (r, k, v, w, u, gy, gS)]
    got = RC.rwkv_chunked_bthd_bwd(*ts[:6], ts[6], chunk=C)
    ins = [t.double().requires_grad_() for t in ts[:5]]
    want = torch.autograd.grad(_chunk_f64(*ins, C), ins,
                               (ts[5].double(), ts[6].double()))
    for name, g, wt in zip("rkvwu", got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, wt) < TOL, (name, _rel(g, wt))
    for idx in under:
        assert float(got[3][idx]) == 0.0
    y = RC.rwkv_chunked_bthd_ref(*ts[:5], chunk=C)
    assert torch.isfinite(y).all()
    logw = np.asarray(jnp.log(jnp.maximum(jnp.asarray(w), 1e-38)))
    assert np.isneginf(logw[under[0]])


@pytest.mark.parametrize("B,T,H,hd,C", [(2, 64, 3, 16, 16),
                                        (1, 256, 2, 32, 128),
                                        (2, 48, 1, 16, 48)])   # one chunk
def test_rwkv_chunked_bwd_matches_autograd(B, T, H, hd, C):
    """``rwkv_chunked_bthd_bwd`` (dr, dk, dv, dw, du; du summed over the
    batch into u's (H, hd)) against autograd through the plain version's
    (y, S_T), f32, decays over (0.6, 0.999)."""
    rng = np.random.default_rng(T + hd)
    f = np.float32
    r, k, v, gy = (torch.from_numpy(rng.standard_normal(
        (B, T, H, hd)).astype(f) * 0.5) for _ in range(4))
    w = torch.from_numpy(rng.uniform(0.6, 0.999, (B, T, H, hd)).astype(f))
    u = torch.from_numpy(rng.standard_normal((H, hd)).astype(f) * 0.1)
    gS = torch.from_numpy(rng.standard_normal((B, H, hd, hd)).astype(f))
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, S = RC.rwkv_chunked_bthd_ref(*ins, chunk=C, return_state=True)
    want = torch.autograd.grad((y, S), ins, (gy, gS))
    got = RC.rwkv_chunked_bthd_bwd(r, k, v, w, u, gy, gS, chunk=C)
    for name, g, wt in zip("rkvwu", got, want):
        assert g.shape == wt.shape, name
        assert _rel(g, wt) < TOL, (name, _rel(g, wt))


def test_rwkv_chunk_saves_nothing_without_grad():
    """Over frozen inputs the Function builds no graph and returns the
    plain version's y and final state."""
    rng = np.random.default_rng(2)
    r, k, v = (torch.from_numpy(rng.standard_normal((1, 32, 2, 16)).astype(
        np.float32)) for _ in range(3))
    w = torch.full((1, 32, 2, 16), 0.9)
    u = torch.zeros((2, 16))
    y, S = RC.RwkvChunk.apply(r, k, v, w, u, 16)
    assert y.grad_fn is None and S.grad_fn is None
    yw, Sw = RC.rwkv_chunked_bthd_ref(r, k, v, w, u, chunk=16,
                                      return_state=True)
    assert torch.equal(y, yw) and torch.equal(S, Sw)
