"""The gradients of K7 and K8 against the live JAX package on the CPU, at
smoke sizes: ``kernels.ssm_scan.SsmScan`` (K8's Function: its plain
forward and ``ssm_scan_bwd_ref`` here) against ``jax.vjp`` of the
reference's ``models.ssm.ssm_scan``, and ``kernels.rwkv_chunk.RwkvChunk``
(K7's Function: its plain forward and ``rwkv_chunked_bthd_bwd``) through
the port's ``time_mix_chunked`` against ``jax.vjp`` of the reference's,
both from numpy-seeded inputs; each backward also against autograd
through its own plain forward, and K7's under the 1e-38 clamp against
the same chunk math in f64. ``_k7_bwd_mirror`` is K7's backward kernel
as it orders its work, in PyTorch (its blocks of 16 tokens, the 2^j
scaling, the per-element folds, the suffix walk), held against the plain
version, f64 autograd under the clamp and ``jax.vjp`` through the
time-mix: only the card runs the kernel itself.

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


SCAN_SHAPES = [(2, 13, 3, 16, 8),
               (1, 40, 2, 32, 16),    # S past one backward chunk of 32
               (3, 8, 4, 16, 16)]


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


def _chunked_bwd_mirror(xh, dt, B_, C_, A, h0, gy, g_hout, L):
    """A mirror, in PyTorch operations (f32), of the three launches of
    K8's backward kernel over chunks of L tokens: (1) each chunk's decay
    product D (in token order), its state increment Delta (the state
    walked from zero, in the forward's operation order) and its
    carried-gradient increment Gamma (walked in reverse from zero); (2)
    the chains h_start[c] (from h0) and g_end[c] (in reverse from g_hout),
    dh0 = D_0 g_end[0] + Gamma_0; (3) each chunk's states recomputed from
    h_start[c] and its tokens walked backwards from g_end[c]. Returns
    (dxh, ddt, dB_, dC_, dA, dh0), D (B, H, nc) and h_start (one state
    per chunk)."""
    Bn, S, H, hd = xh.shape
    decay = torch.exp(dt * A)                               # (B,S,H)
    nc = -(-S // L)
    chunks = [range(c * L, min(S, (c + 1) * L)) for c in range(nc)]

    def dbx(t):
        return (dt[:, t, :, None] * xh[:, t])[..., None] \
            * B_[:, t, None, None, :]

    def a(t):
        return decay[:, t, :, None, None]
    # 1. increments
    D, Delta, Gamma = [], [], []
    for ts in chunks:
        st, p = torch.zeros_like(h0), torch.ones_like(decay[:, 0])
        for t in ts:
            st = st * a(t) + dbx(t)
            p = p * decay[:, t]
        g = torch.zeros_like(h0)
        for t in reversed(ts):
            g = a(t) * (g + C_[:, t, None, None, :] * gy[:, t, ..., None])
        D.append(p)
        Delta.append(st)
        Gamma.append(g)
    # 2. chains
    h_start, h = [], h0
    for c in range(nc):
        h_start.append(h)
        h = D[c][..., None, None] * h + Delta[c]
    g_end, g = [None] * nc, g_hout
    for c in reversed(range(nc)):
        g_end[c] = g
        g = D[c][..., None, None] * g + Gamma[c]
    dh0 = g
    # 3. each chunk's gradients
    dx, ddt = torch.zeros_like(xh), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(B_), torch.zeros_like(C_)
    dA_part = torch.zeros((Bn, H, nc))
    for c, ts in enumerate(chunks):
        hs = [h_start[c]]
        for t in ts:
            hs.append(hs[-1] * a(t) + dbx(t))
        g = g_end[c]
        for i in reversed(range(len(ts))):
            t = ts[i]
            gh = g + C_[:, t, None, None, :] * gy[:, t, ..., None]
            dC[:, t] = torch.einsum("bhdn,bhd->bn", hs[i + 1], gy[:, t])
            sB = torch.einsum("bhdn,bn->bhd", gh, B_[:, t])
            sH = (gh * hs[i]).sum(-1).sum(-1)
            dx[:, t] = dt[:, t, :, None] * sB
            dB[:, t] = torch.einsum("bhdn,bhd->bn", gh,
                                    dt[:, t, :, None] * xh[:, t])
            ddt[:, t] = (xh[:, t] * sB).sum(-1) + A * decay[:, t] * sH
            dA_part[:, :, c] += decay[:, t] * dt[:, t] * sH
            g = gh * a(t)
    return ((dx, ddt, dB, dC, dA_part.sum((0, 2)), dh0), torch.stack(D, -1),
            h_start)


# (B, S, H, hd, N, what): S past a chunk and not a multiple of it, S under
# one chunk, S = 1, a chunk whose decay product underflows to 0 (dt in
# (2, 3) at A = -2: the product of 32 decays is under f32's least
# denormal), and A near 0 (every decay ~1)
CHUNK_CASES = [(2, 75, 3, 16, 8, "ragged"), (1, 20, 2, 16, 16, "short"),
               (2, 1, 2, 16, 8, "one"), (2, 70, 2, 16, 8, "underflow"),
               (1, 40, 2, 32, 16, "no decay")]


@pytest.mark.parametrize("B,S,H,hd,N,what", CHUNK_CASES,
                         ids=[c[-1] for c in CHUNK_CASES])
def test_ssm_scan_bwd_chunk_algebra(B, S, H, hd, N, what):
    """The chunked form of K8's backward kernel (``_chunked_bwd_mirror`` at
    the kernel's ``BWD_CHUNK``) against ``ssm_scan_bwd_ref`` and against
    ``jax.vjp`` of the reference's ``ssm_scan``, every output, from a
    non-zero h0 and with a g_hout; an underflowing chunk's D is 0 and
    every output stays finite."""
    L = SS.BWD_CHUNK
    arrs = _scan_case(B, S, H, hd, N, seed=S + hd + N)
    rng = np.random.default_rng(S)
    if what == "underflow":
        arrs[1][:, L:2 * L] = rng.uniform(2.0, 3.0, (B, L, H))
        arrs[4][:] = -2.0
    elif what == "no decay":
        arrs[4][:] = -1e-7
    ts = [torch.from_numpy(x) for x in arrs]
    got, D, _ = _chunked_bwd_mirror(*ts, L)
    assert D.shape == (B, H, -(-S // L))
    if what == "underflow":
        assert bool((D[..., 1] == 0).all()) and bool((D[..., 0] > 0).all())
    want = SS.ssm_scan_bwd_ref(*ts)
    (_, _), vjp = jax.vjp(JS.ssm_scan, *map(jnp.asarray, arrs[:6]))
    jwant = vjp((jnp.asarray(arrs[6]), jnp.asarray(arrs[7])))
    for name, g, w, jw in zip(("xh", "dt", "B_", "C_", "A", "h0"), got, want,
                              jwant):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert _rel(g, w) < TOL, (name, _rel(g, w))
        assert _rel(g, jw) < TOL, (name, _rel(g, jw))


def _chunked_fwd_mirror(xh, dt, B_, C_, A, h0, L):
    """A mirror, in PyTorch operations (f32), of the three launches of
    K8's forward kernel over chunks of L tokens: (1) for every chunk but
    the last, its decay product D (in token order) and its state walked
    from zero, Delta; (2) the chain h_start[c + 1] = D_c h_start[c] +
    Delta_c from h_start[0] = h0; (3) each chunk's tokens walked from
    h_start[c], each step as the plain version's, y summed over the
    states in their order (each term rounded here; the kernel fuses it
    into the sum); h_out is the last chunk's last state. Returns
    (y, h_out), D (B, H, nc - 1) and h_start (one state per chunk)."""
    S, N = xh.shape[1], B_.shape[-1]
    decay = torch.exp(dt * A)                               # (B,S,H)
    nc = -(-S // L)
    chunks = [range(c * L, min(S, (c + 1) * L)) for c in range(nc)]

    def step(h, t):
        dbx = (dt[:, t, :, None] * xh[:, t])[..., None] \
            * B_[:, t, None, None, :]
        return h * decay[:, t, :, None, None] + dbx
    # 1. increments
    D, Delta = [], []
    for ts in chunks[:-1]:
        st, p = torch.zeros_like(h0), torch.ones_like(decay[:, 0])
        for t in ts:
            st = step(st, t)
            p = p * decay[:, t]
        D.append(p)
        Delta.append(st)
    # 2. the chain
    h_start = [h0]
    for c in range(nc - 1):
        h_start.append(D[c][..., None, None] * h_start[c] + Delta[c])
    # 3. outputs
    y = torch.empty_like(xh)
    for c, ts in enumerate(chunks):
        h = h_start[c]
        for t in ts:
            h = step(h, t)
            acc = h[..., 0] * C_[:, t, None, None, 0]
            for n in range(1, N):
                acc = acc + h[..., n] * C_[:, t, None, None, n]
            y[:, t] = acc
    D = torch.stack(D, -1) if D else torch.ones(h0.shape[:2] + (0,))
    return (y, h), D, h_start


# (B, S, H, hd, N, what) at the forward's chunk L = FWD_CHUNK: S = 1, S
# under, at and one past a chunk, a ragged S over ~2.3 chunks, a chunk
# whose decay product underflows to 0 (dt in (2, 3) at A = -2 over the
# second chunk), A near 0 (every decay ~1), and a non-zero h0 over many
# chunks (every case starts from a non-zero h0)
_L8 = SS.FWD_CHUNK
FWD_CHUNK_CASES = [(2, 1, 2, 16, 8, "one"), (1, _L8 // 2, 2, 16, 16, "short"),
                   (2, _L8, 3, 16, 8, "one chunk"),
                   (1, _L8 + 1, 2, 32, 8, "chunk + 1"),
                   (2, 2 * _L8 + _L8 * 3 // 10, 3, 16, 8, "ragged"),
                   (2, 3 * _L8 + 5, 2, 16, 8, "underflow"),
                   (1, 2 * _L8 + 7, 2, 32, 16, "no decay"),
                   (1, 4 * _L8 + 3, 2, 16, 16, "h0")]


@pytest.mark.parametrize("B,S,H,hd,N,what", FWD_CHUNK_CASES,
                         ids=[c[-1] for c in FWD_CHUNK_CASES])
def test_ssm_scan_fwd_chunk_algebra(B, S, H, hd, N, what):
    """The chunked form of K8's forward kernel (``_chunked_fwd_mirror`` at
    the kernel's ``FWD_CHUNK``) against ``ssm_scan_ref`` and against the
    reference's ``ssm_scan`` (JAX on the CPU), y and h_out within the
    kernel's tolerance 1e-4 + 1e-5 |ref|, from a non-zero h0; an
    underflowing chunk's D is 0 and every output stays finite; the states
    it chains into each chunk are bit for bit those of the backward's
    mirror at the same chunk length."""
    L = SS.FWD_CHUNK
    arrs = _scan_case(B, S, H, hd, N, seed=S + hd + N)[:6]
    rng = np.random.default_rng(S)
    if what == "underflow":
        # the other chunks' dt kept small, so that only the second
        # chunk's product underflows at A = -2
        arrs[1][:] = rng.uniform(0.01, 0.5, (B, S, H))
        arrs[1][:, L:2 * L] = rng.uniform(2.0, 3.0, (B, L, H))
        arrs[4][:] = -2.0
    elif what == "no decay":
        arrs[4][:] = -1e-7
    ts = [torch.from_numpy(x) for x in arrs]
    (y, h), D, h_start = _chunked_fwd_mirror(*ts, L)
    nc = -(-S // L)
    assert D.shape == (B, H, nc - 1) and len(h_start) == nc
    if what == "underflow":
        assert bool((D[..., 1] == 0).all()) and bool((D[..., 0] > 0).all())
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_ref, h_ref = SS.ssm_scan_ref(*ts)
    yj, hj = JS.ssm_scan(*map(jnp.asarray, arrs))
    for got, want in ((y, y_ref), (h, h_ref), (y, yj), (h, hj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-4)
    gy = torch.zeros_like(ts[0])
    _, _, h_bwd = _chunked_bwd_mirror(*ts, gy, torch.zeros_like(ts[5]), L)
    assert all(torch.equal(a, b) for a, b in zip(h_start, h_bwd))


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


def _k7_bwd_mirror(r, k, v, w, u, gy, gS, C):
    """K7's backward kernel (``csrc/rwkv_chunk_bwd.cu``) as it orders its
    work, in PyTorch f32 (test-only): the chunks' state increments and the
    two chains (launches 1 and 2), then each chunk's gradients (launch 3)
    over Cp = C rounded up to 32 rows: the 2^j column scaling of rP and kD
    (P the exp of the previous token's cum), the blocks of A^T, dA^T and dA
    over 16 tokens formed and consumed at once, each product's result
    folded element by element (dcum = gP - gE - gF and gP kept per tile),
    the suffix walk for dw and du per tile. Returns dr, dk, dv, dw and du
    in ``rwkv_chunked_bthd_bwd``'s shapes."""
    B, T, H, hd = r.shape
    nc, Cp = T // C, -(-C // 32) * 32

    def tiles(x, pad):   # (B,T,H,hd) -> (B,H,nc,Cp,hd), rows past C padded
        x = x.float().permute(0, 2, 1, 3).reshape(B, H, nc, C, hd)
        return torch.nn.functional.pad(x, (0, 0, 0, Cp - C), value=pad)
    R, K, V, W, GY = (tiles(x, p) for x, p in ((r, 0.), (k, 0.), (v, 0.),
                                                (w, 1.), (gy, 0.)))
    ue = u.float().expand(B, H, hd)[:, :, None, None, :]
    lw = torch.log(torch.clamp(W, min=1e-38))
    cum = torch.cumsum(lw, 3)
    tot = cum[..., Cp - 1:, :]           # the pad rows add log 1 = 0
    # 1 and 2: dS_c = kT^T v and Ry_c = rP^T gy, chained over the chunks
    dS = (K * torch.exp(tot - cum)).transpose(-1, -2) @ V
    Ry = (R * torch.exp(cum - lw)).transpose(-1, -2) @ GY
    decay = torch.exp(tot).transpose(-1, -2)            # (B,H,nc,hd,1)
    S, G = torch.empty_like(dS), torch.empty_like(dS)
    s = torch.zeros((B, H, hd, hd))
    for c in range(nc):
        S[:, :, c], s = s, decay[:, :, c] * s + dS[:, :, c]
    g = torch.zeros((B, H, hd, hd)) if gS is None else gS.float()
    for c in reversed(range(nc)):
        G[:, :, c], g = g, Ry[:, :, c] + decay[:, :, c] * g
    dts = decay[..., 0] * (S * G).sum(-1)               # (B,H,nc,hd)
    # 3: each chunk's gradients
    j = torch.clamp(torch.round(0.5 * tot * 1.44269504), -126, 0)
    sc, inv = torch.exp2(j), torch.exp2(-j)
    prev = torch.nn.functional.pad(cum, (0, 0, 1, 0))[..., :Cp, :]
    P, E, F = torch.exp(prev) * inv, torch.exp(-cum) * sc, torch.exp(tot - cum)
    E[..., C - 1, :] = 0.0
    rPs, kDs = R * P, K * E
    ddiag = (GY * V).sum(-1, keepdim=True)
    diag = (R * ue * K).sum(-1, keepdim=True)
    upper = torch.triu(torch.ones((16, 16), dtype=torch.bool), 1)
    dv, dkd, drp = (torch.zeros_like(R) for _ in range(3))
    for s0 in range(0, Cp, 16):
        rs = slice(s0, s0 + 16)
        for t0 in range(s0, Cp, 16):   # the key side of rows s
            ts = slice(t0, t0 + 16)
            At = kDs[..., rs, :] @ rPs[..., ts, :].transpose(-1, -2)
            dAt = V[..., rs, :] @ GY[..., ts, :].transpose(-1, -2)
            if t0 == s0:
                At, dAt = At * upper, dAt * upper
            dv[..., rs, :] += At @ GY[..., ts, :]
            dkd[..., rs, :] += dAt @ rPs[..., ts, :]
        for b0 in range(0, s0 + 1, 16):   # the query side of rows t
            bs = slice(b0, b0 + 16)
            dA = GY[..., rs, :] @ V[..., bs, :].transpose(-1, -2)
            if b0 == s0:
                dA = dA * upper.T
            drp[..., rs, :] += dA @ kDs[..., bs, :]
    kT = K * F
    dv = dv + kT @ G + diag * GY
    dkT = V @ G.transpose(-1, -2)
    dk = dkd * E + dkT * F + ddiag * ue * R
    q = -(dkd * kDs) - dkT * kT
    drp = (GY @ S.transpose(-1, -2)) * sc + drp
    dr = drp * P + ddiag * ue * K
    gP = drp * rPs
    dcum = gP + q
    later = dts + (dkT * kT).sum(3)                     # d_total
    dl = torch.flip(torch.cumsum(torch.flip(dcum, (3,)), 3), (3,)) \
        + later[..., None, :] - gP
    dw = torch.where(W > 1e-38, dl / W, 0.0)
    du = (ddiag * R * K).sum((2, 3))

    def back(x):   # (B,H,nc,Cp,hd) -> (B,T,H,hd)
        return x[..., :C, :].reshape(B, H, T, hd).permute(0, 2, 1, 3)
    return (back(dr), back(dk), back(dv), back(dw),
            du.sum(0) if u.dim() == 2 else du)


@pytest.mark.parametrize("B,T,H,hd,C,use_gS,u_batch", [
    (2, 64, 2, 16, 16, True, False),
    (1, 256, 1, 16, 128, False, True),
    (1, 128, 2, 16, 64, True, False),
    (2, 24, 1, 16, 128, True, True),      # T < 32: one chunk of 24
    (1, 128, 1, 128, 64, True, False),    # head dim 128, two chunks
    (1, 64, 2, 128, 64, False, True),     # T == chunk at head dim 128
])
def test_k7_bwd_mirror_matches_plain(B, T, H, hd, C, use_gS, u_batch):
    """The mirror of K7's backward kernel (``_k7_bwd_mirror``) against its
    plain version, every gradient to 1e-5 of its largest magnitude (f32 on
    both sides, the same function summed in other orders), decays over
    (0.6, 0.999)."""
    rng = np.random.default_rng(T + hd + C)
    f = np.float32
    r, k, v, gy = (torch.from_numpy(rng.standard_normal(
        (B, T, H, hd)).astype(f) * 0.5) for _ in range(4))
    w = torch.from_numpy(rng.uniform(0.6, 0.999, (B, T, H, hd)).astype(f))
    u = torch.from_numpy((rng.standard_normal(
        (B, H, hd) if u_batch else (H, hd)) * 0.1).astype(f))
    gS = (torch.from_numpy(rng.standard_normal((B, H, hd, hd)).astype(f)
                           * 0.1) if use_gS else None)
    got = _k7_bwd_mirror(r, k, v, w, u, gy, gS, min(C, T))
    want = RC.rwkv_chunked_bthd_bwd_ref(r, k, v, w, u, gy, gS, chunk=C)
    for name, g, wt in zip("rkvwu", got, want):
        assert g.shape == wt.shape, name
        assert _rel(g, wt) < TOL, (name, _rel(g, wt))


def test_k7_bwd_mirror_under_the_clamp():
    """The mirror under the 1e-38 clamp (the cases of
    ``test_rwkv_chunked_bwd_under_the_clamp``): finite, dw exactly 0 where
    the clamp stops the gradient, every gradient within 1e-5 of autograd
    through the chunk math in f64."""
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
    got = _k7_bwd_mirror(*ts, C)
    ins = [t.double().requires_grad_() for t in ts[:5]]
    want = torch.autograd.grad(_chunk_f64(*ins, C), ins,
                               (ts[5].double(), ts[6].double()))
    for name, g, wt in zip("rkvwu", got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, wt) < TOL, (name, _rel(g, wt))
    for idx in under:
        assert float(got[3][idx]) == 0.0


def test_k7_bwd_mirror_through_time_mix_matches_jax_vjp(monkeypatch):
    """The mirror as K7's Function's backward: the chunked time-mix's
    gradients against ``jax.vjp`` of the reference's (the setting of
    ``test_time_mix_chunked_grad_matches_jax_vjp``)."""
    monkeypatch.setattr(
        RC, "rwkv_chunked_bthd_bwd",
        lambda r, k, v, w, u, gy, gS=None, *, chunk=128: _k7_bwd_mirror(
            r, k, v, w, u, gy, gS, min(chunk, r.shape[1])))
    test_time_mix_chunked_grad_matches_jax_vjp(4)


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
