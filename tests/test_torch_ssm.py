"""The port's mamba head (``models.ssm``, K8's plain version) against the
live JAX package on the CPU: ``ssm_scan``, ``depthwise_conv``,
``mamba_head`` and ``init_mamba_state`` on the same numpy inputs.

Bounds:

* ``ssm_scan`` in f32: y and h_out to 1e-5. Both run the same f32 step;
  they differ in the order of the sum over the state (XLA's dot, torch's
  einsum).
* ``depthwise_conv``: 1e-6 (the same products summed in the same order).
* ``mamba_head``: f32 to 1e-5; bf16 to 1e-2 (XLA's CPU code keeps fused
  elementwise chains in f32 where torch rounds each op to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels import ssm_scan as KSS
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _scan_inputs(B, S, H, hd, N, seed):
    """xh, dt, B_, C_, A, h0 as the head makes them: dt > 0 (softplus
    range), A < 0, a non-zero start state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, hd)).astype(f),
            rng.uniform(0.01, 1.5, (B, S, H)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            -rng.uniform(0.2, 2.0, H).astype(f),
            rng.standard_normal((B, H, hd, N)).astype(f) * 0.5)


@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("N", [8, 16])
def test_ssm_scan_matches_reference(S, N):
    args = _scan_inputs(2, S, 3, 16, N, seed=S + N)
    yj, hj = JS.ssm_scan(*map(jnp.asarray, args))
    yt, ht = TS.ssm_scan(*map(torch.from_numpy, args))
    assert yt.dtype == ht.dtype == torch.float32
    assert yt.shape == (2, S, 3, 16) and ht.shape == (2, 3, 16, N)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=1e-5, atol=1e-5)


def test_ssm_scan_casts_to_f32_as_the_reference():
    """bf16 operands are scanned in f32 (the state and y stay f32)."""
    args = _scan_inputs(1, 16, 2, 16, 8, seed=3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args[:4]]
    yj, hj = JS.ssm_scan(*bf, jnp.asarray(args[4]), jnp.asarray(args[5]))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in args[:4]]
    yt, ht = TS.ssm_scan(*tb, *map(torch.from_numpy, args[4:]))
    assert yt.dtype == ht.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=1e-5, atol=1e-5)


def test_ssm_scan_wrapper_runs_the_plain_version_on_the_cpu():
    """On a CPU tensor the kernel's wrapper is its plain version, bit for
    bit, and counts no launch."""
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 40, 2, 16, 16, 4)]
    n0 = KSS.ssm_scan.launches
    y, h = KSS.ssm_scan(*args)
    y_ref, h_ref = KSS.ssm_scan_ref(*args)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    assert KSS.ssm_scan.launches == n0


def test_ssm_scan_of_two_halves_is_the_whole():
    """The state carries the scan: the second half from the first half's
    h_out lands on the whole scan's y and h_out (the decode path)."""
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 32, 2, 16, 8, 5)]
    xh, dt, B_, C_, A, h0 = args
    y, h = TS.ssm_scan(*args)
    y1, h1 = TS.ssm_scan(xh[:, :20], dt[:, :20], B_[:, :20], C_[:, :20], A,
                         h0)
    y2, h2 = TS.ssm_scan(xh[:, 20:], dt[:, 20:], B_[:, 20:], C_[:, 20:], A,
                         h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 24])
def test_depthwise_conv_matches_reference(S):
    rng = np.random.default_rng(6 + S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    k = rng.standard_normal((4, 12)).astype(np.float32) * 0.5
    carry = rng.standard_normal((2, 3, 12)).astype(np.float32)
    oj, cj = JS.depthwise_conv(*map(jnp.asarray, (x, k, carry)))
    ot, ct = TS.depthwise_conv(*map(torch.from_numpy, (x, k, carry)))
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-6, atol=1e-6)
    assert ct.shape == (2, 3, 12)


def _head_params(D, di, H, N, K, seed):
    """A mamba head's parameters under the reference's keys, as numpy
    arrays; ``a_log`` and ``d_skip`` away from their init constants."""
    rng = np.random.default_rng(seed)

    def n(*s, scale=0.1):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w_in": n(D, 2 * di), "conv_k": n(K, di, scale=0.5),
            "w_dt": n(di, H), "dt_bias": np.full(H, -2.0, np.float32),
            "w_b": n(di, N), "w_c": n(di, N),
            "a_log": n(H, scale=0.5), "d_skip": 1.0 + n(H),
            "w_out": n(di, D)}


# the leaves the reference keeps in f32 in a bf16 model
F32_LEAVES = ("w_dt", "dt_bias", "a_log", "d_skip")


@pytest.mark.parametrize("S", [1, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_head_matches_reference(dtype, S):
    """Output and new state from a non-zero state (h and the conv carry),
    the products in the activation dtype."""
    D, hd, N, K = 32, 16, 8, 4
    p = _head_params(D, D, D // hd, N, K, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    h0 = rng.standard_normal((2, D // hd, hd, N)).astype(np.float32) * 0.3
    conv = rng.standard_normal((2, K - 1, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def leaf_j(k, a):
        return jnp.asarray(a, jnp.float32 if k in F32_LEAVES else jdt)

    def leaf_t(k, a):
        return torch.from_numpy(a).to(torch.float32 if k in F32_LEAVES
                                      else tdt)
    yj, sj = JS.mamba_head(jnp.asarray(x, jdt),
                           {k: leaf_j(k, a) for k, a in p.items()},
                           {"h": jnp.asarray(h0),
                            "conv": jnp.asarray(conv, jdt)}, hd, N)
    yt, st = TS.mamba_head(torch.from_numpy(x).to(tdt),
                           {k: leaf_t(k, a) for k, a in p.items()},
                           {"h": torch.from_numpy(h0),
                            "conv": torch.from_numpy(conv).to(tdt)}, hd, N)
    assert yt.dtype == tdt and st["conv"].dtype == tdt
    assert st["h"].dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=tol, atol=tol)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(st[key]), _np(sj[key]), rtol=tol,
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_state_matches_reference(dtype):
    sj = JS.init_mamba_state(3, 64, 16, 8, 4, getattr(jnp, dtype))
    st = TS.init_mamba_state(3, 64, 16, 8, 4, getattr(torch, dtype), "cpu")
    assert set(st) == set(sj) == {"h", "conv"}
    for key in sj:
        assert tuple(st[key].shape) == sj[key].shape, key
        assert str(st[key].dtype).split(".")[-1] == str(sj[key].dtype), key
        assert not st[key].any()
    assert st["h"].dtype == torch.float32
