"""``repro_torch.kernels.ops`` against the reference's ``repro.kernels.ops``
on the CPU: the same public wrappers (``pc_table_predict``,
``pc_table_update``, ``flash_attention``, ``rwkv_chunked``) on the same
inputs, the reference's Pallas kernels in interpret mode, the port's
plain versions. Tolerances: 1e-5 relative (f32; the PC-table prediction
sums its wavefronts in another order, atol 1e-3 on values up to ~1e4),
K7 to the reference's 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import pc_table as KPT


def _rng(seed):
    return np.random.default_rng(seed)


def test_ops_exposes_the_reference_wrappers():
    names = ("pc_table_predict", "pc_table_update", "flash_attention",
             "rwkv_chunked")
    assert all(callable(getattr(OPS, n)) for n in names)
    assert all(callable(getattr(JOPS, n)) for n in names)
    assert OPS.pc_table_predict is KPT.pc_table_predict
    assert OPS.pc_table_update is KPT.pc_table_update
    assert not hasattr(OPS, "set_backend")


@pytest.mark.parametrize("cap", [0.0, 60.0])
def test_pc_table_predict_matches_reference_ops(cap):
    rng = _rng(5)
    T, E, CU, WF = 8, 128, 16, 40
    arrs = [rng.uniform(0, 60, (T, E)), rng.uniform(0, 40, (T, E)),
            (rng.uniform(size=(T, E)) > 0.4) * 1.0,
            rng.integers(0, T, CU), rng.integers(0, E, (CU, WF)),
            rng.uniform(0, 60, (CU, WF)), rng.uniform(0, 40, (CU, WF)),
            np.linspace(1.3, 2.2, 10)]
    ints = (3, 4)
    j = [jnp.asarray(a, jnp.int32 if i in ints else jnp.float32)
         for i, a in enumerate(arrs)]
    t = [torch.as_tensor(np.asarray(a), dtype=torch.int32 if i in ints
                         else torch.float32) for i, a in enumerate(arrs)]
    want = JOPS.pc_table_predict(*j, epoch_us=2.0, cap_per_ghz=cap)
    got = OPS.pc_table_predict(*t, epoch_us=2.0, cap_per_ghz=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_pc_table_update_matches_reference_ops():
    rng = _rng(6)
    T, E, N = 8, 64, 40
    tbl = [rng.uniform(0, 60, (T, E)), rng.uniform(0, 40, (T, E)),
           (rng.uniform(size=(T, E)) > 0.5) * rng.integers(1, 5, (T, E))]
    idx = rng.integers(0, E, (T, N))
    i0, se = rng.uniform(0, 60, (T, N)), rng.uniform(0, 40, (T, N))
    want = JOPS.pc_table_update(
        *(jnp.asarray(a, jnp.float32) for a in tbl),
        jnp.asarray(idx, jnp.int32), jnp.asarray(i0, jnp.float32),
        jnp.asarray(se, jnp.float32), ema=0.3)
    f32 = [torch.as_tensor(a, dtype=torch.float32) for a in tbl]
    got = OPS.pc_table_update(*f32, torch.as_tensor(idx, dtype=torch.int32),
                              torch.as_tensor(i0, dtype=torch.float32),
                              torch.as_tensor(se, dtype=torch.float32),
                              ema=0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_attention_matches_reference_ops(window):
    rng = _rng(7)
    B, S, H, Hkv, hd = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    want = JOPS.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window, blk_q=32,
                                blk_k=32)
    got = OPS.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), window=window, blk_q=32,
                              blk_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rwkv_chunked_matches_reference_ops():
    rng = _rng(8)
    BH, T, hd = 4, 64, 16
    r, k, v = (rng.standard_normal((BH, T, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.6, 0.999, (BH, T, hd)).astype(np.float32)
    u = rng.standard_normal((BH, hd)).astype(np.float32) * 0.1
    want = JOPS.rwkv_chunked(*map(jnp.asarray, (r, k, v, w, u)), chunk=16)
    got = OPS.rwkv_chunked(*map(torch.as_tensor, (r, k, v, w, u)), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
