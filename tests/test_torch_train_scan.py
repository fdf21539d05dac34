"""Training the ssm (rwkv6-3b) and hybrid (hymba-1.5b) families against
the live JAX package on the CPU, at smoke sizes: ``loss_fn`` and its
gradients in bf16, the remat recompute of K7's and K8's Functions, one
``make_train_step`` step, checkpoints within the port and across
packages, and ``launch.train``'s CLI. The f32 loss and every gradient
leaf of both are ``tests/test_torch_train.py``'s ``LOSS_ARCHS``. rwkv6-3b
runs 256 tokens, so that its time-mix takes the chunked branch (K7, two
chunks of 128); hymba-1.5b 32.

Bounds, each stated where it is used:

* bf16: the loss to 1e-2; each matrix leaf to 2e-2 of its largest
  magnitude (as ``tests/test_torch_train.py`` holds glm4-9b; measured <=
  1.6e-2), each vector leaf (the ``mu`` mixes, ``a_log``, ``d_skip``,
  ``dt_bias``, the norms: per-channel or per-head sums over every token
  of products that cancel, where one bf16 rounding upstream moves the
  sum) to 1e-1 (measured 6.5e-2 at hymba's ``a_log``, 4 elements, and
  2.1e-2 at rwkv6-3b's ``mu_r``).
* A train step (f32): the loss and grad_norm to 1e-5 relative, m and v
  to 1e-5 of their largest magnitude, the update to 1e-4 of the learning
  rate where ``|g| >= 1e-6`` (``tests/test_torch_train.py``'s step bound
  and its reason), and to ``2 lr (1 + wd |p|)`` everywhere.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTC
from repro.data import pipeline as JP
from repro.train import checkpoint as JCK
from repro.train import train_step as JT
from repro_torch import interop
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import rwkv_chunk as RC
from repro_torch.kernels import ssm_scan as SS
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as TCK
from repro_torch.train import train_step as TT
from test_torch_train import (LOSS_S, ROOT, _assert_states_equal, _configs,
                              _loss_and_grads, _np, _pair, _batch, _rel,
                              _tree)

ARCHS = ["rwkv6-3b", "hymba-1.5b"]


def _S(arch):
    return LOSS_S.get(arch, 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_bf16_match_reference(arch):
    """The served dtype: the loss to 1e-2, matrix leaves to 2e-2 and
    vector leaves to 1e-1 of their largest magnitude (module
    docstring)."""
    (lj, _, gj), (lt, _, gt) = _loss_and_grads(arch, "bfloat16")
    assert abs(float(lt) - float(lj)) < 1e-2
    for name in gj:
        lim = 2e-2 if gt[name].dim() > 1 else 1e-1
        assert _rel(gt[name], gj[name]) < lim, (name, _rel(gt[name],
                                                            gj[name]))


def _counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (the kernel wrapper a Function's
    forward calls)."""
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_reruns_the_scan_functions(arch, monkeypatch):
    """Under ``remat`` "full" the non-reentrant checkpoint runs K7's (or
    K8's) Function forward twice per layer (the forward and the
    recompute), once without remat; the backward runs once per layer;
    loss and gradients are bit for bit the same under "full", "dots" and
    "none"."""
    _, ct, _, pt = _pair(arch)
    _, bt = _batch(ct, 2, _S(arch), 9)
    if arch == "rwkv6-3b":
        fwd = _counting(monkeypatch, RC, "rwkv_chunked_bthd")
        bwd = _counting(monkeypatch, RC, "rwkv_chunked_bthd_bwd")
    else:
        fwd = _counting(monkeypatch, SS, "ssm_scan")
        bwd = _counting(monkeypatch, SS, "ssm_scan_bwd")
    out = {}
    for remat, n_fwd in (("full", 2), ("dots", 2), ("none", 1)):
        fwd.clear()
        bwd.clear()
        cfg = dataclasses.replace(ct, remat=remat)
        loss, _ = TM.loss_fn(pt, cfg, bt)
        grads = torch.autograd.grad(loss, list(pt.parameters()))
        assert len(fwd) == n_fwd * ct.n_layers, remat
        assert len(bwd) == ct.n_layers, remat
        out[remat] = (loss, grads)
    for remat in ("dots", "none"):
        assert torch.equal(out[remat][0], out["full"][0]), remat
        for a, b in zip(out[remat][1], out["full"][1]):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step in f32 from the reference's state on the reference's
    batch (4 sequences in 2 microbatches), against its jitted step, to the
    module docstring's bounds."""
    cj, ct = _configs(arch)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2, microbatches=2)
    tj, tt = JTC(**kw), TrainConfig(**kw)
    sj = JT.init_state(cj, tj, jax.random.key(1))
    st = interop.state_from_numpy(ct, jax.tree.map(np.asarray, sj))
    old = {k: v.clone() for k, v in _tree(ct, sj["params"]).items()}
    batch = JP.make_batch(cj, JShape("smoke", _S(arch), 4, "train"), 0,
                          microbatches=2)
    sj2, mj = jax.jit(JT.make_train_step(cj, tj))(sj, batch)
    st2, mt = TT.make_train_step(ct, tt)(
        st, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert abs(float(mt["loss"]) - float(mj["loss"])) < 1e-5
    assert abs(float(mt["grad_norm"]) / float(mj["grad_norm"]) - 1) < 1e-5
    assert float(mt["lr"]) == float(mj["lr"])
    assert int(st2["step"]) == int(sj2["step"]) == 1
    lr, wd = float(mj["lr"]), tt.weight_decay
    mj_, vj_ = _tree(ct, sj2["opt"].m), _tree(ct, sj2["opt"].v)
    pj_ = _tree(ct, sj2["params"])
    for name, p in st2["params"].named_parameters():
        m, v = st2["opt"].m[name], st2["opt"].v[name]
        for got, want in ((m, mj_[name]), (v, vj_[name])):
            assert float((got - want).abs().max()) \
                <= 1e-5 * float(want.abs().max()), name
        g = mj_[name] / (1 - tt.beta1)
        upd = (p.detach() - old[name]) - (pj_[name] - old[name])
        assert (upd.abs()[g.abs() >= 1e-6] <= 1e-4 * lr).all(), name
        assert (upd.abs() <= 2 * lr * (1 + wd * old[name].abs())).all()


def _trained_ref_state(arch):
    """The reference's state after one jitted step (f32 smoke config)."""
    cj, ct = _configs(arch)
    tc = JTC(lr=1e-3, total_steps=8, warmup_steps=2)
    sj = JT.init_state(cj, tc, jax.random.key(2))
    sj, _ = jax.jit(JT.make_train_step(cj, tc))(
        sj, JP.make_batch(cj, JShape("smoke", _S(arch), 2, "train"), 0))
    return cj, ct, tc, sj


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip(arch):
    """Every leaf of a trained port state (the time-mix's and the mamba
    heads' among them, their f32 moments) back bit for bit into a fresh
    state."""
    _, ct, _, sj = _trained_ref_state(arch)
    state = interop.state_from_numpy(ct, jax.tree.map(np.asarray, sj))
    with tempfile.TemporaryDirectory() as d:
        TCK.save(state, d, step=3)
        fresh, step = TCK.restore(TT.init_state(ct, TrainConfig(), 6, "cpu"),
                                  d)
    assert step == 3
    _assert_states_equal(fresh, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_restore_across_packages(arch):
    """A checkpoint the reference saved restores in the port bit for bit
    (against ``state_from_numpy`` of the same state, the optimizer's
    moments included), and one the port saved restores in the
    reference."""
    cj, ct, tc, sj = _trained_ref_state(arch)
    want = interop.state_from_numpy(ct, jax.tree.map(np.asarray, sj))
    with tempfile.TemporaryDirectory() as d:
        JCK.save(sj, d, step=1)
        got, step = TCK.restore(TT.init_state(ct, TrainConfig(), 9, "cpu"),
                                d)
        assert step == 1
        _assert_states_equal(got, want)
    with tempfile.TemporaryDirectory() as d:
        TCK.save(want, d, step=2)
        back, step = JCK.restore(JT.init_state(cj, tc, jax.random.key(4)),
                                 d)
        assert step == 2
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(sj)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains(arch):
    """``python -m repro_torch.launch.train --smoke --device cpu --dvfs``
    trains 2 steps (rwkv6-3b at 256 tokens: the chunked WKV) with finite
    losses and prints the DVFS report."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--smoke", "--device", "cpu", "--steps", "2", "--seq",
             str(_S(arch)), "--batch", "2", "--dvfs", "--ckpt-dir", d],
            env=env, cwd=d, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "[dvfs] simulated energy" in out.stdout
        last = [ln for ln in out.stdout.splitlines()
                if ln.startswith("final loss")]
        assert last and np.isfinite(float(last[0].split()[2]))
        assert TCK.latest_step(d) == 1
