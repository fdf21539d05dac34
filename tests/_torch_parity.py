"""Shared helpers of the port's parity tests (not collected: no ``test_``
prefix). Inputs are made from a seed with numpy and handed to both the
JAX reference (``repro``) and the port (``repro_torch``) as numpy arrays;
the port runs on the CPU, where every kernel wrapper takes its plain
version."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import power as JPWR
from repro.core import predictors as JPRED
from repro.core import simulate as JSIM
from repro.core.workloads import make_program as j_make_program
from repro_torch import interop
from repro_torch.core import power as TPWR

# the parity cases are tiny: torch's intra-op threads would only spin and
# take cores from the other test workers running beside this one
torch.set_num_threads(1)

# (family, fork_estimator, cu_model) covering every specialised mechanism
# shape: pcstall, accpc, stall-style, crisp, accreac
EPOCH_FAMS = [("pc", False, None), ("pc", True, None),
              ("reactive", False, "stall"), ("reactive", False, "crisp"),
              ("reactive", True, None)]


def np_(x) -> np.ndarray:
    """A JAX array or torch tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype)


def port_program(jprog):
    """The reference's program carried over bit-for-bit (cum3 included)."""
    return interop.program_from_numpy(
        jprog.name, np_(jprog.i0_rate), np_(jprog.sens_rate),
        np_(jprog.mem_frac), np_(jprog.cum3), device="cpu")


def jax_noise_for(jprog):
    """A stand-in for the port's ``simulate._epoch_noise`` that returns the
    reference's noise for the port's positions: the sin hash turns one
    ulp into O(1) noise, so the two packages' own hashes cannot be
    compared. The reference evaluated eagerly reproduces the noise its
    jitted scan computes."""
    def noise(pos, p_blocks, seed):
        ctx = JSIM._epoch_context(jprog, jnp.asarray(np_(pos)),
                                  jnp.int32(p_blocks), jnp.int32(seed))
        return t_(np_(ctx.eps))
    return noise


def _key_noise(xp, pos_i, p_blocks, n_cu, n_wf):
    """A noise of exact values in [-1, 1) keyed by (block, loop, wf, cu),
    from integer arithmetic only, so both packages compute the same bits."""
    blk = (pos_i // 4) % p_blocks
    loop = pos_i // (4 * p_blocks)
    wf = xp.arange(n_wf)[None, :]
    cu = xp.arange(n_cu)[:, None]
    key = (blk * 13 + loop * 7 + wf * 5 + cu * 3) % 32
    return key / 16.0 - 1.0


def lockstep_noise(monkeypatch):
    """Give both packages the same integer-keyed noise for the rest of the
    test: the reference's ``_epoch_context`` (looked up when its scan is
    traced) and the port's ``_epoch_noise``. Trace only executables that
    no other test shares while it is in place."""
    orig = JSIM._epoch_context

    def j_context(prog, pos, p_blocks, seed):
        ctx = orig(prog, pos, p_blocks, seed)
        eps = _key_noise(jnp, pos.astype(jnp.int32), p_blocks, *pos.shape)
        return ctx._replace(eps=eps.astype(jnp.float32))

    def t_noise(pos, p_blocks, seed):
        # pos may carry leading grid-row axes (p_blocks broadcasts)
        return _key_noise(torch, pos.to(torch.int32), p_blocks,
                          *pos.shape[-2:]).to(torch.float32)

    monkeypatch.setattr(JSIM, "_epoch_context", j_context)
    from repro_torch.core import simulate as TSIM
    monkeypatch.setattr(TSIM, "_epoch_noise", t_noise)


def epoch_case(family, CU, WF, *, seed=0, NF=10, T=3, E=16, tid=None,
               fork_estimator=False, cu_model=None, P=48):
    """One operand set for ``epoch_fused`` from a generated program plus
    randomised carry state, as (jax args, jax kwargs, port args, port
    kwargs) made from the same numpy arrays."""
    rng = np.random.default_rng(seed)
    jprog = j_make_program("kern", "mixed", seed % 17, P=P)
    sim = JSIM.SimConfig(n_cu=CU, n_wf=WF)
    ax = sim.axes()
    F = np_(JPWR.freqs_ghz(ax.power, NF))
    pos = rng.uniform(0, P * 4, (CU, WF)).astype(np.float32)
    eps = np_(JSIM._epoch_context(jprog, jnp.asarray(pos), jprog.n_blocks,
                                  sim.seed).eps)
    fprev = F[rng.integers(0, NF, CU)]
    eacc = rng.uniform(0, 5, CU).astype(np.float32)
    cum_t = np_(jprog.cum3).T.copy()
    lat = np_(JPWR.transition_latency_us(ax.epoch_us, ax.power))
    scal = dict(epoch_us=float(ax.epoch_us), sigma=float(ax.sigma),
                cap_per_ghz=float(ax.cap_per_ghz), membw=float(ax.membw),
                lat_us=float(lat))
    obj = np_(ax.obj)
    j_args = (jprog.i0_rate, jprog.sens_rate, jnp.asarray(cum_t),
              jnp.asarray(pos), jnp.asarray(F), jnp.asarray(eps),
              jnp.asarray(fprev), jnp.asarray(eacc), jnp.float32(3.0))
    t_args = (t_(np_(jprog.i0_rate)), t_(np_(jprog.sens_rate)), t_(cum_t),
              t_(pos), t_(F), t_(eps), t_(fprev), t_(eacc),
              torch.tensor(3.0))
    common = dict(p_blocks=jprog.n_blocks, family=family,
                  fork_estimator=fork_estimator, cu_model=cu_model, **scal)
    j_kw = dict(common, obj=jnp.asarray(obj), power=ax.power)
    t_kw = dict(common, obj=t_(obj),
                power=interop.power_axes_from_numpy(
                    np.stack([np_(getattr(ax.power, f))
                              for f in JPWR.PowerAxes._fields]), "cpu"))
    if family == "pc":
        tbl = (rng.uniform(0, 6, (T, E)).astype(np.float32),
               rng.uniform(0, 4, (T, E)).astype(np.float32),
               (rng.uniform(size=(T, E)) > 0.5).astype(np.float32))
        tid = np.asarray(tid if tid is not None else np.arange(CU) % T,
                         np.int32)
        wfi = rng.uniform(0, 6, (CU, WF)).astype(np.float32)
        wfs = rng.uniform(0, 4, (CU, WF)).astype(np.float32)
        j_kw.update(table=JPRED.PCTable(*map(jnp.asarray, tbl)),
                    tid=jnp.asarray(tid), wf_i0=jnp.asarray(wfi),
                    wf_sens=jnp.asarray(wfs))
        t_kw.update(table=interop.table_from_numpy(*tbl, device="cpu"),
                    tid=t_(tid, torch.int32), wf_i0=t_(wfi),
                    wf_sens=t_(wfs))
    else:
        ri0 = rng.uniform(0, 200, CU).astype(np.float32)
        rse = rng.uniform(0, 100, CU).astype(np.float32)
        j_kw.update(react_i0=jnp.asarray(ri0), react_sens=jnp.asarray(rse))
        t_kw.update(react_i0=t_(ri0), react_sens=t_(rse))
    return j_args, j_kw, t_args, t_kw


def fork_case(CU, WF, NF, seed):
    """A pc-family operand set of :func:`epoch_case` plus the reactive
    state group and the registry's id layout: the fork family's operands,
    for both packages."""
    from repro_torch.core import simulate as TSIM
    ja, jk, ta, tk = epoch_case("pc", CU, WF, NF=NF, seed=seed)
    rng = np.random.default_rng(seed + 77)
    ri0 = rng.uniform(0, 200, CU).astype(np.float32)
    rse = rng.uniform(0, 100, CU).astype(np.float32)
    layout = dict(react_models=TSIM._REACT_MODELS, pc_ids=TSIM._PC_IDS,
                  id_ctr_pc=TSIM._ID_CTR_PC)
    for kw, arr in ((jk, jnp.asarray), (tk, t_)):
        kw.update(family="fork", react_i0=arr(ri0), react_sens=arr(rse),
                  **layout)
        del kw["fork_estimator"], kw["cu_model"]
    return ja, jk, ta, tk


def epoch_fields(out):
    """An ``EpochOut`` of either package as {name: numpy array}."""
    res = {}
    for name in out._fields:
        v = getattr(out, name)
        if v is None:
            continue
        if name == "table":
            for k in ("i0", "sens", "count"):
                res[f"table.{k}"] = np_(getattr(v, k))
        else:
            res[name] = np_(v)
    return res


def assert_epoch_close(got: dict, want: dict, *, rtol, atol, what=""):
    """Discrete outputs equal, floats within (rtol, atol)."""
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    for k in want:
        if np.issubdtype(want[k].dtype, np.integer):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=atol, err_msg=f"{what} {k}")


def port_power(pw) -> TPWR.PowerConfig:
    """The port's ``PowerConfig`` with the reference config's fields."""
    return TPWR.PowerConfig(**{f: getattr(pw, f)
                               for f in pw.__dataclass_fields__})
