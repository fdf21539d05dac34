"""Fine-grain DVFS simulation engine (port of ``repro.core.simulate``).

One loop iteration = one fixed-time epoch (paper §3.1):

  1. fork--pre-execute oracle: the epoch is evaluated at every V/f state
     from identical starting conditions (the per-epoch noise is keyed by
     (block, loop-iteration, wavefront), so forks see the same noise);
  2. the mechanism predicts next-epoch instructions I(f);
  3. the controller picks the per-domain frequency minimising the
     objective;
  4. the epoch is executed at the chosen mixed per-CU frequencies;
  5. estimators digest the epoch's counters and update predictor state.

Ground truth: a wavefront at PC block b commits ``(i0 + sens*f)*T``
instructions (window-averaged over the blocks traversed), subject to
oldest-first issue contention within the CU and a shared L2/DRAM
bandwidth cap across CUs.

Engines (``SimConfig.use_pallas``, routed as the reference routes it):
``True``/``"v2"`` runs the fused epoch kernel (``kernels.epoch_fused``) for
every v2-capable mechanism; ``"v1"`` runs the PC-table kernel pair
(``kernels.pc_table``) for pc mechanisms; ``False`` runs the unfused
body below. Static frequencies, the oracle and custom hooks always run the
unfused body. The port defaults to ``True``. On a CUDA program the kernels
launch; on a CPU program their plain versions run.

Two loops drive the epoch step, and neither syncs with the host: per-epoch
outputs go into preallocated tensors and the logical-epoch mask is applied
once after the loop.

* :func:`_scan_sim` runs one simulation with a concrete mechanism
  (``run_sim``).
* :func:`_scan_rows` steps R independent rows together, the batched sweep's
  counterpart of the reference's ``vmap`` over (workload x grid point x
  seed and grid point. The builtin fork mechanisms share one step in which
  the mechanism is a per-row traced id (``FORK_MECHS``): on the fused
  kernel engine that step is one ``epoch_fused_rows`` call for all rows;
  otherwise, and for the specialised families (statics, the oracle, custom
  hooks), the one-row body is mapped over the rows with
  ``torch.func.vmap``, so custom hooks see per-row views.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import (DeviceLike, any_id, clamp_blocks, clip, prog_len,
                         resolve_device, select_id)
from repro_torch.core import estimators as EST
from repro_torch.core import mechanisms as MECH
from repro_torch.core import power as PWR
from repro_torch.core import predictors as PRED
from repro_torch.core.mechanisms import MechanismSpec
from repro_torch.core.workloads import INSTR_PER_BLOCK, Program

MECHANISMS = MECH.BUILTIN_NAMES

# Mechanisms that run the fork--pre-execute step, in traced-id order: the
# batched sweep steps them as one family indexed by a per-row traced id
# (the carry is shape-identical across all of them). The oracle predicts
# from this epoch's forks and gets its own specialised step.
FORK_MECHS = tuple(s.name for s in MECH.fork_specs())
FORK_MECH_IDS = {m: i for i, m in enumerate(FORK_MECHS)}
# traced ids 0.._N_REACT-1 predict from CU-level reactive state (the
# registry asserts contiguity: the branch select is one `mech < n` compare)
_N_REACT = MECH.traced_reactive_count()
_REACT_SPECS = tuple(s for s in MECH.fork_specs()
                     if s.is_traced and s.family == "reactive")
_PC_IDS = tuple(s.traced_id for s in MECH.fork_specs()
                if s.is_traced and s.family == "pc")
# the one traced PC mechanism estimating from hardware counters (pcstall);
# the other (accpc) takes the exact per-WF linear model from the forks
_ID_CTR_PC = next(s.traced_id for s in MECH.fork_specs()
                  if s.is_traced and s.family == "pc"
                  and not s.fork_estimator)
# the traced step builds its reactive-estimator select in this order:
# counter models at ids 0..n-2, the fork-accurate reactive (accreac) last
assert all(s.cu_model for s in _REACT_SPECS[:-1]) and \
    _REACT_SPECS[-1].fork_estimator, _REACT_SPECS
# the counter models of the traced reactive ids, in id order
_REACT_MODELS = tuple(s.cu_model for s in _REACT_SPECS
                      if not s.fork_estimator)
# the shared traced-id step can run the fused epoch kernel only if every
# mechanism it multiplexes is v2-capable (all builtin traced mechanisms
# are)
_FORK_V2_CAPABLE = all(s.v2_capable for s in MECH.fork_specs()
                       if s.is_traced)

_F32 = torch.float32


@dataclass(frozen=True)
class SimStatic:
    """Shape/flag half of ``SimConfig``: everything that changes array
    shapes or the loop's structure. Build with ``SimConfig.static_part()``."""
    n_cu: int
    n_wf: int
    n_epochs: int
    entries: int
    offset_blocks: int
    cus_per_table: int
    cus_per_domain: int
    record_wf: bool
    # False (unfused body), "v1" (PC-table kernel pair), "v2" (the fused
    # epoch kernel), True = v2 where the mechanism permits, else v1
    use_pallas: Union[bool, str]
    # the reference's CU tiling of the fork family's fused epoch (None =
    # untiled): checked as the reference checks it, and otherwise inert,
    # since the port's kernels pick their own CTA width on the card
    pallas_block_cu: Optional[int]
    power: PWR.PowerStatic


class SimAxes(NamedTuple):
    """The sweepable scalars of one grid point as 0-dim tensors on the
    simulation's device (``obj`` is the (3,) lowered objective, ``n_ep``
    the logical epoch count, ``power`` the regime)."""
    epoch_us: torch.Tensor
    sigma: torch.Tensor
    cap_per_ghz: torch.Tensor
    membw: torch.Tensor
    table_ema: torch.Tensor
    obj: torch.Tensor
    n_ep: torch.Tensor
    power: PWR.PowerAxes


assert SimAxes._fields == MECH.SIM_AXES_FIELDS, \
    (SimAxes._fields, MECH.SIM_AXES_FIELDS)


def objective_weights(objective: str) -> np.ndarray:
    """Lower an objective name to ``[pbar_weight, use_rate, cap_frac]``:

      cost = (P_dom + pbar_weight * Pbar) / where(use_rate, I_sum, 1)
             + BIG * (I_sum < cap_frac * I_sum[fmax])

    EDP/ED^2P weight the online average power by the delay exponent and
    divide by the rate; ``perfcap<pct>`` minimises power under a rate
    floor; ``deadline<pct>`` adds the average-power term to it."""
    if objective == "edp":
        return np.asarray([1.0, 1.0, 0.0], np.float32)
    if objective == "ed2p":
        return np.asarray([2.0, 1.0, 0.0], np.float32)
    if objective.startswith("perfcap"):
        capf = 1.0 - float(objective[-2:]) / 100.0
        return np.asarray([0.0, 0.0, capf], np.float32)
    if objective.startswith("deadline"):
        pct = objective[len("deadline"):]
        if len(pct) != 2 or not pct.isdigit():
            raise ValueError(objective)
        capf = 1.0 - float(pct) / 100.0
        return np.asarray([1.0, 0.0, capf], np.float32)
    raise ValueError(objective)


@dataclass(frozen=True)
class SimConfig:
    n_cu: int = 64
    n_wf: int = 40
    epoch_us: float = 1.0
    n_epochs: int = 1500
    entries: int = 128
    offset_blocks: int = 8        # blocks/entry: 128 entries cover 1024 blocks
    cus_per_table: int = 1
    cus_per_domain: int = 1
    objective: str = "ed2p"       # 'edp'|'ed2p'|'perfcap<pct>'|'deadline<pct>'
    sigma: float = 0.06           # same-PC iteration noise (Fig 10 ~10%)
    cap_per_ghz: float = 5500.0   # CU issue capacity, instr/us per GHz
    membw: float = 160_000.0      # shared-path capacity, instr-traffic/us
    table_ema: float = 0.5
    record_wf: bool = False
    # False | True | "v1" | "v2": see SimStatic; the port runs its kernels
    # by default
    use_pallas: Union[bool, str] = True
    # the reference's fork-family CU tile (None = untiled): see SimStatic
    pallas_block_cu: Optional[int] = None
    power: PWR.PowerConfig = PWR.DEFAULT
    seed: int = 0

    def static_part(self, n_epochs: Optional[int] = None) -> SimStatic:
        return SimStatic(
            n_cu=self.n_cu, n_wf=self.n_wf,
            n_epochs=self.n_epochs if n_epochs is None else n_epochs,
            entries=self.entries, offset_blocks=self.offset_blocks,
            cus_per_table=self.cus_per_table,
            cus_per_domain=self.cus_per_domain,
            record_wf=self.record_wf, use_pallas=self.use_pallas,
            pallas_block_cu=self.pallas_block_cu,
            power=self.power.static_part())

    def axes(self, device: DeviceLike = "cuda") -> SimAxes:
        """The grid point as tensors on ``device`` (logical epochs =
        ``n_epochs``)."""
        dev = resolve_device(device)

        def full(x, dtype=_F32):
            return torch.full((), x, dtype=dtype, device=dev)

        return SimAxes(
            epoch_us=full(self.epoch_us), sigma=full(self.sigma),
            cap_per_ghz=full(self.cap_per_ghz), membw=full(self.membw),
            table_ema=full(self.table_ema),
            obj=torch.as_tensor(objective_weights(self.objective)).to(dev),
            n_ep=full(self.n_epochs, torch.int32),
            power=self.power.axes(dev))


class Carry(NamedTuple):
    pos: torch.Tensor         # (CU,WF) absolute instruction index
    react_i0: torch.Tensor    # (CU,) reactive CU-level state
    react_sens: torch.Tensor
    wf_i0: torch.Tensor       # (CU,WF) per-WF fallback state
    wf_sens: torch.Tensor
    table: PRED.PCTable
    f_prev: torch.Tensor      # (CU,)
    e_acc: torch.Tensor       # (CU,) accumulated energy (for online Pbar)
    t_acc: torch.Tensor       # () accumulated time


class EpochCtx(NamedTuple):
    """Frequency-independent per-epoch state shared by every frequency
    row of the batched execute."""
    blk: torch.Tensor    # (CU,WF) starting PC block (int64)
    i0_l: torch.Tensor   # (CU,WF) local i0 rate at blk
    s_l: torch.Tensor    # (CU,WF) local sens rate at blk
    eps: torch.Tensor    # (CU,WF) (block,loop,wf,cu)-keyed noise
    cum3: torch.Tensor   # (2P+1,3) packed (cum_i0, cum_sens, cum_mem)
    cum_lo: torch.Tensor  # (CU,WF,3) cum3 gathered at blk


BlockCount = Union[int, torch.Tensor]


class ProgArrays(NamedTuple):
    """The program arrays an epoch reads (a ``Program`` without its name),
    as a tuple ``torch.func.vmap`` can map over."""
    i0_rate: torch.Tensor    # (P,)
    sens_rate: torch.Tensor  # (P,)
    cum3: torch.Tensor       # (2P+1, 3)


def _start_block(pos: torch.Tensor, p_blocks: BlockCount) -> torch.Tensor:
    return torch.remainder(
        torch.div(pos.to(torch.int32), INSTR_PER_BLOCK,
                  rounding_mode="floor"), p_blocks).long()


def _seed_phase(seed):
    """The noise hash's seed phase: the int32 ``seed`` as two exactly
    representable halves folded into one f32 (seeds below 65536 add an
    exact +0 high term). A Python int gives a float, a tensor a tensor of
    the same f32 bits."""
    if isinstance(seed, torch.Tensor):
        return (torch.remainder(seed, 65536).to(_F32) * 3.7
                + torch.div(seed, 65536, rounding_mode="floor").to(_F32)
                * 2.2867257)                       # 3.7 * golden ratio
    s_lo = np.float32(seed % 65536)
    s_hi = np.float32(seed // 65536)
    # repro: waive[REPRO001] the Python-int seed of a one-row run
    return float(s_lo * np.float32(3.7) + s_hi * np.float32(2.2867257))


def _epoch_noise(pos: torch.Tensor, p_blocks: BlockCount, seed
                 ) -> torch.Tensor:
    """The deterministic (block, loop, wf, cu, seed)-keyed noise in
    [-1, 1): ``frac(sin(x) * 43758.5453)`` of a linear key. Identical for
    every fork and for the executed row (the paper's fork property).

    ``pos`` is (..., CU, WF); ``p_blocks`` and the int32 ``seed`` are ints
    or tensors broadcasting against it (one per row of a batch). Every op
    is elementwise, so a row's noise has the same bits alone or in a
    batch. The hash amplifies one ulp of its argument into O(1) noise, so
    its bits depend on the device's ``sin``."""
    blk = _start_block(pos, p_blocks)
    loop = torch.div(pos, INSTR_PER_BLOCK * p_blocks, rounding_mode="floor")
    wf_id = torch.arange(pos.shape[-1], dtype=_F32, device=pos.device)[None]
    cu_id = torch.arange(pos.shape[-2], dtype=_F32,
                         device=pos.device)[:, None]
    h = torch.sin(blk * 12.9898 + loop * 78.233 + wf_id * 37.719
                  + cu_id * 9.131 + _seed_phase(seed)) * 43758.5453
    return (h - torch.floor(h)) * 2.0 - 1.0


def _epoch_context(prog, pos: torch.Tensor, p_blocks: BlockCount,
                   seed) -> EpochCtx:
    """``prog`` is a ``Program`` or :class:`ProgArrays`."""
    blk = _start_block(pos, p_blocks)
    cum3 = prog.cum3
    return EpochCtx(blk=blk, i0_l=prog.i0_rate[blk], s_l=prog.sens_rate[blk],
                    eps=_epoch_noise(pos, p_blocks, seed), cum3=cum3,
                    cum_lo=cum3[blk])


class _SteadyParts(NamedTuple):
    """Steady-state execute intermediates for a ``(..., CU)`` batch of
    frequency rows; fork rows consume only ``steady``."""
    steady: torch.Tensor
    alloc: torch.Tensor
    demand: torch.Tensor
    i0w: torch.Tensor
    sw: torch.Tensor
    mfw: torch.Tensor


def _steady_parts(ctx: EpochCtx, pos: torch.Tensor, f_cu: torch.Tensor,
                  p_blocks: BlockCount, ax: SimAxes) -> _SteadyParts:
    """Steady-state committed instructions at frequency rows ``f_cu`` of
    shape ``(..., CU)``; all outputs carry the batch shape."""
    T = ax.epoch_us
    f_b = f_cu[..., :, None]                                  # (...,CU,1)
    est_instr = (ctx.i0_l + ctx.s_l * f_b) * T
    nblk = clamp_blocks((est_instr / INSTR_PER_BLOCK).to(torch.int32) + 1,
                         p_blocks).long()
    wavg = (ctx.cum3[ctx.blk + nblk] - ctx.cum_lo) / nblk[..., None]
    i0w, sw, mfw = wavg[..., 0], wavg[..., 1], wavg[..., 2]
    demand = (i0w + sw * f_b) * T
    demand = demand * (1.0 + ax.sigma * ctx.eps)
    # oldest-first issue allocation (slot index = age priority)
    C = ax.cap_per_ghz * f_cu * T
    before = torch.cumsum(demand, -1) - demand
    alloc = clip(C[..., :, None] - before, 0.0, demand)
    # shared L2/DRAM bandwidth coupling across all CUs, summed per CU and
    # then over CUs: short reductions whose order on the GPU does not
    # depend on how many rows a batch holds (one 2560-long reduction per
    # row is split across warps only when the batch has few rows)
    traffic = (alloc * mfw).sum(-1).sum(-1)
    scale = torch.clamp(ax.membw * T / torch.clamp(traffic, min=1e-6),
                        max=1.0)
    steady = alloc * (1.0 - mfw * (1.0 - scale[..., None, None]))
    return _SteadyParts(steady, alloc, demand, i0w, sw, mfw)


def _row_counters(parts: _SteadyParts, pos: torch.Tensor,
                  f_cu: torch.Tensor, p_blocks: BlockCount
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Complete one frequency row into the hardware-counter view, with the
    workgroup barrier at each kernel-loop boundary (waves wait for the
    slowest wave of their CU before the next iteration)."""
    f_b = f_cu[..., :, None]
    q = parts.alloc / torch.clamp(parts.demand, min=1e-6)
    plen = prog_len(p_blocks, INSTR_PER_BLOCK)
    tentative = pos + parts.steady
    group_min = tentative.amin(-1)                              # slowest
    boundary = (torch.floor(group_min / plen) + 1.0) * plen     # (...,CU)
    committed = torch.minimum(
        parts.steady, torch.clamp(boundary[..., :, None] - pos, min=0.0))
    core_frac = parts.sw * f_b / torch.clamp(parts.i0w + parts.sw * f_b,
                                             min=1e-6)
    counters = {"committed": committed, "steady": parts.steady,
                "core_frac": core_frac, "issue_q": q, "mem_frac": parts.mfw}
    return committed, counters


def _execute_ctx(ctx: EpochCtx, pos: torch.Tensor, f_cu: torch.Tensor,
                 p_blocks: BlockCount, ax: SimAxes
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full execute of ``f_cu`` rows of shape ``(..., CU)``."""
    parts = _steady_parts(ctx, pos, f_cu, p_blocks, ax)
    return _row_counters(parts, pos, f_cu, p_blocks)


def epoch_execute(prog: Program, pos: torch.Tensor, f_cu: torch.Tensor,
                  sim: SimConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ground-truth execution of one epoch at per-CU frequencies ``f_cu``
    (on ``pos``'s device). Deterministic in (pos, f): the fork property."""
    ax = sim.axes(pos.device)
    ctx = _epoch_context(prog, pos, prog.n_blocks, int(seed_i32(sim.seed)))
    committed, counters = _execute_ctx(ctx, pos, f_cu, prog.n_blocks, ax)
    return committed, dict(counters, start_block=ctx.blk)


def _predict_instr(i0_cu, sens_cu, st: SimStatic, ax: SimAxes):
    """(CU,) linear state -> capacity-clipped predicted I at every ladder
    frequency."""
    F = PWR.freqs_ghz(ax.power, st.power.n_freqs)
    I = (i0_cu[:, None] + sens_cu[:, None] * F[None, :]) * ax.epoch_us
    cap = ax.cap_per_ghz * F[None, :] * ax.epoch_us * st.n_wf
    return clip(I, 0.0, cap)


# public alias for MechanismSpec.predict hooks
predict_instr = _predict_instr


def _select_freq(I_pred_f: torch.Tensor, st: SimStatic, ax: SimAxes,
                 pbar_dom: torch.Tensor) -> torch.Tensor:
    """Per-domain frequency minimising ``(P + w*Pbar) / rate`` (the online
    Lagrangian of ED^nP) plus the perf-cap penalty; ties take the lowest
    index. I_pred_f: (CU, n_freqs); pbar_dom: (n_dom,). Returns the
    selected index (CU,)."""
    F = PWR.freqs_ghz(ax.power, st.power.n_freqs)
    n_dom = st.n_cu // st.cus_per_domain
    I_dom = I_pred_f.reshape(n_dom, st.cus_per_domain, -1)
    act = I_pred_f / (ax.cap_per_ghz * F[None, :] * ax.epoch_us * st.n_wf)
    p_cu = PWR.power(F[None, :], act, ax.power)             # (CU,NF)
    P_dom = p_cu.reshape(n_dom, st.cus_per_domain, -1).sum(1)
    I_sum = torch.clamp(I_dom.sum(1), min=1e-3)
    w_pbar, use_rate, capf = ax.obj[0], ax.obj[1], ax.obj[2]
    denom = torch.where(use_rate > 0.0, I_sum, 1.0)
    infeasible = I_sum < capf * I_sum[:, -1:]
    cost = (P_dom + w_pbar * pbar_dom[:, None]) / denom + 1e9 * infeasible
    idx_dom = torch.argmin(cost, dim=-1)
    # repeat each domain's choice over its CUs (an expand: no host sync)
    return idx_dom[:, None].expand(n_dom, st.cus_per_domain).reshape(-1)


def _true_wf_linear(c_f: torch.Tensor, F: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """c_f: (NF, CU, WF) fork-committed at ladder ``F`` -> exact per-WF
    (i0_rate, sens)."""
    sens = (c_f[-1] - c_f[0]) / (F[-1] - F[0])
    i0 = c_f[0] - sens * F[0]
    return i0, sens


def init_carry(p_blocks: BlockCount, st: SimStatic,
               device: DeviceLike = "cuda") -> Carry:
    """The loop-initial state for a ``p_blocks``-block program. An (R,)
    tensor of block counts gives R rows' states stacked on a leading axis
    (each row's bits those of its one-row state)."""
    dev = resolve_device(device)
    n_tables = max(st.n_cu // st.cus_per_table, 1)
    rows = ()
    plen = prog_len(p_blocks, INSTR_PER_BLOCK)
    if isinstance(p_blocks, torch.Tensor):
        rows = tuple(p_blocks.shape)
        plen = plen.to(dev).reshape(rows + (1, 1))
    cu_off = torch.remainder(
        torch.arange(st.n_cu, dtype=_F32, device=dev)[:, None] * 97.0, plen)
    wf_off = torch.arange(st.n_wf, dtype=_F32, device=dev)[None, :] * 1.0
    pos0 = torch.remainder(cu_off + wf_off, plen)

    def full(shape, x):
        return torch.full(rows + shape, x, dtype=_F32, device=dev)

    tbl = PRED.table_init(n_tables, st.entries, dev)
    return Carry(
        pos=pos0,
        react_i0=full((st.n_cu,), 50.0),
        react_sens=full((st.n_cu,), 30.0),
        wf_i0=full((st.n_cu, st.n_wf), 1.2),
        wf_sens=full((st.n_cu, st.n_wf), 0.8),
        table=PRED.PCTable(*(t.expand(rows + t.shape).contiguous()
                             for t in tbl)),
        # F_STATIC of the default ladder: one initial transition per CU off
        # it, like hardware coming out of a fixed boot frequency
        f_prev=full((st.n_cu,), 1.7),
        # warm-start Pbar near the static-1.7 operating point
        e_acc=full((st.n_cu,), 0.42 * 20.0),
        t_acc=full((), 20.0),
    )


def _engines(st: SimStatic, spec: MechanismSpec) -> Tuple[bool, bool]:
    """(fused epoch kernel, PC-table kernel pair) for this mechanism, as
    the reference routes ``use_pallas``."""
    mode = st.use_pallas
    assert mode in (False, True, "v1", "v2"), \
        f"use_pallas must be False|True|'v1'|'v2', got {mode!r}"
    v2 = (mode in (True, "v2") and not st.record_wf and spec.is_traced
          and spec.v2_capable)
    v1 = (not v2 and mode in (True, "v1", "v2")
          and spec.family != "static" and spec.predict is None
          and st.n_cu % st.cus_per_table == 0)
    return v2, v1


def _make_body(st: SimStatic, spec: Optional[MechanismSpec],
               tid: torch.Tensor, use_v1: bool = False):
    """The unfused epoch ``body(carry, prog, p_blocks, seed, ax, F, lat_us,
    mech) -> (carry, ys)`` of one simulation: ``prog`` a ``Program`` or
    :class:`ProgArrays`, ``p_blocks``/``seed`` ints or 0-dim tensors, ``F``
    the ladder and ``lat_us`` the transition dead time of ``ax``'s power
    regime. ``spec`` None is the traced-id mode: ``mech`` is a 0-dim id
    into ``FORK_MECHS``, both predictors and every estimator are evaluated
    and the id selects, the table and per-WF state update only for the pc
    ids, and ``hit_rate`` is emitted for every id. The body is a pure
    tensor function, so ``torch.func.vmap`` maps it over rows."""
    NF = st.power.n_freqs
    CU = st.n_cu
    n_dom = CU // st.cus_per_domain
    n_tables = max(CU // st.cus_per_table, 1)
    traced = spec is None
    if traced:
        is_static_f = is_custom = is_pc = is_react = is_oracle = False
    else:
        is_static_f = spec.family == "static"
        is_custom = spec.predict is not None
        is_pc = spec.family == "pc" and not is_custom
        is_react = spec.family == "reactive" and not is_custom
        is_oracle = spec.family == "oracle"
    tid32 = tid.to(torch.int32)
    if use_v1:
        from repro_torch.kernels import pc_table as KPT

    def _pc_lookup(carry, idx_lu, F, ax):
        """Table lookup + CU reduce + I(f) + capacity clip."""
        if use_v1:
            # one launch: the kernel reads the int64 slots and the scalars
            # on the card, and writes the hit mask from the counts it reads
            I_pc, hit = KPT.pc_table_predict(
                carry.table.i0, carry.table.sens, carry.table.count, tid32,
                idx_lu, carry.wf_i0, carry.wf_sens, F,
                epoch_us=ax.epoch_us, cap_per_ghz=ax.cap_per_ghz,
                return_hit=True)
        else:
            i0t, s_t, hit = PRED.table_lookup(carry.table, tid, idx_lu,
                                              carry.wf_i0, carry.wf_sens)
            I_pc = _predict_instr(i0t.sum(-1), s_t.sum(-1), st, ax)
        return I_pc, hit

    def _table_update(carry, idx_lu, i0_wf, s_wf, ax):
        if use_v1:
            shp = (n_tables, st.cus_per_table * st.n_wf)
            i0n, sn, cn = KPT.pc_table_update(
                carry.table.i0, carry.table.sens, carry.table.count,
                idx_lu.reshape(shp), i0_wf.reshape(shp),
                s_wf.reshape(shp), ema=ax.table_ema)
            return PRED.PCTable(i0n, sn, cn)
        return PRED.table_update(carry.table, tid, idx_lu, i0_wf, s_wf,
                                 ax.table_ema)

    def body(carry: Carry, prog, p_blocks, seed, ax: SimAxes, F, lat_us,
             mech):
        T = ax.epoch_us
        pos = carry.pos
        dev = pos.device
        F_rows = F[:, None].expand(NF, CU)
        ctx = _epoch_context(prog, pos, p_blocks, seed)
        hit_rate = None
        c_f = I_f = I_pred_f = idx_lu = None
        if is_static_f:
            fidx = torch.full((CU,), spec.static_fidx, dtype=torch.int64,
                              device=dev)
            f_sel = F[fidx]
            committed, ctr = _execute_ctx(ctx, pos, f_sel, p_blocks, ax)
        else:
            idx_lu = PRED.table_index(ctx.blk, st.entries, st.offset_blocks)
            # custom pc-family specs keep the standard table machinery
            if traced or is_pc or (is_custom and spec.family == "pc"):
                I_pc, hit = _pc_lookup(carry, idx_lu, F, ax)
                hit_rate = hit.sum() / hit.numel()
            if traced or is_react:
                I_react = _predict_instr(carry.react_i0, carry.react_sens,
                                         st, ax)
            if is_custom:
                I_hook = spec.predict(carry, ctx, st, ax)
            pbar = (carry.e_acc / torch.clamp(carry.t_acc, min=1e-3)) \
                .reshape(n_dom, st.cus_per_domain).sum(1)
            if is_oracle:
                # the oracle's prediction IS this epoch's forks
                c_f = _steady_parts(ctx, pos, F_rows, p_blocks, ax).steady
                I_f = c_f.sum(-1).T
                I_pred_f = I_f
                fidx = _select_freq(I_pred_f, st, ax, pbar)
                f_sel = F[fidx]
                committed, ctr = _execute_ctx(ctx, pos, f_sel, p_blocks, ax)
            else:
                # fused fork--pre-execute: the NF uniform fork rows and the
                # chosen mixed row run as one (NF+1)-row batched execute
                if traced:
                    I_pred_f = torch.where(mech < _N_REACT, I_react, I_pc)
                else:
                    I_pred_f = I_hook if is_custom else \
                        (I_pc if is_pc else I_react)
                fidx = _select_freq(I_pred_f, st, ax, pbar)
                f_all = torch.cat([F_rows, F[fidx][None]], 0)
                parts = _steady_parts(ctx, pos, f_all, p_blocks, ax)
                c_f = parts.steady[:NF]                     # (NF,CU,WF)
                sel_parts = _SteadyParts(*(x[NF] for x in parts))
                committed, ctr = _row_counters(sel_parts, pos, f_all[NF],
                                               p_blocks)
                f_sel = f_all[NF]
                I_f = c_f.sum(-1).T                         # (CU,NF)

        # --- transition overhead + counter views --------------------------
        trans = f_sel != carry.f_prev
        committed = committed * (1.0 - lat_us / T * trans[:, None])
        I_actual = ctr["steady"].sum(-1)                 # counter view
        work_actual = committed.sum(-1)                  # real progress
        # --- accuracy of the prediction for THIS epoch --------------------
        if I_pred_f is not None:
            I_at_sel = torch.gather(I_pred_f, 1, fidx[:, None])[:, 0]
            err = torch.abs(I_at_sel - I_actual) \
                / torch.clamp(I_actual, min=1e-3)
        else:
            err = torch.zeros((CU,), dtype=_F32, device=dev)
        # --- energy --------------------------------------------------------
        act = work_actual / (ax.cap_per_ghz * f_sel * T * st.n_wf)
        energy = PWR.power(f_sel, act, ax.power) * T \
            + PWR.transition_energy(carry.f_prev, f_sel, ax.power) * trans
        # --- estimation + state update -------------------------------------
        new = carry._replace(pos=pos + committed, f_prev=f_sel,
                             e_acc=carry.e_acc + energy,
                             t_acc=carry.t_acc + T)
        est_ctrs = dict(ctr, committed=ctr["steady"])
        if traced:
            # every estimator, selected on the traced id (counter models at
            # ids 0..n-2, the fork-accurate reactive last)
            cu_ests = [EST.cu_estimate(est_ctrs, f_sel, m)
                       for m in _REACT_MODELS]
            sens_ar = (I_f[:, -1] - I_f[:, 0]) / ((F[-1] - F[0]) * T)
            i0_ar = I_f[:, 0] / T - sens_ar * F[0]
            r_i0 = select_id(mech, [e[0] / T for e in cu_ests] + [i0_ar],
                              carry.react_i0)
            r_se = select_id(mech, [e[1] / T for e in cu_ests] + [sens_ar],
                              carry.react_sens)
            i0_est, s_est = EST.wf_stall_estimate(est_ctrs, f_sel)
            i0_tr, s_tr = _true_wf_linear(c_f, F)
            i0_wf = torch.where(mech == _ID_CTR_PC, i0_est, i0_tr) / T
            s_wf = torch.where(mech == _ID_CTR_PC, s_est, s_tr) / T
            tbl_u = _table_update(carry, idx_lu, i0_wf, s_wf, ax)
            pc_now = any_id(mech, _PC_IDS)
            new = new._replace(
                react_i0=r_i0, react_sens=r_se,
                table=PRED.PCTable(*(torch.where(pc_now, a, b) for a, b
                                     in zip(tbl_u, carry.table))),
                wf_i0=torch.where(pc_now, i0_wf, carry.wf_i0),
                wf_sens=torch.where(pc_now, s_wf, carry.wf_sens))
        elif is_custom:
            if spec.family == "pc":
                # standard counter-driven table maintenance, so a custom
                # pc predictor reads a live table
                i0_wf, s_wf = EST.wf_stall_estimate(est_ctrs, f_sel)
                i0_wf, s_wf = i0_wf / T, s_wf / T
                tbl = _table_update(carry, idx_lu, i0_wf, s_wf, ax)
                new = new._replace(table=tbl, wf_i0=i0_wf, wf_sens=s_wf)
            if spec.update is not None:
                upd = spec.update(est_ctrs, f_sel, I_f, carry, ctx, st, ax)
                if upd is not None:
                    new = new._replace(react_i0=upd[0], react_sens=upd[1])
        elif is_react and not spec.fork_estimator:
            i0_cu, s_cu = EST.cu_estimate(est_ctrs, f_sel, spec.cu_model)
            new = new._replace(react_i0=i0_cu / T, react_sens=s_cu / T)
        elif is_react:  # fork-accurate reactive: exact linear from forks
            sens_cu = (I_f[:, -1] - I_f[:, 0]) / ((F[-1] - F[0]) * T)
            i0_cu = I_f[:, 0] / T - sens_cu * F[0]
            new = new._replace(react_i0=i0_cu, react_sens=sens_cu)
        elif is_pc:
            if not spec.fork_estimator:  # counter-driven (pcstall)
                i0_wf, s_wf = EST.wf_stall_estimate(est_ctrs, f_sel)
            else:  # exact per-WF linear model from the forks (accpc)
                i0_wf, s_wf = _true_wf_linear(c_f, F)
            i0_wf, s_wf = i0_wf / T, s_wf / T
            tbl = _table_update(carry, idx_lu, i0_wf, s_wf, ax)
            new = new._replace(table=tbl, wf_i0=i0_wf, wf_sens=s_wf)
        if is_static_f:
            true_sens_cu = torch.zeros((CU,), dtype=_F32, device=dev)
        else:
            true_sens_cu = (I_f[:, -1] - I_f[:, 0]) / ((F[-1] - F[0]) * T)
        ys = {"work": work_actual, "energy": energy, "err": err,
              "fidx": fidx, "true_sens": true_sens_cu}
        # the traced mode emits the hit rate for every id (the sweep keeps
        # it per spec on unpack)
        if hit_rate is not None and (traced or spec.hit_telemetry):
            ys["hit_rate"] = hit_rate
        if st.record_wf and not is_static_f:
            ys["wf_sens"] = (c_f[-1] - c_f[0]) / (F[-1] - F[0])
            ys["wf_blk"] = ctx.blk.to(torch.int32)
        return new, ys

    return body


def _make_step(prog: Program, p_blocks: int, seed: int, st: SimStatic,
               ax: SimAxes, mech: Union[str, MechanismSpec]):
    """The epoch step ``carry -> (carry, ys)`` for one concrete mechanism
    (a registered name or a ``MechanismSpec``), with the engine chosen by
    ``st.use_pallas``; ``ys`` maps each output channel to this epoch's
    tensor."""
    spec = MECH.resolve(mech)
    dev = prog.device
    NF = st.power.n_freqs
    F = PWR.freqs_ghz(ax.power, NF)
    T = ax.epoch_us
    CU = st.n_cu
    lat_us = PWR.transition_latency_us(ax.epoch_us, ax.power)
    tid = torch.div(torch.arange(CU, device=dev), st.cus_per_table,
                    rounding_mode="floor")
    assert spec.static_fidx is None or spec.static_fidx < NF, \
        f"{spec.name}: static_fidx {spec.static_fidx} is off the " \
        f"{NF}-state ladder of this power regime"
    use_v2, use_v1 = _engines(st, spec)
    if not use_v2:
        body = _make_body(st, spec, tid, use_v1)
        return lambda carry: body(carry, prog, p_blocks, seed, ax, F,
                                  lat_us, None)
    from repro_torch.kernels import epoch_fused as KEF
    cum_t = prog.cum3.T.contiguous()
    tid32 = tid.to(torch.int32)

    def body_v2(carry: Carry):
        # the whole epoch is ONE kernel; only the sin-hash noise is computed
        # outside (see kernels.epoch_fused)
        eps = _epoch_noise(carry.pos, p_blocks, seed)
        out = KEF.epoch_fused(
            prog.i0_rate, prog.sens_rate, cum_t, carry.pos, F, eps,
            carry.f_prev, carry.e_acc, carry.t_acc,
            p_blocks=p_blocks, epoch_us=T, sigma=ax.sigma,
            cap_per_ghz=ax.cap_per_ghz, membw=ax.membw, obj=ax.obj,
            lat_us=lat_us, power=ax.power,
            cus_per_domain=st.cus_per_domain,
            table=carry.table, tid=tid32, wf_i0=carry.wf_i0,
            wf_sens=carry.wf_sens,
            table_ema=ax.table_ema if spec.family == "pc" else 0.0,
            offset_blocks=st.offset_blocks,
            react_i0=carry.react_i0, react_sens=carry.react_sens,
            family=spec.family, fork_estimator=spec.fork_estimator,
            cu_model=spec.cu_model)
        new = carry._replace(pos=out.pos, f_prev=out.f_sel,
                             e_acc=out.e_acc, t_acc=out.t_acc[0])
        if spec.family == "pc":
            new = new._replace(table=out.table, wf_i0=out.wf_i0,
                               wf_sens=out.wf_sens)
        else:
            new = new._replace(react_i0=out.react_i0,
                               react_sens=out.react_sens)
        ys = {"work": out.work, "energy": out.energy, "err": out.err,
              "fidx": out.fidx, "true_sens": out.true_sens}
        if spec.family == "pc" and spec.hit_telemetry:
            ys["hit_rate"] = out.hit_rate[0]
        return new, ys

    return body_v2


def _run_loop(step, carry, n_epochs: int, n_ep: torch.Tensor,
              dev: torch.device) -> Dict[str, torch.Tensor]:
    """``n_epochs`` steps from ``carry`` into preallocated (n_epochs, ...)
    buffers; epochs at index >= ``n_ep`` (a scalar, or one per leading row
    of the outputs) are zeroed afterwards. No host sync."""
    bufs: Dict[str, torch.Tensor] = {}
    for ep in range(n_epochs):
        carry, ys = step(carry)
        if not bufs:
            bufs = {k: torch.empty((n_epochs,) + tuple(v.shape),
                                   dtype=torch.int8 if k == "fidx"
                                   else v.dtype, device=dev)
                    for k, v in ys.items()}
        for k, v in ys.items():
            bufs[k][ep].copy_(v)
    # logical-epoch mask: epochs past n_ep report zeros (the loop is
    # causal, so live epochs are unaffected)
    live = torch.arange(n_epochs, device=dev).reshape(
        (-1,) + (1,) * n_ep.dim()) < n_ep
    return {k: torch.where(
        live.reshape(live.shape + (1,) * (v.dim() - live.dim())), v,
        torch.zeros((), dtype=v.dtype, device=dev)) for k, v in bufs.items()}


def _scan_sim(prog: Program, p_blocks: int, seed: int, st: SimStatic,
              ax: SimAxes, mech: Union[str, MechanismSpec],
              carry0: Optional[Carry] = None) -> Dict[str, torch.Tensor]:
    """The simulation loop: ``st.n_epochs`` epochs of :func:`_make_step`
    on the program's device, from ``carry0`` (default ``init_carry``).
    Epochs at index >= ``ax.n_ep`` are zeroed in every output channel.
    Returns per-epoch tensors on the device."""
    dev = prog.device
    step = _make_step(prog, p_blocks, seed, st, ax, mech)
    carry = init_carry(p_blocks, st, dev) if carry0 is None else carry0
    return _run_loop(step, carry, st.n_epochs, ax.n_ep, dev)


def _fork_kernel_engine(st: SimStatic) -> bool:
    """Whether the traced-id family steps on the fused epoch kernel."""
    assert st.use_pallas in (False, True, "v1", "v2"), \
        f"use_pallas must be False|True|'v1'|'v2', got {st.use_pallas!r}"
    return (st.use_pallas in (True, "v2") and not st.record_wf
            and _FORK_V2_CAPABLE)


def _scan_rows(progs: ProgArrays, prog_idx: torch.Tensor,
               p_blocks: torch.Tensor, seeds: torch.Tensor, st: SimStatic,
               ax: SimAxes, mech: Optional[Union[str, MechanismSpec]],
               mech_ids: Optional[torch.Tensor], carry0: Carry
               ) -> Dict[str, torch.Tensor]:
    """Step R independent simulation rows together for ``st.n_epochs``
    epochs (the batched sweep's counterpart of the reference's ``vmap``).

    ``progs`` stacks W programs padded to a common block count (leading
    axis W); row r runs program ``prog_idx[r]`` with logical block count
    ``p_blocks[r]``, noise seed ``seeds[r]`` (int32) and the grid point
    whose ``SimAxes`` leaves carry a leading row axis (``ax.n_ep`` (R,) is
    each row's logical epoch count). ``mech`` None is the traced fork
    family with per-row ids ``mech_ids`` (R,); otherwise every row runs
    the concrete mechanism ``mech``. ``carry0`` has a leading row axis
    (``init_carry`` of the (R,) block counts).

    Engine: the traced family on the fused kernel engine (``use_pallas``
    True/"v2") is ONE ``epoch_fused_rows`` call per epoch, a single kernel
    launch on the card; every other case maps the one-row unfused body
    over the rows with ``torch.func.vmap``. Returns {channel: (R, n_epochs,
    ...)} on the device, zeroed past each row's logical epochs."""
    dev = carry0.pos.device
    NF = st.power.n_freqs
    spec = None if mech is None else MECH.resolve(mech)
    if spec is not None:
        assert spec.static_fidx is None or spec.static_fidx < NF, \
            f"{spec.name}: static_fidx {spec.static_fidx} is off the " \
            f"{NF}-state ladder of this power regime"
    F = torch.func.vmap(lambda pw: PWR.freqs_ghz(pw, NF))(ax.power)
    lat_us = PWR.transition_latency_us(ax.epoch_us, ax.power)
    tid = torch.div(torch.arange(st.n_cu, device=dev), st.cus_per_table,
                    rounding_mode="floor")
    if spec is None and _fork_kernel_engine(st):
        step = _fork_rows_step(progs, prog_idx, p_blocks, seeds, st, ax, F,
                               lat_us, mech_ids, tid)
    else:
        body = _make_body(st, spec, tid)
        rows_prog = ProgArrays(*(a.index_select(0, prog_idx) for a in progs))
        vbody = torch.func.vmap(body, in_dims=(0, 0, 0, 0, 0, 0, 0,
                                               None if spec else 0))
        ids = mech_ids if spec is None else None

        def step(carry):
            return vbody(carry, rows_prog, p_blocks, seeds, ax, F, lat_us,
                         ids)
    ys = _run_loop(step, carry0, st.n_epochs, ax.n_ep, dev)
    return {k: v.movedim(0, 1) for k, v in ys.items()}


def _fork_rows_step(progs: ProgArrays, prog_idx, p_blocks, seeds,
                    st: SimStatic, ax: SimAxes, F, lat_us, mech_ids, tid):
    """The traced family's step on the fused kernel engine: the sin-hash
    noise of every row, then one ``epoch_fused_rows`` call."""
    from repro_torch.kernels import epoch_fused as KEF
    cum_t = progs.cum3.transpose(1, 2).contiguous()
    scal = torch.stack([ax.epoch_us, ax.sigma, ax.cap_per_ghz, ax.membw,
                        ax.table_ema, ax.obj[:, 0], ax.obj[:, 1],
                        ax.obj[:, 2], lat_us], -1).contiguous()
    pw = torch.stack(list(ax.power), -1).contiguous()
    pidx = prog_idx.to(torch.int32).contiguous()
    pb = p_blocks.to(torch.int32).contiguous()
    ids = mech_ids.to(torch.int32).contiguous()
    pb_b = pb[:, None, None]
    seed_b = seeds[:, None, None]
    tid32 = tid.to(torch.int32)

    def step(carry: Carry):
        eps = _epoch_noise(carry.pos, pb_b, seed_b)
        out = KEF.epoch_fused_rows(
            progs.i0_rate, progs.sens_rate, cum_t, pidx, carry.pos, F, eps,
            carry.f_prev, carry.e_acc, carry.t_acc, p_blocks=pb, mech=ids,
            scal=scal, power=pw, table=carry.table, tid=tid32,
            wf_i0=carry.wf_i0, wf_sens=carry.wf_sens,
            react_i0=carry.react_i0, react_sens=carry.react_sens,
            cus_per_domain=st.cus_per_domain,
            offset_blocks=st.offset_blocks, react_models=_REACT_MODELS,
            pc_ids=_PC_IDS, id_ctr_pc=_ID_CTR_PC,
            block_cu=st.pallas_block_cu)
        new = Carry(pos=out.pos, react_i0=out.react_i0,
                    react_sens=out.react_sens, wf_i0=out.wf_i0,
                    wf_sens=out.wf_sens, table=out.table, f_prev=out.f_sel,
                    e_acc=out.e_acc, t_acc=out.t_acc)
        ys = {"work": out.work, "energy": out.energy, "err": out.err,
              "fidx": out.fidx, "true_sens": out.true_sens,
              "hit_rate": out.hit_rate}
        return new, ys

    return step


def seed_i32(seeds) -> np.ndarray:
    """Fold integer seeds of any width into int32 by keeping the low 32
    bits (two's complement)."""
    scalar = np.ndim(seeds) == 0
    vals = [seeds] if scalar else list(seeds)
    folded = np.asarray([int(s) & 0xFFFFFFFF for s in vals],
                        np.uint32).astype(np.int32)
    return folded[0] if scalar else folded


def run_sim(prog: Program, sim: SimConfig,
            mechanism: Union[str, MechanismSpec]) -> Dict[str, np.ndarray]:
    """Simulate ``mechanism`` (a registered name or a ``MechanismSpec``)
    on ``prog``, on the program's device. Returns per-epoch traces as
    numpy arrays (one device-to-host copy, after the loop)."""
    spec = MECH.resolve(mechanism)
    assert sim.n_cu % sim.cus_per_domain == 0
    dev = prog.device
    ys = _scan_sim(prog, prog.n_blocks, int(seed_i32(sim.seed)),
                   sim.static_part(), sim.axes(dev), spec)
    return {k: v.cpu().numpy() for k, v in ys.items()}


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def prediction_accuracy(trace: Dict[str, np.ndarray],
                        warmup: int = 50) -> float:
    err = trace["err"][warmup:]
    return float(np.clip(1.0 - np.mean(np.clip(err, 0, 1)), 0.0, 1.0))


def ednp(trace: Dict[str, np.ndarray], work_budget: float, epoch_us: float,
         n: int = 2) -> Tuple[float, float, float]:
    """(E, D, E*D^n) to complete ``work_budget`` total instructions."""
    cum_work = np.cumsum(trace["work"].sum(-1))
    cum_energy = np.cumsum(trace["energy"].sum(-1))
    if cum_work[-1] < work_budget:  # extrapolate at terminal rate
        rate = trace["work"].sum(-1)[-200:].mean() / epoch_us
        p_rate = trace["energy"].sum(-1)[-200:].mean() / epoch_us
        extra_t = (work_budget - cum_work[-1]) / rate
        D = len(cum_work) * epoch_us + extra_t
        E = cum_energy[-1] + p_rate * extra_t
    else:
        i = int(np.searchsorted(cum_work, work_budget))
        frac = ((work_budget - (cum_work[i - 1] if i else 0.0))
                / max(cum_work[i] - (cum_work[i - 1] if i else 0.0), 1e-9))
        D = (i + frac) * epoch_us
        E = (cum_energy[i - 1] if i else 0.0) + frac * (
            cum_energy[i] - (cum_energy[i - 1] if i else 0.0))
    return E, D, E * D ** n


def run_workload(prog: Program, sim: SimConfig, mechanisms=MECHANISMS,
                 n: int = 2, baseline: Union[str, MechanismSpec] = "static17"
                 ) -> Dict[str, Dict[str, float]]:
    """Run a mechanism suite; ED^nP normalized to ``baseline`` (default
    the paper's static 1.7 GHz)."""
    base_spec = MECH.resolve(baseline)
    base = run_sim(prog, sim, base_spec)
    budget = 0.9 * base["work"].sum()
    out: Dict[str, Dict[str, float]] = {}
    E0, D0, M0 = ednp(base, budget, sim.epoch_us, n)
    for mech in mechanisms:
        spec = MECH.resolve(mech)
        tr = base if spec.name == base_spec.name else run_sim(prog, sim, spec)
        E, D, M = ednp(tr, budget, sim.epoch_us, n)
        out[spec.name] = {
            "accuracy": prediction_accuracy(tr)
            if spec.family != "static" else float("nan"),
            "E": E, "D": D, "ednp": M, "ednp_norm": M / M0,
            "energy_norm": E / E0, "delay_norm": D / D0,
        }
    return out
