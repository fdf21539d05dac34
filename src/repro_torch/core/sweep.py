"""Batched sweep layer (port of ``repro.core.sweep``): ONE dispatch path for
every sweep, from a single ``run_suite`` call to a whole figure grid.

The paper's figures sweep mechanisms x workloads x epoch granularities x
objectives through the fork--pre-execute engine. This layer

  1. pads every ``Program`` to a common block count (``pad_program`` keeps
     the wrapped prefix-sum window semantics exact: the doubled prefix sums
     of the *logical* program, then a flat tail) and stacks them; each row
     carries its logical block count;
  2. stacks whole grid points (``SimAxes``: epoch_us, sigma, capacity,
     bandwidth, EMA, lowered objective, logical epoch count, power regime)
     and cartesian-products them with the workloads into a flat
     (workload x grid-point) axis. Points with fewer logical epochs run to
     the grid max and mask the tail;
  3. steps seeds and, within the fork family, mechanisms as further rows:
     every traced fork mechanism (``simulate.FORK_MECHS``) shares one
     batched step indexed by a per-row traced id, while the oracle, the
     static frequencies and registered custom mechanisms step their own
     specialised body (``simulate._scan_rows``). On the fused kernel engine
     (``SimConfig.use_pallas`` True/"v2", the port's default) the fork
     family is ONE kernel launch per epoch for all its rows;
  4. deduplicates every mechanism across grid points by its spec's declared
     live axes (``MechanismSpec.exec_axes``): points agreeing on a
     mechanism's live axes form one class and share one row, broadcast back
     to every member grid key (statics ignore objective and table_ema;
     reactive mechanisms and the oracle ignore table_ema; the power regime
     is live for everyone). ``DISPATCH_ROWS`` counts the logical rows
     dispatched per family, as the reference counts them.

``run_suite`` IS a one-point ``run_grid``, so every consumer dispatches
through the same batched steps. Inside the port, suite, grid, per-point
grid and ``GridExecutor`` rows are bitwise equal to each other: a row's
arithmetic never depends on which rows share its batch (the kernel sums
each row's values in fixed orders, whatever its CTAs; the unfused body's
reductions are short enough that their order does not change with the
batch size).

Differences from the reference, all of them consequences of running on
one card in eager PyTorch:

* no ``shard_map`` and no device mesh: one card is the identity layout,
  so there is no device-multiple padding and ``GridExecutor`` takes
  ``n_dev`` 1 only;
* no buffer donation (``donate_argnums``): the initial carry is built per
  dispatch and released when the loop drops it;
* ``TRACE_COUNTS`` counts builds of a family's batched step, one per
  (``SimStatic``, family) key, cached like the reference's executables.

``run_grid(dedup=True)`` refuses an under-declared spec before any
dispatch, as the reference does: the axis-liveness auditor
(``repro_torch.analysis.deps.require_dedup_sound``, on the engine the
grid runs) raises ``AxisLivenessError`` naming the axis (``dedup=False``
runs it).

``GridExecutor.dispatch`` never synchronises with the host: operands go to
the card from pinned memory on the current stream, and
``PendingGrid.traces()`` is the only synchronisation.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import threading
from typing import (Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import mechanisms as MECH
from repro_torch.core import power as PWR
from repro_torch.core import simulate as SIM
from repro_torch.core.mechanisms import MechanismSpec
from repro_torch.core.simulate import (MECHANISMS, SimConfig, SimStatic, ednp,
                                       prediction_accuracy)
from repro_torch.core.workloads import Program

# the SimAxes fields a static-frequency mechanism depends on (its declared
# exec_axes minus the logical epoch count); the dedup is generic over every
# spec's axes
STATIC_EXEC_AXES = MECH.get("static17").dedup_axes

# SimConfig fields that may vary across a grid (they map onto SimAxes);
# n_epochs is the *logical* epoch count of a point. ``power`` values are
# whole ``PowerConfig`` regimes sharing one ladder length.
AXIS_FIELDS = ("epoch_us", "sigma", "cap_per_ghz", "membw", "table_ema",
               "objective", "n_epochs", "power")

# batched-step builds, keyed by family ("grid_forks", "grid_oracle",
# "grid_static17", ...): one per (SimStatic, family)
TRACE_COUNTS: collections.Counter = collections.Counter()

# logical (workload x grid-point x mechanism) rows dispatched per family,
# on every dispatch
DISPATCH_ROWS: collections.Counter = collections.Counter()

# every mutation of the two counters takes this lock (dispatches may come
# from several threads); snapshot reads need none
_COUNTER_LOCK = threading.Lock()


def reset_counters() -> None:
    """Zero ``TRACE_COUNTS`` and ``DISPATCH_ROWS`` atomically."""
    with _COUNTER_LOCK:
        TRACE_COUNTS.clear()
        DISPATCH_ROWS.clear()


def pad_program(prog: Program, p_max: int) -> Program:
    """Pad ``prog``'s arrays to ``p_max`` blocks without changing semantics.

    The per-block arrays are zero-padded (never gathered past the logical
    length). The doubled prefix sums keep the *logical* program's
    ``2 P + 1`` entries, so indices up to ``2 P`` (the widest window the
    execute requests) still see the wrap-around copy, and continue flat:
    bit for bit the prefix sums of the doubled program followed by zeros,
    which is how the reference rebuilds them. No arithmetic runs, so the
    pad has the same bits on every device."""
    P = prog.n_blocks
    if P == p_max:
        return prog
    assert P < p_max, (P, p_max)
    dev = prog.device
    pad1 = torch.zeros((p_max - P,), dtype=torch.float32, device=dev)

    def arr(a):
        return torch.cat([a, pad1])

    cum3 = torch.cat([prog.cum3, prog.cum3[-1:].expand(2 * (p_max - P), 3)])
    return Program(prog.name, arr(prog.i0_rate), arr(prog.sens_rate),
                   arr(prog.mem_frac), cum3)


def _stack_programs(progs: Sequence[Program], p_max: Optional[int] = None
                    ) -> Tuple[Program, np.ndarray]:
    """Pad to a common block count (``p_max``, default the longest) and
    stack into one batched Program (leading workload axis); returns it
    plus the logical block counts."""
    p_max = max(p.n_blocks for p in progs) if p_max is None else p_max
    p_logical = np.asarray([p.n_blocks for p in progs], np.int32)
    padded = [pad_program(p, p_max) for p in progs]
    stacked = Program(
        "suite",
        *(torch.stack([getattr(p, f) for p in padded])
          for f in ("i0_rate", "sens_rate", "mem_frac", "cum3")))
    return stacked, p_logical


def _grid_points(axes_grid) -> Tuple[Tuple[str, ...], List[dict]]:
    """Normalize ``axes_grid`` into (axis names, list of override dicts).

    Dict-of-lists => cartesian product of the values; list-of-dicts =>
    explicit points (coupled axes). Points must share the same axis set;
    their key order is normalized to the first point's."""
    if isinstance(axes_grid, dict):
        names = tuple(axes_grid)
        for n, vals in axes_grid.items():
            assert isinstance(vals, (list, tuple)), \
                f"axis {n!r} needs a list of values, got {vals!r}"
        points = [dict(zip(names, combo))
                  for combo in itertools.product(*axes_grid.values())]
        assert points, "axes_grid needs at least one point"
    else:
        points = [dict(p) for p in axes_grid]
        assert points, "axes_grid needs at least one point"
        names = tuple(points[0])
        for p in points:
            assert set(p) == set(names), \
                f"grid points must share axes: {sorted(p)} vs {sorted(names)}"
        points = [{n: p[n] for n in names} for p in points]
    for p in points:
        for k in p:
            assert k in AXIS_FIELDS, \
                f"{k!r} is not a traced grid axis (one of {AXIS_FIELDS})"
            if k == "power":
                assert isinstance(p[k], PWR.PowerConfig), \
                    f"power axis values must be PowerConfig, got {p[k]!r}"
    return names, points


class _FlatOps(NamedTuple):
    """Host-side layout of one dispatch: the stacked programs (on the
    device), and per flat (workload x grid-point) entry its program index,
    logical block count and grid point; ``n_logical`` counts the entries
    that are not bucket padding."""
    progs: Program
    prog_idx: np.ndarray
    p_log: np.ndarray
    sims: List[SimConfig]
    n_logical: int


def _flat_operands(stacked: Program, p_logical: np.ndarray,
                   sims: Sequence[SimConfig]) -> _FlatOps:
    """Flatten workload-major (flat index i = w * G + g for G points)."""
    W, G = len(p_logical), len(sims)
    prog_idx = np.repeat(np.arange(W, dtype=np.int32), G)
    return _FlatOps(stacked, prog_idx, np.repeat(p_logical, G),
                    [s for _ in range(W) for s in sims], W * G)


# the f32 columns of one row's grid point, in SimAxes order (obj is 3 wide,
# the power regime 11)
_N_AXF = 5 + 3 + len(PWR.PowerAxes._fields)


def _axes_row(s: SimConfig) -> np.ndarray:
    return np.concatenate([
        np.asarray([s.epoch_us, s.sigma, s.cap_per_ghz, s.membw,
                    s.table_ema], np.float32),
        SIM.objective_weights(s.objective),
        np.asarray([getattr(s.power, f) for f in PWR.PowerAxes._fields],
                   np.float32)])


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to the card from pinned memory without
    blocking the host (no synchronisation)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


@functools.lru_cache(maxsize=None)
def _grid_step(st: SimStatic, mechanism: Optional[MechanismSpec]):
    """The batched step of one family (``mechanism`` None: the traced fork
    family), built once per (SimStatic, family)."""
    family = "grid_forks" if mechanism is None else f"grid_{mechanism.name}"
    with _COUNTER_LOCK:
        TRACE_COUNTS[family] += 1

    def run(progs, prog_idx, p_blocks, seeds, ax, mech_ids, carry0):
        return SIM._scan_rows(SIM.ProgArrays(progs.i0_rate, progs.sens_rate,
                                             progs.cum3),
                              prog_idx, p_blocks, seeds, st, ax, mechanism,
                              mech_ids, carry0)
    return run


def _run_family(st: SimStatic, mechanism: Optional[MechanismSpec],
                ops: _FlatOps, seeds: np.ndarray, mech_ids: np.ndarray
                ) -> Dict[str, torch.Tensor]:
    """Dispatch one family over the flat entries x seeds (x traced ids).
    Returns device tensors of shape (n_flat, S, [M,] n_epochs, ...)."""
    family = "grid_forks" if mechanism is None else f"grid_{mechanism.name}"
    n, S = len(ops.sims), len(seeds)
    M = max(len(mech_ids), 1)
    with _COUNTER_LOCK:
        DISPATCH_ROWS[family] += ops.n_logical * M
    dev = ops.progs.device
    # rows in (flat entry, seed, mechanism) order
    flat = np.repeat(np.arange(n), S * M)
    s_i = np.tile(np.repeat(np.arange(S), M), n)
    m_i = np.tile(np.arange(M), n * S)
    axf = np.stack([_axes_row(s) for s in ops.sims])[flat]
    ints = np.stack([ops.prog_idx[flat], ops.p_log[flat], seeds[s_i],
                     mech_ids[m_i] if len(mech_ids) else np.zeros_like(flat),
                     np.asarray([s.n_epochs for s in ops.sims])[flat]],
                    -1).astype(np.int32)
    axf_d, ints_d = _to_device(axf, dev), _to_device(ints, dev)
    prog_idx, p_blocks, seed_r, ids, n_ep = ints_d.unbind(-1)
    cols = axf_d.unbind(-1)
    ax = SIM.SimAxes(epoch_us=cols[0], sigma=cols[1], cap_per_ghz=cols[2],
                     membw=cols[3], table_ema=cols[4],
                     obj=axf_d[:, 5:8], n_ep=n_ep,
                     power=PWR.PowerAxes(*cols[8:]))
    carry0 = SIM.init_carry(p_blocks, st, dev)
    ys = _grid_step(st, mechanism)(
        ops.progs, prog_idx.long(), p_blocks, seed_r, ax,
        ids if mechanism is None else None, carry0)
    lead = (n, S, M) if mechanism is None else (n, S)
    return {k: v.reshape(lead + tuple(v.shape[1:])) for k, v in ys.items()}


def _unpack_trace(arrs: Dict[str, np.ndarray], i: int, spec: MechanismSpec,
                  squeeze_seed: bool,
                  n_ep: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Cut flat entry ``i`` of a family's host arrays down to the
    ``run_sim`` trace schema: squeeze the seed axis when it was implicit,
    slice the epoch axis to the logical count, and drop the ``hit_rate``
    channel for specs that do not declare it."""
    ep = slice(None) if n_ep is None else slice(None, n_ep)
    tr = {k: np.array(v[i, 0, ep] if squeeze_seed else v[i, :, ep])
          for k, v in arrs.items()}
    if not spec.hit_telemetry:
        tr.pop("hit_rate", None)
    return tr


def _host(ys: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy per channel."""
    return {k: v.cpu().numpy() for k, v in ys.items()}


def _exec_classes(sims: Sequence[SimConfig], dedup_axes: Tuple[str, ...]
                  ) -> Tuple[List[int], List[SimConfig]]:
    """Partition grid points into classes of a mechanism's live axes:
    ``class_of[g]`` is point g's class, ``class_sims[c]`` the class
    representative with the class-max logical epoch count (each member's
    trace is a prefix of it: the loop is causal)."""
    class_of: List[int] = []
    class_sims: List[SimConfig] = []
    index: Dict[tuple, int] = {}
    for s in sims:
        ck = tuple(getattr(s, a) for a in dedup_axes)
        c = index.setdefault(ck, len(class_sims))
        if c == len(class_sims):
            class_sims.append(s)
        elif s.n_epochs > class_sims[c].n_epochs:
            class_sims[c] = s
        class_of.append(c)
    return class_of, class_sims


def _programs(programs) -> Tuple[List[str], List[Program]]:
    if isinstance(programs, dict):
        names = list(programs)
        return names, [programs[n] for n in names]
    progs = list(programs)
    return [p.name for p in progs], progs


def run_suite(programs: Union[Dict[str, Program], Sequence[Program]],
              sim: SimConfig,
              mechanisms: Sequence[Union[str, MechanismSpec]] = MECHANISMS,
              seeds: Optional[Sequence[int]] = None
              ) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """Batched counterpart of ``run_sim`` in nested loops: a one-point
    ``run_grid``. Returns ``{workload: {mechanism: trace}}``; with
    ``seeds`` every trace array gains a leading seed axis."""
    return run_grid(programs, sim, [{}], mechanisms, seeds)[()]


def run_grid(programs: Union[Dict[str, Program], Sequence[Program]],
             static_cfg: SimConfig, axes_grid,
             mechanisms: Sequence[Union[str, MechanismSpec]] = MECHANISMS,
             seeds: Optional[Sequence[int]] = None,
             max_mask_ratio: Optional[float] = None,
             dedup: bool = True
             ) -> Dict[tuple, Dict[str, Dict[str, Dict[str, np.ndarray]]]]:
    """One batched dispatch family for a whole figure grid, on the
    programs' device (all programs on one device).

    ``axes_grid`` is a dict ``{axis: [values...]}`` (cartesian product) or
    a list of ``{axis: value}`` points (coupled axes); axes are
    ``AXIS_FIELDS``. ``static_cfg`` supplies the static fields and the
    default of every axis not in the grid. ``mechanisms`` are registered
    names or specs; results are keyed by spec name. Every mechanism is
    deduplicated across points by its spec's live axes (``dedup=False``
    forces one row per mechanism x point). ``max_mask_ratio`` splits
    points whose logical ``n_epochs`` differ by more than that ratio into
    separate dispatches.

    Returns ``{grid_key: {workload: {mechanism: trace}}}`` where
    ``grid_key`` is the tuple of the point's axis values in axis order and
    each trace has the ``run_sim`` schema (seed axis squeezed unless
    ``seeds`` is given, epoch axis cut to the point's ``n_epochs``)."""
    names_w, progs = _programs(programs)
    assert progs, "run_grid needs at least one program"
    devs = {p.device for p in progs}
    assert len(devs) == 1, f"programs on several devices: {devs}"
    specs = [MECH.resolve(m) for m in mechanisms]
    if dedup:
        # refuse under-declared specs before any dispatch: the dedup
        # broadcasts one row across every point agreeing on a spec's
        # declared axes (the audit is cached per spec and engine)
        from repro_torch.analysis.deps import require_dedup_sound
        for s in specs:
            require_dedup_sound(s, static_cfg)
    assert static_cfg.n_cu % static_cfg.cus_per_domain == 0
    axis_names, points = _grid_points(axes_grid)
    keys = [tuple(p[n] for n in axis_names) for p in points]
    assert len(set(keys)) == len(keys), "duplicate grid points"

    if max_mask_ratio is not None and len(points) > 1:
        assert max_mask_ratio >= 1.0, max_mask_ratio
        buckets: List[List[dict]] = []
        for p in sorted(points, reverse=True,
                        key=lambda p: p.get("n_epochs", static_cfg.n_epochs)):
            n_ep = p.get("n_epochs", static_cfg.n_epochs)
            b_max = buckets[-1][0].get("n_epochs", static_cfg.n_epochs) \
                if buckets else None
            if buckets and b_max / n_ep <= max_mask_ratio:
                buckets[-1].append(p)
            else:
                buckets.append([p])
        if len(buckets) > 1:
            out: Dict[tuple, Dict] = {}
            for bucket in buckets:
                out.update(run_grid(programs, static_cfg, bucket,
                                    mechanisms, seeds, dedup=dedup))
            return {k: out[k] for k in keys}

    squeeze_seed = seeds is None
    seed_arr = SIM.seed_i32([static_cfg.seed] if seeds is None
                            else list(seeds))
    stacked, p_logical = _stack_programs(progs)
    G = len(points)
    sims = [dataclasses.replace(static_cfg, **p) for p in points]
    n_ep_max = max(s.n_epochs for s in sims)
    # the ladder length is the one static field a power regime carries
    pstats = {s.power.static_part() for s in sims}
    assert len(pstats) == 1, \
        f"power grid values must share one ladder length, got {pstats}"
    st = sims[0].static_part(n_epochs=n_ep_max)
    full_ops = _flat_operands(stacked, p_logical, sims)

    def classes_of(spec: MechanismSpec):
        if not dedup:
            return list(range(G)), sims
        return _exec_classes(sims, spec.dedup_axes)

    ops_cache: Dict[tuple, _FlatOps] = {}

    def class_operands(class_of, class_sims) -> _FlatOps:
        """The full-grid operands for a trivial partition, else the class
        representatives' (memoized per partition)."""
        if len(class_sims) == G:
            return full_ops
        key = tuple(class_of)
        if key not in ops_cache:
            ops_cache[key] = _flat_operands(stacked, p_logical, class_sims)
        return ops_cache[key]

    # name -> (host arrays, class_of, n_classes)
    by_mech: Dict[str, Tuple[Dict[str, np.ndarray], List[int], int]] = {}
    no_ids = np.zeros((0,), np.int32)

    # traced mechanisms sharing the partition their live axes induce ride
    # one dispatch (a grid with no dead axis: the whole family at once)
    groups: Dict[tuple, List[MechanismSpec]] = {}
    group_classes: Dict[tuple, Tuple[List[int], List[SimConfig]]] = {}
    for s in specs:
        if s.is_traced:
            class_of, class_sims = classes_of(s)
            gk = tuple(class_of)
            groups.setdefault(gk, []).append(s)
            group_classes[gk] = (class_of, class_sims)
    for gk, group in groups.items():
        class_of, class_sims = group_classes[gk]
        ids = np.asarray([SIM.FORK_MECH_IDS[s.name] for s in group],
                         np.int32)
        ys = _host(_run_family(st, None, class_operands(class_of,
                                                        class_sims),
                               seed_arr, ids))
        for j, s in enumerate(group):
            by_mech[s.name] = ({k: v[:, :, j] for k, v in ys.items()},
                               class_of, len(class_sims))

    # specialised families: statics, the oracle, custom mechanisms
    for s in specs:
        if s.is_traced:
            continue
        class_of, class_sims = classes_of(s)
        ys = _host(_run_family(st, s, class_operands(class_of, class_sims),
                               seed_arr, no_ids))
        by_mech[s.name] = (ys, class_of, len(class_sims))

    out: Dict[tuple, Dict[str, Dict[str, Dict[str, np.ndarray]]]] = {}
    for g, (key, sim_pt) in enumerate(zip(keys, sims)):
        out[key] = {}
        for w, name in enumerate(names_w):
            trs = {}
            for s in specs:
                arrs, class_of, C = by_mech[s.name]
                trs[s.name] = _unpack_trace(arrs, w * C + class_of[g], s,
                                            squeeze_seed,
                                            n_ep=sim_pt.n_epochs)
            out[key][name] = trs
    return out


# ---------------------------------------------------------------------------
# GridExecutor — the long-lived handle for request streams
# ---------------------------------------------------------------------------


class PendingGrid:
    """The in-flight result of one :class:`GridExecutor` micro-batch: the
    families' device tensors plus the row bookkeeping to cut them into
    per-job traces. Nothing here synchronises until ``block_until_ready``
    or ``traces``."""

    def __init__(self, rows, n_jobs: int, done: Optional[torch.cuda.Event]):
        # rows: per job, {mech_name: (family arrays, flat_row, spec, n_ep)}
        self._rows = rows
        self.n_jobs = n_jobs
        self._done = done

    def block_until_ready(self) -> "PendingGrid":
        if self._done is not None:
            self._done.synchronize()
        return self

    def traces(self) -> List[Dict[str, Dict[str, np.ndarray]]]:
        """Per-job ``{mechanism: trace}`` results (numpy; synchronises)."""
        host: Dict[int, Dict[str, np.ndarray]] = {}
        out = []
        for job in self._rows:
            trs = {}
            for m, (arrs, i, spec, n_ep) in job.items():
                if id(arrs) not in host:
                    host[id(arrs)] = _host(arrs)
                trs[m] = _unpack_trace(host[id(arrs)], i, spec, True, n_ep)
            out.append(trs)
        return out


class GridExecutor:
    """A reusable handle on the batched steps for one static configuration:
    the object a long-lived DVFS service holds between requests.

    It pins the static half (``SimStatic``, the padded block count
    ``p_max``, the mechanism set, the seed) and a small set of micro-batch
    sizes (``buckets``). ``dispatch`` pads each job list to the smallest
    admitting bucket by cycling jobs (pad rows are dropped on unpack) and
    runs the same batched steps ``run_grid`` runs, so streamed rows are
    bitwise equal to the one-shot grid answer for the same jobs.
    ``buckets=None`` dispatches each batch at its exact size. Every
    dispatch is floored at 2 rows, as in the reference. One card: ``n_dev``
    must be None or 1.

    Dispatch is asynchronous on the current CUDA stream and never
    synchronises; the returned :class:`PendingGrid` does so on
    ``traces()``."""

    def __init__(self, static_cfg: SimConfig,
                 mechanisms: Sequence[Union[str, MechanismSpec]] = MECHANISMS,
                 *, p_max: int = 1024,
                 buckets: Optional[Sequence[int]] = None,
                 n_dev: Optional[int] = None):
        if n_dev not in (None, 1):
            raise ValueError(f"GridExecutor runs on one card; n_dev={n_dev} "
                             "(no multi-device sharding in the port)")
        self.static_cfg = static_cfg
        self.specs = [MECH.resolve(m) for m in mechanisms]
        assert self.specs, "GridExecutor needs at least one mechanism"
        self.p_max = p_max
        self.buckets = None if buckets is None else tuple(sorted(buckets))
        assert self.buckets is None or all(b >= 1 for b in self.buckets)
        self.n_dev = 1
        self._st = static_cfg.static_part()
        self._seeds = SIM.seed_i32([static_cfg.seed])
        self._traced = [s for s in self.specs if s.is_traced]
        self._special = [s for s in self.specs if not s.is_traced]
        self._fork_ids = np.asarray(
            [SIM.FORK_MECH_IDS[s.name] for s in self._traced], np.int32)

    @property
    def max_batch(self) -> Optional[int]:
        """Largest micro-batch one dispatch admits (None = unbounded)."""
        return None if self.buckets is None else self.buckets[-1]

    def _bucket(self, n: int) -> int:
        if self.buckets is None:
            return n
        for b in self.buckets:
            if b >= n:
                return b
        raise AssertionError(
            f"micro-batch of {n} jobs exceeds the largest static shape "
            f"bucket {self.buckets[-1]} — split the batch or widen buckets")

    def dispatch(self, jobs: Sequence[Tuple[Program, dict]]) -> PendingGrid:
        """Dispatch one micro-batch of ``(Program, axes_overrides)`` jobs:
        each job is one flat entry with its program (padded to ``p_max``)
        and its own grid point (the executor's config plus the overrides,
        any ``AXIS_FIELDS`` subset; ``n_epochs`` at most the executor's).
        Asynchronous: returns a :class:`PendingGrid` at once."""
        n = len(jobs)
        assert n >= 1, "dispatch needs at least one job"
        bucket = max(self._bucket(n), 2)
        padded = [jobs[i % n] for i in range(bucket)]
        sims = []
        for prog, ov in padded:
            for k in ov:
                assert k in AXIS_FIELDS, \
                    f"{k!r} is not a traced grid axis (one of {AXIS_FIELDS})"
            s = dataclasses.replace(self.static_cfg, **dict(ov))
            assert s.n_epochs <= self._st.n_epochs, \
                f"job n_epochs {s.n_epochs} exceeds the executor's static " \
                f"scan length {self._st.n_epochs}"
            assert s.static_part(n_epochs=self._st.n_epochs) == self._st, \
                "job overrides must not change the executor's static half " \
                f"(got {s.static_part(n_epochs=self._st.n_epochs)})"
            assert prog.n_blocks <= self.p_max, \
                f"program {prog.name!r} has {prog.n_blocks} blocks > " \
                f"executor p_max {self.p_max}"
            sims.append(s)
        devs = {p.device for p, _ in padded}
        assert len(devs) == 1, f"jobs on several devices: {devs}"
        dev = devs.pop()
        stacked, p_log = _stack_programs([p for p, _ in padded], self.p_max)
        ops = _FlatOps(stacked, np.arange(bucket, dtype=np.int32), p_log,
                       sims, n)

        by_mech: Dict[str, Dict[str, torch.Tensor]] = {}
        if self._traced:
            ys = _run_family(self._st, None, ops, self._seeds,
                             self._fork_ids)
            for j, s in enumerate(self._traced):
                by_mech[s.name] = {k: v[:, :, j] for k, v in ys.items()}
        for s in self._special:
            by_mech[s.name] = _run_family(self._st, s, ops, self._seeds,
                                          np.zeros((0,), np.int32))
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        rows = [{s.name: (by_mech[s.name], j, s, sims[j].n_epochs)
                 for s in self.specs} for j in range(n)]
        return PendingGrid(rows, n, done)

    def run(self, jobs: Sequence[Tuple[Program, dict]]
            ) -> List[Dict[str, Dict[str, np.ndarray]]]:
        """Synchronous convenience: ``dispatch`` + unpack."""
        return self.dispatch(jobs).traces()


def suite_metrics(programs: Union[Dict[str, Program], Sequence[Program],
                                  None],
                  sim: SimConfig,
                  mechanisms: Sequence[Union[str, MechanismSpec]] = MECHANISMS,
                  n: int = 2,
                  traces: Optional[Dict] = None,
                  baseline: Union[str, MechanismSpec] = "static17"
                  ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Batched counterpart of ``run_workload`` over a suite: ED^nP per
    workload, normalized to ``baseline``. Pass ``traces`` (a ``run_suite``
    result that includes the baseline) to reuse computed traces."""
    mech_specs = [MECH.resolve(m) for m in mechanisms]
    base_spec = MECH.resolve(baseline)
    if traces is None:
        need = tuple(mechanisms)
        if all(s.name != base_spec.name for s in mech_specs):
            need = (base_spec,) + need
        traces = run_suite(programs, sim, need)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for name, trs in traces.items():
        base = trs[base_spec.name]
        budget = 0.9 * base["work"].sum()
        E0, D0, M0 = ednp(base, budget, sim.epoch_us, n)
        out[name] = {}
        for s in mech_specs:
            E, D, M = ednp(trs[s.name], budget, sim.epoch_us, n)
            out[name][s.name] = {
                "accuracy": prediction_accuracy(trs[s.name])
                if s.family != "static" else float("nan"),
                "E": E, "D": D, "ednp": M, "ednp_norm": M / M0,
                "energy_norm": E / E0, "delay_norm": D / D0,
            }
    return out
