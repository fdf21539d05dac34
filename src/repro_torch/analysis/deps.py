"""Axis-liveness auditor (port of ``repro.analysis.deps``): derive each
mechanism's live ``SimAxes`` from the operations its epoch runs and check
the hand-declared ``exec_axes`` against them.

Why this exists
---------------
The sweep layer deduplicates grid points per mechanism by its declared
``MechanismSpec.exec_axes``: points agreeing on a spec's live axes share one
row whose trace is broadcast to every member grid key
(``sweep._exec_classes``). That is only sound if the declaration
over-approximates the real data flow:

* **under-declaration** (an axis the epoch reads but the spec omits) makes
  the dedup broadcast one result across grid points that differ: silently
  wrong numbers. The auditor raises :class:`AxisLivenessError`.
* **over-declaration** (a declared axis the epoch never reads) only costs
  dedup opportunity (extra rows in ``sweep.DISPATCH_ROWS``). The auditor
  warns :class:`DeadAxisWarning`, naming the dead axis.

How it works
------------
This is a static analysis of the spec's epoch function, like the
reference's abstract evaluation of its jaxpr, and not a simulation: it
runs one epoch of the mechanism's specialised step
(``simulate._make_step`` inside ``simulate._run_loop``, the code
``_scan_sim`` runs) on the CPU at a tiny static shape
(:data:`TINY_CONFIG`: 2 CUs x 2 WFs over a 4-block program) under a
``TorchDispatchMode`` that follows every ATen operation. No arithmetic of
any simulation moves to the CPU, and nothing of the audit runs on the card.

* Every leaf of the ``SimAxes`` point is an input tagged with its axis
  name; the ``PowerAxes`` regime's eleven leaves are all tagged ``power``.
  Every leaf of the ``Carry`` is tagged with its position.
* Each operation's outputs depend on the union of its tensor inputs'
  tags, and an operation that writes into an argument (``copy_``, an
  ``out=`` form) adds that union to the argument. Tags live on the storage,
  so a view reads everything written through any alias of its base.
  Conservative in the reference's direction: it can report a false
  under-declaration (a waiver documents it), never hide a real one.
* A host read of a tagged value (``.item()``, ``float()``, ``bool()``,
  ``.tolist()``, ``.numpy()``, and any operation that takes a tagged
  tensor and returns no tensor, such as ``torch.equal`` or
  ``torch.allclose``) would carry the dependency out of sight, so the
  audit raises on it instead (the linter's REPRO001 flags the same reads
  in per-epoch code).
* The carry is iterated to a fixpoint: the dependencies a carry leaf
  takes in one epoch flow into the next epoch's outputs until nothing
  grows, so state threaded across epochs (the PC table carrying
  ``table_ema`` into later predictions) is seen. The logical-epoch mask of
  ``_run_loop`` makes ``n_ep`` live for every channel, as in the reference.

Custom ``predict``/``update`` hooks, :class:`~repro_torch.core.mechanisms.
ParamHook` included, run inside the step like any other code, so a hook
that reads an undeclared axis is caught.

Results are cached per ``(spec, static shape)`` (specs are frozen and
hashable; hooks compare by identity, ``ParamHook`` by value), so the
registration check, the ``run_grid`` guard and the report share one audit
per spec per process.

The registration check (:func:`verify_spec_axes` with ``static_cfg=None``)
audits both engines, as the reference does: :data:`TINY_CONFIG` (the
unfused body) and :data:`TINY_CONFIG_V2` (the fused epoch's plain
version, which the kernel mirrors; specs it does not serve run the unfused
body there too). The dispatch guard (:func:`require_dedup_sound`) audits
the one engine the grid runs: only that engine's data flow can make a
broadcast row wrong.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import mechanisms as MECH
from repro_torch.core import simulate as SIM
from repro_torch.core import workloads as WL
from repro_torch.core.mechanisms import MechanismSpec
from repro_torch.core.simulate import SimConfig

# The audit point: liveness is a property of the epoch's structure, not of
# array extents, so a 2-CU / 2-WF epoch over a 4-block program sees the
# same data flow as a production shape.
TINY_CONFIG = SimConfig(n_cu=2, n_wf=2, n_epochs=2, entries=8,
                        offset_blocks=1, use_pallas=False)

# The same point on the fused-kernel engine: a v2-capable spec's step runs
# ``kernels.epoch_fused`` (its plain version, on the CPU) in place of the
# unfused body, and the declared axes must hold for that step too.
TINY_CONFIG_V2 = dataclasses.replace(TINY_CONFIG, use_pallas="v2")

_CPU = torch.device("cpu")


@functools.lru_cache(maxsize=1)
def _tiny_program() -> WL.Program:
    return WL._finalize("audit", np.linspace(40.0, 80.0, 4),
                        np.linspace(20.0, 40.0, 4),
                        np.linspace(0.1, 0.5, 4), device=_CPU)


class AxisLivenessError(ValueError):
    """A mechanism's epoch depends on an axis its spec does not declare:
    deduplicated grid dispatch would broadcast wrong results."""


class DeadAxisWarning(UserWarning):
    """A declared exec axis the epoch never reads: correct but wasteful
    (the grid dedup keeps equivalence classes apart for nothing)."""


# ---------------------------------------------------------------------------
# dependency tracking over the ATen operations of one epoch
# ---------------------------------------------------------------------------

_Deps = FrozenSet[object]
_EMPTY: _Deps = frozenset()
_HOST_READS = {torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.is_nonzero.default}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class _DepTracker(TorchDispatchMode):
    """Tags on storages, propagated through every ATen operation."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing under the audit is compiled: leave __torch_dispatch__
        # unwrapped, so that the first audit of a process does not import
        # torch._dynamo (seconds of host time inside a first run_grid)
        return False

    def __init__(self):
        super().__init__()
        self._deps: Dict[object, _Deps] = {}
        # every tensor seen stays alive until the audit ends, so no storage
        # address is reused under another tensor's tags
        self._alive: List[torch.Tensor] = []

    def _key(self, t: torch.Tensor):
        s = t.untyped_storage()
        return s.data_ptr() if s.nbytes() else ("empty", id(t))

    def deps(self, t: torch.Tensor) -> _Deps:
        return self._deps.get(self._key(t), _EMPTY)

    def _add(self, t: torch.Tensor, d: _Deps) -> None:
        self._alive.append(t)
        if d:
            k = self._key(t)
            self._deps[k] = self._deps.get(k, _EMPTY) | d

    def tag(self, t: torch.Tensor, d) -> None:
        self._alive.append(t)
        self._deps[self._key(t)] = frozenset(d)

    def host_read(self, t: torch.Tensor, what: str) -> None:
        d = self.deps(t)
        if d:
            raise AxisLivenessError(
                f"{what} reads a value that depends on {sorted(map(str, d))} "
                "on the host inside the epoch: the auditor cannot follow it "
                "(and the card would synchronise every epoch). Keep the "
                "value in a tensor.")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            self.host_read(args[0], func.__name__)
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        u = _EMPTY.union(*(self.deps(t) for t in ins))
        wrote = False
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in _tensors(v):
                    self._add(t, u)
                    wrote = True
        outs = _tensors(out)
        if u and not outs and not wrote:
            # a Python value from tagged tensors (torch.equal, allclose):
            # the dependency would leave the graph through the host
            for t in ins:
                self.host_read(t, func.__name__)
        for t in outs:
            self._add(t, u)
        return out


class _NoHostCopies(TorchFunctionMode):
    """``.numpy()``/``.tolist()`` leave the dispatcher; refuse them on
    tagged values."""

    def __init__(self, tracker: _DepTracker):
        super().__init__()
        self.tracker = tracker

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.numpy, torch.Tensor.tolist,
                    torch.Tensor.__array__):
            self.tracker.host_read(args[0], func.__name__)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# The audit
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AuditResult:
    """Derived-vs-declared liveness for one mechanism."""
    name: str
    declared: Tuple[str, ...]                    # spec.exec_axes
    derived: Tuple[str, ...]                     # union over outputs
    per_output: Tuple[Tuple[str, Tuple[str, ...]], ...]  # channel -> axes
    waiver: Optional[str] = None                 # spec.liveness_waiver

    @property
    def under_declared(self) -> Tuple[str, ...]:
        """Axes the epoch reads but the spec omits (dedup-UNSOUND)."""
        return tuple(a for a in self.derived if a not in self.declared)

    @property
    def over_declared(self) -> Tuple[str, ...]:
        """Declared axes the epoch never reads (dedup opportunity lost)."""
        return tuple(a for a in self.declared if a not in self.derived)

    @property
    def exact(self) -> bool:
        return self.declared == self.derived

    @property
    def sound(self) -> bool:
        """Safe for deduplicated grid dispatch."""
        return not self.under_declared or self.waiver is not None


def _leaf_axes(ax: SIM.SimAxes) -> List[str]:
    """Axis field name of every flattened SimAxes leaf, in flatten order
    (the nested PowerAxes regime gives one ``power`` tag per leaf)."""
    names: List[str] = []
    for f, v in zip(ax._fields, ax):
        names += [f] * len(pytree.tree_leaves(v))
    return names


def _order(s) -> Tuple[str, ...]:
    """Canonical SimAxes field order, like exec_axes."""
    return tuple(a for a in MECH.SIM_AXES_FIELDS if a in s)


@functools.lru_cache(maxsize=256)
def axis_liveness(mech: Union[str, MechanismSpec],
                  static_cfg: Optional[SimConfig] = None) -> AuditResult:
    """Derive the axes each output channel of ``mech``'s epoch loop depends
    on, from one tracked epoch at a tiny static shape on the CPU (a static
    analysis; see the module docstring). Cached per ``(spec, static)``.

    The audited object is the mechanism's specialised step (the concrete
    spec, as ``run_sim`` runs it): the semantics the grid dedup
    broadcasts. The shared traced-id family evaluates every estimator and
    selects, so there every axis would look live."""
    spec = MECH.resolve(mech)
    cfg = TINY_CONFIG if static_cfg is None else static_cfg
    st = cfg.static_part()
    prog = _tiny_program()
    ax0 = cfg.axes(_CPU)
    ax_leaves, ax_spec = pytree.tree_flatten(ax0)
    carry_leaves, carry_spec = pytree.tree_flatten(
        SIM.init_carry(prog.n_blocks, st, _CPU))
    tracker = _DepTracker()
    ax_t = [t.clone() for t in ax_leaves]
    for t, name in zip(ax_t, _leaf_axes(ax0)):
        tracker.tag(t, (name,))
    carry_t = [t.clone() for t in carry_leaves]
    for i, t in enumerate(carry_t):
        tracker.tag(t, (i,))
    ax = pytree.tree_unflatten(ax_t, ax_spec)
    carry = pytree.tree_unflatten(carry_t, carry_spec)

    last = []
    with torch.no_grad(), _NoHostCopies(tracker), tracker:
        step = SIM._make_step(prog, prog.n_blocks, 0, st, ax, spec)

        def step1(c):
            c, ys = step(c)
            last.append(c)
            return c, ys

        ys = SIM._run_loop(step1, carry, 1, ax.n_ep, _CPU)
    carry_out = [tracker.deps(t) for t in pytree.tree_leaves(last[0])]
    assert len(carry_out) == len(carry_t)
    ys_deps = {k: tracker.deps(v) for k, v in ys.items()}

    # carry fixpoint: the initial carry reads no axis; each epoch adds what
    # its step reads, through the previous epoch's carry
    def resolve(d: _Deps, cd: List[_Deps]) -> _Deps:
        out = set()
        for x in d:
            out |= cd[x] if isinstance(x, int) else {x}
        return frozenset(out)

    cd: List[_Deps] = [_EMPTY] * len(carry_t)
    while True:
        new = [cd[i] | resolve(carry_out[i], cd) for i in range(len(cd))]
        if new == cd:
            break
        cd = new
    per_out = {k: resolve(d, cd) for k, d in ys_deps.items()}
    derived = _EMPTY.union(*per_out.values())
    return AuditResult(
        name=spec.name, declared=spec.exec_axes, derived=_order(derived),
        per_output=tuple((k, _order(v)) for k, v in sorted(per_out.items())),
        waiver=spec.liveness_waiver)


def _enforce_audit(res: AuditResult, *, warn_over: bool = True) -> None:
    """Apply the declaration contract to one :class:`AuditResult`: raise
    :class:`AxisLivenessError` on unwaived under-declaration, warn
    :class:`DeadAxisWarning` on over-declaration (when ``warn_over``)."""
    under, over = res.under_declared, res.over_declared
    if under and res.waiver is None:
        culprits = [f"  {ch}: depends on {missing}" for ch, axes in
                    res.per_output
                    for missing in [tuple(a for a in axes if a in under)]
                    if missing]
        raise AxisLivenessError(
            f"mechanism {res.name!r} UNDER-declares exec_axes: its epoch "
            f"depends on {under} but exec_axes={res.declared} omits "
            "them. Deduplicated grid dispatch (run_grid(dedup=True)) "
            "would broadcast one row across grid points that differ on "
            "these axes: silently wrong results. Per-channel liveness:\n"
            + "\n".join(culprits) +
            f"\nFix: add {under} to the spec's exec_axes (costing only "
            "dedup opportunity if the auditor over-approximated), or, "
            "ONLY for a documented false positive of the conservative "
            "dependency walk, set liveness_waiver explaining why.")
    if under and res.waiver is not None:
        warnings.warn(
            f"mechanism {res.name!r} under-declares {under} under waiver: "
            f"{res.waiver}", DeadAxisWarning, stacklevel=3)
    if over and warn_over:
        warnings.warn(
            f"mechanism {res.name!r} over-declares exec_axes: {over} "
            f"is dead in its epoch (declared {res.declared}, derived "
            f"{res.derived}). Correct but wasteful: grid points that "
            "differ only on a dead axis each get their own row "
            "(DISPATCH_ROWS shows the extra rows). Drop the axis from "
            "exec_axes to let the dedup collapse them.",
            DeadAxisWarning, stacklevel=3)


def verify_spec_axes(mech: Union[str, MechanismSpec],
                     static_cfg: Optional[SimConfig] = None) -> AuditResult:
    """Audit ``mech`` and enforce the declaration contract: raise
    :class:`AxisLivenessError` on under-declaration (unless the spec
    carries a ``liveness_waiver``), warn :class:`DeadAxisWarning` on
    over-declaration, naming the dead axes.

    At the default audit point (``static_cfg=None``) the spec is audited
    under both engines, :data:`TINY_CONFIG` and :data:`TINY_CONFIG_V2`.
    The v2 pass enforces under-declaration only, and only where it derives
    something else than the first pass."""
    res = axis_liveness(mech, static_cfg)
    _enforce_audit(res)
    if static_cfg is None:
        res2 = axis_liveness(mech, TINY_CONFIG_V2)
        if res2 != res:
            _enforce_audit(res2, warn_over=False)
    return res


def engine_audit_point(static_cfg: Optional[SimConfig]) -> SimConfig:
    """The audit point of the engine ``static_cfg`` runs a spec's step on:
    :data:`TINY_CONFIG_V2` where it takes the fused epoch
    (``use_pallas`` True or ``"v2"``, no per-WF record), else
    :data:`TINY_CONFIG` (``None`` too, as in the reference)."""
    if (static_cfg is not None and static_cfg.use_pallas in (True, "v2")
            and not static_cfg.record_wf):
        return TINY_CONFIG_V2
    return TINY_CONFIG


def require_dedup_sound(mech: Union[str, MechanismSpec],
                        static_cfg: Optional[SimConfig] = None) -> None:
    """Dispatch-time guard of ``run_grid(dedup=True)``: raise
    :class:`AxisLivenessError` if ``mech``'s epoch reads an undeclared
    axis on the engine ``static_cfg`` selects (:func:`engine_audit_point`;
    the other engine cannot move this grid's rows). Warning-free
    (over-declaration is flagged at registration and in the report) and
    cached, so a spec costs one audit per engine per process."""
    if not axis_liveness(mech, engine_audit_point(static_cfg)).sound:
        verify_spec_axes(mech)  # raises with the full diagnostic


def audit_registry(static_cfg: Optional[SimConfig] = None
                   ) -> List[AuditResult]:
    """Audit every registered mechanism (the report's entry point)."""
    return [axis_liveness(s, static_cfg) for s in MECH.specs()]
