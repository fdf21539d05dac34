"""Mechanism-as-data: the ``MechanismSpec`` registry (port of
``repro.core.mechanisms``).

Every DVFS mechanism is one frozen :class:`MechanismSpec`; the engine
derives its dispatch (family branch, static V/f index, traced fork-family
ids, custom predictor/estimator hooks) from the registry. The builtin
traced ids are frozen: they are the same integers as the reference's, so
results keyed by id carry across the two packages.

Hook contract (as in the reference, on tensors):

``predict(carry, ctx, st, ax) -> (n_cu, n_freqs) tensor``
    Predicted instructions committed next epoch at every V/f state; use
    ``simulate.predict_instr`` to lower a per-CU linear model.
``update(counters, f_sel, I_f, carry, ctx, st, ax) -> (i0, sens) | None``
    New per-CU reactive state in instr/us(/GHz) rate units; ``None`` keeps
    the carry.

Hooks whose weights are part of the mechanism's identity (the learned
predictors of ``repro_torch.learn``) ride a :class:`ParamHook`, which
compares by parameter value. ``register`` audits every non-builtin spec
with the axis-liveness auditor (``repro_torch.analysis.deps``), and
:func:`mechanism_table` renders the registry with the audit's verdict.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import power as PWR

# The traced SimAxes fields (asserted against simulate.SimAxes._fields at
# engine import so the two can never drift)
SIM_AXES_FIELDS = ("epoch_us", "sigma", "cap_per_ghz", "membw", "table_ema",
                   "obj", "n_ep", "power")

# SimAxes field -> SimConfig field
AXIS_TO_CONFIG = {"obj": "objective", "n_ep": "n_epochs"}

FAMILIES = ("static", "reactive", "pc", "oracle")

# the DEFAULT ladder length; static V/f indices are validated against the
# actual ladder at dispatch
N_FREQS = PWR.DEFAULT.n_freqs

# axes the engine reads for every mechanism (execution model, logical
# epoch mask, power regime); + obj for anything that selects a frequency,
# + table_ema for anything with a PC table
_REQUIRED_AXES = ("epoch_us", "sigma", "cap_per_ghz", "membw", "n_ep",
                  "power")


@dataclass(frozen=True)
class MechanismSpec:
    """One DVFS mechanism, as data. Frozen and hashable."""
    name: str
    family: str                              # one of FAMILIES
    exec_axes: Tuple[str, ...]               # live SIM_AXES_FIELDS
    label: str = ""                          # plot/report label
    color: Optional[str] = None              # plot metadata
    static_fidx: Optional[int] = None        # family='static': V/f index
    traced_id: Optional[int] = None          # fork-family scan id (builtin)
    cu_model: Optional[str] = None           # reactive estimator name
    fork_estimator: bool = False             # estimate from fork rows (acc*)
    hit_telemetry: bool = False              # emits the hit_rate channel
    predict: Optional[Callable] = None       # custom predictor hook
    update: Optional[Callable] = None        # custom estimator hook
    # documented waiver for a false under-declaration reported by the
    # axis-liveness auditor: it turns the audit's error into a warning
    liveness_waiver: Optional[str] = None
    # whether the fused epoch kernel can serve this mechanism; forced False
    # for static pins, the fork oracle and custom predict hooks, which run
    # the unfused body
    v2_capable: bool = True

    def __post_init__(self):
        assert self.family in FAMILIES, \
            f"family {self.family!r} not in {FAMILIES}"
        bad = [a for a in self.exec_axes if a not in SIM_AXES_FIELDS]
        assert not bad, \
            f"exec_axes {bad} not SimAxes fields (one of {SIM_AXES_FIELDS})"
        assert len(set(self.exec_axes)) == len(self.exec_axes), \
            f"duplicate exec_axes in {self.exec_axes}"
        # canonical SimAxes field order: equal axis sets compare equal
        canon = tuple(a for a in SIM_AXES_FIELDS if a in self.exec_axes)
        object.__setattr__(self, "exec_axes", canon)
        if self.family == "static":
            assert self.static_fidx is not None and \
                0 <= self.static_fidx < N_FREQS, \
                f"static mechanism needs static_fidx in [0, {N_FREQS})"
            assert self.predict is None and self.update is None, \
                "static mechanisms take no predictor hooks"
        else:
            assert self.static_fidx is None, \
                f"{self.family} mechanism must not set static_fidx"
        if self.update is not None:
            assert self.predict is not None, \
                "an update hook requires a predict hook"
        if self.family in ("reactive", "pc") and self.predict is None \
                and self.traced_id is None:
            raise ValueError(
                f"custom {self.family} mechanism {self.name!r} needs a "
                "predict hook (builtin predictor paths are traced-id "
                "dispatch only)")
        if self.hit_telemetry and self.family != "pc":
            raise ValueError(
                "hit_telemetry requires family='pc' — only the PC-table "
                "path emits the hit_rate channel")
        required = set(_REQUIRED_AXES)
        if self.family != "static":
            required.add("obj")
        if self.family == "pc":
            required.add("table_ema")
        missing = [a for a in SIM_AXES_FIELDS
                   if a in required and a not in self.exec_axes]
        if missing:
            raise ValueError(
                f"{self.family} mechanism {self.name!r} must declare the "
                f"engine-imposed live axes {missing} in exec_axes — an "
                "omitted live axis makes the grid dedup broadcast wrong "
                "results")
        if self.family in ("static", "oracle") or self.predict is not None:
            object.__setattr__(self, "v2_capable", False)
        if not self.label:
            object.__setattr__(self, "label", self.name)

    @property
    def is_traced(self) -> bool:
        """True for the builtin non-oracle fork mechanisms."""
        return (self.traced_id is not None and self.family != "oracle"
                and self.predict is None)

    @property
    def config_axes(self) -> Tuple[str, ...]:
        return tuple(AXIS_TO_CONFIG.get(a, a) for a in self.exec_axes)

    @property
    def dedup_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.config_axes if a != "n_epochs")


class ParamHook:
    """A predict/update hook parameterized by arrays, compared by VALUE.

    Binds a module-level hook function ``fn`` to a flat ``{name: array}``
    parameter dict and calls it as ``fn(*hook_args, params=tensors)``,
    where ``tensors`` are the parameters as f32 tensors on the device of
    the hook's first tensor argument (copied there once per device and
    kept: the epoch loop copies nothing from the host).

    Equality and hashing cover ``(fn identity, per-parameter name, shape,
    dtype, bytes)``, the key the step caches need:

    * a spec re-created around equal-valued parameters (the same frozen
      artifact reloaded) compares equal, so every spec-keyed cache
      (``sweep._grid_step``, the audit cache, ``resolve``) hits and
      nothing is rebuilt;
    * any changed byte makes an unequal spec, which builds its own step
      and never reuses one with old weights;
    * the shared builtin fork family keys on no custom spec, so weight
      swaps never rebuild it.

    Parameters are converted with ``np.asarray`` and keyed in sorted-name
    order; pass numpy arrays (or CPU tensors)."""

    __slots__ = ("fn", "params", "_key", "_hash", "_on_device")

    def __init__(self, fn: Callable, params: Mapping[str, "np.ndarray"]):
        self.fn = fn
        self.params = {k: np.asarray(params[k]) for k in sorted(params)}
        self._key = (fn, tuple(
            (k, v.shape, v.dtype.str, v.tobytes())
            for k, v in self.params.items()))
        self._hash = hash(self._key)
        self._on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The parameters as f32 tensors on ``device`` (cached)."""
        dev = torch.device(device)
        got = self._on_device.get(dev)
        if got is None:
            got = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                   for k, v in self.params.items()}
            self._on_device[dev] = got
        return got

    def __call__(self, *args, **kw):
        dev = next(t.device for t in pytree.tree_leaves(args)
                   if isinstance(t, torch.Tensor))
        return self.fn(*args, params=self.tensors(dev), **kw)

    def __eq__(self, other):
        return isinstance(other, ParamHook) and self._key == other._key

    def __hash__(self):
        return self._hash

    def __repr__(self):
        shapes = {k: v.shape for k, v in self.params.items()}
        name = getattr(self.fn, "__name__", repr(self.fn))
        return f"ParamHook({name}, {shapes})"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, MechanismSpec] = {}
_REG_LOCK = threading.Lock()


def register(spec: MechanismSpec, *, allow_override: bool = False,
             verify_axes: Optional[bool] = None) -> MechanismSpec:
    """Add ``spec`` to the registry and return it. Duplicate names raise
    unless ``allow_override=True``; builtins can never be overridden and
    user mechanisms cannot claim a traced id.

    ``verify_axes`` runs the axis-liveness auditor
    (:func:`repro_torch.analysis.deps.verify_spec_axes`) on the spec
    before it enters the registry: one epoch of the spec is followed
    operation by operation at a tiny static shape on the CPU (cached, and
    shared with the ``run_grid`` guard) and its real axis dependencies
    are checked against ``exec_axes``. Under-declaration raises
    :class:`repro_torch.analysis.deps.AxisLivenessError` and the spec is
    not registered; over-declaration warns, naming the dead axis. The
    default (``None``) audits every spec outside ``BUILTIN_NAMES``; the
    builtins are held exact by the port's tests.

    Step builds are keyed on the spec value and plain hook functions
    compare by identity, so a spec re-created around fresh lambdas builds
    a new step; weights that belong to the mechanism's identity go in a
    :class:`ParamHook`, which compares by value."""
    if spec.name in _REGISTRY and (
            not allow_override or spec.name in BUILTIN_NAMES):
        raise ValueError(
            f"mechanism {spec.name!r} is already registered"
            + ("" if allow_override else
               " (pass allow_override=True to replace)"))
    if spec.name not in BUILTIN_NAMES:
        assert spec.traced_id is None, \
            "traced ids are reserved for the builtin fork family"
        assert spec.family != "oracle", \
            "the oracle family is the builtin fork oracle"
    if verify_axes is None:
        verify_axes = spec.name not in BUILTIN_NAMES
    if verify_axes:
        # lazy: the auditor imports simulate, which imports this module
        from repro_torch.analysis.deps import verify_spec_axes
        verify_spec_axes(spec)  # raises AxisLivenessError: not registered
    with _REG_LOCK:
        if spec.name in _REGISTRY and (
                not allow_override or spec.name in BUILTIN_NAMES):
            raise ValueError(
                f"mechanism {spec.name!r} is already registered")
        _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> None:
    """Remove a user-registered mechanism (builtins are permanent)."""
    assert name not in BUILTIN_NAMES, f"cannot unregister builtin {name!r}"
    with _REG_LOCK:
        _REGISTRY.pop(name, None)


def get(name: str) -> MechanismSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown mechanism {name!r}; registered: {names()}") from None


def resolve(mech: Union[str, MechanismSpec]) -> MechanismSpec:
    """A mechanism name or spec, uniformly. A spec whose name is registered
    must be field-equal to the registered one."""
    if isinstance(mech, MechanismSpec):
        reg = _REGISTRY.get(mech.name)
        if reg is not None:
            if reg != mech:
                raise ValueError(
                    f"spec {mech.name!r} differs from the registered "
                    "mechanism of that name; register the variant under "
                    "its own name (or allow_override=True)")
            return reg
        assert mech.traced_id is None, \
            "traced ids are reserved for the registered builtin fork family"
        return mech
    return get(mech)


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def specs() -> Tuple[MechanismSpec, ...]:
    return tuple(_REGISTRY.values())


def fork_specs() -> Tuple[MechanismSpec, ...]:
    """Builtin fork mechanisms in traced-id order."""
    forks = sorted((s for s in _REGISTRY.values() if s.traced_id is not None),
                   key=lambda s: s.traced_id)
    ids = [s.traced_id for s in forks]
    assert ids == list(range(len(forks))), \
        f"traced ids must be contiguous from 0, got {ids}"
    return tuple(forks)


def traced_reactive_count() -> int:
    """Number of traced reactive ids; they must be 0..n-1."""
    react = [s.traced_id for s in _REGISTRY.values()
             if s.is_traced and s.family == "reactive"]
    assert sorted(react) == list(range(len(react))), react
    return len(react)


# ---------------------------------------------------------------------------
# Builtin paper mechanisms (traced ids frozen: identical to the reference)
# ---------------------------------------------------------------------------

_EXEC = ("epoch_us", "sigma", "cap_per_ghz", "membw", "n_ep", "power")
_CTRL = _EXEC + ("obj",)          # + objective: drives frequency selection
_TABLE = _CTRL + ("table_ema",)   # + table EMA: drives the PC table

BUILTIN_NAMES = ("static13", "static17", "static22",
                 "stall", "lead", "crit", "crisp",
                 "accreac", "pcstall", "accpc", "oracle")

for _s in (
    MechanismSpec("static13", "static", _EXEC, static_fidx=0,
                  label="static 1.3 GHz"),
    MechanismSpec("static17", "static", _EXEC, static_fidx=4,
                  label="static 1.7 GHz"),
    MechanismSpec("static22", "static", _EXEC, static_fidx=9,
                  label="static 2.2 GHz"),
    MechanismSpec("stall", "reactive", _CTRL, traced_id=0, cu_model="stall",
                  label="STALL (reactive)"),
    MechanismSpec("lead", "reactive", _CTRL, traced_id=1, cu_model="lead",
                  label="LEAD (reactive)"),
    MechanismSpec("crit", "reactive", _CTRL, traced_id=2, cu_model="crit",
                  label="CRIT (reactive)"),
    MechanismSpec("crisp", "reactive", _CTRL, traced_id=3, cu_model="crisp",
                  label="CRISP (reactive)"),
    MechanismSpec("accreac", "reactive", _CTRL, traced_id=4,
                  fork_estimator=True, label="ACC-REAC (fork-accurate)"),
    MechanismSpec("pcstall", "pc", _TABLE, traced_id=5,
                  hit_telemetry=True, label="PCSTALL (predictive)"),
    MechanismSpec("accpc", "pc", _TABLE, traced_id=6, fork_estimator=True,
                  hit_telemetry=True, label="ACC-PC (fork-accurate table)"),
    MechanismSpec("oracle", "oracle", _CTRL, traced_id=7,
                  label="fork oracle"),
):
    # repro: waive[REPRO006] import-time builtin registration, no threads yet
    _REGISTRY[_s.name] = _s
del _s

assert names() == BUILTIN_NAMES


def mechanism_table(verify: bool = True) -> str:
    """The registry as a markdown table.

    With ``verify=True`` each row's live-axes cell is stamped by the
    axis-liveness auditor: ``✓`` when it derives exactly the declared
    set, ``~ over`` for a declared axis that is dead, ``waived`` for a
    documented waiver and ``✗ UNDER`` for an under-declaration."""
    marks = {}
    if verify:
        from repro_torch.analysis.deps import axis_liveness
        for s in specs():
            res = axis_liveness(s)
            if res.under_declared:
                marks[s.name] = "waived" if res.waiver else "✗ UNDER"
            else:
                marks[s.name] = "✓" if res.exact else "~ over"
    head = "| name | family | traced id | live axes | verified | label |" \
        if verify else "| name | family | traced id | live axes | label |"
    rows = [head, "|---|---|" + "---|" * (head.count("|") - 3)]
    for s in specs():
        tid = "—" if s.traced_id is None else str(s.traced_id)
        axes = ", ".join(a for a in s.exec_axes if a != "n_ep")
        cells = [f"`{s.name}`", s.family, tid, axes]
        if verify:
            cells.append(marks[s.name])
        cells.append(s.label)
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join(rows)
