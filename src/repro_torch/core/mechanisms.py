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

The axis-liveness auditor of ``repro.analysis`` is not ported yet
(ROADMAP A11): ``register(verify_axes=True)`` raises until it is.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

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
    # axis-liveness auditor (kept for parity with the reference's specs)
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


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, MechanismSpec] = {}
_REG_LOCK = threading.Lock()


def register(spec: MechanismSpec, *, allow_override: bool = False,
             verify_axes: bool = False) -> MechanismSpec:
    """Add ``spec`` to the registry and return it. Duplicate names raise
    unless ``allow_override=True``; builtins can never be overridden and
    user mechanisms cannot claim a traced id. ``verify_axes=True`` needs
    the axis-liveness auditor, which is not ported yet."""
    if verify_axes:
        raise NotImplementedError(
            "verify_axes needs the axis-liveness auditor (analysis/), not "
            "yet ported: ROADMAP A11")
    with _REG_LOCK:
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
    _REGISTRY[_s.name] = _s
del _s

assert names() == BUILTIN_NAMES
