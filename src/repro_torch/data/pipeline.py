"""Deterministic streams, splits and artifacts (port of the counter-based
and npz parts of ``repro.data.pipeline``): ``stream_rng``,
``dvfs_request_stream``, ``train_val_split``, ``export_npz`` and
``load_npz``.

Element ``i`` of a stream is derived from ``(seed, i)`` alone, so any
consumer replays bit-identical streams with no stored trace files, and the
port's stream equals the reference's for the same seed. The npz artifacts
(learn datasets and frozen weights) are written canonically, byte for byte
the reference's for the same arrays. The token pipeline comes with the
port of the training path.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.core.workloads import Program, get_workload


def stream_rng(seed: int, i: int) -> np.random.Generator:
    """Element ``i`` of deterministic stream ``seed``, with no sequential
    state: the generator is derived from ``(seed, i)`` alone, so a
    consumer draws element ``i`` without generating the first ``i - 1``."""
    return np.random.default_rng((seed, i))


def train_val_split(n_items: int, *, val_frac: float = 0.25,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic seeded train/val index split.

    Returns sorted ``(train_idx, val_idx)`` int64 arrays partitioning
    ``range(n_items)``, from ``stream_rng(seed, n_items)`` alone. Validation
    gets ``round(n_items * val_frac)`` items, at least 1 and at most
    ``n_items - 1`` whenever ``0 < val_frac`` and ``n_items > 1``."""
    if not 0.0 <= val_frac < 1.0:
        raise ValueError(f"val_frac must be in [0, 1), got {val_frac}")
    perm = stream_rng(seed, n_items).permutation(n_items)
    n_val = int(round(n_items * val_frac))
    if val_frac > 0.0 and n_items > 1:
        n_val = min(max(n_val, 1), n_items - 1)
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])


def export_npz(path, arrays: Dict[str, np.ndarray],
               meta: Optional[dict] = None) -> Path:
    """Deterministic npz export: keys in sorted order, the optional
    ``meta`` dict as canonical (sorted-keys) JSON under ``__meta__``.
    ``np.savez`` stamps fixed zip timestamps, so the same payload gives
    the same bytes."""
    out = {k: np.ascontiguousarray(arrays[k]) for k in sorted(arrays)}
    if meta is not None:
        blob = json.dumps(meta, sort_keys=True).encode("utf-8")
        out["__meta__"] = np.frombuffer(blob, dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)
    return path


def load_npz(path) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """Inverse of :func:`export_npz`: ``(arrays, meta_or_None)``."""
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files if k != "__meta__"}
        meta = (json.loads(f["__meta__"].tobytes().decode("utf-8"))
                if "__meta__" in f.files else None)
    return arrays, meta


def dvfs_request_stream(n_requests: int, *, seed: int = 0,
                        workloads: Sequence[str] = ("comd", "xsbench",
                                                    "lulesh", "minife"),
                        epoch_us: Sequence[float] = (1.0, 10.0),
                        objectives: Sequence[str] = ("ed2p",),
                        steps_per_request: int = 4,
                        device: DeviceLike = "cuda",
                        ) -> Iterator[Tuple[Program, dict, tuple]]:
    """Trace-driven request stream for the streaming DVFS service.

    Yields ``(program, axes_overrides, telemetry)`` tuples ready for
    ``DVFSService.submit``: a Table II workload program on ``device``, a
    traced-axis operating point drawn from ``epoch_us`` x ``objectives``,
    and a plausible (step, seconds) step-time window. Request ``i`` comes
    from ``stream_rng(seed, i)`` alone."""
    names = tuple(workloads)
    progs = {n: get_workload(n, device=device) for n in names}
    for i in range(n_requests):
        rng = stream_rng(seed, i)
        name = names[int(rng.integers(len(names)))]
        axes = {"epoch_us": float(epoch_us[int(rng.integers(len(epoch_us)))]),
                "objective": objectives[int(rng.integers(len(objectives)))]}
        telemetry = tuple(
            (i * steps_per_request + s, float(rng.gamma(2.0, 0.005)))
            for s in range(steps_per_request))
        yield progs[name], axes, telemetry
