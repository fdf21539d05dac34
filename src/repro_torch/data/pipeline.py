"""Deterministic request streams (port of the counter-based part of
``repro.data.pipeline``): ``stream_rng`` and ``dvfs_request_stream``.

Element ``i`` of a stream is derived from ``(seed, i)`` alone, so any
consumer replays bit-identical streams with no stored trace files, and the
port's stream equals the reference's for the same seed.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.core.workloads import Program, get_workload


def stream_rng(seed: int, i: int) -> np.random.Generator:
    """Element ``i`` of deterministic stream ``seed``, with no sequential
    state: the generator is derived from ``(seed, i)`` alone, so a
    consumer draws element ``i`` without generating the first ``i - 1``."""
    return np.random.default_rng((seed, i))


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
