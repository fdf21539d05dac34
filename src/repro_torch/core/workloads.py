"""Wavefront-program workload models (port of ``repro.core.workloads``).

A *program* is a looped sequence of P instruction blocks (4 instructions per
block). Block j has ``i0_rate[j]`` (instr/us, frequency-independent),
``sens_rate[j]`` (instr/us/GHz) and ``mem_frac[j]`` (share of traffic on the
shared L2/DRAM path), so a wavefront in block j commits
``(i0 + sens*f) * T`` instructions per epoch.

Generation uses the same numpy ``default_rng`` streams as the reference, so
the rate arrays are byte-equal to it. The packed prefix sums ``cum3`` are
taken on the CPU with a sequential f32 cumsum and then moved to the device,
so every device sees the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

INSTR_PER_BLOCK = 4


@dataclass
class Program:
    name: str
    i0_rate: torch.Tensor    # (P,) instr/us
    sens_rate: torch.Tensor  # (P,) instr/us/GHz
    mem_frac: torch.Tensor   # (P,)
    # prefix sums over the doubled program, packed (2P+1, 3) as columns
    # (i0, sens, mem): O(1) wrapped window averages in the epoch body
    cum3: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.i0_rate.shape[0]

    @property
    def device(self) -> torch.device:
        return self.i0_rate.device

    @property
    def cum_i0(self) -> torch.Tensor:
        return self.cum3[:, 0]

    @property
    def cum_sens(self) -> torch.Tensor:
        return self.cum3[:, 1]

    @property
    def cum_mem(self) -> torch.Tensor:
        return self.cum3[:, 2]


def _finalize(name, i0, sens, mem, device: DeviceLike = "cpu") -> Program:
    dev = resolve_device(device)
    cols = [torch.as_tensor(np.asarray(a), dtype=torch.float32)
            for a in (i0, sens, mem)]

    def cum(a):
        return torch.cat([torch.zeros(1), torch.cumsum(a.repeat(2), 0)])

    cum3 = torch.stack([cum(a) for a in cols], dim=-1)
    return Program(name, *(a.to(dev) for a in cols), cum3.to(dev))


# base per-WF rate scale: a wavefront at 1.7 GHz commits ~100 instr/us
_RATE = 100.0


def _segments(rng: np.random.Generator, P: int, palettes,
              seg_len_mean: float, hetero: float = 0.3):
    """Piecewise-constant (i0, sens, mem) arrays. ``palettes`` is a list of
    phase palettes cycled deterministically; the phase within a palette and
    the segment length are random."""
    if palettes and isinstance(palettes[0], tuple) \
            and isinstance(palettes[0][0], float):
        palettes = [palettes]  # single palette
    i0 = np.zeros(P)
    sens = np.zeros(P)
    mem = np.zeros(P)
    pos, pi = 0, 0
    while pos < P:
        ln = max(2, int(rng.exponential(seg_len_mean)))
        kinds = palettes[pi % len(palettes)]
        pi += 1
        core_share, rate_mult, mfrac = kinds[rng.integers(len(kinds))]
        jitter = 1.0 + hetero * rng.standard_normal()
        rate = _RATE * rate_mult * max(jitter, 0.3)
        # at f=1.7: rate = i0 + sens*1.7 with core share of the f-scaling part
        sens_v = core_share * rate / 1.7
        i0_v = (1 - core_share) * rate
        i0[pos:pos + ln] = i0_v
        sens[pos:pos + ln] = sens_v
        mem[pos:pos + ln] = mfrac
        pos += ln
    return i0, sens, mem


# phase palettes: (core_share, rate_mult, mem_frac)
_COMPUTE = [(0.9, 1.4, 0.05), (0.8, 0.7, 0.1), (0.95, 1.1, 0.02),
            (0.85, 1.8, 0.08),
            (0.45, 0.9, 0.45)]  # tile prologue/epilogue interludes
_MEMORY = [(0.15, 0.7, 0.8), (0.25, 0.8, 0.7), (0.1, 0.6, 0.9)]
_BALANCED = [(0.55, 1.0, 0.35), (0.45, 0.9, 0.45)]
_ALL = _COMPUTE + _MEMORY + _BALANCED


# (generator spec, mem_frac acceptance band) per kind: rejection sampling
# guarantees every generated program really has its intended phase mix
_KIND_SPECS = {
    "compute":  (([_COMPUTE, _COMPUTE, _BALANCED], 32, 0.7), (0.0, 0.3)),
    "memory":   (([_MEMORY, _MEMORY, _MEMORY, _BALANCED], 32, 0.4),
                 (0.5, 1.0)),
    "phased":   (([_COMPUTE, _MEMORY], 36, 0.5), (0.25, 0.55)),
    "irregular": (([_ALL], 12, 0.8), (0.15, 0.6)),
    "constant": (([(0.5, 1.0, 0.3)], 100_000, 0.0), (0.0, 1.0)),
    "thrash":   (([(0.7, 1.2, 0.75), (0.6, 1.1, 0.8)], 40, 0.3), (0.5, 1.0)),
    "mixed":    (([_BALANCED, _COMPUTE, _MEMORY], 24, 0.5), (0.15, 0.45)),
}


def make_program(name: str, kind: str, seed: int, P: int = 1024,
                 device: DeviceLike = "cuda") -> Program:
    (palettes, seg_len, hetero), (lo, hi) = _KIND_SPECS[kind]
    for trial in range(50):
        rng = np.random.default_rng(seed + 1000 * trial)
        i0, s, m = _segments(rng, P, palettes, seg_len_mean=min(seg_len, P),
                             hetero=hetero)
        if lo <= float(np.mean(m)) <= hi:
            break
    return _finalize(name, i0, s, m, device)


# The paper's workload suite (Table II), mapped to generator kinds.
WORKLOAD_TABLE: Dict[str, Tuple[str, int]] = {
    # HPC apps
    "comd": ("phased", 11),
    "hpgmg": ("memory", 12),
    "lulesh": ("irregular", 13),
    "minife": ("mixed", 14),
    "xsbench": ("memory", 15),
    "hacc": ("phased", 16),
    "quickS": ("irregular", 17),
    "pennant": ("mixed", 18),
    "snapc": ("memory", 19),
    # MI apps
    "dgemm": ("compute", 21),
    "BwdBN": ("mixed", 22),
    "BwdPool": ("constant", 23),
    "BwdSoft": ("memory", 24),
    "FwdBN": ("mixed", 25),
    "FwdPool": ("constant", 26),
    "FwdSoft": ("thrash", 27),
}


def get_workload(name: str, P: int = 1024,
                 device: DeviceLike = "cuda") -> Program:
    kind, seed = WORKLOAD_TABLE[name]
    return make_program(name, kind, seed, P=P, device=device)


def all_workloads(P: int = 1024,
                  device: DeviceLike = "cuda") -> Dict[str, Program]:
    return {n: get_workload(n, P, device) for n in WORKLOAD_TABLE}
