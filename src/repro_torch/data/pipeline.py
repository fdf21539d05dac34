"""Deterministic streams, splits, artifacts and token batches (port of
``repro.data.pipeline``): ``stream_rng``, ``dvfs_request_stream``,
``train_val_split``, ``export_npz``, ``load_npz`` and the token pipeline
(``DataConfig``, ``make_batch``, ``data_iterator``).

Element ``i`` of a stream is derived from ``(seed, i)`` alone, so any
consumer replays bit-identical streams with no stored trace files, and the
port's stream equals the reference's for the same seed. The npz artifacts
(learn datasets and frozen weights) are written canonically, byte for byte
the reference's for the same arrays.

The token batch of ``step`` comes from ``(seed, step, host_id)`` alone, as
the reference's does, drawn by a ``torch.Generator`` on the batch's
device: its bits differ from ``jax.random``'s (as ``init_params``' do).
The reference's formula over its draws is :func:`affine_tokens`, which
takes the draws as operands.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
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


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2
    n_phases: int = 8


def _wrap_i32(t: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to int32's range, as the reference's int32
    arithmetic wraps."""
    return torch.remainder(t + 2 ** 31, 2 ** 32) - 2 ** 31


def affine_tokens(phase: torch.Tensor, x0: torch.Tensor,
                  noise: torch.Tensor, rand: torch.Tensor, vocab: int,
                  dc: DataConfig = DataConfig()) -> torch.Tensor:
    """The reference's ``_batch_tokens`` over its draws: phase (B,1) in
    [0, n_phases), x0 (B,1) in [0, band), noise (B,S) bool, rand (B,S) in
    [0, band). Each sequence walks ``t_i = (x0 * 31^(i % 7) + 17 i) %
    band`` (int32 arithmetic, wrapping) in its phase's band of the vocab,
    with ``rand`` where ``noise``. Returns (B,S) int32."""
    band = max(vocab // dc.n_phases, 16)
    base = phase.long() * (vocab // dc.n_phases)
    idx = torch.arange(noise.shape[1], device=noise.device)[None, :]
    a, b = 31, 17
    tok = _wrap_i32(_wrap_i32(x0.long() * (a ** (idx % 7))) + b * idx)
    tok = torch.remainder(tok, band)
    tok = torch.where(noise, rand.long(), tok)
    return (base + tok).to(torch.int32)


def _batch_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int,
                  dc: DataConfig) -> torch.Tensor:
    """Synthetic but learnable: a phase per sequence picks a band of the
    vocab, within which tokens follow an affine progression with 5%
    noise, so next-token prediction is learnable to well below ln(V)."""
    dev = gen.device
    band = max(vocab // dc.n_phases, 16)
    phase = torch.randint(0, dc.n_phases, (batch, 1), generator=gen,
                          device=dev)
    x0 = torch.randint(0, band, (batch, 1), generator=gen, device=dev)
    noise = torch.rand((batch, seq), generator=gen, device=dev) < 0.05
    rand = torch.randint(0, band, (batch, seq), generator=gen, device=dev)
    return affine_tokens(phase, x0, noise, rand, vocab, dc)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, *,
               microbatches: int = 1, host_id: int = 0, n_hosts: int = 1,
               dc: DataConfig = DataConfig(),
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The global batch of ``step`` (this host's slice if ``n_hosts > 1``)
    with a leading microbatch axis, (M, B/M, ...) for M = ``microbatches``
    (also M = 1): ``tokens``, next-token ``labels`` and ``mask`` (int32).
    The vision frontend's batch also holds ``patch_embeds`` (B/M,
    n_patches, D) in bf16 and its labels and mask are zero over the
    patches."""
    B = shape.global_batch // n_hosts
    S = shape.seq_len
    dev = resolve_device(device)
    # seeded from (dc.seed, step, host_id) alone
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence(
        (dc.seed, step, host_id)).generate_state(1, np.uint64)[0] >> 1))
    vision = cfg.frontend == "vision"
    St = S - cfg.n_patches if vision else S
    toks = _batch_tokens(gen, B, St + 1, cfg.vocab, dc)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    mask = torch.ones((B, St), dtype=torch.int32, device=dev)
    batch = {"tokens": tokens, "labels": labels, "mask": mask}
    if vision:
        zeros = torch.zeros((B, cfg.n_patches), dtype=torch.int32,
                            device=dev)
        batch["labels"] = torch.cat([zeros, labels], 1)
        batch["mask"] = torch.cat([zeros, mask], 1)
        batch["patch_embeds"] = torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=gen, device=dev,
            dtype=torch.bfloat16)
    return {k: v.reshape(microbatches, B // microbatches, *v.shape[1:])
            for k, v in batch.items()}


def data_iterator(cfg: ModelConfig, shape: ShapeConfig, start_step: int = 0,
                  **kw) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, shape, step, **kw)
        step += 1


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
