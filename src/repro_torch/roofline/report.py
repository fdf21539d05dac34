"""Roofline report of one H100: every (arch x shape) cell counted on
``meta`` tensors (port of ``repro.roofline.report``, which tabulates the
reference's dry-run JSONs; the port has no dry run).

Per (arch x shape) cell, one card: the compute, memory and collective
terms (seconds), the dominant term, MODEL_FLOPS = 6*N_active*D (train) /
2*N_active*D (prefill) / 2*N_active*B (decode), the useful-compute ratio
(model FLOPs over counted FLOPs), the resident bytes of the cell's state
and inputs and whether they fit the card's 80 GB, and a
what-would-move-it note.

  PYTHONPATH=src python -m repro_torch.roofline.report [--csv]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ARCH_IDS, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.input_specs import input_specs
from repro_torch.roofline import work as W
from repro_torch.roofline.analysis import analyze, roofline_terms
from repro_torch.train.train_step import (make_decode_step,
                                          make_prefill_step, make_train_step)

CARD_BYTES = 80e9   # one H100's HBM


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N D (train), 2 N D (prefill) or 2 N B (decode: one token per
    sequence), N the active parameters and D the tokens."""
    N = cfg.n_active_params
    if shape.kind == "train":
        return 6.0 * N * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * N * shape.global_batch * shape.seq_len
    return 2.0 * N * shape.global_batch


def model_flops_per_device(arch: str, shape_name: str,
                           n_devices: int = 1) -> float:
    cfg = get_config(arch)
    shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
    return model_flops(cfg, shape) / n_devices


def step_fn(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig):
    """The cell's step: ``make_train_step``, ``make_prefill_step`` or
    ``make_decode_step``."""
    if shape.kind == "train":
        return make_train_step(cfg, tc)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)


def resident_bytes(inputs) -> int:
    """Bytes of a cell's state and inputs (parameters, optimizer state,
    cache, batch), each tensor once."""
    seen, total = set(), 0
    for t in pytree.tree_leaves(inputs):
        ts = t.parameters() if isinstance(t, torch.nn.Module) else [t]
        for x in ts:
            if isinstance(x, torch.Tensor) and id(x) not in seen:
                seen.add(id(x))
                total += W.nbytes(x)
    return total


def advice(dom: str, row: Dict) -> str:
    if not row["fits_80gb"]:
        return "state does not fit one card: shard it or cut the batch"
    if dom == "t_memory_s":
        if row["useful_ratio"] < 0.5:
            return "cut remat recompute + fuse the backward's passes"
        return "raise arithmetic intensity: fuse elementwise ops, CUDA graphs"
    return "compute-bound: good; next win is the kernels' tensor-core share"


def cell_row(arch: str, cfg: ModelConfig, shape: ShapeConfig,
             tc: TrainConfig = None) -> Dict:
    tc = tc or TrainConfig()
    inputs = input_specs(cfg, shape, tc)
    a = analyze(step_fn(cfg, shape, tc), *inputs)
    peak = W.PEAK_FLOPS_BF16 if cfg.dtype == "bfloat16" \
        else W.PEAK_FLOPS_F32
    terms = roofline_terms(a, peak)
    mf = model_flops(cfg, shape)
    res = resident_bytes(inputs)
    row = {"arch": arch, "shape": shape.name, "devices": 1,
           **{k: terms[k] for k in ("t_compute_s", "t_memory_s",
                                    "t_collective_s", "dominant",
                                    "roofline_fraction")},
           "model_flops_dev": mf, "counted_flops_dev": a["flops"],
           "useful_ratio": mf / a["flops"] if a["flops"] else 0.0,
           "resident_gb_dev": res / 1e9, "fits_80gb": res <= CARD_BYTES}
    row["advice"] = advice(terms["dominant"], row)
    return row


def build_rows() -> List[Dict]:
    return [cell_row(arch, cfg, s)
            for arch in ARCH_IDS
            for cfg in (get_config(arch),)
            for s in shapes_for(cfg)]


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "roofline frac | useful FLOP ratio | resident GB/dev | fits 80 GB "
           "| next move |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3f} | "
            f"{r['t_memory_s']:.3f} | {r['t_collective_s']:.3f} | "
            f"{r['dominant'].replace('t_', '').replace('_s', '')} | "
            f"{r['roofline_fraction']:.2f} | {r['useful_ratio']:.2f} | "
            f"{r['resident_gb_dev']:.1f} | "
            f"{'yes' if r['fits_80gb'] else 'no'} | {r['advice']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = build_rows()
    if args.csv:
        keys = list(rows[0].keys())
        print(",".join(keys))
        for r in rows:
            print(",".join(str(r[k]) for k in keys))
    else:
        print(to_markdown(rows))


if __name__ == "__main__":
    main()
