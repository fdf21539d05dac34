"""Checkpoints with an atomic commit and resume (port of
``repro.train.checkpoint``), in the reference's layout and keys, so that a
checkpoint written by either package restores in the other.

Layout: ``<dir>/step_<N:08d>/shard_<host:05d>.npz`` and ``MANIFEST.json``,
written last by an atomic rename: a step without a manifest is incomplete
and ignored. Keys are the reference's slash paths of its state tree:
``params/embed``, ``params/layers/attn/wq`` (the per-layer leaves stacked
on a leading layer axis, as the reference stores its layers),
``opt/m/...``, ``opt/v/...``, ``opt/count``, ``step`` and ``ef/...``;
bf16 is stored as f32 (lossless).

The npz is written one array at a time and read one array at a time, so
the host holds one stacked leaf, not the state. ``save`` checks the free
disk space first and raises ``OSError`` naming what it needs.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

Entry = Union[torch.Tensor, List[torch.Tensor]]


def _tree_entries(prefix: str, named) -> Dict[str, Entry]:
    """{key: tensor, or the per-layer tensors of a stacked key} of a
    ``(name, tensor)`` iterable whose names are the params tree's
    (``layers.<i>.attn.wq``)."""
    out: Dict[str, Entry] = {}
    for name, t in named:
        parts = name.split(".")
        if parts[0] == "layers":
            key = "/".join([prefix, "layers", *parts[2:]])
            layers = out.setdefault(key, [])
            if int(parts[1]) != len(layers):
                raise ValueError(f"{name}: layers out of order")
            layers.append(t)
        else:
            out["/".join([prefix, *parts])] = t
    return out


def _entries(state) -> Dict[str, Entry]:
    """The checkpoint's keys and what each holds; the moments and
    residuals are flat dicts by the parameters' names, walked in the
    params tree's order (its layers in index order)."""
    named = list(state["params"].named_parameters())
    out = _tree_entries("params", named)
    opt = state["opt"]
    for prefix, tree in (("opt/m", opt.m), ("opt/v", opt.v),
                         ("ef", state.get("ef"))):
        if tree is not None:
            out.update(_tree_entries(prefix, ((k, tree[k])
                                              for k, _ in named)))
    out["opt/count"] = opt.count
    out["step"] = state["step"]
    return out


def _stored(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _array(entry: Entry) -> np.ndarray:
    if isinstance(entry, torch.Tensor):
        return _stored(entry)
    first = _stored(entry[0])
    arr = np.empty((len(entry), *first.shape), first.dtype)
    arr[0] = first
    for i, t in enumerate(entry[1:], 1):
        arr[i] = _stored(t)
    return arr


def nbytes(state) -> int:
    """The bytes of the arrays a checkpoint of ``state`` holds."""
    total = 0
    for entry in _entries(state).values():
        for t in ([entry] if isinstance(entry, torch.Tensor) else entry):
            total += t.numel() * (4 if t.is_floating_point()
                                  else t.element_size())
    return total


def save(state, ckpt_dir: str, step: int, host_id: int = 0,
         keep: int = 3) -> str:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    entries = _entries(state)
    need, free = nbytes(state), shutil.disk_usage(d).free
    if free < need:
        raise OSError(f"checkpoint of step {step} needs {need / 1e9:.2f} GB"
                      f" under {d}; {free / 1e9:.2f} GB are free")
    tmp = tempfile.NamedTemporaryFile(dir=d, delete=False, suffix=".tmp")
    try:
        with tmp, zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                                  allowZip64=True) as zf:
            for key, entry in entries.items():
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _array(entry),
                                              allow_pickle=False)
        os.replace(tmp.name, d / f"shard_{host_id:05d}.npz")
    except BaseException:
        os.unlink(tmp.name)
        raise
    # manifest written LAST = commit point
    manifest = {"step": step, "n_leaves": len(entries), "host": host_id}
    mtmp = d / f".manifest_{host_id}.tmp"
    mtmp.write_text(json.dumps(manifest))
    os.replace(mtmp, d / "MANIFEST.json")
    _gc(ckpt_dir, keep)
    return str(d)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    best = None
    for d in sorted(Path(ckpt_dir).glob("step_*")):
        if (d / "MANIFEST.json").exists():  # complete checkpoints only
            best = int(d.name.split("_")[1])
    return best


def restore(state_template, ckpt_dir: str, step: Optional[int] = None,
            host_id: int = 0) -> Tuple[object, int]:
    """Restore into ``state_template`` in place (each tensor keeps its
    dtype and device). Returns (state, step). Raises FileNotFoundError if
    no complete checkpoint exists."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(d / f"shard_{host_id:05d}.npz") as z, torch.no_grad():
        for key, entry in _entries(state_template).items():
            arr = z[key]
            dst = [entry] if isinstance(entry, torch.Tensor) else entry
            src = [arr] if isinstance(entry, torch.Tensor) else arr
            want = tuple(dst[0].shape) if isinstance(entry, torch.Tensor) \
                else (len(dst), *dst[0].shape)
            if arr.shape != want:
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"state shape {want}")
            for t, a in zip(dst, src):
                t.copy_(torch.from_numpy(a))
    return state_template, step
