"""Hand-written CUDA kernels of the port (sm_90a).

Ten kernels, one shared library. The DVFS engine's hot path:

* ``pc_table.pc_table_predict`` / ``pc_table.pc_table_update`` — the PC
  table predict/update pair (``csrc/pc_table.cu``);
* ``epoch_fused.epoch_fused`` — the whole fork--execute epoch of one
  simulation, families ``pc``/``reactive`` (``csrc/epoch_fused.cu``: each
  row's CUs over CTAs of a few CUs, in two passes and an epilogue);
* ``epoch_fused.epoch_fused_rows`` — the same epoch for every row of a
  sweep family at once, mechanism chosen per row by a traced id (family
  ``fork``; the same kernels).

The LM model zoo's prefill and decode (``ops.py`` holds the reference's
public wrappers):

* ``flash_attention.flash_attention_bshd`` — K6, online-softmax attention
  with causal, sliding-window and prefix-LM masks over grouped KV heads at
  head dims 16, 32, 64, 96, 128 and 256 (``csrc/flash_attention.cu``):
  bf16 on the tensor cores (``wgmma``, TMA-staged K/V, p split into two
  bf16 terms), f32 on the CUDA cores; it also writes each row's
  log-sum-exp where asked;
* ``flash_attention.flash_attention_bshd_bwd`` — K6's backward
  (``csrc/flash_attention_bwd.cu``): dq, dk and dv from the log-sum-exp
  K6 saved, a dk/dv kernel per key tile and a dq kernel per query tile,
  bf16 on the tensor cores (``wgmma`` with TMA-fed rings up to head dim
  128, ``mma.sync`` at 256), f32 on the CUDA cores, no atomics;
* ``rwkv_chunk.rwkv_chunked_bthd`` — K7, the chunked RWKV6 WKV
  (``csrc/rwkv_chunk.cu``): persistent CTAs walk the (batch, head,
  chunk) tiles, the state carried from chunk to chunk through a chain of
  flags;
* ``ssm_scan.ssm_scan`` — K8, the selective scan of the hybrid family's
  mamba heads (``csrc/ssm_scan.cu``): one CTA per (batch, head), one
  thread per channel, tiles of tokens staged in shared memory. It
  replaces no TPU kernel (the reference's scan is a ``lax.scan``);
* ``ssm_scan.ssm_scan_bwd`` — K8's backward (``csrc/ssm_scan_bwd.cu``):
  the same grid, the state checkpointed every few tokens and each tile
  recomputed in reverse, the sums over channels in a fixed order.

Every wrapper launches its kernel on a CUDA tensor and runs the kernel's
plain PyTorch version on a CPU tensor; there is no fallback between the
two. :func:`library` builds the CUDA sources with ``nvcc`` at first use
into ``build/repro_torch/<source hash>/`` at the repository root (one
``nvcc`` per source, all started together, then one link) and loads the
result with ``ctypes``. A changed source rebuilds; an unchanged one loads
the cached library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_LIB_NAME = "librepro_torch_kernels.so"
# IEEE division and no FMA contraction: the kernels keep the plain
# versions' rounding (an argmin over costs and integer truncations of
# products sit downstream)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signature of every C entry point (c_void_p for each pointer and
# the stream, c_int for each int, c_float for each float), in the order
# of the C prototypes
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "pc_table_predict_launch": (_CI, [_VP] * 10 + [_CF] * 2 + [_CI] * 6
                                + [_VP] * 3),
    "pc_table_update_launch": (_CI, [_VP] * 7 + [_CF] + [_CI] * 4
                               + [_VP] * 2),
    "epoch_fused_launch": (_CI, [_VP, _VP]),
    "epoch_fused_cta_width": (_CI, [_CI] * 3),
    "flash_attention_launch": (_CI, [_VP] * 5 + [_CI] * 10 + [_VP]),
    "flash_attention_bwd_launch": (_CI, [_VP] * 10 + [_CI] * 9 + [_VP]),
    "rwkv_chunk_launch": (_CI, [_VP] * 8 + [_CI] * 7 + [_VP]),
    "ssm_scan_launch": (_CI, [_VP] * 8 + [_CI] * 5 + [_VP]),
    "ssm_scan_bwd_launch": (_CI, [_VP] * 15 + [_CI] * 5 + [_VP]),
    "repro_error_string": (ctypes.c_char_p, [_CI]),
}

_lock = threading.Lock()
_lib = None
# seconds spent by the build that loaded the library in this process
# (0.0 when it was found cached) and nvcc's resource report
BUILD = {"seconds": 0.0, "log": ""}


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{_CSRC} with the CUDA toolkit")


def _build(out_dir: Path) -> Path:
    """Compile every ``.cu`` in parallel, link one shared library into
    ``out_dir`` (atomically: a temp dir renamed into place)."""
    nvcc = _nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=out_dir.parent, prefix=".build-"))
    procs = []
    try:
        cus = [p for p in _sources() if p.suffix == ".cu"]
        procs = [(p, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(p), "-o", str(tmp / f"{p.stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for p in cus]
        log = []
        for p, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {p.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {p.name}:\n{out}")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / _LIB_NAME),
             *(str(tmp / f"{p.stem}.o") for p in cus)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)
        except OSError:  # another process finished the same build first
            pass
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    # repro: waive[REPRO006] _build runs only inside library() under _lock
    BUILD["seconds"] = time.perf_counter() - t0
    return out_dir / _LIB_NAME


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use and loaded once per
    process, with every entry point's ``argtypes``/``restype`` set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = _BUILD_ROOT / _digest()
        path = out_dir / _LIB_NAME
        if not path.exists():
            path = _build(out_dir)
        BUILD["log"] = (out_dir / "build.log").read_text()
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cuda error {code})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    return stream_ptr_of(t.device)


def stream_ptr_of(device: torch.device) -> int:
    """The current CUDA stream of ``device`` (the current device where it
    names no index), as a pointer-sized int, without building a
    ``torch.cuda.Stream`` (a few µs of host time per launch)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
            device: torch.device) -> None:
    """Validate one kernel operand: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
