"""Where the selective-scan kernel (K8) spends its time: other splits of a
channel's state over threads, and parts taken away.

    PYTHONPATH=src python3 scripts/k8_probe.py

Builds variants of ``src/repro_torch/kernels/csrc/ssm_scan.cu`` with
``nvcc`` (the library's own flags) into a temporary directory under
``build/``, one shared library each, all compiled together, and times
each at the hymba-1.5b prefill (B 4, S 2048, 25 heads of 64, state 16,
f32) by ``scripts/devtime.py``'s method, in turns (shipped, variants...,
shipped), on one CUDA card:

* ``shipped``: the source as it is (one thread per channel holding its
  N states, the y sum in state order);
* ``four_per_channel`` (N / 4 states a thread, the partial y sums joined
  by two xor shuffles: 800 warps at this shape, not 200) and
  ``two_per_channel`` (N / 2, one shuffle) split a channel's state over
  more threads; ``one_tree`` sums y as a pairwise tree (a chain of log2 N
  adds, not N - 1);
* ``no_store`` (y is computed but not written) takes one part away and
  gives wrong output; only its time is read.

Prints each variant's device µs per call (the shipped kernel first and
last), the right variants' max abs error against ``ssm_scan_ref``, and
the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import devtime as DT  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
B, S, H, HD, N = 4, 2048, 25, 64, 16

_GROUPS = "constexpr int groups() { return HD >= 32 ? 1 : 2; }"
_STORE = "      if (g == 0) yp[(size_t)t * H * HD] = p;\n"
_SUM = ("      float p = st[0] * cv[0];\n"
        "#pragma unroll\n"
        "      for (int j = 1; j < NP; ++j) p = p + st[j] * cv[j];\n")
_TREE = ("      float q[NP];\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < NP; ++j) q[j] = st[j] * cv[j];\n"
         "#pragma unroll\n"
         "      for (int w = 1; w < NP; w <<= 1)\n"
         "#pragma unroll\n"
         "        for (int j = 0; j + w < NP; j += 2 * w) q[j] = q[j] + q[j + w];\n"
         "      float p = q[0];\n")
# variant -> (old, new) text replacements in ssm_scan.cu
VARIANTS = {
    "shipped": [],
    "four_per_channel": [(_GROUPS, "constexpr int groups() { return 4; }")],
    "two_per_channel": [(_GROUPS, "constexpr int groups() { return 2; }")],
    "one_tree": [(_SUM, _TREE)],
    # a test the data never passes keeps y's computation alive
    "no_store": [(_STORE, "      if (g == 0 && p == 1234.5f) "
                          "yp[(size_t)t * H * HD] = p;\n")],
}
RIGHT = ("shipped", "four_per_channel", "two_per_channel", "one_tree")


def build(tmp: Path) -> dict:
    src = (CSRC / "ssm_scan.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once: "
                                   f"{old!r}")
            text = text.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "ssm_scan.cu").write_text(text)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "ssm_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        fn = ctypes.CDLL(str(tmp / name / "lib.so")).ssm_scan_launch
        fn.restype, fn.argtypes = K.SIGNATURES["ssm_scan_launch"]
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(48)
    arrs = (rng.standard_normal((B, S, H, HD)), rng.uniform(0.01, 1.5,
                                                            (B, S, H)),
            rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
            -rng.uniform(0.2, 2.0, H), rng.standard_normal((B, H, HD, N))
            * 0.5)
    xh, dt, Bm, Cm, A, h0 = (torch.as_tensor(a.astype(np.float32)).to(dev)
                             for a in arrs)
    y_ref, h_ref = SS.ssm_scan_ref(xh, dt, Bm, Cm, A, h0)
    stream = torch.cuda.current_stream().cuda_stream
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build(Path(tmp))
        y = torch.empty_like(xh)
        h = torch.empty_like(h0)

        def run(name):
            code = libs[name](xh.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                              Cm.data_ptr(), A.data_ptr(), h0.data_ptr(),
                              y.data_ptr(), h.data_ptr(), B, S, H, HD, N,
                              stream)
            if code:
                raise RuntimeError(f"{name}: cuda error {code}")

        times = {}
        for name in list(VARIANTS) + ["shipped"]:
            times.setdefault(name, []).append(
                DT.device_ms(lambda: run(name)))
        for name in VARIANTS:
            line = f"k8_probe {name}: " + " / ".join(
                "refused" if t is None else f"{t * 1e3:.2f}"
                for t in times[name]) + " us per call (device)"
            if name in RIGHT:
                run(name)
                torch.cuda.synchronize()
                err = max(float((y - y_ref).abs().max()),
                          float((h - h_ref).abs().max()))
                line += f", max abs err {err:.3e}"
            print(line + f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
