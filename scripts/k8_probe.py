"""The selective-scan kernel (K8) at hymba-1.5b's layouts: its chunk length
and thread split, and another checkout's K8 in turns.

    PYTHONPATH=src python3 scripts/k8_probe.py [--ab OTHER_CSRC] [--trace]
        [--sass LISTING]

Builds ``src/repro_torch/kernels/csrc/ssm_scan.cu`` as it is
(``shipped``) and variants of it with ``nvcc`` (the library's own flags),
one shared library each, all compiled together into a temporary
directory under ``build/``:

* ``chunk32`` / ``chunk64`` / ``chunk128`` x ``threads1`` / ``threads2``:
  the chunk of tokens each CTA walks (``kChunk``) and the threads per
  channel (``groups``: one thread holding the channel's N states, or two
  of N / 2 whose y halves an xor shuffle joins);
* ``unroll4`` / ``unroll16``: the walking loops unrolled by 4 or 16
  tokens (shipped 8);
* ``unfused_y`` / ``tree_y``: y's sum over the states with each term
  rounded before its add (the shipped sum fuses each term into it, in
  state order), or as a pairwise tree of rounded terms;
* ``no_store``, ``no_c_loads``, ``no_walk`` and ``no_copies`` take a part
  away (y summed but not written; C's shared-memory loads, B read in
  their place; the outputs launch's walk, y = x + C; the copies of x, B
  and C into shared memory, the walks running on what it holds) and give
  wrong output; only their time is read;

and, with ``--ab``, another checkout's ``ssm_scan.cu`` and its headers
(a directory of csrc, e.g. a parent unpacked with ``git archive`` under
``build/``; either form of the entry point: the one-CTA-per-(batch,
head) kernel before the chunked form, or the chunked one with its
scratch).

At a hymba-1.5b decode step (B 4, S 1), its prefill (B 4, S 2048) and its
training layout (B 4, S 4096; 25 heads of 64, state 16, f32, a non-zero
h0, from a numpy seed) each build is held against ``ssm_scan_ref`` (max
abs error, and within 1e-4 + 1e-5 |ref|), then timed by
``scripts/devtime.py``'s method in turns: other, shipped, the variants,
then the same in reverse, so each has two readings around the others;
each build of this tree is also split by its three launches
(torch.profiler, ``devtime.kernel_means``), and x copied by torch (read
and written once) gives the card's practical rate for that traffic.
Prints nvcc's report (registers, spills) of the shipped kernels at head
dim 64 and state 16, the CTAs of each launch resident on one SM for
every build of this tree
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), every time with the
card's name and power limit. With ``--sass`` it also prints the shipped
launches' SASS (``cuobjdump``): instructions in all and by opcode, and
writes their listing to the file it names. With ``--trace`` it builds a
copy of the source whose increments and outputs launches stamp, for each
CTA, its SM and the SM clock (as it starts, once its chunk has landed,
as thread 0 is done), runs it once at the training layout, and prints
the mean cycles of each CTA's wait and walk, the CTAs an SM held at once
and its busy span.
"""
from __future__ import annotations

import argparse
import ctypes
import re
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
LAYOUTS = {"decode": (4, 1, 25, 64, 16), "prefill": (4, 2048, 25, 64, 16),
           "train": (4, 4096, 25, 64, 16)}
RTOL, ATOL = 1e-5, 1e-4

_CHUNK = re.compile(r"constexpr int kChunk = \d+;")
_GROUPS = "constexpr int groups() { return HD >= 32 ? 1 : 2; }"
# variant -> (pattern, new) source edits
VARIANTS = {f"chunk{L}_threads{G}": [
    (_CHUNK, f"constexpr int kChunk = {L};"),
    (re.compile(re.escape(_GROUPS)),
     f"constexpr int groups() {{ return {G}; }}")]
    for L in (32, 64, 128) for G in (1, 2)}
_YSUM = ("    float p = st[0] * cv[0];\n"
         "#pragma unroll\n"
         "    for (int j = 1; j < NP; ++j) p = __fmaf_rn(st[j], cv[j], p);\n")
_UNROLL_INC = "#pragma unroll 8\n  for (int t = 0; t < kChunk; ++t) step"
_UNROLL_OUT = "#pragma unroll 8\n  for (int t = 0; t < nt; ++t) {"
VARIANTS.update({
    # the walking loops unrolled by 4 or 16 tokens (shipped 8)
    **{f"unroll{u}": [(re.compile(re.escape(_UNROLL_INC)),
                       _UNROLL_INC.replace("unroll 8", f"unroll {u}")),
                      (re.compile(re.escape(_UNROLL_OUT)),
                       _UNROLL_OUT.replace("unroll 8", f"unroll {u}"))]
       for u in (4, 16)},
    # y's sum over the states: each term rounded before its add (the
    # shipped sum fuses them), or a pairwise tree (a chain of log2 NP
    # adds, not NP - 1)
    "unfused_y": [(re.compile(re.escape(_YSUM)), _YSUM.replace(
        "p = __fmaf_rn(st[j], cv[j], p)", "p = p + st[j] * cv[j]"))],
    "tree_y": [(re.compile(re.escape(_YSUM)),
                "    float pr[NP];\n"
                "#pragma unroll\n"
                "    for (int j = 0; j < NP; ++j) pr[j] = st[j] * cv[j];\n"
                "#pragma unroll\n"
                "    for (int w = 1; w < NP; w <<= 1)\n"
                "#pragma unroll\n"
                "      for (int j = 0; j + w < NP; j += 2 * w) "
                "pr[j] = pr[j] + pr[j + w];\n"
                "    float p = pr[0];\n")]})
# parts taken away (wrong output; only the time is read): y computed but
# not written (a test the data never passes keeps its sum alive)
_STORE = "    if (g == 0) yp[(size_t)t * H * HD] = p;\n"
_CLOAD = "    ld4<NP>(cc + t * N, cv);\n"
REMOVALS = {"no_store": [(re.compile(re.escape(_STORE)),
                          "    if (g == 0 && p == 1234.5f) "
                          "yp[(size_t)t * H * HD] = p;\n")],
            # y from the state and B in place of C: C's shared-memory
            # loads taken away
            "no_c_loads": [(re.compile(re.escape(_CLOAD)),
                            "    ld4<NP>(sm + L::kB + t * N + g * NP, "
                            "cv);\n")],
            # the outputs launch's walk taken away (y = x + C[0], the copies
            # and stores kept): its memory alone
            "no_walk": [(re.compile(re.escape(
                "    step<HD, N, NP>(sm, t, d, g, st);\n    float cv[NP];\n")
                + r".*?p \+= __shfl_xor_sync\(FULL_MASK, p, m\);\n",
                re.S), "    float p = sm[L::kX + t * HD + d] + cc[t * N];\n")],
            # both walking launches' copies of x, B and C taken away (the
            # walks run on what shared memory holds): their compute and
            # stores alone
            "no_copies": [(re.compile(re.escape(
                "    cp16(sm + L::kX + t * HD + 4 * p, x + ((row + t) * H + "
                "h) * HD + 4 * p);\n")),
                "    if (H < 0) cp16(sm + L::kX + t * HD + 4 * p, x);\n"),
                (re.compile(re.escape(
                    "    cp16(sm + L::kB + t * N + 4 * p, Bm + (row + t) * N "
                    "+ 4 * p);\n")),
                 "    if (H < 0) cp16(sm + L::kB + t * N + 4 * p, Bm);\n"),
                (re.compile(re.escape(
                    "      cp16(sm + L::kC + t * N + 4 * p, Cm + (row + t) * "
                    "N + 4 * p);\n")),
                 "      if (H < 0) cp16(sm + L::kC + t * N + 4 * p, Cm);\n")]}
# appended to each build of this tree: the CTAs of each launch resident on
# one SM at head dim 64, state 16, as the launcher sizes them
OCCUPANCY = """
extern "C" int k8_occupancy(int* out) {
  using L = Chunk<64, 16>;
  constexpr int kT = threads<64>();
  cudaError_t e = smem_limit(ssm_scan_fwd_increments<64, 16>,
                             sizeof(float) * L::kC);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, ssm_scan_fwd_increments<64, 16>, kT, sizeof(float) * L::kC);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, ssm_scan_fwd_chains, kChainThreads, 0);
  if (e == cudaSuccess)
    e = smem_limit(ssm_scan_fwd_outputs<64, 16>, sizeof(float) * L::kEnd);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, ssm_scan_fwd_outputs<64, 16>, kT, sizeof(float) * L::kEnd);
  return (int)e;
}
"""
LAUNCHES = ("ssm_scan_fwd_increments", "ssm_scan_fwd_chains",
            "ssm_scan_fwd_outputs")
# --trace: edits of the shipped source that stamp, per CTA of the
# increments (slot 0) and outputs (slot 1) launches, its SM and the SM
# clock as it starts, once its chunk has landed, and as thread 0 is done
_STAMP = "k8_stamp(%d, blockIdx.x, %d);\n"
TRACE_MAX_CTAS = 16384
TRACE_HEAD = """
__device__ long long k8_stamps[2][%d][4];
__device__ __forceinline__ void k8_stamp(int slot, int cta, int at) {
  if (threadIdx.x == 0 && cta < %d) {
    if (at == 1) {
      unsigned smid;
      asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(smid));
      k8_stamps[slot][cta][0] = smid;
    }
    k8_stamps[slot][cta][at] = clock64();
  }
}
""" % (TRACE_MAX_CTAS, TRACE_MAX_CTAS)
TRACE_TAIL = """
extern "C" int k8_stamps_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k8_stamps, sizeof(k8_stamps));
}
"""
TRACE = [
    ("template <int HD, int N>\n"
     "__global__ void __launch_bounds__(threads<HD>())\n"
     "ssm_scan_fwd_increments(", TRACE_HEAD, "before"),
    ("  const int c = blk % nk, bh = blk / nk, b = bh / H, h = bh % H;\n",
     "  " + _STAMP % (0, 1), "after"),
    ("  float st[NP];\n#pragma unroll\n  for (int j = 0; j < NP; ++j) "
     "st[j] = 0.f;\n", "  " + _STAMP % (0, 2), "before"),
    ("  if (tid == 0) {\n    float p = 1.f;\n", "  " + _STAMP % (0, 3),
     "before"),
    ("  const int t0 = c * kChunk, nt = min(kChunk, S - t0);\n",
     "  " + _STAMP % (1, 1), "before"),
    ("  const float* cc = sm + L::kC + g * NP;\n", "  " + _STAMP % (1, 2),
     "before"),
    ("  if (c == nc - 1) st4<NP>(h_out", "  " + _STAMP % (1, 3), "before"),
]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def sources(other: Path | None, trace: bool = False) -> dict:
    """{build: (csrc directory of its headers, ssm_scan.cu's text)}."""
    src = (CSRC / "ssm_scan.cu").read_text()
    out = {"shipped": (CSRC, src + OCCUPANCY)}
    for name, edits in {**VARIANTS, **REMOVALS}.items():
        text = src
        for pat, new in edits:
            text, n = pat.subn(new, text)
            if n != 1:
                raise RuntimeError(f"variant {name}: {pat.pattern!r} "
                                   f"matched {n} times")
        out[name] = (CSRC, text + OCCUPANCY)
    if other is not None:
        out["other"] = (other, (other / "ssm_scan.cu").read_text())
    if trace:
        out["traced"] = (CSRC, traced_source())
    return out


def build(tmp: Path, srcs: dict) -> dict:
    """{build: (entry point, its source, nvcc's report)}, all compiled
    together."""
    procs = {}
    for name, (hdrs, text) in srcs.items():
        d = tmp / name
        d.mkdir()
        for h in hdrs.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "ssm_scan.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "ssm_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (ctypes.CDLL(str(tmp / name / "lib.so")),
                     srcs[name][1], log)
    return out


def entry(lib, src: str, args):
    """A call of a build's ``ssm_scan_launch`` on ``args`` (xh, dt, B_,
    C_, A, h0), writing (y, h_out): the one-kernel form (eight pointers)
    or the chunked one (ten: its scratch sized by the source's
    ``kChunk``, allocated here once)."""
    proto = re.search(r'extern "C" int ssm_scan_launch\((.*?)\)', src,
                      re.S).group(1)
    ptrs = proto.count("*") - 1             # the last is the stream
    fn = lib.ssm_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    xh, h0 = args[0], args[5]
    B, S, H, hd = xh.shape
    N = args[2].shape[-1]
    y, h_out = torch.empty_like(xh), torch.empty_like(h0)
    scratch = []
    if ptrs == 10:
        chunk = int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))
        nk = -(-S // chunk) - 1
        scratch = [torch.empty((B * H, nk, hd, N), device=xh.device),
                   torch.empty((B * H, nk), device=xh.device)]
    ptr_args = [t.data_ptr() for t in (*args, *scratch, y, h_out)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        code = fn(*ptr_args, B, S, H, hd, N, stream)
        if code:
            raise RuntimeError(f"ssm_scan_launch: cuda error {code}")
        return y, h_out
    return call


def traced_source() -> str:
    """The shipped source with the ``--trace`` stamps."""
    text = (CSRC / "ssm_scan.cu").read_text()
    for anchor, add, where in TRACE:
        if text.count(anchor) != 1:
            raise RuntimeError(f"trace anchor not found once: {anchor!r}")
        text = text.replace(anchor, add + anchor if where == "before"
                            else anchor + add)
    return text + TRACE_TAIL


def trace(lib, src: str, args, name: str) -> None:
    """One traced call at ``args``: per launch, each CTA's SM cycles from
    its start to its chunk landing (the wait) and from there to thread 0
    being done (the walk), how many CTAs an SM held at once on average
    (the sum of their spans over the SM's busy span), and that span."""
    call = entry(lib, src, args)
    call()
    torch.cuda.synchronize()
    buf = np.zeros((2, TRACE_MAX_CTAS, 4), dtype=np.int64)
    code = lib.k8_stamps_read(ctypes.c_void_p(buf.ctypes.data))
    if code:
        raise RuntimeError(f"k8_stamps_read: cuda error {code}")
    B, S, H, _ = args[0].shape
    nc = -(-S // SS.FWD_CHUNK)
    for slot, launch, n in ((0, "increments", B * H * (nc - 1)),
                            (1, "outputs", B * H * nc)):
        st = buf[slot, :n]
        wait, walk = st[:, 2] - st[:, 1], st[:, 3] - st[:, 2]
        held, spans = [], []
        for sm in np.unique(st[:, 0]):
            on = st[st[:, 0] == sm]
            spans.append(on[:, 3].max() - on[:, 1].min())
            held.append((on[:, 3] - on[:, 1]).sum() / max(spans[-1], 1))
        print(f"k8_probe trace {launch} (SM cycles, {n} CTAs): wait for "
              f"the chunk mean {wait.mean():.0f} (p90 "
              f"{np.percentile(wait, 90):.0f}), walk mean {walk.mean():.0f} "
              f"(p90 {np.percentile(walk, 90):.0f}); CTAs held per SM "
              f"{np.mean(held):.2f}, busy span per SM {np.mean(spans):.0f} "
              f"(max {np.max(spans)}) over {len(held)} SMs on {name}",
              flush=True)


def report(log: str) -> None:
    """nvcc's registers and spills of the three launches at head dim 64,
    state 16."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(ssm_scan_fwd_(?:"
                      r"increments|outputs)(?=ILi64ELi16E)|"
                      r"ssm_scan_fwd_chains)", line)
        if m:
            name = m.group(1)
            continue
        if name and ("registers" in line or "spill" in line):
            print(f"  {name}: {line.strip()}", flush=True)
            if "registers" in line:
                name = None


def sass(lib_path: Path, listing: Path) -> None:
    """The shipped launches' SASS at head dim 64, state 16
    (``cuobjdump -sass``): instructions in all and by opcode; the three
    functions' listing written to ``listing``."""
    import collections
    import shutil
    tool = shutil.which("cuobjdump") or str(
        Path(K._nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    name, ops, kept = None, collections.Counter(), []

    def flush():
        if name:
            print(f"  {name}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common(16)),
                  flush=True)
    for line in out.splitlines():
        m = re.search(r"Function : \S*?(ssm_scan_fwd_(?:increments|outputs)"
                      r"(?=ILi64ELi16E)|ssm_scan_fwd_chains|"
                      r"(?=Function))", line)
        if "Function :" in line:
            flush()
            name, ops = (m.group(1) or None) if m else None, \
                collections.Counter()
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                        line)
        if name and ins:
            ops[ins.group(1).split(".")[0]] += 1
        if name:
            kept.append(line)
    flush()
    listing.parent.mkdir(parents=True, exist_ok=True)
    listing.write_text("\n".join(kept) + "\n")
    print(f"  the listing: {listing}", flush=True)


def case(B, S, H, hd, N, dev, seed=48):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, S, H, hd)),
            rng.uniform(0.01, 1.5, (B, S, H)),
            rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
            -rng.uniform(0.2, 2.0, H),
            rng.standard_normal((B, H, hd, N)) * 0.5)
    return [torch.as_tensor(a.astype(np.float32)).to(dev) for a in arrs]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", type=Path, default=None,
                    help="another checkout's kernels/csrc directory")
    ap.add_argument("--trace", action="store_true",
                    help="also trace the shipped launches' CTAs")
    ap.add_argument("--sass", type=Path, default=None, metavar="LISTING",
                    help="also count the shipped launches' SASS and write "
                         "their listing to LISTING")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = card()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build(Path(tmp), sources(opts.ab, opts.trace))
        print(f"nvcc's report of the shipped K8 (FWD_CHUNK "
              f"{SS.FWD_CHUNK}):", flush=True)
        report(libs["shipped"][2])
        if opts.sass:
            sass(Path(tmp) / "shipped" / "lib.so", opts.sass)
        for b, (lib, _, _) in libs.items():
            if b in ("other", "traced"):
                continue
            occ = (ctypes.c_int * 3)()
            code = lib.k8_occupancy(occ)
            if code:
                raise RuntimeError(f"{b}: k8_occupancy cuda error {code}")
            print(f"k8_probe {b}: CTAs resident per SM at hd 64, N 16: "
                  + ", ".join(f"{n} {v}" for n, v in zip(LAUNCHES, occ))
                  + f" on {name}", flush=True)
        if opts.trace:
            trace(libs["traced"][0], libs["traced"][1],
                  case(*LAYOUTS["train"], dev), name)
        order = (["other"] if opts.ab else []) + ["shipped", *VARIANTS,
                                                   *REMOVALS]
        for key, shape in LAYOUTS.items():
            args = case(*shape, dev)
            y_ref, h_ref = SS.ssm_scan_ref(*args)
            calls = {b: entry(libs[b][0], libs[b][1], args) for b in order}
            for b in order:
                y, h = calls[b]()
                torch.cuda.synchronize()
                err = max(float((y - y_ref).abs().max()),
                          float((h - h_ref).abs().max()))
                ok = all(bool(((g - w).abs() <= ATOL + RTOL * w.abs()).all())
                         for g, w in ((y, y_ref), (h, h_ref)))
                if b not in REMOVALS:
                    print(f"k8_probe {b} at {key} {shape}: max abs err "
                          f"{err:.3e} ({'within' if ok else 'PAST'} 1e-4 "
                          f"+ 1e-5 |ref|)", flush=True)
            times = {b: [] for b in order}
            for b in order + order[::-1]:
                times[b].append(DT.device_ms(calls[b]))
            for b in order:
                print(f"k8_probe {b} at {key} (B, S, H, hd, N) {shape}: "
                      + " / ".join("refused" if t is None else f"{t * 1e3:.2f}"
                                   for t in times[b])
                      + f" us per call (device, in turns) on {name}",
                      flush=True)
            for b in order:
                if b == "other":
                    continue
                split = DT.kernel_means(calls[b], LAUNCHES, reps=20)
                print(f"k8_probe {b} at {key} by launch (profiler): "
                      + ", ".join(f"{n} {m * 1e3:.2f} us ({c})"
                                  for n, (m, c) in split.items()
                                  if m is not None) + f" on {name}",
                      flush=True)
            # the card's practical rate for this much traffic: x copied
            # into a tensor of its shape by torch (read once, written once)
            out = torch.empty_like(args[0])
            ms = DT.device_ms(lambda: out.copy_(args[0]))
            mb = 2 * args[0].numel() * 4 / 1e6
            print(f"k8_probe copy of x at {key}: {ms * 1e3:.2f} us for "
                  f"{mb:.1f} MB read and written, {mb / 1e3 / ms:.2f} TB/s "
                  f"on {name}", flush=True)
            del args, y_ref, h_ref, calls, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
