"""Static checks of the port that need neither JAX nor a card.

* The port (``src/repro_torch``), its examples (``examples_torch``) and
  ``chip_smoke.py`` import neither JAX nor the reference package
  ``repro``: every import statement is checked in the AST.
* The ctypes declarations of the kernel library match the C sources: each
  entry point's parameter count and kinds, and the field order of the
  fused epoch kernel's argument struct (K1-K8). A mismatch would not fail to
  build; it would hand the kernel garbage pointers on the card.
* A program too long for a CTA's shared memory: the code the C entry
  point returns for it is the one the wrapper turns into an error naming
  ``pallas_block_cu`` and the remedy; K7's backward refuses with the
  forward's codes, and checks its operands before the library.
"""
import ast
import ctypes
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import epoch_fused as KEF  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_file_list_is_complete():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = "src/repro_torch/"
    assert {port + f for f in (
        "core/simulate.py", "core/sweep.py", "kernels/epoch_fused.py",
        "kernels/pc_table.py", "interop.py", "configs/__init__.py",
        "configs/base.py", "configs/llama3_405b.py",
        "configs/granite_moe_1b_a400m.py", "dvfs_runtime/telemetry.py",
        "dvfs_runtime/manager.py", "dvfs_runtime/service.py",
        "data/pipeline.py", "kernels/flash_attention.py",
        "kernels/rwkv_chunk.py", "kernels/ssm_scan.py", "kernels/ops.py",
        "models/layers.py", "models/rwkv.py", "models/moe.py",
        "models/ssm.py", "models/model.py",
        "models/__init__.py",
        "launch/serve.py", "launch/train.py", "train/__init__.py",
        "train/train_step.py", "train/checkpoint.py",
        "optim/adamw.py", "launch/input_specs.py", "roofline/work.py",
        "roofline/analysis.py", "roofline/report.py")} \
        | {f"examples_torch/{f}.py" for f in (
            "quickstart", "custom_mechanism", "dvfs_granularity",
            "ivr_regime", "serve_batched", "train_lm")} \
        | {"chip_smoke.py"} <= names


def _c_entry_points():
    """{name: [param kinds]} of every ``extern "C"`` function in csrc."""
    out = {}
    pat = re.compile(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)', re.S)
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in pat.findall(src.read_text()):
            kinds = []
            for p in params.split(","):
                p = p.strip()
                kinds.append("ptr" if "*" in p else "int")
            out[name] = kinds
    return out


def test_ctypes_signatures_match_c_sources():
    c = _c_entry_points()
    assert set(c) == set(K.SIGNATURES)
    assert {"epoch_fused_launch", "epoch_fused_cta_width",
            "flash_attention_launch", "rwkv_chunk_launch",
            "ssm_scan_launch"} <= set(c)
    for name, (_, argtypes) in K.SIGNATURES.items():
        kinds = ["ptr" if t is ctypes.c_void_p else "int" for t in argtypes]
        assert kinds == c[name], name


def test_epoch_args_struct_matches_c_source():
    src = (CSRC / "epoch_fused.cu").read_text()
    body = re.search(r"struct EpochArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = "ptr" if "*" in decl else "int"
        for name in re.sub(r"^(const\s+)?\w+\s*\*?", "", decl).split(","):
            fields.append((name.strip().lstrip("*").strip(), kind))
    py = [(n, "ptr" if t is ctypes.c_void_p else "int")
          for n, t in KEF._EpochArgs._fields_]
    assert py == fields


def test_row_too_wide_code_matches_c_source():
    """The epoch entry point refuses a program a CTA cannot hold with the
    code the wrapper maps to its error, before any launch."""
    src = (CSRC / "epoch_fused.cu").read_text()
    code = int(re.search(r"kRowTooWide = (-?\d+);", src).group(1))
    assert KEF._ROW_TOO_WIDE == code
    assert len(re.findall(r"if \(bytes > \(size_t\)kMaxSmem\) return "
                          r"kRowTooWide;", src)) == 1


@pytest.mark.parametrize("family", ["pc", "reactive", "fork"])
def test_row_too_wide_raises_naming_pallas_block_cu(monkeypatch, family):
    """The entry point's refusal becomes a RuntimeError that names
    ``pallas_block_cu`` with the remedy, and counts no launch."""
    class Lib:
        def epoch_fused_launch(self, *a):
            return KEF._ROW_TOO_WIDE
    monkeypatch.setattr(KEF, "library", Lib)
    monkeypatch.setattr(KEF, "stream_ptr_of", lambda dev: 0)
    before = dict(KEF.epoch_fused.launches_by_family)
    args = KEF._EpochArgs(CU=304, WF=40, Pp=1024)
    with pytest.raises(RuntimeError, match="pallas_block_cu") as err:
        KEF._run_kernel(args, None, family)
    assert "304 CUs x 40 WFs over 1024 program blocks" in str(err.value)
    assert KEF._TOO_WIDE_HINT in str(err.value)
    assert KEF.epoch_fused.launches_by_family == before


def test_rwkv_too_large_code_matches_c_source():
    """K7's entry point refuses a chunk one CTA cannot hold with the code
    the wrapper turns into its error."""
    from repro_torch.kernels import rwkv_chunk as RC
    src = (CSRC / "rwkv_chunk.cu").read_text()
    assert RC._TOO_LARGE == int(
        re.search(r"kTooLarge = (-?\d+);", src).group(1))


def test_rwkv_bwd_codes_match_c_sources():
    """K7's backward entry point refuses a chunk one CTA cannot hold and a
    head dim it has no kernel for with the forward's codes, the ones the
    wrapper turns into its errors."""
    from repro_torch.kernels import rwkv_chunk as RC
    for name in ("rwkv_chunk.cu", "rwkv_chunk_bwd.cu"):
        src = (CSRC / name).read_text()
        assert RC._TOO_LARGE == int(
            re.search(r"kTooLarge = (-?\d+);", src).group(1)), name
        assert RC._BAD_HEAD_DIM == int(
            re.search(r"kBadHeadDim = (-?\d+);", src).group(1)), name


@pytest.mark.parametrize("code,match", [("_TOO_LARGE", "shared memory"),
                                        ("_BAD_HEAD_DIM", "head dims 16")])
def test_rwkv_bwd_refusal_raises_and_counts_no_launch(monkeypatch, code,
                                                      match):
    """The backward entry point's refusal (nothing launched) becomes a
    ValueError and counts no launch; the entry point gets its 24
    arguments."""
    import torch

    from repro_torch.kernels import rwkv_chunk as RC
    seen = []

    class Lib:
        def rwkv_chunk_bwd_launch(self, *a):
            seen.append(len(a))
            return getattr(RC, code)
    monkeypatch.setattr(RC, "library", Lib)
    monkeypatch.setattr(RC, "stream_ptr", lambda t: 0)
    r = torch.zeros((1, 32, 2, 16))
    n = RC.rwkv_chunked_bthd_bwd.launches
    with pytest.raises(ValueError, match=match):
        RC._bwd_launch(r, r, r, r, torch.zeros((2, 16)), r, None, 16)
    assert seen == [len(K.SIGNATURES["rwkv_chunk_bwd_launch"][1])] == [24]
    assert RC.rwkv_chunked_bthd_bwd.launches == n


def test_rwkv_bwd_checks_operands_before_the_library(monkeypatch):
    """Operands the kernel does not take raise in the wrapper before the
    library is asked for anything (``meta`` tensors take the card's
    checks)."""
    import torch

    from repro_torch.kernels import rwkv_chunk as RC

    def library():
        raise AssertionError("the library was reached")
    monkeypatch.setattr(RC, "library", library)

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    r, u, gy = m(2, 32, 2, 16), m(2, 16), m(2, 32, 2, 16)
    n = RC.rwkv_chunked_bthd_bwd.launches
    for args, match in (
            ((r, r, r, r, u, m(2, 32, 2, 16, dtype=torch.float64)),
             "gy: dtype"),
            ((r, r, r, r, u, gy, m(2, 2, 16, 8)), "gS: shape"),
            ((r, r, r, r, m(3, 16), gy), "u: "),
            ((r, r, m(2, 32, 2, 8), r, u, gy), "v: shape"),
            ((r.transpose(1, 2).contiguous().transpose(1, 2), r, r, r, u,
              gy), "r: must be contiguous")):
        with pytest.raises(ValueError, match=match):
            RC.rwkv_chunked_bthd_bwd(*args)
    assert RC.rwkv_chunked_bthd_bwd.launches == n


def test_flash_attention_limits_match_c_source():
    """The head dims K6 is instantiated for and its largest key block, as
    the wrapper checks them before a launch; the head dims of K6's
    backward (its ``launch_hd`` switch and its entry point's check) are
    the same."""
    from repro_torch.kernels import flash_attention as FA
    src = (CSRC / "flash_attention.cu").read_text()
    assert FA.HEAD_DIMS == tuple(int(x) for x in
                                 re.findall(r"case (\d+):", src))
    assert FA.MAX_BLK_K == int(re.search(r"kMaxBlkK = (\d+);", src)
                               .group(1))
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert FA.HEAD_DIMS == tuple(int(x) for x in
                                 re.findall(r"case (\d+):", bwd))
    entry = bwd[bwd.index('extern "C" int flash_attention_bwd_launch'):]
    assert FA.HEAD_DIMS == tuple(int(x) for x in
                                 re.findall(r"hd != (\d+)", entry))


def test_ssm_scan_limits_match_c_source():
    """The head dims and state sizes K8 is instantiated for, as the
    wrapper checks them before a launch: the state sizes are the entry
    point's switch, the head dims ``launch_hd``'s."""
    from repro_torch.kernels import ssm_scan as SS
    src = (CSRC / "ssm_scan.cu").read_text()
    entry = src[src.index('extern "C" int ssm_scan_launch'):]
    hd_switch = src[src.index("int launch_hd("):src.index("}  // namespace")]
    assert SS.STATE_SIZES == tuple(int(x) for x in
                                   re.findall(r"case (\d+):", entry))
    assert SS.HEAD_DIMS == tuple(int(x) for x in
                                 re.findall(r"case (\d+):", hd_switch))


def test_ssm_scan_fwd_chunk_matches_c_source():
    """K8's token chunk as the wrapper sizes its scratch by it: the
    forward source's ``kChunk``, and the entry point's note of it."""
    from repro_torch.kernels import ssm_scan as SS
    src = (CSRC / "ssm_scan.cu").read_text()
    assert SS.FWD_CHUNK == int(re.search(r"kChunk = (\d+);", src).group(1))
    assert f"nc = ceil(S / {SS.FWD_CHUNK})" in src


def test_ssm_scan_bwd_limits_match_c_source():
    """The K8 backward's head dims, state sizes and token chunk, as the
    wrapper checks and sizes them before a launch: the state sizes are
    the entry point's switch, the head dims ``launch_hd``'s, the chunk
    its ``kChunk`` (the chain arrays' spacing)."""
    from repro_torch.kernels import ssm_scan as SS
    src = (CSRC / "ssm_scan_bwd.cu").read_text()
    entry = src[src.index('extern "C" int ssm_scan_bwd_launch'):]
    hd_switch = src[src.index("int launch_hd("):src.index("}  // namespace")]
    assert SS.STATE_SIZES == tuple(int(x) for x in
                                   re.findall(r"case (\d+):", entry))
    assert SS.HEAD_DIMS == tuple(int(x) for x in
                                 re.findall(r"case (\d+):", hd_switch))
    assert SS.BWD_CHUNK == int(re.search(r"kChunk = (\d+);", src).group(1))
