"""Static checks of the port that need neither JAX nor a card.

* The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX
  nor the reference package ``repro``: every import statement is checked
  in the AST.
* The ctypes declarations of the kernel library match the C sources: each
  entry point's parameter count and kinds, and the field order of the
  fused epoch kernel's argument struct. A mismatch would not fail to
  build; it would hand the kernel garbage pointers on the card.
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
    + [ROOT / "chip_smoke.py"]
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
    names = {p.name for p in PORT_FILES}
    assert {"simulate.py", "sweep.py", "epoch_fused.py", "pc_table.py",
            "interop.py", "chip_smoke.py"} <= names


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
