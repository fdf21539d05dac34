"""Per-epoch hazard linter (port of ``repro.analysis.lint``): an AST pass
with the repo's rules for the ways eager PyTorch code in the epoch loop can
go quietly wrong.

Rules
-----
``REPRO001`` **host sync in per-epoch code**: ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``np.asarray()``/``np.array()``, or
    ``float()``/``int()``/``bool()`` of a value. On the card each one
    waits for the queue to drain, every epoch. Conversions of shapes and
    static values (``int(x.shape[0])``, ``len(...)``, ``x.numel()``,
    constants) are exempt.
``REPRO002`` **Python control flow on a tensor value**: ``if``/``while``/
    ``assert`` whose test calls into ``torch`` or reduces a tensor
    (``.any()``, ``.all()``). The branch syncs with the host and bakes the
    value into the control flow; use ``torch.where``.
``REPRO003`` **numpy computation in per-epoch code**: ``np.`` arithmetic
    on values that should stay on the device (it copies them to the host
    or computes on stale host copies). Dtype constructors and constants
    (``np.float32(...)``, ``np.pi``) are exempt, as is ``np.asarray``
    (reported as REPRO001, the sharper diagnosis).
``REPRO004``, ``REPRO005``: the reference's rules for buffer donation and
    pytree dict order are specific to JAX; they stay in :data:`RULES`,
    marked not applicable, so the rule table stays complete.
``REPRO006`` **unguarded module-level mutable state**: a module-level
    ``dict``/``list``/``set``/``Counter``/``defaultdict`` mutated without
    a surrounding ``with <lock>:`` block. The DVFS service mutates
    sweep-layer counters from dispatch threads.

Per-epoch code
--------------
PyTorch has no ``jit`` marker, so the roots of per-epoch code are named in
:data:`EPOCH_ROOTS`: the bodies made by ``simulate._make_body`` and
``_make_step``, the steps of ``_scan_rows`` and ``_fork_rows_step``, the
predictor/estimator/power functions they call across modules, the
mechanism hooks of ``learn``, and the kernels' plain versions. A function
is per-epoch if it is a root, is passed to ``torch.func.vmap`` (or another
function transform), is nested in a per-epoch function, or is a
same-module function called by name from one (to a fixpoint), as in the
reference.

Waivers
-------
An intentional violation carries an inline waiver naming the rule and a
reason, on the flagged line or the line above::

    n = int(p_blocks)  # repro: waive[REPRO001] p_blocks is a Python int

A file-level waiver (``# repro: waive-file[REPRO003] <reason>``) silences a
rule for the whole file. Waived findings stay in the report with
``waived: true``.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

RULES: Dict[str, str] = {
    "REPRO001": "host sync in per-epoch code (.item()/.cpu()/float() of a "
                "tensor)",
    "REPRO002": "Python if/while/assert on a tensor value",
    "REPRO003": "np. computation in per-epoch code",
    "REPRO004": "not applicable to torch (JAX buffer donation)",
    "REPRO005": "not applicable to torch (JAX pytree dict order)",
    "REPRO006": "module-level mutable state mutated without a lock",
}

# the roots of per-epoch code, by file (relative to the package) and
# qualified function name
EPOCH_ROOTS: Dict[str, Sequence[str]] = {
    "core/simulate.py": ("_make_body.body", "_make_step.body_v2",
                         "_scan_rows.step", "_fork_rows_step.step"),
    "core/predictors.py": ("table_index", "slot_sums", "ema_blend",
                           "table_update", "table_lookup"),
    "core/estimators.py": ("wf_stall_estimate", "cu_estimate"),
    "core/power.py": ("freqs_ghz", "v_of_f", "ivr_eta", "power",
                      "transition_energy", "transition_latency_us"),
    "kernels/epoch_fused.py": ("_epoch_math", "_fork_blocked_math",
                               "_rows_plain", "_rows_blocked_plain"),
    "kernels/ref.py": ("pc_table_predict_ref", "pc_table_update_ref",
                       "attention_ref", "rwkv_chunk_ref"),
    "kernels/flash_attention.py": ("flash_attention_ref",
                                   "flash_attention_bshd_ref"),
    "kernels/rwkv_chunk.py": ("rwkv_chunked_ref", "rwkv_chunked_bthd_ref"),
    "learn/mechanism.py": ("epoch_features", "learned_predict",
                           "learned_update"),
    "learn/models.py": ("predict_targets", "apply_model", "linear_apply",
                        "mlp_apply"),
}

# function transforms whose function-valued arguments run per epoch
_TRANSFORMS = {"vmap", "grad", "jacrev", "jacfwd", "functional_call",
               "compile", "make_fx"}

_HOST_SYNC_CALLS = {"float", "int", "bool", "complex"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}
_STATIC_SRC = (".shape", "len(", "ndim", ".dim(", ".numel(", ".size(")
_NP_HOST_FUNCS = {"asarray", "array"}
# numpy names that are static/constant-producing
_NP_STATIC_OK = {
    "float32", "float64", "float16", "int32", "int64", "int8", "int16",
    "uint8", "uint32", "uint64", "bool_", "dtype", "pi", "e", "inf", "nan",
    "newaxis", "ndim", "shape", "isscalar", "issubdtype", "finfo", "iinfo",
}
# tensor methods whose result in a branch test is a device value
_TENSOR_TESTS = {"any", "all"}
_MUTATING_METHODS = {
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "subtract",
}
_MUTABLE_CTORS = {"dict", "list", "set", "Counter", "OrderedDict",
                  "defaultdict", "deque"}

_WAIVE_RE = re.compile(r"#\s*repro:\s*waive\[([A-Z0-9, ]+)\]")
_WAIVE_FILE_RE = re.compile(r"#\s*repro:\s*waive-file\[([A-Z0-9, ]+)\]")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    msg: str
    context: str = ""          # enclosing function, if any
    waived: bool = False

    def format(self) -> str:
        w = " (waived)" if self.waived else ""
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{w} " \
               f"{self.msg}{ctx}"


def _call_name(node: ast.AST) -> Optional[str]:
    """Terminal name of a call target: ``torch.func.vmap`` -> ``vmap``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost name of an attribute chain: ``np.linalg.norm`` -> ``np``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class _Parents(ast.NodeVisitor):
    """Annotate every node with its parent (ast has no uplinks)."""

    def __init__(self, tree: ast.AST):
        self.parent: Dict[ast.AST, Optional[ast.AST]] = {tree: None}
        self.visit(tree)

    def generic_visit(self, node: ast.AST):
        for child in ast.iter_child_nodes(node):
            self.parent[child] = node
        super().generic_visit(node)


def _enclosing_funcs(node: ast.AST, parents: Dict) -> List[ast.AST]:
    out = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, _FUNC_NODES):
            out.append(cur)
        cur = parents.get(cur)
    return out


def _qualname(f: ast.AST, parents: Dict) -> str:
    encl = [f] + _enclosing_funcs(f, parents)
    return ".".join(g.name for g in reversed(encl)
                    if not isinstance(g, ast.Lambda))


def roots_for(path: str) -> Sequence[str]:
    """The :data:`EPOCH_ROOTS` entry of a file of the package."""
    p = Path(path).as_posix()
    for rel, names in EPOCH_ROOTS.items():
        if p.endswith("repro_torch/" + rel):
            return names
    return ()


def _epoch_functions(tree: ast.Module, parents: Dict,
                     roots: Sequence[str]) -> Set[ast.AST]:
    """The set of function nodes that run per epoch (see module doc)."""
    funcs = [n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)]
    by_name: Dict[str, List[ast.AST]] = {}
    for f in funcs:
        if not isinstance(f, ast.Lambda):
            by_name.setdefault(f.name, []).append(f)

    epoch: Set[ast.AST] = {f for f in funcs if not isinstance(f, ast.Lambda)
                           and _qualname(f, parents) in roots}
    # functions (by name or inline) passed to a function transform
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call) or \
                _call_name(call.func) not in _TRANSFORMS:
            continue
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Lambda):
                epoch.add(arg)
            elif isinstance(arg, ast.Name):
                epoch.update(by_name.get(arg.id, ()))

    # fixpoint: lexical nesting + same-module calls from per-epoch bodies
    while True:
        grew = False
        for f in funcs:
            if f not in epoch and any(
                    e in epoch for e in _enclosing_funcs(f, parents)):
                epoch.add(f)
                grew = True
        for f in list(epoch):
            for call in ast.walk(f):
                if isinstance(call, ast.Call) and \
                        isinstance(call.func, ast.Name):
                    for g in by_name.get(call.func.id, ()):
                        if g not in epoch:
                            epoch.add(g)
                            grew = True
        if not grew:
            return epoch


def _expr_reads_tensor(node: ast.AST) -> bool:
    """Does this expression call into torch or reduce a tensor?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if _root_name(sub.func) == "torch":
                return True
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _TENSOR_TESTS:
                return True
    return False


def _under_lock(node: ast.AST, parents: Dict) -> bool:
    """Is ``node`` inside a ``with <something lock-like>:`` block?"""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, (ast.Name, ast.Attribute)):
                        name = sub.attr if isinstance(sub, ast.Attribute) \
                            else sub.id
                        if "lock" in name.lower():
                            return True
        cur = parents.get(cur)
    return False


def _fn_label(node: ast.AST, parents: Dict) -> str:
    encl = _enclosing_funcs(node, parents)
    names = [f.name for f in reversed(encl) if not isinstance(f, ast.Lambda)]
    return ".".join(names)


@dataclass
class _FileLint:
    path: str
    source: str
    roots: Sequence[str] = ()
    findings: List[Finding] = field(default_factory=list)

    def __post_init__(self):
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.path)
        self.parents = _Parents(self.tree).parent
        self.epoch = _epoch_functions(self.tree, self.parents, self.roots)
        self.file_waivers: Set[str] = set()
        for ln in self.lines:
            m = _WAIVE_FILE_RE.search(ln)
            if m:
                self.file_waivers.update(
                    r.strip() for r in m.group(1).split(","))

    # -- waiver lookup ------------------------------------------------------

    def _line_waivers(self, line: int) -> Set[str]:
        out: Set[str] = set()
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = _WAIVE_RE.search(self.lines[ln - 1])
                if m:
                    out.update(r.strip() for r in m.group(1).split(","))
        return out

    def emit(self, rule: str, node: ast.AST, msg: str):
        waived = rule in self.file_waivers or \
            rule in self._line_waivers(node.lineno)
        self.findings.append(Finding(
            rule, self.path, node.lineno, node.col_offset, msg,
            context=_fn_label(node, self.parents), waived=waived))

    def in_epoch(self, node: ast.AST) -> bool:
        return any(f in self.epoch for f in
                   _enclosing_funcs(node, self.parents))

    # -- the pass -----------------------------------------------------------

    def run(self) -> List[Finding]:
        self._module_state_rule()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and self.in_epoch(node):
                self._call_rules(node)
            elif isinstance(node, (ast.If, ast.While, ast.Assert)) \
                    and self.in_epoch(node):
                self._branch_rule(node)
        return self.findings

    def _call_rules(self, node: ast.Call):
        fn = node.func
        # REPRO001: host conversions and copies
        if isinstance(fn, ast.Name) and fn.id in _HOST_SYNC_CALLS \
                and node.args:
            arg = node.args[0]
            src = ast.unparse(arg)
            if not (isinstance(arg, ast.Constant)
                    or any(s in src for s in _STATIC_SRC)):
                self.emit("REPRO001", node,
                          f"{fn.id}({src}) syncs with the host if the "
                          "operand is a tensor; keep it a tensor or hoist "
                          "it out of the epoch loop")
        if isinstance(fn, ast.Attribute) and fn.attr in _HOST_SYNC_METHODS \
                and _root_name(fn) != "np":
            self.emit("REPRO001", node,
                      f".{fn.attr}() in per-epoch code copies a device "
                      "value to the host and waits for it; keep device "
                      "values on the device")
        if isinstance(fn, ast.Attribute) and _root_name(fn) == "np":
            if fn.attr in _NP_HOST_FUNCS:
                self.emit("REPRO001", node,
                          f"np.{fn.attr}() in per-epoch code copies to the "
                          "host; use torch.as_tensor on the device")
            # REPRO003: numpy compute in per-epoch code
            elif fn.attr not in _NP_STATIC_OK:
                self.emit("REPRO003", node,
                          f"np.{fn.attr} in per-epoch code computes on the "
                          f"host; use torch.{fn.attr} on the device")

    def _branch_rule(self, node):
        test = node.test
        if _expr_reads_tensor(test):
            kind = type(node).__name__.lower()
            self.emit("REPRO002", node,
                      f"Python {kind} on a tensor expression "
                      f"({ast.unparse(test)[:60]}): the branch syncs with "
                      "the host every epoch; use torch.where")

    def _module_state_rule(self):
        # module-level mutable containers...
        mutables: Dict[str, ast.AST] = {}
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            is_mut = isinstance(value, (ast.Dict, ast.List, ast.Set,
                                        ast.DictComp, ast.ListComp,
                                        ast.SetComp)) or (
                isinstance(value, ast.Call)
                and _call_name(value.func) in _MUTABLE_CTORS)
            if not is_mut:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    mutables[t.id] = stmt
        if not mutables:
            return
        # ... mutated anywhere in the module without a lock
        flagged: Set[str] = set()
        for node in ast.walk(self.tree):
            name = None
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATING_METHODS \
                    and isinstance(node.func.value, ast.Name):
                name = node.func.value.id
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in tgts:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name):
                        name = t.value.id
            if name in mutables and name not in flagged \
                    and not _under_lock(node, self.parents):
                flagged.add(name)
                self.emit("REPRO006", node,
                          f"module-level mutable {name!r} mutated "
                          "without a lock: dispatch threads (DVFSService) "
                          "make unlocked read-modify-write lose updates "
                          "— guard with a module Lock or waive if "
                          "provably single-threaded")


def lint_source(source: str, path: str = "<string>",
                roots: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one source string; returns findings (waived ones included,
    marked). ``roots`` names the per-epoch roots (qualified function
    names); the default is the package's :data:`EPOCH_ROOTS` entry for
    ``path``."""
    return _FileLint(path, source,
                     roots_for(path) if roots is None else roots).run()


def lint_paths(paths: Sequence[Path],
               exclude: Iterable[str] = ()) -> List[Finding]:
    """Lint ``.py`` files under the given files/directories."""
    files: List[Path] = []
    for p in map(Path, paths):
        files += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    out: List[Finding] = []
    for f in files:
        if any(x in str(f) for x in exclude):
            continue
        out += lint_source(f.read_text(), str(f))
    return out


def violations(findings: Iterable[Finding]) -> List[Finding]:
    """The findings that should fail a check (un-waived)."""
    return [f for f in findings if not f.waived]
