"""Source AST linter: host-sync and tensor-branch hazards in the port's
step-reachable code (port of ``repro/analysis/lint.py``).

Rules (ids are stable: they key the baseline ratchet):

  host-sync (P1)
      ``.item()``/``.cpu()``/``.tolist()``/``.numpy()`` method calls,
      ``torch.cuda.synchronize()`` and ``<event or stream>.synchronize()``,
      ``np.asarray``/``np.array`` calls, and ``int(...)``/``float(...)``/
      ``bool(...)`` whose argument contains a ``torch.`` call: each blocks
      the host on device work. Inside a captured step they either fail
      the capture or (in host-side driver loops) serialize the pipeline.
      The serving discipline allows exactly the documented fetches, which
      carry a justification marker (below).

  tensor-branch (P2)
      ``if``/``while`` whose test calls a ``torch.`` function or a tensor
      method ``.any()``/``.all()``: Python control flow on a device value
      waits for the device, and a captured graph freezes one branch.
      Shape, dtype, device and ``is_cuda`` metadata and the host-side
      queries of torch (``torch.is_tensor``, ``torch.cuda.is_available``,
      any ``torch.*.is_*``/``get_*``) are static and exempt.

  docstring-missing (P3)
      a public function/class reachable from the export surfaces
      (``repro_torch.api``, ``repro_torch.hw``) without a docstring:
      these two modules ARE the documented API; an undocumented export
      is a docs bug, ratcheted like any other finding
      (:func:`docstring_findings`, a separate whole-surface pass).

The reference's ``static-arg-hazard`` and ``dataclass-unregistered``
rules are left out: they concern ``jax.jit``'s static arguments and
pytree registration, and torch has neither (a captured step takes its
inputs as static tensors, and any Python object crosses it).

Suppression, *at the offending line* (same line or the line above),
with a justification::

    toks = toks.cpu().numpy()  # analysis: host-sync ok -- the one documented fetch per decode step

The marker is rule-scoped (``# analysis: <rule-id> ok``); a lint
finding without a marker is a real finding, and an unused marker costs
nothing. Scanned packages are the step-reachable ones
(:data:`TRACED_PACKAGES`); launch/, configs/, hw/, data/ and analysis/
itself are host-side by design and excluded.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, List, Tuple

from repro_torch.analysis.op_audit import Finding

#: packages under src/repro_torch whose code a serving or training step
#: reaches (the reference's jit-reachable set)
TRACED_PACKAGES = (
    "core", "models", "kernels", "serve", "quant", "dist", "train", "optim",
    "profile",
)

_SUPPRESS_RE = re.compile(r"#\s*analysis:\s*([a-z0-9-]+)\s+ok\b")

#: attribute-call names (no arguments) that block on device values
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "synchronize")
#: numpy-module functions that force a device->host copy
_NP_SYNC_FUNCS = ("asarray", "array")
#: tensor methods whose value a branch would wait for
_BRANCH_METHODS = ("any", "all")
#: metadata attributes and host-side torch queries (never device values)
_STATIC_ATTRS = {
    "ndim", "shape", "size", "dtype", "device", "is_cuda", "dim", "numel",
    "element_size", "device_count", "current_device", "Size", "finfo", "iinfo",
    "get_device_name", "manual_seed",
}

#: severity ladder: P1 = contract violation / correctness-adjacent,
#: P2 = performance or tracing hazard, P3 = hygiene / informational
_SEVERITY = {
    "host-sync": "P1",
    "tensor-branch": "P2",
    "docstring-missing": "P3",
}


def _dotted(node: ast.AST) -> str:
    """'np.asarray' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _module_aliases(tree: ast.Module) -> Tuple[set, set]:
    """(numpy aliases, torch aliases) bound by this module's imports."""
    np_names, torch_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.asname or a.name.split(".")[0]
                if a.name == "numpy":
                    np_names.add(name)
                elif a.name == "torch" or a.name.startswith("torch."):
                    torch_names.add(name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "torch" or node.module.startswith("torch."):
                for a in node.names:
                    torch_names.add(a.asname or a.name)
    return np_names, torch_names


def _static_leaf(leaf: str) -> bool:
    return leaf in _STATIC_ATTRS or leaf.startswith(("is_", "get_"))


def _contains_torch_call(node: ast.AST, torch_names: set) -> bool:
    """Does the subtree call a torch function (excluding static metadata
    and host-side queries)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            dotted = _dotted(sub.func)
            root = dotted.split(".")[0] if dotted else ""
            leaf = dotted.split(".")[-1] if dotted else ""
            if root in torch_names and not _static_leaf(leaf):
                return True
    return False


def _contains_branch_method(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _BRANCH_METHODS and not sub.args:
            return True
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.np_names, self.torch_names = _module_aliases(self.tree)
        self.findings: List[Finding] = []

    def _suppressed(self, rule: str, lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                m = _SUPPRESS_RE.search(self.lines[ln - 1])
                if m and m.group(1) in (rule, "all"):
                    return True
        return False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        lineno = getattr(node, "lineno", 0)
        if self._suppressed(rule, lineno):
            return
        self.findings.append(Finding(
            severity=_SEVERITY[rule], engine="lint", rule=rule,
            where=f"{self.path}:{lineno}", message=message,
        ))

    # -- host-sync ----------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        root = dotted.split(".")[0] if dotted else ""
        leaf = dotted.split(".")[-1] if dotted else ""
        if root in self.np_names and leaf in _NP_SYNC_FUNCS:
            self._emit("host-sync", node,
                       f"{dotted}(...) forces a device->host copy "
                       f"(blocks on device work)")
        elif root in self.torch_names and dotted.endswith("cuda.synchronize"):
            self._emit("host-sync", node,
                       f"{dotted}(...) blocks the host until the device is idle")
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS \
                and not node.args and not node.keywords:
            self._emit("host-sync", node,
                       f".{node.func.attr}() blocks the host on device work")
        elif isinstance(node.func, ast.Name) and node.func.id in ("int", "float", "bool") \
                and len(node.args) == 1 \
                and _contains_torch_call(node.args[0], self.torch_names):
            self._emit("host-sync", node,
                       f"{node.func.id}(<torch expression>) synchronously "
                       f"pulls a device scalar to the host")
        self.generic_visit(node)

    # -- tensor branching ----------------------------------------------------

    def _check_branch(self, node) -> None:
        if _contains_torch_call(node.test, self.torch_names) \
                or _contains_branch_method(node.test):
            kind = "if" if isinstance(node, ast.If) else "while"
            self._emit("tensor-branch", node,
                       f"python `{kind}` on a tensor expression -- the host "
                       f"waits for the device, and a captured graph freezes "
                       f"one branch (use torch.where, or hoist to static "
                       f"metadata)")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node)
        self.generic_visit(node)


def lint_source(source: str, path: str) -> List[Finding]:
    """Lint one module's source. ``path`` is the repo-relative path
    used in findings (tests pass synthetic paths)."""
    linter = _Linter(path, source)
    linter.visit(linter.tree)
    return sorted(linter.findings)


def lint_paths(root: Path, packages: Iterable[str] = TRACED_PACKAGES) -> List[Finding]:
    """Lint every ``.py`` file of the traced packages under
    ``root/src/repro_torch`` (sorted walk: deterministic reports)."""
    findings: List[Finding] = []
    base = Path(root) / "src" / "repro_torch"
    files = [base / "api.py"]
    for pkg in packages:
        files.extend(sorted((base / pkg).rglob("*.py")))
    for f in files:
        if not f.exists():
            continue
        rel = f.relative_to(Path(root)).as_posix()
        findings.extend(lint_source(f.read_text(), rel))
    return sorted(findings)


# ---------------------------------------------------------------------------
# Docstring coverage over the public export surfaces
# ---------------------------------------------------------------------------

#: the export surfaces whose re-exported defs the docstring rule covers
_EXPORT_SURFACES = ("api.py", "hw/__init__.py")
_PACKAGE = "repro_torch"


def _surface_exports(tree: ast.Module) -> List[Tuple[str, str]]:
    """(module, exported-name) pairs an export surface re-exports from
    inside ``repro_torch.`` (constants and third-party names drop out
    later: only def/class statements are docstring-checkable)."""
    out: List[Tuple[str, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or not node.module:
            continue
        if node.level or node.module.split(".")[0] != _PACKAGE:
            continue
        for a in node.names:
            if a.name != "*" and not a.name.startswith("_"):
                out.append((node.module, a.name))
    return out


def _resolve_export(src_root: Path, module: str, name: str, _depth: int = 0):
    """Find the def/class statement behind ``from <module> import
    <name>``: the module file's top-level def, following at most one
    re-export level through a package ``__init__``. Returns
    ``(path, defnode)`` or None (constants, aliases, unresolvable)."""
    mod_path = src_root / Path(*module.split("."))
    if (mod_path / "__init__.py").exists():
        path = mod_path / "__init__.py"
    elif mod_path.with_suffix(".py").exists():
        path = mod_path.with_suffix(".py")
    else:
        return None
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError:
        return None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node.name == name:
            return path, node
    if _depth >= 1:
        return None
    for node in tree.body:  # one re-export hop (package __init__)
        if isinstance(node, ast.ImportFrom) and node.module \
                and not node.level and node.module.split(".")[0] == _PACKAGE:
            for a in node.names:
                if (a.asname or a.name) == name:
                    return _resolve_export(src_root, node.module, a.name,
                                           _depth + 1)
    return None


def docstring_findings(root: Path) -> List[Finding]:
    """The docstring-coverage pass (rule ``docstring-missing``, P3):
    every public function/class reachable from the export surfaces
    (``repro_torch.api``, ``repro_torch.hw``) must carry a docstring.
    Same suppression marker discipline as the AST rules."""
    src_root = Path(root) / "src"
    base = src_root / _PACKAGE
    findings: List[Finding] = []
    seen = set()
    lines_cache: dict = {}
    for surface in _EXPORT_SURFACES:
        spath = base / surface
        if not spath.exists():
            continue
        surface_mod = _PACKAGE + "." + surface.replace("/__init__.py", "").replace(
            ".py", "").replace("/", ".")
        for module, name in _surface_exports(ast.parse(spath.read_text())):
            res = _resolve_export(src_root, module, name)
            if res is None:
                continue
            path, defnode = res
            key = (str(path), defnode.lineno)
            if key in seen:
                continue
            seen.add(key)
            if ast.get_docstring(defnode) is not None:
                continue
            if str(path) not in lines_cache:
                lines_cache[str(path)] = path.read_text().splitlines()
            lines = lines_cache[str(path)]
            first = min([defnode.lineno] + [d.lineno
                                           for d in defnode.decorator_list])
            if any(
                (m := _SUPPRESS_RE.search(lines[ln - 1]))
                and m.group(1) in ("docstring-missing", "all")
                for ln in (defnode.lineno, defnode.lineno - 1, first,
                           first - 1)
                if 1 <= ln <= len(lines)
            ):
                continue
            kind = "class" if isinstance(defnode, ast.ClassDef) else "function"
            findings.append(Finding(
                severity=_SEVERITY["docstring-missing"], engine="lint",
                rule="docstring-missing",
                where=f"{path.relative_to(Path(root)).as_posix()}:{defnode.lineno}",
                message=f"public {kind} `{name}` (exported via "
                        f"{surface_mod}) has no docstring",
            ))
    return sorted(findings)
