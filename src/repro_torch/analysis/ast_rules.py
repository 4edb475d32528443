"""AST-tier rules over ``src/repro_torch/``: pure stdlib, reading source.

The port's twin of ``repro.analysis.ast_rules``, with the rules that
apply to the port. Each answers a question the test suite cannot
cheaply ask:

* ``kernel-mirror``: does every public function of a kernel module
  (``repro_torch/kernels/*.py`` but ``ref.py``, ``__init__.py`` and the
  loader ``build.py``) that reaches ``build.load_library``, itself or
  through a module-private helper, have a plain version
  ``<stem>_ref`` in ``repro_torch/kernels/ref.py`` (``stem`` the name
  without a trailing ``_slab``) with the same parameters, apart from
  the launch-only ones (``KERNEL_ONLY_PARAMS``), and the positional
  operands in the same order? On the CPU each wrapper runs that plain
  version, and the tests hold the kernel to it on the card: a wrapper
  without one is a kernel no CPU test reaches.
* ``zero-tail-restore``: is every quantized receive that can see a
  ``zero_fold`` sign wire (in ``repro_torch/core/{ota,shard,stream}.py``)
  paired with ``restore_zero_tail``? The folded wire's padding blocks
  dequantize to +-scale, not zero, so an unmasked tail leaks into the
  next round's master weights.
* ``draw-in-round`` (the twin of ``rekey-in-round``): does a round body
  (``repro_torch/core/{fl,ota,shard,stream}.py`` and the kernel
  modules) make a draw: ``torch.Generator(...)``, ``.manual_seed(...)``,
  ``torch.rand*`` / ``torch.normal`` and the other sampling functions,
  or an in-place ``.normal_`` / ``.uniform_`` / ``.exponential_`` /
  ``.bernoulli_``? A round's randomness comes in as ``RoundDraws``, from
  the one provider ``core/draws.py`` (outside the scope), so that the
  parity tests can feed the JAX package's own draws through the same
  seam; a draw inside the round forks the streams.
* ``local-import`` and ``syntax-error``, as in the JAX package.

Every rule honours a waiver in place: ``# repro-lint: allow[<rule-id>]``
on (or up to three lines above) the flagged line, and ``# repro-lint:
lazy-import (reason)`` for a deliberate function-local import (cycle
breaks, optional toolchains). The fold rules have no twin: the port
calls no ``fold_in`` (its draws are tensors, keyed on the host in
``core/draws.py``).

Entry points: ``analyze_repo(root)`` for the live tree,
``analyze_sources({relpath: source})`` for in-memory fixtures (the
test suite), ``analyze_paths(files, root)`` for an explicit file set.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

# Rule id -> one-line description (the CLI's --list-rules catalogue).
AST_RULES = {
    "kernel-mirror":
        "kernel wrapper without a signature-matching plain version in "
        "kernels/ref.py",
    "zero-tail-restore":
        "quantized receive with zero_fold in scope lacks restore_zero_tail",
    "draw-in-round":
        "a round body makes a draw (randomness must come in as RoundDraws)",
    "local-import":
        "function-local import without a lazy-import waiver",
    "syntax-error":
        "file does not parse (all other rules skipped for it)",
}

# Launch-only parameters, exempt from the wrapper <-> plain version
# match: B5's tile sizes and the transmit kernel's in-kernel rounding
# seed (the plain version takes pre-drawn uniforms).
KERNEL_ONLY_PARAMS = {"bq", "bk", "sr_seed"}

_KERNELS = "repro_torch/kernels/"
_NOT_WRAPPERS = ("/ref.py", "/__init__.py", "/build.py")
# Modules holding quantized-aggregate receive sites (zero-tail rule).
_ZERO_TAIL_SUFFIXES = ("repro_torch/core/ota.py", "repro_torch/core/shard.py",
                       "repro_torch/core/stream.py")
# Modules whose function bodies are round bodies (draw-in-round), beside
# the kernel modules.
_ROUND_SCOPE_SUFFIXES = ("repro_torch/core/fl.py",
                         "repro_torch/core/round.py") + _ZERO_TAIL_SUFFIXES

_RECEIVE_FNS = {"ota_receive_slab", "ota_receive_ref"}
_LOADER = "load_library"

# torch.<name>(...) calls that sample, and in-place sampling methods.
_DRAW_FNS = {"rand", "randn", "randint", "randperm", "rand_like",
             "randn_like", "randint_like", "normal", "bernoulli",
             "multinomial", "poisson"}
_DRAW_METHODS = {"manual_seed", "normal_", "uniform_", "exponential_",
                 "bernoulli_", "random_", "geometric_", "cauchy_",
                 "log_normal_"}

_WAIVER_TAG = "# repro-lint:"
# How many lines above a flagged statement a waiver comment may sit.
_WAIVER_REACH = 3


class _Mod:
    """One parsed source file (repo-relative posix path + AST)."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source)

    def snippet(self, line: int) -> str:
        if 0 < line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


def _norm(path) -> str:
    return str(path).replace(os.sep, "/")


def _is_kernel_mod(path: str) -> bool:
    return _KERNELS in path and not path.endswith(_NOT_WRAPPERS)


def _waived(mod: _Mod, node: ast.AST, rule: str) -> bool:
    start = getattr(node, "lineno", 1)
    end = getattr(node, "end_lineno", start) or start
    for ln in range(max(1, start - _WAIVER_REACH), end + 1):
        text = mod.lines[ln - 1] if ln <= len(mod.lines) else ""
        if _WAIVER_TAG not in text:
            continue
        # A waiver ABOVE the statement must be a standalone comment; a
        # trailing waiver (code + comment) covers only its own line.
        if ln < start and not text.lstrip().startswith("#"):
            continue
        tag = text.split(_WAIVER_TAG, 1)[1]
        if f"allow[{rule}]" in tag:
            return True
        if rule == "local-import" and "lazy-import" in tag:
            return True
    return False


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _call_name(func: ast.AST) -> Optional[str]:
    """Last path component of a call target (``build.f`` -> ``f``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _calls(node: ast.AST) -> Iterable[ast.Call]:
    return (n for n in ast.walk(node) if isinstance(n, ast.Call))


# ---------------------------------------------------------------------------
# kernel-mirror


def _reaches_loader(mod: _Mod) -> Set[str]:
    """Names of the module's top-level functions that call
    ``load_library``, directly or through module-private helpers."""
    fns = {fn.name: fn for fn in mod.tree.body
           if isinstance(fn, ast.FunctionDef)}
    called = {name: {_call_name(c.func) for c in _calls(fn)}
              for name, fn in fns.items()}
    reach = {name for name, c in called.items() if _LOADER in c}
    grew = True
    while grew:
        grew = False
        for name, c in called.items():
            if name not in reach and any(
                    h in reach and h.startswith("_") for h in c if h):
                reach.add(name)
                grew = True
    return reach


def _param_names(fn) -> Tuple[List[str], List[str]]:
    """(positional names, all names): posonly + args + kwonly."""
    a = fn.args
    pos = [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
    return pos, pos + [p.arg for p in a.kwonlyargs]


def _check_kernel_mirror(kernel_mods: Sequence[_Mod],
                         ref_mod: Optional[_Mod]) -> List[Finding]:
    findings = []
    ref_fns = ({} if ref_mod is None else
               {fn.name: fn for fn in ref_mod.tree.body
                if isinstance(fn, ast.FunctionDef)})
    ref_path = ref_mod.path if ref_mod is not None else \
        "src/repro_torch/kernels/ref.py"
    for mod in kernel_mods:
        reach = _reaches_loader(mod)
        for fn in mod.tree.body:
            if (not isinstance(fn, ast.FunctionDef)
                    or fn.name.startswith("_") or fn.name not in reach
                    or _waived(mod, fn, "kernel-mirror")):
                continue
            stem = fn.name[:-5] if fn.name.endswith("_slab") else fn.name
            ref_name = f"{stem}_ref"
            snip = mod.snippet(fn.lineno)
            rfn = ref_fns.get(ref_name)
            if rfn is None:
                findings.append(Finding(
                    mod.path, fn.lineno, "kernel-mirror", "error",
                    f"kernel wrapper {fn.name} has no plain version "
                    f"{ref_name} in {ref_path}: no CPU test reaches its "
                    "arithmetic", snippet=snip))
                continue
            kpos, kall = _param_names(fn)
            rpos, rall = _param_names(rfn)
            kset = set(kall) - KERNEL_ONLY_PARAMS
            rset = set(rall) - KERNEL_ONLY_PARAMS
            missing = sorted(kset - rset)
            extra = sorted(rset - kset)
            kp = [p for p in kpos if p not in KERNEL_ONLY_PARAMS]
            if missing or extra:
                parts = []
                if missing:
                    parts.append(f"plain version is missing {missing}")
                if extra:
                    parts.append(f"plain version has extra {extra}")
                findings.append(Finding(
                    mod.path, fn.lineno, "kernel-mirror", "error",
                    f"{fn.name} and {ref_name} signatures disagree: "
                    + "; ".join(parts), snippet=snip))
            elif rpos[:len(kp)] != kp:
                findings.append(Finding(
                    mod.path, fn.lineno, "kernel-mirror", "error",
                    f"{fn.name} positional operands {kp} but {ref_name} "
                    f"leads with {rpos[:len(kp)]}", snippet=snip))
    return findings


# ---------------------------------------------------------------------------
# zero-tail-restore


def _check_zero_tail(mod: _Mod) -> List[Finding]:
    if not mod.path.endswith(_ZERO_TAIL_SUFFIXES):
        return []
    findings = []
    for fn in mod.tree.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls: Set[str] = set()
        names: Set[str] = set()
        first_recv: Optional[ast.Call] = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                cname = _call_name(node.func)
                if cname:
                    calls.add(cname)
                    if cname in _RECEIVE_FNS and first_recv is None:
                        first_recv = node
                names.update(kw.arg for kw in node.keywords if kw.arg)
            elif isinstance(node, ast.Name):
                names.add(node.id)
            elif isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.arg):
                names.add(node.arg)
        if (first_recv is not None and "zero_fold" in names
                and "restore_zero_tail" not in calls
                and not _waived(mod, first_recv, "zero-tail-restore")):
            findings.append(Finding(
                mod.path, first_recv.lineno, "zero-tail-restore", "error",
                f"{fn.name} receives a quantized aggregate with zero_fold "
                "reachable but never calls restore_zero_tail: the folded "
                "sign wire's padding blocks dequantize to +-scale, not "
                "zero", snippet=mod.snippet(first_recv.lineno)))
    return findings


# ---------------------------------------------------------------------------
# draw-in-round


def _draw(node: ast.Call) -> Optional[str]:
    """What ``node`` draws, or None."""
    dotted = _dotted(node.func) or ""
    name = _call_name(node.func)
    if name == "Generator":
        return f"{dotted}(...) makes a generator"
    if name in _DRAW_METHODS and isinstance(node.func, ast.Attribute):
        return f".{name}(...) draws or reseeds"
    head, _, last = dotted.rpartition(".")
    if last in _DRAW_FNS and head.split(".")[-1:] == ["torch"]:
        return f"{dotted}(...) draws"
    return None


def _check_draws(mod: _Mod) -> List[Finding]:
    if not (mod.path.endswith(_ROUND_SCOPE_SUFFIXES)
            or _is_kernel_mod(mod.path)):
        return []
    findings = []
    for scope in mod.tree.body:
        if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
            continue
        for node in _calls(scope):
            what = _draw(node)
            if what is None or _waived(mod, node, "draw-in-round"):
                continue
            findings.append(Finding(
                mod.path, node.lineno, "draw-in-round", "error",
                f"{what} inside a round body: the round's randomness comes "
                "in as RoundDraws (core/draws.py), so the parity tests can "
                "feed the same draws to both packages",
                snippet=mod.snippet(node.lineno)))
    return findings


# ---------------------------------------------------------------------------
# local-import


def _is_import_guard(node: ast.AST) -> bool:
    if isinstance(node, ast.Try):
        for handler in node.handlers:
            types = handler.type
            if types is None:
                return True
            names = ([_call_name(e) for e in types.elts]
                     if isinstance(types, ast.Tuple)
                     else [_call_name(types)])
            if {"ImportError", "ModuleNotFoundError",
                    "Exception"} & set(filter(None, names)):
                return True
    if isinstance(node, ast.If):
        test = _dotted(node.test)
        if test and test.endswith("TYPE_CHECKING"):
            return True
    return False


def _check_local_imports(mod: _Mod) -> List[Finding]:
    findings = []

    def visit(node: ast.AST, in_fn: bool, guarded: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                if (in_fn and not guarded
                        and not _waived(mod, child, "local-import")):
                    if isinstance(child, ast.ImportFrom):
                        what = f"from {child.module or '.'} import ..."
                    else:
                        what = ("import "
                                + ", ".join(a.name for a in child.names))
                    findings.append(Finding(
                        mod.path, child.lineno, "local-import", "warn",
                        f"function-local `{what}`: hoist to module level, "
                        "or waive with `# repro-lint: lazy-import "
                        "(reason)` if it breaks a cycle or defers a side "
                        "effect", snippet=mod.snippet(child.lineno)))
            visit(child,
                  in_fn or isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.Lambda)),
                  guarded or _is_import_guard(child))

    visit(mod.tree, False, False)
    return findings


# ---------------------------------------------------------------------------
# drivers


def analyze_sources(sources: Dict[str, str]) -> List[Finding]:
    """Run every AST rule over ``{repo-relative path: source text}``."""
    mods: List[_Mod] = []
    findings: List[Finding] = []
    for path in sorted(sources):
        npath = _norm(path)
        try:
            mods.append(_Mod(npath, sources[path]))
        except SyntaxError as exc:
            findings.append(Finding(
                npath, exc.lineno or 1, "syntax-error", "error",
                f"does not parse: {exc.msg}"))
    for mod in mods:
        findings += _check_zero_tail(mod)
        findings += _check_draws(mod)
        findings += _check_local_imports(mod)
    kernel_mods = [m for m in mods if _is_kernel_mod(m.path)]
    ref_mod = next((m for m in mods
                    if m.path.endswith(_KERNELS + "ref.py")), None)
    findings += _check_kernel_mirror(kernel_mods, ref_mod)
    return sorted(findings)


def analyze_paths(paths: Iterable[Path], root: Path) -> List[Finding]:
    """Analyze an explicit file set; paths reported relative to root."""
    root = Path(root).resolve()
    sources = {}
    for p in paths:
        p = Path(p).resolve()
        try:
            rel = p.relative_to(root)
        except ValueError:
            rel = p
        sources[_norm(rel)] = p.read_text()
    return analyze_sources(sources)


def analyze_repo(root: Path) -> List[Finding]:
    """Analyze every ``*.py`` under ``<root>/src/repro_torch``."""
    src = Path(root) / "src" / "repro_torch"
    return analyze_paths(sorted(src.rglob("*.py")), Path(root))
