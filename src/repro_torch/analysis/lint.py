"""Repo-specific AST lint for the port (port of ``repro/analysis/lint.py``).

Rules, with the reference's IDs:

  FLD105 host-sync         ``.item()``, ``.tolist()``, ``.cpu()``,
                           ``np.asarray`` / ``np.array`` (of a tensor) or
                           ``torch.cuda.synchronize()`` inside a step
                           function: the host waits for the card on the hot
                           path, and the launches behind it stall.
  FLD106 unregistered-policy  BasePolicy subclass without
                           @register_policy: invisible to get_policy(), so
                           the FL loop and serving engine can't resolve it.
  FLD100 syntax-error      the file does not parse (the reference reports
                           this under FLD101).

Not ported: FLD101 (tracer-branch), FLD102 (loop-jnp), FLD103
(np-float-op), FLD104 (factory-dtype) and FLD107 (missing-donate). They
guard JAX tracing (a Python branch on a tracer, a loop unrolled into a
jaxpr), x64 promotion of weak types and jit's buffer donation, none of
which a torch program has: it runs eagerly, promotes by torch's own rules
(no x64 mode), and frees a dead input when its last reference goes. The
no-f64 contracts (analysis/contracts.py) check dtypes where they arise.

Suppression: append ``# fluidlint: disable=FLD105`` (comma-list, or
``all``) to the offending line, or put
``# fluidlint: disable-file=FLD105`` in the first ten lines of the file.
A suppression carries its reason on the same line.

Scope notes. "Step function" (FLD105) means what is statically visible as
one in the module: a function whose name ends in ``step`` or ``program``
(``step``, ``decode_step``, ``_decode_program``), everything defined inside
a ``make_*step`` factory, the ``forward`` / ``backward`` of a
``torch.autograd.Function`` subclass, and a function passed by name to
``checkpoint`` / ``torch.utils.checkpoint.checkpoint``, ``torch.compile``
or a ``torch.func`` / ``torch.vmap`` transform in the same module —
including everything nested inside them. A helper such a function calls
in another module is out of reach (the no-host-sync contract in
analysis/contracts.py runs the steps themselves and sees every op).
``np.asarray`` / ``np.array`` are flagged whatever they are given: a
static pass cannot tell a tensor from a list.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    summary: str
    fixit: str


RULES: Dict[str, Rule] = {r.id: r for r in [
    Rule("FLD100", "syntax-error",
         "the file does not parse",
         "fix the syntax error"),
    Rule("FLD105", "host-sync",
         "host sync inside a step function",
         "return the tensor and move .item()/.tolist()/.cpu()/np.asarray/"
         "torch.cuda.synchronize() to the caller, after the step's program "
         "has been enqueued; inside a step they make the host wait for the "
         "card"),
    Rule("FLD106", "unregistered-policy",
         "BasePolicy subclass not registered",
         "decorate with @register_policy(\"<name>\") so "
         "core.dropout.get_policy can resolve it"),
]}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self):
        r = RULES[self.rule]
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{r.name}] {self.message} — fix: {r.fixit}")


_SUPPRESS_LINE = re.compile(r"#\s*fluidlint:\s*disable=([A-Za-z0-9,\s]+)")
_SUPPRESS_FILE = re.compile(r"#\s*fluidlint:\s*disable-file=([A-Za-z0-9,\s]+)")

_STEP_NAME = re.compile(r"(^|_)(step|program)$")
_STEP_FACTORY = re.compile(r"^make_\w*step$")
# callables whose first argument is run as part of a step
_STEP_WRAPPERS = {("checkpoint",), ("utils", "checkpoint", "checkpoint"), ("compile",),
                  ("vmap",), ("func", "vmap"), ("func", "grad"), ("func", "vjp"),
                  ("func", "functional_call")}
_SYNC_METHODS = {"item", "tolist", "cpu"}
_HOST_SYNC_NP = {"asarray", "array"}


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """Attribute/Name chain -> ('torch', 'cuda', 'synchronize'), or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any((_dotted(b) or ("",))[-1] == "Function" for b in cls.bases)


class _ModuleContext:
    """Per-module alias table + the functions passed to a step wrapper."""

    def __init__(self, tree: ast.Module):
        self.np_aliases: Set[str] = set()
        self.torch_aliases: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    tgt = a.asname or a.name.split(".")[0]
                    if a.name == "numpy":
                        self.np_aliases.add(tgt)
                    elif a.name.split(".")[0] == "torch":
                        self.torch_aliases.add(tgt)
        self.wrapped: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Name):
                chain = _dotted(node.func)
                if chain and (chain in _STEP_WRAPPERS or chain[1:] in _STEP_WRAPPERS):
                    self.wrapped.add(node.args[0].id)

    def is_torch_chain(self, chain, tail) -> bool:
        return (len(chain) == len(tail) + 1 and chain[0] in self.torch_aliases
                and chain[1:] == tail)


class _Visitor(ast.NodeVisitor):
    def __init__(self, ctx: _ModuleContext, path: str):
        self.ctx = ctx
        self.path = path
        self.findings: List[Finding] = []
        self._step_depth = 0
        self._autograd_class = False

    def _flag(self, rule: str, node: ast.AST, message: str):
        self.findings.append(Finding(rule, self.path, node.lineno,
                                     node.col_offset, message))

    # ------------------------------------------------------------ defs
    def visit_FunctionDef(self, node):
        entering = (_STEP_NAME.search(node.name) is not None
                    or _STEP_FACTORY.match(node.name) is not None
                    or node.name in self.ctx.wrapped
                    or (self._autograd_class and node.name in ("forward", "backward")))
        if entering:
            self._step_depth += 1
        saved, self._autograd_class = self._autograd_class, False
        self.generic_visit(node)
        self._autograd_class = saved
        if entering:
            self._step_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    # ------------------------------------------------------------ FLD106
    def visit_ClassDef(self, node):
        is_policy = any((_dotted(b) or ("",))[-1] == "BasePolicy"
                        for b in node.bases)
        if is_policy and node.name != "BasePolicy":
            registered = False
            for d in node.decorator_list:
                tgt = d.func if isinstance(d, ast.Call) else d
                if (_dotted(tgt) or ("",))[-1] == "register_policy":
                    registered = True
            if not registered:
                self._flag("FLD106", node,
                           f"policy class {node.name} subclasses BasePolicy "
                           f"but is not @register_policy'd")
        saved, self._autograd_class = self._autograd_class, _is_autograd_function(node)
        self.generic_visit(node)
        self._autograd_class = saved

    # ------------------------------------------------------------ FLD105
    def visit_Call(self, node):
        if self._step_depth > 0:
            chain = _dotted(node.func)
            if (chain and len(chain) == 2 and chain[0] in self.ctx.np_aliases
                    and chain[1] in _HOST_SYNC_NP):
                self._flag("FLD105", node, f"np.{chain[1]}() inside a step function")
            elif chain and self.ctx.is_torch_chain(chain, ("cuda", "synchronize")):
                self._flag("FLD105", node,
                           "torch.cuda.synchronize() inside a step function")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _SYNC_METHODS and not node.args):
                self._flag("FLD105", node,
                           f".{node.func.attr}() inside a step function")
        self.generic_visit(node)


def _suppressions(text: str):
    """(file-level rule set, {lineno: rule set}); 'all' suppresses any."""
    file_rules: Set[str] = set()
    line_rules: Dict[int, Set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_FILE.search(line)
        if m and i <= 10:
            file_rules |= {r.strip().upper() for r in m.group(1).split(",")}
        m = _SUPPRESS_LINE.search(line)
        if m:
            line_rules[i] = {r.strip().upper() for r in m.group(1).split(",")}
    return file_rules, line_rules


def lint_source(text: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source text. Returns unsuppressed findings."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("FLD100", path, e.lineno or 0, 0,
                        f"syntax error: {e.msg}")]
    v = _Visitor(_ModuleContext(tree), path)
    v.visit(tree)
    file_rules, line_rules = _suppressions(text)
    out = []
    for f in v.findings:
        sup = file_rules | line_rules.get(f.line, set())
        if "ALL" in sup or f.rule in sup:
            continue
        out.append(f)
    return out


def iter_py_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        pth = Path(p)
        if pth.is_dir():
            files.extend(sorted(f for f in pth.rglob("*.py")
                                if "__pycache__" not in f.parts))
        elif pth.suffix == ".py":
            files.append(pth)
    return files


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    out: List[Finding] = []
    for f in iter_py_files(paths):
        out.extend(lint_source(f.read_text(), str(f)))
    return out
