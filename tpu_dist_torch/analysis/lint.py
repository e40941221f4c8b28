"""Layer 1: the AST lint for idioms that hurt a distributed PyTorch step
(rules TD001-TD008), the port's counterpart of ``tpu_dist/analysis/lint.py``.

Pure ``ast`` walking, stdlib only, so it runs anywhere in milliseconds.
The interesting part is *step-context detection*: TD001/TD005 apply only
inside code that runs once a training step on the device's clock, where a
host read stalls the stream every step and, under a CUDA graph, a host
value is frozen at capture. JAX's lint calls these functions "traced"; the
port's are

* every function nested in a hot factory (a name matching
  ``HOT_FACTORY_REGEX``: ``make_train_step``'s ``step``,
  ``make_step_body``'s ``body``);
* the body of a ``with torch.cuda.graph(...)`` block (``GRAPH_CAPTURE_CALLS``);
* a function decorated with, or passed to, ``torch.compile``,
  ``torch.cuda.make_graphed_callables``, ``torch.utils.checkpoint.checkpoint``
  or ``torch.func.grad``/``vmap`` (``TRACE_ENTRY_CALLS``), also through
  ``functools.partial``;
* the ``forward``/``backward`` of a ``torch.autograd.Function`` subclass;
* a function defined inside, or called by name from, any of these in the
  same module (a fixpoint over the local call graph, as JAX's).

This is a heuristic, not a proof: a step handed across modules (a
``_GraphLoop`` capturing ``self.fn``) is invisible to it, and a miss costs
only a lint gap, never a false build break.

TD003 (``jit-missing-donate``) has no direct counterpart: eager PyTorch
donates nothing, and the port's steps update the state in place (``add_``,
``_foreach_*_``, the fused SGD kernel). Its signal here is the regression
of that idiom inside a hot factory's step context: a state name
(``TD003_STATE_NAMES``: ``p``, ``params``, ``momentum``, ``buf``...) rebound
to an out-of-place result of itself (``p = p - lr * g``, ``p.data = p -
...``), or a whole copy of one (``.clone()``, ``torch.clone``,
``copy.deepcopy``). Either keeps the old state alive beside the new one
until the step returns: twice the state's memory at peak. It cannot see an
out-of-place update made through a helper in another module, a state
rebound under another name, or ``torch.func.functional_call`` over a new
dict of parameters.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Optional

from tpu_dist_torch.analysis.rules import (
    AUTOGRAD_FUNCTION_BASES,
    COLLECTIVE_CALL_NONMODULES,
    COLLECTIVE_CALLS,
    COMPAT_MODULE_SUFFIX,
    FRAGILE_IMPORTS,
    FRAGILE_PRIVATE_ROOT,
    GRAPH_CAPTURE_CALLS,
    HOST_SYNC_BUILTINS,
    HOST_SYNC_CALLS,
    HOST_SYNC_METHODS,
    HOT_FACTORY_REGEX,
    LOG_METHODS,
    LOGGERISH_NAMES,
    NONDETERMINISM_CALLS,
    NONDETERMINISM_PREFIXES,
    RANK_CALL_SUFFIXES,
    RANK_VAR_NAMES,
    TD002_EXEMPT_PARTS,
    TD003_STATE_NAMES,
    TD006_ALLOWED_SILENT,
    TD007_ALLOWED_PARTS,
    TRACE_ENTRY_CALLS,
    Violation,
)

_SUPPRESS_RE = re.compile(r"#\s*tpu-dist:\s*ignore(?:\[([A-Za-z0-9,\s]+)\])?")
_HOT_RE = re.compile(HOT_FACTORY_REGEX)
_PRIMARY_NAMES = {"is_primary", "is_main", "is_main_process", "main_process"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: The package the CLI lints by default.
DEFAULT_PATH = "tpu_dist_torch"


def lint_paths(paths: Iterable[str], root: Optional[str] = None) -> list:
    """Lint every ``.py`` under ``paths``; returns suppression-filtered
    violations with repo-relative file names."""
    root = os.path.abspath(root or os.getcwd())
    out: list = []
    for path in paths:
        path = os.path.abspath(path)
        if not os.path.exists(path):
            # a missing path must be loud: os.walk would iterate nothing
            # and the gate would report a false-green "0 violations"
            raise FileNotFoundError(f"lint path does not exist: {path}")
        if os.path.isfile(path):
            out.extend(lint_file(path, root))
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.extend(lint_file(os.path.join(dirpath, fn), root))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def lint_file(path: str, root: Optional[str] = None) -> list:
    root = os.path.abspath(root or os.getcwd())
    rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, rel)


def lint_source(source: str, rel_path: str) -> list:
    """Lint one file's source. ``rel_path`` is used for reporting AND for
    the path-scoped rules (TD002/TD007's allowlists, TD004's compat
    module)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation("TD000", rel_path, e.lineno or 0, f"syntax error: {e.msg}")]
    lint = _FileLint(tree, source.splitlines(), rel_path)
    out = [v for v in lint.run() if not lint.suppressed(v)]
    out.sort(key=lambda v: (v.line, v.col, v.rule))
    return out


def _leaf(node: ast.AST) -> Optional[str]:
    """The last name of a target or receiver: ``state.params`` ->
    ``params``, ``p.data`` -> ``p``, ``bufs[i]`` -> ``bufs``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return _leaf(node.value) if node.attr == "data" else node.attr
    if isinstance(node, ast.Subscript):
        return _leaf(node.value)
    return None


class _FileLint:
    def __init__(self, tree: ast.Module, lines: list, rel_path: str):
        self.tree = tree
        self.lines = lines
        self.rel_path = rel_path
        self.parent: dict = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        self.aliases = self._collect_aliases()
        self.funcs_by_name: dict = {}
        self.all_funcs: list = []
        for node in ast.walk(tree):
            if isinstance(node, _FUNCS):
                self.all_funcs.append(node)
                self.funcs_by_name.setdefault(node.name, []).append(node)
        self.hot_factories = [fn for fn in self.all_funcs if _HOT_RE.match(fn.name)]
        self.traced = self._find_traced()
        self.suppressions = self._collect_suppressions()

    # -- plumbing ----------------------------------------------------------

    def _collect_aliases(self) -> dict:
        aliases: dict = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name != "*":
                        aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path of a Name/Attribute chain with import aliases
        substituted: ``np.random.default_rng`` -> ``numpy.random.default_rng``."""
        parts: list = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def _collect_suppressions(self) -> dict:
        """Map line -> suppressed rule ids (None = all). A marker on a code
        line covers that line; a marker inside a comment block covers the
        next statement line (so multi-line explanations work)."""
        sup: dict = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            ids_str = m.group(1)
            ids = {s.strip() for s in ids_str.split(",")} if ids_str else None
            targets = [i]
            if line.strip().startswith("#"):
                j = i + 1
                while j <= len(self.lines) and (
                        not self.lines[j - 1].strip()
                        or self.lines[j - 1].strip().startswith("#")):
                    j += 1
                if j <= len(self.lines):
                    targets.append(j)
            for t in targets:
                if ids is None or sup.get(t, set()) is None:
                    sup[t] = None
                else:
                    sup[t] = set(sup.get(t) or set()) | ids
        return sup

    def suppressed(self, v: Violation) -> bool:
        ids = self.suppressions.get(v.line, False)
        if ids is False:
            return False
        return ids is None or v.rule in ids

    def _snippet(self, node: ast.AST) -> str:
        line = getattr(node, "lineno", 0)
        return self.lines[line - 1].strip() if 0 < line <= len(self.lines) else ""

    def _violation(self, rule: str, node: ast.AST, message: str) -> Violation:
        return Violation(rule, self.rel_path, getattr(node, "lineno", 0), message,
                         col=getattr(node, "col_offset", 0), snippet=self._snippet(node))

    # -- step-context detection --------------------------------------------

    def _is_trace_entry(self, func_expr: ast.AST) -> bool:
        return self.resolve(func_expr) in TRACE_ENTRY_CALLS

    def _find_traced(self) -> set:
        traced: set = set()
        # roots: every function nested in a hot factory
        for factory in self.hot_factories:
            for sub in ast.walk(factory):
                if sub is not factory and isinstance(sub, _FUNCS + (ast.Lambda,)):
                    traced.add(sub)
        # decorators and direct references in step-entry calls
        for fn in self.all_funcs:
            for dec in fn.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if self._is_trace_entry(target) or (
                        isinstance(dec, ast.Call)
                        and self.resolve(dec.func) == "functools.partial"
                        and dec.args and self._is_trace_entry(dec.args[0])):
                    traced.add(fn)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and self._is_trace_entry(node.func):
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Name):
                        traced.update(self.funcs_by_name.get(arg.id, []))
                    elif isinstance(arg, ast.Lambda):
                        traced.add(arg)
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and self.resolve(item.context_expr.func) in GRAPH_CAPTURE_CALLS
                    for item in node.items):
                traced.add(node)  # a captured block: its body is the step
            elif isinstance(node, ast.ClassDef) and any(
                    self.resolve(b) in AUTOGRAD_FUNCTION_BASES for b in node.bases):
                traced.update(s for s in node.body
                              if isinstance(s, _FUNCS) and s.name in ("forward", "backward"))
        # closure: lexically-nested defs + module-local call graph
        changed = True
        while changed:
            changed = False
            for fn in list(traced):
                for sub in ast.walk(fn):
                    if sub is fn:
                        continue
                    if isinstance(sub, _FUNCS + (ast.Lambda,)) and sub not in traced:
                        traced.add(sub)
                        changed = True
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        for callee in self.funcs_by_name.get(sub.func.id, []):
                            if callee not in traced:
                                traced.add(callee)
                                changed = True
        return traced

    # -- rank-0 guard recognition (TD002) ---------------------------------

    def _is_rank_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            resolved = self.resolve(node.func) or ""
            return resolved.split(".")[-1] in RANK_CALL_SUFFIXES
        if isinstance(node, ast.Name):
            return node.id in RANK_VAR_NAMES
        if isinstance(node, ast.Attribute):
            return node.attr in RANK_VAR_NAMES
        return False

    def _is_primary_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            resolved = self.resolve(node.func) or ""
            return resolved.split(".")[-1] in _PRIMARY_NAMES
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = node.id if isinstance(node, ast.Name) else node.attr
            return name in _PRIMARY_NAMES
        return False

    def _test_polarity(self, test: ast.AST) -> Optional[bool]:
        """True = test passes only on rank 0; False = only on rank != 0;
        None = not a rank test. Handles ``== 0``/``!= 0``/``> 0``, bare
        truthiness, ``not`` inversion, ``is_primary()`` spellings, and
        ``and``-conjunctions containing a rank test."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = self._test_polarity(test.operand)
            return None if inner is None else not inner
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for sub in test.values:
                pol = self._test_polarity(sub)
                if pol is not None:
                    return pol  # rank0 AND x still implies rank0 when true
            return None
        if self._is_primary_expr(test):
            return True
        if self._is_rank_expr(test):
            return False  # `if rank:` is true only off rank 0
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            left, op, right = test.left, test.ops[0], test.comparators[0]
            if isinstance(right, ast.Constant) and right.value == 0:
                rank_side = left
            elif isinstance(left, ast.Constant) and left.value == 0:
                rank_side, op = right, _flip(op)
            else:
                return None
            if not self._is_rank_expr(rank_side):
                return None
            if isinstance(op, ast.Eq):
                return True
            if isinstance(op, (ast.NotEq, ast.Gt)):
                return False
        return None

    def _early_exit(self, node: ast.AST, polarity) -> Optional[ast.AST]:
        """An ``if <rank test>: return``/``raise`` earlier in the enclosing
        function than ``node`` (``polarity``: the test's required polarity,
        or None for either), or None."""
        fn = self._enclosing_function(node)
        if fn is None:
            return None
        for stmt in fn.body:
            if getattr(stmt, "lineno", 10**9) >= getattr(node, "lineno", 0):
                break
            if not (isinstance(stmt, ast.If) and not stmt.orelse and any(
                    isinstance(s, (ast.Return, ast.Raise)) for s in stmt.body)):
                continue
            pol = self._test_polarity(stmt.test)
            if pol is not None and (polarity is None or pol is polarity):
                return stmt
        return None

    def _is_rank0_guarded(self, node: ast.AST) -> bool:
        # (a) ancestor `if` taking the rank-0 branch
        child = node
        anc = self.parent.get(node)
        while anc is not None:
            if isinstance(anc, ast.If):
                pol = self._test_polarity(anc.test)
                if pol is not None:
                    in_body = any(child is s for s in anc.body)
                    in_orelse = any(child is s for s in anc.orelse)
                    if (pol and in_body) or (not pol and in_orelse):
                        return True
            child, anc = anc, self.parent.get(anc)
        # (b) early-return guard earlier in the enclosing function:
        #     `if rank != 0: return` before this statement
        return self._early_exit(node, False) is not None

    def _rank_guard(self, node: ast.AST):
        """The rank-dependent control flow that gates ``node`` (TD008): an
        ancestor ``if`` whose test is a rank test of EITHER polarity, or an
        earlier rank-early-return in the enclosing function, after which
        the remaining body runs on a rank subset. Returns the guarding
        statement, or None."""
        child = node
        anc = self.parent.get(node)
        while anc is not None:
            if (isinstance(anc, ast.If) and self._test_polarity(anc.test) is not None
                    and (any(child is s for s in anc.body)
                         or any(child is s for s in anc.orelse))):
                return anc
            child, anc = anc, self.parent.get(anc)
        return self._early_exit(node, None)

    def _enclosing_function(self, node: ast.AST):
        anc = self.parent.get(node)
        while anc is not None:
            if isinstance(anc, _FUNCS):
                return anc
            anc = self.parent.get(anc)
        return None

    # -- the rules ---------------------------------------------------------

    def run(self) -> list:
        out: list = []
        seen: set = set()

        def emit(rule: str, node: ast.AST, msg: str) -> None:
            key = (rule, getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
            if key not in seen:
                seen.add(key)
                out.append(self._violation(rule, node, msg))

        self._check_imports(emit)
        for fn in self.traced:
            self._check_traced_body(fn, emit)
        self._check_io(emit)
        self._check_bare_print(emit)
        self._check_state_copies(emit)
        self._check_silent_except(emit)
        self._check_rank_guarded_collective(emit)
        return out

    @staticmethod
    def _fragile(module: str, name: Optional[str]) -> bool:
        banned = FRAGILE_IMPORTS.get(module, set())
        if name is not None and (name in banned or "*" in banned
                                 or ("_*" in banned and name.startswith("_"))):
            return True
        if name is not None and f"{module}.{name}" in FRAGILE_IMPORTS:
            return True
        parts = module.split(".")
        return parts[0] == FRAGILE_PRIVATE_ROOT and any(p.startswith("_") for p in parts[1:])

    def _check_imports(self, emit) -> None:  # TD004
        if self.rel_path.endswith(COMPAT_MODULE_SUFFIX):
            return
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if self._fragile(node.module, a.name):
                        emit("TD004", node,
                             f"`from {node.module} import {a.name}` is a private torch API "
                             "that moves between releases; import it from "
                             "tpu_dist_torch.comm.compat")
                        break
            elif isinstance(node, ast.Import):
                for a in node.names:
                    module, _, name = a.name.rpartition(".")
                    if self._fragile(a.name, None) or (module and self._fragile(module, name)):
                        emit("TD004", node,
                             f"`import {a.name}` is a private torch API that moves between "
                             "releases; use tpu_dist_torch.comm.compat")
                        break

    def _check_traced_body(self, fn: ast.AST, emit) -> None:  # TD001 / TD005
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            resolved = self.resolve(node.func)
            if resolved in HOST_SYNC_CALLS:
                emit("TD001", node, f"`{resolved}` forces a host sync in a step context")
            elif (isinstance(node.func, ast.Attribute) and node.func.attr in HOST_SYNC_METHODS
                  and not node.args and not node.keywords):
                emit("TD001", node,
                     f"`.{node.func.attr}()` forces a host sync in a step context")
            elif (isinstance(node.func, ast.Name) and node.func.id in HOST_SYNC_BUILTINS
                  and node.args and not isinstance(node.args[0], ast.Constant)):
                emit("TD001", node,
                     f"`{node.func.id}()` on a tensor blocks on a device readback "
                     "(host sync) in a step context")
            if resolved is not None and (resolved in NONDETERMINISM_CALLS
                                         or resolved.startswith(NONDETERMINISM_PREFIXES)):
                emit("TD005", node,
                     f"`{resolved}` in a step context is read ONCE at capture and frozen "
                     "into the CUDA graph; draw on the device (torch.Generator) or pass "
                     "the value in")

    def _check_io(self, emit) -> None:  # TD002
        if any(part in self.rel_path for part in TD002_EXEMPT_PARTS):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = self._io_kind(node)
            if kind is None or self._is_rank0_guarded(node):
                continue
            emit("TD002", node,
                 f"unguarded {kind} runs on EVERY rank; wrap in "
                 "`if dist.get_rank() == 0` (or rank0_print/get_logger)")

    def _io_kind(self, node: ast.Call) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id == "print":
                return "print()"
            if func.id == "open":
                mode = node.args[1] if len(node.args) >= 2 else None
                for k in node.keywords:
                    if k.arg == "mode":
                        mode = k.value
                if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
                    if any(c in mode.value for c in "wax+"):
                        return f"open(mode={mode.value!r}) file write"
            return None
        if isinstance(func, ast.Attribute):
            if func.attr in ("write_text", "write_bytes"):
                return f".{func.attr}() file write"
            if func.attr in LOG_METHODS:
                resolved = self.resolve(func.value) or ""
                base = func.value
                basename = (base.id if isinstance(base, ast.Name)
                            else base.attr if isinstance(base, ast.Attribute) else "")
                if resolved == "logging" or resolved.startswith("logging."):
                    return f"logging.{func.attr}()"
                if any(t in basename.lower() for t in LOGGERISH_NAMES):
                    return f"{basename}.{func.attr}()"
        return None

    def _check_bare_print(self, emit) -> None:  # TD007
        """Stricter sibling of TD002: ANY bare ``print(`` outside the
        designated logging layer: a rank-0 guard makes it correct but still
        un-grep-able and un-silenceable."""
        if any(part in self.rel_path for part in TD007_ALLOWED_PARTS):
            return
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                emit("TD007", node,
                     "bare print() bypasses the logging layer; use rank0_print/get_logger "
                     "(tpu_dist_torch.metrics.logging) — or inline-ignore with the reason "
                     "this sink is deliberate")

    def _exc_type_names(self, t: ast.AST) -> list:
        """Dotted names of the handled exception type(s); '<dynamic>' for
        anything unresolvable (a computed type never passes the allowlist)."""
        if isinstance(t, ast.Tuple):
            out: list = []
            for e in t.elts:
                out.extend(self._exc_type_names(e))
            return out
        resolved = self.resolve(t)
        return [resolved] if resolved else ["<dynamic>"]

    def _check_silent_except(self, emit) -> None:  # TD006
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                emit("TD006", node,
                     "bare `except:` also catches SystemExit/KeyboardInterrupt and hides "
                     "the real failure; catch a concrete exception type")
                continue
            # "silent" = the body does literally nothing: pass / `...`
            silent = all(isinstance(s, ast.Pass) or (
                isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
                for s in node.body)
            if not silent:
                continue
            names = self._exc_type_names(node.type)
            if all(n.split(".")[-1] in TD006_ALLOWED_SILENT for n in names):
                continue
            emit("TD006", node,
                 f"`except {', '.join(names)}: pass` silently swallows the failure — on a "
                 "multi-process job the first fault then surfaces as a collective "
                 "deadlock; log it, re-raise, or narrow to an allowlisted benign type "
                 f"({', '.join(sorted(TD006_ALLOWED_SILENT))})")

    def _check_rank_guarded_collective(self, emit) -> None:  # TD008
        """A collective call site gated by rank-dependent control flow: only
        the guarded ranks reach the collective, the rest block in whatever
        collective comes next and the job dies later with an opaque
        timeout. Compute the collective on every rank and guard the
        rank-local action instead."""
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            resolved = self.resolve(node.func)
            if resolved is None and isinstance(node.func, ast.Attribute):
                last = node.func.attr
            elif resolved is not None:
                if resolved.startswith(COLLECTIVE_CALL_NONMODULES):
                    continue
                last = resolved.split(".")[-1]
            else:
                continue
            if last not in COLLECTIVE_CALLS:
                continue
            guard = self._rank_guard(node)
            if guard is None:
                continue
            emit("TD008", node,
                 f"collective `{last}` is reachable only under the rank-dependent guard at "
                 f"line {guard.lineno} — ranks that skip it block in the next matching "
                 "collective (cross-host deadlock); hoist the collective out of the guard "
                 "(compute everywhere, act on one rank)")

    def _check_state_copies(self, emit) -> None:  # TD003
        for factory in self.hot_factories:
            for fn in ast.walk(factory):
                if fn is factory or fn not in self.traced:
                    continue
                for node in ast.walk(fn):
                    what = self._state_copy(node)
                    if what is not None:
                        emit("TD003", node,
                             f"{what} inside hot-path factory `{factory.name}`'s step: the "
                             "old TrainState stays live beside the new one across the "
                             "update (2x peak device memory); update in place (add_, "
                             "_foreach_*_, the fused kernel)")

    def _state_copy(self, node: ast.AST) -> Optional[str]:
        """What makes ``node`` a TD003 finding, or None."""
        if isinstance(node, ast.Call):
            resolved = self.resolve(node.func)
            if resolved in ("copy.deepcopy", "torch.clone") and node.args and (
                    _leaf(node.args[0]) in TD003_STATE_NAMES):
                return f"`{resolved}` of the state `{_leaf(node.args[0])}`"
            if (isinstance(node.func, ast.Attribute) and node.func.attr == "clone"
                    and _leaf(node.func.value) in TD003_STATE_NAMES):
                return f"`.clone()` of the state `{_leaf(node.func.value)}`"
            return None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.value, ast.BinOp) and isinstance(node.value.op, (ast.Add, ast.Sub)):
            name = _leaf(node.targets[0])
            if name in TD003_STATE_NAMES and any(
                    _leaf(sub) == name for sub in ast.walk(node.value)
                    if isinstance(sub, (ast.Name, ast.Attribute, ast.Subscript))):
                return f"the state `{name}` rebound to an out-of-place result of itself"
        return None


def _flip(op: ast.cmpop) -> ast.cmpop:
    if isinstance(op, ast.Gt):
        return ast.Lt()
    if isinstance(op, ast.Lt):
        return ast.Gt()
    return op
