"""Composition templating: the port's copy of the JAX package's
``testground_tpu/cmd/template.py`` (reference pkg/cmd/template.go:16-60).

Compositions are templates evaluated before TOML parsing, with the
reference's helper surface: ``.Env`` (the client's environment variables),
``split`` (comma-split), and ``load_resource`` (TOML file relative to the
composition). The reference uses Go ``text/template``; this is a Python
evaluator for the subset of that language compositions use:

- ``{{ .path.to.field }}`` output actions with dot navigation
- ``{{ with expr }} … {{ else }} … {{ end }}`` (re-binds dot)
- ``{{ range expr }}`` / ``{{ range $k, $v := expr }}`` over lists and maps
- ``{{ if expr }} … {{ else }} … {{ end }}`` with Go truthiness
- function calls ``(load_resource "./x.toml")``, ``split "a,b"``,
  ``index .Env "KEY"``, ``eq``/``ne``, and ``expr | func`` pipelines
- ``{{-`` / ``-}}`` whitespace trim markers
- ``$`` (root data), ``$var`` bindings from range

Every rendered text and every ``TemplateError`` message is the JAX
evaluator's (``tests/test_torch_cli_commands.py``).
"""

from __future__ import annotations

import os
import re
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional


class TemplateError(Exception):
    pass


# ---------------------------------------------------------------- lexing

_ACTION_RE = re.compile(r"\{\{(-)?\s*(.*?)\s*(-)?\}\}", re.DOTALL)


@dataclass
class _Text:
    s: str


@dataclass
class _Action:
    expr: str  # raw action text ("with .x", "end", ".Env.HOME", …)


def _lex(src: str) -> list:
    """Split into text/action tokens, applying {{- and -}} trimming."""
    out: list = []
    pos = 0
    for m in _ACTION_RE.finditer(src):
        text = src[pos : m.start()]
        if m.group(1):  # {{- trims preceding whitespace
            text = text.rstrip()
        out.append(_Text(text))
        out.append(_Action(m.group(2)))
        pos = m.end()
        if m.group(3):  # -}} trims following whitespace
            rest = src[pos:]
            trimmed = rest.lstrip()
            pos += len(rest) - len(trimmed)
    out.append(_Text(src[pos:]))
    return out


# --------------------------------------------------------------- parsing

@dataclass
class _Node:
    kind: str  # text | out | with | range | if
    text: str = ""
    pipeline: str = ""
    loop_vars: tuple = ()
    body: list = field(default_factory=list)
    else_body: list = field(default_factory=list)


_RANGE_VARS_RE = re.compile(
    r"^(\$\w+)\s*(?:,\s*(\$\w+)\s*)?:=\s*(.*)$", re.DOTALL
)


def _parse(tokens: list) -> list:
    root: list[_Node] = []
    stack: list[_Node] = []

    def emit(node: _Node) -> None:
        if stack:
            top = stack[-1]
            (top.else_body if getattr(top, "_in_else", False) else top.body).append(node)
        else:
            root.append(node)

    for tok in tokens:
        if isinstance(tok, _Text):
            if tok.s:
                emit(_Node("text", text=tok.s))
            continue
        expr = tok.expr
        if expr.startswith("/*") and expr.endswith("*/"):
            continue  # {{/* comment */}}
        word = expr.split(None, 1)[0] if expr.split() else ""
        rest = expr[len(word) :].strip()
        if word in ("with", "if", "range"):
            node = _Node(word, pipeline=rest)
            if word == "range":
                m = _RANGE_VARS_RE.match(rest)
                if m:
                    node.loop_vars = tuple(v for v in (m.group(1), m.group(2)) if v)
                    node.pipeline = m.group(3)
            emit(node)
            stack.append(node)
        elif word == "else":
            if not stack:
                raise TemplateError("unexpected {{else}}")
            stack[-1]._in_else = True  # type: ignore[attr-defined]
            if rest:  # {{ else if expr }}: nested if, closed by the same end
                kw = rest.split(None, 1)
                if kw[0] not in ("if", "with"):
                    raise TemplateError(f"unexpected {{{{else {rest}}}}}")
                node = _Node(kw[0], pipeline=kw[1] if len(kw) > 1 else "")
                node._elseif = True  # type: ignore[attr-defined]
                stack[-1].else_body.append(node)
                stack.append(node)
        elif word == "end":
            if not stack:
                raise TemplateError("unexpected {{end}}")
            # one end closes a whole if/else-if chain
            while getattr(stack.pop(), "_elseif", False):
                if not stack:
                    raise TemplateError("unexpected {{end}}")
        elif word == "":
            continue
        else:
            emit(_Node("out", pipeline=expr))
    if stack:
        raise TemplateError(f"unclosed {{{{{stack[-1].kind}}}}} block")
    return root


# ------------------------------------------------------------ expressions

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<str>"(?:[^"\\]|\\.)*"|`[^`]*`)
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<pipe>\|)
      | (?P<lp>\()
      | (?P<rp>\))
      | (?P<dot>\.[\w.]*)
      | (?P<var>\$\w*(?:\.[\w.]+)?)
      | (?P<ident>\w+)
    )""",
    re.VERBOSE,
)


def _tokenize_expr(s: str) -> list[tuple[str, str]]:
    toks, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip():
                raise TemplateError(f"bad expression near: {s[pos:]!r}")
            break
        pos = m.end()
        for k, v in m.groupdict().items():
            if v is not None:
                toks.append((k, v))
                break
    return toks


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "'": "'", "\\": "\\",
            "a": "\a", "b": "\b", "f": "\f", "v": "\v", "0": "\0"}


def _unescape(s: str) -> str:
    """Decode Go string-literal escapes (\\n, \\t, \\", \\\\, \\xFF,
    \\uXXXX, \\UXXXXXXXX) without a latin-1 round-trip that would mangle
    non-ASCII source text."""
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c != "\\" or i + 1 >= len(s):
            out.append(c)
            i += 1
            continue
        nxt = s[i + 1]
        hexlen = {"x": 2, "u": 4, "U": 8}.get(nxt)
        if hexlen is not None and i + 2 + hexlen <= len(s):
            try:
                out.append(chr(int(s[i + 2 : i + 2 + hexlen], 16)))
                i += 2 + hexlen
                continue
            except ValueError:
                pass
        out.append(_ESCAPES.get(nxt, "\\" + nxt))
        i += 2
    return "".join(out)


class StringMap(dict):
    """Go ``map[string]string`` semantics: a missing key is the zero value
    "" (used for .Env, so `{{ .Env.UNSET }}` renders empty and
    `split .Env.UNSET` gets a string, as in the reference)."""

    def get(self, key, default=""):
        return super().get(key, default)


class _Scope:
    def __init__(self, data: Any, funcs: dict[str, Callable]) -> None:
        self.root = data
        self.funcs = funcs
        self.vars: dict[str, Any] = {}

    def child(self) -> "_Scope":
        c = _Scope(self.root, self.funcs)
        c.vars = dict(self.vars)
        return c


def _navigate(obj: Any, path: str, origin: str) -> Any:
    for part in [p for p in path.split(".") if p]:
        if isinstance(obj, dict):
            # Go text/template: a missing map key yields the zero value
            # (so `{{ if .Env.UNSET }}` is simply false)
            obj = obj.get(part)
        elif obj is None:
            return None
        else:
            try:
                obj = getattr(obj, part)
            except AttributeError:
                raise TemplateError(f"can't evaluate field {part} in {origin}")
    return obj


class _ExprEval:
    """Evaluates one pipeline: ``term | func | func`` where a term is a
    function call with space-separated args or a single operand."""

    def __init__(self, scope: _Scope, dot: Any) -> None:
        self.scope = scope
        self.dot = dot

    def eval(self, src: str) -> Any:
        toks = _tokenize_expr(src)
        val, pos = self._command(toks, 0, src)
        val, pos = self._pipe_tail(val, toks, pos, src)
        if pos != len(toks):
            raise TemplateError(f"trailing tokens in expression {src!r}")
        return val

    def _pipe_tail(self, val, toks, pos, src):
        """`x | f | g` = g(f(x)): fold any trailing pipe segments."""
        while pos < len(toks) and toks[pos][0] == "pipe":
            if pos + 1 >= len(toks) or toks[pos + 1][0] != "ident":
                raise TemplateError(f"expected function after | in {src!r}")
            fname = toks[pos + 1][1]
            args, pos = self._args(toks, pos + 2, src)
            val = self._call(fname, args + [val], src)
        return val, pos

    def _command(self, toks, pos, src):
        """A function call with args, or a single operand."""
        if pos < len(toks) and toks[pos][0] == "ident" and toks[pos][1] not in (
            "true",
            "false",
            "nil",
        ):
            fname = toks[pos][1]
            args, pos = self._args(toks, pos + 1, src)
            return self._call(fname, args, src), pos
        return self._operand(toks, pos, src)

    def _args(self, toks, pos, src):
        args = []
        while pos < len(toks) and toks[pos][0] not in ("pipe", "rp"):
            v, pos = self._operand(toks, pos, src)
            args.append(v)
        return args, pos

    def _operand(self, toks, pos, src):
        if pos >= len(toks):
            raise TemplateError(f"unexpected end of expression in {src!r}")
        kind, text = toks[pos]
        if kind == "str":
            if text.startswith("`"):
                return text[1:-1], pos + 1
            return _unescape(text[1:-1]), pos + 1
        if kind == "num":
            return (float(text) if "." in text else int(text)), pos + 1
        if kind == "dot":
            return _navigate(self.dot, text[1:], src), pos + 1
        if kind == "var":
            name, _, path = text.partition(".")
            if name == "$":
                base = self.scope.root
            elif name in self.scope.vars:
                base = self.scope.vars[name]
            else:
                raise TemplateError(f"undefined variable {name} in {src!r}")
            return _navigate(base, path, src), pos + 1
        if kind == "ident":
            if text == "true":
                return True, pos + 1
            if text == "false":
                return False, pos + 1
            if text == "nil":
                return None, pos + 1
            # bare function call with no args (e.g. inside parens)
            return self._call(text, [], src), pos + 1
        if kind == "lp":
            val, pos = self._command(toks, pos + 1, src)
            val, pos = self._pipe_tail(val, toks, pos, src)  # pipes in parens
            if pos >= len(toks) or toks[pos][0] != "rp":
                raise TemplateError(f"missing ) in {src!r}")
            return val, pos + 1
        raise TemplateError(f"unexpected token {text!r} in {src!r}")

    def _call(self, name: str, args: list, src: str) -> Any:
        fn = self.scope.funcs.get(name)
        if fn is None:
            raise TemplateError(f"unknown function {name!r} in {src!r}")
        try:
            return fn(*args)
        except TemplateError:
            raise
        except Exception as e:
            raise TemplateError(f"{name}: {e} (in {src!r})") from e


# ------------------------------------------------------------- rendering

def _truthy(v: Any) -> bool:
    """Go template truth: false, 0, nil, empty string/map/slice are false."""
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, bytes, dict, list, tuple)) and len(v) == 0:
        return False
    return True


def _format(v: Any) -> str:
    """fmt %v-style output for the types compositions use."""
    if v is None:
        return "<no value>"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (list, tuple)):
        return "[" + " ".join(_format(x) for x in v) + "]"
    return str(v)


def _render(nodes: list, scope: _Scope, dot: Any, out: list[str]) -> None:
    for node in nodes:
        if node.kind == "text":
            out.append(node.text)
        elif node.kind == "out":
            val = _ExprEval(scope, dot).eval(node.pipeline)
            out.append(_format(val))
        elif node.kind == "if":
            val = _ExprEval(scope, dot).eval(node.pipeline)
            _render(node.body if _truthy(val) else node.else_body, scope, dot, out)
        elif node.kind == "with":
            val = _ExprEval(scope, dot).eval(node.pipeline)
            if _truthy(val):
                _render(node.body, scope, val, out)
            else:
                _render(node.else_body, scope, dot, out)
        elif node.kind == "range":
            val = _ExprEval(scope, dot).eval(node.pipeline)
            items: list[tuple[Any, Any]]
            if isinstance(val, dict):
                items = sorted(val.items())
            elif isinstance(val, (list, tuple)):
                items = list(enumerate(val))
            elif not _truthy(val):
                items = []
            else:
                raise TemplateError(f"can't range over {type(val).__name__}")
            if not items:
                _render(node.else_body, scope, dot, out)
                continue
            for k, v in items:
                inner = scope.child()
                if node.loop_vars:
                    if len(node.loop_vars) == 1:
                        inner.vars[node.loop_vars[0]] = v
                    else:
                        inner.vars[node.loop_vars[0]] = k
                        inner.vars[node.loop_vars[1]] = v
                _render(node.body, inner, v, out)


# ------------------------------------------------------------ public API

def default_funcs(template_dir: str | Path) -> dict[str, Callable]:
    """The reference helper set (template.go:24-43) plus the text/template
    builtins compositions use."""
    template_dir = Path(template_dir)

    def load_resource(p: str) -> dict:
        full = template_dir / p
        try:
            data = full.read_text()
        except OSError as e:
            raise TemplateError(f"load_resource {p} failed: {e}") from e
        try:
            return tomllib.loads(data)
        except Exception as e:
            raise TemplateError(f"load_resource {p} failed: {e}") from e

    def index(obj, *keys):
        for k in keys:
            if obj is None:
                return None  # Go: indexing nil yields the zero value
            if isinstance(obj, dict):
                obj = obj.get(k)
            else:
                try:
                    obj = obj[k]
                except (IndexError, KeyError, TypeError) as e:
                    raise TemplateError(f"index: {e}") from e
        return obj

    return {
        "split": lambda xs, sep=",": xs.split(sep),
        "load_resource": load_resource,
        "index": index,
        "eq": lambda a, b: a == b,
        "ne": lambda a, b: a != b,
        "not": lambda a: not _truthy(a),
        "default": lambda d, v=None: v if _truthy(v) else d,
        "printf": lambda fmt, *a: _go_printf(fmt, a),
    }


def _go_printf(fmt: str, args: tuple) -> str:
    # %v → %s with Go-ish formatting; the common verbs map directly
    py = re.sub(r"%v", "%s", fmt)
    return py % tuple(
        _format(a) if isinstance(a, (bool, list, tuple, type(None))) else a
        for a in args
    )


def compile_composition_template(
    path: str | Path, env: Optional[dict[str, str]] = None
) -> str:
    """Render the composition template at ``path`` (reference
    compileCompositionTemplate). ``env`` defaults to the process
    environment, exposed as ``.Env``."""
    path = Path(path)
    src = path.read_text()
    return render_template(
        src,
        data={"Env": StringMap(os.environ if env is None else env)},
        funcs=default_funcs(path.parent),
    )


def render_template(
    src: str, data: Any, funcs: Optional[dict[str, Callable]] = None
) -> str:
    nodes = _parse(_lex(src))
    scope = _Scope(data, funcs or {})
    out: list[str] = []
    _render(nodes, scope, data, out)
    return "".join(out)
