"""
GLSL fragment front-end: run the reference's `.frag` authoring format as JAX.

The reference assembles GLSL fragment shaders with a metaprogrammer and hands
them to OpenGL (/root/reference/shaderflow/shader.py:186-239, example
fragments under /root/reference/examples/basic/shaders/). Here the same
sources compile to a jittable per-pixel function over jnp arrays: a small
recursive-descent parser builds an AST once, and a vectorized interpreter
executes it per frame inside the render trace — every pixel is a lane of the
(H, W) arrays, and divergent control flow (`if` on per-pixel values, `break`,
`return`, `discard`) becomes mask-merged assignment, which is exactly how a
GPU wave executes it and precisely what XLA wants: no data-dependent control
flow, just `where`.

Scope (the subset the bundled + example shaders use — see tests/test_glsl.py):
  - #define object-like macros; comments; int/float/bool/vecN/ivecN/bvecN/
    matN/sampler2D types; const arrays (`const int a[9] = int[9](...)`)
  - functions (value parameters, incl. sampler2D), full expression grammar
    (ternary, swizzles, compound assignment, ++/--, matrix*vector)
  - `if`/`else` (uniform Python conditions branch for free; per-pixel
    conditions mask-merge), `for`/`while` with statically countable trip
    counts (per-pixel `break`/`continue`/`return` via masks), `discard`
  - the ShaderFlow uniform/texture surface: astuv/gluv/... coordinates,
    every pipeline uniform, texture()/texelFetch()/stexture()/gtexture(),
    `iName<T>x<L>` box naming, `<Name>Texture(t, l, uv)` accessors,
    GetCamera(iCamera) + camera struct fields, and the stdlib
    (resources/shaders/include/shaderflow.glsl) mapped onto ops/stdlib.py.

Not supported (raises GlslError at compile or run): out/inout parameters,
user struct declarations, switch, dynamic (data-dependent) trip counts,
pointer-ish array writes through dynamic indices.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

from shaderflow_tpu import ops
from shaderflow_tpu.ops import stdlib as sl
from shaderflow_tpu.ops.sampling import Sampler2D


class GlslError(Exception):
    pass


class _LowerUnsupported(Exception):
    """Internal: a loop body needs python-time values (temporal texture
    indices, dynamic-store indices, non-arrayable carried state) and cannot
    be lowered to lax.while_loop — fall back to trace-time unrolling."""


# =========================================================================== #
# Lexer + preprocessor

_TOKEN_RE = re.compile(r"""
    (?P<float>   \d+\.\d*(?:[eE][+-]?\d+)?[fF]? | \.\d+(?:[eE][+-]?\d+)?[fF]?
               | \d+[eE][+-]?\d+[fF]? | \d+[fF] )
  | (?P<int>     0[xX][0-9a-fA-F]+ | \d+[uU]? )
  | (?P<ident>   [A-Za-z_]\w* )
  | (?P<op>      \+\+ | -- | \+= | -= | \*= | /= | %= | && | \|\| | == | !=
               | <= | >= | << | >> | [-+*/%<>=!&|^?:;,.(){}\[\]~] )
  | (?P<ws>      \s+ )
""", re.VERBOSE)


def tokenize(source: str, origin: str = "<glsl>") -> list[tuple[str, str, int]]:
    """-> [(kind, text, line)]; comments stripped, #defines applied."""
    # Strip comments, keep newlines for line numbers
    source = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                    source, flags=re.S)
    source = re.sub(r"//[^\n]*", "", source)

    # Preprocessor: object-like #define only (function-like macros in the
    # reference includes are builtins here); other directives are ignored.
    defines: dict[str, str] = {}
    lines = []
    for line in source.split("\n"):
        stripped = line.strip()
        if stripped.startswith("#"):
            m = re.match(r"#\s*define\s+([A-Za-z_]\w*)\s+(.*)$", stripped)
            if m and "(" != (m.group(2)[:1] if False else "") and not re.match(
                    r"#\s*define\s+[A-Za-z_]\w*\(", stripped):
                defines[m.group(1)] = m.group(2).strip()
            lines.append("")  # keep line count
            continue
        lines.append(line)
    text = "\n".join(lines)

    # Expand defines iteratively at the token level
    def expand(tok_text: str, depth: int = 0) -> list[str]:
        if depth > 16 or tok_text not in defines:
            return [tok_text]
        out = []
        for m in _TOKEN_RE.finditer(defines[tok_text]):
            if m.lastgroup == "ws":
                continue
            out.extend(expand(m.group(0), depth + 1)
                       if m.lastgroup == "ident" else [m.group(0)])
        return out

    tokens: list[tuple[str, str, int]] = []
    line_no = 1
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise GlslError(f"{origin}:{line_no}: bad character {text[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            line_no += m.group(0).count("\n")
            continue
        if kind == "ident" and m.group(0) in defines:
            for piece in expand(m.group(0)):
                pm = _TOKEN_RE.match(piece)
                tokens.append((pm.lastgroup, piece, line_no))
            continue
        tokens.append((kind, m.group(0), line_no))
    return tokens


# =========================================================================== #
# AST (plain tuples: (node_kind, ...))

_TYPES = {"void", "float", "int", "bool", "uint",
          "vec2", "vec3", "vec4", "ivec2", "ivec3", "ivec4",
          "bvec2", "bvec3", "bvec4", "uvec2", "uvec3", "uvec4",
          "mat2", "mat3", "mat4", "sampler2D"}

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%="}


class Parser:
    def __init__(self, tokens: list[tuple[str, str, int]], origin: str):
        self.toks = tokens
        self.i = 0
        self.origin = origin

    # -- token helpers ----------------------------------------------------
    def peek(self, ahead: int = 0) -> tuple[str, str, int]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else ("eof", "", -1)

    def next(self) -> tuple[str, str, int]:
        tok = self.peek()
        self.i += 1
        return tok

    def accept(self, text: str) -> bool:
        if self.peek()[1] == text:
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> None:
        kind, got, line = self.next()
        if got != text:
            raise GlslError(f"{self.origin}:{line}: expected {text!r}, got {got!r}")

    def error(self, message: str) -> GlslError:
        return GlslError(f"{self.origin}:{self.peek()[2]}: {message}")

    # -- top level --------------------------------------------------------
    def parse_unit(self) -> list:
        decls = []
        while self.peek()[0] != "eof":
            decls.append(self.parse_toplevel())
        return decls

    def parse_toplevel(self):
        qualifiers = []
        while self.peek()[1] in ("const", "uniform", "in", "out", "highp",
                                 "mediump", "lowp", "precision"):
            qualifiers.append(self.next()[1])
        type_name = self.next()[1]
        if type_name not in _TYPES:
            raise self.error(f"unknown type {type_name!r}")
        name = self.next()[1]
        if self.peek()[1] == "(":
            return self.parse_function(type_name, name)
        return self.parse_global(qualifiers, type_name, name)

    def parse_function(self, ret_type: str, name: str):
        self.expect("(")
        params = []
        if not self.accept(")"):
            while True:
                while self.peek()[1] in ("in", "const", "highp", "mediump", "lowp"):
                    self.next()
                if self.peek()[1] in ("out", "inout"):
                    raise self.error("out/inout parameters are not supported")
                ptype = self.next()[1]
                pname = self.next()[1]
                params.append((ptype, pname))
                if not self.accept(","):
                    break
            self.expect(")")
        body = self.parse_block()
        return ("func", ret_type, name, params, body)

    def parse_global(self, qualifiers, type_name, name):
        size = None
        if self.accept("["):
            size = int(self.next()[1])
            self.expect("]")
        init = None
        if self.accept("="):
            init = self.parse_assignment_expr()
        self.expect(";")
        return ("global", qualifiers, type_name, name, size, init)

    # -- statements -------------------------------------------------------
    def parse_block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.parse_statement())
        return ("block", stmts)

    def parse_statement(self):
        kind, text, line = self.peek()
        if text == "{":
            return self.parse_block()
        if text == ";":
            self.next()
            return ("block", [])
        if text == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            then = self.parse_statement()
            otherwise = self.parse_statement() if self.accept("else") else None
            return ("if", cond, then, otherwise)
        if text == "for":
            self.next()
            self.expect("(")
            init = (("expr", None) if self.accept(";")
                    else self.parse_simple_statement())
            cond = None if self.peek()[1] == ";" else self.parse_expression()
            self.expect(";")
            step = None if self.peek()[1] == ")" else self.parse_expression()
            self.expect(")")
            body = self.parse_statement()
            return ("for", init, cond, step, body)
        if text == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            body = self.parse_statement()
            return ("for", ("expr", None), cond, None, body)
        if text == "return":
            self.next()
            value = None if self.peek()[1] == ";" else self.parse_expression()
            self.expect(";")
            return ("return", value)
        if text == "break":
            self.next()
            self.expect(";")
            return ("break",)
        if text == "continue":
            self.next()
            self.expect(";")
            return ("continue",)
        if text == "discard":
            self.next()
            self.expect(";")
            return ("discard",)
        stmt = self.parse_simple_statement()
        return stmt

    def parse_simple_statement(self):
        """Declaration or expression statement, consuming the trailing ';'."""
        kind, text, _ = self.peek()
        qualifiers = []
        while self.peek()[1] in ("const", "highp", "mediump", "lowp"):
            qualifiers.append(self.next()[1])
        if self.peek()[1] in _TYPES and self.peek(1)[0] == "ident" \
                and self.peek(2)[1] not in ("(",):
            type_name = self.next()[1]
            decls = []
            while True:
                name = self.next()[1]
                size = None
                if self.accept("["):
                    size = int(self.next()[1])
                    self.expect("]")
                init = self.parse_assignment_expr() if self.accept("=") else None
                decls.append((name, size, init))
                if not self.accept(","):
                    break
            self.expect(";")
            return ("decl", type_name, decls)
        if qualifiers:
            raise self.error("qualifier without declaration")
        expr = self.parse_expression()
        self.expect(";")
        return ("expr", expr)

    # -- expressions (precedence climbing) --------------------------------
    def parse_expression(self):
        expr = self.parse_assignment_expr()
        while self.accept(","):
            expr = ("comma", expr, self.parse_assignment_expr())
        return expr

    def parse_assignment_expr(self):
        left = self.parse_ternary()
        if self.peek()[1] in _ASSIGN_OPS:
            op = self.next()[1]
            right = self.parse_assignment_expr()
            return ("assign", op, left, right)
        return left

    def parse_ternary(self):
        cond = self.parse_binary(0)
        if self.accept("?"):
            then = self.parse_assignment_expr()
            self.expect(":")
            otherwise = self.parse_assignment_expr()
            return ("ternary", cond, then, otherwise)
        return cond

    _PRECEDENCE = [["||"], ["&&"], ["|"], ["^"], ["&"],
                   ["==", "!="], ["<", ">", "<=", ">="],
                   ["<<", ">>"], ["+", "-"], ["*", "/", "%"]]

    def parse_binary(self, level: int):
        if level >= len(self._PRECEDENCE):
            return self.parse_unary()
        left = self.parse_binary(level + 1)
        while self.peek()[1] in self._PRECEDENCE[level]:
            op = self.next()[1]
            right = self.parse_binary(level + 1)
            left = ("binary", op, left, right)
        return left

    def parse_unary(self):
        text = self.peek()[1]
        if text in ("-", "+", "!", "~"):
            self.next()
            return ("unary", text, self.parse_unary())
        if text in ("++", "--"):
            self.next()
            return ("prefix", text, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        expr = self.parse_primary()
        while True:
            text = self.peek()[1]
            if text == ".":
                self.next()
                member = self.next()[1]
                expr = ("member", expr, member)
            elif text == "[":
                self.next()
                index = self.parse_expression()
                self.expect("]")
                expr = ("index", expr, index)
            elif text == "(" and expr[0] in ("ident", "arraytype"):
                self.next()
                args = []
                if not self.accept(")"):
                    while True:
                        args.append(self.parse_assignment_expr())
                        if not self.accept(","):
                            break
                    self.expect(")")
                expr = ("call", expr, args)
            elif text in ("++", "--"):
                self.next()
                expr = ("postfix", text, expr)
            else:
                return expr

    def parse_primary(self):
        kind, text, line = self.next()
        if kind == "float":
            return ("num", float(text.rstrip("fF")))
        if kind == "int":
            return ("num", int(text.rstrip("uU"), 0))
        if kind == "ident":
            if text in ("true", "false"):
                return ("num", text == "true")
            if text in _TYPES and self.peek()[1] == "[":
                # array constructor type: int[9](...)
                self.expect("[")
                size = int(self.next()[1])
                self.expect("]")
                return ("arraytype", text, size)
            return ("ident", text)
        if text == "(":
            expr = self.parse_expression()
            self.expect(")")
            return expr
        raise GlslError(f"{self.origin}:{line}: unexpected token {text!r}")


# =========================================================================== #
# Values

_VEC_SIZE = {"vec2": 2, "vec3": 3, "vec4": 4, "ivec2": 2, "ivec3": 3,
             "ivec4": 4, "bvec2": 2, "bvec3": 3, "bvec4": 4,
             "uvec2": 2, "uvec3": 3, "uvec4": 4}
_MAT_SIZE = {"mat2": 2, "mat3": 3, "mat4": 4}
_SWIZZLE = {"x": 0, "y": 1, "z": 2, "w": 3, "r": 0, "g": 1, "b": 2, "a": 3,
            "s": 0, "t": 1, "p": 2, "q": 3}


class GV:
    """A GLSL value: `kind` + `data`.

    Scalars ('float'/'int'/'bool') hold a python number OR a jnp array of
    pixel shape (H, W) (or ()); vectors ('vecN'/'ivecN'/'bvecN') hold a jnp
    array whose LAST axis is the component axis ((N,) constants, (H, W, N)
    per-pixel fields); matrices hold (..., N, N); 'sampler' holds a
    Sampler2D; 'camera' holds a cameralib.CameraRays; 'array' holds a (K,)
    element array with elem kind in data[1]."""
    __slots__ = ("kind", "data")

    def __init__(self, kind: str, data: Any):
        self.kind = kind
        self.data = data

    def __repr__(self) -> str:
        return f"GV({self.kind}, {type(self.data).__name__})"

    @property
    def is_python(self) -> bool:
        return isinstance(self.data, (int, float, bool))

    @property
    def components(self) -> int:
        return _VEC_SIZE.get(self.kind, 1)


def _is_scalar_kind(kind: str) -> bool:
    return kind in ("float", "int", "bool")


def _pixelwise(value):
    """Scalar payload -> something broadcastable against a (..., N) vector:
    append a component axis to (H, W) planes."""
    if isinstance(value, (int, float, bool)):
        return value
    arr = jnp.asarray(value)
    return arr[..., None] if arr.ndim > 0 else arr


def _promote_num(a: GV, b: GV) -> str:
    if "float" in (a.kind, b.kind):
        return "float"
    if "int" in (a.kind, b.kind):
        return "int"
    return a.kind


def make_scalar(kind: str, value) -> GV:
    return GV(kind, value)


def make_vec(kind: str, data) -> GV:
    return GV(kind, data)


# =========================================================================== #
# Interpreter

class _Env:
    def __init__(self, parent: Optional["_Env"] = None):
        self.vars: dict[str, GV] = {}
        self.parent = parent

    def lookup(self, name: str) -> Optional[GV]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        return None

    def owner(self, name: str) -> Optional["_Env"]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.vars:
                return env
            env = env.parent
        return None

    def declare(self, name: str, value: GV) -> None:
        self.vars[name] = value


def _mask_and(a, b):
    """None = all lanes; False = no lanes; True = all lanes; else array."""
    if a is None:
        return b
    if b is None:
        return a
    if a is False or b is False:
        return False
    if a is True:
        return b
    if b is True:
        return a
    return jnp.logical_and(a, b)


def _mask_andnot(a, b):
    """a & ~b (b None/False -> a)."""
    if a is False:
        return False
    if b is None or b is False:
        return a
    if b is True:
        return False
    return _mask_and(a, jnp.logical_not(b))


def _mask_or(a, b):
    if a is None or b is None:
        raise GlslError("internal: or on unset mask")
    if isinstance(a, bool) and isinstance(b, bool):
        return a or b
    return jnp.logical_or(a, b)


def _sticky_or(current, addition):
    """Accumulate a sticky flag mask: current is False (never taken),
    True (taken everywhere) or an array; addition is None (taken under the
    full active set), True or an array."""
    if addition is None or addition is True or current is True:
        return True
    if current is False:
        return addition if addition is not False else False
    if addition is False:
        return current
    return jnp.logical_or(current, addition)


def _as_mask_arr(mask):
    """Flow mask (None/bool/array) -> a concrete bool array for a carry."""
    if mask is None or mask is True:
        return jnp.ones((), bool)
    if mask is False:
        return jnp.zeros((), bool)
    return jnp.asarray(mask, bool)


def _kind_dtype(kind: str):
    """Carry dtype for a GLSL kind; None = not lowerable (sampler/camera)."""
    if kind == "float" or kind.startswith("vec") or kind in _MAT_SIZE \
            or kind == "array:float":
        return jnp.float32
    if kind in ("int", "uint") or kind.startswith(("ivec", "uvec")) \
            or kind == "array:int":
        return jnp.int32
    if kind == "bool" or kind.startswith("bvec"):
        return jnp.bool_
    return None


def _add_store_target(target, out: set) -> None:
    while target[0] in ("member", "index"):
        target = target[1]
    if target[0] == "ident":
        out.add(target[1])


def _collect_mutated(node, out: set) -> None:
    """All identifiers the AST can store into (assignment/inc-dec targets)."""
    if isinstance(node, tuple):
        kind = node[0] if node and isinstance(node[0], str) else None
        if kind == "assign":
            _add_store_target(node[2], out)
        elif kind in ("prefix", "postfix"):
            _add_store_target(node[2], out)
        for child in node[1:] if kind else node:
            _collect_mutated(child, out)
    elif isinstance(node, list):
        for child in node:
            _collect_mutated(child, out)


def _expr_is_pure(node) -> bool:
    """No stores / no user-call opacity: safe to pre-evaluate a condition.
    Builtin calls (length, dot, ...) are pure; user calls are opaque."""
    if isinstance(node, tuple):
        kind = node[0] if node and isinstance(node[0], str) else None
        if kind in ("assign", "prefix", "postfix", "comma"):
            return False
        if kind == "call":
            callee = node[1]
            if callee[0] != "ident" or callee[1] not in _BUILTINS:
                return False
            return all(_expr_is_pure(arg) for arg in node[2])
        return all(_expr_is_pure(child) for child in (node[1:] if kind else node))
    if isinstance(node, list):
        return all(_expr_is_pure(child) for child in node)
    return True


class _Flow:
    """Per-frame control-flow state: the active mask plus sticky
    return/break/continue/discard masks (False = not taken, True = taken
    everywhere, array = per-pixel)."""

    def __init__(self):
        self.mask = None          # None = fully active
        self.returned = False
        self.break_mask = False
        self.continue_mask = False
        self.ret_value: Optional[GV] = None
        self.discarded = False

    def active(self):
        m = _mask_andnot(self.mask, self.returned)
        m = _mask_andnot(m, self.break_mask)
        return _mask_andnot(m, self.continue_mask)

    def fully_inactive(self) -> bool:
        return (self.returned is True or self.break_mask is True
                or self.continue_mask is True)


class Interpreter:
    """Executes one parsed translation unit against a Frag context."""

    def __init__(self, unit: list, origin: str):
        self.origin = origin
        self.functions: dict[str, tuple] = {}
        self.globals_ast: list[tuple] = []
        for decl in unit:
            if decl[0] == "func":
                self.functions[decl[2]] = decl
            else:
                self.globals_ast.append(decl)
        if "main" not in self.functions:
            raise GlslError(f"{origin}: no void main() defined")

    # ------------------------------------------------------------------ #
    def run(self, sf) -> jnp.ndarray:
        self.sf = sf
        self.height, self.width = sf.astuv.shape[:2]
        root = _Env()
        root.declare("fragColor", GV("vec4", jnp.zeros(4, jnp.float32)))
        root.declare("fragCoord", GV("vec2", sf.stxy))
        root.declare("gl_FragCoord", GV("vec2", sf.stxy))
        for decl in self.globals_ast:
            _, _qual, type_name, name, size, init = decl
            flow = _Flow()
            value = (self.eval(init, root, flow) if init is not None
                     else self._default_value(type_name, size))
            root.declare(name, self._coerce_decl(type_name, size, value))
        flow = _Flow()
        self.exec_block(self.functions["main"][4], _Env(root), flow)
        if flow.discarded is not False:
            sf.discard(flow.discarded if flow.discarded is not True
                       else jnp.ones((self.height, self.width), bool))
        color = root.lookup("fragColor")
        data = jnp.asarray(color.data, jnp.float32)
        return jnp.broadcast_to(data, (self.height, self.width, 4))

    # ------------------------------------------------------------------ #
    # Statements

    def exec_stmt(self, stmt, env: _Env, flow: _Flow) -> None:
        op = stmt[0]
        if op == "block":
            self.exec_block(stmt, _Env(env), flow)
        elif op == "expr":
            if stmt[1] is not None:
                self.eval(stmt[1], env, flow)
        elif op == "decl":
            _, type_name, decls = stmt
            for name, size, init in decls:
                value = (self.eval(init, env, flow) if init is not None
                         else self._default_value(type_name, size))
                env.declare(name, self._coerce_decl(type_name, size, value))
        elif op == "if":
            self.exec_if(stmt, env, flow)
        elif op == "for":
            self.exec_for(stmt, env, flow)
        elif op == "return":
            value = self.eval(stmt[1], env, flow) if stmt[1] is not None else None
            active = flow.active()
            if value is not None:
                if flow.ret_value is None:
                    flow.ret_value = value
                else:
                    flow.ret_value = self._merge(flow.ret_value, value, active)
            flow.returned = _sticky_or(flow.returned, active)
        elif op == "break":
            flow.break_mask = _sticky_or(flow.break_mask, flow.active())
        elif op == "continue":
            flow.continue_mask = _sticky_or(flow.continue_mask, flow.active())
        elif op == "discard":
            active = flow.active()
            flow.discarded = _sticky_or(flow.discarded, active)
            flow.returned = _sticky_or(flow.returned, active)
        else:
            raise GlslError(f"{self.origin}: unhandled statement {op!r}")

    def exec_block(self, block, env: _Env, flow: _Flow) -> None:
        for stmt in block[1]:
            if flow.fully_inactive():
                return
            self.exec_stmt(stmt, env, flow)

    def exec_if(self, stmt, env: _Env, flow: _Flow) -> None:
        _, cond_ast, then, otherwise = stmt
        cond = self.eval(cond_ast, env, flow)
        if cond.is_python:
            if cond.data:
                self.exec_stmt(then, _Env(env), flow)
            elif otherwise is not None:
                self.exec_stmt(otherwise, _Env(env), flow)
            return
        cond_mask = jnp.asarray(cond.data, bool)
        saved = flow.mask
        flow.mask = _mask_and(saved, cond_mask)
        self.exec_stmt(then, _Env(env), flow)
        if otherwise is not None:
            flow.mask = _mask_and(saved, jnp.logical_not(cond_mask))
            self.exec_stmt(otherwise, _Env(env), flow)
        flow.mask = saved

    # Loops with at most this many statically-counted trips unroll at trace
    # time (constant folding, python temporal indices keep working); bigger
    # or data-dependent loops lower to ONE lax.while_loop whose body is
    # traced once — raymarch-style 100-step marches compile in seconds
    # instead of exploding the XLA graph, and exit as soon as every lane
    # broke (true early-out, which unrolling can never do).
    UNROLL_LIMIT = 32

    def exec_for(self, stmt, env: _Env, flow: _Flow) -> None:
        _, init, cond_ast, step, body = stmt
        loop_env = _Env(env)
        self.exec_stmt(init, loop_env, flow)

        trips = self._shadow_trip_count(stmt, loop_env)
        if trips is None or trips > self.UNROLL_LIMIT:
            cond_is_python = True
            if trips is None and cond_ast is not None \
                    and _expr_is_pure(cond_ast):
                probe = self.eval(cond_ast, loop_env, flow)
                cond_is_python = probe.is_python
            if trips is not None or not cond_is_python:
                try:
                    self._exec_for_lowered(stmt, loop_env, flow, trips)
                    return
                except _LowerUnsupported:
                    if trips is None:
                        raise GlslError(
                            f"{self.origin}: data-dependent loop needs "
                            "python-time values in its body and cannot be "
                            "unrolled either") from None
        self._exec_for_unrolled(stmt, loop_env, flow, trips)

    def _exec_for_unrolled(self, stmt, loop_env: _Env, flow: _Flow,
                           trips: Optional[int]) -> None:
        _, init, cond_ast, step, body = stmt
        saved_mask = flow.mask
        break_saved = flow.break_mask
        continue_saved = flow.continue_mask
        # Lanes sitting out the enclosing scope (outer break/continue) must
        # stay inactive for this whole loop; `returned` is sticky on the flow
        # itself so active() keeps excluding it.
        entry_mask = _mask_andnot(_mask_andnot(saved_mask, break_saved),
                                  continue_saved)
        flow.break_mask = False
        flow.continue_mask = False
        iteration = 0
        while True:
            if trips is not None and iteration >= trips:
                break
            if trips is None and iteration >= 65536:
                raise GlslError(f"{self.origin}: loop exceeded 65536 iterations")
            cond = (self.eval(cond_ast, loop_env, flow)
                    if cond_ast is not None else GV("bool", True))
            if cond.is_python:
                if not cond.data:
                    break
                flow.mask = _mask_andnot(entry_mask, flow.break_mask)
            else:
                flow.mask = _mask_andnot(
                    _mask_and(entry_mask, jnp.asarray(cond.data, bool)),
                    flow.break_mask)
            if flow.break_mask is True or flow.returned is True:
                break
            flow.continue_mask = False
            self.exec_stmt(body, _Env(loop_env), flow)
            # `continue` jumps to the step expression: continued lanes rejoin
            # here; broken/returned lanes stay excluded via active().
            flow.continue_mask = False
            if step is not None:
                self.eval(step, loop_env, flow)
            iteration += 1
        flow.continue_mask = continue_saved
        flow.break_mask = break_saved
        flow.mask = saved_mask

    def _shadow_trip_count(self, stmt, loop_env: _Env) -> Optional[int]:
        """Statically count loop trips by simulating init/cond/step with
        python numbers (per-pixel masking can turn the loop counter into an
        array mid-loop, so the live condition cannot control the python
        loop). Returns None when the condition stays python-evaluable (the
        live loop just uses it)."""
        _, init, cond_ast, step, _body = stmt
        if cond_ast is None:
            return None

        # Identify the loop variable from init: decl or assignment
        name = None
        start = None
        if init[0] == "decl":
            decls = init[2]
            if len(decls) == 1 and decls[0][2] is not None:
                name = decls[0][0]
                value = loop_env.lookup(name)
                if value is not None and value.is_python:
                    start = value.data
        elif init[0] == "expr" and init[1] is not None and init[1][0] == "assign":
            target = init[1][2]
            if target[0] == "ident":
                name = target[1]
                value = loop_env.lookup(name)
                if value is not None and value.is_python:
                    start = value.data
        if name is None or start is None:
            return None

        env = dict(shadow_var=None)

        def shadow_eval(ast, current) -> Any:
            kind = ast[0]
            if kind == "num":
                return ast[1]
            if kind == "ident":
                if ast[1] == name:
                    return current
                value = loop_env.lookup(ast[1])
                if value is not None and value.is_python:
                    return value.data
                if ast[1] in _CONSTANTS:
                    return _CONSTANTS[ast[1]]
                raise GlslError("shadow: non-static name " + ast[1])
            if kind == "binary":
                a = shadow_eval(ast[2], current)
                b = shadow_eval(ast[3], current)
                return _PY_BINOPS[ast[1]](a, b)
            if kind == "unary":
                value = shadow_eval(ast[2], current)
                return {"-": lambda v: -v, "+": lambda v: v,
                        "!": lambda v: not v}[ast[1]](value)
            if kind == "call" and ast[1][0] == "ident" and ast[1][1] == "float":
                return float(shadow_eval(ast[2][0], current))
            if kind == "call" and ast[1][0] == "ident" and ast[1][1] == "int":
                return int(shadow_eval(ast[2][0], current))
            raise GlslError("shadow: unsupported " + kind)

        def shadow_step(current) -> Any:
            if step is None:
                raise GlslError("shadow: missing step")
            s = step
            if s[0] in ("prefix", "postfix"):
                target = s[2]
                if target[0] == "ident" and target[1] == name:
                    return current + (1 if s[1] == "++" else -1)
                raise GlslError("shadow: step on other var")
            if s[0] == "assign" and s[2][0] == "ident" and s[2][1] == name:
                if s[1] == "=":
                    return shadow_eval(s[3], current)
                delta = shadow_eval(s[3], current)
                return _PY_BINOPS[s[1][0]](current, delta)
            raise GlslError("shadow: unsupported step")

        try:
            current = start
            trips = 0
            while shadow_eval(cond_ast, current):
                trips += 1
                if trips > 65536:
                    raise GlslError(f"{self.origin}: loop exceeds 65536 trips")
                current = shadow_step(current)
            return trips
        except GlslError as error:
            if "65536" in str(error):
                raise
            return None  # fall back to live python-evaluable condition

    # ------------------------------------------------------------------ #
    # lax.while_loop lowering: big/data-dependent loops trace their body
    # ONCE. The mutated variables + the sticky flow masks form the carry;
    # per-lane `break`/`return`/condition failure drop lanes out of the
    # active mask, and the loop exits as soon as no lane is active.

    def _exec_for_lowered(self, stmt, loop_env: _Env, flow: _Flow,
                          trips: Optional[int]) -> None:
        import jax
        from jax import lax
        _, _init, cond_ast, step, body = stmt

        saved_mask = flow.mask
        break_saved = flow.break_mask
        continue_saved = flow.continue_mask
        entry_mask = _mask_andnot(_mask_andnot(saved_mask, break_saved),
                                  continue_saved)

        mutated: set = set()
        _collect_mutated(body, mutated)
        if step is not None:
            _collect_mutated(step, mutated)
        if cond_ast is not None:
            _collect_mutated(cond_ast, mutated)
        carried: dict[str, GV] = {}
        for name in sorted(mutated):
            owner = loop_env.owner(name)
            if owner is None:
                continue  # declared inside the body: loop-local
            gv = owner.vars[name]
            if _kind_dtype(gv.kind) is None:
                raise _LowerUnsupported(f"cannot carry {gv.kind} {name!r}")
            carried[name] = gv

        ret_kind = [flow.ret_value.kind if flow.ret_value is not None else None]
        cap = trips if trips is not None else 65536

        def materialize(carry):
            """Write carry into the owner envs; -> restore list."""
            originals = []
            for name, gv in carried.items():
                owner = loop_env.owner(name)
                originals.append((owner, name, owner.vars[name]))
                owner.vars[name] = GV(gv.kind, carry["v:" + name])
            return originals

        def make_flow(carry) -> _Flow:
            f = _Flow()
            f.mask = entry_mask
            f.returned = carry["_ret"]
            f.break_mask = carry["_brk"]
            f.discarded = carry["_dis"]
            if "_rv" in carry and ret_kind[0] is not None:
                f.ret_value = GV(ret_kind[0], carry["_rv"])
            return f

        def eval_cond_mask(f: _Flow):
            if cond_ast is None:
                return None
            cond = self.eval(cond_ast, loop_env, f)
            if cond.is_python:
                return None if cond.data else False
            return jnp.asarray(cond.data, bool)

        def cond_fn(carry):
            originals = materialize(carry)
            try:
                f = make_flow(carry)
                active = _mask_and(entry_mask, eval_cond_mask(f))
                active = _mask_andnot(active, carry["_ret"])
                active = _mask_andnot(active, carry["_brk"])
            finally:
                for owner, name, gv in originals:
                    owner.vars[name] = gv
            if active is None:
                any_active = jnp.asarray(True)
            elif active is False:
                any_active = jnp.asarray(False)
            else:
                any_active = jnp.any(active)
            return jnp.logical_and(any_active, carry["_it"] < cap)

        def body_fn(carry):
            originals = materialize(carry)
            try:
                f = make_flow(carry)
                cond_mask = eval_cond_mask(f)
                f.mask = _mask_and(entry_mask, cond_mask)
                f.continue_mask = False
                self.exec_stmt(body, _Env(loop_env), f)
                # `continue` rejoins at the step expression (C semantics)
                f.continue_mask = False
                if step is not None:
                    self.eval(step, loop_env, f)
                out = {"_it": carry["_it"] + 1,
                       "_ret": _as_mask_arr(f.returned),
                       "_brk": _as_mask_arr(f.break_mask),
                       "_dis": _as_mask_arr(f.discarded)}
                if f.ret_value is not None:
                    ret_kind[0] = f.ret_value.kind
                    out["_rv"] = jnp.asarray(f.ret_value.data,
                                             _kind_dtype(f.ret_value.kind))
                for name, gv in carried.items():
                    live = loop_env.owner(name).vars[name]
                    if live.kind != gv.kind:
                        raise _LowerUnsupported(
                            f"{name!r} changed kind {gv.kind}->{live.kind}")
                    out["v:" + name] = jnp.asarray(live.data,
                                                   _kind_dtype(gv.kind))
            finally:
                for owner, name, gv in originals:
                    owner.vars[name] = gv
            return out

        carry = {"_it": jnp.asarray(0, jnp.int32),
                 "_ret": _as_mask_arr(flow.returned),
                 "_brk": _as_mask_arr(False),
                 "_dis": _as_mask_arr(flow.discarded)}
        if flow.ret_value is not None:
            carry["_rv"] = jnp.asarray(flow.ret_value.data,
                                       _kind_dtype(flow.ret_value.kind))
        for name, gv in carried.items():
            carry["v:" + name] = jnp.asarray(gv.data, _kind_dtype(gv.kind))

        # get_camera caches per-trace rays; anything it caches inside the
        # abstract/while traces below would leak those traces' tracers.
        camera_cache = dict(self.sf._camera_cache)
        try:
            # Fixed-point the carry structure: masked merges broadcast
            # scalars up to (H, W) planes, the first `return` adds the _rv
            # slot — eval_shape (abstract, no FLOPs) discovers the stable
            # shapes, then the real while_loop runs with an exact carry.
            for _ in range(4):
                try:
                    spec = jax.eval_shape(body_fn, carry)
                except (GlslError, TypeError, ValueError) as error:
                    raise _LowerUnsupported(str(error)) from None
                stable = True
                for key, leaf_spec in spec.items():
                    old = carry.get(key)
                    if old is None:
                        carry[key] = jnp.zeros(leaf_spec.shape, leaf_spec.dtype)
                        stable = False
                    elif (jnp.shape(old) != leaf_spec.shape
                          or jnp.asarray(old).dtype != leaf_spec.dtype):
                        try:
                            carry[key] = jnp.broadcast_to(
                                jnp.asarray(old, leaf_spec.dtype),
                                leaf_spec.shape)
                        except (TypeError, ValueError) as error:
                            raise _LowerUnsupported(str(error)) from None
                        stable = False
                if stable:
                    break
            else:
                raise _LowerUnsupported("carry never stabilized")

            try:
                final = lax.while_loop(cond_fn, body_fn, carry)
            except (GlslError, TypeError, ValueError) as error:
                raise _LowerUnsupported(str(error)) from None
        finally:
            self.sf._camera_cache.clear()
            self.sf._camera_cache.update(camera_cache)

        for name, gv in carried.items():
            loop_env.owner(name).vars[name] = GV(gv.kind, final["v:" + name])
        flow.returned = final["_ret"]
        flow.discarded = final["_dis"]
        if "_rv" in final and ret_kind[0] is not None:
            flow.ret_value = GV(ret_kind[0], final["_rv"])
        flow.break_mask = break_saved
        flow.continue_mask = continue_saved
        flow.mask = saved_mask

    # ------------------------------------------------------------------ #
    # Stores

    def _merge(self, old: GV, new: GV, mask) -> GV:
        if mask is None or mask is True:
            return new
        if mask is False:
            return old
        new = self._convert(new, old.kind) if old.kind != new.kind else new
        mask_data = mask
        if not _is_scalar_kind(old.kind):
            mask_data = jnp.asarray(mask)[..., None]
        merged = jnp.where(mask_data, jnp.asarray(new.data), jnp.asarray(old.data))
        return GV(old.kind, merged)

    def store(self, target, value: GV, env: _Env, flow: _Flow) -> None:
        active = flow.active()
        if target[0] == "ident":
            name = target[1]
            owner = env.owner(name)
            if owner is None:
                raise GlslError(f"{self.origin}: assignment to undeclared {name!r}")
            old = owner.vars[name]
            if old.kind != value.kind:
                value = self._convert(value, old.kind)
            owner.vars[name] = self._merge(old, value, active)
            return
        if target[0] == "member":
            base_ast, member = target[1], target[2]
            base = self.eval(base_ast, env, flow)
            if base.kind not in _VEC_SIZE:
                raise GlslError(f"{self.origin}: cannot assign member of {base.kind}")
            idx = [_SWIZZLE[c] for c in member]
            new_base = self._swizzle_store(base, idx, value, active)
            self.store(base_ast, new_base, env, _Flow())  # already masked
            return
        if target[0] == "index":
            base_ast, index_ast = target[1], target[2]
            base = self.eval(base_ast, env, flow)
            index = self.eval(index_ast, env, flow)
            if not index.is_python:
                raise GlslError(f"{self.origin}: dynamic indexed store unsupported")
            if base.kind in _VEC_SIZE:
                new_base = self._swizzle_store(base, [int(index.data)], value, active)
            elif base.kind.startswith("array"):
                elem = jnp.asarray(value.data)
                data = jnp.asarray(base.data).at[int(index.data)].set(elem)
                new_base = GV(base.kind, data)
            else:
                raise GlslError(f"{self.origin}: cannot index-store {base.kind}")
            self.store(base_ast, new_base, env, _Flow())
            return
        raise GlslError(f"{self.origin}: invalid assignment target {target[0]!r}")

    def _swizzle_store(self, base: GV, idx: list[int], value: GV, mask) -> GV:
        n = base.components
        data = jnp.asarray(base.data, jnp.float32 if base.kind.startswith("vec")
                           else None)
        # Promote constant vectors against per-pixel stores
        value_data = jnp.asarray(value.data)
        if len(idx) == 1:
            parts = value_data[..., None] if value.kind in _VEC_SIZE else \
                _pixelwise(value.data)
            new_components = {idx[0]: (parts[..., 0] if hasattr(parts, "ndim")
                                       and getattr(parts, "ndim", 0) > 0
                                       and parts.shape[-1:] == (1,) else value_data)}
        else:
            new_components = {j: value_data[..., k] for k, j in enumerate(idx)}
        columns = []
        for j in range(n):
            old_j = data[..., j]
            if j in new_components:
                new_j = new_components[j]
                if mask is None or mask is True:
                    merged = jnp.broadcast_to(
                        jnp.asarray(new_j),
                        jnp.broadcast_shapes(jnp.shape(new_j), jnp.shape(old_j)))
                elif mask is False:
                    merged = old_j
                else:
                    merged = jnp.where(mask, new_j, old_j)
                columns.append(merged)
            else:
                columns.append(old_j)
        shape = jnp.broadcast_shapes(*(jnp.shape(c) for c in columns))
        columns = [jnp.broadcast_to(jnp.asarray(c, data.dtype), shape)
                   for c in columns]
        return GV(base.kind, jnp.stack(columns, axis=-1))

    # ------------------------------------------------------------------ #
    # Expressions

    def eval(self, ast, env: _Env, flow: _Flow) -> GV:
        op = ast[0]
        if op == "num":
            value = ast[1]
            if isinstance(value, bool):
                return GV("bool", value)
            return GV("int" if isinstance(value, int) else "float", value)
        if op == "ident":
            return self.resolve(ast[1], env)
        if op == "binary":
            return self.eval_binary(ast[1], self.eval(ast[2], env, flow),
                                    self.eval(ast[3], env, flow))
        if op == "unary":
            return self.eval_unary(ast[1], self.eval(ast[2], env, flow))
        if op == "ternary":
            cond = self.eval(ast[1], env, flow)
            if cond.is_python:
                return self.eval(ast[2] if cond.data else ast[3], env, flow)
            a = self.eval(ast[2], env, flow)
            b = self.eval(ast[3], env, flow)
            kind = a.kind if not _is_scalar_kind(a.kind) else _promote_num(a, b)
            a = self._convert(a, kind)
            b = self._convert(b, kind)
            mask = jnp.asarray(cond.data, bool)
            if kind in _VEC_SIZE:
                mask = mask[..., None] if mask.ndim > 0 else mask
            return GV(kind, jnp.where(mask, jnp.asarray(a.data), jnp.asarray(b.data)))
        if op == "assign":
            _, aop, target, value_ast = ast
            value = self.eval(value_ast, env, flow)
            if aop != "=":
                current = self.eval(target, env, flow)
                value = self.eval_binary(aop[0], current, value)
            self.store(target, value, env, flow)
            return value
        if op in ("prefix", "postfix"):
            _, pop, target = ast
            current = self.eval(target, env, flow)
            one = GV("int", 1)
            updated = self.eval_binary("+" if pop == "++" else "-", current, one)
            self.store(target, updated, env, flow)
            return updated if op == "prefix" else current
        if op == "member":
            return self.eval_member(ast, env, flow)
        if op == "index":
            base = self.eval(ast[1], env, flow)
            index = self.eval(ast[2], env, flow)
            return self.eval_index(base, index)
        if op == "call":
            return self.eval_call(ast, env, flow)
        if op == "comma":
            self.eval(ast[1], env, flow)
            return self.eval(ast[2], env, flow)
        raise GlslError(f"{self.origin}: unhandled expression {op!r}")

    # -- identifier resolution --------------------------------------------
    def resolve(self, name: str, env: _Env) -> GV:
        value = env.lookup(name)
        if value is not None:
            return value
        if name in _CONSTANTS:
            return GV("float", _CONSTANTS[name])
        sf = self.sf
        if name in ("astuv", "agluv", "stuv", "gluv", "stxy", "glxy"):
            return GV("vec2", getattr(sf, name))
        if name == "sgluv":
            return GV("vec2", sf.gluv)
        if name in ("instance", "gl_InstanceID"):
            return GV("int", sf.instance)  # vertex/default.glsl:5
        # uniforms
        uniform = sf._uniforms.get(name, sf._statics.get(name))
        if uniform is not None:
            return self._wrap_uniform(uniform)
        # textures ('name' or 'name<T>x<L>')
        sampler = self._try_sampler(name)
        if sampler is not None:
            return sampler
        raise GlslError(f"{self.origin}: unknown identifier {name!r}")

    def _wrap_uniform(self, value) -> GV:
        if isinstance(value, bool):
            return GV("bool", value)
        if isinstance(value, int):
            return GV("int", value)
        if isinstance(value, float):
            return GV("float", value)
        arr = jnp.asarray(value)
        if arr.ndim == 0:
            kind = ("int" if jnp.issubdtype(arr.dtype, jnp.integer) else
                    "bool" if arr.dtype == bool else "float")
            return GV(kind, arr)
        if arr.ndim == 1 and arr.shape[0] in (2, 3, 4):
            return GV(f"vec{arr.shape[0]}", arr)
        raise GlslError(f"{self.origin}: cannot map uniform of shape {arr.shape}")

    def _try_sampler(self, name: str) -> Optional[GV]:
        sf = self.sf
        if name in sf._textures:
            return GV("sampler", sf.tex(name))
        m = re.fullmatch(r"(\w+?)(\d+)x(\d+)", name)
        if m and m.group(1) in sf._textures:
            return GV("sampler", sf.tex(m.group(1), temporal=int(m.group(2)),
                                        layer=int(m.group(3))))
        # `iTexT` alias = temporal T, last layer (reference texture.py:359-360)
        m = re.fullmatch(r"(\w+?)(\d+)", name)
        if m and m.group(1) in sf._textures:
            return GV("sampler", sf.tex(m.group(1), temporal=int(m.group(2))))
        return None

    # -- operators ---------------------------------------------------------
    def eval_binary(self, op: str, a: GV, b: GV) -> GV:
        if op in ("&&", "||"):
            if a.is_python and b.is_python:
                return GV("bool", (a.data and b.data) if op == "&&"
                          else (a.data or b.data))
            fn = jnp.logical_and if op == "&&" else jnp.logical_or
            return GV("bool", fn(jnp.asarray(a.data, bool), jnp.asarray(b.data, bool)))

        # matrices
        if a.kind in _MAT_SIZE or b.kind in _MAT_SIZE:
            return self._matrix_binary(op, a, b)

        if op in ("<", ">", "<=", ">=", "==", "!="):
            va, vb = self._align(a, b)
            if isinstance(va, (int, float, bool)) and isinstance(vb, (int, float, bool)):
                return GV("bool", _PY_BINOPS[op](va, vb))
            return GV("bool", _PY_BINOPS[op](jnp.asarray(va), jnp.asarray(vb)))

        kind = self._result_kind(a, b)
        va, vb = self._align(a, b)
        if op == "/" and kind not in ("int",) and "int" in (a.kind, b.kind):
            pass  # float division once either side is float
        if op == "%":
            fn = (lambda x, y: sl.glsl_mod(x, y)) if kind == "float" else \
                 (lambda x, y: x % y)
            result = fn(va, vb)
        elif op == "/" and kind == "int" and a.kind == "int" and b.kind == "int":
            if isinstance(va, int) and isinstance(vb, int):
                result = int(va / vb) if vb != 0 else 0
            else:
                result = jnp.asarray(va, jnp.int32) // jnp.asarray(vb, jnp.int32)
        else:
            if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
                result = _PY_BINOPS[op](va, vb)
            else:
                result = _PY_BINOPS[op](jnp.asarray(va), jnp.asarray(vb))
        return GV(kind, result)

    def _result_kind(self, a: GV, b: GV) -> str:
        if a.kind in _VEC_SIZE and b.kind in _VEC_SIZE:
            if a.components != b.components:
                raise GlslError(f"{self.origin}: {a.kind} vs {b.kind}")
            return a.kind if a.kind.startswith("vec") else b.kind
        if a.kind in _VEC_SIZE:
            return a.kind
        if b.kind in _VEC_SIZE:
            return b.kind
        return _promote_num(a, b)

    def _align(self, a: GV, b: GV):
        """Payloads ready for a componentwise binary op."""
        va, vb = a.data, b.data
        if a.kind in _VEC_SIZE and _is_scalar_kind(b.kind):
            vb = _pixelwise(vb)
        elif b.kind in _VEC_SIZE and _is_scalar_kind(a.kind):
            va = _pixelwise(va)
        return va, vb

    def _matrix_binary(self, op: str, a: GV, b: GV) -> GV:
        if op != "*":
            raise GlslError(f"{self.origin}: matrix op {op!r} unsupported")
        if a.kind in _MAT_SIZE and b.kind in _VEC_SIZE:
            return GV(b.kind, jnp.einsum("...ij,...j->...i",
                                         jnp.asarray(a.data), jnp.asarray(b.data)))
        if a.kind in _VEC_SIZE and b.kind in _MAT_SIZE:
            return GV(a.kind, jnp.einsum("...i,...ij->...j",
                                         jnp.asarray(a.data), jnp.asarray(b.data)))
        if a.kind in _MAT_SIZE and b.kind in _MAT_SIZE:
            return GV(a.kind, jnp.asarray(a.data) @ jnp.asarray(b.data))
        if _is_scalar_kind(b.kind):
            return GV(a.kind, jnp.asarray(a.data) * b.data)
        if _is_scalar_kind(a.kind):
            return GV(b.kind, a.data * jnp.asarray(b.data))
        raise GlslError(f"{self.origin}: matrix op {a.kind} * {b.kind}")

    def eval_unary(self, op: str, value: GV) -> GV:
        if op == "+":
            return value
        if op == "-":
            return GV(value.kind, -value.data if value.is_python
                      else -jnp.asarray(value.data))
        if op == "!":
            return GV("bool", (not value.data) if value.is_python
                      else jnp.logical_not(jnp.asarray(value.data, bool)))
        raise GlslError(f"{self.origin}: unary {op!r} unsupported")

    # -- members / swizzles ------------------------------------------------
    def eval_member(self, ast, env: _Env, flow: _Flow) -> GV:
        base = self.eval(ast[1], env, flow)
        member = ast[2]
        if base.kind == "camera":
            return self._camera_member(base.data, member)
        if base.kind in _VEC_SIZE:
            if any(c not in _SWIZZLE for c in member):
                raise GlslError(f"{self.origin}: bad swizzle .{member}")
            idx = [_SWIZZLE[c] for c in member]
            data = jnp.asarray(base.data)
            scalar_kind = ("int" if base.kind.startswith("i") else
                           "bool" if base.kind.startswith("b") else "float")
            if len(idx) == 1:
                return GV(scalar_kind, data[..., idx[0]])
            picked = data[..., jnp.array(idx)] if len(set(idx)) != len(idx) \
                else data[..., idx[0]:idx[-1] + 1] \
                if idx == list(range(idx[0], idx[-1] + 1)) else data[..., jnp.array(idx)]
            prefix = "i" if base.kind.startswith("i") else \
                     "b" if base.kind.startswith("b") else ""
            return GV(f"{prefix}vec{len(idx)}", picked)
        raise GlslError(f"{self.origin}: member .{member} on {base.kind}")

    def _camera_member(self, rays, member: str) -> GV:
        vec3_fields = {"origin", "target", "position", "forward", "up", "right"}
        vec2_fields = {"gluv", "agluv", "stuv", "astuv", "stxy", "glxy"}
        alias = {"upward": "up"}
        member_l = alias.get(member, member)
        if member_l in vec2_fields:
            return GV("vec2", getattr(rays, member_l))
        if member_l in vec3_fields:
            return GV("vec3", getattr(rays, member_l))
        if member_l == "out_of_bounds":
            return GV("bool", rays.out_of_bounds)
        if member_l == "ray" or member_l == "direction":
            return GV("vec3", rays.ray_direction)
        # scalar camera uniforms: zoom, isometric, orbital, dolly, ...
        uniform_name = "iCamera" + "".join(
            part.capitalize() for part in member.split("_"))
        value = self.sf._uniforms.get(uniform_name,
                                      self.sf._statics.get(uniform_name))
        if value is not None:
            return self._wrap_uniform(value)
        raise GlslError(f"{self.origin}: camera has no member .{member}")

    def eval_index(self, base: GV, index: GV) -> GV:
        if base.kind in _VEC_SIZE:
            data = jnp.asarray(base.data)
            scalar_kind = ("int" if base.kind.startswith("i") else
                           "bool" if base.kind.startswith("b") else "float")
            if index.is_python:
                return GV(scalar_kind, data[..., int(index.data)])
            idx = jnp.asarray(index.data, jnp.int32)
            return GV(scalar_kind, jnp.take_along_axis(
                jnp.broadcast_to(data, idx.shape + data.shape[-1:]),
                idx[..., None], axis=-1)[..., 0])
        if base.kind.startswith("array:"):
            elem_kind = base.kind.split(":")[1]
            data = jnp.asarray(base.data)
            if index.is_python:
                return GV(elem_kind, data[int(index.data)])
            return GV(elem_kind, jnp.take(data, jnp.asarray(index.data, jnp.int32),
                                          mode="clip"))
        if base.kind in _MAT_SIZE:
            if not index.is_python:
                raise GlslError(f"{self.origin}: dynamic matrix index")
            n = _MAT_SIZE[base.kind]
            return GV(f"vec{n}", jnp.asarray(base.data)[..., int(index.data), :])
        raise GlslError(f"{self.origin}: cannot index {base.kind}")

    # -- calls -------------------------------------------------------------
    def eval_call(self, ast, env: _Env, flow: _Flow) -> GV:
        callee = ast[1]
        if callee[0] == "arraytype":
            _, elem_type, size = callee
            args = [self.eval(a, env, flow) for a in ast[2]]
            if len(args) != size:
                raise GlslError(f"{self.origin}: array ctor arity")
            dtype = jnp.int32 if elem_type == "int" else jnp.float32
            return GV(f"array:{elem_type}",
                      jnp.asarray([a.data for a in args], dtype))
        name = callee[1]

        # GetCamera(iCamera): bind the camera struct into the caller scope
        if name == "GetCamera":
            target = ast[2][0]
            if target[0] != "ident":
                raise GlslError(f"{self.origin}: GetCamera needs a name")
            cam_name = target[1]
            env.declare(cam_name, GV("camera", self.sf.get_camera(cam_name)))
            return GV("void", None)

        args = [self.eval(a, env, flow) for a in ast[2]]

        # Constructors
        if name in _VEC_SIZE:
            return self._construct_vec(name, args)
        if name in _MAT_SIZE:
            return self._construct_mat(name, args)
        if name in ("float", "int", "bool", "uint"):
            return self._cast_scalar(name, args[0])

        # User-defined functions
        if name in self.functions:
            return self.call_user(self.functions[name], args)

        # <Name>Texture(t, l, uv) metaprogrammer accessors: plain texture()
        # on the (t, l) box (reference texture.py:363-367)
        m = re.fullmatch(r"(\w+?)Texture", name)
        if m and m.group(1) in self.sf._textures:
            t, layer, uv = args
            if not (t.is_python and layer.is_python):
                raise GlslError(
                    f"{self.origin}: {name}(t, l, uv) needs statically "
                    "countable t/l (a python loop counter or literal)")
            sampler = self.sf.tex(m.group(1), temporal=int(t.data),
                                  layer=int(layer.data))
            return self._pad_vec4(ops.sample(sampler, jnp.asarray(uv.data)))

        builtin = _BUILTINS.get(name)
        if builtin is not None:
            return builtin(self, args)
        raise GlslError(f"{self.origin}: unknown function {name!r}")

    def call_user(self, func, args: list[GV]) -> GV:
        _, ret_type, name, params, body = func
        if len(args) != len(params):
            raise GlslError(f"{self.origin}: {name} expects {len(params)} args")
        env = _Env()
        for (ptype, pname), arg in zip(params, args):
            env.declare(pname, self._coerce_decl(ptype, None, arg))
        flow = _Flow()
        self.exec_block(body, env, flow)
        if ret_type == "void":
            return GV("void", None)
        if flow.ret_value is None:
            raise GlslError(f"{self.origin}: {name} returned no value")
        return self._convert(flow.ret_value, ret_type)

    # -- constructors / conversions ---------------------------------------
    def _construct_vec(self, kind: str, args: list[GV]) -> GV:
        n = _VEC_SIZE[kind]
        dtype = (jnp.int32 if kind.startswith("i") else
                 bool if kind.startswith("b") else jnp.float32)
        parts = []
        for arg in args:
            if arg.kind in _VEC_SIZE:
                data = jnp.asarray(arg.data)
                for j in range(arg.components):
                    parts.append(data[..., j])
            else:
                parts.append(arg.data)
        if len(parts) == 1:
            parts = parts * n
        if len(parts) != n:
            raise GlslError(f"{self.origin}: {kind} constructor with "
                            f"{len(parts)} components")
        shape = jnp.broadcast_shapes(*(jnp.shape(p) for p in parts))
        columns = [jnp.broadcast_to(jnp.asarray(p, dtype), shape) for p in parts]
        return GV(kind, jnp.stack(columns, axis=-1))

    def _construct_mat(self, kind: str, args: list[GV]) -> GV:
        n = _MAT_SIZE[kind]
        if len(args) == 1 and _is_scalar_kind(args[0].kind):
            return GV(kind, jnp.eye(n, dtype=jnp.float32) * args[0].data)
        flat = []
        for arg in args:
            if arg.kind in _VEC_SIZE:
                data = jnp.asarray(arg.data)
                flat.extend(data[..., j] for j in range(arg.components))
            else:
                flat.append(arg.data)
        if len(flat) != n * n:
            raise GlslError(f"{self.origin}: {kind} constructor arity")
        # GLSL matrices are column-major: mat2(a,b,c,d) has columns (a,b),(c,d)
        cols = [jnp.stack([jnp.asarray(flat[c * n + r], jnp.float32)
                           for r in range(n)], axis=-1) for c in range(n)]
        return GV(kind, jnp.stack(cols, axis=-1))  # (..., row, col)

    def _cast_scalar(self, kind: str, value: GV) -> GV:
        kind = "int" if kind == "uint" else kind
        if value.is_python:
            py = {"float": float, "int": int, "bool": bool}[kind]
            return GV(kind, py(value.data))
        arr = jnp.asarray(value.data)
        dtype = {"float": jnp.float32, "int": jnp.int32, "bool": bool}[kind]
        if kind == "int":
            arr = jnp.trunc(arr) if jnp.issubdtype(arr.dtype, jnp.floating) else arr
        return GV(kind, arr.astype(dtype))

    def _convert(self, value: GV, kind: str) -> GV:
        if value.kind == kind:
            return value
        if _is_scalar_kind(kind) and _is_scalar_kind(value.kind):
            return self._cast_scalar(kind, value)
        if kind in _VEC_SIZE and _is_scalar_kind(value.kind):
            return self._construct_vec(kind, [value])
        if kind in _VEC_SIZE and value.kind in _VEC_SIZE \
                and _VEC_SIZE[kind] == _VEC_SIZE[value.kind]:
            dtype = (jnp.int32 if kind.startswith("i") else
                     bool if kind.startswith("b") else jnp.float32)
            return GV(kind, jnp.asarray(value.data, dtype))
        raise GlslError(f"{self.origin}: cannot convert {value.kind} -> {kind}")

    def _default_value(self, type_name: str, size: Optional[int]) -> GV:
        if size is not None:
            dtype = jnp.int32 if type_name == "int" else jnp.float32
            return GV(f"array:{type_name}", jnp.zeros(size, dtype))
        if type_name in _VEC_SIZE:
            dtype = (jnp.int32 if type_name.startswith("i") else
                     bool if type_name.startswith("b") else jnp.float32)
            return GV(type_name, jnp.zeros(_VEC_SIZE[type_name], dtype))
        if type_name in _MAT_SIZE:
            return GV(type_name, jnp.eye(_MAT_SIZE[type_name], dtype=jnp.float32))
        if type_name == "int":
            return GV("int", 0)
        if type_name == "bool":
            return GV("bool", False)
        return GV("float", 0.0)

    def _coerce_decl(self, type_name: str, size: Optional[int], value: GV) -> GV:
        if size is not None:
            if not value.kind.startswith("array"):
                raise GlslError(f"{self.origin}: array initializer expected")
            return GV(f"array:{type_name}", value.data)
        if type_name == "sampler2D":
            if value.kind != "sampler":
                raise GlslError(f"{self.origin}: sampler2D initializer expected")
            return value
        return self._convert(value, type_name)

    # -- texturing ---------------------------------------------------------
    def _sampler_arg(self, value: GV) -> Sampler2D:
        if value.kind == "sampler":
            return value.data
        raise GlslError(f"{self.origin}: expected a sampler")

    def _pad_vec4(self, data) -> GV:
        """GL pads missing texture components with (0, 0, 0, 1)."""
        data = jnp.asarray(data)
        channels = data.shape[-1]
        if channels == 4:
            return GV("vec4", data)
        fill = [data[..., j] for j in range(channels)]
        zeros = jnp.zeros_like(data[..., 0])
        while len(fill) < 3:
            fill.append(zeros)
        fill.append(jnp.ones_like(zeros))
        return GV("vec4", jnp.stack(fill, axis=-1))


# =========================================================================== #
# Builtin function table

_CONSTANTS = {"PI": sl.PI, "TAU": sl.TAU, "EULER": math.e,
              "E": math.e, "PHI": (1 + 5 ** 0.5) / 2}

_PY_BINOPS: dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "<": lambda a, b: a < b, ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}


def _componentwise(fn_jnp, fn_py=None):
    """Builtin applying componentwise over any mix of scalars/vectors,
    preserving python scalars (shadow-loop friendliness) when possible."""
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        if fn_py is not None and all(a.is_python for a in args):
            return GV("float", float(fn_py(*(a.data for a in args))))
        kind = "float"
        for a in args:
            if a.kind in _VEC_SIZE:
                kind = a.kind if not a.kind.startswith(("i", "b")) else \
                    "vec" + a.kind[-1]
                break
        payloads = []
        for a in args:
            if _is_scalar_kind(a.kind) and kind in _VEC_SIZE:
                payloads.append(_pixelwise(a.data))
            else:
                payloads.append(jnp.asarray(a.data, jnp.float32)
                                if not a.is_python else a.data)
        return GV(kind, fn_jnp(*payloads))
    return impl


def _vec_reduce(fn, out_kind="float"):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        return GV(out_kind, fn(*(jnp.asarray(a.data, jnp.float32)
                                 for a in args)))
    return impl


def _bi_texture(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    return interp._pad_vec4(ops.sample(sampler, jnp.asarray(args[1].data)))


def _bi_texel_fetch(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    xy = jnp.asarray(args[1].data)
    return interp._pad_vec4(ops.texel_fetch(sampler, xy))


def _bi_texture_size(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    height, width = sampler.data.shape[:2]
    return GV("ivec2", jnp.asarray([width, height], jnp.int32))


def _space_texture(attr: str):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        sampler = interp._sampler_arg(args[0])
        uv = jnp.asarray(args[1].data)
        return interp._pad_vec4(getattr(ops, attr)(sampler, uv))
    return impl


def _bi_agtexture(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    uv = jnp.asarray(args[1].data)
    return interp._pad_vec4(
        ops.agtexture(sampler, uv, interp.sf.uniform("iWantAspect")))


def _bi_rotate2d(interp: Interpreter, args: list[GV]) -> GV:
    # shaderflow.glsl:75 mat2(c,-s,s,c) is COLUMN-major: columns (c,-s),(s,c)
    # -> the (row, col) matrix is [[c, s], [-s, c]]
    angle = args[0].data
    cos = jnp.cos(angle) if not args[0].is_python else math.cos(angle)
    sin = jnp.sin(angle) if not args[0].is_python else math.sin(angle)
    row0 = jnp.stack([jnp.asarray(cos, jnp.float32),
                      jnp.asarray(sin, jnp.float32)], axis=-1)
    row1 = jnp.stack([jnp.asarray(-sin, jnp.float32),
                      jnp.asarray(cos, jnp.float32)], axis=-1)
    return GV("mat2", jnp.stack([row0, row1], axis=-2))


def _bi_zoom(interp: Interpreter, args: list[GV]) -> GV:
    uv = jnp.asarray(args[0].data)
    factor = args[1].data
    anchor = jnp.asarray(args[2].data) if len(args) > 2 else None
    return GV("vec2", sl.zoom(uv, _pixelwise(factor), anchor))


def _coordinate_map(fn, n_extra=0):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        payloads = [jnp.asarray(args[0].data)]
        payloads += [a.data for a in args[1:]]
        return GV("vec2", fn(*payloads))
    return impl


def _bi_mix(interp: Interpreter, args: list[GV]) -> GV:
    a, b, t = args
    kind = a.kind if a.kind in _VEC_SIZE else (
        b.kind if b.kind in _VEC_SIZE else "float")
    da = _pixelwise(a.data) if _is_scalar_kind(a.kind) and kind in _VEC_SIZE else a.data
    db = _pixelwise(b.data) if _is_scalar_kind(b.kind) and kind in _VEC_SIZE else b.data
    dt = _pixelwise(t.data) if _is_scalar_kind(t.kind) and kind in _VEC_SIZE else t.data
    if all(isinstance(v, (int, float)) for v in (da, db, dt)):
        return GV("float", da * (1 - dt) + db * dt)
    return GV(kind, sl.mix(jnp.asarray(da, jnp.float32),
                           jnp.asarray(db, jnp.float32), dt))


def _sd(fn):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        return GV("float", fn(*(jnp.asarray(a.data, jnp.float32)
                                if not a.is_python else a.data for a in args)))
    return impl


_BUILTINS: dict[str, Callable[[Interpreter, list[GV]], GV]] = {
    # angle & trig
    "sin": _componentwise(jnp.sin, math.sin), "cos": _componentwise(jnp.cos, math.cos),
    "tan": _componentwise(jnp.tan, math.tan), "asin": _componentwise(jnp.arcsin),
    "acos": _componentwise(jnp.arccos),
    "atan": _componentwise(lambda y, x=None: jnp.arctan(y) if x is None
                           else jnp.arctan2(y, x)),
    "sinh": _componentwise(jnp.sinh), "cosh": _componentwise(jnp.cosh),
    "tanh": _componentwise(jnp.tanh),
    "radians": _componentwise(jnp.deg2rad, math.radians),
    "degrees": _componentwise(jnp.rad2deg, math.degrees),
    # exponential
    "pow": _componentwise(jnp.power, math.pow), "exp": _componentwise(jnp.exp),
    "log": _componentwise(jnp.log), "exp2": _componentwise(jnp.exp2),
    "log2": _componentwise(jnp.log2), "sqrt": _componentwise(jnp.sqrt, math.sqrt),
    "inversesqrt": _componentwise(lambda x: 1.0 / jnp.sqrt(x)),
    # common
    "abs": _componentwise(jnp.abs, abs), "sign": _componentwise(jnp.sign),
    "floor": _componentwise(jnp.floor, math.floor),
    "ceil": _componentwise(jnp.ceil, math.ceil),
    "fract": _componentwise(sl.fract), "mod": _componentwise(sl.glsl_mod),
    "min": _componentwise(jnp.minimum, min), "max": _componentwise(jnp.maximum, max),
    "clamp": _componentwise(jnp.clip),
    "mix": _bi_mix, "lerp": _bi_mix,
    "step": _componentwise(lambda e, x: (x >= e).astype(jnp.float32)),
    "smoothstep": _componentwise(sl.smoothstep),
    "round": _componentwise(jnp.round),
    "trunc": _componentwise(jnp.trunc),
    # geometric
    "length": _vec_reduce(sl.length), "distance": _vec_reduce(sl.distance),
    "dot": _vec_reduce(sl.dot),
    "cross": _vec_reduce(sl.cross, out_kind="vec3"),
    "normalize": lambda interp, args: GV(args[0].kind,
                                         sl.normalize(jnp.asarray(args[0].data))),
    "reflect": _vec_reduce(sl.reflect, out_kind="vec3"),
    # texturing
    "texture": _bi_texture, "texture2D": _bi_texture,
    "texelFetch": _bi_texel_fetch, "textureSize": _bi_texture_size,
    "stexture": _space_texture("stexture"), "gtexture": _space_texture("gtexture"),
    "astexture": _space_texture("astexture"), "agtexture": _bi_agtexture,
    # shaderflow.glsl
    "rotate2d": _bi_rotate2d,
    "rotate2deg": lambda interp, args: _bi_rotate2d(
        interp, [GV("float", jnp.deg2rad(jnp.asarray(args[0].data))
                  if not args[0].is_python else math.radians(args[0].data))]),
    "zoom": _bi_zoom,
    "stuv2gluv": _coordinate_map(sl.stuv2gluv),
    "gluv2stuv": _coordinate_map(sl.gluv2stuv),
    "agluv2gluv": _coordinate_map(sl.agluv2gluv),
    "gluv2agluv": _coordinate_map(sl.gluv2agluv),
    "stuv2stxy": _coordinate_map(sl.stuv2stxy),
    "stxy2stuv": _coordinate_map(sl.stxy2stuv),
    "astuv2stuv": _coordinate_map(sl.astuv2stuv),
    "stuv2astuv": _coordinate_map(sl.stuv2astuv),
    "atan1": _vec_reduce(sl.atan1), "atan1n": _vec_reduce(sl.atan1n),
    "atan2": _componentwise(jnp.arctan2),
    "atan2n": _componentwise(lambda y, x: jnp.arctan2(y, x) / sl.TAU),
    "atan_normalized": _componentwise(sl.atan_normalized),
    "palette": _vec_reduce(sl.palette, out_kind="vec3"),
    "palette_magma": lambda interp, args: GV("vec3", sl.palette_magma(
        jnp.asarray(args[0].data, jnp.float32))),
    "hsv2rgb": _vec_reduce(sl.hsv2rgb, out_kind="vec3"),
    "rgb2hsv": _vec_reduce(sl.rgb2hsv, out_kind="vec3"),
    "noise21": _vec_reduce(sl.noise21),
    "noise22": _vec_reduce(sl.noise22, out_kind="vec2"),
    "smin": _componentwise(sl.smin), "smax": _componentwise(sl.smax),
    "proportion": _componentwise(sl.proportion),
    "smoothlerp": _componentwise(sl.smoothlerp),
    "isBlackKey": _componentwise(sl.is_black_key),
    "isWhiteKey": _componentwise(sl.is_white_key),
    # signed distance library (shaderflow.glsl:270-350)
    "sdLine": _sd(sl.sd_line), "sdLineSegment": _sd(sl.sd_line_segment),
    "sdSphere": _sd(sl.sd_sphere), "sdPlane": _sd(sl.sd_plane),
    "sdBox": _sd(sl.sd_box), "sdOctahedron": _sd(sl.sd_octahedron),
    "sdUnion": _sd(sl.sd_union), "sdSmoothUnion": _sd(sl.sd_smooth_union),
    "sdSubtraction": _sd(sl.sd_subtraction),
    "sdSmoothSubtraction": _sd(sl.sd_smooth_subtraction),
    "sdIntersection": _sd(sl.sd_intersection),
    "sdSmoothIntersection": _sd(sl.sd_smooth_intersection),
    "blend": _vec_reduce(sl.blend, out_kind="vec4"),
    "alphaComposite": _vec_reduce(sl.alpha_composite, out_kind="vec4"),
    "saturate_color": _vec_reduce(sl.saturate, out_kind="vec3"),
}


# =========================================================================== #
# Entry point

def looks_like_glsl(source: str) -> bool:
    """Heuristic used by ShaderProgram.compile to route sources: GLSL main
    is `void main()`, python shaders are `def main(sf)`."""
    return bool(re.search(r"\bvoid\s+main\s*\(", source))


def compile_fragment(source: str, origin: str = "<glsl>") -> Callable:
    """Parse GLSL fragment source -> PixelFunction main(sf) -> (H, W, 4).

    The parse happens once here (syntax errors surface immediately, matching
    the reference's compile-time GLSL errors); the returned callable
    interprets the AST inside the render trace.
    """
    tokens = tokenize(source, origin)
    unit = Parser(tokens, origin).parse_unit()
    interpreter = Interpreter(unit, origin)

    def main(sf):
        return interpreter.run(sf)

    main.__name__ = f"glsl_main[{origin}]"
    main.glsl_interpreter = interpreter
    return main
