"""muparser-style math expression compiler -> torch functions.

The torch counterpart of dflo_tpu/config/expressions.py (which replaces
deal.II's FunctionParser, src/parameters.cc:470-527): ICs, BCs, external
forces, gravity potentials and the solid-cell mask in .prm files are math
expressions in x, y (,t) — e.g. ``1.0*(x<=0.5)+0.125*(x>0.5)`` or
``(x>0.6)*(y<0.2)``.

Expressions are parsed with the Python ast module against the same strict
whitelist (no eval of arbitrary code) and compiled to closures over torch
ops.  muparser's ``^`` power operator and ``if(cond, a, b)`` ternary are
translated.  Numeric constants become 0-dim tensors of the first
variable's dtype and device, so they combine with tensors the way the
reference's weakly typed scalars do (a constant times a comparison is a
float of the variables' dtype, never of torch's default dtype), and a
constant expression broadcasts to the first variable's shape.
"""

from __future__ import annotations

import ast
import re
from typing import Callable

import numpy as np
import torch

_FUNCS: dict[str, Callable] = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.arcsin, "acos": torch.arccos, "atan": torch.arctan,
    "atan2": torch.atan2,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "log10": torch.log10, "ln": torch.log,
    "sqrt": torch.sqrt, "abs": torch.abs, "fabs": torch.abs,
    "pow": torch.pow, "min": torch.minimum, "max": torch.maximum,
    "floor": torch.floor, "ceil": torch.ceil, "sign": torch.sign,
    "erf": torch.special.erf,
    "where": torch.where,  # muparser's if(c,a,b)
}

_CONSTS = {"pi": np.pi, "Pi": np.pi, "PI": np.pi, "e": np.e, "E": np.e,
           # deal.II FunctionParser spellings
           "_pi": np.pi, "_e": np.e}

_ALLOWED_BINOPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.Mod)
_ALLOWED_UNARY = (ast.UAdd, ast.USub)
_ALLOWED_CMP = (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq)
_CMP_OPS = {ast.Lt: torch.lt, ast.LtE: torch.le, ast.Gt: torch.gt,
            ast.GtE: torch.ge, ast.Eq: torch.eq, ast.NotEq: torch.ne}


class _Validator(ast.NodeVisitor):
    def __init__(self, variables):
        self.variables = set(variables)

    def generic_visit(self, node):
        ok = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Compare,
              ast.Call, ast.Name, ast.Constant, ast.BoolOp, ast.And, ast.Or,
              ast.Load) + _ALLOWED_BINOPS + _ALLOWED_UNARY + _ALLOWED_CMP
        if not isinstance(node, ok):
            raise ValueError(f"disallowed syntax in expression: "
                             f"{type(node).__name__}")
        super().generic_visit(node)

    def visit_Call(self, node):
        if not isinstance(node.func, ast.Name) or node.func.id not in _FUNCS:
            name = getattr(node.func, "id", "?")
            raise ValueError(f"unknown function {name!r} in expression")
        for a in node.args:
            self.visit(a)
        if node.keywords:
            raise ValueError("keyword arguments not allowed in expressions")

    def visit_Name(self, node):
        if node.id not in self.variables and node.id not in _CONSTS:
            raise ValueError(f"unknown variable {node.id!r} in expression "
                             f"(allowed: {sorted(self.variables)})")

    def visit_Constant(self, node):
        if not isinstance(node.value, (int, float)):
            raise ValueError("only numeric constants allowed")


def _translate(expr: str) -> str:
    """muparser -> python: '^' is power; 'if(c,a,b)' renamed (keyword clash);
    '&&'/'||' -> and/or."""
    out = expr.replace("^", "**").replace("&&", " and ").replace("||", " or ")
    return re.sub(r"\bif\s*\(", "where(", out)


def compile_expression(expr: str, variables=("x", "y", "t")) -> Callable:
    """Compile one scalar expression into fn(*variables) -> tensor shaped
    like the first variable (a torch tensor)."""
    src = _translate(expr)
    try:
        tree = ast.parse(src, mode="eval")
    except SyntaxError as e:
        raise ValueError(f"cannot parse expression {expr!r}: {e}") from None
    _Validator(variables).visit(tree)

    def promote(a, b, const):
        """A comparison's bool plane beside a number becomes numbers of the
        variables' dtype, as JAX promotes it (torch refuses `1 - (x < s)`);
        two bool planes stay bool, as in JAX ((x > a)*(y < b) is a mask)."""
        if (a.dtype == torch.bool) != (b.dtype == torch.bool):
            fdt = const(0.0).dtype
            a, b = (v.to(fdt) if v.dtype == torch.bool else v for v in (a, b))
        return a, b

    def ev(node, env, const):
        if isinstance(node, ast.Expression):
            return ev(node.body, env, const)
        if isinstance(node, ast.Constant):
            return const(node.value)
        if isinstance(node, ast.Name):
            return env[node.id] if node.id in env else const(_CONSTS[node.id])
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand, env, const)
            return +v if isinstance(node.op, ast.UAdd) else -v
        if isinstance(node, ast.BinOp):
            a, b = promote(ev(node.left, env, const),
                           ev(node.right, env, const), const)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Div):
                return a / b
            if isinstance(node.op, ast.Mod):
                return torch.remainder(a, b)
            return torch.pow(a, b)
        if isinstance(node, ast.Compare):
            # chain comparisons like a < x < b as logical and
            res = None
            left = ev(node.left, env, const)
            for op, comp in zip(node.ops, node.comparators):
                right = ev(comp, env, const)
                r = _CMP_OPS[type(op)](left, right)
                res = r if res is None else torch.logical_and(res, r)
                left = right
            return res
        if isinstance(node, ast.BoolOp):
            vals = [ev(v, env, const) for v in node.values]
            op = (torch.logical_and if isinstance(node.op, ast.And)
                  else torch.logical_or)
            out = vals[0]
            for v in vals[1:]:
                out = op(out, v)
            return out
        if isinstance(node, ast.Call):
            args = [ev(a, env, const) for a in node.args]
            return _FUNCS[node.func.id](*args)
        raise AssertionError(type(node))

    def fn(*args):
        ref = torch.as_tensor(args[0])
        fdt = ref.dtype if ref.is_floating_point() else torch.float64

        def const(v):
            return torch.tensor(v, dtype=fdt, device=ref.device)

        env = {name: a if isinstance(a, torch.Tensor) else const(a)
               for name, a in zip(variables, args)}
        out = ev(tree, env, const)
        if out.dim() == 0:
            # a constant expression broadcasts to the variables' shape
            return out * torch.ones_like(ref, dtype=fdt)
        return out

    return fn


def compile_vector_expression(exprs, variables=("x", "y", "t")) -> Callable:
    """Compile dim+2 component expressions into fn(x, y, t) -> [4, ...]
    (the FunctionParser vector_value interface, src/parameters.h:402-407)."""
    fns = [compile_expression(e, variables) for e in exprs]

    def fn(x, y, t=0.0):
        return torch.stack([f(x, y, t) for f in fns])

    return fn
