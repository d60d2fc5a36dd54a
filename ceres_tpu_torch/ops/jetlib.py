"""Sparse forward-mode jets over two scalar types: the jet algebra of the
auto-jet linearize (K5, ops/lin_auto.py) and of its compiler
(ops/jet_compile.py).

Counterpart of ceres_tpu/ops/jetlib.py (:27-411; _correct_jets, :207;
_jet_planes, :402). A jet is a value and a {channel: partial} map;
a missing channel is a structural zero and a None partial is the exact
seed 1, so sparsity decays through the chain as in the reference's
Jet<T, N> (include/ceres/jet.h:211). Each chain rule is written once,
over a scalar that is one of:

  - a tensor (or a numpy f32 constant): CPU evaluation, used by the
    tests, where the operations are PyTorch's;
  - an emitter scalar (`Sym`): every operation appends one line of C++
    (`const float t42 = t7 * t9;`) to its `Emitter` and returns the new
    name, so evaluating a chain over Syms writes the CUDA code of that
    chain, and only the channels that are structurally nonzero are
    emitted.

The functions below dispatch on the scalar type: a Sym anywhere among
the operands emits, else a tensor computes with PyTorch, else numpy
computes the constant in f32. Emitted code is f32 throughout: literals
carry the `f` suffix and the math functions are the f32 ones (sqrtf,
atan2f, ...), so nothing runs in double.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ----------------------------------------------------------------------
# emitter scalars

def literal(x) -> str:
    """A C++ literal of a constant: f32 (`1.5f`) or bool."""
    if isinstance(x, (bool, np.bool_)):
        return "true" if x else "false"
    f = np.float32(x)
    if np.isnan(f):
        return "NAN"
    if np.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    s = "%.9g" % float(f)
    if not any(ch in s for ch in ".e"):
        s += ".0"
    s += "f"
    return f"({s})" if s.startswith("-") else s


class Sym:
    """An emitter scalar: the name of a C++ value (kind "f": float, "b":
    bool). Arithmetic and comparisons emit one line each."""
    __slots__ = ("em", "name", "kind")
    __array_ufunc__ = None          # numpy operands defer to these methods
    __hash__ = object.__hash__

    def __init__(self, em, name, kind="f"):
        self.em, self.name, self.kind = em, name, kind

    def __add__(self, o):
        return self.em.binop("+", self, o)

    def __radd__(self, o):
        return self.em.binop("+", o, self)

    def __sub__(self, o):
        return self.em.binop("-", self, o)

    def __rsub__(self, o):
        return self.em.binop("-", o, self)

    def __mul__(self, o):
        return self.em.binop("*", self, o)

    def __rmul__(self, o):
        return self.em.binop("*", o, self)

    def __truediv__(self, o):
        return self.em.binop("/", self, o)

    def __rtruediv__(self, o):
        return self.em.binop("/", o, self)

    def __neg__(self):
        return self.em.emit(f"-{self.name}")

    def __lt__(self, o):
        return self.em.binop("<", self, o)

    def __le__(self, o):
        return self.em.binop("<=", self, o)

    def __gt__(self, o):
        return self.em.binop(">", self, o)

    def __ge__(self, o):
        return self.em.binop(">=", self, o)

    def __eq__(self, o):
        return self.em.binop("==", self, o)

    def __ne__(self, o):
        return self.em.binop("!=", self, o)

    def __and__(self, o):
        return self.em.binop("&&", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return self.em.binop("||", self, o)

    __ror__ = __or__

    def __xor__(self, o):
        return self.em.binop("!=", self, o)

    def __invert__(self):
        return self.em.emit(f"!{self.name}", "b")


_BOOL_OPS = ("<", "<=", ">", ">=", "==", "!=", "&&", "||")


def operand(x) -> str:
    """The C++ text of a scalar: a Sym's name or a literal."""
    return x.name if isinstance(x, Sym) else literal(x)


def _is_const(x, value) -> bool:
    return (not isinstance(x, (Sym, torch.Tensor))
            and not isinstance(x, (bool, np.bool_)) and float(x) == value)


class Emitter:
    """Collects the lines of C++ that Sym arithmetic emits."""

    def __init__(self, prefix: str = "t"):
        self.prefix = prefix
        self.lines = []

    def input(self, expr: str, kind: str = "f") -> Sym:
        """A Sym for an expression the code defines elsewhere (an input)."""
        return Sym(self, expr, kind)

    def emit(self, expr: str, kind: str = "f") -> Sym:
        name = f"{self.prefix}{len(self.lines)}"
        ctype = "float" if kind == "f" else "bool"
        self.lines.append(f"const {ctype} {name} = {expr};")
        return Sym(self, name, kind)

    def binop(self, op, a, b):
        # the seed 1 multiplies exactly, and the seeds' zero values add
        # nothing (up to the sign of a zero)
        if (op == "*" and _is_const(b, 1.0)) or (
                op in "+-" and _is_const(b, 0.0)):
            return a
        if (op == "*" and _is_const(a, 1.0)) or (
                op == "+" and _is_const(a, 0.0)):
            return b
        kind = "b" if op in _BOOL_OPS else "f"
        return self.emit(f"{operand(a)} {op} {operand(b)}", kind)


# ----------------------------------------------------------------------
# scalar functions, dispatched on the operands' type

def _sym_of(*xs):
    for x in xs:
        if isinstance(x, Sym):
            return x
    return None


def _tensor_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x
    return None


def _as_tensor(x, like):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.bool if isinstance(x, (bool, np.bool_))
        else like.dtype if like.dtype != torch.bool else torch.float32,
        device=like.device)


def _np_erf(x):
    return math.erf(float(x))


def _np_erfc(x):
    return math.erfc(float(x))


# name: (C++ f32 function, PyTorch, numpy)
_UNARY = {
    "sqrt": ("sqrtf", torch.sqrt, np.sqrt),
    "rsqrt": ("rsqrtf", torch.rsqrt, lambda x: 1.0 / np.sqrt(x)),
    "exp": ("expf", torch.exp, np.exp),
    "log": ("logf", torch.log, np.log),
    "log1p": ("log1pf", torch.log1p, np.log1p),
    "expm1": ("expm1f", torch.expm1, np.expm1),
    "sin": ("sinf", torch.sin, np.sin),
    "cos": ("cosf", torch.cos, np.cos),
    "tan": ("tanf", torch.tan, np.tan),
    "asin": ("asinf", torch.asin, np.arcsin),
    "acos": ("acosf", torch.acos, np.arccos),
    "atan": ("atanf", torch.atan, np.arctan),
    "sinh": ("sinhf", torch.sinh, np.sinh),
    "cosh": ("coshf", torch.cosh, np.cosh),
    "tanh": ("tanhf", torch.tanh, np.tanh),
    "asinh": ("asinhf", torch.asinh, np.arcsinh),
    "acosh": ("acoshf", torch.acosh, np.arccosh),
    "atanh": ("atanhf", torch.atanh, np.arctanh),
    "erf": ("erff", torch.erf, _np_erf),
    "erfc": ("erfcf", torch.erfc, _np_erfc),
    "abs": ("fabsf", torch.abs, np.abs),
    "floor": ("floorf", torch.floor, np.floor),
    "ceil": ("ceilf", torch.ceil, np.ceil),
    "rint": ("rintf", torch.round, np.rint),
    "trunc": ("truncf", torch.trunc, np.trunc),
}
_BINARY = {
    "atan2": ("atan2f", torch.atan2, np.arctan2),
    "pow": ("powf", torch.pow, np.power),
    "maximum": ("fmaxf", torch.maximum, np.maximum),
    "minimum": ("fminf", torch.minimum, np.minimum),
}


def unary(name, x):
    """The f32 math function `name` of a scalar."""
    c_fn, t_fn, n_fn = _UNARY[name]
    if isinstance(x, Sym):
        return x.em.emit(f"{c_fn}({x.name})")
    if isinstance(x, torch.Tensor):
        return t_fn(x)
    return np.float32(n_fn(np.float32(x)))


def binary(name, a, b):
    c_fn, t_fn, n_fn = _BINARY[name]
    s = _sym_of(a, b)
    if s is not None:
        return s.em.emit(f"{c_fn}({operand(a)}, {operand(b)})")
    t = _tensor_of(a, b)
    if t is not None:
        return t_fn(_as_tensor(a, t), _as_tensor(b, t))
    return np.float32(n_fn(np.float32(a), np.float32(b)))


def sign(x):
    if isinstance(x, Sym):
        return x.em.emit(f"({x.name} > 0.0f ? 1.0f : ({x.name} < 0.0f ? "
                         "-1.0f : 0.0f))")
    if isinstance(x, torch.Tensor):
        return torch.sign(x)
    return np.float32(np.sign(np.float32(x)))


def sigmoid(x):
    if isinstance(x, Sym):
        return x.em.emit(f"1.0f / (1.0f + expf(-{x.name}))")
    if isinstance(x, torch.Tensor):
        return torch.sigmoid(x)
    return np.float32(1.0) / (np.float32(1.0) + np.exp(-np.float32(x)))


def where(c, a, b):
    """c ? a : b; a constant condition selects without emitting."""
    if isinstance(c, (bool, np.bool_)) or (
            not isinstance(c, (Sym, torch.Tensor))):
        return a if bool(c) else b
    if isinstance(c, Sym):
        kind = "b" if all(getattr(x, "kind", None) == "b"
                          or isinstance(x, (bool, np.bool_))
                          for x in (a, b)) else "f"
        return c.em.emit(f"{c.name} ? {operand(a)} : {operand(b)}", kind)
    t = _tensor_of(a, b)
    if t is None:
        t = torch.zeros((), dtype=torch.float32, device=c.device)
    return torch.where(c, _as_tensor(a, t), _as_tensor(b, t))


def to_float(x):
    """A bool or integer scalar as f32."""
    if isinstance(x, Sym):
        return x.em.emit(f"({x.name} ? 1.0f : 0.0f)") if x.kind == "b" \
            else x
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.float32(x)


def to_bool(x):
    """x != 0 (a bool stays itself)."""
    if isinstance(x, Sym):
        return x if x.kind == "b" else x != 0.0
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.bool else x != 0
    return np.bool_(x)


def logical_not(x):
    if isinstance(x, Sym):
        return ~to_bool(x)
    if isinstance(x, torch.Tensor):
        return torch.logical_not(x)
    return np.bool_(not x)


# ----------------------------------------------------------------------
# jets

class Jet:
    """(value, {channel: partial}); a None partial is the seed 1."""
    __slots__ = ("v", "d")
    __array_ufunc__ = None

    def __init__(self, v, d=None):
        self.v = v
        self.d = d if d is not None else {}

    def __add__(self, o):
        return jadd(self, _jet(o))

    def __radd__(self, o):
        return jadd(_jet(o), self)

    def __sub__(self, o):
        return jsub(self, _jet(o))

    def __rsub__(self, o):
        return jsub(_jet(o), self)

    def __mul__(self, o):
        return jmul(self, _jet(o))

    def __rmul__(self, o):
        return jmul(_jet(o), self)

    def __truediv__(self, o):
        return jdiv(self, _jet(o))

    def __rtruediv__(self, o):
        return jdiv(_jet(o), self)

    def __neg__(self):
        return jneg(self)


def _jet(x):
    return x if isinstance(x, Jet) else Jet(x)


def const(v):
    """A constant jet (no partials); numbers become numpy f32."""
    if isinstance(v, (float, int, np.floating, np.integer)) and \
            not isinstance(v, (bool, np.bool_)):
        v = np.float32(v)
    return Jet(v)


def seed(v, channel):
    """A variable of channel `channel` (partial exactly 1)."""
    return Jet(v, {channel: None})


def _p(x):
    """Resolve a stored partial (None is the seed 1)."""
    return np.float32(1.0) if x is None else x


def jadd(a, b):
    d = dict(a.d)
    for c, p in b.d.items():
        d[c] = _p(p) if c not in d else _p(d[c]) + _p(p)
    return Jet(a.v + b.v, d)


def jsub(a, b):
    d = {c: _p(p) for c, p in a.d.items()}
    for c, p in b.d.items():
        d[c] = -_p(p) if c not in d else d[c] - _p(p)
    return Jet(a.v - b.v, d)


def jneg(a):
    return Jet(-a.v, {c: -_p(p) for c, p in a.d.items()})


def jmul(a, b):
    d = {c: _p(p) * b.v for c, p in a.d.items()}
    for c, p in b.d.items():
        d[c] = _p(p) * a.v if c not in d else d[c] + _p(p) * a.v
    return Jet(a.v * b.v, d)


def jdiv(a, b):
    if not b.d:
        if not a.d:
            return Jet(a.v / b.v)
        inv = np.float32(1.0) / b.v
        return Jet(a.v * inv, {c: _p(p) * inv for c, p in a.d.items()})
    inv = np.float32(1.0) / b.v
    v = a.v * inv
    d = {c: _p(p) * inv for c, p in a.d.items()}
    w = v * inv                       # a / b^2
    for c, p in b.d.items():
        d[c] = -_p(p) * w if c not in d else d[c] - _p(p) * w
    return Jet(v, d)


def jchain(a, v, dv):
    """The jet of value v whose partials are dv times a's."""
    return Jet(v, {c: _p(p) * dv for c, p in a.d.items()})


def jsqrt(a):
    v = unary("sqrt", a.v)
    if not a.d:
        return Jet(v)
    return jchain(a, v, np.float32(0.5) / v)


def jexp(a):
    v = unary("exp", a.v)
    return jchain(a, v, v)


def jlog(a):
    return jchain(a, unary("log", a.v), np.float32(1.0) / a.v) if a.d \
        else Jet(unary("log", a.v))


def _lazy(value_fn, deriv_fn):
    """A unary jet rule; the derivative is computed only when a has
    partials."""
    def rule(a):
        v = value_fn(a.v)
        if not a.d:
            return Jet(v)
        return jchain(a, v, deriv_fn(a.v, v))
    return rule


_ONE = np.float32(1.0)
_ZERO = np.float32(0.0)
_TWO_OVER_SQRT_PI = np.float32(1.1283791670955126)

jlog1p = _lazy(lambda x: unary("log1p", x), lambda x, v: _ONE / (_ONE + x))
jexpm1 = _lazy(lambda x: unary("expm1", x), lambda x, v: v + _ONE)
jrsqrt = _lazy(lambda x: unary("rsqrt", x),
               lambda x, v: np.float32(-0.5) * v / x)
jsin = _lazy(lambda x: unary("sin", x), lambda x, v: unary("cos", x))
jcos = _lazy(lambda x: unary("cos", x), lambda x, v: -unary("sin", x))


def _dtan(x, v):
    c = unary("cos", x)
    return _ONE / (c * c)


jtan = _lazy(lambda x: unary("tan", x), _dtan)
jasin = _lazy(lambda x: unary("asin", x), lambda x, v: unary(
    "rsqrt", binary("maximum", _ONE - x * x, _ZERO)))
jacos = _lazy(lambda x: unary("acos", x), lambda x, v: -unary(
    "rsqrt", binary("maximum", _ONE - x * x, _ZERO)))
jatan = _lazy(lambda x: unary("atan", x), lambda x, v: _ONE / (_ONE + x * x))
jsinh = _lazy(lambda x: unary("sinh", x), lambda x, v: unary("cosh", x))
jcosh = _lazy(lambda x: unary("cosh", x), lambda x, v: unary("sinh", x))
jtanh = _lazy(lambda x: unary("tanh", x), lambda x, v: _ONE - v * v)
jasinh = _lazy(lambda x: unary("asinh", x),
               lambda x, v: unary("rsqrt", x * x + _ONE))
jacosh = _lazy(lambda x: unary("acosh", x), lambda x, v: unary(
    "rsqrt", binary("maximum", x * x - _ONE, _ZERO)))
jatanh = _lazy(lambda x: unary("atanh", x), lambda x, v: _ONE / (_ONE - x * x))
jerf = _lazy(lambda x: unary("erf", x),
             lambda x, v: _TWO_OVER_SQRT_PI * unary("exp", -x * x))
jerfc = _lazy(lambda x: unary("erfc", x),
              lambda x, v: -_TWO_OVER_SQRT_PI * unary("exp", -x * x))
jlogistic = _lazy(sigmoid, lambda x, v: v * (_ONE - v))
jabs = _lazy(lambda x: unary("abs", x), lambda x, v: sign(x))


def jdrop(fn):
    """A rule of zero derivative (floor, ceil, round, sign, ...)."""
    return lambda a: Jet(fn(a.v))


def jatan2(y, x):
    """atan2(y, x) (jet.h atan2): d = (x dy - y dx) / (x^2 + y^2)."""
    v = binary("atan2", y.v, x.v)
    if not (y.d or x.d):
        return Jet(v)
    denom = x.v * x.v + y.v * y.v
    cy = x.v / denom
    cx = -y.v / denom
    d = {c: _p(p) * cy for c, p in y.d.items()}
    for c, p in x.d.items():
        t = _p(p) * cx
        d[c] = t if c not in d else d[c] + t
    return Jet(v, d)


def jpow(a, b):
    """a^b (jet.h pow): the full bivariate rule."""
    v = binary("pow", a.v, b.v)
    d = {}
    if a.d:
        da = b.v * binary("pow", a.v, b.v - _ONE)
        d = {c: _p(p) * da for c, p in a.d.items()}
    if b.d:
        db = v * unary("log", a.v)
        for c, p in b.d.items():
            t = _p(p) * db
            d[c] = t if c not in d else d[c] + t
    return Jet(v, d)


def jintpow(a, n: int):
    """a^n for a constant integer n, by repeated products."""
    n = int(n)
    if n == 0:
        return const(1.0)
    if n < 0:
        return jdiv(const(1.0), jintpow(a, -n))
    out = a
    for _ in range(n - 1):
        out = jmul(out, a)
    return out


def jwhere(cond, a, b):
    """cond ? a : b channel by channel (a constant condition selects)."""
    if not isinstance(cond, (Sym, torch.Tensor)):
        return a if bool(cond) else b
    d = {}
    for c in list(a.d) + [c for c in b.d if c not in a.d]:
        pa = _p(a.d[c]) if c in a.d else _ZERO
        pb = _p(b.d[c]) if c in b.d else _ZERO
        d[c] = where(cond, pa, pb)
    return Jet(where(cond, a.v, b.v), d)


def jmax(a, b):
    return jwhere(a.v >= b.v, a, b)


def jmin(a, b):
    return jwhere(a.v <= b.v, a, b)


# ----------------------------------------------------------------------
# the robust-loss corrector and the dense output

def correct_jets(jets, loss_eval, valid):
    """Triggs correction of one residual block's jets (jetlib.py:207 and
    loss.py correct_residuals_and_jacobian; the reference's
    corrector.cc): r~ = residual_scaling r, J~ = sqrt(rho')
    (J - (alpha / ||r||^2) r r^T J). `loss_eval(sq)` gives (rho, rho',
    rho'') of a scalar. An invalid lane takes sq = 0 (the simple branch),
    so its values stay finite. The r r^T J term fills every residual
    with every channel any residual has."""
    sq = None
    for j in jets:
        t = j.v * j.v
        sq = t if sq is None else sq + t
    sq = where(valid, sq, _ZERO)
    _, rho1, rho2 = loss_eval(sq)
    sqrt_rho1 = unary("sqrt", binary("maximum", rho1, _ZERO))
    is_zero = sq == _ZERO
    simple = is_zero | (rho2 <= _ZERO)
    safe_sq = where(is_zero, _ONE, sq)
    safe_rho1 = where(rho1 == _ZERO, _ONE, rho1)
    D = _ONE + np.float32(2.0) * sq * rho2 / safe_rho1
    alpha = _ONE - unary("sqrt", binary("maximum", D, _ZERO))
    rs = where(simple, sqrt_rho1, sqrt_rho1 / (_ONE - alpha))
    asn = where(simple, _ZERO, alpha / safe_sq)

    chans = []
    for j in jets:
        chans += [c for c in j.d if c not in chans]
    rtj = {}
    for c in chans:
        acc = None
        for j in jets:
            if c in j.d:
                t = j.v * _p(j.d[c])
                acc = t if acc is None else acc + t
        rtj[c] = acc
    out = []
    for j in jets:
        d = {}
        for c in chans:
            corr = asn * j.v * rtj[c]
            if c in j.d:
                d[c] = sqrt_rho1 * (_p(j.d[c]) - corr)
            else:
                d[c] = -sqrt_rho1 * corr
        out.append(Jet(j.v * rs, d))
    return out


def dense_partials(jet, nt: int):
    """[nt] partials of a jet, None where the channel is structurally
    zero (jetlib.py _jet_planes without the mask)."""
    return [_p(jet.d[c]) if c in jet.d else None for c in range(nt)]
