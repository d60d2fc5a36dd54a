"""The auto-jet compiler: a bucket's residual program traced to an aten
graph and evaluated over sparse jets (ops/jetlib.py).

Counterpart of ceres_tpu/ops/jet_compile.py. The bucket's per-row program
(the functor after the variable slots' Plus: the g(deltas) closure of
program.py `_bucket_linearize32`, jet_compile.py:503-512 in the JAX
package) is traced ONCE with torch.fx's `make_fx` on f32 inputs of one
row, in fake-tensor mode, so data-dependent control flow fails the trace
instead of baking one branch. The graph is then evaluated over numpy
object arrays of jets, as `_eval_jaxpr_jets` does (:410-446):
elementwise aten ops map to the jet rules; structural ops (select, slice,
view, unsqueeze, squeeze, expand, cat, stack, permute, index with
constant indices, ...) run on an arange of positions and move the jets
the way they moved the positions (the arange trick, :308). Evaluated
over tensor scalars this is a CPU forward-mode derivative (the tests hold
it to jacfwd); evaluated over emitter scalars it writes the CUDA code of
the chain: K5's lane chain (ops/lin_auto.py, csrc/lin_auto.cuh) and
K11's row chain (`row_chain_source`; ops/linearize.py,
csrc/linearize_auto.cuh), both through `chain_body`.

A graph with an op outside the rule table makes `make_auto_spec` return
None (`_validate`, :449), and the caller keeps another path. The spec is
cached per bucket, with a digest of the graph.

Robust losses: `make_loss_spec` traces `loss.evaluate(s)` for a scalar s
with the loss's scalar attributes (nested losses included) as graph
inputs, so one trace, and one CUDA build, serves every instance of a loss
class; `eval_loss` evaluates it to (rho, rho', rho'') over either scalar
type, the loss's scalars coming in as kernel arguments.
"""

from __future__ import annotations

import hashlib
import operator
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import jetlib as jl
from .jetlib import Jet, const

__all__ = ["make_auto_spec", "make_loss_spec", "loss_param_values",
           "loss_structure", "chain_body", "row_chain_source",
           "eval_loss", "AutoSpec", "LossSpec"]

_WARNED: set = set()


def _warn_once(key, msg):
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"ceres_tpu_torch: {msg}", file=sys.stderr)


class _Unsupported(TypeError):
    pass


# ----------------------------------------------------------------------
# object arrays of jets

def _obj0(x):
    a = np.empty((), dtype=object)
    a[()] = x
    return a


def _as_obj(x):
    """An object array; a bare number or jet becomes a 0-d constant."""
    if isinstance(x, np.ndarray):
        return x
    return _obj0(x if isinstance(x, Jet) else const(x))


def _map(f, *arrs):
    """f elementwise, with broadcasting, over object arrays."""
    return _as_obj(np.frompyfunc(f, len(arrs), 1)(*[_as_obj(a)
                                                     for a in arrs]))


def _const_array(t: torch.Tensor):
    """A constant tensor of the graph as an object array of constant jets
    (floats as numpy f32, integers as int64, bools as bool)."""
    a = t.detach().cpu().numpy()
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    out = np.empty(a.shape, dtype=object)
    flat, of = a.reshape(-1), out.reshape(-1)
    for i in range(flat.size):
        of[i] = Jet(flat[i])
    return out


def _concrete(x):
    """An index argument as concrete integers: object arrays of constant
    jets become int64 tensors; a traced index is unsupported."""
    if isinstance(x, np.ndarray) and x.dtype == object:
        out = np.empty(x.shape, dtype=np.int64)
        for idx in np.ndindex(x.shape):
            j = x[idx]
            if j.d or isinstance(j.v, (jl.Sym, torch.Tensor)):
                raise _Unsupported("selection with traced indices")
            out[idx] = int(j.v)
        return torch.as_tensor(out)
    if isinstance(x, (list, tuple)):
        return type(x)(_concrete(v) for v in x)
    return x


# ----------------------------------------------------------------------
# rules: rule(args, kwargs) -> object array (or a list for several
# outputs), with graph tensors already object arrays

def _ew(f):
    return lambda args, kw: _map(f, *args)


def _alpha(b, kw):
    alpha = kw.get("alpha", 1)
    return b if alpha == 1 else _map(lambda j: jl.jmul(j, const(alpha)), b)


def _rule_add(args, kw):
    return _map(jl.jadd, args[0], _alpha(args[1], kw))


def _rule_sub(args, kw):
    return _map(jl.jsub, args[0], _alpha(args[1], kw))


def _rule_rsub(args, kw):
    return _map(jl.jsub, args[1], _alpha(args[0], kw))


def _rule_div(args, kw):
    mode = kw.get("rounding_mode")
    q = _map(jl.jdiv, args[0], args[1])
    if mode is None:
        return q
    fn = "floor" if mode == "floor" else "trunc"
    return _map(jl.jdrop(lambda v: jl.unary(fn, v)), q)


def _rule_pow(args, kw):
    a, e = args
    if isinstance(e, (int, float)) and float(e).is_integer():
        return _map(lambda j: jl.jintpow(j, int(e)), a)
    return _map(jl.jpow, a, e)


def _cmp(op):
    return lambda args, kw: _map(lambda x, y: Jet(op(x.v, y.v)), *args)


def _logic(op):
    return lambda args, kw: _map(
        lambda *js: Jet(op(*[jl.to_bool(j.v) for j in js])), *args)


def _rule_where(args, kw):
    return _map(lambda c, a, b: jl.jwhere(c.v, a, b), *args)


def _rule_clamp(args, kw):
    x = args[0]
    lo = args[1] if len(args) > 1 else kw.get("min")
    hi = args[2] if len(args) > 2 else kw.get("max")
    if lo is not None:
        x = _map(jl.jmax, x, lo)
    if hi is not None:
        x = _map(jl.jmin, x, hi)
    return x


def _unary(name):
    return _ew(jl.jdrop(lambda v: jl.unary(name, v)))


def _rule_round(args, kw):
    if kw.get("decimals", 0) != 0 or len(args) > 1:
        raise _Unsupported("round with decimals")
    return _map(jl.jdrop(lambda v: jl.unary("rint", v)), args[0])


def _rule_to(args, kw):
    """_to_copy / to: a cast between float and bool (or a move)."""
    dtype = kw.get("dtype")
    if dtype is None:
        dtype = next((a for a in args[1:] if isinstance(a, torch.dtype)),
                     None)
    if dtype is None or dtype.is_floating_point:
        def cast(j):
            v = j.v
            if isinstance(v, (bool, np.bool_, np.integer)) or getattr(
                    v, "kind", None) == "b" or (
                    isinstance(v, torch.Tensor) and v.dtype == torch.bool):
                return Jet(jl.to_float(v))
            return j
        return _map(cast, args[0])
    if dtype == torch.bool:
        return _map(lambda j: Jet(jl.to_bool(j.v)), args[0])
    raise _Unsupported(f"cast to {dtype}")


def _like(value):
    return lambda args, kw: _map(lambda j: const(value), args[0])


def _rule_full_like(args, kw):
    fill = args[1]
    return np.broadcast_to(_as_obj(fill), _as_obj(args[0]).shape).copy()


def _full(shape, fill):
    out = np.empty(tuple(shape), dtype=object)
    out[...] = fill if isinstance(fill, Jet) else const(fill)
    return out


def _reduce(args, kw, ufunc):
    x = _as_obj(args[0])
    dims = args[1] if len(args) > 1 else kw.get("dim")
    keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        dims = list(range(x.ndim))
    if isinstance(dims, int):
        dims = [dims]
    dims = sorted({d % max(x.ndim, 1) for d in dims}, reverse=True)
    for d in dims:
        x = _as_obj(ufunc.reduce(x, axis=d, keepdims=keep))
    return x


def _rule_sum(args, kw):
    return _reduce(args, kw, np.add)


def _rule_prod(args, kw):
    return _reduce(args, kw, np.multiply)


def _rule_mean(args, kw):
    x = _as_obj(args[0])
    s = _reduce(args, kw, np.add)
    return _map(lambda j: jl.jmul(j, const(1.0 * s.size / x.size)), s)


def _fold(args, kw, f):
    x = _as_obj(args[0])
    dims = args[1] if len(args) > 1 else kw.get("dim", None)
    keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        dims = list(range(x.ndim))
    if isinstance(dims, int):
        dims = [dims]
    for d in sorted({d % max(x.ndim, 1) for d in dims}, reverse=True):
        parts = np.moveaxis(x, d, 0)
        acc = parts[0]
        for i in range(1, parts.shape[0]):
            acc = _map(f, acc, parts[i])
        x = np.expand_dims(acc, d) if keep else _as_obj(acc)
    return x


def _rule_cross(args, kw):
    a, b = np.broadcast_arrays(_as_obj(args[0]), _as_obj(args[1]))
    dim = args[2] if len(args) > 2 else kw.get("dim", -1)
    a, b = np.moveaxis(a, dim, -1), np.moveaxis(b, dim, -1)
    out = np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                    a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                    a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)
    return np.moveaxis(_as_obj(out), -1, dim)


def _rule_matmul(args, kw):
    a, b = _as_obj(args[0]), _as_obj(args[1])
    if a.ndim == 1 and b.ndim == 1:
        return _obj0(np.add.reduce(a * b))
    return _as_obj(np.matmul(a, b))


def _rule_local_scalar(args, kw):
    return _as_obj(args[0])


def _structural(op):
    """Selection and layout ops by the arange trick: run the op on a
    tensor of positions and move the jets as it moved the positions."""
    def rule(args, kw):
        first = args[0]
        if isinstance(first, (list, tuple)):          # cat, stack
            arrs = [_as_obj(a) for a in first]
            flat = np.concatenate([a.reshape(-1) for a in arrs])
            head, off = [], 0
            for a in arrs:
                head.append(torch.arange(off, off + a.size,
                                         dtype=torch.float64).reshape(
                                             a.shape))
                off += a.size
        else:
            a = _as_obj(first)
            flat = a.reshape(-1)
            head = torch.arange(a.size, dtype=torch.float64).reshape(
                a.shape)
        out = op(head, *[_concrete(x) for x in args[1:]],
                 **{k: _concrete(v) for k, v in kw.items()})

        def take(pos):
            idx = pos.reshape(-1).to(torch.int64).numpy()
            res = np.empty(idx.shape, dtype=object)
            res[:] = [flat[i] for i in idx]
            return res.reshape(tuple(pos.shape))

        if isinstance(out, (list, tuple)):
            return [take(o) for o in out]
        return take(out)
    return rule


_STRUCTURAL = ("select", "slice", "view", "_unsafe_view", "reshape",
               "unsqueeze", "squeeze", "expand", "permute", "t",
               "transpose", "index", "narrow", "flip", "diagonal",
               "repeat", "unbind", "split", "split_with_sizes", "cat",
               "stack", "movedim", "roll", "alias", "clone",
               "lift_fresh_copy", "contiguous")

_RULES = {
    "add": _rule_add, "sub": _rule_sub, "rsub": _rule_rsub,
    "mul": _ew(jl.jmul), "div": _rule_div, "neg": _ew(jl.jneg),
    "reciprocal": _ew(lambda a: jl.jdiv(const(1.0), a)),
    "square": _ew(lambda a: jl.jintpow(a, 2)), "pow": _rule_pow,
    "sqrt": _ew(jl.jsqrt), "rsqrt": _ew(jl.jrsqrt),
    "exp": _ew(jl.jexp), "log": _ew(jl.jlog), "log1p": _ew(jl.jlog1p),
    "expm1": _ew(jl.jexpm1), "sin": _ew(jl.jsin), "cos": _ew(jl.jcos),
    "tan": _ew(jl.jtan), "asin": _ew(jl.jasin), "acos": _ew(jl.jacos),
    "atan": _ew(jl.jatan), "sinh": _ew(jl.jsinh), "cosh": _ew(jl.jcosh),
    "tanh": _ew(jl.jtanh), "asinh": _ew(jl.jasinh),
    "acosh": _ew(jl.jacosh), "atanh": _ew(jl.jatanh),
    "erf": _ew(jl.jerf), "erfc": _ew(jl.jerfc),
    "sigmoid": _ew(jl.jlogistic), "abs": _ew(jl.jabs),
    "atan2": _ew(jl.jatan2), "maximum": _ew(jl.jmax),
    "minimum": _ew(jl.jmin), "clamp": _rule_clamp,
    "clamp_min": lambda args, kw: _rule_clamp(args[:2], {}),
    "clamp_max": lambda args, kw: _rule_clamp([args[0], None, args[1]], {}),
    "sign": _ew(jl.jdrop(jl.sign)), "floor": _unary("floor"),
    "ceil": _unary("ceil"), "trunc": _unary("trunc"), "round": _rule_round,
    "where": _rule_where,
    "lt": _cmp(operator.lt), "le": _cmp(operator.le),
    "gt": _cmp(operator.gt), "ge": _cmp(operator.ge),
    "eq": _cmp(operator.eq), "ne": _cmp(operator.ne),
    "logical_and": _logic(operator.and_), "bitwise_and": _logic(operator.and_),
    "logical_or": _logic(operator.or_), "bitwise_or": _logic(operator.or_),
    "logical_xor": _logic(operator.xor), "bitwise_xor": _logic(operator.xor),
    "logical_not": _ew(lambda j: Jet(jl.logical_not(j.v))),
    "bitwise_not": _ew(lambda j: Jet(jl.logical_not(j.v))),
    "detach": _ew(lambda j: Jet(j.v)),
    "_to_copy": _rule_to, "to": _rule_to,
    "ones_like": _like(1.0), "zeros_like": _like(0.0),
    "full_like": _rule_full_like,
    "full": lambda args, kw: _full(args[0], args[1]),
    "ones": lambda args, kw: _full(args[0], 1.0),
    "zeros": lambda args, kw: _full(args[0], 0.0),
    "scalar_tensor": lambda args, kw: _full((), args[0]),
    "_local_scalar_dense": _rule_local_scalar,
    "sum": _rule_sum, "prod": _rule_prod, "mean": _rule_mean,
    "amax": lambda args, kw: _fold(args, kw, jl.jmax),
    "amin": lambda args, kw: _fold(args, kw, jl.jmin),
    "linalg_cross": _rule_cross, "dot": _rule_matmul, "mv": _rule_matmul,
    "mm": _rule_matmul, "matmul": _rule_matmul, "bmm": _rule_matmul,
}
for _name in _STRUCTURAL:
    _RULES[_name] = None                      # resolved per overload below


def _op_name(target) -> str:
    return getattr(target, "_opname", None) or getattr(
        target, "__name__", str(target))


def _rule_for(target):
    name = _op_name(target)
    if name in _STRUCTURAL:
        return _structural(target)
    return _RULES.get(name)


def _validate(gm) -> set:
    """The names of the graph's ops outside the rule table (empty: ok)."""
    bad = set()
    for n in gm.graph.nodes:
        if n.op in ("call_module", "call_method"):
            bad.add(str(n.target))
        elif n.op == "call_function" and n.target is not operator.getitem \
                and _op_name(n.target) not in _RULES:
            bad.add(_op_name(n.target))
    return bad


def _resolve(x, env):
    if isinstance(x, torch.fx.Node):
        return env[x]
    if isinstance(x, (list, tuple)):
        return type(x)(_resolve(v, env) for v in x)
    if isinstance(x, dict):
        return {k: _resolve(v, env) for k, v in x.items()}
    return x


def evaluate_graph(gm, inputs):
    """Interpret the graph with object arrays of jets as its inputs;
    returns its outputs (object arrays) in the graph's output structure.
    Constants fold in f32 with IEEE semantics, as the kernel computes."""
    with np.errstate(all="ignore"):
        return _evaluate(gm, inputs)


def _evaluate(gm, inputs):
    env = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for n, a in zip(placeholders, inputs):
        env[n] = _as_obj(a)
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            env[n] = _const_array(getattr(gm, n.target))
        elif n.op == "call_function":
            args, kw = _resolve(n.args, env), _resolve(n.kwargs, env)
            if n.target is operator.getitem:
                env[n] = args[0][args[1]]
                continue
            rule = _rule_for(n.target)
            if rule is None:
                raise _Unsupported(_op_name(n.target))
            env[n] = rule(args, kw)
        elif n.op == "output":
            return _resolve(n.args[0], env)
    raise _Unsupported("graph without output")


def _trace(fn, args):
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn, tracing_mode="fake")(*args)


def _digest(gm) -> str:
    h = hashlib.blake2s(gm.code.encode())
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            h.update(getattr(gm, n.target).detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# ----------------------------------------------------------------------
# bucket specs

class AutoSpec(NamedTuple):
    """The traced per-row program of a bucket."""
    name: str                   # "auto:<functor class>"
    digest: str                 # of the graph and its constants
    graph: object               # torch.fx.GraphModule
    per_row: object             # the traced closure (data, slots, deltas)
    data_names: tuple           # bucket data fields, sorted
    data_shapes: tuple          # per-row shape of each field
    slot_sizes: tuple           # ambient size of each slot
    tan_sizes: tuple            # tangent size of each variable slot
    var_slots: tuple            # indices of the variable slots
    r: int
    nt: int

    @property
    def data_widths(self):
        return tuple(int(np.prod(s, dtype=np.int64)) for s in
                     self.data_shapes)

    @property
    def p_dat(self) -> int:
        return sum(self.data_widths)

    def data_matrix(self, bk) -> torch.Tensor:
        """The bucket's data fields as one f32 [n, p_dat] tensor."""
        cols = [bk.data[name].reshape(bk.n, w) for name, w in
                zip(self.data_names, self.data_widths)]
        if not cols:            # a functor without data fields
            return torch.zeros(bk.n, 0, dtype=torch.float32,
                               device=bk.slots[0].amb_local.device)
        return torch.cat(cols, dim=1).to(torch.float32).contiguous()

    def split_data(self, row):
        """A [p_dat] row of data_matrix as the per-row fields."""
        out, off = [], 0
        for shape, w in zip(self.data_shapes, self.data_widths):
            out.append(row[off:off + w].reshape(shape))
            off += w
        return out

    def jets(self, slot_values, dat_values):
        """The R residual jets of one row: slot_values, per slot its
        ambient scalars; dat_values, the p_dat data scalars (tensor,
        emitter or constant scalars). Channels follow the variable
        slots' tangents in slot order."""
        args, off = [], 0
        for shape, w in zip(self.data_shapes, self.data_widths):
            a = np.empty((w,), dtype=object)
            for i in range(w):
                a[i] = Jet(dat_values[off + i])
            args.append(a.reshape(shape))
            off += w
        for vals in slot_values:
            a = np.empty((len(vals),), dtype=object)
            for i, v in enumerate(vals):
                a[i] = Jet(v)
            args.append(a)
        ch = 0
        for t in self.tan_sizes:
            a = np.empty((t,), dtype=object)
            for i in range(t):
                a[i] = jl.seed(np.float32(0.0), ch + i)
            args.append(a)
            ch += t
        out = evaluate_graph(self.graph, args)
        return list(_as_obj(out).reshape(-1))

    def row_jacobian(self, slots, d_row):
        """(r [R], J [R, nt]) of one row by torch.func.jacfwd of per_row
        at zero tangent, in the dtype of the slots: slots, per slot its
        ambient values; d_row, a [p_dat] row of data_matrix. Under vmap
        this is the plain version of the kernels that run the chain."""
        c = slots[0]

        def g(*deltas):
            r = self.per_row(*self.split_data(d_row), *slots, *deltas)
            return r, r

        zeros = tuple(torch.zeros(t, dtype=c.dtype, device=c.device)
                      for t in self.tan_sizes)
        Js, r = torch.func.jacfwd(g, argnums=tuple(range(len(zeros))),
                                  has_aux=True)(*zeros)
        return r, torch.cat([j.to(c.dtype) for j in Js], dim=-1)


def chain_body(em, jets, nt: int) -> str:
    """The lines of a chain's run(): the emitter's straight-line f32
    code, then the stores of the R residual jets into rv[R] and a dense
    J[R][nt], 0.0f where a channel is structurally zero."""
    out = []
    for s, jet in enumerate(jets):
        out.append(f"rv[{s}] = {jl.operand(jet.v)};")
        for c, p in enumerate(jl.dense_partials(jet, nt)):
            out.append(f"J[{s}][{c}] = "
                       f"{'0.0f' if p is None else jl.operand(p)};")
    return "\n".join("    " + ln for ln in em.lines + out)


def row_chain_source(spec: "AutoSpec", name: str = "RowChain") -> str:
    """The C++ struct of one row's residual jet chain for K11's auto
    spec (csrc/linearize_auto.cuh states its interface): any number of
    slots, read from the row's slot-concatenated ambient values x[P_IN]
    and data d[P_DAT]; the variable slots' tangents seeded through the
    traced program, which holds each slot's Plus; no loss (K11 returns
    the uncorrected r and J)."""
    em = jl.Emitter()
    offs = np.cumsum((0,) + spec.slot_sizes)
    jets = spec.jets(
        [[em.input(f"x[{o + a}]") for a in range(size)]
         for o, size in zip(offs, spec.slot_sizes)],
        [em.input(f"d[{i}]") for i in range(spec.p_dat)])
    return f"""struct {name} {{
  static constexpr int R = {spec.r}, NT = {spec.nt};
  static constexpr int P_IN = {int(offs[-1])}, P_DAT = {spec.p_dat};
  static __device__ __forceinline__ void run(
      const float* __restrict__ x, const float* __restrict__ d,
      float (&rv)[R], float (&J)[R][NT]) {{
{chain_body(em, jets, spec.nt)}
  }}
}};
"""


def _functor_name(bk) -> str:
    f = getattr(bk.cost, "functor", None)
    return type(f).__name__ if f is not None else type(bk.cost).__name__


def make_auto_spec(program, bk) -> Optional[AutoSpec]:
    """The traced per-row program of bucket bk, or None when the functor
    does not trace (data-dependent control flow, ...) or uses an op
    outside the rule table; the caller keeps another path. Cached per
    bucket."""
    cache = program.__dict__.setdefault("_autojet_specs", {})
    if id(bk) not in cache:
        cache[id(bk)] = _build_auto_spec(bk)
    return cache[id(bk)]


def _build_auto_spec(bk) -> Optional[AutoSpec]:
    name = _functor_name(bk)
    names = tuple(sorted(bk.data))
    shapes = []
    for k in names:
        t = bk.data[k]
        if not t.is_floating_point() or t.shape[:1] != (bk.n,):
            return None
        shapes.append(tuple(t.shape[1:]))
    var_slots = tuple(i for i, sl in enumerate(bk.slots) if sl.variable)
    if not var_slots:
        return None
    slots = list(bk.slots)
    fn = bk.residual_fn
    L, S = len(names), len(slots)

    def per_row(*flat):
        data = dict(zip(names, flat[:L]))
        ps = list(flat[L:L + S])
        for i, d in zip(var_slots, flat[L + S:]):
            sl = slots[i]
            ps[i] = ps[i] + d if sl.manifold is None else \
                sl.manifold.plus(ps[i], d)
        return fn(data, *ps)

    f32 = torch.float32
    args = ([torch.zeros(s, dtype=f32) for s in shapes]
            + [torch.zeros(sl.amb_size, dtype=f32) for sl in slots]
            + [torch.zeros(slots[i].tangent_size, dtype=f32)
               for i in var_slots])
    try:
        gm = _trace(per_row, args)
    except Exception as e:
        _warn_once(("trace", name), f"autojet: tracing {name} failed "
                   f"({type(e).__name__})")
        return None
    bad = _validate(gm)
    if bad:
        _warn_once(("ops", name, tuple(sorted(bad))),
                   f"autojet: {name} uses ops outside the jet rules "
                   f"({', '.join(sorted(bad))})")
        return None
    out = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
    val = getattr(out, "meta", {}).get("val")
    if not isinstance(out, torch.fx.Node) or val is None or \
            tuple(val.shape) != (bk.r,):
        return None
    tan = tuple(slots[i].tangent_size for i in var_slots)
    spec = AutoSpec(f"auto:{name}", _digest(gm), gm, per_row, names,
                    tuple(shapes), tuple(sl.amb_size for sl in slots), tan,
                    var_slots, bk.r, sum(tan))
    try:              # a rule can still refuse (traced indices): dry run
        em = jl.Emitter()
        spec.jets([[em.input(f"x{s}[{a}]") for a in range(size)]
                   for s, size in enumerate(spec.slot_sizes)],
                  [em.input(f"d[{i}]") for i in range(spec.p_dat)])
    except Exception as e:
        _warn_once(("emit", name), f"autojet: {name} does not evaluate "
                   f"over jets ({type(e).__name__}: {e})")
        return None
    return spec


# ----------------------------------------------------------------------
# robust losses

class LossSpec(NamedTuple):
    """A loss class traced to a graph of (s, *params) -> (rho, rho',
    rho''), the params being the loss's scalar attributes."""
    key: tuple                  # the loss's class structure
    graph: object
    n_params: int
    digest: str


def loss_structure(loss):
    """(structure key, scalar values) of a loss, nested losses walked in
    attribute order; a bool or str attribute is part of the structure
    with its value; raises _Unsupported (a TypeError) on any other
    attribute. The program keys its buckets by it, K5 its builds."""
    from ..loss import LossFunction
    parts, values = [], []
    for k, v in vars(loss).items():
        if isinstance(v, LossFunction):
            sub, vals = loss_structure(v)
            parts.append((k, sub))
            values += vals
        elif v is None or isinstance(v, (bool, str)):
            parts.append((k, v))
        elif isinstance(v, (int, float)):
            parts.append((k, "scalar"))
            values.append(float(v))
        else:
            raise _Unsupported(f"loss attribute {k} of {type(v).__name__}")
    return (type(loss).__name__, tuple(parts)), values


def _loss_rebuild(loss, params):
    """A copy of loss whose scalar attributes are taken from `params`."""
    from ..loss import LossFunction
    obj = object.__new__(type(loss))
    for k, v in vars(loss).items():
        if isinstance(v, LossFunction):
            v = _loss_rebuild(v, params)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            v = next(params)
        object.__setattr__(obj, k, v)
    return obj


_LOSS_SPECS: dict = {}


def loss_param_values(loss) -> list:
    """The loss's scalars, in the order of make_loss_spec's params."""
    return loss_structure(loss)[1]


def make_loss_spec(loss) -> Optional[LossSpec]:
    """The traced loss of loss's class structure (cached), or None when
    the loss has other attributes than scalars and nested losses, or does
    not trace."""
    try:
        key, values = loss_structure(loss)
    except _Unsupported:
        return None
    if key not in _LOSS_SPECS:
        n = len(values)

        def fn(s, *params):
            return tuple(_loss_rebuild(loss, iter(params)).evaluate(s))

        spec = None
        try:
            gm = _trace(fn, [torch.zeros((), dtype=torch.float32)]
                        + [torch.ones((), dtype=torch.float32)
                           for _ in range(n)])
            if not _validate(gm):
                spec = LossSpec(key, gm, n, _digest(gm))
        except Exception as e:
            _warn_once(("loss", key), f"autojet: tracing {key[0]} failed "
                       f"({type(e).__name__})")
        _LOSS_SPECS[key] = spec
    return _LOSS_SPECS[key]


def eval_loss(spec: LossSpec, s, params):
    """(rho, rho', rho'') of the scalar s with the loss's scalars
    `params` (tensor, emitter or constant scalars)."""
    outs = evaluate_graph(spec.graph, [Jet(s)] + [Jet(p) for p in params])
    return tuple(_as_obj(o)[()].v for o in outs)
