"""Cost functions: the user-facing residual definitions, on torch tensors.

Counterpart of ceres_tpu/cost.py for the slice: CostFunction
(the reference's cost_function.h:64), SizedCostFunction
(sized_cost_function.h:50), AutoDiffCostFunction
(autodiff_cost_function.h:156), NumericDiffOptions and
NumericDiffCostFunction (numeric_diff_cost_function.h:181, FORWARD,
CENTRAL and RIDDERS), DynamicAutoDiffCostFunction and
DynamicNumericDiffCostFunction (dynamic_*_cost_function.h),
CostFunctionToFunctor and DynamicCostFunctionToFunctor
(cost_function_to_functor.h:104, dynamic_cost_function_to_functor.h:46),
ConditionedCostFunction (conditioned_cost_function.h:74) and NormalPrior
(normal_prior.h:60). A functor is a plain function
`f(*params) -> residuals` or an instance whose `__call__(self, *params)`
uses torch operations; instance attributes (observations and the like)
are per-residual-block data, stacked across a bucket and mapped over with
`torch.func.vmap`. Forward-mode derivatives come from `torch.func.jacfwd`,
the role the reference's Jet plays; a SizedCostFunction that overrides
`jacobians` gives its own, and a NumericDiffCostFunction takes them by
finite differences (`jacobian_of`). The program picks the mode per bucket
(program.py `jac_mode`, ceres_tpu program.py:448-456).
"""

from __future__ import annotations

import types as _types
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .types import NumericDiffMethodType


class NumericDiffOptions:
    """The reference's numeric_diff_options.h."""

    def __init__(self,
                 relative_step_size: float = 1e-6,
                 ridders_relative_initial_step_size: float = 1e-2,
                 max_num_ridders_extrapolations: int = 10,
                 ridders_epsilon: float = 1e-12,
                 ridders_step_shrink_factor: float = 2.0):
        self.relative_step_size = relative_step_size
        self.ridders_relative_initial_step_size = (
            ridders_relative_initial_step_size)
        self.max_num_ridders_extrapolations = max_num_ridders_extrapolations
        self.ridders_epsilon = ridders_epsilon
        self.ridders_step_shrink_factor = ridders_step_shrink_factor


def _functor_parts(functor):
    """(bucket code key, call(data, *params), data dict) of a functor."""
    if isinstance(functor, type):
        raise TypeError("pass an instance or function, not a class")
    if isinstance(functor, (_types.FunctionType, _types.BuiltinFunctionType,
                            _types.MethodType, _types.LambdaType)):
        return functor, (lambda data, *params: functor(*params)), {}
    if callable(functor):
        cls = type(functor)
        data = dict(vars(functor)) if hasattr(functor, "__dict__") else {}

        def call(data_dict, *params):
            obj = object.__new__(cls)
            object.__setattr__(obj, "__dict__", dict(data_dict))
            return obj(*params)

        return cls, call, data
    raise TypeError(f"functor {functor!r} is not callable")


class CostFunction:
    """Base cost function (cost_function.h:64)."""

    def __init__(self, num_residuals: int,
                 parameter_block_sizes: Sequence[int]):
        self._num_residuals = int(num_residuals)
        self._parameter_block_sizes = [int(s) for s in parameter_block_sizes]

    @property
    def num_residuals(self) -> int:
        return self._num_residuals

    @property
    def parameter_block_sizes(self) -> Sequence[int]:
        return list(self._parameter_block_sizes)

    def bucket_key(self):
        """Residual blocks with equal keys are evaluated in one batch."""
        return (type(self), self._num_residuals,
                tuple(self._parameter_block_sizes))

    def block_data(self):
        """Per-residual-block data, stacked across the bucket."""
        return {}

    def make_residual_fn(self) -> Callable:
        """f(data, *params) -> residuals [num_residuals], unbatched."""
        raise NotImplementedError

    def make_linearize_fn(self) -> Callable:
        """f(data, *params) -> (residuals [r], [J_i [r, size_i] per
        parameter block]), unbatched, by forward-mode differentiation."""
        fn = self.make_residual_fn()

        def lin(data, *params):
            def g(*ps):
                r = fn(data, *ps)
                return r, r

            jacs, r = torch.func.jacfwd(
                g, argnums=tuple(range(len(params))), has_aux=True)(*params)
            return r, list(jacs)

        return lin


class AutoDiffCostFunction(CostFunction):
    """Forward-mode AD cost (autodiff_cost_function.h:156).

    ceres:  AutoDiffCostFunction<Functor, kNumResiduals, N0, N1...>
    here:   AutoDiffCostFunction(functor, num_residuals, [n0, n1, ...])
    """

    def __init__(self, functor, num_residuals: int,
                 parameter_block_sizes: Sequence[int]):
        super().__init__(num_residuals, parameter_block_sizes)
        self._functor = functor
        self._code_key, self._call, self._data = _functor_parts(functor)

    @property
    def functor(self):
        return self._functor

    def bucket_key(self):
        return ("autodiff", self._code_key, self._num_residuals,
                tuple(self._parameter_block_sizes))

    def block_data(self):
        return self._data

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            return torch.as_tensor(call(data, *params)).reshape(nr)

        return fn


class SizedCostFunction(CostFunction):
    """User-subclassed cost (sized_cost_function.h:50): implement
    `residuals(*params)` with torch operations, and derivatives come from
    jacfwd; or also `jacobians(*params) -> [J_i [num_residuals, size_i]
    per parameter block]` for analytic ones. Instance attributes are
    per-block data."""

    def bucket_key(self):
        return ("sized", type(self), self._num_residuals,
                tuple(self._parameter_block_sizes))

    def residuals(self, *params):
        raise NotImplementedError

    def jacobians(self, *params):
        return None

    def block_data(self):
        return {k: v for k, v in vars(self).items()
                if k not in ("_num_residuals", "_parameter_block_sizes")}

    def make_residual_fn(self):
        cls = type(self)
        nr = self._num_residuals

        def fn(data, *params):
            obj = object.__new__(cls)
            object.__setattr__(obj, "__dict__", dict(data))
            return torch.as_tensor(obj.residuals(*params)).reshape(nr)

        return fn


class NumericDiffCostFunction(CostFunction):
    """Finite-difference cost (numeric_diff_cost_function.h:181; the
    reference's internal/numeric_diff.h:61): method FORWARD, CENTRAL or
    RIDDERS. All probes of one parameter block run as one batched call
    (vmap over the perturbation directions)."""

    def __init__(self, functor, method=NumericDiffMethodType.CENTRAL,
                 num_residuals: int = 1,
                 parameter_block_sizes: Sequence[int] = (),
                 options: Optional[NumericDiffOptions] = None):
        super().__init__(num_residuals, parameter_block_sizes)
        self._functor = functor
        self._method = method
        self._options = options or NumericDiffOptions()
        self._code_key, self._call, self._data = _functor_parts(functor)

    def bucket_key(self):
        return ("numdiff", self._code_key, self._method, self._num_residuals,
                tuple(self._parameter_block_sizes))

    def block_data(self):
        return self._data

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            return torch.as_tensor(call(data, *params)).reshape(nr)

        return fn

    def jacobian_of(self, residual_fn, slot: int):
        """jfn(data, params) -> [num_residuals, size] finite-difference
        Jacobian with respect to parameter slot `slot` (ceres_tpu
        cost.py:230-293): a relative step of max(|x|, 1) per coordinate;
        RIDDERS runs a fixed-depth Neville tableau of central differences
        over a shrinking step and keeps, per entry, the extrapolation
        with the smallest error estimate."""
        opts = self._options
        method = self._method

        def jfn(data, params):
            x = params[slot]
            rel = (opts.ridders_relative_initial_step_size
                   if method == NumericDiffMethodType.RIDDERS
                   else opts.relative_step_size)
            step = rel * torch.clamp(torch.abs(x), min=1.0)
            eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)

            def eval_at(xs):
                ps = list(params)
                ps[slot] = xs
                return residual_fn(data, *ps)

            def probes(sign, h):
                return torch.func.vmap(
                    lambda e, hh: eval_at(x + sign * hh * e))(eye, h)

            if method == NumericDiffMethodType.FORWARD:
                f0 = eval_at(x)
                return ((probes(1.0, step) - f0[None, :])
                        / step[:, None]).T
            if method == NumericDiffMethodType.CENTRAL:
                return ((probes(1.0, step) - probes(-1.0, step))
                        / (2.0 * step[:, None])).T

            def central(h):                 # [size, nr]
                return (probes(1.0, h) - probes(-1.0, h)) / (2.0 * h[:, None])

            T = opts.max_num_ridders_extrapolations
            shrink = opts.ridders_step_shrink_factor
            col = [central(step / (shrink ** t)) for t in range(T)]
            best = col[0]
            best_err = torch.full_like(best, float("inf"))
            prev_row = [col[0]]
            for t in range(1, T):
                row = [col[t]]
                fac = shrink ** 2
                for m in range(1, t + 1):
                    new = (row[m - 1] * fac - prev_row[m - 1]) / (fac - 1.0)
                    fac *= shrink ** 2
                    err = torch.maximum(torch.abs(new - row[m - 1]),
                                        torch.abs(new - prev_row[m - 1]))
                    better = err < best_err
                    best = torch.where(better, new, best)
                    best_err = torch.where(better, err, best_err)
                    row.append(new)
                prev_row = row
            return best.T

        return jfn


class DynamicAutoDiffCostFunction(AutoDiffCostFunction):
    """Runtime-sized AD cost (dynamic_autodiff_cost_function.h:80): the
    functor takes one list of parameter tensors; the sizes are set with
    add_parameter_block and set_num_residuals before the block is added
    (fixed from then on, as a bucket's shapes are)."""

    def __init__(self, functor):
        self._functor = functor
        self._code_key, self._call, self._data = _functor_parts(functor)
        self._num_residuals = -1
        self._parameter_block_sizes = []

    def add_parameter_block(self, size: int):
        self._parameter_block_sizes.append(int(size))

    def set_num_residuals(self, n: int):
        self._num_residuals = int(n)

    def bucket_key(self):
        return ("dyn_autodiff", self._code_key, self._num_residuals,
                tuple(self._parameter_block_sizes))

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            return torch.as_tensor(call(data, list(params))).reshape(nr)

        return fn


class DynamicNumericDiffCostFunction(NumericDiffCostFunction):
    """dynamic_numeric_diff_cost_function.h: as DynamicAutoDiffCostFunction,
    with finite-difference Jacobians."""

    def __init__(self, functor, method=NumericDiffMethodType.CENTRAL,
                 options: Optional[NumericDiffOptions] = None):
        self._functor = functor
        self._method = method
        self._options = options or NumericDiffOptions()
        self._code_key, self._call, self._data = _functor_parts(functor)
        self._num_residuals = -1
        self._parameter_block_sizes = []

    def add_parameter_block(self, size: int):
        self._parameter_block_sizes.append(int(size))

    def set_num_residuals(self, n: int):
        self._num_residuals = int(n)

    def bucket_key(self):
        return ("dyn_numdiff", self._code_key, self._method,
                self._num_residuals, tuple(self._parameter_block_sizes))

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            return torch.as_tensor(call(data, list(params))).reshape(nr)

        return fn


def _data_like(data, like):
    """A cost's block data as tensors beside `like` (its device; floating
    values in its dtype), for a cost called from inside another functor."""
    out = {}
    for k, v in data.items():
        if not torch.is_tensor(v):
            v = torch.as_tensor(np.asarray(v))
        out[k] = v.to(device=like.device,
                      dtype=like.dtype if v.is_floating_point() else v.dtype)
    return out


class CostFunctionToFunctor:
    """A CostFunction as a functor, so analytic and AD costs mix
    (cost_function_to_functor.h:104): a call runs the cost's residual
    function, which jacfwd differentiates through."""

    def __init__(self, cost_function: CostFunction):
        self._cost = cost_function
        self._fn = cost_function.make_residual_fn()
        self._data = cost_function.block_data()

    def __call__(self, *params):
        return self._fn(_data_like(self._data, params[0]), *params)


class DynamicCostFunctionToFunctor(CostFunctionToFunctor):
    """A dynamically sized CostFunction as a functor
    (dynamic_cost_function_to_functor.h:46), called with one list of
    parameter tensors (the reference's T const* const* parameters)."""

    def __call__(self, params):
        return self._fn(_data_like(self._data, params[0]), *params)


class ConditionedCostFunction(CostFunction):
    """out_i = c_i(r_i) (conditioned_cost_function.h:74): one conditioner
    a residual, a CostFunction of one residual and one parameter, a
    callable, or None (the identity). Blocks share a bucket when they
    share the wrapped cost's key and the conditioners themselves."""

    def __init__(self, wrapped: CostFunction, conditioners):
        super().__init__(wrapped.num_residuals,
                         wrapped.parameter_block_sizes)
        if len(conditioners) != wrapped.num_residuals:
            raise ValueError("need one conditioner per residual")
        self._wrapped = wrapped
        self._conditioners = list(conditioners)

    def bucket_key(self):
        return ("conditioned", self._wrapped.bucket_key(),
                tuple(id(c) for c in self._conditioners))

    def block_data(self):
        return self._wrapped.block_data()

    def make_residual_fn(self):
        inner = self._wrapped.make_residual_fn()
        conds = [(c.make_residual_fn(), c.block_data())
                 if isinstance(c, CostFunction) else c
                 for c in self._conditioners]

        def fn(data, *params):
            r = inner(data, *params)
            outs = []
            for i, c in enumerate(conds):
                if c is None:
                    outs.append(r[i])
                elif isinstance(c, tuple):
                    outs.append(torch.reshape(
                        c[0](_data_like(c[1], r), r[i:i + 1]), ()))
                else:
                    outs.append(torch.reshape(torch.as_tensor(
                        c(r[i:i + 1])), ()))
            return torch.stack(outs)

        return fn


class NormalPrior(CostFunction):
    """r = A (x - b), a Gaussian prior (normal_prior.h:60); A and b ride
    the bucket as per-block data, keyed on A's shape."""

    def __init__(self, A, b):
        A = np.asarray(A, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if A.ndim != 2 or b.ndim != 1 or A.shape[1] != b.shape[0]:
            raise ValueError("A must be [r, n], b must be [n]")
        super().__init__(A.shape[0], [b.shape[0]])
        self.A = A
        self.b = b

    def bucket_key(self):
        return ("normal_prior", self.A.shape)

    def block_data(self):
        return {"A": self.A, "b": self.b}

    def make_residual_fn(self):
        def fn(data, x):
            return data["A"] @ (x - data["b"])

        return fn
