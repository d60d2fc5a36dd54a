"""Problem: the mutable graph of parameter blocks and residual blocks.

Counterpart of ceres_tpu/problem.py (the reference's problem.h:120-532,
problem_impl.cc): ProblemOptions, parameter blocks, constancy,
manifolds, bounds, add_residual_block, removal, the accessors, and
Problem::Evaluate with its residual-block forms (`evaluate`,
`evaluate_residual_block`) on an explicit `device`.

Parameter blocks are identified by the numpy array object the user passes
(the reference keys on the double* pointer); the solver writes results
back into those arrays in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cost import CostFunction
from .loss import LossFunction
from .manifolds import Manifold


class _ParamBlock:
    __slots__ = ("array", "size", "manifold", "constant", "lower", "upper",
                 "index")

    def __init__(self, array: np.ndarray, index: int):
        self.array = array
        self.size = int(array.size)
        self.manifold: Optional[Manifold] = None
        self.constant = False
        self.lower = None
        self.upper = None
        self.index = index

    @property
    def tangent_size(self) -> int:
        if self.constant:
            return 0
        return self.manifold.tangent_size if self.manifold else self.size

    def ensure_bounds(self):
        if self.lower is None:
            self.lower = np.full(self.size, -np.inf)
            self.upper = np.full(self.size, np.inf)

    @property
    def has_bounds(self) -> bool:
        return self.lower is not None


class ResidualBlockId:
    """Opaque handle returned by add_residual_block."""
    __slots__ = ("cost", "loss", "param_keys", "index")

    def __init__(self, cost, loss, param_keys, index):
        self.cost = cost
        self.loss = loss
        self.param_keys = param_keys
        self.index = index


class ProblemOptions:
    """The reference's Problem::Options (problem.h:160-190). The ownership
    arguments do nothing (Python owns its objects); enable_fast_removal is
    kept for the API (removal here is a pass over the residual blocks);
    disable_all_safety_checks skips add_residual_block's checks;
    evaluation_callback is told before each evaluation by
    Problem.evaluate* and by solve (taken into SolverOptions'
    evaluation_callback when that is unset)."""

    def __init__(self, enable_fast_removal: bool = False,
                 cost_function_ownership=None, loss_function_ownership=None,
                 manifold_ownership=None, disable_all_safety_checks=False,
                 evaluation_callback=None):
        self.enable_fast_removal = enable_fast_removal
        self.disable_all_safety_checks = disable_all_safety_checks
        self.evaluation_callback = evaluation_callback


# evaluations of a residual-block or parameter-block subset keep their
# view problem and program per signature, at most this many per problem
SUBSET_CACHE_SIZE = 256


def _eval_device(device) -> torch.device:
    """The device of an evaluation; a CUDA device must exist (no fallback
    to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate: device is CUDA but no CUDA device is "
                           "available (pass device='cpu')")
    return device


class Problem:
    def __init__(self, options: Optional[ProblemOptions] = None):
        self.options = options or ProblemOptions()
        self._blocks: dict[int, _ParamBlock] = {}     # id(array) -> block
        self._block_order: list[int] = []
        # a removed residual block leaves a hole (None), so that every
        # ResidualBlockId.index keeps naming its place in insertion order
        self._residuals: list[Optional[ResidualBlockId]] = []
        self._num_residual_blocks = 0
        self._next_param_index = 0
        self._revision = 0    # bumped on any structural change
        self._subset_eval_cache = {}

    # ---------- parameter blocks ----------

    @staticmethod
    def _as_key(values) -> int:
        if not isinstance(values, np.ndarray):
            raise TypeError("parameter blocks must be numpy arrays "
                            f"(user-owned memory); got {type(values)}")
        return id(values)

    def _get(self, values) -> _ParamBlock:
        key = self._as_key(values)
        if key not in self._blocks:
            raise KeyError("parameter block not in problem")
        return self._blocks[key]

    def add_parameter_block(self, values: np.ndarray, size: int = None,
                            manifold: Optional[Manifold] = None):
        if not isinstance(values, np.ndarray) or values.ndim != 1:
            raise TypeError("parameter blocks must be 1-D numpy arrays "
                            "(user-owned memory)")
        if size is not None and int(size) != values.size:
            raise ValueError(f"size {size} != array size {values.size}")
        key = id(values)
        if key not in self._blocks:
            self._blocks[key] = _ParamBlock(values, self._next_param_index)
            self._next_param_index += 1
            self._block_order.append(key)
            self._revision += 1
        if manifold is not None:
            self.set_manifold(values, manifold)
        return values

    def remove_parameter_block(self, values):
        """problem.h:297: removes the block and every residual block that
        names it."""
        key = self._as_key(values)
        self._get(values)
        for i, rb in enumerate(self._residuals):
            if rb is not None and key in rb.param_keys:
                self._residuals[i] = None
                self._num_residual_blocks -= 1
        del self._blocks[key]
        self._block_order.remove(key)
        self._revision += 1

    def set_parameter_block_constant(self, values):
        self._get(values).constant = True
        self._revision += 1

    def set_parameter_block_variable(self, values):
        self._get(values).constant = False
        self._revision += 1

    def is_parameter_block_constant(self, values) -> bool:
        return self._get(values).constant

    def set_manifold(self, values, manifold: Optional[Manifold]):
        blk = self._get(values)
        if manifold is not None and manifold.ambient_size != blk.size:
            raise ValueError(f"manifold ambient size {manifold.ambient_size}"
                             f" != block size {blk.size}")
        blk.manifold = manifold
        self._revision += 1

    def get_manifold(self, values) -> Optional[Manifold]:
        return self._get(values).manifold

    def has_manifold(self, values) -> bool:
        return self._get(values).manifold is not None

    def set_parameter_lower_bound(self, values, index: int, bound: float):
        blk = self._get(values)
        blk.ensure_bounds()
        blk.lower[index] = bound
        self._revision += 1

    def set_parameter_upper_bound(self, values, index: int, bound: float):
        blk = self._get(values)
        blk.ensure_bounds()
        blk.upper[index] = bound
        self._revision += 1

    def get_parameter_lower_bound(self, values, index: int) -> float:
        blk = self._get(values)
        return float(blk.lower[index]) if blk.lower is not None else -np.inf

    def get_parameter_upper_bound(self, values, index: int) -> float:
        blk = self._get(values)
        return float(blk.upper[index]) if blk.upper is not None else np.inf

    def has_parameter_block(self, values) -> bool:
        """problem.h:369."""
        try:
            key = self._as_key(values)
        except TypeError:
            return False
        return key in self._blocks

    def parameter_block_size(self, values) -> int:
        return self._get(values).size

    def parameter_block_tangent_size(self, values) -> int:
        blk = self._get(values)
        return blk.manifold.tangent_size if blk.manifold else blk.size

    # ---------- residual blocks ----------

    def add_residual_block(self, cost_function: CostFunction,
                           loss_function: Optional[LossFunction],
                           *parameter_blocks) -> ResidualBlockId:
        if len(parameter_blocks) == 1 and isinstance(parameter_blocks[0],
                                                     (list, tuple)):
            parameter_blocks = tuple(parameter_blocks[0])
        sizes = cost_function.parameter_block_sizes
        if len(parameter_blocks) != len(sizes):
            raise ValueError(f"cost function expects {len(sizes)} parameter "
                             f"blocks, got {len(parameter_blocks)}")
        check = not self.options.disable_all_safety_checks
        keys = []
        for pb, s in zip(parameter_blocks, sizes):
            if check:
                if not isinstance(pb, np.ndarray) or pb.size != s:
                    raise ValueError(
                        f"parameter block size mismatch: expected {s}, got "
                        f"{getattr(pb, 'size', None)}")
                if id(pb) in keys:
                    raise ValueError("duplicate parameter block in residual")
            if id(pb) not in self._blocks:
                self.add_parameter_block(pb)
            keys.append(id(pb))
        rb = ResidualBlockId(cost_function, loss_function, tuple(keys),
                             len(self._residuals))
        self._residuals.append(rb)
        self._num_residual_blocks += 1
        self._revision += 1
        return rb

    def _check_residual(self, rb: ResidualBlockId):
        if (rb.index >= len(self._residuals)
                or self._residuals[rb.index] is not rb):
            raise KeyError("residual block not in problem")

    def remove_residual_block(self, rb: ResidualBlockId):
        """problem.h:305. The parameter blocks stay, even those that no
        residual block names any more (they leave the program's layout,
        as in the reference's reduced program)."""
        self._check_residual(rb)
        self._residuals[rb.index] = None
        self._num_residual_blocks -= 1
        self._revision += 1

    # ---------- introspection ----------

    def num_parameter_blocks(self) -> int:
        return len(self._blocks)

    def num_parameters(self) -> int:
        return sum(b.size for b in self._blocks.values())

    def num_residual_blocks(self) -> int:
        return self._num_residual_blocks

    def num_residuals(self) -> int:
        return sum(rb.cost.num_residuals for rb in self._residuals
                   if rb is not None)

    def parameter_blocks(self):
        return [self._blocks[k].array for k in self._block_order]

    def residual_blocks(self):
        return [rb for rb in self._residuals if rb is not None]

    def get_parameter_blocks_for_residual_block(self, rb: ResidualBlockId):
        return [self._blocks[k].array for k in rb.param_keys]

    def get_cost_function_for_residual_block(self, rb: ResidualBlockId):
        """problem.h:387."""
        return rb.cost

    def get_loss_function_for_residual_block(self, rb: ResidualBlockId):
        """problem.h:392."""
        return rb.loss

    def get_residual_blocks_for_parameter_block(self, values):
        key = self._as_key(values)
        return [rb for rb in self._residuals
                if rb is not None and key in rb.param_keys]

    # accessors for program.py
    def _param_records(self):
        return [self._blocks[k] for k in self._block_order]

    def _residual_records(self):
        return [rb for rb in self._residuals if rb is not None]

    # ---------- evaluation (problem.h:455 Problem::Evaluate) ----------

    def evaluate(self, apply_loss_function: bool = True,
                 residual_blocks=None, parameter_blocks=None,
                 want_residuals: bool = True, want_gradient: bool = False,
                 want_jacobian: bool = False, new_point: bool = True,
                 jacobian_format: str = "dense", device="cuda"):
        """(cost, residuals, gradient, jacobian) as numpy, each None when
        not asked for (problem_impl.cc:585, EvaluateOptions problem.h:
        405-438), computed in f64 on `device`.

        residual_blocks: the residual blocks to evaluate and their row
        order (None: all, in insertion order). parameter_blocks: the
        blocks and their column order (None: all, in insertion order);
        a block not listed is held constant for this evaluation, and a
        listed block gives tangent_size columns (0 if constant), zero
        where the chosen residual blocks do not touch it.
        Residuals are loss-corrected; the gradient and Jacobian are in
        tangent space. jacobian_format "dense" (numpy) or "csr" (scipy
        CSR, the reference's CRSMatrix, never densified)."""
        from .program import CompiledProgram
        device = _eval_device(device)
        cb = self.options.evaluation_callback
        if cb is not None:
            cb.prepare_for_evaluation(
                evaluate_jacobians=bool(want_gradient or want_jacobian),
                new_evaluation_point=new_point)
        if residual_blocks is None and parameter_blocks is None:
            # every residual block, all-constant ones too
            prog = CompiledProgram.get_cached(
                self, device=device, apply_loss=apply_loss_function,
                include_fixed_blocks=True)
            return prog.public_evaluate(want_residuals, want_gradient,
                                        want_jacobian,
                                        jacobian_format=jacobian_format)

        # A subset: a view problem sharing the user's arrays and costs,
        # whose insertion order is the requested row and column order (the
        # reference builds a temporary Program the same way). The view and
        # its program are kept per signature: a loop over
        # evaluate_residual_block reuses them; values are read fresh.
        sel_res = (list(residual_blocks) if residual_blocks is not None
                   else self.residual_blocks())
        sig = (self._revision, str(device), bool(apply_loss_function),
               tuple(rb.index for rb in sel_res),
               None if parameter_blocks is None
               else tuple(id(pb) for pb in parameter_blocks))
        cache = self._subset_eval_cache
        for k in [k for k in cache if k[0] != self._revision]:
            del cache[k]
        if sig not in cache:
            view = self._subset_view(sel_res, parameter_blocks)
            prog = CompiledProgram(view, device,
                                   apply_loss=apply_loss_function,
                                   include_fixed_blocks=True)
            if len(cache) >= SUBSET_CACHE_SIZE:
                cache.pop(next(iter(cache)))
            cache[sig] = (view, prog)
        view, prog = cache[sig]
        return self._finish_subset_evaluate(
            view, prog, parameter_blocks, want_residuals, want_gradient,
            want_jacobian, jacobian_format)

    def _subset_view(self, sel_res, parameter_blocks):
        """The view problem of a subset evaluation."""
        view = Problem()
        listed_keys = None
        if parameter_blocks is not None:
            listed_keys = set()
            for pb in parameter_blocks:
                src = self._get(pb)
                view.add_parameter_block(pb)
                vb = view._get(pb)
                vb.manifold = src.manifold
                vb.constant = src.constant
                listed_keys.add(id(pb))
        for rb in sel_res:
            self._check_residual(rb)
            arrays = [self._blocks[k].array for k in rb.param_keys]
            view.add_residual_block(rb.cost, rb.loss, *arrays)
            for k, arr in zip(rb.param_keys, arrays):
                src, vb = self._blocks[k], view._get(arr)
                vb.manifold = src.manifold
                # blocks outside parameter_blocks are held constant
                # (problem_impl.cc: SetConstant during the evaluation)
                vb.constant = src.constant or (
                    listed_keys is not None and k not in listed_keys)
        return view

    def _finish_subset_evaluate(self, view, prog, parameter_blocks,
                                want_residuals, want_gradient,
                                want_jacobian, jacobian_format):
        cost, res, grad, jac = prog.public_evaluate(
            want_residuals, want_gradient, want_jacobian,
            jacobian_format=jacobian_format)
        if not (want_gradient or want_jacobian):
            return cost, res, grad, jac

        # Widen the view's tangent columns to the requested block list:
        # the view's program leaves out blocks the chosen residuals do not
        # touch; the reference gives every listed variable block its
        # tangent_size columns (zero if untouched).
        req = (parameter_blocks if parameter_blocks is not None
               else self.parameter_blocks())
        used = set()
        for rb in view._residual_records():
            used.update(rb.param_keys)
        src_off, o = {}, 0    # the view's columns, in its insertion order
        for key in view._block_order:
            vb = view._blocks[key]
            if vb.constant or key not in used or vb.tangent_size == 0:
                continue
            src_off[key] = (o, vb.tangent_size)
            o += vb.tangent_size
        widths = []
        for pb in req:
            vb = view._blocks.get(id(pb))
            if vb is None:    # listed, untouched by the chosen residuals
                vb = self._get(pb)
            widths.append(0 if vb.constant else vb.tangent_size)
        total = sum(widths)
        grad_out = np.zeros(total) if want_gradient else None
        sparse = want_jacobian and jacobian_format == "csr"
        src_cols, dst_cols = [], []
        jac_out = (np.zeros((jac.shape[0], total))
                   if want_jacobian and not sparse else None)
        d = 0
        for pb, w in zip(req, widths):
            s = src_off.get(id(pb))
            if s is not None and w:
                if want_gradient:
                    grad_out[d:d + w] = grad[s[0]:s[0] + s[1]]
                if sparse:
                    src_cols.extend(range(s[0], s[0] + s[1]))
                    dst_cols.extend(range(d, d + w))
                elif want_jacobian:
                    jac_out[:, d:d + w] = jac[:, s[0]:s[0] + s[1]]
            d += w
        if sparse:        # the column projection jac @ P
            import scipy.sparse as sp
            P = sp.coo_matrix(
                (np.ones(len(src_cols)), (src_cols, dst_cols)),
                shape=(jac.shape[1], total)).tocsr()
            jac_out = (jac @ P).tocsr()
        return cost, res, grad_out, jac_out

    def evaluate_residual_block(self, rb: ResidualBlockId,
                                apply_loss_function: bool = True,
                                want_jacobians: bool = True,
                                new_point: bool = True, device="cuda"):
        """problem.h:515 EvaluateResidualBlock: (cost, residuals,
        jacobians), jacobians one [num_residuals, tangent_size] array a
        parameter block of rb (None for a constant block), or None when
        want_jacobians is False; the loss and the manifolds applied."""
        self._check_residual(rb)
        cost, res, _, jac = self.evaluate(
            apply_loss_function=apply_loss_function, residual_blocks=[rb],
            parameter_blocks=[self._blocks[k].array for k in rb.param_keys],
            want_residuals=True, want_gradient=False,
            want_jacobian=want_jacobians, new_point=new_point,
            device=device)
        if not want_jacobians:
            return cost, res, None
        jacs, col = [], 0
        for k in rb.param_keys:
            blk = self._blocks[k]
            if blk.constant:
                jacs.append(None)
                continue
            w = blk.tangent_size
            jacs.append(jac[:, col:col + w])
            col += w
        return cost, res, jacs

    def evaluate_residual_block_assuming_parameters_unchanged(
            self, rb: ResidualBlockId, apply_loss_function: bool = True,
            want_jacobians: bool = True, device="cuda"):
        """problem.h:533: evaluate_residual_block with the
        EvaluationCallback told new_point=False."""
        return self.evaluate_residual_block(
            rb, apply_loss_function=apply_loss_function,
            want_jacobians=want_jacobians, new_point=False, device=device)
