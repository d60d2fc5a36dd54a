"""CompiledProgram: a Problem laid out as tensors on one device.

Counterpart of ceres_tpu/program.py for the slices. The layout of the
state vector x is the JAX package's, so a JAX state (as numpy) drives the
port exactly (`state_from_numpy`):
  - ambient x: every used parameter block, grouped by size (stable in
    insertion order), so each size group is one contiguous slab;
  - tangent space: the variable blocks grouped by tangent size;
  - residual blocks grouped into buckets by (cost code, loss, slot
    signature), each bucket's rows ordered by the block index of its slot
    with the most blocks (the point slot in bundle adjustment); a flat
    loss class of plain numbers is one bucket whatever its scalars, which
    ride along per row where they differ (`loss_attrs`, as the JAX
    package's), a nested loss keys by structure and value (F2).
Per-bucket data and index maps are tensors on the program's device.

The generic trust-region path reads the program through `plus` (batched
per manifold group, then projected onto the bound box when a block has
bounds), `cost_fn`, `residuals_fn`, `linearize_fn` (f64) and
`linearize_fn_mixed`: the f64 cost from a residual-only pass, and the
f32 tangent Jacobian of each bucket from kernel K11 (ops/linearize.py)
where a hand spec or an auto spec matches the bucket, chosen once here,
else as the f64 pass takes it (ceres_tpu program.py _bucket_linearize):
by the bucket's `jac_mode`, torch.func.jacfwd through the slots'
manifold Plus ("ad"), or the cost's own ambient Jacobian ("analytic",
SizedCostFunction.jacobians; "numdiff", NumericDiffCostFunction) times
each manifold slot's plus_jacobian. The f64 pass never launches K11, as
the JAX package runs its Pallas linearize on the f32 pass only.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .cost import NumericDiffCostFunction, SizedCostFunction
from .loss import correct_residuals_and_jacobian, stacked_loss
from .manifolds import EuclideanManifold
from .ops.bsr import (BlockJacobian, BucketJacobian, GroupMeta, RVec,
                      column_sum_for)
from .ops.jet_compile import AutoSpec, loss_structure
from .ops.linearize import (bucket_linearize, bucket_linearize_auto,
                            linearize_spec)


def _loss_vectorizable(loss) -> bool:
    """A loss whose attributes are all plain numbers: one bucket takes
    every loss of its class, the scalars that differ riding along as
    per-row tensors (ceres_tpu program.py _loss_vectorizable)."""
    try:
        return all(isinstance(v, (int, float)) for v in vars(loss).values())
    except TypeError:                   # no __dict__ (a loss of __slots__)
        return False


def _loss_key(loss):
    """Losses with equal keys share a bucket. A flat loss of plain
    numbers is keyed by its class alone, its scalars stacked per row when
    they differ (as in the JAX package: 24 per-filter FoE alphas make one
    bucket). Any other loss by its class, its scalar attributes and its
    bool and str attributes, nested losses walked
    (ScaledLoss(HuberLoss(0.1), 1) and ScaledLoss(CauchyLoss(10), 1)
    differ, as in Ceres; the JAX package's key leaves nested losses out,
    ROADMAP.md section 3, F2); a loss with any other attribute is its own
    key."""
    if loss is None:
        return None
    if _loss_vectorizable(loss):
        return (type(loss).__name__, "vectorized")
    try:
        structure, values = loss_structure(loss)
    except TypeError:
        return ("loss-id", id(loss))
    return (structure, tuple(values))


def bucket_loss_key(bk):
    """What a batch of programs must share of a bucket's loss: its class
    structure and, when the bucket has one set of scalars, their values
    (per-row scalars are data, stacked with the rows)."""
    if bk.loss_proto is None:
        return None
    try:
        structure, values = loss_structure(bk.loss_proto)
    except TypeError:
        return ("loss-id", id(bk.loss_proto))
    return (structure, "rows" if bk.loss_attrs is not None
            else tuple(values))


def loss_attrs_of(losses) -> "dict | None":
    """The per-row scalars of a bucket's flat losses (one a row), by
    attribute, as f64 numpy [n], or None when they agree (ceres_tpu
    program.py:427-439)."""
    sets = [vars(lf) for lf in losses]
    names = list(sets[0])
    if all(a[k] == sets[0][k] for a in sets for k in names):
        return None
    return {k: np.asarray([a[k] for a in sets], dtype=np.float64)
            for k in names}


def rows_loss(proto, attrs, rows=None, device=None):
    """The loss over a bucket's rows: `proto` when `attrs` is None, else
    its class with the per-row scalars `attrs` (rows `rows` of them) as
    f64 tensors on `device`."""
    if attrs is None:
        return proto
    return stacked_loss(proto, {
        k: torch.as_tensor(v if rows is None else v[rows], device=device)
        for k, v in attrs.items()})


class _Slot:
    __slots__ = ("variable", "amb_size", "tangent_size", "manifold",
                 "cols", "cols_t", "amb_gid", "amb_local")


class _Bucket:
    __slots__ = ("cost", "loss", "loss_proto", "loss_attrs", "residual_fn",
                 "data", "slots", "n", "r", "orig_indices", "_slot_keys",
                 "spec", "dat32", "jac_mode")


def _jac_mode(cost) -> str:
    """How a bucket's Jacobian is formed (ceres_tpu program.py:448-456):
    "numdiff", "analytic" (a SizedCostFunction that overrides jacobians),
    "host" (a cost evaluated on the host a bucket at a time, `host_rows`:
    the C API's costs, which vmap cannot call) or "ad"."""
    if hasattr(cost, "host_rows"):
        return "host"
    if isinstance(cost, NumericDiffCostFunction):
        return "numdiff"
    if (isinstance(cost, SizedCostFunction)
            and type(cost).jacobians is not SizedCostFunction.jacobians):
        return "analytic"
    return "ad"


class CompiledProgram:
    """A Problem at one structure revision, with its tensors on `device`."""

    @classmethod
    def get_cached(cls, problem, options=None, *, device=None,
                   apply_loss: bool = True,
                   include_fixed_blocks: bool = False):
        """Reuse the program across solves and evaluations while the
        problem's structure is unchanged (values are read fresh from the
        user arrays). Keyed on the revision, the device, the dtype,
        apply_loss and include_fixed_blocks (ceres_tpu program.py:130-153),
        so a Problem.evaluate program never serves a solve; entries of an
        older revision are dropped."""
        device = torch.device(device if device is not None
                              else options.device)
        key = (problem._revision, str(device), str(torch.float64),
               bool(apply_loss), bool(include_fixed_blocks))
        cache = {k: v for k, v in
                 getattr(problem, "_compiled_cache", {}).items()
                 if k[0] == problem._revision}
        problem._compiled_cache = cache
        if key not in cache:
            cache[key] = cls(problem, device, apply_loss=apply_loss,
                             include_fixed_blocks=include_fixed_blocks)
        return cache[key]

    def __init__(self, problem, device="cuda", apply_loss: bool = True,
                 include_fixed_blocks: bool = False):
        """apply_loss=False leaves the robust losses out of every cost,
        residual and Jacobian (Covariance's apply_loss_function,
        Problem.evaluate's apply_loss_function); the buckets stay those of
        the program with losses. include_fixed_blocks keeps the residual
        blocks whose parameters are all constant as buckets with zero
        tangent columns (ceres_tpu program.py:265-290), where a solve's
        program folds them into fixed_cost; such a program serves
        Problem.evaluate (f64) and picks no K11 spec."""
        self.problem = problem
        self.include_fixed_blocks = include_fixed_blocks
        self.device = torch.device(device)
        self.dtype = torch.float64
        records = problem._param_records()
        residuals = problem._residual_records()

        def is_fixed(rb):
            return all(problem._blocks[k].constant for k in rb.param_keys)

        if include_fixed_blocks:
            active_res, fixed_res = residuals, []
        else:
            active_res = [rb for rb in residuals if not is_fixed(rb)]
            fixed_res = [rb for rb in residuals if is_fixed(rb)]
        used_keys = set()
        for rb in residuals:
            used_keys.update(rb.param_keys)

        # --- parameter layout (sizes ascending, stable) ---
        self.used_blocks = [b for b in records if id(b.array) in used_keys]
        self.used_blocks.sort(key=lambda b: b.size)
        self.amb_offset = {}
        off = 0
        for b in self.used_blocks:
            self.amb_offset[id(b.array)] = off
            off += b.size
        self.num_ambient = off

        self.variable_blocks = [b for b in self.used_blocks
                                if not b.constant and b.tangent_size > 0]
        self.variable_blocks.sort(key=lambda b: b.tangent_size)
        self.tan_offset = {}
        toff = 0
        for b in self.variable_blocks:
            self.tan_offset[id(b.array)] = toff
            toff += b.tangent_size
        self.num_effective = toff

        self._amb_group_of_block = {}
        self.amb_slabs = []   # [(start_offset, k, size)]
        by_size = {}
        for b in self.used_blocks:
            by_size.setdefault(b.size, []).append(b)
        for gi, (size, blks) in enumerate(sorted(by_size.items())):
            for li, b in enumerate(blks):
                self._amb_group_of_block[id(b.array)] = (gi, li)
            self.amb_slabs.append((self.amb_offset[id(blks[0].array)],
                                   len(blks), size))

        # --- summary counts ---
        self.num_parameter_blocks = len(records)
        self.num_parameters = sum(b.size for b in records)
        self.num_effective_parameters = sum(
            (b.manifold.tangent_size if b.manifold else b.size)
            for b in records)
        self.num_residual_blocks = len(residuals)
        self.num_residuals_total = sum(rb.cost.num_residuals
                                       for rb in residuals)
        self.num_parameter_blocks_reduced = len(self.variable_blocks)
        self.num_parameters_reduced = sum(b.size
                                          for b in self.variable_blocks)
        self.num_effective_parameters_reduced = self.num_effective
        self.num_residual_blocks_reduced = len(active_res)
        self.num_residuals_reduced = sum(rb.cost.num_residuals
                                         for rb in active_res)
        self.has_bounds = any(b.has_bounds for b in self.variable_blocks)
        self._lo = self._hi = None
        if self.has_bounds:        # the box of plus (parameter_block.h)
            lo = np.full(self.num_ambient, -np.inf)
            hi = np.full(self.num_ambient, np.inf)
            for b in self.variable_blocks:
                if b.has_bounds:
                    o = self.amb_offset[id(b.array)]
                    lo[o:o + b.size] = b.lower
                    hi[o:o + b.size] = b.upper
            self._lo = torch.as_tensor(lo, device=self.device)
            self._hi = torch.as_tensor(hi, device=self.device)
        self.has_manifolds = any(
            b.manifold is not None
            and not isinstance(b.manifold, EuclideanManifold)
            for b in self.variable_blocks)

        # --- Jacobi groups: variable blocks by tangent size; the tangent
        # space is sorted by tangent size, so each is one contiguous slab ---
        size_groups = {}
        for b in self.variable_blocks:
            size_groups.setdefault(b.tangent_size, []).append(b)
        self.groups: List[GroupMeta] = []
        self._group_of_block = {}
        for gi, (t, blks) in enumerate(sorted(size_groups.items())):
            for li, b in enumerate(blks):
                self._group_of_block[id(b.array)] = (gi, li)
            self.groups.append(GroupMeta(t, len(blks),
                                         self.tan_offset[id(blks[0].array)]))

        # --- buckets ---
        groups_map = {}
        for rb in active_res:
            slot_sig = []
            for k in rb.param_keys:
                blk = problem._blocks[k]
                var = (not blk.constant) and blk.tangent_size > 0
                man_key = (blk.manifold.bucket_key() if blk.manifold
                           else ("euclid", blk.size))
                slot_sig.append((var, blk.size, man_key))
            key = (rb.cost.bucket_key(), _loss_key(rb.loss), tuple(slot_sig))
            groups_map.setdefault(key, []).append(rb)

        self.buckets: List[_Bucket] = []
        for rbs in groups_map.values():
            # rows ordered by the block index of the slot with most blocks
            if len(rbs) > 1:
                sort_si, sort_kg = None, 1
                for si, k in enumerate(rbs[0].param_keys):
                    blk = problem._blocks[k]
                    if blk.constant or blk.tangent_size <= 0:
                        continue
                    kg = self.groups[self._group_of_block[k][0]].num_blocks
                    if kg > sort_kg:
                        sort_kg, sort_si = kg, si
                if sort_si is not None:
                    rbs = sorted(rbs, key=lambda rb: self._group_of_block[
                        rb.param_keys[sort_si]][1])
            bk = _Bucket()
            bk.cost = rbs[0].cost
            # loss_proto: the first row's loss (its class and, with no
            # loss_attrs, its scalars); loss_attrs: the rows' scalars of a
            # flat loss class where they differ; loss: what the rows
            # apply (loss_proto, or its class over the per-row scalars)
            bk.loss_proto = rbs[0].loss if apply_loss else None
            bk.loss_attrs = None
            if bk.loss_proto is not None and _loss_vectorizable(
                    bk.loss_proto):
                bk.loss_attrs = loss_attrs_of([rb.loss for rb in rbs])
            bk.loss = rows_loss(bk.loss_proto, bk.loss_attrs,
                                device=self.device)
            bk.n = len(rbs)
            bk.r = bk.cost.num_residuals
            bk.orig_indices = np.asarray([rb.index for rb in rbs],
                                         dtype=np.int64)
            bk.residual_fn = bk.cost.make_residual_fn()
            bk.jac_mode = _jac_mode(bk.cost)
            datas = [rb.cost.block_data() for rb in rbs]
            bk.data = {name: torch.as_tensor(
                np.stack([np.asarray(d[name]) for d in datas]),
                device=self.device) for name in datas[0]}
            bk.data = {name: (v.to(self.dtype) if v.is_floating_point()
                              else v) for name, v in bk.data.items()}
            bk.slots = []
            var_si = 0
            for si in range(len(bk.cost.parameter_block_sizes)):
                sl = _Slot()
                blk0 = problem._blocks[rbs[0].param_keys[si]]
                sl.amb_size = blk0.size
                sl.variable = (not blk0.constant) and blk0.tangent_size > 0
                sl.manifold = blk0.manifold
                sl.tangent_size = blk0.tangent_size if sl.variable else 0
                sl.amb_gid = self._amb_group_of_block[
                    rbs[0].param_keys[si]][0]
                sl.amb_local = torch.as_tensor(np.fromiter(
                    (self._amb_group_of_block[rb.param_keys[si]][1]
                     for rb in rbs), dtype=np.int64, count=bk.n),
                    device=self.device)
                sl.cols = sl.cols_t = None
                if sl.variable:
                    tan_off = np.fromiter(
                        (self.tan_offset[rb.param_keys[si]] for rb in rbs),
                        dtype=np.int32, count=bk.n)
                    sl.cols = tan_off[:, None] + np.arange(
                        sl.tangent_size, dtype=np.int32)[None, :]
                    sl.cols_t = torch.as_tensor(sl.cols.astype(np.int64),
                                                device=self.device)
                    gid, _ = self._group_of_block[rbs[0].param_keys[si]]
                    local_ids = np.fromiter(
                        (self._group_of_block[rb.param_keys[si]][1]
                         for rb in rbs), dtype=np.int64, count=bk.n)
                    self.groups[gid].bucket_slots.append(
                        (len(self.buckets), var_si, local_ids))
                    var_si += 1
                bk.slots.append(sl)
            # K11 where a hand or auto spec matches an autodiff bucket,
            # chosen once; its data fields as one f32 tensor, built once
            bk.spec = (linearize_spec(self, bk)
                       if bk.jac_mode == "ad" and not include_fixed_blocks
                       else None)
            bk.dat32 = (bk.spec.data_matrix(bk) if bk.spec is not None
                        else None)
            self.buckets.append(bk)
        self.num_rows = sum(bk.n * bk.r for bk in self.buckets)

        # Plus groups: variable blocks by manifold, each with its ambient
        # and tangent slabs of x and delta (or index maps where a group's
        # blocks are not contiguous)
        plus_map = {}
        var_mask = np.zeros(self.num_ambient, dtype=np.float64)
        for b in self.variable_blocks:
            mk = (b.manifold.bucket_key() if b.manifold
                  else ("euclid", b.size))
            plus_map.setdefault(mk, []).append(b)
            o = self.amb_offset[id(b.array)]
            var_mask[o:o + b.size] = 1.0
        self.plus_groups = []
        for blks in plus_map.values():
            amb = np.concatenate([np.arange(self.amb_offset[id(b.array)],
                                            self.amb_offset[id(b.array)]
                                            + b.size) for b in blks])
            tan = np.concatenate([np.arange(self.tan_offset[id(b.array)],
                                            self.tan_offset[id(b.array)]
                                            + b.tangent_size) for b in blks])
            self.plus_groups.append((
                blks[0].manifold, len(blks), blks[0].size,
                blks[0].tangent_size, self._index_or_slice(amb),
                self._index_or_slice(tan)))
        self.tangent_is_ambient = bool(
            self.num_effective == self.num_ambient
            and all(m is None or isinstance(m, EuclideanManifold)
                    for m, *_ in self.plus_groups)
            and all(isinstance(a, slice) and a == t
                    for *_, a, t in self.plus_groups))
        self._all_variable = len(self.variable_blocks) == len(
            self.used_blocks)
        self._var_mask = torch.as_tensor(var_mask, device=self.device)
        self._col_sum = None

        self.fixed_cost = 0.0
        for rb in fixed_res:
            params = [torch.as_tensor(problem._blocks[k].array,
                                      dtype=self.dtype)
                      for k in rb.param_keys]
            data = {n: torch.as_tensor(np.asarray(v))
                    for n, v in rb.cost.block_data().items()}
            r = rb.cost.make_residual_fn()(data, *params)
            cost, _, _ = correct_residuals_and_jacobian(
                rb.loss if apply_loss else None, r[None], None)
            self.fixed_cost += float(cost[0])

    # ------------------------------------------------------------------
    # state

    def initial_state_numpy(self) -> np.ndarray:
        """The user arrays gathered into the ambient layout (f64 numpy)."""
        if not self.used_blocks:
            return np.zeros(0, dtype=np.float64)
        return np.concatenate([b.array for b in self.used_blocks],
                              axis=None).astype(np.float64, copy=False)

    def initial_state(self) -> torch.Tensor:
        return self.state_from_numpy(self.initial_state_numpy())

    def state_from_numpy(self, x) -> torch.Tensor:
        """A state in this layout (for example a JAX state as numpy) as an
        f64 tensor on the program's device."""
        x = np.array(x, dtype=np.float64)      # a writable copy
        if x.shape != (self.num_ambient,):
            raise ValueError(f"state must have shape ({self.num_ambient},)")
        return torch.from_numpy(x).to(self.device)

    @staticmethod
    def state_to_numpy(x) -> np.ndarray:
        return x.detach().to("cpu", torch.float64).numpy()

    def write_back(self, x):
        """Copy a state into the user's numpy arrays (the reference's
        StateVectorToParameterBlocks)."""
        xh = self.state_to_numpy(x)
        for b in self.used_blocks:
            if not b.constant:
                o = self.amb_offset[id(b.array)]
                b.array[:] = xh[o:o + b.size]

    def state_norm(self, x):
        """Norm of the variable part of x (the reference's reduced-program
        x_norm_)."""
        if self._all_variable:
            return torch.linalg.vector_norm(x)
        return torch.linalg.vector_norm(x * self._var_mask)

    def _index_or_slice(self, idx: np.ndarray):
        """A slice when idx is one contiguous run, else an index tensor."""
        if idx.size and np.array_equal(
                idx, np.arange(idx[0], idx[0] + idx.size)):
            return slice(int(idx[0]), int(idx[0]) + idx.size)
        return torch.as_tensor(idx, device=self.device)

    def plus(self, x, delta):
        """x' = Plus(x, delta), batched per manifold group, then projected
        onto the bound box (ceres_tpu program.py plus, :702-732); constant
        blocks keep their values."""
        if self.tangent_is_ambient:
            out = x + delta
        else:
            out = x.clone()
            for manifold, k, amb, t, a_ix, t_ix in self.plus_groups:
                xs, ds = x[a_ix].view(k, amb), delta[t_ix].view(k, t)
                new = (xs + ds if manifold is None
                       else manifold.plus_batch(xs, ds))
                out[a_ix] = new.reshape(-1)
        if self.has_bounds:
            out = torch.clamp(out, self._lo, self._hi)
        return out

    # ------------------------------------------------------------------
    # evaluation

    def _bucket_params(self, bk, x):
        """Per-slot parameters [n, size], taken from the size slabs."""
        out = []
        for sl in bk.slots:
            start, k, size = self.amb_slabs[sl.amb_gid]
            out.append(x[start:start + k * size].view(k, size)[sl.amb_local])
        return out

    def _bucket_residuals(self, bk, x):
        """Uncorrected residuals [n, r] of one bucket."""
        return self.rows_residuals(bk, self._bucket_params(bk, x), bk.data)

    def cost_fn(self, x):
        """Total cost 0.5 sum_i rho_i(||r_i||^2) + fixed_cost, in f64."""
        total = torch.tensor(self.fixed_cost, dtype=x.dtype, device=x.device)
        for bk in self.buckets:
            r = self._bucket_residuals(bk, x)
            cost, _, _ = correct_residuals_and_jacobian(
                bk.loss, r, None)
            total = total + torch.sum(cost)
        return total

    def _bucket_linearize(self, bk, x, dtype):
        """(residuals [n, r], J [n, r, t_total]) of one bucket in `dtype`,
        tangent space, uncorrected (ceres_tpu program.py _bucket_linearize,
        :795-903): in f32, K11 for a bucket with a hand or auto spec;
        otherwise by the bucket's jac_mode. An all-constant bucket gives
        zero tangent columns."""
        params = [p.to(dtype) for p in self._bucket_params(bk, x)]
        if dtype == torch.float32 and bk.spec is not None:
            xin = torch.cat(params, dim=1).contiguous()
            k11 = (bucket_linearize_auto if isinstance(bk.spec, AutoSpec)
                   else bucket_linearize)
            return k11(bk.spec, xin, bk.dat32)
        return self.rows_linearize(bk, params, bk.data, dtype)

    @staticmethod
    def rows_residuals(bk, params, data):
        """Uncorrected residuals [n, r] of rows of bucket `bk` at the
        per-slot parameters `params` ([n, size] each) with the per-row
        `data`, by torch.func.vmap (batch.py passes the rows of many
        problems at once); a "host" bucket by its cost's host_rows."""
        if bk.jac_mode == "host":
            return bk.cost.host_rows(params, data, False)[0].to(
                params[0].dtype)
        return torch.func.vmap(bk.residual_fn)(data, *params)

    @staticmethod
    def rows_linearize(bk, params, data, dtype):
        """(residuals [n, r], J [n, r, t_total]) of rows of bucket `bk`
        in `dtype`, tangent space, uncorrected, by the bucket's jac_mode
        (the plain route of _bucket_linearize: no K11)."""
        data = {k: (v.to(dtype) if v.is_floating_point() else v)
                for k, v in data.items()}
        fn = bk.residual_fn
        device = params[0].device
        var_slots = [(i, sl) for i, sl in enumerate(bk.slots) if sl.variable]
        if bk.jac_mode == "host":
            r, jacs = bk.cost.host_rows(params, data, bool(var_slots))
            Jts = []
            for i, sl in var_slots:
                J = jacs[i]
                if sl.manifold is not None and not isinstance(
                        sl.manifold, EuclideanManifold):
                    J = J @ torch.func.vmap(sl.manifold.plus_jacobian)(
                        params[i].double())
                Jts.append(J)
            J = (torch.cat(Jts, dim=-1) if Jts
                 else r.new_zeros(r.shape + (0,)))
            return r.to(dtype), J.to(dtype)
        if not var_slots:
            r = torch.func.vmap(fn)(data, *params)
            return r, r.new_zeros(r.shape + (0,))

        if bk.jac_mode == "ad":
            def per_block(data, *ps):
                def g(*deltas):
                    plussed = list(ps)
                    for (i, sl), d in zip(var_slots, deltas):
                        plussed[i] = (ps[i] + d if sl.manifold is None
                                      else sl.manifold.plus(ps[i], d))
                    r = fn(data, *plussed)
                    return r, r

                zeros = tuple(torch.zeros(sl.tangent_size, dtype=dtype,
                                          device=device)
                              for _, sl in var_slots)
                Js, r = torch.func.jacfwd(
                    g, argnums=tuple(range(len(zeros))),
                    has_aux=True)(*zeros)
                return r, torch.cat(Js, dim=-1)

            return torch.func.vmap(per_block)(data, *params)

        # analytic or numeric: the ambient Jacobian, then the PlusJacobian
        # chain rule (the reference's residual_block.cc:134-157)
        if bk.jac_mode == "analytic":
            cls = type(bk.cost)

            def jac_fn(data, ps):
                obj = object.__new__(cls)
                object.__setattr__(obj, "__dict__", dict(data))
                return obj.jacobians(*ps)
        else:
            slot_jfns = {i: bk.cost.jacobian_of(fn, i) for i, _ in var_slots}

            def jac_fn(data, ps):
                return [slot_jfns[i](data, ps) if i in slot_jfns else None
                        for i in range(len(ps))]

        def per_block(data, *ps):
            r = fn(data, *ps)
            Jambs = jac_fn(data, list(ps))
            Jts = []
            for i, sl in var_slots:
                Jamb = Jambs[i]
                Jamb = (Jamb if torch.is_tensor(Jamb)
                        else torch.as_tensor(Jamb)).to(r.dtype).reshape(
                            bk.r, sl.amb_size)
                if sl.manifold is None or isinstance(sl.manifold,
                                                     EuclideanManifold):
                    Jts.append(Jamb)
                else:
                    Jts.append(Jamb @ sl.manifold.plus_jacobian(ps[i]))
            return r, torch.cat(Jts, dim=-1)

        return torch.func.vmap(per_block)(data, *params)

    def _bucket_linearize32(self, bk, x):
        """_bucket_linearize in f32 (the mixed pass)."""
        return self._bucket_linearize(bk, x, torch.float32)

    def column_sum(self):
        """The fixed-order ColumnSum of J^T-side products (built once)."""
        if self._col_sum is None:
            self._col_sum = column_sum_for(
                [[sl.cols for sl in bk.slots if sl.variable]
                 for bk in self.buckets], self.num_effective, self.device)
        return self._col_sum

    def _bucket_jacobian(self, bk, J):
        return BucketJacobian(J, [sl.cols_t for sl in bk.slots
                                  if sl.variable])

    def residuals_fn(self, x, corrected: bool = False) -> RVec:
        """The buckets' residuals in f64 (loss-corrected when asked)."""
        parts = []
        for bk in self.buckets:
            r = self._bucket_residuals(bk, x)
            if corrected:
                _, r, _ = correct_residuals_and_jacobian(bk.loss, r, None)
            parts.append(r)
        return RVec(parts)

    def linearize_fn(self, x):
        """The f64 linearize (ceres_tpu program.py linearize_fn, :925-943):
        (cost, gradient [num_effective], BlockJacobian, residuals RVec),
        all f64 and loss-corrected; gradient = J^T r."""
        total = torch.tensor(self.fixed_cost, dtype=x.dtype, device=x.device)
        jac_buckets, res_parts = [], []
        for bk in self.buckets:
            r, J = self._bucket_linearize(bk, x, torch.float64)
            cost, rc, Jc = correct_residuals_and_jacobian(bk.loss, r, J)
            total = total + torch.sum(cost)
            jac_buckets.append(self._bucket_jacobian(bk, Jc))
            res_parts.append(rc)
        jac = BlockJacobian(jac_buckets, self.num_effective,
                            self.column_sum())
        res = RVec(res_parts)
        return total, jac.rmatvec(res), jac, res

    def linearize_fn_mixed(self, x):
        """Mixed-precision linearize (ceres_tpu program.py
        linearize_fn_mixed): (cost f64, gradient f32 [num_effective],
        BlockJacobian f32, residuals RVec f32). The cost comes from an f64
        residual-only pass, the Jacobian from the f32 pass; both are
        loss-corrected; gradient = J^T r."""
        total = torch.tensor(self.fixed_cost, dtype=x.dtype, device=x.device)
        jac_buckets, res_parts = [], []
        for bk in self.buckets:
            r64 = self._bucket_residuals(bk, x)
            cost, _, _ = correct_residuals_and_jacobian(bk.loss, r64, None)
            total = total + torch.sum(cost)
            # (jacfwd can give an f64 tangent from f32 inputs, ROADMAP.md
            # section 3: the loss correction takes both sides in f32)
            J32 = self._bucket_linearize32(bk, x)[1].to(torch.float32)
            _, rc, Jc = correct_residuals_and_jacobian(
                bk.loss, r64.to(torch.float32), J32)
            jac_buckets.append(self._bucket_jacobian(bk,
                                                     Jc.to(torch.float32)))
            res_parts.append(rc.to(torch.float32))
        jac = BlockJacobian(jac_buckets, self.num_effective,
                            self.column_sum())
        res = RVec(res_parts)
        return total, jac.rmatvec(res), jac, res

    # ------------------------------------------------------------------
    # Problem::Evaluate

    def _evaluate_layout(self):
        """The maps of public_evaluate, built once a program with numpy:
        each bucket's [n, r] destination rows (residual blocks in
        insertion order) and its [n, t] destination columns (tangent
        columns in parameter-block insertion order), and the tangent
        permutation itself (ceres_tpu program.py:1043-1055 and :1093-1096
        walk the blocks one at a time in Python for the same maps)."""
        layout = self.__dict__.get("_eval_layout")
        if layout is not None:
            return layout
        recs = self.problem._residual_records()
        index = np.fromiter((rb.index for rb in recs), dtype=np.int64,
                            count=len(recs))
        sizes = np.fromiter((rb.cost.num_residuals for rb in recs),
                            dtype=np.int64, count=len(recs))
        start = np.zeros(int(index.max()) + 1 if recs else 0, np.int64)
        start[index] = np.cumsum(sizes) - sizes      # index is ascending
        order = [b for b in self.problem._param_records()
                 if id(b.array) in self.tan_offset]
        perm = (np.concatenate([
            np.arange(self.tan_offset[id(b.array)],
                      self.tan_offset[id(b.array)] + b.tangent_size)
            for b in order]) if order else np.zeros(0, np.int64))
        inv = np.empty(perm.size, dtype=np.int64)
        inv[perm] = np.arange(perm.size)
        rows, cols = [], []
        for bk in self.buckets:
            rows.append(start[bk.orig_indices][:, None]
                        + np.arange(bk.r)[None, :])
            slot_cols = [sl.cols for sl in bk.slots if sl.variable]
            cols.append(inv[np.concatenate(slot_cols, axis=1)] if slot_cols
                        else np.zeros((bk.n, 0), np.int64))
        layout = self._eval_layout = (rows, cols, perm)
        return layout

    def public_evaluate(self, want_residuals, want_gradient, want_jacobian,
                        jacobian_format: str = "dense"):
        """Problem::Evaluate (problem_impl.cc:585; ceres_tpu program.py
        public_evaluate, :1005-1126) at the user arrays' values, f64 on
        the program's device: (cost, residuals in residual-block insertion
        order and loss-corrected, gradient and Jacobian in tangent space
        with the columns in parameter-block insertion order), as numpy,
        each None when not asked for. jacobian_format "dense" (numpy) or
        "csr" (scipy CSR, assembled from the blocks without densifying).
        Each output comes to the host in one copy."""
        x = self.initial_state()
        if want_gradient or want_jacobian:
            cost, grad, jac, res = self.linearize_fn(x)
        else:
            cost, grad, jac = self.cost_fn(x), None, None
            res = (self.residuals_fn(x, corrected=True) if want_residuals
                   else None)
        rows, cols, perm = self._evaluate_layout()
        residuals_out = grad_out = jac_out = None
        if want_residuals:
            residuals_out = np.zeros(self.num_rows)
            if self.buckets:
                residuals_out[np.concatenate([r.ravel() for r in rows])] = \
                    self.state_to_numpy(res.flatten())
        if want_gradient:
            grad_out = self.state_to_numpy(grad)[perm]
        if want_jacobian:
            ncols = perm.size
            parts = [(bj.J, r, c) for bj, r, c in zip(jac.buckets, rows, cols)
                     if bj.J.shape[2]]
            if parts:
                vals = self.state_to_numpy(torch.cat(
                    [J.reshape(-1) for J, _, _ in parts]))
                r_all = np.concatenate([np.broadcast_to(
                    r[:, :, None], J.shape).ravel() for J, r, _ in parts])
                c_all = np.concatenate([np.broadcast_to(
                    c[:, None, :], J.shape).ravel() for J, _, c in parts])
            else:
                vals = np.zeros(0)
                r_all = c_all = np.zeros(0, np.int64)
            if jacobian_format == "csr":
                import scipy.sparse as sp
                jac_out = sp.coo_matrix((vals, (r_all, c_all)),
                                        shape=(self.num_rows, ncols)).tocsr()
            else:
                jac_out = np.zeros((self.num_rows, ncols))
                jac_out[r_all, c_all] = vals
        return float(cost), residuals_out, grad_out, jac_out
