"""Shared set-up of the batch-mode parity tests
(tests/test_torch_batch_rest.py, tests/test_torch_batch_schur.py): the
elements (tests/test_torch_batch.py's BA graph and curve fits, and a
70-pose SE2 graph past SPARSE_DENSE_CAP's 200 effective parameters),
built from the same seeds in both packages, and one run of the JAX
package's solve_batched(batch_mode="batch") and of the port's batch and
pipeline modes on them, with each element's counts, termination, final
cost and parameters."""

import contextlib
import os

import numpy as np
import torch

import torch_parity_kit  # noqa: F401  (one thread)
import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu import batch as jax_batch
from ceres_tpu.examples.slam import build_pose_graph_2d_problem as jax_se2
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.io.g2o import synthetic_pose_graph_2d as jax_graph
from ceres_tpu_torch.examples.slam import \
    build_pose_graph_2d_problem as torch_se2
from ceres_tpu_torch.io.bal import build_bal_ceres_problem as torch_build
from ceres_tpu_torch.io.g2o import synthetic_pose_graph_2d as torch_graph

SEEDS = (1, 2, 3)
CURVE_TRUTHS = [(0.3, 0.1), (0.25, 0.4), (0.5, -0.2), (0.1, 0.8)]
SE2_POSES = 70


def ba_bal(seed):
    """tests/test_torch_batch.py's BA graph (4 cameras, 60 points, 240
    observations, graph seed 11), perturbed with `seed`."""
    bal = synthetic_bal_problem(num_cameras=4, num_points=60,
                                num_observations=240, seed=11,
                                pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=seed)
    return bal


class _JaxExp:
    def __init__(self, x, y):
        self.x, self.y = float(x), float(y)

    def __call__(self, m, c):
        import jax.numpy as jnp
        return self.y - jnp.exp(m[0] * self.x + c[0])


class _TorchExp(_JaxExp):
    def __call__(self, m, c):
        return self.y - torch.exp(m[0] * self.x + c[0])


def elements(kind, mod):
    """[(problem, [parameter arrays])] of one batch in package `mod`:
    "ba" (3 BA starts), "curve" (4 curve fits), "se2" (3 SE2 graphs)."""
    out = []
    if kind == "ba":
        for s in SEEDS:
            prob, cams, pts = (jax_build if mod is ct else torch_build)(
                ba_bal(s))
            out.append((prob, list(cams) + list(pts)))
    elif kind == "curve":
        rng = np.random.default_rng(3)
        functor = _JaxExp if mod is ct else _TorchExp
        for mt, c_t in CURVE_TRUTHS:
            m, c = np.array([0.0]), np.array([0.0])
            prob = mod.Problem()
            for x in np.linspace(0, 5, 25):
                y = float(np.exp(mt * x + c_t)
                          + 0.01 * rng.standard_normal())
                prob.add_residual_block(mod.AutoDiffCostFunction(
                    functor(x, y), 1, [1, 1]), None, m, c)
            out.append((prob, [m, c]))
    else:
        for s in SEEDS:
            poses, edges, _ = (jax_graph if mod is ct else torch_graph)(
                num_poses=SE2_POSES, seed=s)
            prob, pos, yaws = (jax_se2 if mod is ct else torch_se2)(poses,
                                                                    edges)
            out.append((prob, [pos[i] for i in sorted(pos)]
                        + [yaws[i] for i in sorted(yaws)]))
    return out


def options(mod, kind, **kw):
    base = dict(max_num_iterations=50, fused_iterations=True,
                function_tolerance=1e-12 if kind == "curve" else 1e-9)
    base.update(kw)
    if mod is not ct:
        base.setdefault("device", "cpu")
    for k, v in list(base.items()):
        if isinstance(v, str) and k.endswith("_type"):
            enum = {"linear_solver_type": mod.LinearSolverType,
                    "preconditioner_type": mod.PreconditionerType,
                    "trust_region_strategy_type":
                        mod.TrustRegionStrategyType,
                    "dogleg_type": mod.DoglegType}[k]
            base[k] = enum[v]
    return mod.SolverOptions(**base)


@contextlib.contextmanager
def env(**values):
    """The JAX package's switches, with its template registry cleared
    around them (its key does not see an environment variable)."""
    old = {k: os.environ.get(k) for k in values}
    jax_batch._TEMPLATE_REGISTRY.clear()
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax_batch._TEMPLATE_REGISTRY.clear()


def run(mod, kind, batch_mode="batch", **kw):
    """One solve_batched of the batch: per element (LM iterations, linear
    iterations, termination name, final cost, parameters)."""
    elems = elements(kind, mod)
    subset = kw.pop("subset", None)
    if subset is not None:      # SUBSET: the first `subset` residual blocks
        kw["residual_blocks_for_subset_preconditioner"] = \
            elems[0][0].residual_blocks()[:subset]
    ss = mod.solve_batched(options(mod, kind, batch_mode=batch_mode, **kw),
                           [p for p, _ in elems])
    assert all(f"[{batch_mode}]" in s.message for s in ss)
    return [(s.num_iterations, s.num_linear_solver_iterations,
             s.termination_type.name, s.final_cost,
             np.concatenate([np.ravel(a) for a in arrs]))
            for s, (_, arrs) in zip(ss, elems)]


def jax_run(kind, jax_env=None, **kw):
    with env(**(jax_env or {})):
        return run(ct, kind, **kw)


def jax_single_run(kind, **kw):
    """The JAX package's ct.solve of each element in turn, in run's
    format."""
    elems = elements(kind, ct)
    subset = kw.pop("subset", None)
    if subset is not None:
        kw["residual_blocks_for_subset_preconditioner"] = \
            elems[0][0].residual_blocks()[:subset]
    out = []
    for prob, arrs in elems:
        if subset is not None:
            # the same rows of this element's own problem
            kw["residual_blocks_for_subset_preconditioner"] = \
                prob.residual_blocks()[:subset]
        s = ct.solve(options(ct, kind, **kw), prob)
        out.append((s.num_iterations, s.num_linear_solver_iterations,
                    s.termination_type.name, s.final_cost,
                    np.concatenate([np.ravel(a) for a in arrs])))
    return out


def port_first_steps(options, problems):
    """The port's batch-mode step at each element's start and the initial
    radius (batched_tr_solve's first iteration): per element (model cost
    change, step norm, linear iterations)."""
    from ceres_tpu_torch import batch as batch_mod
    from ceres_tpu_torch.program import CompiledProgram
    programs = [CompiledProgram.get_cached(p, options) for p in problems]
    data = batch_mod._Batch(programs)
    step = batch_mod.make_batched_step(programs[0], options).bind(data)
    x0 = data.x0
    art = step.linearize(x0, None, first=True, cost=step.cost(x0))
    radius = torch.full((x0.shape[0],), options.initial_trust_region_radius,
                        dtype=torch.float64, device=x0.device)
    delta, mcc, its = step.solve(art, radius)
    return [(float(m), float(n), int(i)) for m, n, i in zip(
        mcc, torch.linalg.vector_norm(delta, dim=1), its)]


def jax_first_steps(options, problems):
    """The JAX package's batched step (make_step_impl(..., batched=True),
    the step its solve_batched vmaps) at each element's start, its Jacobi
    scale and the initial radius: per element (model cost change, step
    norm, linear iterations)."""
    import jax
    import jax.numpy as jnp
    from ceres_tpu.program import CompiledProgram
    from ceres_tpu.solver import make_scale_impl, make_step_impl
    out = []
    for p in problems:
        prog = CompiledProgram.get_cached(p, options)
        step = make_step_impl(prog, options, batched=True)
        scale = make_scale_impl(prog, options)
        o = jax.jit(lambda x, r: step(x, r, scale(x)))(
            prog.initial_state(),
            jnp.asarray(options.initial_trust_region_radius, prog.dtype))
        out.append((float(o["model_cost_change"]), float(o["step_norm"]),
                    int(o["lin_iters"])))
    return out


def held(ours, ref, exact: bool, cost_rtol: float, x_atol=None,
         label=""):
    """Each element of `ours` against `ref`: with `exact`, LM and linear
    iteration counts and termination equal; the final cost within
    cost_rtol relative; the parameters within x_atol (None: not held)."""
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        if exact:
            assert a[:3] == b[:3], (label, i, a[:4], b[:4])
        np.testing.assert_allclose(a[3], b[3], rtol=cost_rtol, atol=0,
                                   err_msg=f"{label} element {i}")
        if x_atol is not None:
            np.testing.assert_allclose(a[4], b[4], rtol=0, atol=x_atol,
                                       err_msg=f"{label} element {i}")
