"""Rank bodies of the sharded-solve tests (tests/test_torch_sharded_*.py).

Each runs inside a rank that ceres_tpu_torch.parallel.launch.run_ranks
spawned, so this module imports torch and the port only (a spawned rank
imports its target's module; the JAX references are computed in the
pytest process). The problems are built from numpy inputs passed in.
"""

import hashlib

import numpy as np
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples.snavely import SnavelyReprojectionError
from ceres_tpu_torch.io.bal import build_bal_ceres_problem


def two_bucket_problem(bal):
    """test_fused_schur.py's _two_bucket_bal_problem in the port: every
    even observation under HuberLoss(2.0), the odd ones plain."""
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pts = [bal.points[i].copy() for i in range(bal.num_points)]
    problem = ctt.Problem()
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(SnavelyReprojectionError(ox, oy), 2,
                                     [9, 3]),
            ctt.HuberLoss(2.0) if i % 2 == 0 else None,
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return problem, cams, pts


class CameraPrior:
    """A prior pulling a camera toward zero: residual w * camera [9]."""

    def __init__(self, w):
        self.w = w

    def __call__(self, camera):
        return self.w * camera


def schur_kinds_problem(bal):
    """torch_parity_kit.schur_problem(ctt, bal, heavy_point=False) in
    the port alone: bal's blocks, a HuberLoss(1.0) bucket observing every
    fourth (camera, point) pair again, priors on cameras 0-4 (an f-only
    bucket) and camera 5 constant (an e-only bucket)."""
    problem, cams, pts = build_bal_ceres_problem(bal)
    for i in range(0, bal.num_observations, 4):
        ox, oy = bal.observations[i]
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(SnavelyReprojectionError(ox, oy), 2,
                                     [9, 3]),
            ctt.HuberLoss(1.0), cams[bal.camera_index[i]],
            pts[bal.point_index[i]])
    for c in cams[:5]:
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(CameraPrior(0.1), 9, [9]), None, c)
    problem.set_parameter_block_constant(cams[5])
    return problem, cams, pts


def build(kind, bal):
    """(problem, arrays) of a named test problem."""
    if kind == "bal":
        problem, cams, pts = build_bal_ceres_problem(bal)
    elif kind == "two_bucket":
        problem, cams, pts = two_bucket_problem(bal)
    elif kind == "schur":
        problem, cams, pts = schur_kinds_problem(bal)
    else:
        raise ValueError(kind)
    return problem, cams + pts


def assert_equal_tree(got, want, where):
    """Nested dicts, sequences and arrays equal, strings equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got), set(want))
        for k in want:
            assert_equal_tree(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_tree(g, w, f"{where}[{i}]")
    elif isinstance(want, str):
        assert got == want, where
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=where)


def digest(x):
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(x, np.float64)).tobytes()).hexdigest()


def solve_cases(cases, bals):
    """Solve each case on this rank: (name, problem kind, bal key,
    options kwargs, force_implicit), twice when asked. Returns per case
    the summary's numbers, the state (numpy) and its sha256, and the
    group's collective counts of the first solve; rank 0 adds the final
    cost of the port's single-device solve of the same options
    ("single_cost", fused_iterations on, the options' route)."""
    from ceres_tpu_torch.parallel.group import as_group
    from ceres_tpu_torch.parallel.solve_sharded import _fill
    from ceres_tpu_torch.parallel.sharded_fused import \
        make_sharded_fused_solve
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    world = torch.distributed.get_world_size()
    group = as_group(world)
    out = {}
    for name, kind, key, kw, force_implicit, repeat in cases:
        runs = []
        for _ in range(2 if repeat else 1):
            problem, arrays = build(kind, bals[key])
            options = ctt.SolverOptions(mesh=world, device="cpu", **kw)
            group.reset_counts()
            if force_implicit:
                program = CompiledProgram.get_cached(problem, options)
                meta = detect_schur_structure(program, options)
                run, step = make_sharded_fused_solve(
                    program, options, meta, world, force_implicit=True)
                result = run(program.initial_state())
                summary = ctt.SolverSummary()
                _fill(summary, result)
                summary.message += f" Schur step: {step.mode}."
                x = result.x.numpy()
            else:
                summary = ctt.solve(options, problem)
                x = np.concatenate([np.asarray(a) for a in arrays])
            runs.append(dict(
                message=summary.message,
                termination=str(summary.termination_type),
                iterations=summary.num_successful_steps
                + summary.num_unsuccessful_steps,
                linearizations=getattr(summary, "num_linearizations_fused",
                                       None),
                lin_iters=summary.num_linear_solver_iterations,
                initial_cost=summary.initial_cost,
                final_cost=summary.final_cost, x=x, sha=digest(x),
                calls=dict(group.calls), bytes=dict(group.bytes)))
        if torch.distributed.get_rank() == 0:
            runs[0]["single_cost"] = ctt.solve(ctt.SolverOptions(
                device="cpu", fused_iterations=True, **kw),
                build(kind, bals[key])[0]).final_cost
        out[name] = runs
    return out


def routing_checks(bal):
    """SolverOptions.mesh's routes on this rank: a problem with bounds
    (the host loop on each rank), a mesh int that is not the world size
    (raises), solve_batched with a mesh (each element solved sharded,
    not in batch mode), and a ProcessGroup as the mesh."""
    world = torch.distributed.get_world_size()
    base = dict(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                max_num_iterations=30, function_tolerance=1e-9,
                device="cpu")
    problem, cams, pts = build_bal_ceres_problem(bal)
    p0 = pts[0]
    problem.set_parameter_lower_bound(p0, 0, float(p0[0]) - 100.0)
    problem.set_parameter_upper_bound(p0, 0, float(p0[0]) + 100.0)
    s = ctt.solve(ctt.SolverOptions(mesh=world, **base), problem)
    out = {"bounds": (s.message, str(s.termination_type))}
    try:
        ctt.solve(ctt.SolverOptions(mesh=world + 1, **base),
                  build_bal_ceres_problem(bal)[0])
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    summaries = ctt.solve_batched(
        ctt.SolverOptions(mesh=world, use_mixed_precision_solves=True,
                          fused_iterations=True, batch_mode="batch",
                          **base),
        [build_bal_ceres_problem(bal)[0] for _ in range(2)])
    out["batched"] = [(s.message, s.final_cost) for s in summaries]
    pg = torch.distributed.new_group(list(range(world)))
    s = ctt.solve(ctt.SolverOptions(mesh=pg,
                                    use_mixed_precision_solves=True,
                                    fused_iterations=True, **base),
                  build_bal_ceres_problem(bal)[0])
    out["group"] = (s.message, s.final_cost)
    return out


def fused_rank(cases, bals, routing_key=None):
    """solve_cases, and routing_checks on bals[routing_key] if given."""
    out = {"cases": solve_cases(cases, bals)}
    if routing_key is not None:
        out["routing"] = routing_checks(bals[routing_key])
    return out


def se2_problem(graph):
    """io/g2o.py's synthetic SE2 graph of these keyword arguments, as
    examples/slam.py builds it."""
    from ceres_tpu_torch.examples.slam import build_pose_graph_2d_problem
    from ceres_tpu_torch.io.g2o import synthetic_pose_graph_2d
    poses, constraints, _ = synthetic_pose_graph_2d(**graph)
    return build_pose_graph_2d_problem(poses, constraints)[0]


def cgnr_rank(graph, graph_kw, bal, step_kw, radius, dry_shape=None):
    """On this rank: the SE2 graph through ctt.solve with a mesh and CGNR
    (the sharded CGNR host loop); one make_sharded_lm_step and one
    make_sharded_schur_step step at x0 on bal's problem; and the dry run
    at dry_shape if given."""
    from ceres_tpu_torch.parallel.dryrun import dryrun_rank
    from ceres_tpu_torch.parallel.sharded import (make_sharded_lm_step,
                                                  make_sharded_schur_step)
    from ceres_tpu_torch.program import CompiledProgram
    world = torch.distributed.get_world_size()
    s = ctt.solve(ctt.SolverOptions(
        mesh=world, device="cpu",
        linear_solver_type=ctt.LinearSolverType.CGNR, **graph_kw),
        se2_problem(graph))
    out = {"graph": dict(message=s.message, final_cost=s.final_cost,
                         initial_cost=s.initial_cost,
                         successful=s.num_successful_steps,
                         unsuccessful=s.num_unsuccessful_steps,
                         termination=str(s.termination_type))}
    problem, _ = build("bal", bal)
    for kind, make in (("CGNR", make_sharded_lm_step),
                       ("DENSE_SCHUR", make_sharded_schur_step)):
        opt = ctt.SolverOptions(device="cpu", linear_solver_type=getattr(
            ctt.LinearSolverType, kind), **step_kw)
        prog = CompiledProgram.get_cached(problem, opt)
        step, _ = make(prog, opt, world)
        o = step(prog.initial_state(), radius)
        out[kind] = {k: (v.numpy() if torch.is_tensor(v) else v)
                     for k, v in o.items()}
    if dry_shape is not None:
        out["dryrun"] = dryrun_rank("cpu", dry_shape)
    return out


def kernel_shard_rank(bal, limit):
    """On this rank of a group on the card: mixed DENSE_SCHUR's sharded
    explicit step at x0, its K1, K2 and K4 outputs on the rank's shard
    held to their plain versions (max |difference| / max |plain|), then
    the sharded solve. Returns the errors, the solve's numbers and the
    state's sha256."""
    from ceres_tpu_torch.ops.cost import snavely_sq, snavely_sq_plain
    from ceres_tpu_torch.ops.lin import elim, elim_plain, lin, lin_plain
    from ceres_tpu_torch.parallel.sharded_fused import sharded_step
    from ceres_tpu_torch.parallel.group import as_group
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    world = torch.distributed.get_world_size()
    options = ctt.SolverOptions(
        mesh=world, linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True, fused_iterations=True,
        max_num_iterations=50, function_tolerance=1e-9, device="cuda")
    problem, arrays = build("bal", bal)
    program = CompiledProgram.get_cached(problem, options)
    meta = detect_schur_structure(program, options)
    step = sharded_step(program, options, meta, as_group(world))
    x = program.initial_state()
    xe = step.point_state(x).float()
    xf = x[step.f_slab:step.f_slab + step.nf].float()
    se0, _ = step.initial_scales()

    def err(got, want):
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max())

    got = lin(xf, xe, step.cam, step.mask, step.dat, se0, True,
              plan=step.plan)
    want = lin_plain(xf, xe, step.cam, step.mask, step.dat[..., 0],
                     step.dat[..., 1], se0, True)
    errors = {f"K1 {k}": err(got[k], want[k]) for k in want}
    art = step.linearize(x, *step.initial_scales(), first=True)
    args = (art.A, art.etes, art.gse, art.diag_e, 1e4)
    for name, g, w in zip(("S_corr", "rhs", "inv", "z"), elim(*args),
                          elim_plain(*args)):
        errors[f"K2 {name}"] = err(g, w)
    errors["K4"] = err(snavely_sq(x, step.k4), snavely_sq_plain(x, step.k4))
    s = ctt.solve(options, problem)
    xs = np.concatenate([np.asarray(a) for a in arrays])
    return dict(errors=errors, limit=limit, message=s.message,
                final_cost=s.final_cost, sha=digest(xs),
                termination=str(s.termination_type))
