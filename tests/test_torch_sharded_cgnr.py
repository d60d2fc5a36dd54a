"""The sharded CGNR step and host loop and the one-step functions
(ceres_tpu_torch/parallel/sharded.py, solve_sharded.py) against the JAX
package's (ceres_tpu/parallel/sharded.py, solve_sharded.py) on the
virtual CPU mesh of the same width, and the dry run
(parallel/dryrun.py).

The port's ranks run on gloo, spawned once per world size (2 and 4;
rank bodies in tests/torch_rank_kit.py), and solve while the JAX
references are built here. On a 100-pose SE2 graph,
ctt.solve with a mesh and CGNR runs the sharded CGNR host loop: the JAX
package's LM counts, its final cost within 1e-9 relative. One
make_sharded_lm_step (CGNR with block Jacobi) and one
make_sharded_schur_step step at x0 of a small BA problem: the step
within 1e-10 of JAX's. build_row_shards' arrays equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_rank_kit as rk
from torch_parity_kit import ct, ctt, rel

from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.parallel import sharded as jsh
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu_torch.io.bal import BALProblem
from ceres_tpu_torch.parallel import sharded as tsh
from ceres_tpu_torch.parallel.launch import start_ranks
from ceres_tpu_torch.program import CompiledProgram as TorchProgram

GRAPH = dict(num_poses=100, seed=6)
GRAPH_OPTIONS = dict(max_num_iterations=50, function_tolerance=1e-9,
                     max_linear_solver_iterations=200, eta=1e-3)
STEP_OPTIONS = dict(max_linear_solver_iterations=100)
RADIUS = 1e4
WORLDS = (2, 4)
DRY_SHAPE = dict(num_cameras=6, num_points=300, num_observations=1500)


def step_bal():
    """tests/test_sharded.py's problem: 3 cameras, 40 points, 120
    observations."""
    bal = synthetic_bal_problem(3, 40, 120, seed=5, pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.05,
                point_sigma=0.05, seed=6)
    return bal


def port_bal(bal):
    return BALProblem(bal.cameras, bal.points, bal.camera_index,
                      bal.point_index, bal.observations)


def jax_graph():
    poses, constraints, _ = jax_g2o.synthetic_pose_graph_2d(**GRAPH)
    return jax_slam.build_pose_graph_2d_problem(poses, constraints)[0]


def mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("data",))


@pytest.fixture(scope="module")
def started():
    """The port's ranks, one spawn a world size, started: they run while
    the JAX references are built here."""
    bal = port_bal(step_bal())
    handles = {}
    try:
        for w in WORLDS:
            handles[w] = start_ranks(
                rk.cgnr_rank, w, "gloo", "cpu", 300.0,
                args=(GRAPH, GRAPH_OPTIONS, bal, STEP_OPTIONS, RADIUS,
                      DRY_SHAPE if w == 2 else None))
        yield handles
    finally:
        for h in handles.values():
            h.kill()


@pytest.fixture(scope="module")
def jax_graph_refs(started):
    return {w: ct.solve(ct.SolverOptions(
        mesh=mesh(w), linear_solver_type=ct.LinearSolverType.CGNR,
        **GRAPH_OPTIONS), jax_graph()) for w in WORLDS}


@pytest.fixture(scope="module")
def ranks(started, jax_graph_refs, jax_steps):
    return {w: h.join() for w, h in started.items()}


@pytest.fixture(scope="module")
def jax_steps(started):
    out = {}
    problem = jax_build(step_bal())[0]
    prog = JaxProgram(problem)
    for w in WORLDS:
        for kind, make in (("CGNR", jsh.make_sharded_lm_step),
                           ("DENSE_SCHUR", jsh.make_sharded_schur_step)):
            opt = ct.SolverOptions(linear_solver_type=getattr(
                ct.LinearSolverType, kind), **STEP_OPTIONS)
            step, shards_np, place = make(prog, opt, mesh(w))
            o = step(prog.initial_state(), jnp.asarray(RADIUS, prog.dtype),
                     place(shards_np))
            out[w, kind] = {k: np.asarray(v) for k, v in o.items()}
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_row_shards_equal_jax(world):
    """build_row_shards' arrays equal the JAX function's on the SE2 graph
    (angle slots on a manifold) and on the BA problem."""
    jprogs = [JaxProgram(jax_graph()), JaxProgram(jax_build(step_bal())[0])]
    tprogs = [TorchProgram(rk.se2_problem(GRAPH), "cpu"),
              TorchProgram(rk.build("bal", port_bal(step_bal()))[0], "cpu")]
    for jp, tp in zip(jprogs, tprogs):
        want = jsh.build_row_shards(jp, world)
        assert all("loss_attrs" not in e for e in want)
        rk.assert_equal_tree(tsh.build_row_shards(tp, world), want,
                               "rows")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cgnr_host_loop_matches_jax(ranks, jax_graph_refs, world):
    want = jax_graph_refs[world]
    assert "sharded CGNR host loop" in want.message
    for r in ranks[world]:
        got = r["graph"]
        assert "sharded CGNR host loop" in got["message"], got["message"]
        assert got["termination"] == str(want.termination_type)
        assert got["successful"] == want.num_successful_steps
        assert got["unsuccessful"] == want.num_unsuccessful_steps
        assert abs(got["final_cost"] - want.final_cost) <= \
            1e-9 * want.final_cost
        assert got["final_cost"] < got["initial_cost"]


@pytest.mark.parametrize("world,kind", [(w, k) for w in WORLDS
                                        for k in ("CGNR", "DENSE_SCHUR")])
def test_one_sharded_step_matches_jax(ranks, jax_steps, world, kind):
    """make_sharded_lm_step (CGNR + block Jacobi) and
    make_sharded_schur_step: one step at x0, radius 1e4, within 1e-10 of
    the JAX step; every rank returns the same bits."""
    want = jax_steps[world, kind]
    got = ranks[world][0][kind]
    for r in ranks[world][1:]:
        np.testing.assert_array_equal(r[kind]["delta"], got["delta"])
    assert rel(got["delta"], want["delta"]) < 1e-10
    assert int(got["lin_iters"]) == int(want["lin_iters"])
    for key in ("cost", "model_cost_change", "gradient_norm"):
        assert abs(float(got[key]) - float(want[key])) <= \
            1e-10 * abs(float(want[key])), key


def test_dryrun_small_shape(ranks):
    """parallel/dryrun.py's four parts at small_bal's shape on 2 ranks:
    the sharded f64 DENSE_SCHUR solve within 1e-6 of rank 0's
    single-device solve, a decreasing CGNR step on the radius ladder, a
    decreasing sharded Schur step and a decreasing forced implicit
    solve."""
    res = [r["dryrun"] for r in ranks[2]]
    assert len({r["sha"] for r in res}) == 1
    r0 = res[0]
    assert r0["rel"] < 1e-6
    assert r0["cgnr"][1] < r0["cgnr"][0]
    assert r0["schur"][1] < r0["schur"][0]
    assert r0["implicit"][1] < r0["implicit"][0]
    assert "sharded fused" in r0["message"]
