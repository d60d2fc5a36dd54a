"""The sharded fused Schur solve (ceres_tpu_torch/parallel/sharded_fused.py)
against the JAX package's (ceres_tpu/parallel/sharded_fused.py) on the
virtual CPU mesh of the same width.

The port's ranks run on gloo, spawned once per world size
(parallel/launch.py start_ranks; the rank bodies are in
tests/torch_rank_kit.py) and solving while the JAX references are built
here; rank 0 also solves each case on one device. World 2 solves
test_fused_schur.py's small_bal (6 cameras, 300 points, 1,500
observations), world 4 its two-bucket Huber-and-plain problem, each in
five configurations (DENSE_SCHUR f64 and mixed, explicit ITERATIVE_SCHUR
f64, the implicit mode forced, f64 and mixed), and world 2 the mesh's
routes. f64 keeps the JAX sharded LM count and its final cost within
1e-9 relative, mixed within 1e-5 (JAX's own bound); both lie within 1e-6
(f64) or 1e-5 (mixed) of the port's single-device solve, and every rank
ends with the same bits of x.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_kit as rk
from torch_parity_kit import ct, ctt, schur_bal, schur_problem, small_bal

from ceres_tpu.examples.snavely import SnavelyReprojectionError as JaxSnav
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.parallel import sharded_fused as jsf
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.io.bal import BALProblem
from ceres_tpu_torch.parallel import sharded_fused as tsf
from ceres_tpu_torch.parallel.launch import run_ranks, start_ranks
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers.schur import \
    detect_schur_structure as torch_detect

# name -> (linear solver, mixed, implicit forced)
CONFIGS = {"dense64": ("DENSE_SCHUR", False, False),
           "dense32": ("DENSE_SCHUR", True, False),
           "iter64": ("ITERATIVE_SCHUR", False, False),
           "implicit64": ("ITERATIVE_SCHUR", False, True),
           "implicit32": ("ITERATIVE_SCHUR", True, True)}
WORLDS = {2: "bal", 4: "two_bucket"}      # world size -> its problem
# world 2 also solves test_torch_schur_solve.py's problem of every bucket
# kind (e with f, e0, f-only) and duplicate rows across two buckets
EXTRA = {2: [("schur", "dense64"), ("schur", "implicit64")], 4: []}
REPEAT = {2: "dense32", 4: "implicit64"}  # the case solved twice
# The JAX sharded implicit solve fails on an f-only bucket (it looks for
# the bucket's Jacobian where its store holds None, as its single-device
# fused implicit step does: ROADMAP.md section 3), so the port's implicit
# solve of that problem is held to the JAX sharded explicit
# ITERATIVE_SCHUR solve, the same damped systems and CG.
JAX_CONFIG = {"schur-implicit64": "iter64"}
# On that problem the port's single-device f64 ITERATIVE_SCHUR (the
# generic Schur step's CG) stops 3.7e-6 from the sharded explicit and
# implicit solves, as far as the JAX package's own sharded DENSE_SCHUR and
# ITERATIVE_SCHUR solves of it stop apart (5272.2731 and 5272.2925): CG
# truncated at eta 0.1 takes each route to its own point inside the
# function tolerance. That case is held to the single-device solve at
# 1e-5.
SINGLE_TOL = {"schur-implicit64": 1e-5}
BASE = dict(max_num_iterations=50, function_tolerance=1e-9)


def two_bucket_bal():
    """test_fused_schur.py's _two_bucket_bal_problem's BAL data."""
    bal = synthetic_bal_problem(num_cameras=4, num_points=100,
                                num_observations=400, seed=2,
                                pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=3)
    return bal


def jax_problem(kind, bal):
    if kind == "bal":
        return jax_build(bal)[0]
    if kind == "schur":
        return schur_problem(ct, bal, heavy_point=False)[0]
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pts = [bal.points[i].copy() for i in range(bal.num_points)]
    problem = ct.Problem()
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        problem.add_residual_block(
            ct.AutoDiffCostFunction(JaxSnav(ox, oy), 2, [9, 3]),
            ct.HuberLoss(2.0) if i % 2 == 0 else None,
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return problem


def port_bal(bal):
    return BALProblem(bal.cameras, bal.points, bal.camera_index,
                      bal.point_index, bal.observations)


def options_kw(mod, name):
    solver, mixed, _ = CONFIGS[name]
    return dict(BASE, linear_solver_type=mod.LinearSolverType[solver],
                preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
                use_mixed_precision_solves=mixed)


@pytest.fixture(scope="module")
def bals():
    return {"bal": small_bal(), "two_bucket": two_bucket_bal(),
            "schur": schur_bal()}


@pytest.fixture(scope="module")
def started(bals):
    """The port's sharded solves, one spawn a world size, started: they
    run in their ranks while the JAX references are built here. Rank 0
    also solves each case on one device."""
    pbals = {k: port_bal(v) for k, v in bals.items()}
    handles = {}
    try:
        for world, kind in WORLDS.items():
            cases = [(name, kind, kind, options_kw(ctt, name),
                      CONFIGS[name][2], name == REPEAT[world])
                     for name in CONFIGS]
            cases += [(f"{k}-{name}", k, k, options_kw(ctt, name),
                       CONFIGS[name][2], False) for k, name in EXTRA[world]]
            handles[world] = start_ranks(
                rk.fused_rank, world, "gloo", "cpu", 300.0,
                args=(cases, pbals, "bal" if world == 2 else None))
        yield handles
    finally:
        for h in handles.values():
            h.kill()


@pytest.fixture(scope="module")
def jax_refs(started, bals):
    """The JAX package's sharded solves, on a mesh of each world size."""
    out = {}
    for world, kind, name, key in CASES:
        mesh = Mesh(np.array(jax.devices()[:world]), axis_names=("data",))
        name = JAX_CONFIG.get(key, name)
        if CONFIGS[name][2]:
            os.environ["CERES_TPU_FORCE_IMPLICIT"] = "1"
        try:
            s = ct.solve(ct.SolverOptions(mesh=mesh, **options_kw(ct, name)),
                         jax_problem(kind, bals[kind]))
        finally:
            os.environ.pop("CERES_TPU_FORCE_IMPLICIT", None)
        assert "sharded fused" in s.message, s.message
        out[world, key] = s
    return out


@pytest.fixture(scope="module")
def ranks(started, jax_refs):
    """The ranks' results (each rank's cases and, on world 2, its
    routing checks), once the JAX references are built."""
    return {world: h.join() for world, h in started.items()}


@pytest.mark.parametrize("world,cam_chunks", [(2, False), (2, True),
                                              (4, False), (4, True)])
def test_chunk_shards_equal_jax(bals, world, cam_chunks):
    """build_chunk_shards' arrays (data, ambient indices, masks, f ids
    and the implicit mode's per-shard camera chunks) equal the JAX
    function's, and so does ne_pad."""
    kind = WORLDS[world]
    jprog = JaxProgram(jax_problem(kind, bals[kind]))
    jopt = ct.SolverOptions(linear_solver_type=ct.LinearSolverType
                            .DENSE_SCHUR)
    want, want_pad = jsf.build_chunk_shards(
        jprog, jax_detect(jprog, jopt), world, cam_chunks=cam_chunks)
    topt = ctt.SolverOptions(device="cpu",
                             linear_solver_type=ctt.LinearSolverType
                             .DENSE_SCHUR)
    tprog = TorchProgram(rk.build(kind, port_bal(bals[kind]))[0], "cpu")
    got, got_pad = tsf.build_chunk_shards(
        tprog, torch_detect(tprog, topt), world, cam_chunks=cam_chunks)
    assert got_pad == want_pad
    assert all("loss_attrs" not in e for e in want)
    rk.assert_equal_tree(got, want, "shards")


@pytest.mark.parametrize("solver,cg", [("DENSE_SCHUR", 0),
                                       ("ITERATIVE_SCHUR", 17)])
def test_collective_footprint_equals_jax(bals, solver, cg):
    jprog = JaxProgram(jax_problem("bal", bals["bal"]))
    jopt = ct.SolverOptions(linear_solver_type=ct.LinearSolverType[solver])
    topt = ctt.SolverOptions(device="cpu", linear_solver_type=ctt
                             .LinearSolverType[solver])
    tprog = TorchProgram(rk.build("bal", port_bal(bals["bal"]))[0], "cpu")
    for nbytes in (4, 8):
        assert tsf.collective_footprint(
            torch_detect(tprog, topt), topt, 4, cg, nbytes) == \
            jsf.collective_footprint(jax_detect(jprog, jopt), jopt, 4, cg,
                                     nbytes)


# (world, problem, configuration, case name)
CASES = ([(w, k, n, n) for w, k in WORLDS.items() for n in CONFIGS]
         + [(w, k, n, f"{k}-{n}") for w in EXTRA for k, n in EXTRA[w]])


@pytest.mark.parametrize("world,kind,name,key", CASES,
                         ids=[f"{c[3]}-w{c[0]}" for c in CASES])
def test_sharded_solve_matches_jax(ranks, jax_refs, world, kind, name,
                                   key):
    runs = [r["cases"][key][0] for r in ranks[world]]
    got, want = runs[0], jax_refs[world, key]
    mixed = CONFIGS[name][1]
    assert "sharded fused" in got["message"], got["message"]
    assert got["termination"] == "CONVERGENCE", got["message"]
    assert len({r["sha"] for r in runs}) == 1, "the ranks' x differ"
    rel_jax = abs(got["final_cost"] - want.final_cost) / want.final_cost
    single = got["single_cost"]
    rel_one = abs(got["final_cost"] - single) / single
    if mixed:
        assert rel_jax < 1e-5, rel_jax
        assert rel_one < 1e-5, rel_one
    else:
        assert got["iterations"] == (want.num_successful_steps
                                     + want.num_unsuccessful_steps)
        assert rel_jax < 1e-9, rel_jax
        assert rel_one < SINGLE_TOL.get(key, 1e-6), rel_one
    # the kernel routes where the single-device fused step takes them
    if mixed and kind == "bal":
        assert ("K10" if CONFIGS[name][2] else "K1") in got["message"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_solve_repeats_its_bits(ranks, world):
    for r in ranks[world]:
        first, second = r["cases"][REPEAT[world]]
        assert first["sha"] == second["sha"]
        assert first["iterations"] == second["iterations"]


@pytest.mark.parametrize("name", ["dense64", "dense32"])
def test_explicit_collectives_follow_the_footprint(bals, ranks, name):
    """The explicit mode's collectives over a whole solve, held to
    collective_footprint's per-iteration list with each departure named:
      - the loop relinearizes only after an accepted step, so psum #1
        and the max run once a linearization, the rest once an iteration;
      - x0's cost is one more sum;
      - the max of |g_e| is a call of its own (the footprint folds it
        into psum #1's two e-gradient values);
      - psum #1 carries no cost (the loop carries the candidate's summed
        cost) and one e-gradient value, |g_e|^2;
      - the norms carry two values (d.g and |D d|^2 or |J d|^2): the step
        norm comes from the gathered step;
      - every cost is f64 (8 bytes) whatever the solve's dtype;
      - the e-part is gathered in f64 as [ne_pad, te], ne_pad / 2 rows a
        rank (Group counts the bytes a rank sends)."""
    run = ranks[2][0]["cases"][name][0]
    its, lins = run["iterations"], run["linearizations"]
    nb = 4 if CONFIGS[name][1] else 8
    topt = ctt.SolverOptions(device="cpu", **options_kw(ctt, name))
    tprog = TorchProgram(rk.build("bal", port_bal(bals["bal"]))[0], "cpu")
    meta = torch_detect(tprog, topt)
    fp = tsf.collective_footprint(meta, topt, 2, 0, nb)
    kf, tf = meta.f_groups[0]["kf"], meta.f_groups[0]["t"]
    nf = kf * tf
    psum1 = fp["psum_bytes"] - (nf * nf + nf) * nb - 3 * nb - nb
    assert psum1 == (1 + kf * tf * tf + kf * tf + 2) * nb
    psum1 -= 2 * nb                       # no cost, one e-gradient value
    ne_pad = -(-meta.ne // 2) * 2
    assert run["calls"] == {"sum": 1 + lins + 3 * its, "max": lins,
                            "gather": its}
    assert run["bytes"] == {
        "sum": 8 + lins * psum1 + its * ((nf * nf + nf) * nb + 2 * nb + 8),
        "max": lins * nb, "gather": its * (ne_pad // 2) * meta.te * 8}
    assert fp["psum_count"] == 4 and fp["allgather_count"] == 1


def test_mesh_with_bounds_runs_the_host_loop(ranks):
    """options.mesh with bounds runs the single-device host loop on each
    rank (test_fused_schur.py's test_mesh_with_bounds_falls_back_to_host
    _loop), and the message says so."""
    message, term = ranks[2][0]["routing"]["bounds"]
    assert term == "CONVERGENCE"
    assert "sharded fused" not in message
    assert "single-device route (a host-loop configuration)" in message


def test_mesh_takes_a_process_group(ranks):
    """A torch.distributed ProcessGroup as the mesh runs the sharded
    path, to the int mesh's cost."""
    message, cost = ranks[2][0]["routing"]["group"]
    assert "sharded fused" in message and "2 ranks" in message
    assert cost == ranks[2][0]["routing"]["batched"][0][1]


def test_mesh_int_must_match_the_world_size(ranks):
    assert "world size 2" in ranks[2][0]["routing"]["mismatch"]
    problem = rk.build("bal", port_bal(small_bal()))[0]
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        ctt.solve(ctt.SolverOptions(mesh=2, device="cpu",
                                    linear_solver_type=ctt.LinearSolverType
                                    .DENSE_SCHUR), problem)


def test_solve_batched_with_a_mesh_solves_each_sharded(ranks):
    """solve_batched leaves a mesh out of the fused (batch) route: each
    element runs through solve, sharded."""
    batched = ranks[2][0]["routing"]["batched"]
    assert len(batched) == 2
    for message, _ in batched:
        assert "sharded fused" in message, message
    assert batched[0][1] == batched[1][1]


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the kernels K1, K2 and K4 run on the card")
def test_sharded_kernels_on_the_card(bals):
    """Two gloo ranks sharing the card: each rank's K1, K2 and K4 outputs
    on its shard within 1e-5 (K4: 1e-12) of their plain versions, and the
    sharded mixed DENSE_SCHUR solve within 1e-5 of the port's f64
    single-device solve on the CPU, the ranks' x the same bits."""
    pb = port_bal(bals["bal"])
    res = run_ranks(rk.kernel_shard_rank, 2, "gloo", "cuda", 600.0,
                    args=(pb, 1e-5))
    want = ctt.solve(ctt.SolverOptions(
        device="cpu", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=50, function_tolerance=1e-9),
        rk.build("bal", pb)[0])
    assert len({r["sha"] for r in res}) == 1
    for r in res:
        for name, e in r["errors"].items():
            assert e <= (1e-12 if name == "K4" else 1e-5), (name, e)
        assert "sharded fused" in r["message"] and "K1" in r["message"]
        assert abs(r["final_cost"] - want.final_cost) <= \
            1e-5 * want.final_cost
