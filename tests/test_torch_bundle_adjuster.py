"""ceres_tpu_torch's bundle_adjuster example (examples/bundle_adjuster.py)
against ceres_tpu's on the CPU.

The example's main on small synthetic flags (6 cameras, 80 points, 400
observations, perturbed) under its defaults (SPARSE_SCHUR + JACOBI, f64,
5 iterations) and with quaternion cameras on the product manifold,
against the JAX example's main on its generic Schur route
(CERES_TPU_NO_FUSED_SCHUR: below the dense cap the JAX package serves
f64 SPARSE_SCHUR with its fused f64 step, which the port does not have;
ROADMAP.md section 3), the same LM count and final cost within 1e-9;
and mixed, where both packages take their fused step, within 1e-5. The
PLY files it writes. Each flag the port does not run raises
NotImplementedError naming its ROADMAP.md item; --line_search runs and
matches the JAX example.
"""

import pytest

from torch_parity_kit import jax_generic_schur

from ceres_tpu.examples import bundle_adjuster as jax_example
from ceres_tpu_torch.examples import bundle_adjuster as example

SMALL = ["--synthetic_cameras", "6", "--synthetic_points", "80",
         "--synthetic_observations", "400", "--random_seed", "3",
         "--rotation_sigma", "0.02", "--translation_sigma", "0.1",
         "--point_sigma", "0.05"]


@pytest.mark.parametrize("flags", [[], ["--use_quaternions",
                                        "--use_manifolds"],
                                   ["--mixed_precision_solves"]],
                         ids=["defaults", "quaternion_manifold", "mixed"])
def test_main_matches_jax(flags, tmp_path):
    ply = [str(tmp_path / "initial.ply"), str(tmp_path / "final.ply")]
    mixed = "--mixed_precision_solves" in flags
    if mixed:
        s_j = jax_example.main(SMALL + flags)
    else:
        with jax_generic_schur():
            s_j = jax_example.main(SMALL + flags)
    s_t = example.main(SMALL + flags + ["--device", "cpu", "--initial_ply",
                                        ply[0], "--final_ply", ply[1]])
    assert ("Schur step: explicit reduced camera matrix, linearize K1"
            if mixed else "Schur step: generic SPARSE_SCHUR, dense S"
            ) in s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_successful_steps == s_j.num_successful_steps
    if mixed:
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-5 * s_j.final_cost
    else:
        assert s_t.num_iterations == s_j.num_iterations
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-9 * s_j.final_cost
    for path in ply:
        lines = open(path).read().splitlines()
        assert lines[0] == "ply" and "element vertex 86" in lines
        assert len(lines) == lines.index("end_header") + 1 + 86
    # the final PLY holds the solved cameras' translations, not the start's
    assert open(ply[0]).read() != open(ply[1]).read()


@pytest.mark.parametrize("flags,item", [
    (["--inner_iterations"], None),
    (["--line_search"], None),
    (["--num_devices", "2"], None),
    (["--linear_solver", "iterative_schur", "--preconditioner",
      "cluster_jacobi"], None),
    (["--linear_solver", "iterative_schur", "--preconditioner",
      "cluster_tridiagonal", "--visibility_clustering", "single_linkage"],
     None),
], ids=["inner_iterations", "line_search", "num_devices",
        "cluster_jacobi", "cluster_tridiagonal"])
def test_flags_outside_the_port_raise(flags, item):
    """Each case raised until the port ran it (the cases keep their
    ids): --num_devices 2 (item 30) spawns two gloo ranks, each running
    the single-device host loop (the example prints progress, a host-loop
    configuration, as the JAX example's mesh of two devices does), and
    keeps the JAX example's LM count, its cost within 1e-9; --line_search
    (item 25) runs the line-search
    minimizer (L-BFGS, Wolfe, f64, the host loop) and keeps the JAX
    example's iteration and probe counts, its cost within 1e-9;
    --inner_iterations (item 22) and ITERATIVE_SCHUR with
    --preconditioner cluster_jacobi / cluster_tridiagonal (items 36 and
    21; the latter with single-linkage clustering) keep the JAX example's
    LM count (and inner-iteration steps), its cost within 1e-9."""
    if item is None:
        s_j = jax_example.main(SMALL + flags)
        s_t = example.main(SMALL + flags + ["--device", "cpu"])
        assert str(s_t.termination_type) == str(s_j.termination_type)
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-9 * s_j.final_cost
        assert s_t.final_cost < s_t.initial_cost
        if "--line_search" not in flags:
            assert s_t.num_iterations == s_j.num_iterations
            assert s_t.num_inner_iteration_steps == \
                s_j.num_inner_iteration_steps
            assert ("--inner_iterations" in flags) == (
                s_t.num_inner_iteration_steps > 0)
            if "iterative_schur" in flags:
                assert "CLUSTER" in s_t.message
                assert s_t.num_linear_solver_iterations == \
                    s_j.num_linear_solver_iterations
            return
        assert str(s_t.minimizer_type) == "LINE_SEARCH"
        assert len(s_t.iterations) == len(s_j.iterations) == 6
        assert s_t.num_line_search_steps == s_j.num_line_search_steps
        return
    with pytest.raises(NotImplementedError, match=item):
        example.main(SMALL + flags + ["--device", "cpu"])
