"""The last example families of the port against the JAX package's, on
inputs the tests write: examples/denoising.py (a 24 x 24 image and a
2 x 2 FoE file), examples/libmv_bundle_adjuster.py (a generated 20-camera,
40-track file) and examples/nist_runner.py (one written StRD file)."""

import numpy as np
import pytest

import torch_parity_kit  # noqa: F401  (one thread)
import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu_torch.io.pgm import read_pgm, write_pgm

DENOISE_SIZE = 24


def _denoise_files(tmp):
    """A smooth pattern with seeded noise as PGM, and a 2 x 2 FoE file of
    three zero-mean filters."""
    from ceres_tpu_torch.examples.denoising import write_foe
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:DENOISE_SIZE, 0:DENOISE_SIZE] / DENOISE_SIZE
    img = np.clip(128 + 50 * np.sin(5 * xx) * np.cos(3 * yy)
                  + 20.0 * rng.standard_normal(xx.shape), 0, 255)
    pgm = str(tmp / "noisy.pgm")
    write_pgm(pgm, img)
    fs = rng.standard_normal((3, 4))
    fs -= fs.mean(axis=1, keepdims=True)
    foe = str(tmp / "2x2.foe")
    write_foe(foe, 2, [0.8, 1.2, 1.6], fs)
    return pgm, foe


def _denoise_options(mod, **kw):
    """tests/test_denoising.py's options."""
    return mod.SolverOptions(
        linear_solver_type=mod.LinearSolverType.CGNR,
        preconditioner_type=mod.PreconditionerType.JACOBI,
        max_num_iterations=20, max_linear_solver_iterations=50, **kw)


@pytest.fixture(scope="module")
def denoise_ref(tmp_path_factory):
    from ceres_tpu.examples import denoising as jd
    from ceres_tpu.io.pgm import read_pgm as jax_read_pgm
    tmp = tmp_path_factory.mktemp("denoise")
    pgm, foe = _denoise_files(tmp)
    problem, pixels = jd.build_denoising_problem(
        jax_read_pgm(pgm), jd.FieldsOfExperts(foe))
    s = ct.solve(_denoise_options(ct), problem)
    return pgm, foe, s, jd.pixels_to_image(pixels)


def test_foe_file_round_trip(denoise_ref):
    from ceres_tpu.examples.denoising import FieldsOfExperts as JaxFoE
    from ceres_tpu_torch.examples.denoising import FieldsOfExperts
    _, foe, _, _ = denoise_ref
    a, b = FieldsOfExperts(foe), JaxFoE(foe)
    assert (a.size, a.num_filters, a.x, a.y, a.alpha) == \
        (b.size, b.num_filters, b.x, b.y, b.alpha) == \
        (2, 3, [0, 1, 0, 1], [0, 0, 1, 1], [0.8, 1.2, 1.6])
    for fa, fb in zip(a.filters, b.filters):
        np.testing.assert_array_equal(fa, fb)


def test_denoising_matches_jax(denoise_ref):
    """f64 CGNR + JACOBI on the 24 x 24 image: the JAX package's count
    and final cost within 1e-9, the image within 1e-6 grey levels, the
    total variation lower than the input's."""
    from ceres_tpu_torch.examples import denoising
    pgm, foe, s_jax, img_jax = denoise_ref
    img = read_pgm(pgm)
    problem, pixels = denoising.build_denoising_problem(
        img, denoising.FieldsOfExperts(foe))
    s = ctt.solve(_denoise_options(ctt, device="cpu"), problem)
    out = denoising.pixels_to_image(pixels)
    assert s.is_solution_usable()
    assert s.num_iterations == s_jax.num_iterations
    np.testing.assert_allclose(s.final_cost, s_jax.final_cost, rtol=1e-9)
    np.testing.assert_allclose(out, img_jax, rtol=0, atol=1e-6)
    assert denoising.total_variation(out) < denoising.total_variation(img)
    assert s.final_cost < s.initial_cost


def test_denoising_mixed_fused_near_f64(denoise_ref):
    """Mixed and fused (the K8 / K9 path on the card; their plain versions
    here): within 1e-5 of the f64 solve."""
    from ceres_tpu_torch.examples import denoising
    pgm, foe, s_jax, _ = denoise_ref
    problem, _ = denoising.build_denoising_problem(
        read_pgm(pgm), denoising.FieldsOfExperts(foe))
    s = ctt.solve(_denoise_options(ctt, device="cpu",
                                   use_mixed_precision_solves=True,
                                   fused_iterations=True), problem)
    assert s.is_solution_usable()
    np.testing.assert_allclose(s.final_cost, s_jax.final_cost, rtol=1e-5)


@pytest.fixture(scope="module")
def libmv_file(tmp_path_factory):
    from ceres_tpu_torch.examples.libmv_bundle_adjuster import \
        synthetic_libmv_problem
    from ceres_tpu_torch.io.libmv import write_libmv_test_problem
    path = str(tmp_path_factory.mktemp("libmv") / "problem.bin")
    write_libmv_test_problem(path, synthetic_libmv_problem(
        num_cameras=20, num_tracks=40, num_markers=500, seed=1))
    return path


@pytest.fixture(scope="module")
def libmv_ref(libmv_file):
    from ceres_tpu.examples import libmv_bundle_adjuster as jl
    out = {}
    for flags in (0, 15):
        s, intr, _, _ = jl.solve_libmv(libmv_file, flags)
        out[flags] = (s.num_iterations, s.final_cost, intr.copy())
    return out


@pytest.mark.parametrize("flags", [0, 15], ids=["defaults",
                                                "refine_intrinsics"])
def test_libmv_bundle_adjuster_matches_jax(flags, libmv_file, libmv_ref):
    """solve_libmv's defaults (ITERATIVE_SCHUR, SCHUR_JACOBI, inner
    iterations, f64), with no intrinsics refined and with focal length,
    principal point, k1 and k2 (BUNDLE_* 15, the SubsetManifold): the JAX
    run's count and final cost within 1e-9."""
    from ceres_tpu_torch.examples import libmv_bundle_adjuster as lba
    s, intr, cams, pts = lba.solve_libmv(libmv_file, flags, device="cpu")
    it, cost, intr_jax = libmv_ref[flags]
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    assert s.num_inner_iteration_steps > 0
    assert s.num_iterations == it
    np.testing.assert_allclose(s.final_cost, cost, rtol=1e-9)
    np.testing.assert_allclose(intr, intr_jax, rtol=1e-7)
    if flags == 0:
        from ceres_tpu_torch.io.libmv import read_libmv_problem
        np.testing.assert_array_equal(
            intr, read_libmv_problem(libmv_file).intrinsics)


def test_libmv_flags_pin_intrinsics():
    from ceres_tpu.examples import libmv_bundle_adjuster as jl
    from ceres_tpu_torch.examples import libmv_bundle_adjuster as lba
    from ceres_tpu_torch.io import libmv
    lp = lba.synthetic_libmv_problem(num_cameras=3, num_tracks=4,
                                     num_markers=10, seed=2)
    for flags in (1, 2, 4, 8, 15, 16, 32, 63):
        assert lba.intrinsics_manifold_constants(flags) == sorted(
            set(range(8)) - {k for k, bit in enumerate(
                (1, 2, 2, 4, 8, 0, 16, 32)) if flags & bit})
        problem, intr, _, _ = lba.build_libmv_problem(lp, flags)
        jp, _, _, _ = jl.build_libmv_problem(lp, flags)
        assert problem.num_residual_blocks() == jp.num_residual_blocks()
    assert libmv.BUNDLE_RADIAL == 12 and libmv.BUNDLE_TANGENTIAL == 48


def test_opencv_reprojection_error_matches_jax():
    import jax.numpy as jnp
    import torch
    from ceres_tpu.examples.libmv_bundle_adjuster import \
        OpenCVReprojectionError as JaxError
    from ceres_tpu_torch.examples.libmv_bundle_adjuster import \
        OpenCVReprojectionError
    rng = np.random.default_rng(3)
    intr = np.array([900.0, 320.0, 240.0, -0.1, 0.02, 0.001, 1e-3, -2e-3])
    for _ in range(4):
        rt = np.concatenate([0.1 * rng.standard_normal(3),
                             rng.standard_normal(3)])
        X = np.array([*rng.standard_normal(2), 6.0])
        got = OpenCVReprojectionError(10.0, 20.0)(
            torch.as_tensor(intr), torch.as_tensor(rt), torch.as_tensor(X))
        want = JaxError(10.0, 20.0)(jnp.asarray(intr), jnp.asarray(rt),
                                    jnp.asarray(X))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-13, atol=1e-9)


def test_nist_runner_on_a_written_file(tmp_path):
    """run_suite on a Misra1a-model file written in the StRD format, its
    certified values a tight JAX solve's: both starts reach the JAX run's
    LRE within 0.1 and its cost within 1e-9."""
    from ceres_tpu.examples import nist_runner as jr
    from ceres_tpu.io import nist as jn
    from ceres_tpu_torch.examples import nist_runner
    from ceres_tpu_torch.io.nist import write_nist_test_file
    true = (238.94212918, 5.5015643181e-4)       # chip_smoke.py's data
    x = np.linspace(77.6, 790.0, 14)
    y = true[0] * (1 - np.exp(-true[1] * x)) \
        + 0.1 * np.random.default_rng(1).standard_normal(14)
    write_nist_test_file(str(tmp_path / "Misra1a.dat"), "Misra1a", x, y,
                         (true, true), true, 1.0)
    nprob = jn.parse_nist_file(str(tmp_path / "Misra1a.dat"))
    problem, b = jn.build_nist_problem(nprob, 0)
    s = ct.solve(ct.SolverOptions(max_num_iterations=10000,
                                  function_tolerance=1e-18,
                                  gradient_tolerance=1e-18,
                                  parameter_tolerance=1e-18), problem)
    write_nist_test_file(str(tmp_path / "Misra1a.dat"), "Misra1a", x, y,
                         ((500.0, 1e-4), (250.0, 5e-4)), np.asarray(b),
                         2 * s.final_cost)
    jax_res, jax_avg = jr.run_suite(str(tmp_path), verbose=False)
    res, avg, sums = nist_runner.run_suite(str(tmp_path), verbose=False,
                                           device="cpu")
    assert list(res) == ["Misra1a"]
    np.testing.assert_allclose(res["Misra1a"], jax_res["Misra1a"],
                               atol=0.1)
    assert min(res["Misra1a"]) >= 9.0
    for s_ in sums["Misra1a"]:
        assert s_.termination_type == ctt.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s_.final_cost, s.final_cost, rtol=1e-9)
    assert abs(avg - jax_avg) <= 0.1
