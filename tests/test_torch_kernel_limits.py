"""The last kernel limits of ceres_tpu_torch on the card, lifted: K10 at
any (r, te, tf), and the fused step's gate, which no longer refuses a
shape of K10, a K1 loss or K5's count of loss scalars.

- csrc/implicit.cu's tiers on the host (tests/cuda_host_emu.py): each
  tier that holds a shape, at tier 0's bounds and past each of them
  ((2, 3, 18), FULL_OPENCV's; (6, 3, 9), (2, 6, 9), (6, 6, 24)), in
  warps (k <= 32) and a block a point (k = 33), with v staged and read
  from memory, and the general tier's scratch in shared and in device
  memory: bit for bit implicit_apply_plain (every product and sum
  rounds apart in the same order; the host compiles them without fused
  multiply-adds).
- The implicit step past those bounds against the JAX package's
  implicit step (its XLA operator, CERES_TPU_FORCE_IMPLICIT), on small
  problems: COLMAP's FULL_OPENCV camera (tf 18, chip_smoke.py
  opencv_functor), a functor of r 6 and one of te 6. One damped step from
  the JAX package's Jacobi scale: the cost, gradient and model cost change
  within 1e-5 and the step within 5e-4, with its CG count (the implicit
  step's tolerances: the f32 CG amplifies rounding by the damped system's
  conditioning); each problem's f64 solve with the JAX package's LM and
  CG counts and its final cost within 1e-10.
- `unsupported_reason` on device "cuda" for those shapes and for the
  losses of tests/test_torch_loss_rows.py: no KernelLimit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu
from torch_parity_kit import ct, ctt, main_path_options, rel

import chip_smoke as cs
from ceres_tpu import rotation as jax_rot
from ceres_tpu import solver as jax_solver
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu_torch import rotation as torch_rot
from ceres_tpu_torch.io import bal as tbal
from ceres_tpu_torch.ops import _cuda
from ceres_tpu_torch.ops import implicit as k10
from ceres_tpu_torch.ops.implicit import (GENERAL_TIER, TIERS,
                                          implicit_apply,
                                          implicit_apply_plain,
                                          implicit_tier)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers import schur_fused as tsf
from ceres_tpu_torch.solvers.schur import detect_schur_structure

RADIUS = 1e4


# ---- K10's tiers on the host ----

_K10_MAIN = r"""
  const int* h = emu_read<int>("hdr", 8);
  const int ne = h[0], k = h[1], r = h[2], te = h[3], tf = h[4], kf = h[5],
            tier = h[6], scratch_smem = h[7];
  const float* Je = emu_read<float>("Je", (size_t)ne * k * r * te);
  const float* Jf = emu_read<float>("Jf", (size_t)ne * k * r * tf);
  const float* inv = emu_read<float>("inv", (size_t)ne * te * te);
  const int* fids = emu_read<int>("fids", (size_t)ne * k);
  const float* v = emu_read<float>("v", (size_t)kf * tf);
  int plan[6];
  if (ceres_implicit_plan(ne, k, r, te, tf, kf, tier, scratch_smem, plan))
    return 3;
  float* scratch = plan[4] ? emu_alloc<float>((size_t)plan[4] * plan[5])
                           : nullptr;
  float* C = emu_alloc<float>((size_t)ne * k * tf);
  if (ceres_implicit_apply(Je, Jf, inv, fids, v, ne, k, r, te, tf, kf, tier,
                           scratch_smem, scratch, C, nullptr))
    return 4;
  emu_write("C", C, (size_t)ne * k * tf);
  emu_write("plan", plan, 6);
"""
_EMU = []


def _k10_inputs(ne, k, r, te, tf, kf, seed):
    """Seeded K10 inputs: masked lanes (zero Je and Jf rows, as the
    implicit step's chunk layout has them), an SPD-like inverse."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random((ne, k)) < 0.8).astype(f32)
    mask[:, 0] = 1.0
    Je = (rng.standard_normal((ne, k, r, te)) * mask[..., None, None]
          ).astype(f32)
    Jf = (rng.standard_normal((ne, k, r, tf)) * mask[..., None, None]
          ).astype(f32)
    a = rng.standard_normal((ne, te, te))
    inv = (np.einsum("nij,nkj->nik", a, a) / te
           + np.eye(te)[None]).astype(f32)
    fids = rng.integers(0, kf, (ne, k)).astype(np.int32)
    v = rng.standard_normal(kf * tf).astype(f32)
    return [torch.as_tensor(x) for x in (Je, Jf, inv, fids, v)]


def _tiers(r, te, tf):
    """(tier, scratch_smem) of every launch that holds (r, te, tf): the
    register tiers that hold it, and the general one with its scratch in
    shared memory (-1, the card's opt-in) and in device memory (0)."""
    return ([(t, -1) for t, m in TIERS.items()
             if all(x <= y for x, y in zip((r, te, tf), m))]
            + [(GENERAL_TIER, -1), (GENERAL_TIER, 0)])


def _emulated_k10(tmp_path_factory, args, tier, scratch_smem):
    if not _EMU:
        _EMU.append(emu.build(tmp_path_factory.mktemp("k10emu"),
                              (_cuda.CSRC / "implicit.cu").read_text(),
                              _K10_MAIN))
    Je, Jf, inv, fids, v = args
    ne, k, r, te = Je.shape
    tf = Jf.shape[-1]
    kf = v.numel() // tf
    out = emu.run(_EMU[0], tmp_path_factory.mktemp("k10run"), {
        "hdr": np.array([ne, k, r, te, tf, kf, tier, scratch_smem],
                        np.int32),
        "Je": Je.numpy(), "Jf": Jf.numpy(), "inv": inv.numpy(),
        "fids": fids.numpy(), "v": v.numpy()},
        {"C": (np.float32, ne * k * tf), "plan": (np.int32, 6)})
    return out["C"].reshape(ne, k, tf), out["plan"]


# (r, te, tf): tier 0's bounds, FULL_OPENCV's, and past each old bound
K10_SHAPES = [(4, 4, 16), (2, 3, 18), (6, 3, 9), (2, 6, 9), (6, 6, 24),
              (9, 2, 5)]


@pytest.mark.parametrize("shape", K10_SHAPES, ids=str)
def test_k10_tiers_on_the_host_match_plain(tmp_path_factory, shape):
    """Every tier that holds the shape, bit for bit the plain version: in
    warps (k 3, v staged; 70,000 floats of v: read from memory, past the
    emulated card's 256 KB of shared memory), a block a point (k 33), and
    the general tier's scratch in shared and in device memory. The
    wrapper picks the smallest tier that holds the shape."""
    r, te, tf = shape
    tiers = _tiers(r, te, tf)
    assert tiers[0][0] == implicit_tier(r, te, tf)
    assert (implicit_tier(r, te, tf) == 0) == (
        r <= 4 and te <= 4 and tf <= 16)
    for ne, k, kf in ((13, 3, 5), (3, 33, 7), (11, 2, 70000 // tf)):
        args = _k10_inputs(ne, k, r, te, tf, kf, seed=ne + k + r + te + tf)
        want = implicit_apply_plain(*args).numpy()
        for tier, scratch_smem in tiers:
            got, plan = _emulated_k10(tmp_path_factory, args, tier,
                                      scratch_smem)
            assert plan[0] == tier
            assert np.array_equal(got.view(np.int32),
                                  want.view(np.int32)), (tier, ne, k, kf)
            assert (plan[4] > 0) == (scratch_smem == 0)
            if scratch_smem == 0:
                assert plan[5] == min(ne, 1024)
            assert plan[2] == (kf * tf * 4 < 256 * 1024)   # v staged


def test_k10_tiers_are_nested():
    """Each tier holds the shapes of the one before it, and the general
    one any."""
    maxima = list(TIERS.values())
    for a, b in zip(maxima, maxima[1:]):
        assert all(x <= y for x, y in zip(a, b))
    assert implicit_tier(100, 50, 300) == GENERAL_TIER
    assert implicit_tier(2, 3, 9) == 0 and implicit_tier(2, 3, 18) == 1
    assert implicit_tier(6, 3, 9) == implicit_tier(2, 6, 9) == GENERAL_TIER
    args = _k10_inputs(2, 2, 2, 3, 18, 3, seed=0)
    implicit_apply.launches = 0
    assert implicit_apply(*args).shape == (2, 2, 18)
    assert implicit_apply.launches == 0          # plain on CPU tensors


# ---- the implicit step past tier 0's bounds against the JAX package ----

def _snavely_xy(rot, camera, X):
    """The Snavely projection (x, y) of X by an angle-axis camera."""
    p = rot.angle_axis_rotate_point(camera[:3], X) + camera[3:6]
    xp, yp = -p[0] / p[2], -p[1] / p[2]
    r2 = xp * xp + yp * yp
    dist = 1.0 + r2 * (camera[7] + camera[8] * r2)
    return camera[6] * dist * xp, camera[6] * dist * yp


def stacked_functor(T, rot):
    """r 6: a camera observing a point and two points offset from it by
    data, each projected. T and rot are closed over (the JAX package
    batches a functor's numeric attributes)."""
    class Stacked:
        def __init__(self, obs, d1, d2):
            self.obs, self.d1, self.d2 = obs, d1, d2

        def __call__(self, camera, point):
            out = []
            for X, i in ((point, 0), (point + self.d1, 2),
                         (point + self.d2, 4)):
                x, y = _snavely_xy(rot, camera, X)
                out += [x - self.obs[i], y - self.obs[i + 1]]
            return T.stack(out)
    return Stacked


def pair_functor(T, rot):
    """te 6: a block of two points [X, Y] seen by one camera (r 4)."""
    class Pair:
        def __init__(self, obs):
            self.obs = obs

        def __call__(self, camera, pair):
            out = []
            for X, i in ((pair[:3], 0), (pair[3:6], 2)):
                x, y = _snavely_xy(rot, camera, X)
                out += [x - self.obs[i], y - self.obs[i + 1]]
            return T.stack(out)
    return Pair


def _snavely_data():
    bal = tbal.synthetic_bal_problem(num_cameras=6, num_points=120,
                                     num_observations=480, seed=3,
                                     pixel_noise=0.5)
    rng = np.random.default_rng(4)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1, point_sigma=0.05,
                seed=5)
    return bal, rng


def shape_problem(name, mod):
    """(problem, the options' extra) of each shape, in package `mod`."""
    T, rot = (torch, torch_rot) if mod is ctt else (jnp, jax_rot)
    if name == "opencv":
        data = cs.opencv_data(tbal, dict(num_cameras=6, num_points=120,
                                         num_observations=480))
        return cs.opencv_problem(mod, T, rot, data)[0]
    bal, rng = _snavely_data()
    prob = mod.Problem()
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    if name == "r6":
        pts = [bal.points[i].copy() for i in range(bal.num_points)]
        F = stacked_functor(T, rot)
        offs = 0.2 * rng.standard_normal((bal.num_observations, 2, 3))
        for i in range(bal.num_observations):
            c, p = bal.camera_index[i], bal.point_index[i]
            obs = np.concatenate([bal.observations[i]] + [
                _project_np(bal.cameras[c], bal.points[p] + offs[i, j])
                + rng.normal(0, 0.5, 2) for j in range(2)])
            prob.add_residual_block(mod.AutoDiffCostFunction(
                F(obs, offs[i, 0], offs[i, 1]), 6, [9, 3]), None, cams[c],
                pts[p])
        return prob
    F = pair_functor(T, rot)
    partner = (np.arange(bal.num_points) + 1) % bal.num_points
    pairs = [np.concatenate([bal.points[i], bal.points[partner[i]]])
             for i in range(bal.num_points)]
    for i in range(bal.num_observations):
        c, p = bal.camera_index[i], bal.point_index[i]
        obs = np.concatenate([bal.observations[i], _project_np(
            bal.cameras[c], bal.points[partner[p]]) + rng.normal(0, 0.5, 2)])
        prob.add_residual_block(mod.AutoDiffCostFunction(F(obs), 4, [9, 6]),
                                None, cams[c], pairs[p])
    return prob


def _project_np(cam, X):
    """The Snavely projection of X by camera cam, numpy f64."""
    aa = cam[:3]
    th = np.linalg.norm(aa)
    w = aa / th if th > 0 else aa
    p = (X * np.cos(th) + np.cross(w, X) * np.sin(th)
         + w * np.dot(w, X) * (1.0 - np.cos(th))) + cam[3:6]
    xp, yp = -p[0] / p[2], -p[1] / p[2]
    r2 = xp * xp + yp * yp
    d = 1.0 + r2 * (cam[7] + cam[8] * r2)
    return np.array([cam[6] * d * xp, cam[6] * d * yp])


def implicit_options(mod, **extra):
    return main_path_options(
        mod, linear_solver_type=mod.LinearSolverType.ITERATIVE_SCHUR,
        **extra)


SHAPES = {"opencv": (2, 3, 18), "r6": (6, 3, 9), "te6": (4, 6, 9)}


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's forced-implicit damped step at its Jacobi scale,
    per shape, built once for the module."""
    os.environ["CERES_TPU_FORCE_IMPLICIT"] = "1"
    try:
        out = {}
        for name in SHAPES:
            opts = implicit_options(ct)
            jp = JaxProgram.get_cached(shape_problem(name, ct), opts)
            x0 = jp.initial_state()
            scale = np.asarray(jax_solver.make_scale_fn(jp, opts)(x0))
            ex = (jp.example_x(), jp.example_scalar(), jp.example_delta())
            a = jp.jit_with_consts(jax_solver.make_step_impl(jp, opts), ex)(
                x0, jnp.asarray(RADIUS, jp.dtype), jnp.asarray(scale))
            out[name] = (scale, {k: np.asarray(v) for k, v in a.items()})
        return out
    finally:
        del os.environ["CERES_TPU_FORCE_IMPLICIT"]


@pytest.mark.parametrize("name", list(SHAPES))
def test_implicit_step_past_the_old_bounds_matches_jax(jax_steps, name):
    """One forced-implicit damped step against the JAX package's, at the
    shapes past K10 tier 0's bounds (K10's plain version on the CPU)."""
    scale, a = jax_steps[name]
    opts = implicit_options(ctt)
    tp = TorchProgram.get_cached(shape_problem(name, ctt), opts)
    step = tsf.ImplicitSchurStep(tp, opts, detect_schur_structure(tp, opts))
    r, te, tf = SHAPES[name]
    assert step.k10 and (tp.buckets[0].r, step.te, step.tf) == (r, te, tf)
    sc = torch.tensor(scale, dtype=torch.float32)
    s_e = sc[:te * step.ne].view(step.ne, te)
    s_f = sc[te * step.ne:].view(step.kf, tf)
    art = step.linearize(tp.initial_state(), s_e, s_f, first=False)
    b = step.solve(art, RADIUS)
    assert int(b["lin_iters"]) == int(a["lin_iters"]) > 1
    for k in ["cost", "gradient_max_norm", "gradient_norm", "delta",
              "model_cost_change", "step_norm"]:
        tol = 5e-4 if k in ("delta", "step_norm") else 1e-5
        assert rel(b[k].numpy(), a[k]) < tol, k


@pytest.mark.parametrize("name", list(SHAPES))
def test_f64_solve_past_the_old_bounds_matches_jax(monkeypatch, name):
    """Each shape's problem in f64 (the generic Schur step's CG on both
    sides): the JAX package's counts, its final cost within 1e-10."""
    monkeypatch.setenv("CERES_TPU_NO_FUSED_SCHUR", "1")
    kw = dict(use_mixed_precision_solves=False, max_num_iterations=8)
    s_j = ct.solve(implicit_options(ct, **kw), shape_problem(name, ct))
    s_t = ctt.solve(implicit_options(ctt, **kw), shape_problem(name, ctt))
    assert "Schur step: generic" in s_t.message
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_linear_solver_iterations == \
        s_j.num_linear_solver_iterations
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-10 * s_j.final_cost


# ---- the gate ----

@pytest.mark.parametrize("name", list(SHAPES))
def test_no_kernel_limit_for_k10_shapes(name):
    """On device "cuda" the implicit step takes every shape: no
    KernelLimit, where K10 once refused r > 4, te > 4 and tf > 16."""
    opts = implicit_options(ctt, device="cuda")
    program = TorchProgram(shape_problem(name, ctt), device="cpu")
    meta = detect_schur_structure(program, opts)
    assert tsf.unsupported_reason(program, opts, meta, implicit=True) is None


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("shape", K10_SHAPES, ids=str)
@pytest.mark.parametrize("ne,k,kf", [(7, 3, 5), (513, 5, 1024),
                                     (5, 33, 7), (300, 2, 20000)])
def test_cuda_k10_tiers_match_plain(monkeypatch, shape, ne, k, kf):
    """Every tier that holds the shape against the plain version on the
    card, bit for bit, each launch counted on its tier; v staged and
    (kf 20,000) read from device memory. Run on a machine with a card:
    python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r, te, tf = shape
    args = [a.cuda() for a in _k10_inputs(ne, k, r, te, tf, kf, seed=ne)]
    want = implicit_apply_plain(*args)
    for tier, scratch_smem in _tiers(r, te, tf):
        monkeypatch.setattr(k10, "TIERS", {t: m for t, m in TIERS.items()
                                           if t >= tier})
        monkeypatch.setattr(k10, "SCRATCH_SMEM_BYTES",
                            None if scratch_smem < 0 else scratch_smem)
        assert k10.implicit_plan(ne, k, r, te, tf, kf)["tier"] == tier
        before = k10.TIER_COUNTERS[tier].launches
        got = implicit_apply(*args)
        torch.cuda.synchronize()
        assert k10.TIER_COUNTERS[tier].launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (tier, scratch_smem)
