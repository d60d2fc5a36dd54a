"""K5 of ceres_tpu_torch (ops/lin_auto.py, the auto-jet linearize) and the
quaternion-camera slice it serves, against the JAX package.

- The plain K5 against the JAX package's _lin_kernel_auto
  (ceres_tpu/ops/pallas_lin.py, make_pallas_lin(...).lin) in interpret
  mode on tests/test_autolin.py's problem with quaternion cameras, with no
  loss and with HuberLoss(1.0), the scale derived (first) and carried:
  every output within 1e-5 relative to its largest entry, as K1 is held
  (both f32, another summation order).
- The plain K5 on the angle-axis Snavely problem against the port's
  plain K1, which computes the same function by hand.
- One LM step against the JAX fused Schur step (K5 in interpret mode),
  with test_torch_solve.py's tolerances.
- Whole CPU solves (DENSE_SCHUR, ITERATIVE_SCHUR + SCHUR_JACOBI,
  DENSE_SCHUR + HuberLoss(1.0)) against ceres_tpu.solve on the CPU: the
  same LM iterations and the final cost within 1e-6 relative. These run a
  larger problem than the LIN checks: with Euclidean quaternion blocks the
  600-observation problem does not converge in 50 iterations in either
  package. The quaternion trajectories are sensitive to f32 rounding: a
  1e-7 relative change of the starting points moves the JAX package's own
  iteration count on such problems (PERF.md, PR 5), so the problem is one
  whose three solves agree at this seed.
- What the slice still refuses, and (on the card only) K5 against its
  plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu

from torch_parity_kit import (ct, ctt, jax_problem, jax_quaternion_problem,
                              main_path_options, pallas_interpret,
                              point_problem,
                              quaternion_bal, quaternion_solve_bal, rel,
                              small_bal, torch_problem,
                              torch_quaternion_problem)

from ceres_tpu import solver as jax_solver
from ceres_tpu.ops.pallas_lin import make_pallas_lin
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers import schur_fused as jax_schur_fused
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.io.bal import build_bal_ceres_problem
from ceres_tpu_torch.ops import lin_auto as k5
from ceres_tpu_torch.ops.jet_compile import make_auto_spec
from ceres_tpu_torch.ops.lin import lin_plain
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.rotation import angle_axis_rotate_point
from ceres_tpu_torch.solver import takes_fused_schur_step
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep

TOL = 1e-5
LOSSES = {"none": (None, None), "huber": (ct.HuberLoss(1.0),
                                          ctt.HuberLoss(1.0))}


def _torch_step(problem, **extra):
    opts = main_path_options(ctt, **extra)
    tp = TorchProgram.get_cached(problem, opts)
    return tp, FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))


def _k5_inputs(step, tp, s_e, first):
    x = tp.initial_state()
    ne, nf = step.ne, step.nf
    return (step.k5, x[step.f_slab:step.f_slab + nf].float(),
            x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float(),
            step.cam, step.mask, step.dat, torch.as_tensor(s_e), first,
            True, step.loss)


@pytest.fixture(scope="module")
def quat():
    """The port's steps on the quaternion problem (no loss, Huber) and a
    seeded carried scale; the JAX references are made per case, once."""
    bal = quaternion_bal()
    steps = {name: _torch_step(torch_quaternion_problem(bal, pair[1]))
             for name, pair in LOSSES.items()}
    ne = steps["none"][1].ne
    s_e = (0.5 + np.random.default_rng(11).random((ne, 3))).astype(
        np.float32)
    return dict(bal=bal, steps=steps, s_e=s_e, jax={})


def _jax_lin(quat, loss_name, first):
    key = (loss_name, first)
    if key not in quat["jax"]:
        opts = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
            use_mixed_precision_solves=True)
        ne = quat["steps"][loss_name][1].ne
        with pallas_interpret():
            jp = JaxProgram.get_cached(jax_quaternion_problem(
                quat["bal"], LOSSES[loss_name][0]), opts)
            plin = make_pallas_lin(jp, opts, jax_detect(jp, opts))
            assert plin is not None          # the JAX gate takes K5 here
            s_e = np.ones((plin.ne_pad, 3), np.float32)
            s_e[:ne] = quat["s_e"]
            out = plin.lin(jp.initial_state(), jnp.asarray(s_e),
                           jnp.asarray(first))
        quat["jax"][key] = {k: np.asarray(v) for k, v in out.items()
                            if k != "ne_pad"}
    return quat["jax"][key]


@pytest.mark.parametrize("first", [True, False], ids=["first", "carried"])
@pytest.mark.parametrize("loss_name", list(LOSSES))
def test_k5_plain_matches_jax_auto_lin_kernel(quat, loss_name, first):
    tp, step = quat["steps"][loss_name]
    assert step.k5 is not None and step.k5.auto.name == \
        "auto:SnavelyReprojectionErrorWithQuaternions"
    assert (step.te, step.tf, step.k5.r) == (3, 10, 2)
    ne = step.ne
    j = _jax_lin(quat, loss_name, first)
    t = {k: v.numpy() for k, v in k5.lin_auto_plain(
        *_k5_inputs(step, tp, quat["s_e"], first)).items()}
    assert rel(t["ete"].reshape(ne, 3, 3), j["EtE"][:ne]) <= TOL
    assert rel(t["ge"], j["g_e"][:ne]) <= TOL
    assert rel(t["se"], j["s_e"][:ne]) <= TOL
    assert rel(t["A"], j["A_eT"][:, :, :ne].transpose(2, 0, 1)) <= TOL
    assert rel(t["ftf"], j["FtF"]) <= TOL
    assert rel(t["gf"], j["g_f"]) <= TOL
    if not first:
        assert np.array_equal(t["se"], quat["s_e"])


@pytest.mark.parametrize("loss", [None, ctt.HuberLoss(1.0)],
                         ids=["none", "huber"])
def test_k5_plain_matches_k1_plain_on_snavely(loss):
    """On the angle-axis Snavely bucket, K5's traced chain and epilogue
    give what K1's hand-written ones give (K1 takes masked lanes as camera
    0, K5 as the point's first valid lane: the mask removes both)."""
    tp, step = _torch_step(torch_problem(small_bal(), loss))
    assert step.k5 is None                     # Snavely keeps K1
    bk = tp.buckets[0]
    var = [i for i, sl in enumerate(bk.slots) if sl.variable]
    meta = detect_schur_structure(tp, main_path_options(ctt))
    spec = k5.lin_auto_spec(make_auto_spec(tp, bk),
                            var[meta.buckets[0].e_slot])
    rows, cmask = meta.buckets[0].chunk_rows, meta.buckets[0].chunk_mask
    safe = torch.as_tensor(k5.safe_rows(rows, cmask))
    local = np.asarray(next(s[2] for s in meta.f_groups[0]["slots"]
                            if s[0] == 0))
    cam = torch.as_tensor(local.astype(np.int32))[safe].contiguous()
    dat = spec.auto.data_matrix(bk)[safe].contiguous()
    x = tp.initial_state()
    ne, nf = step.ne, step.nf
    xe = x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    xf = x[step.f_slab:step.f_slab + nf].float()
    se = torch.ones(ne, 3)
    a = k5.lin_auto_plain(spec, xf, xe, cam, step.mask, dat, se, True,
                          True, loss)
    b = lin_plain(xf, xe, step.cam, step.mask, step.dat[..., 0],
                  step.dat[..., 1], se, True, loss=loss)
    assert set(a) == set(b)
    for key in b:
        assert rel(a[key], b[key]) <= TOL, key


def test_one_lm_step_matches_jax_k5_step(quat):
    """One LM step at the start against the JAX fused Schur step, whose
    lin phase is K5 in interpret mode."""
    radius = 1e4
    opts_j = main_path_options(ct)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_quaternion_problem(quat["bal"]),
                                   opts_j)
        step_j = jax_schur_fused.make_fused_schur_lm_step(
            jp, opts_j, jax_detect(jp, opts_j))
        assert step_j.pallas_lin
        x0 = jp.initial_state()
        scale = jax_solver.make_scale_fn(jp, opts_j)(x0)
        ex = (jp.example_x(), jp.example_scalar(), jp.example_delta())
        a = jp.jit_with_consts(jax_solver.make_step_impl(jp, opts_j), ex)(
            x0, jnp.asarray(radius, jp.dtype), scale)
    tp, step = quat["steps"]["none"]
    sc = torch.tensor(np.array(scale), dtype=torch.float32)
    s_e = sc[step.e_slab:step.e_slab + 3 * step.ne].view(step.ne, 3)
    s_f = sc[step.f_slab:step.f_slab + step.nf].view(step.kf, 10)
    art = step.linearize(tp.initial_state(), s_e, s_f, first=False)
    b = step.solve(art, radius)
    for k in ["cost", "gradient_max_norm", "delta", "model_cost_change",
              "step_norm"]:
        tol = 5e-4 if k in ("delta", "step_norm") else 1e-5
        assert rel(b[k].numpy(), np.asarray(a[k])) < tol, k


SOLVES = {"dense": ("DENSE_SCHUR", None),
          "iterative": ("ITERATIVE_SCHUR", None),
          "dense-huber": ("DENSE_SCHUR", 1.0)}


@pytest.mark.parametrize("name", list(SOLVES))
def test_quaternion_solve_matches_jax(name):
    solver, huber = SOLVES[name]
    bal = quaternion_solve_bal()
    extra = dict(max_num_iterations=100 if huber else 50)

    def opts(mod):
        return main_path_options(mod, linear_solver_type=getattr(
            mod.LinearSolverType, solver), **extra)

    s_j = ct.solve(opts(ct), jax_quaternion_problem(
        bal, None if huber is None else ct.HuberLoss(huber)))
    problem = torch_quaternion_problem(
        bal, None if huber is None else ctt.HuberLoss(huber))
    s_t = ctt.solve(opts(ctt), problem)
    assert "K5" in s_t.message
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost


def test_quaternion_manifold_still_raises():
    """Quaternion cameras on the quaternion x Euclidean(6) product
    manifold build (io/bal.py, as the JAX package does), and the fused
    Schur step still refuses non-Euclidean manifolds (ROADMAP.md item
    11), so the solve takes the generic Schur step, whose parity
    tests/test_torch_schur_solve.py holds."""
    problem, cams, _ = build_bal_ceres_problem(
        quaternion_bal(), use_quaternions=True, use_manifolds=True)
    assert all(type(problem._blocks[id(c)].manifold).__name__
               == "ProductManifold" for c in cams)
    opts = main_path_options(ctt)
    program = TorchProgram(problem, device="cpu")
    meta = detect_schur_structure(program, opts)
    with pytest.raises(NotImplementedError, match="item 11"):
        FusedSchurStep(program, opts, meta)
    s = ctt.solve(main_path_options(ctt, max_num_iterations=2), problem)
    assert "Schur step: generic DENSE_SCHUR" in s.message


class _HomogeneousPinhole:
    """A 6-parameter camera (angle-axis, translation) and a 4-parameter
    homogeneous point: te = 4."""

    def __init__(self, ox, oy):
        self.ox, self.oy = float(ox), float(oy)

    def __call__(self, cam, pt):
        p = angle_axis_rotate_point(cam[0:3], pt[0:3]) + cam[3:6] * pt[3]
        return torch.stack([p[0] / p[2] - self.ox, p[1] / p[2] - self.oy])


class _Branchy:
    """Control flow on the parameter values: does not trace."""

    def __init__(self, ox, oy):
        self.ox, self.oy = float(ox), float(oy)

    def __call__(self, cam, pt):
        p = angle_axis_rotate_point(cam[0:3], pt) + cam[3:6]
        if p[2] > 0:
            return torch.stack([p[0] / p[2] - self.ox, p[1] / p[2] - self.oy])
        return torch.stack([p[0] - self.ox, p[1] - self.oy])


@pytest.mark.parametrize("functor,point_size,match", [
    (_HomogeneousPinhole, 4, None), (_Branchy, 3, "item 11")],
    ids=["te4", "untraceable"])
def test_explicit_step_refuses(functor, point_size, match):
    """A functor the jet compiler cannot trace: the explicit fused step
    raises, naming its ROADMAP.md item, and the solve takes the generic
    Schur step (solver.py takes_fused_schur_step), as the JAX package's
    fused step runs it on its generic lin phase. A point block of te = 4
    (the homogeneous point), which the explicit step refused until K6
    took every te the JAX kernels take (ROADMAP.md item 40): the step
    builds on the fused route (K5, then K6 after the PyTorch inverse),
    and the solve keeps the JAX fused step's LM count and its cost within
    5e-4 over five iterations (tests/test_torch_elim_te.py states why)."""
    rng = np.random.default_rng(0)
    cams = [np.concatenate([0.05 * rng.standard_normal(3),
                            [0.1 * c, -0.1, 4.0]]) for c in range(4)]
    pts = [np.concatenate([0.5 * rng.standard_normal(3), [1.0]])[
        :point_size] for _ in range(30)]
    prob = ctt.Problem()
    for p in pts:
        for c in range(4):
            prob.add_residual_block(ctt.AutoDiffCostFunction(
                functor(*(0.1 * rng.standard_normal(2))), 2,
                [6, point_size]), None, cams[c], p)
    opts = main_path_options(ctt)
    program = TorchProgram(prob, device="cpu")
    meta = detect_schur_structure(program, opts)
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            FusedSchurStep(program, opts, meta)
        assert not takes_fused_schur_step(program, opts)
        return
    step = FusedSchurStep(program, opts, meta)
    assert (step.te, step.k5 is not None) == (4, True)
    assert "eliminate K6" in step.mode
    assert takes_fused_schur_step(program, opts)
    s_j = ct.solve(main_path_options(ct, max_num_iterations=5),
                   point_problem(ct, 4))
    s_t = ctt.solve(main_path_options(ctt, max_num_iterations=5),
                    point_problem(ctt, 4))
    assert s_t.num_iterations == s_j.num_iterations
    assert abs(s_t.final_cost - s_j.final_cost) <= 5e-4 * s_j.final_cost


@pytest.mark.cuda
@pytest.mark.parametrize("loss_name", list(LOSSES))
def test_cuda_k5_matches_plain(quat, loss_name):
    """On the card: the generated K5 against lin_auto_plain on the same
    inputs, within 1e-5. The CPU has no kernel to run (the CUDA build
    needs nvcc and a GPU): python -m pytest tests -m cuda on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bal = quat["bal"]
    opts = main_path_options(ctt, device="cuda")
    problem = torch_quaternion_problem(bal, LOSSES[loss_name][1])
    tp = TorchProgram.get_cached(problem, opts)
    step = FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))
    for first in (True, False):
        args = _k5_inputs(step, tp, quat["s_e"], first)
        args = args[:6] + (args[6].cuda(),) + args[7:]
        got = k5.lin_auto(*args)
        want = k5.lin_auto_plain(*args)
        for key in want:
            assert rel(got[key].cpu(), want[key].cpu()) <= TOL, key


# ---- the kernel's edges: seeded inputs, on the host and on the card ----

class _Wide:
    """A functor at the gate's caps: a 12-parameter camera, a 6-parameter
    point, 8 residuals (te 6, tf 12, r 8)."""

    def __init__(self, o):
        self.o = float(o)

    def __call__(self, cam, pt):
        u = cam[0:6] * pt
        v = cam[6:12] * torch.sin(pt)
        return torch.cat([u + v, (u * v)[0:2]]) - self.o


@pytest.fixture(scope="module")
def wide_spec():
    """K5's spec of the _Wide functor (traced once)."""
    rng = np.random.default_rng(5)
    cams = [rng.standard_normal(12) for _ in range(2)]
    pts = [rng.standard_normal(6) for _ in range(3)]
    prob = ctt.Problem()
    for p in pts:
        for c in cams:
            prob.add_residual_block(ctt.AutoDiffCostFunction(
                _Wide(rng.standard_normal()), 8, [12, 6]), None, c, p)
    tp = TorchProgram(prob, device="cpu")
    spec = k5.lin_auto_spec(make_auto_spec(tp, tp.buckets[0]), 1)
    assert (spec.te, spec.tf, spec.r) == (k5.MAX_TE, k5.MAX_TF, k5.MAX_R)
    return spec


# name: (ne, k, kf, points observed twice by one camera, loss)
EDGES = {
    "k1": (50, 1, 6, False, None),
    "k4-ragged-twice": (45, 4, 6, True, None),
    "k4-huber": (45, 4, 6, True, "huber"),
    "k33": (7, 33, 12, True, None),
    "k200": (2, 200, 6, False, None),
    "nf-not-4": (40, 4, 9, True, None),
    "chunks": (300, 4, 6, True, None),
    "kf408": (6, 4, 408, True, None),
    "kf409": (6, 4, 409, True, None),
}


def _edge_inputs(quat, ne, k, kf, twice, seed):
    """Seeded K5 inputs at the quaternion functor's shape (te 3, tf 10):
    each point a random point of the quaternion problem with its valid
    lanes' observations repeated to a random count of 1..k lanes, each
    lane's camera on a random copy (slightly moved) of its own camera
    among kf, masked lanes filled from the first lane (safe_rows), and
    with `twice` some points' lane 1 a second observation by lane 0's
    camera."""
    tp, step = quat["steps"]["none"]
    x = tp.initial_state()
    ne0, kf0, tf = step.ne, step.kf, step.tf
    xe0 = x[step.e_slab:step.e_slab + 3 * ne0].view(ne0, 3).float().numpy()
    xf0 = x[step.f_slab:step.f_slab + step.nf].view(kf0, tf).float().numpy()
    cam0, mask0 = step.cam.numpy(), step.mask.numpy()
    dat0 = step.dat.numpy()
    rng = np.random.default_rng(seed)
    reps = -(-kf // kf0)
    xf = np.concatenate([xf0 * (1 + 1e-4 * rng.standard_normal(xf0.shape))
                         for _ in range(reps)])[:kf].astype(np.float32)
    pts = rng.integers(0, ne0, ne)
    xe = (xe0[pts] * (1 + 1e-3 * rng.standard_normal((ne, 3)))).astype(
        np.float32)
    cam = np.zeros((ne, k), np.int32)
    dat = np.zeros((ne, k, dat0.shape[2]), np.float32)
    mask = np.zeros((ne, k), np.float32)
    for n, p in enumerate(pts):
        lanes = np.flatnonzero(mask0[p] > 0)
        count = int(rng.integers(1, k + 1))
        for j in range(k):
            src = lanes[j % lanes.size] if j < count else lanes[0]
            c = cam0[p, src] + kf0 * int(rng.integers(0, reps))
            cam[n, j] = c if c < kf else cam0[p, src]
            dat[n, j] = dat0[p, src] + 0.01 * rng.standard_normal(2)
            mask[n, j] = float(j < count)
        if twice and k > 1 and n % 3 == 0:
            cam[n, 1], mask[n, 1] = cam[n, 0], 1.0
        cam[n, mask[n] == 0] = cam[n, 0]
        dat[n, mask[n] == 0] = dat[n, 0]
    se_in = (0.5 + rng.random((ne, 3))).astype(np.float32)
    return tuple(torch.as_tensor(a) for a in (xf.reshape(-1), xe, cam, mask,
                                              dat, se_in))


def _wide_inputs(spec, ne, k, kf, seed):
    """Seeded K5 inputs for the _Wide functor, with repeated cameras."""
    rng = np.random.default_rng(seed)
    cam = rng.integers(0, kf, (ne, k)).astype(np.int32)
    cam[::2, 1] = cam[::2, 0]
    mask = (rng.random((ne, k)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    cam[mask == 0] = np.broadcast_to(cam[:, :1], cam.shape)[mask == 0]
    dat = rng.standard_normal((ne, k, spec.auto.p_dat)).astype(np.float32)
    dat[mask == 0] = np.broadcast_to(dat[:, :1], dat.shape)[mask == 0]
    return tuple(torch.as_tensor(a) for a in (
        rng.standard_normal(kf * spec.tf).astype(np.float32),
        rng.standard_normal((ne, spec.te)).astype(np.float32), cam, mask,
        dat, (0.5 + rng.random((ne, spec.te))).astype(np.float32)))


_K5_MAIN = r"""
  const int* h = emu_read<int>("hdr", 9);
  const int ne = h[0], k = h[1], kf = h[2], pb = h[3], nchunks = h[4];
  const int nvalid = h[5], nlp = h[6], first = h[7], use_scaling = h[8];
  constexpr int TE = Chain::TE, TF = Chain::TF, ND = Chain::ND;
  constexpr int NQ = TF * (TF + 1) / 2 + TF;
  const size_t rows = (size_t)ne * k, na = (size_t)ne * TE * kf * TF;
  const float* xf = emu_read<float>("xf", (size_t)kf * TF);
  const float* xe = emu_read<float>("xe", (size_t)ne * TE);
  const int* cam = emu_read<int>("cam", rows);
  const float* mask = emu_read<float>("mask", rows);
  const float* dat = emu_read<float>("dat", rows * ND);
  const float* lp = emu_read<float>("lp", nlp);
  const float* se_in = emu_read<float>("se_in", (size_t)ne * TE);
  const int* pos = emu_read<int>("pos", rows);
  const int* off = emu_read<int>("off", (size_t)nchunks * kf + 1);
  float* ete = emu_alloc<float>((size_t)ne * TE * TE);
  float* ge = emu_alloc<float>((size_t)ne * TE);
  float* se = emu_alloc<float>((size_t)ne * TE);
  float* A = emu_alloc<float>(na);
  float* q = emu_alloc<float>((size_t)nvalid * NQ);
  float* partial = emu_alloc<float>((size_t)nchunks * kf * NQ);
  float* ftf = emu_alloc<float>((size_t)kf * TF * TF);
  float* gf = emu_alloc<float>((size_t)kf * TF);
  if (lin_auto_launch<Chain>(xf, xe, cam, mask, dat, nlp, lp, 0,
                             se_in, first, use_scaling, ne, k, kf, pb, pos,
                             off, nchunks, ete, ge, se, A, q, partial, ftf,
                             gf, nullptr))
    return 3;
  emu_write("ete", ete, (size_t)ne * TE * TE);
  emu_write("ge", ge, (size_t)ne * TE);
  emu_write("se", se, (size_t)ne * TE);
  emu_write("A", A, na);
  emu_write("ftf", ftf, (size_t)kf * TF * TF);
  emu_write("gf", gf, (size_t)kf * TF);
"""
_EMU_EXE = {}


def _emulated_k5(tmp_path_factory, spec, xf, xe, cam, mask, dat, se_in,
                 first, use_scaling=True, loss=None):
    """csrc/lin_auto.cuh run on the host (tests/cuda_host_emu.py) through
    lin_auto_launch, with the wrapper's plan and block choice."""
    from ceres_tpu_torch.ops import _cuda
    from ceres_tpu_torch.ops.jet_compile import (loss_param_values,
                                                 make_loss_spec)
    lspec = None if loss is None else make_loss_spec(loss)
    key = (spec.auto.digest, spec[1:], lspec and lspec.digest)
    if key not in _EMU_EXE:
        _EMU_EXE[key] = emu.build(
            tmp_path_factory.mktemp("k5emu"),
            (_cuda.CSRC / "lin_auto.cuh").read_text(), _K5_MAIN,
            k5.chain_source(spec, lspec))
    ne, k = cam.shape
    te, tf = spec.te, spec.tf
    kf = xf.numel() // tf
    pb, _ = k5.lane_block(k, te, tf)
    plan = k5.camera_plan(cam, mask, kf)
    lp = [] if loss is None else loss_param_values(loss)
    hdr = [ne, k, kf, pb, plan.nchunks, plan.nvalid, len(lp), int(first),
           int(use_scaling)]
    out = emu.run(_EMU_EXE[key], tmp_path_factory.mktemp("k5run"), {
        "hdr": np.array(hdr, np.int32), "xf": xf.numpy(), "xe": xe.numpy(),
        "cam": cam.numpy(), "mask": mask.numpy(), "dat": dat.numpy(),
        "lp": np.array(lp, np.float32), "se_in": se_in.numpy(),
        "pos": plan.pos.numpy(), "off": plan.off.numpy()}, {
        "ete": (np.float32, ne * te * te), "ge": (np.float32, ne * te),
        "se": (np.float32, ne * te), "A": (np.float32, ne * te * kf * tf),
        "ftf": (np.float32, kf * tf * tf), "gf": (np.float32, kf * tf)})
    return {"ete": out["ete"].reshape(ne, te * te),
            "ge": out["ge"].reshape(ne, te), "se": out["se"].reshape(ne, te),
            "A": out["A"].reshape(ne, te, kf * tf),
            "ftf": out["ftf"].reshape(kf, tf, tf),
            "gf": out["gf"].reshape(kf, tf)}


def _hold(got, want, tol=TOL):
    for key in want:
        g = np.asarray(got[key].cpu() if torch.is_tensor(got[key])
                       else got[key])
        assert np.isfinite(g).all(), key          # A: every entry written
        assert rel(g, want[key].cpu()) <= tol, key


@pytest.mark.parametrize("name", list(EDGES))
def test_k5_kernel_source_on_the_host(quat, tmp_path_factory, name):
    """csrc/lin_auto.cuh, emulated on the host (one std::thread per CUDA
    thread), against lin_auto_plain at the edges: one lane a point, a
    ragged last block, a point observed twice by one camera, a point past
    a block's 128 lanes (passes), nf not a multiple of 4 (4-byte stores),
    rows over several 1,024-row chunks, rows longer than the A tile (kf
    408 and 409: column segments); the scale derived and carried."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    ne, k, kf, twice, loss_name = EDGES[name]
    loss = LOSSES[loss_name or "none"][1]
    spec = quat["steps"][loss_name or "none"][1].k5
    args = _edge_inputs(quat, ne, k, kf, twice, seed=k * 1000 + ne)
    for first in (True, False):
        want = k5.lin_auto_plain(spec, *args, first, True, loss)
        got = _emulated_k5(tmp_path_factory, spec, *args, first, True, loss)
        _hold(got, want)


def test_k5_kernel_source_on_the_host_at_the_caps(wide_spec,
                                                  tmp_path_factory):
    """The same at the gate's caps te 6, tf 12, r 8, with repeated
    cameras and masked lanes, scaling off."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    args = _wide_inputs(wide_spec, 30, 6, 5, seed=3)
    want = k5.lin_auto_plain(wide_spec, *args, True, False)
    _hold(_emulated_k5(tmp_path_factory, wide_spec, *args, True, False),
          want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EDGES))
def test_cuda_k5_edges_match_plain(quat, name):
    """On the card: K5 at the edges of the host test above against
    lin_auto_plain within 1e-5, every A entry written, one launch a call.
    Run on a machine with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ne, k, kf, twice, loss_name = EDGES[name]
    loss = LOSSES[loss_name or "none"][1]
    spec = quat["steps"][loss_name or "none"][1].k5
    args = [a.cuda() for a in _edge_inputs(quat, ne, k, kf, twice,
                                           seed=k * 1000 + ne)]
    for first in (True, False):
        k5.lin_auto.launches = 0
        got = k5.lin_auto(spec, *args, first, True, loss)
        torch.cuda.synchronize()
        assert k5.lin_auto.launches == 1
        _hold(got, k5.lin_auto_plain(spec, *args, first, True, loss))


@pytest.mark.cuda
def test_cuda_k5_at_the_caps_matches_plain(wide_spec):
    """On the card: K5 at te 6, tf 12, r 8 against lin_auto_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [a.cuda() for a in _wide_inputs(wide_spec, 300, 6, 40, seed=3)]
    _hold(k5.lin_auto(wide_spec, *args, True, True),
          k5.lin_auto_plain(wide_spec, *args, True, True))


# ---- host-side pieces of the kernel, and the contract with duplicates ----

def test_camera_plan_against_a_direct_construction():
    """K5's camera plan (three 1,024-row chunks, masked lanes, points
    observed twice by one camera) against a walk of chunks, cameras and
    rows in order."""
    rng = np.random.default_rng(4)
    ne, k, kf = 700, 3, 7
    cam = rng.integers(0, kf, (ne, k)).astype(np.int32)
    cam[::5, 1] = cam[::5, 0]
    mask = rng.random((ne, k)) < 0.7
    mask[:, 0] = True
    plan = k5.camera_plan(torch.as_tensor(cam),
                          torch.as_tensor(mask.astype(np.float32)), kf)
    rows = ne * k
    pos, off, p = np.full(rows, -1), [0], 0
    for ch in range(3):
        for c in range(kf):
            for r in range(ch * 1024, min((ch + 1) * 1024, rows)):
                if mask.flat[r] and cam.flat[r] == c:
                    pos[r] = p
                    p += 1
            off.append(p)
    assert plan.nchunks == 3 and plan.nvalid == int(mask.sum())
    assert plan.pos.dtype == plan.off.dtype == torch.int32
    assert np.array_equal(plan.pos.numpy(), pos)
    assert np.array_equal(plan.off.numpy(), off)
    with pytest.raises(ValueError, match="outside"):
        k5.camera_plan(torch.as_tensor(cam), torch.ones(ne, k), kf - 1)


def test_lane_block_choice():
    """Points a block (128 lanes, whole points; one point past 128) and
    the block's shared memory, as csrc/lin_auto.cuh lays it out: 31 KB at
    the quaternion shape (the A tile, 2,048 floats; the 64-lane F-side
    stage, 64 x 65, and the cross terms, 128 x 31, in one place), under
    the card's 227 KB at the caps."""
    assert [k5.lane_block(k, 3, 10)[0] for k in (1, 4, 5, 33, 128, 200)] \
        == [128, 32, 25, 3, 1, 1]
    # + 128 lanes x (9 + 2) + 128 places + 32 points x 3, 4 B each
    assert k5.lane_block(4, 3, 10)[1] == 4 * (
        2048 + 64 * 65 + 128 * 11 + 128 + 96)
    # past a pass, the stage and the cross terms side by side
    assert k5.lane_block(200, 3, 10)[1] == 4 * (
        2048 + 64 * 65 + 200 * 31 + 200 * 11 + 128 + 3)
    assert k5.lane_block(128, k5.MAX_TE, k5.MAX_TF)[1] <= 232448
    assert k5.lane_block(1400, 3, 10)[1] > 232448


def _twice_bal():
    """The quaternion problem with every 37th observation repeated (0.3
    pixel off) by the same camera: points observed twice by one camera."""
    bal = quaternion_bal()
    idx = np.arange(0, bal.num_observations, 37)
    bal.camera_index = np.concatenate([bal.camera_index,
                                       bal.camera_index[idx]])
    bal.point_index = np.concatenate([bal.point_index, bal.point_index[idx]])
    bal.observations = np.concatenate([bal.observations,
                                       bal.observations[idx] + 0.3])
    return bal


def test_k5_plain_matches_jax_with_a_point_observed_twice(tmp_path_factory):
    """The contract K5 meets where a point has two lanes on one camera:
    lin_auto_plain and the kernel source (emulated on the host) against
    the JAX _lin_kernel_auto in interpret mode, within 1e-5."""
    bal = _twice_bal()
    opts = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                            use_mixed_precision_solves=True)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_quaternion_problem(bal), opts)
        plin = make_pallas_lin(jp, opts, jax_detect(jp, opts))
        assert plin is not None
        j = {key: np.asarray(v) for key, v in plin.lin(
            jp.initial_state(), jnp.ones((plin.ne_pad, 3), jnp.float32),
            jnp.asarray(True)).items() if key != "ne_pad"}
    tp, step = _torch_step(torch_quaternion_problem(bal))
    cam, mask = step.cam.numpy(), step.mask.numpy() > 0
    assert any(cam[n, a] == cam[n, b] and mask[n, a] and mask[n, b]
               for n in range(step.ne) for a in range(cam.shape[1])
               for b in range(a))
    ne = step.ne
    args = _k5_inputs(step, tp, np.ones((ne, 3), np.float32), True)
    want = {"ete": j["EtE"][:ne].reshape(ne, 9), "ge": j["g_e"][:ne],
            "se": j["s_e"][:ne],
            "A": j["A_eT"][:, :, :ne].transpose(2, 0, 1),
            "ftf": j["FtF"], "gf": j["g_f"]}
    want = {key: torch.tensor(v) for key, v in want.items()}
    _hold(k5.lin_auto_plain(*args), want)
    if emu.gxx() is not None:
        _hold(_emulated_k5(tmp_path_factory, *args[:8]), want)
