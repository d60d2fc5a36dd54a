"""Per-row loss parameters and K1 under any traced loss (ceres_tpu_torch
against ceres_tpu).

- Bucketing: a flat loss class of plain numbers is one bucket, its
  differing scalars stacked per row (ceres_tpu program.py loss_attrs), so
  the port's buckets, their rows and the stacked scalars are the JAX
  package's: per-observation HuberLoss(1.2 ** level) on 8 levels (one
  bucket) and FoE denoising's per-filter alphas (one bucket, where the
  port keyed three by value); nested losses keep F2's key
  (tests/test_torch_repairs.py). The sharded layouts carry the stacked
  scalars as the JAX package's do.
- Solves under ScaledLoss, ComposedLoss, LossFunctionWrapper and per-row
  HuberLoss against the JAX package's: f64 with its LM count and final
  cost within 1e-12; mixed DENSE_SCHUR (K1's plain version on the CPU,
  its loss per lane) with its LM count and final cost within 1e-9, as
  the robust solves' tests.
- The gate on device "cuda": no KernelLimit for these losses (K1's
  generated loss units), for per-row scalars (K1 and K5 read the lanes'
  own) or for a loss of more than 16 scalars; a loss that does not trace
  is the one refusal left (ROADMAP.md item 9).
- On the host (tests/cuda_host_emu.py): K1's generated loss unit
  (csrc/lin_k1.cuh with ScaledLoss(HuberLoss(1.0), 0.5)'s emitted rho',
  rho'') and K1 and K5 with per-lane scalars (the LossRow pointer)
  against their plain versions within 1e-5 (f32, the host's rounding).
"""

import numpy as np
import pytest
import torch

import cuda_host_emu as emu
from torch_parity_kit import (ct, ctt, main_path_options, quaternion_bal,
                              rel, small_bal)

from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.parallel import sharded as jsh
from ceres_tpu.parallel import sharded_fused as jsf
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.ops import _cuda
from ceres_tpu_torch.ops import lin_auto as k5
from ceres_tpu_torch.ops.jet_compile import make_auto_spec, make_loss_spec
from ceres_tpu_torch.ops.lin import k1_loss_unit, lin_plain
from ceres_tpu_torch.parallel import sharded as tsh
from ceres_tpu_torch.parallel import sharded_fused as tsf_sh
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers import schur_fused as tsf
from ceres_tpu_torch.solvers.schur import detect_schur_structure

LEVELS = np.random.default_rng(16).integers(0, 8, 1500)


def tiny_bal():
    bal = synthetic_bal_problem(num_cameras=4, num_points=100,
                                num_observations=400, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return bal


# each loss by name: loss(mod, i) for observation i. Their solves of
# small_bal converge in 4-11 LM iterations; a loss whose solve takes
# 30-50 (ComposedLoss(CauchyLoss(2), HuberLoss(1))) parts the two
# packages' f32 (and even f64) trajectories by an LM iteration or two in
# the tail, where both have converged to the same cost within 2e-5
LOSSES = {
    "scaled": lambda m, i: m.ScaledLoss(m.HuberLoss(2.0), 0.5),
    "composed": lambda m, i: m.ComposedLoss(m.HuberLoss(3.0),
                                            m.ScaledLoss(None, 0.5)),
    "wrapper": lambda m, i: m.LossFunctionWrapper(m.CauchyLoss(5.0)),
    "row_huber": lambda m, i: m.HuberLoss(1.2 ** int(LEVELS[i])),
}


def loss_problem(mod, name, bal=None):
    """tiny_bal's observations (Snavely) under LOSSES[name] in package
    `mod`: one loss object for every block where the loss is one, one a
    block for the per-row losses."""
    from importlib import import_module
    snav = import_module(mod.__name__ + ".examples.snavely")
    bal = tiny_bal() if bal is None else bal
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pts = [bal.points[i].copy() for i in range(bal.num_points)]
    prob = mod.Problem()
    shared = LOSSES[name](mod, 0) if name != "row_huber" else None
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        prob.add_residual_block(
            mod.AutoDiffCostFunction(snav.SnavelyReprojectionError(ox, oy),
                                     2, [9, 3]),
            shared if shared is not None else LOSSES[name](mod, i),
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return prob


# ---- bucketing ----

def test_per_row_huber_is_one_bucket_as_in_jax():
    """Eight Huber thresholds make one bucket with the JAX package's rows
    and stacked scalars; the per-row loss prices each row by its own."""
    jp = JaxProgram(loss_problem(ct, "row_huber"))
    tp = TorchProgram(loss_problem(ctt, "row_huber"), device="cpu")
    assert len(tp.buckets) == len(jp.buckets) == 1
    bj, bt = jp.buckets[0], tp.buckets[0]
    assert np.array_equal(bt.orig_indices, bj.orig_indices)
    assert sorted(bt.loss_attrs) == sorted(bj.loss_attrs)
    for k, v in bj.loss_attrs.items():
        assert np.array_equal(bt.loss_attrs[k], np.asarray(v, np.float64))
    assert float(tp.cost_fn(tp.initial_state())) == pytest.approx(
        float(jp.cost_fn(jp.initial_state())), rel=1e-13)


def test_uniform_and_nested_losses_keep_one_set_of_scalars():
    """One HuberLoss for all rows: no stacked scalars; two nested losses
    with differing inner scalars still split (F2)."""
    tp = TorchProgram(loss_problem(ctt, "scaled"), device="cpu")
    assert len(tp.buckets) == 1 and tp.buckets[0].loss_attrs is None
    assert tp.buckets[0].loss is tp.buckets[0].loss_proto


def test_foe_buckets_match_jax(tmp_path):
    """FoE denoising's per-filter alphas: the JAX package's bucket count
    (one bucket for the filters' blocks, their alphas stacked)."""
    from ceres_tpu.examples import denoising as jd
    from ceres_tpu.io.pgm import read_pgm as jax_read_pgm
    from ceres_tpu_torch.examples import denoising as td
    from ceres_tpu_torch.io.pgm import read_pgm, write_pgm
    rng = np.random.default_rng(2)
    img = np.clip(128 + 20 * rng.standard_normal((10, 10)), 0, 255)
    write_pgm(str(tmp_path / "n.pgm"), img)
    fs = rng.standard_normal((3, 4))
    td.write_foe(str(tmp_path / "f.foe"), 2, [0.8, 1.2, 1.6],
                 fs - fs.mean(axis=1, keepdims=True))
    jprob, _ = jd.build_denoising_problem(
        jax_read_pgm(str(tmp_path / "n.pgm")),
        jd.FieldsOfExperts(str(tmp_path / "f.foe")))
    tprob, _ = td.build_denoising_problem(
        read_pgm(str(tmp_path / "n.pgm")),
        td.FieldsOfExperts(str(tmp_path / "f.foe")))
    jp, tp = JaxProgram(jprob), TorchProgram(tprob, device="cpu")
    assert len(tp.buckets) == len(jp.buckets)
    assert [bk.n for bk in tp.buckets] == [bk.n for bk in jp.buckets]
    assert any(bk.loss_attrs is not None for bk in tp.buckets)
    assert float(tp.cost_fn(tp.initial_state())) == pytest.approx(
        float(jp.cost_fn(jp.initial_state())), rel=1e-12)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_layouts_carry_the_stacked_scalars(world):
    """build_row_shards and build_chunk_shards pad or gather the stacked
    scalars with the rows, as the JAX package's functions do."""
    jp = JaxProgram(loss_problem(ct, "row_huber"))
    tp = TorchProgram(loss_problem(ctt, "row_huber"), device="cpu")
    for got, want in zip(tsh.build_row_shards(tp, world),
                         jsh.build_row_shards(jp, world)):
        for k, v in want["loss_attrs"].items():
            assert np.array_equal(got["loss_attrs"][k], v)
    jopt = ct.SolverOptions(linear_solver_type=ct.LinearSolverType
                            .DENSE_SCHUR)
    topt = ctt.SolverOptions(device="cpu", linear_solver_type=ctt
                             .LinearSolverType.DENSE_SCHUR)
    want, _ = jsf.build_chunk_shards(jp, jax_detect(jp, jopt), world)
    got, _ = tsf_sh.build_chunk_shards(tp, detect_schur_structure(tp, topt),
                                       world)
    for g, w in zip(got, want):
        for k, v in w["loss_attrs"].items():
            assert np.array_equal(g["loss_attrs"][k], v)


# ---- solves ----

@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's solve of each loss, f64 and mixed, once."""
    out = {}
    for name in LOSSES:
        for mixed in (False, True):
            out[name, mixed] = ct.solve(
                main_path_options(ct, use_mixed_precision_solves=mixed),
                loss_problem(ct, name, small_bal()))
    return out


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_solve_matches_jax(jax_solves, name, mixed):
    s_j = jax_solves[name, mixed]
    s_t = ctt.solve(main_path_options(ctt, use_mixed_precision_solves=mixed),
                    loss_problem(ctt, name, small_bal()))
    assert s_t.termination_type.name == s_j.termination_type.name == \
        "CONVERGENCE"
    if mixed:
        assert "linearize K1" in s_t.message
    assert s_t.num_iterations == s_j.num_iterations
    tol = 1e-9 if mixed else 1e-12
    assert abs(s_t.final_cost - s_j.final_cost) <= tol * s_j.final_cost


def test_batch_mode_stacks_the_rows_scalars():
    """solve_batched in batch mode on three elements whose per-row
    scalars differ element by element (f64, DENSE_SCHUR): each element's
    scalars ride with its rows (batch.py _Batch.losses), each element
    with the JAX package's batched LM count and final cost within
    1e-12."""
    def element(mod, seed):
        levels = np.random.default_rng(seed).integers(0, 8, 400)
        bal = tiny_bal()
        prob = mod.Problem()
        from importlib import import_module
        snav = import_module(mod.__name__ + ".examples.snavely")
        cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
        pts = [bal.points[i].copy() for i in range(bal.num_points)]
        for i in range(bal.num_observations):
            prob.add_residual_block(
                mod.AutoDiffCostFunction(snav.SnavelyReprojectionError(
                    *bal.observations[i]), 2, [9, 3]),
                mod.HuberLoss(1.2 ** int(levels[i])),
                cams[bal.camera_index[i]], pts[bal.point_index[i]])
        return prob

    got = ctt.solve_batched(main_path_options(
        ctt, use_mixed_precision_solves=False, batch_mode="batch"),
        [element(ctt, s) for s in (1, 2, 3)])
    want = ct.solve_batched(main_path_options(
        ct, use_mixed_precision_solves=False, batch_mode="batch"),
        [element(ct, s) for s in (1, 2, 3)])
    for a, b in zip(got, want):
        assert a.num_iterations == b.num_iterations
        assert abs(a.final_cost - b.final_cost) <= 1e-12 * b.final_cost
    assert len({round(a.final_cost, 6) for a in got}) == 3


# ---- the gate ----

class _ManyScalars(ctt.LossFunction):
    """A flat loss of 20 scalars: rho(s) = (c0 + ... + c19) s."""

    def __init__(self):
        for i in range(20):
            setattr(self, f"c{i}", 0.05)

    def evaluate(self, s):
        a = sum(getattr(self, f"c{i}") for i in range(20))
        return a * s, a * torch.ones_like(s), torch.zeros_like(s)


class _Opaque(ctt.LossFunction):
    def __init__(self):
        self.table = np.ones(3)           # an attribute that does not trace

    def evaluate(self, s):
        return s, torch.ones_like(s), torch.zeros_like(s)


@pytest.mark.parametrize("name", list(LOSSES) + ["quat_row_cauchy",
                                                 "many_scalars", "opaque"])
def test_no_kernel_limit_on_the_card_but_an_untraced_loss(name):
    if name == "quat_row_cauchy":
        bal = quaternion_bal()
        prob = ctt.Problem()
        from ceres_tpu_torch.examples.snavely import \
            SnavelyReprojectionErrorWithQuaternions as Q
        cams = [c.copy() for c in bal.cameras]
        pts = [p.copy() for p in bal.points]
        for i in range(bal.num_observations):
            prob.add_residual_block(ctt.AutoDiffCostFunction(
                Q(*bal.observations[i]), 2, [10, 3]),
                ctt.CauchyLoss(2.0 * 1.2 ** (i % 8)),
                cams[bal.camera_index[i]], pts[bal.point_index[i]])
    elif name in ("many_scalars", "opaque"):
        bal = tiny_bal()
        from ceres_tpu_torch.io.bal import build_bal_ceres_problem
        prob = build_bal_ceres_problem(
            bal, loss=_ManyScalars() if name == "many_scalars"
            else _Opaque())[0]
    else:
        prob = loss_problem(ctt, name)
    opts = main_path_options(ctt, device="cuda")
    program = TorchProgram(prob, device="cpu")
    meta = detect_schur_structure(program, opts)
    reason = tsf.unsupported_reason(program, opts, meta)
    if name == "opaque":
        assert isinstance(reason, tsf.KernelLimit) and "item 9" in reason
    else:
        assert reason is None, reason
        assert (program.buckets[0].loss_attrs is not None) == (
            name in ("row_huber", "quat_row_cauchy"))


# ---- K1 and K5 with generated losses and per-lane scalars, on the host ----

def quaternion_row_cauchy(mod=ctt):
    """quaternion_bal's observations under CauchyLoss(2 * 1.2 ** level),
    one a block (Euclidean quaternion blocks)."""
    from importlib import import_module
    snav = import_module(mod.__name__ + ".examples.snavely")
    bal = quaternion_bal()
    cams = [c.copy() for c in bal.cameras]
    pts = [p.copy() for p in bal.points]
    prob = mod.Problem()
    for i in range(bal.num_observations):
        prob.add_residual_block(mod.AutoDiffCostFunction(
            snav.SnavelyReprojectionErrorWithQuaternions(
                *bal.observations[i]), 2, [10, 3]),
            mod.CauchyLoss(2.0 * 1.2 ** int(LEVELS[i])),
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return prob


def fused_step(prob, solver="DENSE_SCHUR"):
    opts = main_path_options(ctt, linear_solver_type=getattr(
        ctt.LinearSolverType, solver))
    tp = TorchProgram.get_cached(prob, opts)
    return tp, tsf.FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))


_LANE_MAIN = r"""
  const int* h = emu_read<int>("hdr", 12);
  const int ne = h[0], k = h[1], kf = h[2], pb = h[3], nchunks = h[4];
  const int nvalid = h[5], first = h[6], entry_id = h[7], nlp = h[8];
  const int lstride = h[9], TE = h[10], TF = h[11];
  const int NQ = TF * (TF + 1) / 2 + TF, ND = 2;
  const size_t rows = (size_t)ne * k, na = (size_t)ne * TE * kf * TF;
  const float* lp = emu_read<float>("lp", nlp > 0 ? nlp : 1);
  const float* lrows = lstride ? emu_read<float>("lrows", rows * lstride)
                               : nullptr;
  const float* xf = emu_read<float>("xf", (size_t)kf * TF);
  const float* xe = emu_read<float>("xe", (size_t)ne * TE);
  const int* cam = emu_read<int>("cam", rows);
  const float* mask = emu_read<float>("mask", rows);
  const float* dat = emu_read<float>("dat", rows * ND);
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
  if (ENTRY(entry_id)(xf, xe, cam, mask, dat, nlp, lstride ? lrows : lp,
                      lstride, se_in, first, 1, ne, k, kf, pb, pos, off,
                      nchunks, ete, ge, se, A, q, partial, ftf, gf, nullptr))
    return 3;
  emu_write("ete", ete, (size_t)ne * TE * TE);
  emu_write("ge", ge, (size_t)ne * TE);
  emu_write("se", se, (size_t)ne * TE);
  emu_write("A", A, na);
  emu_write("ftf", ftf, (size_t)kf * TF * TF);
  emu_write("gf", gf, (size_t)kf * TF);
"""
_LANE_EXE = {}


def _emulated_lanes(tmp_path_factory, key, header, extra, entries, step,
                    x, entry_id, loss, loss_rows, first=True):
    """A lin_auto.cuh entry point (K1's or K5's) on the host with the
    step's chunk inputs at x: `entries` the C++ expression of ENTRY(i)."""
    if key not in _LANE_EXE:
        main = _LANE_MAIN.replace("ENTRY(entry_id)", f"({entries})")
        _LANE_EXE[key] = emu.build(tmp_path_factory.mktemp("lanes"), header,
                                   main, extra)
    from ceres_tpu_torch.ops.jet_compile import loss_structure
    te, tf, ne, kf = step.te, step.tf, step.ne, step.kf
    k = step.cam.shape[1]
    xf = x[step.f_slab:step.f_slab + step.nf].float()
    xe = step.point_state(x).float().contiguous()
    pb, _ = k5.lane_block(k, te, tf)
    lp = loss_structure(loss)[1]
    lstride = 0 if loss_rows is None else loss_rows.shape[-1]
    hdr = [ne, k, kf, pb, step.plan.nchunks, step.plan.nvalid, int(first),
           entry_id, len(lp), lstride, te, tf]
    se_in = torch.ones(ne, te)
    ins = {"hdr": np.array(hdr, np.int32), "lp": np.array(lp, np.float32),
           "xf": xf.numpy(), "xe": xe.numpy(), "cam": step.cam.numpy(),
           "mask": step.mask.numpy(), "dat": step.dat.numpy(),
           "se_in": se_in.numpy(), "pos": step.plan.pos.numpy(),
           "off": step.plan.off.numpy()}
    if loss_rows is not None:
        ins["lrows"] = loss_rows.numpy()
    out = emu.run(_LANE_EXE[key], tmp_path_factory.mktemp("lanesrun"), ins, {
        "ete": (np.float32, ne * te * te), "ge": (np.float32, ne * te),
        "se": (np.float32, ne * te), "A": (np.float32, ne * te * kf * tf),
        "ftf": (np.float32, kf * tf * tf), "gf": (np.float32, kf * tf)})
    shapes = {"ete": (ne, te * te), "ge": (ne, te), "se": (ne, te),
              "A": (ne, te, kf * tf), "ftf": (kf, tf, tf), "gf": (kf, tf)}
    return {key: v.reshape(shapes[key]) for key, v in out.items()}, \
        (xf, xe, se_in)


def _hold(got, want, tol=1e-5):
    for key in want:
        g = np.asarray(got[key])
        assert np.isfinite(g).all(), key
        assert rel(g, want[key].numpy()) <= tol, key


@pytest.mark.parametrize("name", ["scaled", "row_huber"])
def test_k1_generated_and_per_row_losses_on_the_host(tmp_path_factory, name):
    """csrc/lin.cu with a generated loss unit (ceres_lin_gen, the loss
    ScaledLoss(HuberLoss(2.0), 0.5)) and its Huber instance with per-lane
    scalars (LossRow), at the explicit step's chunk inputs of small_bal,
    against lin_plain with the same loss and lanes' scalars."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    tp, step = fused_step(loss_problem(ctt, name, small_bal()))
    assert (step.loss_rows is not None) == (name == "row_huber")
    unit = k1_loss_unit(LOSSES["scaled"](ctt, 0))
    got, (xf, xe, se_in) = _emulated_lanes(
        tmp_path_factory, "k1", emu.source(_cuda.CSRC / "lin.cu"),
        unit.replace('#include "lin_k1.cuh"', ""),
        "entry_id == 0 ? ceres_lin_gen : ceres_lin_huber", step,
        tp.initial_state(), int(name == "row_huber"), step.loss,
        step.loss_rows)
    want = lin_plain(xf, xe, step.cam, step.mask, step.dat[..., 0],
                     step.dat[..., 1], se_in, True, True, step.loss,
                     step.loss_rows)
    _hold(got, want)
    if name == "row_huber":        # the lanes' scalars moved the outputs
        one = lin_plain(xf, xe, step.cam, step.mask, step.dat[..., 0],
                        step.dat[..., 1], se_in, True, True, step.loss)
        assert rel(got["gf"], one["gf"].numpy()) > 1e-3


def test_k5_per_row_loss_on_the_host(tmp_path_factory):
    """csrc/lin_auto.cuh's lane kernel reading each lane's Cauchy scalars
    through LossRow (quaternion cameras, CauchyLoss(2 * 1.2 ** level)) at
    the explicit step's chunk inputs, against lin_auto_plain with the
    lanes' scalars; a masked lane carries its point's first valid
    lane's."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    tp, step = fused_step(quaternion_row_cauchy(), "ITERATIVE_SCHUR")
    assert step.k5 is not None and step.loss_rows is not None
    rows = k5.safe_rows(step._chunks()[0], step._chunks()[1])
    assert np.array_equal(step.loss_rows[..., 1].numpy(), np.float32(
        tp.buckets[0].loss_attrs["c"][rows]))
    chain = k5.chain_source(step.k5, make_loss_spec(step.loss))
    got, (xf, xe, se_in) = _emulated_lanes(
        tmp_path_factory, "k5", (_cuda.CSRC / "lin_auto.cuh").read_text(),
        chain, "lin_auto_launch<Chain>", step, tp.initial_state(), 0,
        step.loss, step.loss_rows)
    want = k5.lin_auto_plain(step.k5, xf, xe, step.cam, step.mask, step.dat,
                             se_in, True, True, step.loss, step.loss_rows)
    _hold(got, want)
    assert make_auto_spec(tp, tp.buckets[0]) is step.k5.auto


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scaled", "composed", "row_huber"])
def test_cuda_k1_generated_and_per_row_match_plain(name):
    """K1 on the card with a generated loss unit or per-lane scalars,
    against lin_plain within 1e-5, its bits repeated. Run on a machine
    with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_tpu_torch.ops.lin import lin
    opts = main_path_options(ctt, device="cuda")
    tp = TorchProgram.get_cached(loss_problem(ctt, name, small_bal()), opts)
    step = tsf.FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))
    x = tp.initial_state()
    xf = x[step.f_slab:step.f_slab + step.nf].float()
    xe = step.point_state(x).float().contiguous()
    se = torch.ones(step.ne, 3, device="cuda")
    gen0 = lin.generated_launches
    got = lin(xf, xe, step.cam, step.mask, step.dat, se, True, True,
              step.loss, step.plan, step.loss_rows)
    again = lin(xf, xe, step.cam, step.mask, step.dat, se, True, True,
                step.loss, step.plan, step.loss_rows)
    want = lin_plain(xf, xe, step.cam, step.mask, step.dat[..., 0],
                     step.dat[..., 1], se, True, True, step.loss,
                     step.loss_rows)
    torch.cuda.synchronize()
    assert (lin.generated_launches > gen0) == (name != "row_huber")
    for key in want:
        assert rel(got[key].cpu().numpy(), want[key].cpu().numpy()) <= 1e-5
        assert torch.equal(got[key], again[key])


@pytest.mark.cuda
def test_cuda_k5_per_row_matches_plain():
    """K5 on the card with per-lane Cauchy scalars against lin_auto_plain
    within 1e-5. Run on a machine with a card: python -m pytest tests -m
    cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    opts = main_path_options(ctt, device="cuda", linear_solver_type=ctt
                             .LinearSolverType.ITERATIVE_SCHUR)
    tp = TorchProgram.get_cached(quaternion_row_cauchy(), opts)
    step = tsf.FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))
    x = tp.initial_state()
    args = (x[step.f_slab:step.f_slab + step.nf].float(),
            step.point_state(x).float().contiguous(), step.cam, step.mask,
            step.dat, torch.ones(step.ne, step.te, device="cuda"))
    got = k5.lin_auto(step.k5, *args, True, True, step.loss, step.plan,
                      step.loss_rows)
    want = k5.lin_auto_plain(step.k5, *args, True, True, step.loss,
                             step.loss_rows)
    torch.cuda.synchronize()
    for key in want:
        assert rel(got[key].cpu().numpy(), want[key].cpu().numpy()) <= 1e-5
