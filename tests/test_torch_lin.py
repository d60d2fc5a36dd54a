"""K1 (linearize) and K2 (damped elimination) of ceres_tpu_torch: the plain
PyTorch versions against the JAX package's Pallas kernels
(ceres_tpu/ops/pallas_lin.py _lin_kernel, _elim2_kernel) in interpret
mode on the same inputs; and K1's CUDA source (csrc/lin.cu, a hand
Snavely chain through csrc/lin_auto.cuh, with no loss and in its
HuberLoss and CauchyLoss instances) against the plain version (with the
same loss), on the host under tests/cuda_host_emu.py's g++ shim and,
marked `cuda`, on the card.

Tolerance 1e-5 relative to the largest entry: both sides are f32, and the
port sums rows and points in another order than the TPU kernel's lane
reductions (f32 rounding of sums over a few thousand terms); the host
emulation and the card hold the kernel to lin_plain within the same
limit (the kernel rounds each product apart, or contracts it on the
card, where torch's einsums sum in their own order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu

from torch_parity_kit import (ct, ctt, jax_problem, main_path_options,
                              pallas_interpret, rel, small_bal,
                              torch_problem)

from ceres_tpu.ops.pallas_lin import make_pallas_lin
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.ops import lin_auto as k5
from ceres_tpu_torch.ops.lin import (K1_ENTRIES, elim_plain, k1_entry, lin,
                                     lin_plain)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """One JAX Pallas lin bundle (interpret mode) and the port's step on
    the same problem; s_e is a seeded scale for the carried case."""
    bal = small_bal()
    opts_j = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_problem(bal), opts_j)
        plin = make_pallas_lin(jp, opts_j, jax_detect(jp, opts_j))
    opts_t = main_path_options(ctt)
    tp = TorchProgram.get_cached(torch_problem(bal), opts_t)
    step = FusedSchurStep(tp, opts_t, detect_schur_structure(tp, opts_t))
    rng = np.random.default_rng(11)
    s_e = (0.5 + rng.random((step.ne, 3))).astype(np.float32)
    return dict(jp=jp, plin=plin, tp=tp, step=step, s_e=s_e)


def _jax_lin(setup, first):
    plin, ne = setup["plin"], setup["step"].ne
    s_e = np.ones((plin.ne_pad, 3), np.float32)
    s_e[:ne] = setup["s_e"]
    with pallas_interpret():
        out = plin.lin(setup["jp"].initial_state(), jnp.asarray(s_e),
                       jnp.asarray(first))
    return {k: np.asarray(v) for k, v in out.items() if k != "ne_pad"}


def _torch_lin(setup, first):
    step, tp = setup["step"], setup["tp"]
    x = tp.initial_state()
    ne, nf = step.ne, step.nf
    xe = x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    xf = x[step.f_slab:step.f_slab + nf].float()
    return lin_plain(xf, xe, step.cam, step.mask, step.dat[..., 0],
                     step.dat[..., 1], torch.as_tensor(setup["s_e"]), first)


@pytest.mark.parametrize("first", [True, False])
def test_k1_plain_matches_jax_lin_kernel(setup, first):
    ne = setup["step"].ne
    j = _jax_lin(setup, first)
    t = {k: v.numpy() for k, v in _torch_lin(setup, first).items()}
    assert rel(t["ete"].reshape(ne, 3, 3), j["EtE"][:ne]) <= TOL
    assert rel(t["ge"], j["g_e"][:ne]) <= TOL
    assert rel(t["se"], j["s_e"][:ne]) <= TOL
    A_j = j["A_eT"][:, :, :ne].transpose(2, 0, 1)     # -> [ne, 3, nf]
    assert rel(t["A"], A_j) <= TOL
    assert rel(t["ftf"], j["FtF"]) <= TOL
    assert rel(t["gf"], j["g_f"]) <= TOL
    if not first:
        assert np.array_equal(t["se"], setup["s_e"])


def test_k2_plain_matches_jax_elim2_kernel(setup):
    """Inputs from the port's own linearization at x0, padded to the JAX
    kernel's lane layout (pad points: zero Grams and cross terms, unit
    diagonal, so they contribute nothing)."""
    step, plin = setup["step"], setup["plin"]
    ne, nf, pad = step.ne, step.nf, setup["plin"].ne_pad - step.ne
    se0, sf0 = step.initial_scales()
    art = step.linearize(setup["tp"].initial_state(), se0, sf0, True)
    radius = 1e4
    S_t, rhs_t, inv_t, z_t = (v.numpy() for v in elim_plain(
        art.A, art.etes, art.gse, art.diag_e, radius))

    def planes(a, fill=0.0):      # [ne, w] -> [w, ne_pad]
        a = a.numpy().reshape(ne, -1)
        return jnp.asarray(np.concatenate(
            [a, np.full((pad, a.shape[1]), fill, np.float32)]).T)

    A_t = np.concatenate([art.A.numpy(), np.zeros((pad, 3, nf),
                                                  np.float32)])
    with pallas_interpret():
        S_j, rhs_j, inv_j, z_j = plin.elim2(
            jnp.asarray(A_t.transpose(1, 2, 0)), planes(art.etes),
            planes(art.gse), planes(art.diag_e, 1.0),
            jnp.asarray(radius, jnp.float32))
    assert rel(S_t, S_j) <= TOL
    assert rel(rhs_t, rhs_j) <= TOL
    assert rel(inv_t.reshape(ne, 9), np.asarray(inv_j)[:, :ne].T) <= TOL
    assert rel(z_t, np.asarray(z_j)[:, :ne].T) <= TOL


def test_k1_plain_robust_loss_matches_jax_lin_kernel():
    """The plain K1 applies a uniform robust loss (the Triggs corrector)
    per lane, as the TPU kernel's jet-plane corrector does; the CUDA
    kernel refuses a loss until the robust-loss item of ROADMAP.md."""
    bal = small_bal()
    opts_j = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_problem(bal, ct.HuberLoss(1.0)),
                                   opts_j)
        plin = make_pallas_lin(jp, opts_j, jax_detect(jp, opts_j))
        j = plin.lin(jp.initial_state(),
                     jnp.ones((plin.ne_pad, 3), jnp.float32),
                     jnp.asarray(True))
    opts_t = main_path_options(ctt)
    loss = ctt.HuberLoss(1.0)
    tp = TorchProgram.get_cached(torch_problem(bal, loss), opts_t)
    step = FusedSchurStep(tp, opts_t, detect_schur_structure(tp, opts_t))
    x = tp.initial_state()
    ne, nf = step.ne, step.nf
    t = lin_plain(x[step.f_slab:step.f_slab + nf].float(),
                  x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float(),
                  step.cam, step.mask, step.dat[..., 0], step.dat[..., 1],
                  torch.ones(ne, 3), True, loss=loss)
    assert rel(t["ete"].view(ne, 3, 3), np.asarray(j["EtE"])[:ne]) <= TOL
    assert rel(t["ge"], np.asarray(j["g_e"])[:ne]) <= TOL
    assert rel(t["A"], np.asarray(j["A_eT"])[:, :, :ne].transpose(
        2, 0, 1)) <= TOL
    assert rel(t["ftf"], np.asarray(j["FtF"])) <= TOL
    assert rel(t["gf"], np.asarray(j["g_f"])) <= TOL


# ---- K1's CUDA source: seeded inputs, on the host and on the card ----

def test_step_builds_lane_data_and_camera_plan_once(setup, monkeypatch):
    """The Snavely step keeps its lanes' observations as one dat [ne, k, 2]
    f32 tensor (0 on masked lanes) and its camera plan, made once at
    build: linearizing does not make another."""
    step, tp = setup["step"], setup["tp"]
    bk = tp.buckets[0]
    ne, k = step.cam.shape
    assert step.k5 is None and step.dat.shape == (ne, k, 2)
    assert step.dat.dtype == torch.float32 and step.dat.is_contiguous()
    meta = detect_schur_structure(tp, main_path_options(ctt))
    rows, cmask = meta.buckets[0].chunk_rows, meta.buckets[0].chunk_mask
    for j, field in enumerate(("observed_x", "observed_y")):
        want = bk.data[field].numpy().astype(np.float32)[rows] * cmask
        assert np.array_equal(step.dat[..., j].numpy(), want)
    plan = k5.camera_plan(step.cam, step.mask, step.kf)
    assert torch.equal(step.plan.pos, plan.pos)
    assert torch.equal(step.plan.off, plan.off)
    calls = []
    monkeypatch.setattr(k5, "camera_plan",
                        lambda *a: calls.append(a) or plan)
    se0, sf0 = step.initial_scales()
    x = tp.initial_state()
    step.linearize(x, se0, sf0, True)
    step.linearize(x, se0, sf0, False)
    assert calls == []


@pytest.mark.parametrize("first", [True, False], ids=["first", "carried"])
def test_lin_on_the_cpu_with_and_without_a_plan(setup, first):
    """On the CPU, lin is lin_plain whether or not it is given the step's
    camera plan (the plan serves the card's kernel only)."""
    step, tp = setup["step"], setup["tp"]
    x = tp.initial_state()
    ne, nf = step.ne, step.nf
    args = (x[step.f_slab:step.f_slab + nf].float(),
            x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float(),
            step.cam, step.mask, step.dat, torch.as_tensor(setup["s_e"]),
            first)
    with_plan, without = lin(*args, plan=step.plan), lin(*args)
    want = _torch_lin(setup, first)
    for key in want:
        assert torch.equal(with_plan[key], want[key]), key
        assert torch.equal(without[key], want[key]), key


def _snavely_lanes(ne, k, kf, twice, seed):
    """Seeded K1 inputs in the chunk layout: kf cameras (small rotations
    and translations, BAL-like focal length and distortion), ne points
    about 5 units in front of them, each observed on a random count of
    1..k lanes by random cameras (with `twice`, every third point's lane 1
    on lane 0's camera), masked lanes on camera 0 with observation 0 (the
    explicit step's rule), and a carried scale."""
    rng = np.random.default_rng(seed)
    xf = np.concatenate([0.1 * rng.standard_normal((kf, 3)),
                         0.1 * rng.standard_normal((kf, 3)),
                         rng.uniform(400, 600, (kf, 1)),
                         1e-3 * rng.standard_normal((kf, 2))], axis=1)
    xe = rng.standard_normal((ne, 3)) + [0.0, 0.0, -5.0]
    count = rng.integers(1, k + 1, ne)
    mask = (np.arange(k)[None, :] < count[:, None]).astype(np.float32)
    cam = rng.integers(0, kf, (ne, k)).astype(np.int32)
    if twice and k > 1:
        cam[::3, 1] = cam[::3, 0]
        mask[::3, 1] = 1.0
    dat = 100.0 * rng.standard_normal((ne, k, 2))
    cam[mask == 0] = 0
    dat[mask == 0] = 0.0
    se_in = 0.5 + rng.random((ne, 3))
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dt)
                 for a, dt in ((xf.reshape(-1), torch.float32),
                               (xe, torch.float32), (cam, torch.int32),
                               (mask, torch.float32), (dat, torch.float32),
                               (se_in, torch.float32)))


def _plain(args, first, use_scaling=True, loss=None):
    xf, xe, cam, mask, dat, se_in = args
    return lin_plain(xf, xe, cam, mask, dat[..., 0], dat[..., 1], se_in,
                     first, use_scaling, loss)


_K1_MAIN = r"""
  const int* h = emu_read<int>("hdr", 10);
  const int ne = h[0], k = h[1], kf = h[2], pb = h[3], nchunks = h[4];
  const int nvalid = h[5], first = h[6], use_scaling = h[7];
  const int loss = h[8], nlp = h[9];
  const float* lp = emu_read<float>("lp", nlp > 0 ? nlp : 1);
  constexpr int NQ = 54;
  const size_t rows = (size_t)ne * k, na = (size_t)ne * 3 * kf * 9;
  const float* xf = emu_read<float>("xf", (size_t)kf * 9);
  const float* xe = emu_read<float>("xe", (size_t)ne * 3);
  const int* cam = emu_read<int>("cam", rows);
  const float* mask = emu_read<float>("mask", rows);
  const float* dat = emu_read<float>("dat", rows * 2);
  const float* se_in = emu_read<float>("se_in", (size_t)ne * 3);
  const int* pos = emu_read<int>("pos", rows);
  const int* off = emu_read<int>("off", (size_t)nchunks * kf + 1);
  float* ete = emu_alloc<float>((size_t)ne * 9);
  float* ge = emu_alloc<float>((size_t)ne * 3);
  float* se = emu_alloc<float>((size_t)ne * 3);
  float* A = emu_alloc<float>(na);
  float* q = emu_alloc<float>((size_t)nvalid * NQ);
  float* partial = emu_alloc<float>((size_t)nchunks * kf * NQ);
  float* ftf = emu_alloc<float>((size_t)kf * 81);
  float* gf = emu_alloc<float>((size_t)kf * 9);
  auto entry = loss == 1 ? ceres_lin_huber
               : loss == 2 ? ceres_lin_cauchy : ceres_lin;
  if (entry(xf, xe, cam, mask, dat, lp, nlp, se_in, first, use_scaling, ne, k,
            kf, pb, pos, off, nchunks, ete, ge, se, A, q, partial, ftf, gf,
            nullptr))
    return 3;
  emu_write("ete", ete, (size_t)ne * 9);
  emu_write("ge", ge, (size_t)ne * 3);
  emu_write("se", se, (size_t)ne * 3);
  emu_write("A", A, na);
  emu_write("ftf", ftf, (size_t)kf * 81);
  emu_write("gf", gf, (size_t)kf * 9);
"""
_EMU_EXE = []


# the emulated main's loss codes: the entry point of each loss class
_EMU_LOSS = {None: 0, "ceres_lin_huber": 1, "ceres_lin_cauchy": 2}


def _emulated_k1(tmp_path_factory, args, first, use_scaling=True,
                 loss=None):
    """csrc/lin.cu run on the host (tests/cuda_host_emu.py) through the
    entry point of `loss` (ops/lin.py k1_entry: ceres_lin, or its Huber or
    Cauchy instance), with the wrapper's block choice, camera plan and
    loss scalars."""
    from ceres_tpu_torch.ops import _cuda
    if not _EMU_EXE:
        _EMU_EXE.append(emu.build(tmp_path_factory.mktemp("k1emu"),
                                  emu.source(_cuda.CSRC / "lin.cu"),
                                  _K1_MAIN))
    xf, xe, cam, mask, dat, se_in = args
    ne, k = cam.shape
    kf = xf.numel() // 9
    pb, _ = k5.lane_block(k, 3, 9)
    plan = k5.camera_plan(cam, mask, kf)
    entry, lp = k1_entry(loss)
    hdr = [ne, k, kf, pb, plan.nchunks, plan.nvalid, int(first),
           int(use_scaling), _EMU_LOSS.get(entry, 0), len(lp)]
    out = emu.run(_EMU_EXE[0], tmp_path_factory.mktemp("k1run"), {
        "hdr": np.array(hdr, np.int32),
        "lp": np.array(lp or [0.0], np.float32),
        "xf": xf.numpy(), "xe": xe.numpy(),
        "cam": cam.numpy(), "mask": mask.numpy(), "dat": dat.numpy(),
        "se_in": se_in.numpy(), "pos": plan.pos.numpy(),
        "off": plan.off.numpy()}, {
        "ete": (np.float32, ne * 9), "ge": (np.float32, ne * 3),
        "se": (np.float32, ne * 3), "A": (np.float32, ne * 3 * kf * 9),
        "ftf": (np.float32, kf * 81), "gf": (np.float32, kf * 9)})
    shapes = {"ete": (ne, 9), "ge": (ne, 3), "se": (ne, 3),
              "A": (ne, 3, kf * 9), "ftf": (kf, 9, 9), "gf": (kf, 9)}
    return {key: v.reshape(shapes[key]) for key, v in out.items()}


def _hold(got, want):
    for key in want:
        g = np.asarray(got[key].cpu() if torch.is_tensor(got[key])
                       else got[key])
        assert g.shape == tuple(want[key].shape), key
        assert np.isfinite(g).all(), key          # A: every entry written
        assert rel(g, want[key].cpu()) <= TOL, key


# name: (ne, k, kf, a point's lane 1 on its lane 0's camera, use_scaling)
K1_EDGES = {
    "masked": (50, 4, 6, False, True),
    "twice": (45, 4, 6, True, True),
    "kf5-nf-not-4": (40, 4, 5, True, True),
    "k200-past-a-block": (2, 200, 6, True, True),
    "chunks": (300, 4, 6, True, True),
    "no-scaling": (45, 4, 6, True, False),
}


@pytest.mark.parametrize("name", list(K1_EDGES))
def test_k1_kernel_source_on_the_host(tmp_path_factory, name):
    """csrc/lin.cu (K1's Snavely chain through csrc/lin_auto.cuh),
    emulated on the host (one std::thread per CUDA thread), against
    lin_plain within 1e-5 of each output's largest entry, every A entry
    written: masked lanes (camera 0, observation 0), a point with two
    lanes on one camera, nf = 45 (4-byte stores of A), a point on more
    lanes than a block's 128 threads (passes), rows over several 1,024-row
    chunks, scaling off; the scale derived and carried."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    ne, k, kf, twice, use_scaling = K1_EDGES[name]
    args = _snavely_lanes(ne, k, kf, twice, seed=k * 1000 + ne)
    for first in (True, False):
        got = _emulated_k1(tmp_path_factory, args, first, use_scaling)
        want = _plain(args, first, use_scaling)
        _hold(got, want)
        if not first and use_scaling:
            assert np.array_equal(got["se"], args[5].numpy())


# name: (loss, K1_EDGES case); the seeded observations (100 pixels)
# put most lanes past the loss's scale, the small ones below it
K1_LOSSES = {
    "huber-masked": (ctt.HuberLoss(1.0), "masked"),
    "huber-twice-chunks": (ctt.HuberLoss(50.0), "chunks"),
    "huber-no-scaling": (ctt.HuberLoss(80.0), "no-scaling"),
    "cauchy-masked": (ctt.CauchyLoss(1.0), "masked"),
    "cauchy-k200": (ctt.CauchyLoss(50.0), "k200-past-a-block"),
    "cauchy-chunks": (ctt.CauchyLoss(80.0), "chunks"),
}


@pytest.mark.parametrize("name", list(K1_LOSSES))
def test_k1_loss_kernel_source_on_the_host(tmp_path_factory, name):
    """csrc/lin.cu's Huber and Cauchy chains (the Triggs corrector after
    the Snavely residual), emulated on the host, against lin_plain(...,
    loss=) within 1e-5 of each output's largest entry, every A entry
    written and finite (masked lanes too); the scale derived and
    carried."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    loss, edge = K1_LOSSES[name]
    ne, k, kf, twice, use_scaling = K1_EDGES[edge]
    args = _snavely_lanes(ne, k, kf, twice, seed=k * 1000 + ne + 1)
    for first in (True, False):
        got = _emulated_k1(tmp_path_factory, args, first, use_scaling, loss)
        want = _plain(args, first, use_scaling, loss)
        _hold(got, want)
        # the loss moved the outputs: not the no-loss kernel's
        plain_no_loss = _plain(args, first, use_scaling)
        assert rel(got["gf"], plain_no_loss["gf"].numpy()) > 1e-3


def test_k1_entries_cover_the_stock_losses():
    """One K1 instance a stock scalar loss class, with the wrapper's
    scalars in loss_structure order; any other loss raises, naming
    ROADMAP.md item 9."""
    from ceres_tpu_torch.ops import _cuda
    for cls, entry in K1_ENTRIES.items():
        assert _cuda._SIGNATURES[entry] is _cuda._SIGNATURES["ceres_lin"]
        assert f"CERES_LIN_ENTRY({entry}," in (
            _cuda.CSRC / "lin.cu").read_text()
    assert k1_entry(ctt.HuberLoss(2.0)) == ("ceres_lin_huber", [2.0, 4.0])
    assert k1_entry(ctt.CauchyLoss(2.0)) == ("ceres_lin_cauchy",
                                              [4.0, 0.25])
    with pytest.raises(NotImplementedError, match="item 9"):
        k1_entry(ctt.ScaledLoss(ctt.HuberLoss(1.0), 2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K1_LOSSES))
def test_cuda_k1_loss_matches_plain(name):
    """On the card: K1's Huber and Cauchy instances against
    lin_plain(..., loss=) within 1e-5, repeating their bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    loss, edge = K1_LOSSES[name]
    ne, k, kf, twice, use_scaling = K1_EDGES[edge]
    args = [a.cuda() for a in _snavely_lanes(ne, k, kf, twice,
                                             seed=k * 1000 + ne + 1)]
    for first in (True, False):
        got = lin(*args, first, use_scaling, loss)
        again = lin(*args, first, use_scaling, loss)
        torch.cuda.synchronize()
        _hold(got, _plain(args, first, use_scaling, loss))
        for key in got:
            assert torch.equal(got[key], again[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K1_EDGES) + ["bal-16-22106"])
def test_cuda_k1_matches_plain(name):
    """On the card: K1 against lin_plain within 1e-5 at the host test's
    edges and at BAL-16-22106's shape (22,106 points on 4 lanes, 16
    cameras), with the camera plan given and made by the wrapper, one
    launch a call. Run on a machine with a card:
    python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ne, k, kf, twice, use_scaling = K1_EDGES.get(
        name, (22106, 4, 16, True, True))
    args = [a.cuda() for a in _snavely_lanes(ne, k, kf, twice,
                                             seed=k * 1000 + ne)]
    plan = k5.camera_plan(args[2], args[3], kf)
    for first in (True, False):
        lin.launches = 0
        got = lin(*args, first, use_scaling, plan=plan)
        again = lin(*args, first, use_scaling)
        torch.cuda.synchronize()
        assert lin.launches == 2
        _hold(got, _plain(args, first, use_scaling))
        for key in got:                           # a run repeats its bits
            assert torch.equal(got[key], again[key]), key
