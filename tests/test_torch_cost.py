"""K4, the f64 Snavely cost per observation, on the CPU: the plain
version of ops/cost.py against the JAX package's Pallas kernel
(ceres_tpu/ops/pallas_cost.py _cost_kernel, its `sq_planes`: hi + lo in
f64, mapped through the bucket's chunk rows and mask) in interpret mode
on the same state; csrc/cost.cu on the host under tests/cuda_host_emu.py's g++ shim against the plain
version; the step's bound inputs; and, marked `cuda`, the kernel against
the plain version on the card.

Tolerance 1e-12 relative to the largest row: both sides are f64, and
the host rounds each product apart where torch and the card contract
some into fused multiply-adds. The TPU kernel carries double-single f32
pairs (~2^-48 relative on the chip), but in interpret mode XLA's CPU
compiler degrades their error-free transforms to about f32 accuracy
(tests/test_fused_schur.py test_pallas_ds_cost_matches_f64 says so and
holds the total cost to 3e-8): its rows are held to INTERPRET_TOL, 1e-6
of the largest row (3.9e-7 measured here, about three f32 roundings),
and the f64 rows of the JAX package's residual pass to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu

from torch_parity_kit import (ct, ctt, jax_problem, main_path_options,
                              pallas_interpret, rel, small_bal,
                              torch_problem)

from ceres_tpu.ops.pallas_cost import make_pallas_cost
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.ops import _cuda
from ceres_tpu_torch.ops.cost import SnavelyCost, snavely_sq, snavely_sq_plain
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep

TOL = 1e-12
INTERPRET_TOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    """The JAX Pallas cost (interpret mode) and the port's step on the
    small problem, and a perturbed state both packages read."""
    bal = small_bal()
    opts_j = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_problem(bal), opts_j)
        meta = jax_detect(jp, opts_j)
        cost_fn = make_pallas_cost(jp, opts_j, meta)
    opts_t = main_path_options(ctt)
    tp = TorchProgram.get_cached(torch_problem(bal), opts_t)
    step = FusedSchurStep(tp, opts_t, detect_schur_structure(tp, opts_t))
    x0 = np.asarray(jp.initial_state())
    x = x0 * (1.0 + 1e-3 * np.random.default_rng(0).standard_normal(
        x0.shape))
    return dict(jp=jp, meta=meta, cost_fn=cost_fn, step=step, x=x)


def test_plain_matches_jax_cost_kernel(setup):
    """K4's plain rows against the JAX package on the same state: its f64
    residual rows (program.residuals_fn, the function the TPU kernel
    evaluates in double-single) within 1e-12 of the largest row, and
    its Pallas kernel's chunk planes (lane j of point i is bucket row
    chunk_rows[i, j] where chunk_mask[i, j]) within INTERPRET_TOL."""
    cost_fn, jp = setup["cost_fn"], setup["jp"]
    assert cost_fn is not None
    step = setup["step"]
    got = snavely_sq_plain(torch.as_tensor(setup["x"]), step.k4).numpy()
    r = np.asarray(jp.residuals_fn(jnp.asarray(setup["x"])).parts[0])
    assert got.shape == (step.k4.n,) and r.shape == (step.k4.n, 2)
    assert rel(got, np.sum(r * r, axis=1)) <= TOL
    with pallas_interpret():
        hi, lo = jp.jit_with_consts(cost_fn.sq_planes, (jp.example_x(),))(
            jnp.asarray(setup["x"]))
    planes = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    rows, mask = cost_fn.chunk_rows, cost_fn.chunk_mask > 0.5
    assert np.array_equal(np.sort(rows[mask]), np.arange(step.k4.n))
    want = planes[:, :rows.shape[0]].T[mask]
    assert rel(got[rows[mask]], want) <= INTERPRET_TOL


def test_step_binds_the_inputs_once_and_prices_by_k4(setup, monkeypatch):
    """The step binds K4's inputs (bucket row order) at build; its cost
    is the fixed cost plus half the rows' sum, the program's f64 cost."""
    step = setup["step"]
    k4 = step.k4
    assert isinstance(k4, SnavelyCost)
    assert (k4.ne, k4.kf, k4.n) == (step.ne, step.kf, 1500)
    assert k4.pt_idx.dtype == k4.cam_idx.dtype == torch.int32
    x = torch.as_tensor(setup["x"])
    calls = []
    monkeypatch.setattr(
        "ceres_tpu_torch.solvers.schur_fused.snavely_sq",
        lambda x_, c: calls.append(c) or snavely_sq(x_, c))
    cost = step.cost(x)
    assert calls == [k4]
    want = step.program.cost_fn(x)
    assert abs(float(cost) - float(want)) <= TOL * abs(float(want))


def test_wrapper_takes_the_plain_version_on_cpu(setup):
    step = setup["step"]
    x = torch.as_tensor(setup["x"])
    snavely_sq.launches = 0
    got = snavely_sq(x, step.k4)
    assert snavely_sq.launches == 0
    assert torch.equal(got, snavely_sq_plain(x, step.k4))


def test_cuda_x_with_cpu_inputs_raises(setup):
    """A CUDA state with inputs bound on the CPU has no kernel to take it:
    the wrapper raises (no fallback), before touching a device."""
    step = setup["step"]

    class FakeCuda:
        is_cuda = True
        dtype = torch.float64
        shape = (10,)
        device = "cuda"

        def dim(self):
            return 1

        def is_contiguous(self):
            return True

        def numel(self):
            return 10
    with pytest.raises(ValueError, match="snavely_sq"):
        snavely_sq(FakeCuda(), step.k4)


_K4_MAIN = r"""
  int* hdr = emu_read<int>("hdr", 6);
  const int n = hdr[0], kf = hdr[1], nx = hdr[2];
  const long e_slab = hdr[3], f_slab = hdr[4];
  double* x = emu_read<double>("x", nx);
  int* pt = emu_read<int>("pt", n);
  int* cam = emu_read<int>("cam", n);
  double* ox = emu_read<double>("ox", n);
  double* oy = emu_read<double>("oy", n);
  double* sq = emu_alloc<double>(n);
  if (ceres_cost(x, e_slab, f_slab, pt, cam, ox, oy, n, sq, nullptr))
    return 3;
  emu_write("sq", sq, n);
"""
_EMU_EXE = []


def _cost_case(ne, kf, n, seed, small=(), gap=0):
    """A seeded Snavely cost case: state [gap | points | cameras] (BAL
    magnitudes: cameras 10 units back, f ~500, small distortion), rows
    over random points and cameras; the cameras in `small` take the
    small-angle branch (|aa| ~ 1e-7, theta^2 < 1e-12) and camera 0
    the exact zero rotation when listed."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((ne, 3))
    cams = np.zeros((kf, 9))
    cams[:, :3] = 0.3 * rng.standard_normal((kf, 3))
    cams[:, 3:5] = 0.2 * rng.standard_normal((kf, 2))
    cams[:, 5] = -10.0 + rng.standard_normal(kf)
    cams[:, 6] = 500.0 * (1.0 + 0.1 * rng.random(kf))
    cams[:, 7:9] = 1e-3 * rng.standard_normal((kf, 2))
    for c in small:
        cams[c, :3] = 0.0 if c == 0 else 1e-7 * rng.standard_normal(3)
    x = np.concatenate([rng.standard_normal(gap), pts.ravel(),
                        cams.ravel()])
    pt = rng.integers(0, ne, n).astype(np.int32)
    cam = rng.integers(0, kf, n).astype(np.int32)
    cam[:len(small)] = small                  # every small camera seen
    obs = 300.0 * rng.standard_normal((n, 2))
    return SnavelyCost(gap, gap + 3 * ne, ne, kf, torch.as_tensor(pt),
                       torch.as_tensor(cam), torch.as_tensor(obs[:, 0]),
                       torch.as_tensor(obs[:, 1])), torch.as_tensor(x)


# name: (ne, kf, n, small-angle cameras, leading state entries)
K4_EDGES = {
    "rows-over-blocks": (40, 5, 700, (0, 3), 0),
    "many-cameras": (60, 300, 900, (7,), 5),
    "one-row": (1, 1, 1, (), 2),
    "all-small": (20, 4, 300, (0, 1, 2, 3), 0),
}


@pytest.mark.parametrize("name", list(K4_EDGES))
def test_k4_kernel_source_on_the_host(tmp_path_factory, name):
    """csrc/cost.cu emulated on the host (one std::thread per CUDA
    thread) through ceres_cost, against snavely_sq_plain within 1e-12 of
    the largest row: rows over several 256-row blocks, 300 cameras, a
    state with entries before the points, cameras in the small-angle
    branch (the exact zero rotation too)."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    if not _EMU_EXE:
        _EMU_EXE.append(emu.build(tmp_path_factory.mktemp("k4emu"),
                                  emu.source(_cuda.CSRC / "cost.cu"),
                                  _K4_MAIN))
    ne, kf, n, small, gap = K4_EDGES[name]
    cost, x = _cost_case(ne, kf, n, seed=n + kf, small=small, gap=gap)
    hdr = [n, kf, x.numel(), cost.e_slab, cost.f_slab, 0]
    out = emu.run(_EMU_EXE[0], tmp_path_factory.mktemp("k4run"), {
        "hdr": np.array(hdr, np.int32), "x": x.numpy(),
        "pt": cost.pt_idx.numpy(), "cam": cost.cam_idx.numpy(),
        "ox": cost.obsx.numpy(), "oy": cost.obsy.numpy()},
        {"sq": (np.float64, n)})
    want = snavely_sq_plain(x, cost).numpy()
    assert np.isfinite(out["sq"]).all()
    assert rel(out["sq"], want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K4_EDGES) + ["large-case"])
def test_cuda_k4_matches_plain(name):
    """On the card: K4 against snavely_sq_plain within 1e-12 at the host
    test's edges and at the large case's shape (200,000 points, 1,024
    cameras, 1M rows), one launch a call, the same bits on a second
    call. Run on a machine with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ne, kf, n, small, gap = K4_EDGES.get(
        name, (200000, 1024, 1000000, (0, 5), 0))
    cost, x = _cost_case(ne, kf, n, seed=n + kf, small=small, gap=gap)
    cost = SnavelyCost(cost.e_slab, cost.f_slab, ne, kf,
                       *(t.cuda() for t in (cost.pt_idx, cost.cam_idx,
                                            cost.obsx, cost.obsy)))
    x = x.cuda()
    snavely_sq.launches = 0
    got = snavely_sq(x, cost)
    again = snavely_sq(x, cost)
    torch.cuda.synchronize()
    assert snavely_sq.launches == 2
    assert torch.equal(got, again)
    assert rel(got.cpu(), snavely_sq_plain(x, cost).cpu()) <= TOL
    with pytest.raises(ValueError, match="snavely_sq"):
        snavely_sq(x.float(), cost)
