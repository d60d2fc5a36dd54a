"""K2 (damped elimination) and K6 (elimination from a given inverse) of
ceres_tpu_torch: the split-K plan of csrc/elim.cu (ops/lin.py
elim_plan), the plain K2 at the quaternion cameras' width (tf 10)
against the JAX package's _elim2_kernel in interpret mode, and, on a card
only, both kernels against their plain versions.

Tolerance 1e-5 relative to the largest entry: both sides are f32 and sum
the points in another order (the kernel over fixed point ranges, then
the ranges in order; the plain version through cuBLAS or the CPU's
einsum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, jax_quaternion_problem, main_path_options,
                              ctt, pallas_interpret, quaternion_bal, rel,
                              torch_quaternion_problem)

from ceres_tpu.ops.pallas_lin import make_pallas_lin
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.ops.kernels import SMEM_OPTIN
from ceres_tpu_torch.ops.lin import (elim, elim_plain, elim_plan, elim_v1,
                                     elim_v1_plain, spd_inv3)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep

TOL = 1e-5
H100_SMS = 132
SM_SHARED = 233472          # shared memory of one H100 SM (228 KB)


@pytest.mark.parametrize("ne", [1, 255, 22106])
@pytest.mark.parametrize("nf", [144, 1024])
def test_elim_point_ranges_cover_the_points_in_order(ne, nf):
    """Contiguous, ordered, non-overlapping, non-empty, covering [0, ne),
    and no more blocks than two per SM."""
    plan = elim_plan(ne, nf, H100_SMS)
    pts = plan["pts"]
    # split s takes points [s pts, min(ne, (s + 1) pts)) (csrc/elim.cu)
    ranges = [(s * pts, min(ne, (s + 1) * pts))
              for s in range(plan["splits"])]
    assert ranges[0][0] == 0 and ranges[-1][1] == ne
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(n0 < n1 <= n0 + plan["pts"] for n0, n1 in ranges)
    assert plan["splits"] * plan["pairs"] <= max(2 * H100_SMS,
                                                 plan["pairs"])


@pytest.mark.parametrize("nf, R, nt, nacc", [
    (9, 1, 1, 1), (144, 9, 1, 45), (160, 10, 1, 55), (1024, 8, 8, 64)])
def test_elim_plan_tiles_and_shared_memory(nf, R, nt, nacc):
    """One tile up to nf = 160, its upper triangle only (R (R + 1) / 2
    sums a thread); tiles of 128 past it; two blocks fit on one SM; the
    partial sums' shapes."""
    plan = elim_plan(22106, nf, H100_SMS)
    assert (plan["R"], plan["nt"], plan["tri"]) == (R, nt, nt == 1)
    assert plan["pairs"] == nt * (nt + 1) // 2
    assert plan["smem"] <= SMEM_OPTIN
    assert 2 * (plan["smem"] + 1024) <= SM_SHARED
    assert plan["buffers"][2:4] == ((plan["splits"], plan["pairs"], nacc,
                                     256), (plan["splits"], nf))


def test_elim_plan_refuses_an_empty_problem():
    with pytest.raises(ValueError, match="must be >= 1"):
        elim_plan(0, 144, H100_SMS)


def test_k2_plain_matches_jax_elim2_kernel_quaternion_width():
    """The quaternion problem's first linearization (K5's A, tf 10),
    padded to the JAX kernel's lane layout as test_torch_lin.py's
    angle-axis case is."""
    bal = quaternion_bal()
    opts = main_path_options(ctt)
    tp = TorchProgram.get_cached(torch_quaternion_problem(bal), opts)
    step = FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))
    assert step.tf == 10
    opts_j = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_quaternion_problem(bal), opts_j)
        plin = make_pallas_lin(jp, opts_j, jax_detect(jp, opts_j))
    ne, nf, pad = step.ne, step.nf, plin.ne_pad - step.ne
    se0, sf0 = step.initial_scales()
    art = step.linearize(tp.initial_state(), se0, sf0, True)
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


def _ba_inputs(ne, nf, seed=0, k=4):
    """Seeded K2/K6 inputs with BA's sparsity: each point's A touches at
    most k camera blocks (tf 9 or 10 columns wide, else 8), the rest zero;
    SPD point Grams B B^T + 3 I (condition number under ~10, as Jacobi-
    scaled Grams are: with B B^T alone some reach 1e5, and the plain f32
    version itself lands 5e-4 from the f64 result), a positive diagonal,
    and inv, z as the ITERATIVE_SCHUR step forms them at radius 1e4."""
    rng = np.random.default_rng(seed)
    tf = 9 if nf % 9 == 0 else 10 if nf % 10 == 0 else 8
    kf = nf // tf
    A = np.zeros((ne, 3, kf, tf), np.float32)
    for n in range(ne):
        cams = rng.choice(kf, size=min(k, kf), replace=False)
        A[n][:, cams] = rng.standard_normal((3, len(cams), tf))
    B = rng.standard_normal((ne, 3, 3)).astype(np.float32)
    etes = (np.einsum("nij,nkj->nik", B, B)
            + 3 * np.eye(3, dtype=np.float32)).reshape(ne, 9)
    gse = rng.standard_normal((ne, 3)).astype(np.float32)
    diag = (0.5 + rng.random((ne, 3))).astype(np.float32)
    t = [torch.as_tensor(a).cuda() for a in (A.reshape(ne, 3, nf), etes,
                                             gse, diag)]
    rad = torch.tensor(1e4, dtype=torch.float32, device="cuda")
    inv = spd_inv3(t[1].view(ne, 3, 3) + torch.diag_embed(t[3] / rad))
    z = torch.einsum("nij,nj->ni", inv, -t[2])
    return t + [1e4], (t[0], inv.contiguous(), z.contiguous())


SHAPES = [(1, 9), (257, 144), (22106, 144), (22106, 160), (3000, 1024),
          (3000, 1134), (1000, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("ne, nf", SHAPES)
def test_cuda_k2_k6_match_plain_and_repeat_bits(ne, nf):
    """K2 and K6 within 1e-5 of their plain versions on the card, each
    call one launch, and a second call with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k2_args, k6_args = _ba_inputs(ne, nf)
    n2, n6 = elim.launches, elim_v1.launches
    got2, got6 = elim(*k2_args), elim_v1(*k6_args)
    torch.cuda.synchronize()
    assert (elim.launches - n2, elim_v1.launches - n6) == (1, 1)
    for name, got, want in (("K2", got2, elim_plain(*k2_args)),
                            ("K6", got6, elim_v1_plain(*k6_args))):
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(a).all(), (name, i)
            assert rel(a.cpu().numpy(), b.cpu().numpy()) <= TOL, (name, i)
    if nf <= 160:                    # one tile: its upper side mirrored
        assert torch.equal(got2[0], got2[0].T)
    again2, again6 = elim(*k2_args), elim_v1(*k6_args)
    torch.cuda.synchronize()
    for a, b in zip(got2 + got6, again2 + again6):
        assert torch.equal(a, b)
