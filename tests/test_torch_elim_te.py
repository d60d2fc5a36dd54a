"""K2 and K6 (csrc/elim.cuh) at every point size the JAX package's Pallas
kernels take, and the explicit fused step past te = 3.

- The plain K2 (ops/lin.py elim_plain: the closed-form damped inverse)
  at te 1 and 2 against the JAX package's _elim2_kernel, and the plain
  K6 (elim_v1_plain) at te 4 and 6 against its _elim_kernel, both run in
  interpret mode on one seeded shape each (ne 200 padded to 256, nf 18):
  within 1e-5 relative to the largest entry (both f32, other summation
  orders).
- the kernel sources (csrc/elim.cu, elim.cuh and the six elim_te<N>.cu
  units), built once with the host g++ under
  tests/cuda_host_emu.py's shim: K2 at te 1, 2 and 3 and K6 at te 1, 2,
  4, 5 and 6 against the plain versions, within 1e-5 (the host's f32
  arithmetic without FMA contraction, another summation order); K2's
  inverse and z to 1e-6.
- Whole solves on the explicit fused step at te 1 and 2 (K2), 4 and 5
  (K6): DENSE_SCHUR (and ITERATIVE_SCHUR at te 2 and 4), mixed, on
  tests/torch_parity_kit.py's point_problem, against
  ceres_tpu.solve on the CPU over five LM iterations (rejected steps,
  then accepted ones): the same LM counts and the final cost within 1e-5
  relative, 5e-4 for DENSE_SCHUR at te 4, where each homogeneous
  point's scale direction is a null space of its block that the damping
  alone closes, so the f32 rounding of the two packages' Cholesky
  factors moves the step by ~1e-4 after two accepted steps, and 1e-4 at
  te 1 (8 cameras): its reduced camera matrix is ill-conditioned in f32,
  so both packages' mixed steps part from their common f64 step (JAX's
  by 5e-6, the port's K3 by 3.9e-5 after five iterations; with 4
  cameras 1.2e-4 and 3.2e-4) while their f64 steps agree to 2e-13.
- On a card only (cuda-marked): both kernels against their plain versions
  at te 1 to 6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu
from torch_parity_kit import ct, ctt, point_problem, rel

from ceres_tpu.ops.pallas_lin import _elim2_kernel, _elim_kernel
from ceres_tpu_torch.ops import _cuda
from ceres_tpu_torch.ops.lin import (elim, elim_plain, elim_plan, elim_v1,
                                     elim_v1_plain)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import takes_fused_schur_step

TOL = 1e-5
NE, NE_PAD, TILE, NF = 200, 256, 128, 18
EMU_SMS = 2                       # the emulated card's SMs


def inputs(te, ne=NE, nf=NF, seed=0):
    """Seeded K2/K6 inputs: A [ne, te, nf], SPD point Grams B B^T + 3 I,
    gradients, a positive diagonal, and inv, z at radius 1e4 (f32)."""
    rng = np.random.default_rng(seed + te)
    A = rng.standard_normal((ne, te, nf)).astype(np.float32)
    B = rng.standard_normal((ne, te, te)).astype(np.float32)
    etes = (B @ B.transpose(0, 2, 1)
            + 3 * np.eye(te, dtype=np.float32)).reshape(ne, te * te)
    gse = rng.standard_normal((ne, te)).astype(np.float32)
    diag = (0.5 + rng.random((ne, te))).astype(np.float32)
    M = etes.reshape(ne, te, te) + np.einsum(
        "ni,ij->nij", diag / np.float32(1e4), np.eye(te, dtype=np.float32))
    inv = np.linalg.inv(M.astype(np.float64)).astype(np.float32)
    z = np.einsum("nij,nj->ni", inv, -gse).astype(np.float32)
    return dict(A=A, etes=etes, gse=gse, diag=diag, inv=inv, z=z)


def jax_elim(te, d, k2):
    """The JAX package's ELIM kernel (K2: _elim2_kernel, K6:
    _elim_kernel) in interpret mode, with pallas_lin.py's block specs, on
    the planes of `d` padded to NE_PAD points."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    pad = NE_PAD - NE

    def planes(a, fill=0.0):
        a = a.reshape(NE, -1)
        return jnp.asarray(np.concatenate(
            [a, np.full((pad, a.shape[1]), fill, np.float32)]).T)

    def bspec(shape, imap):
        return pl.BlockSpec(shape, imap, memory_space=pltpu.VMEM)

    acc = [bspec((NF, NF), lambda i: (0, 0)), bspec((NF, 1), lambda i: (0, 0))]
    a_t = jnp.asarray(np.concatenate(
        [d["A"], np.zeros((pad, te, NF), np.float32)]).transpose(1, 2, 0))
    a_spec = bspec((te, NF, TILE), lambda i: (0, 0, i))
    sq, vec = (bspec((te * te, TILE), lambda i: (0, i)),
               bspec((te, TILE), lambda i: (0, i)))
    shapes = [jax.ShapeDtypeStruct((NF, NF), jnp.float32),
              jax.ShapeDtypeStruct((NF, 1), jnp.float32)]
    with jax.enable_x64(False):
        if k2:
            call = pl.pallas_call(
                functools.partial(_elim2_kernel, te=te, nf=NF),
                grid=(NE_PAD // TILE,),
                in_specs=[a_spec, sq, vec, vec, pl.BlockSpec(
                    (1,), lambda i: (0,), memory_space=pltpu.SMEM)],
                out_specs=acc + [sq, vec],
                out_shape=shapes + [
                    jax.ShapeDtypeStruct((te * te, NE_PAD), jnp.float32),
                    jax.ShapeDtypeStruct((te, NE_PAD), jnp.float32)],
                interpret=True)
            S, rhs, inv, z = call(a_t, planes(d["etes"]), planes(d["gse"]),
                                  planes(d["diag"], 1.0),
                                  jnp.asarray([1e4], jnp.float32))
            return (np.asarray(S), np.asarray(rhs)[:, 0],
                    np.asarray(inv)[:, :NE].T.reshape(NE, te, te),
                    np.asarray(z)[:, :NE].T)
        call = pl.pallas_call(
            functools.partial(_elim_kernel, te=te, nf=NF),
            grid=(NE_PAD // TILE,), in_specs=[a_spec, sq, vec],
            out_specs=acc, out_shape=shapes, interpret=True)
        S, rhs = call(a_t, planes(d["inv"]), planes(d["z"]))
        return np.asarray(S), np.asarray(rhs)[:, 0]


@pytest.mark.parametrize("te, k2", [(1, True), (2, True), (4, False),
                                    (6, False)])
def test_plain_matches_jax_elim_kernels(te, k2):
    d = inputs(te)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    want = jax_elim(te, d, k2)
    got = (elim_plain(t["A"], t["etes"], t["gse"], t["diag"], 1e4) if k2
           else elim_v1_plain(t["A"], t["inv"], t["z"]))
    for name, g, w in zip(("S_corr", "rhs", "inv", "z"), got, want):
        assert rel(g.numpy(), w) <= TOL, (te, name)


EMU_BODY = r'''
  int* cfg = emu_read<int>("cfg", 9);
  const int k2 = cfg[0], te = cfg[1], ne = cfg[2], nf = cfg[3], R = cfg[4];
  const int nt = cfg[5], splits = cfg[6], pts = cfg[7], smem = cfg[8];
  const int pairs = nt * (nt + 1) / 2;
  const int nacc = nt == 1 ? R * (R + 1) / 2 : R * R;
  float* A = emu_read<float>("A", (size_t)ne * te * nf);
  float* p0 = emu_read<float>("p0", (size_t)ne * te * te);
  float* p1 = emu_read<float>("p1", (size_t)ne * te);
  float* p2 = emu_read<float>("p2", (size_t)ne * te);
  float* S = emu_alloc<float>((size_t)nf * nf);
  float* rhs = emu_alloc<float>(nf);
  float* inv = emu_alloc<float>((size_t)ne * te * te);
  float* z = emu_alloc<float>((size_t)ne * te);
  float* part = emu_alloc<float>((size_t)splits * pairs * nacc * 256);
  float* rpart = emu_alloc<float>((size_t)splits * nf);
  const int err =
      k2 ? ceres_elim(A, p0, p1, p2, 1e4f, te, ne, nf, R, nt, splits, pts,
                      smem, S, rhs, inv, z, part, rpart, nullptr)
         : ceres_elim_v1(A, p0, p1, te, ne, nf, R, nt, splits, pts, smem, S,
                         rhs, part, rpart, nullptr);
  if (err) return 2;
  emu_write("S", S, (size_t)nf * nf);
  emu_write("rhs", rhs, nf);
  emu_write("inv", inv, (size_t)ne * te * te);
  emu_write("z", z, (size_t)ne * te);
'''


@pytest.fixture(scope="module")
def elim_emu(tmp_path_factory):
    """csrc/elim.cu and its six point-size units built once, as one
    program, with the host g++ under the shim."""
    if emu.gxx() is None:
        pytest.skip("needs the host g++")
    path = tmp_path_factory.mktemp("elim_emu")
    seen = set()
    text = "".join(emu.source(_cuda.CSRC / name, seen) for name in
                   ["elim.cu"] + [f"elim_te{t}.cu" for t in range(1, 7)])
    return path, emu.build(path, text, EMU_BODY)


@pytest.mark.parametrize("te, k2", [(1, True), (2, True), (3, True),
                                    (1, False), (2, False), (4, False),
                                    (5, False), (6, False)])
def test_host_elim_cu_matches_plain(elim_emu, te, k2):
    """The kernel source at te 1-3 (K2) and 1-6 (K6), one tile (nf 18),
    several point ranges, against the plain versions."""
    path, exe = elim_emu
    ne = 37
    d = inputs(te, ne=ne)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    plan = elim_plan(ne, NF, EMU_SMS, te)
    assert plan["splits"] > 1
    cfg = np.array([int(k2), te, ne, NF, plan["R"], plan["nt"],
                    plan["splits"], plan["pts"], plan["smem"]], np.int32)
    p = ((d["etes"], d["gse"], d["diag"]) if k2
         else (d["inv"], d["z"], d["diag"]))
    got = emu.run(exe, path, dict(cfg=cfg, A=d["A"], p0=p[0], p1=p[1],
                                  p2=p[2]),
                  {"S": (np.float32, NF * NF), "rhs": (np.float32, NF),
                   "inv": (np.float32, ne * te * te),
                   "z": (np.float32, ne * te)})
    if k2:
        S, rhs, inv, z = elim_plain(t["A"], t["etes"], t["gse"], t["diag"],
                                    1e4)
        assert rel(got["inv"], inv.numpy().reshape(-1)) <= 1e-6
        assert rel(got["z"], z.numpy().reshape(-1)) <= 1e-6
    else:
        S, rhs = elim_v1_plain(t["A"], t["inv"], t["z"])
    assert rel(got["S"], S.numpy().reshape(-1)) <= TOL
    assert rel(got["rhs"], rhs.numpy()) <= TOL


def te_options(mod, solver, **extra):
    kw = dict(device="cpu") if mod is ctt else {}
    return mod.SolverOptions(
        linear_solver_type=getattr(mod.LinearSolverType, solver),
        preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
        use_mixed_precision_solves=True, fused_iterations=True,
        max_num_iterations=5, **kw, **extra)


@pytest.mark.parametrize("te, solver, tol, cameras", [
    (1, "DENSE_SCHUR", 1e-4, 8), (2, "DENSE_SCHUR", 1e-5, 4),
    (2, "ITERATIVE_SCHUR", 1e-5, 4), (4, "DENSE_SCHUR", 5e-4, 4),
    (4, "ITERATIVE_SCHUR", 1e-5, 4), (5, "DENSE_SCHUR", 1e-5, 4)])
def test_point_size_solve_matches_jax(te, solver, tol, cameras):
    """The explicit fused step at te 1 and 2 (K2 eliminates DENSE_SCHUR)
    and te 4 and 5 (K6 after the PyTorch inverse) against the JAX fused
    step."""
    s_j = ct.solve(te_options(ct, solver),
                   point_problem(ct, te, cameras=cameras))
    prob = point_problem(ctt, te, cameras=cameras)
    opts = te_options(ctt, solver)
    program = TorchProgram.get_cached(prob, opts)
    assert takes_fused_schur_step(program, opts)
    s_t = ctt.solve(opts, prob)
    elim_kernel = "K2" if te <= 3 and solver == "DENSE_SCHUR" else "K6"
    assert f"linearize K5, eliminate {elim_kernel}" in s_t.message
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= tol * s_j.final_cost


@pytest.mark.cuda
@pytest.mark.parametrize("te", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("nf", [18, 144, 300])
def test_cuda_elim_at_point_size(te, nf):
    """On the card: K2 (te <= 3) and K6 within 1e-5 of their plain
    versions, one launch a call, the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = inputs(te, ne=5000, nf=nf)
    t = {k: torch.as_tensor(v).cuda() for k, v in d.items()}
    calls = [(elim_v1, elim_v1_plain, (t["A"], t["inv"], t["z"]))]
    if te <= 3:
        calls.append((elim, elim_plain,
                      (t["A"], t["etes"], t["gse"], t["diag"], 1e4)))
    for kernel, plain, args in calls:
        n0 = kernel.launches
        got = kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1
        for a, b in zip(got, plain(*args)):
            assert rel(a.cpu().numpy(), b.cpu().numpy()) <= TOL
        for a, b in zip(got, kernel(*args)):
            assert torch.equal(a, b)
