"""K7 (the whole PCG solve) and K6 (elimination from a given inverse) of
ceres_tpu_torch: the port's conjugate_gradients and dense_pcg_plain
against the JAX package's conjugate_gradients and its Pallas kernel
(ceres_tpu/ops/pallas_pcg.py dense_pcg, interpret mode on the CPU), on the
cases of test_pallas_pcg.py; elim_v1_plain against ceres_tpu/ops/
pallas_lin.py _elim_kernel in interpret mode; csrc/pcg.cu run on the
host under tests/cuda_host_emu.py's g++ shim against dense_pcg_plain;
and, on a card only, the CUDA kernels K6 and K7 against their plain
versions.

Tolerances: CG iteration counts equal; y within rtol 2e-5 / atol 2e-6, as
test_pallas_pcg.py holds the Pallas kernel to the XLA loop (f32 sums in
another order). K6 within 1e-5 relative, as K2.
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
from ceres_tpu.ops.pallas_pcg import dense_pcg as jax_dense_pcg
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.cg import conjugate_gradients as jax_cg
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.ops import _cuda
from ceres_tpu_torch.ops.lin import elim_v1, elim_v1_plain
from ceres_tpu_torch.ops.pcg import dense_pcg, dense_pcg_plain
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers.cg import conjugate_gradients
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep

RADIUS = 1e4
ITERATIVE = dict(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR)


def _spd(rng, m):
    A = rng.standard_normal((m, m))
    return (A @ A.T + m * np.eye(m)).astype(np.float32)


def _case(m, q_tol, tf):
    """test_pallas_pcg.py's inputs: S, b, inverted tf-blocks (or None)."""
    rng = np.random.default_rng(3 if tf else 7)
    S = _spd(rng, m)
    b = rng.standard_normal(m).astype(np.float32)
    if not tf:
        return S, b, None
    kf = m // tf
    blocks = np.stack([S[i * tf:(i + 1) * tf, i * tf:(i + 1) * tf]
                       for i in range(kf)])
    return S, b, np.linalg.inv(blocks)


def _jax_refs(S, b, inv, max_it, q_tol):
    """(JAX cg.py result, JAX Pallas dense_pcg result) on these inputs."""
    m = S.shape[0]
    Sj, bj = jnp.asarray(S), jnp.asarray(b)
    if inv is None:
        prec, Minv = None, np.eye(m, dtype=np.float32)
    else:
        kf, tf, _ = inv.shape

        def prec(v):
            return jnp.sum(jnp.asarray(inv) * v.reshape(kf, 1, tf),
                           axis=-1).reshape(m)
        Minv = np.zeros((m, m), np.float32)
        for i in range(kf):
            Minv[i * tf:(i + 1) * tf, i * tf:(i + 1) * tf] = inv[i]
    ref = jax_cg(lambda v: Sj @ v, bj, jnp.zeros_like(bj),
                 apply_preconditioner=prec, max_iterations=max_it,
                 q_tolerance=q_tol)
    y_k, it_k = jax_dense_pcg(Sj, bj, jnp.asarray(Minv),
                              max_iterations=max_it, q_tolerance=q_tol)
    return ref, (np.asarray(y_k), int(it_k))


@pytest.mark.parametrize("m,q_tol,tf,max_it", [
    (144, 0.1, 8, 60), (144, 0.0, 8, 60), (64, 0.1, 8, 60),
    (296, 0.01, 8, 60), (128, 1e-2, 0, 80)],
    ids=["144-q0.1", "144-q0", "64-q0.1", "296-q0.01", "identity"])
def test_pcg_plain_matches_jax_cg_and_pallas_kernel(m, q_tol, tf, max_it):
    S, b, inv = _case(m, q_tol, tf)
    ref, (y_k, it_k) = _jax_refs(S, b, inv, max_it, q_tol)
    assert it_k == int(ref.num_iterations)
    St, bt = torch.as_tensor(S), torch.as_tensor(b)
    inv_t = None if inv is None else torch.as_tensor(inv)
    res = conjugate_gradients(
        lambda v: St @ v, bt, torch.zeros_like(bt),
        apply_preconditioner=(None if inv is None else lambda v: torch.sum(
            inv_t * v.view(m // tf, 1, tf), dim=-1).view(m)),
        max_iterations=max_it, q_tolerance=q_tol)
    y, it, norm = dense_pcg_plain(St, bt, inv_t, max_iterations=max_it,
                                  q_tolerance=q_tol)
    assert int(res.num_iterations) == int(ref.num_iterations)
    assert int(it) == int(ref.num_iterations) and it.dtype == torch.int32
    for got in (res.x, y):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.x),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got.numpy(), y_k, rtol=2e-5, atol=2e-6)
    assert torch.isfinite(norm)


@pytest.mark.parametrize("kind", ["nan", "indefinite", "max_it_0",
                                  "min_it_3", "reset_every_4"])
def test_cg_guards_match_jax_cg(kind):
    """The guards of cg.py, against the Pallas kernel (which, like K7,
    starts from r0 = b): a NaN or indefinite S stops at the first
    iteration with y = 0; max_iterations = 0 returns y0 = 0;
    min_iterations delays the Q test; the residual refresh at another
    period."""
    rng = np.random.default_rng(5)
    m = 32
    S = _spd(rng, m)
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(max_iterations=40, q_tolerance=0.1)
    if kind == "nan":
        S[3, 5] = np.nan
    elif kind == "indefinite":
        S = -S
    elif kind == "max_it_0":
        kw["max_iterations"] = 0
    elif kind == "min_it_3":
        kw["min_iterations"] = 3
        kw["q_tolerance"] = 0.5
    else:
        kw.update(residual_reset_period=4, q_tolerance=0.0,
                  max_iterations=12)
    y_j, it_j = jax_dense_pcg(jnp.asarray(S), jnp.asarray(b),
                              jnp.eye(m, dtype=jnp.float32), **kw)
    y, it, _ = dense_pcg_plain(torch.as_tensor(S), torch.as_tensor(b), None,
                               **kw)
    assert int(it) == int(it_j)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-5,
                               atol=2e-6)
    if kind in ("nan", "indefinite"):
        assert int(it) == 1 and not torch.any(y != 0)


# csrc/pcg.cu on the host: main() reads the system, runs ceres_pcg and
# writes y, the iteration count, ||r|| and the shared memory the launch
# asked for
_K7_MAIN = r"""
  int* hdr = emu_read<int>("hdr", 5);
  float* q_tol = emu_read<float>("q_tol", 1);
  const int m = hdr[0], tf = hdr[1];
  float* S = emu_read<float>("S", (size_t)m * m);
  float* b = emu_read<float>("b", m);
  float* minv = tf ? emu_read<float>("minv", (size_t)m * tf) : nullptr;
  float* y = emu_alloc<float>(m);
  int* it = emu_alloc<int>(1);
  float* norm = emu_alloc<float>(1);
  if (ceres_pcg(S, b, minv, m, tf ? tf : 1, hdr[2], hdr[3], q_tol[0],
                hdr[4], y, it, norm, nullptr) != 0)
    abort();
  const long used = (long)emu_smem_used;
  emu_write("y", y, m);
  emu_write("it", it, 1);
  emu_write("norm", norm, 1);
  emu_write("smem", &used, 1);
"""
_REG_CAP = "constexpr int REG_CAP = 160;"
_SMEM_M = "constexpr int SMEM_M = 240;"
_K7_EXE = {}
# case -> (m, tf (0: IDENTITY), max_iterations, q_tolerance, what is
# changed): the Q test's stop on SCHUR_JACOBI-like blocks and on
# IDENTITY, a run past the refresh at 10 iterations (14 iterations), a
# NaN in S (stops at iteration 1 with y = 0), max_iterations = 0 (y = 0),
# an odd m (S's bytes not a multiple of 16: no bulk copy), and m 160 (the
# register path's 10-row instantiation; from memory three chunks of rows)
K7_HOST_CASES = {
    "blocks": (64, 8, 60, 0.01, None), "identity": (48, 0, 60, 0.01, None),
    "refresh": (56, 8, 14, 0.0, None), "nan": (48, 8, 40, 0.01, "nan"),
    "max_it_0": (48, 8, 0, 0.01, None), "odd": (63, 0, 60, 0.01, None),
    "m160": (160, 8, 60, 0.01, None)}


@pytest.mark.parametrize("path", ["registers", "shared", "global"])
@pytest.mark.parametrize("case", list(K7_HOST_CASES))
def test_k7_kernel_source_on_the_host(tmp_path_factory, path, case):
    """csrc/pcg.cu emulated on the host (one std::thread per CUDA thread,
    the warp shuffles and the bulk copy through the shim) through
    ceres_pcg, against dense_pcg_plain: equal iteration counts and y
    within 1e-4 relative (the host does not contract to FMA).
    "registers" builds the source as it is, so these m take the register
    path that the main path runs (9 rows of 5 columns a thread, 10 at
    m 160); "shared" builds it with REG_CAP 32, so they take the
    shared-memory path (S brought in by one bulk copy, or copied by the
    threads at an odd m); "global" with REG_CAP and SMEM_M 32, so S is
    read from global memory."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    if path not in _K7_EXE:
        src = emu.source(_cuda.CSRC / "pcg.cu")
        assert _REG_CAP in src
        if path != "registers":
            src = src.replace(_REG_CAP, "constexpr int REG_CAP = 32;")
        if path == "global":
            assert _SMEM_M in src
            src = src.replace(_SMEM_M, "constexpr int SMEM_M = 32;")
        _K7_EXE[path] = emu.build(tmp_path_factory.mktemp(f"k7emu{path}"),
                                  src, _K7_MAIN)
    m, tf, max_it, q_tol, change = K7_HOST_CASES[case]
    S, b, inv = _case(m, q_tol, tf)
    if change == "nan":
        S[3, 5] = np.nan
    reset = 10
    inputs = {"hdr": np.array([m, tf, max_it, 0, reset], np.int32),
              "q_tol": np.array([q_tol], np.float32), "S": S, "b": b}
    if tf:
        inputs["minv"] = inv.astype(np.float32)
    out = emu.run(_K7_EXE[path], tmp_path_factory.mktemp("k7run"), inputs,
                  {"y": (np.float32, m), "it": (np.int32, 1),
                   "norm": (np.float32, 1), "smem": (np.int64, 1)})
    y, it, norm = dense_pcg_plain(
        torch.as_tensor(S), torch.as_tensor(b),
        None if inv is None else torch.as_tensor(inv.astype(np.float32)),
        max_iterations=max_it, q_tolerance=q_tol,
        residual_reset_period=reset)
    assert (int(out["smem"][0]) >= 4 * m * m) == (path == "shared")
    assert int(out["it"][0]) == int(it)
    if change == "nan":
        assert int(it) == 1 and not np.any(out["y"] != 0)
    elif max_it == 0:
        assert int(it) == 0 and not np.any(out["y"] != 0)
        np.testing.assert_allclose(out["norm"], float(norm), rtol=1e-6)
    else:
        assert int(it) == (14 if case == "refresh" else int(it)) > 1
        assert rel(out["y"], y.numpy()) <= 1e-4
        # ||r|| to 1e-4, or to 1e-6 of b where it reaches f32's floor
        np.testing.assert_allclose(out["norm"], float(norm), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(b).max()))


def _iterative_step(device):
    opts = main_path_options(ctt, device=device, **ITERATIVE)
    program = TorchProgram(torch_problem(small_bal()), device=device)
    return FusedSchurStep(program, opts,
                          detect_schur_structure(program, opts))


def test_k6_plain_matches_jax_elim_kernel():
    """K6 on the inv and z of the port's ITERATIVE_SCHUR step at x0,
    padded to the JAX kernel's lane layout (pad points: zero cross terms,
    so they contribute nothing)."""
    bal = small_bal()
    opts_j = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        use_mixed_precision_solves=True)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_problem(bal), opts_j)
        plin = make_pallas_lin(jp, opts_j, jax_detect(jp, opts_j))
    step = _iterative_step("cpu")
    ne, nf, pad = step.ne, step.nf, plin.ne_pad - step.ne
    se0, sf0 = step.initial_scales()
    art = step.linearize(step.program.initial_state(), se0, sf0, True)
    inv, z = step.point_inverse(art, torch.tensor(RADIUS))
    S_t, rhs_t = (v.numpy() for v in elim_v1_plain(art.A, inv, z))

    def planes(a):      # [ne, w] -> [w, ne_pad]
        a = a.numpy().reshape(ne, -1)
        return jnp.asarray(np.concatenate(
            [a, np.zeros((pad, a.shape[1]), np.float32)]).T)

    A_t = np.concatenate([art.A.numpy(), np.zeros((pad, 3, nf),
                                                  np.float32)])
    with pallas_interpret():
        S_j, rhs_j = plin.elim(jnp.asarray(A_t.transpose(1, 2, 0)),
                               planes(inv), planes(z))
    assert rel(S_t, S_j) <= 1e-5
    assert rel(rhs_t, rhs_j) <= 1e-5


@pytest.mark.cuda
def test_cuda_k6_k7_match_plain_versions():
    """K6 and K7 against their plain versions on the card, on the small
    problem's reduced system at RADIUS (K7: equal iteration counts, y
    within 1e-4 relative as in chip_smoke.py). Run on a machine with a
    card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    step = _iterative_step("cuda")
    se0, sf0 = step.initial_scales()
    art = step.linearize(step.program.initial_state(), se0, sf0, True)
    S, rhs, inv, rad = step.reduced_system(art, RADIUS)
    _, z = step.point_inverse(art, rad)
    for a, b in zip(elim_v1(art.A, inv, z), elim_v1_plain(art.A, inv, z)):
        assert rel(a.cpu(), b.cpu()) <= 1e-5
    for minv in (step.precond_inverse(art, S, rad), None):
        kw = step.pcg_args
        y, it, _ = dense_pcg(S, rhs, minv, **kw)
        y_p, it_p, _ = dense_pcg_plain(S, rhs, minv, **kw)
        assert int(it) == int(it_p) > 1
        assert rel(y.cpu(), y_p.cpu()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m,tf,kind", [
    (200, 8, "spd"), (201, 3, "spd"), (296, 8, "spd"), (1024, 8, "spd"),
    (1024, 0, "spd"), (64, 8, "nan"), (64, 0, "max_it_0")])
def test_cuda_k7_other_shapes_and_guards(m, tf, kind):
    """K7 beyond the main path's m = 144 and 160: S in global memory past
    the register path (m = 200, 201 with 3 x 3 blocks, 296 and 1024),
    IDENTITY, a NaN in S (stops at iteration 1 with y = 0) and
    max_iterations = 0 (y = 0, 0 iterations), against the plain version
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, b, inv = _case(m, 0.01, tf)
    if kind == "nan":
        S[3, 5] = np.nan
    kw = dict(max_iterations=0 if kind == "max_it_0" else 100,
              q_tolerance=0.01)
    St, bt = torch.as_tensor(S).cuda(), torch.as_tensor(b).cuda()
    minv = None if inv is None else torch.as_tensor(
        inv.astype(np.float32)).cuda()
    y, it, norm = dense_pcg(St, bt, minv, **kw)
    y_p, it_p, _ = dense_pcg_plain(St, bt, minv, **kw)
    assert int(it) == int(it_p)
    if kind == "spd":
        assert int(it) > 1 and torch.isfinite(norm)
        assert rel(y.cpu(), y_p.cpu()) <= 1e-4
    else:
        assert int(it) == (1 if kind == "nan" else 0)
        assert not torch.any(y != 0)
