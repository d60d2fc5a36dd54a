"""The Schur operations of ceres_tpu_torch (solvers/schur.py SchurOps)
against ceres_tpu's SchurOps on the same f64 Jacobian and damping.

The problem (torch_parity_kit.schur_problem) has five buckets: the
Snavely blocks (chunk layout in the JAX package), the observations of a
constant camera (an e-only bucket), a HuberLoss bucket that observes a
quarter of the (camera, point) pairs again and one point forty-odd times
(observation order in the JAX package: past its padding guard), that
bucket's constant-camera rows, and a prior on five cameras (an f-only
bucket). Every output within 1e-12 relative: explicit S and its rhs,
the reduced rhs, the back-substitution, apply_S, E, E^T, F, F^T, esolve
and each ported preconditioner's apply.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity_kit import (ct, ctt, rel, schur_bal, schur_problem)

from ceres_tpu.ops.bsr import RVec as JaxRVec
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.schur import SchurOps as JaxOps
from ceres_tpu.solvers.schur import make_schur_solver
from ceres_tpu.solvers.schur import \
    detect_schur_structure as jax_detect
from ceres_tpu_torch.ops.bsr import RVec
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers.schur import (SchurOps, SchurSystem,
                                           cluster_masks,
                                           detect_schur_structure)

TOL = 1e-12


@pytest.fixture(scope="module")
def pair():
    """(JAX ops as a function of one traced call, port ops, seeded
    inputs) on the problem's Jacobian at its start, D = 0.5 + a seeded
    uniform [0, 1). The JAX side runs under jax.jit (eagerly, its
    linearize alone takes ~20 s here)."""
    bal = schur_bal()
    jprog = JaxProgram(schur_problem(ct, bal)[0])
    tprog = TorchProgram(schur_problem(ctt, bal)[0], device="cpu")
    jmeta = jax_detect(jprog, ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR))
    tmeta = detect_schur_structure(tprog, ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR, device="cpu"))
    assert np.array_equal(jmeta.e_cols, tmeta.e_cols)
    assert np.array_equal(jmeta.f_global_cols, tmeta.f_global_cols)
    # the layouts this file covers, as the JAX package sees them
    kinds = {(bs.e_slot is not None, bs.f_cols is not None,
              bs.chunk_rows is not None) for bs in jmeta.buckets}
    assert kinds == {(True, True, True), (True, True, False),
                     (True, False, True), (False, True, False)}
    jjac = jax.jit(jprog.linearize_fn)(jprog.initial_state())[2]
    tjac = tprog.linearize_fn(tprog.initial_state())[2]
    rng = np.random.default_rng(11)
    D = 0.5 + rng.random(tprog.num_effective)
    D_j = jnp.asarray(D)

    def jops(fn):
        return jax.jit(lambda jac, D_: fn(JaxOps(jmeta, jac, D_)))(jjac, D_j)
    tops = SchurOps(SchurSystem(tmeta, tjac), torch.as_tensor(D))
    ins = dict(
        v=rng.standard_normal(tmeta.nf),
        b_e=rng.standard_normal((tmeta.ne, tmeta.te)),
        b_f=rng.standard_normal(tmeta.nf),
        y=rng.standard_normal(tmeta.nf),
        w=[rng.standard_normal(tuple(b.J.shape[:2])) for b in tjac.buckets],
        programs=(jprog, jmeta, tprog, tmeta))
    return jops, tops, ins


def _t(x):
    return torch.as_tensor(x)


def _j(x):
    return jnp.asarray(x)


CASES = {
    "explicit_S": lambda ops, c, i: ops.explicit_S(),
    "explicit_S_rhs": lambda ops, c, i: ops.explicit_S_and_rhs(
        c(i["b_e"]), c(i["b_f"]))[1],
    "rhs": lambda ops, c, i: ops.rhs(c(i["b_e"]), c(i["b_f"])),
    "back_substitute": lambda ops, c, i: ops.back_substitute(
        c(i["b_e"]), c(i["y"])),
    "apply_S": lambda ops, c, i: ops.apply_S(c(i["v"])),
    "esolve": lambda ops, c, i: ops.esolve(c(i["b_e"])),
    "F_apply": lambda ops, c, i: ops.F_apply(c(i["v"])).parts,
    "E_apply": lambda ops, c, i: ops.E_apply(c(i["b_e"])).parts,
    "Ft_apply": lambda ops, c, i: ops.Ft_apply(
        (RVec if c is _t else JaxRVec)([c(p) for p in i["w"]])),
    "Et_apply": lambda ops, c, i: ops.Et_apply(
        (RVec if c is _t else JaxRVec)([c(p) for p in i["w"]])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_schur_ops_match(pair, name):
    jops, tops, ins = pair
    got = CASES[name](tops, _t, ins)
    want = jops(lambda ops: CASES[name](ops, _j, ins))
    if isinstance(got, (list, tuple)):
        for g, w in zip(got, want):
            assert rel(g.numpy(), np.asarray(w)) <= TOL
    else:
        assert got.dtype == torch.float64
        assert rel(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("kind", ["IDENTITY", "JACOBI", "SCHUR_JACOBI",
                                  "SCHUR_POWER_SERIES_EXPANSION"])
def test_preconditioners_match(pair, kind):
    """Each ported ITERATIVE_SCHUR preconditioner's apply on a seeded v
    (IDENTITY: the port passes no preconditioner, the JAX package the
    identity)."""
    jops, tops, ins = pair
    apply = tops.make_preconditioner(getattr(ctt.PreconditionerType, kind))
    got = ins["v"] if apply is None else apply(_t(ins["v"])).numpy()
    want = jops(lambda ops: ops.make_preconditioner(
        getattr(ct.PreconditionerType, kind))(_j(ins["v"])))
    assert rel(got, np.asarray(want)) <= TOL


@pytest.mark.parametrize("kind", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
def test_cluster_preconditioners_raise(pair, kind):
    """The visibility-based preconditioners, which raised naming their
    ROADMAP.md items (36, 21) until this slice (the cases keep their
    ids): S restricted to the camera clusters' pattern (and the spanning
    forest's, TRIDIAGONAL), factored densely, its apply on a seeded v
    against the JAX package's, whose masks make_schur_solver builds (reset
    first: the JAX meta keeps the first kind's masks)."""
    jops, tops, ins = pair
    jprog, jmeta, program, meta = ins["programs"]
    jmeta.cluster_mask = None
    jkind = getattr(ct.PreconditionerType, kind)
    make_schur_solver(jprog, ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=jkind))
    masks = cluster_masks(program, meta, getattr(ctt.PreconditionerType,
                                                 kind), "CANONICAL_VIEWS",
                          "cpu")
    assert np.array_equal(masks[0].numpy(), jmeta.cluster_mask > 0)
    assert np.array_equal(masks[1].numpy(), jmeta.cluster_mask_diag > 0)
    apply = tops.make_preconditioner(getattr(ctt.PreconditionerType, kind),
                                     masks)
    want = jops(lambda ops: ops.make_preconditioner(jkind)(_j(ins["v"])))
    assert rel(apply(_t(ins["v"])).numpy(), np.asarray(want)) <= TOL


def test_block_diag_blocks_match(pair):
    """SCHUR_JACOBI's blocks themselves (the diagonal blocks of S, with
    each row's cross terms), before their inversion."""
    jops, tops, _ = pair
    for (jc, jb), (tc, tb) in zip(jops(lambda ops: ops._block_diag_S(True)),
                                  tops.block_diag_S(True)):
        assert np.array_equal(np.asarray(jc), tc.numpy())
        assert rel(tb.numpy(), np.asarray(jb)) <= TOL
