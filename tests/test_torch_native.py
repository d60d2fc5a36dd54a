"""The port's native host library (ceres_tpu_torch/native.py, built from
csrc/ceres_native.cpp into ceres_tpu_torch/_build/) against the JAX
package's (ceres_tpu/native): on the seeded SPD CSC matrices of
tests/test_native.py, the factor, the solve, diag_stats, the RCM and AMD
permutations and scatter_add give the same bits in both (the same source
arithmetic, built with the same flags); a breakdown is reported; a
failed build raises with the compiler's output.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from ceres_tpu import native as jax_native
from ceres_tpu_torch import native


def _random_spd(n, density, seed):
    B = sp.random(n, n, density=density, random_state=seed)
    A = (B @ B.T + sp.eye(n) * n).tocsc()
    A.sort_indices()
    return A


def _ring(n):
    """A ring graph with its diagonal (tests/test_native.py's RCM case)."""
    rows, cols = [], []
    for i in range(n):
        for j in (i, (i + 1) % n):
            rows += [i, j]
            cols += [j, i]
    A = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n, n)).tocsc()
    A.sum_duplicates()
    A.sort_indices()
    return A


MATRICES = {"spd200": (200, 0.03, 0), "spd150": (150, 0.04, 2),
            "spd100": (100, 0.05, 3)}
ORDERINGS = {"natural": 0, "rcm": 1, "amd": 2, "auto": 3}


def test_library_builds_into_the_port():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libceres_native_") and path.exists()
    assert native.library() is native.library()


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("ordering", list(ORDERINGS))
def test_factor_and_solve_match_jax_bits(name, ordering):
    n, density, seed = MATRICES[name]
    A = _random_spd(n, density, seed)
    o = ORDERINGS[ordering]
    ct_ = native.SparseCholesky(n, A.indptr, A.indices, ordering=o)
    cj = jax_native.SparseCholesky(n, A.indptr, A.indices, ordering=o)
    assert ct_.factor_nnz == cj.factor_nnz
    rng = np.random.default_rng(1)
    for scale in (1.0, 3.7):
        assert ct_.factor(A.data * scale) == cj.factor(A.data * scale) == 0
        assert ct_.diag_stats() == cj.diag_stats()
        for _ in range(2):
            b = rng.normal(size=n)
            x = ct_.solve(b)
            assert np.array_equal(x, cj.solve(b))
            np.testing.assert_allclose((A * scale) @ x, b, atol=1e-9)
            out = np.empty(n)
            assert ct_.solve(b, out) is out and np.array_equal(out, x)


@pytest.mark.parametrize("graph", ["spd200", "ring50"])
def test_orderings_match_jax(graph):
    A = _ring(50) if graph == "ring50" else _random_spd(*MATRICES[graph])
    n = A.shape[0]
    for fn, jfn in ((native.rcm_order, jax_native.rcm_order),
                    (native.amd_order, jax_native.amd_order)):
        perm = fn(A.indptr, A.indices, n)
        assert sorted(perm.tolist()) == list(range(n))
        assert np.array_equal(perm, jfn(A.indptr, A.indices, n))


def test_scatter_add_skips_negative_and_matches_jax():
    idx = np.array([0, 2, -1, 2], dtype=np.int64)
    vals = np.array([1.0, 2.0, 100.0, 3.0])
    out = np.zeros(5)
    native.scatter_add(out, idx, vals)
    np.testing.assert_allclose(out, [1.0, 0.0, 5.0, 0.0, 0.0])
    rng = np.random.default_rng(4)
    idx = rng.integers(-1, 50, size=4000).astype(np.int64)
    vals = rng.normal(size=4000)
    a, b = np.zeros(50), np.zeros(50)
    native.scatter_add(a, idx, vals)
    jax_native.scatter_add(b, idx, vals)
    assert np.array_equal(a, b)


def test_breakdown_detected():
    A = sp.eye(10).tolil()
    A[5, 5] = 0.0
    A = A.tocsc()
    A.sort_indices()
    chol = native.SparseCholesky(10, A.indptr, A.indices)
    assert chol.factor(A.data) != 0


def test_diag_stats_rank_policy():
    """The inertia and pivot ratio the covariance rank policy reads: an
    SPD matrix, a near-singular one and an indefinite one."""
    A = _random_spd(100, 0.05, 3)
    chol = native.SparseCholesky(100, A.indptr, A.indices)
    assert chol.factor(A.data) == 0
    dmin, dmax, nneg = chol.diag_stats()
    assert nneg == 0 and dmin > 0 and dmin / dmax > 1e-10
    for value, want_neg in ((1e-18, 0), (-1.0, 1)):
        B = sp.eye(10, format="csc").tolil()
        B[5, 5] = value
        B = B.tocsc()
        B.sort_indices()
        c = native.SparseCholesky(10, B.indptr, B.indices,
                                  ordering=native.SparseCholesky.ORDER_NATURAL)
        assert c.factor(B.data) == 0
        dmin, dmax, nneg = c.diag_stats()
        assert nneg == want_neg
        if want_neg == 0:
            assert dmin / dmax < 1e-14


def test_failed_build_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "ceres_native.cpp"
    bad.write_text(native.SOURCE.read_text().replace(
        "extern \"C\" {", "extern \"C\" { this is not C++;", 1))
    with pytest.raises(RuntimeError, match="building the native library "
                       "failed") as err:
        native.build(bad, tmp_path / "_build")
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_failed_load_raises(tmp_path):
    not_a_library = tmp_path / "libceres_native_x.so"
    not_a_library.write_text("not a shared object")
    with pytest.raises(RuntimeError, match="loading the native library"):
        native.load(not_a_library)
