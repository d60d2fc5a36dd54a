"""K8, the CGNR operator J^T (J v), and the block-sparse Jacobian of
ceres_tpu_torch against ceres_tpu: the plain K8, which gathers v itself,
against the JAX package's Pallas bucket_jtjv (interpret mode on the CPU)
on the gathered vector at the pose graphs' bucket shapes, also with rows
that repeat a column and with one row; jac_normal_matvec against J^T (J v) by matvec and rmatvec and
against the JAX package's; the transpose-side sums (J^T w, squared column
norms, the block-Jacobi J^T J blocks) against the JAX package's and
against numpy; and, on a card, the CUDA kernel against the plain version
at odd row counts and widths.

Tolerance 1e-5 relative to the largest entry: f32 on both sides, sums in
another order. The two packages' Jacobians differ by f32 rounding (K11's
plain version against jacfwd), which stays far inside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import rel

from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.ops.bsr import block_diag_jtj as jax_block_diag_jtj
from ceres_tpu.ops.pallas_kernels import bucket_jtjv as jax_bucket_jtjv
from ceres_tpu.ops.pallas_kernels import \
    jac_normal_matvec as jax_jac_normal_matvec
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.ops.bsr import (BlockJacobian, BucketJacobian,
                                     ColumnSum, block_diag_jtj,
                                     column_sum_for)
from ceres_tpu_torch.ops.kernels import (bucket_jtjv, bucket_jtjv_plain,
                                         jac_normal_matvec)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram

torch.set_num_threads(1)

# (n, r, t): the SE3 and SE2 main buckets, the SE3 gauge bucket
SHAPES = [(37, 6, 12), (29, 3, 6), (2, 6, 6)]
GRAPHS = {"3d": dict(num_poses=25, seed=4, loop_every=5),
          "2d": dict(num_poses=40, seed=6)}


def _k8_inputs(n, r, t, seed, repeat=False):
    """Seeded K8 inputs: J [n, r, t], v [3 t + 5] and each row's columns
    cols [n, t] (int32); with `repeat`, every row's second column repeats
    its first."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((n, r, t)).astype(np.float32)
    m = 3 * t + 5
    v = rng.standard_normal(m).astype(np.float32)
    cols = rng.integers(0, m, size=(n, t)).astype(np.int32)
    if repeat and t > 1:
        cols[:, 1] = cols[:, 0]
    return J, v, cols


@pytest.mark.parametrize("n,r,t", SHAPES)
def test_k8_plain_matches_jax_kernel(n, r, t):
    """K8 (which gathers v itself) against the JAX kernel on the gathered
    vector."""
    J, v, cols = _k8_inputs(n, r, t, n)
    want = np.asarray(jax_bucket_jtjv(jnp.asarray(J), jnp.asarray(v[cols])))
    args = tuple(map(torch.as_tensor, (J, v, cols)))
    bucket_jtjv.launches = 0
    got = bucket_jtjv(*args)
    assert bucket_jtjv.launches == 0        # plain on CPU tensors
    assert got.dtype == torch.float32 and got.shape == (n, t)
    assert rel(got.numpy(), want) < 1e-5
    assert torch.equal(got, bucket_jtjv_plain(*args))


@pytest.mark.parametrize("n,r,t", [(1, 6, 12), (1, 3, 6), (1, 1, 1),
                                   (17, 6, 12), (17, 3, 6)])
def test_k8_repeated_columns_and_one_row(n, r, t):
    """A bucket whose rows repeat a column, and a bucket of one row: K8
    against the JAX kernel on the gathered vector, `out` filled in place,
    and jac_normal_matvec over a one-bucket BlockJacobian against its
    two-pass form J^T (J v) by rmatvec and matvec."""
    J, v, cols = _k8_inputs(n, r, t, 100 + n, repeat=True)
    want = np.asarray(jax_bucket_jtjv(jnp.asarray(J), jnp.asarray(v[cols])))
    Jt, vt, ct = map(torch.as_tensor, (J, v, cols))
    out = torch.full((n, t), float("nan"))
    got = bucket_jtjv(Jt, vt, ct, out=out)
    assert got is out and rel(out.numpy(), want) < 1e-5
    cs = column_sum_for([[cols]], vt.numel(), "cpu")
    jac = BlockJacobian([BucketJacobian(Jt, [ct.long()])], vt.numel(), cs)
    got = jac_normal_matvec(jac, vt)
    assert got.shape == vt.shape
    assert rel(got.numpy(), jac.rmatvec(jac.matvec(vt)).numpy()) < 1e-5
    want_cols = np.zeros(vt.numel(), np.float32)
    np.add.at(want_cols, cols.reshape(-1), want.reshape(-1))
    assert rel(got.numpy(), want_cols) < 1e-5


@pytest.fixture(scope="module")
def linearized():
    """Both packages' mixed linearization of each graph at the start."""
    out = {}
    for dim, args in GRAPHS.items():
        gen = f"synthetic_pose_graph_{dim}"
        build = f"build_pose_graph_{dim}_problem"
        jp = JaxProgram(getattr(jax_slam, build)(
            *getattr(jax_g2o, gen)(**args)[:2])[0])
        tp = TorchProgram(getattr(slam, build)(
            *getattr(g2o, gen)(**args)[:2])[0], device="cpu")
        x = np.asarray(jp.initial_state())
        jac_j = jp.linearize_fn_mixed(jnp.asarray(x))[2]
        jac_t = tp.linearize_fn_mixed(tp.state_from_numpy(x))[2]
        v = np.random.default_rng(2).standard_normal(
            tp.num_effective).astype(np.float32)
        out[dim] = dict(jp=jp, tp=tp, jac_j=jac_j, jac_t=jac_t, v=v)
    return out


@pytest.mark.parametrize("dim", list(GRAPHS))
def test_jac_normal_matvec_matches_two_pass_and_jax(linearized, dim):
    g = linearized[dim]
    jac, v = g["jac_t"], torch.as_tensor(g["v"])
    got = jac_normal_matvec(jac, v)
    assert got.dtype == torch.float32 and got.shape == v.shape
    assert rel(got.numpy(), jac.rmatvec(jac.matvec(v)).numpy()) < 1e-5
    want = np.asarray(jax_jac_normal_matvec(g["jac_j"], jnp.asarray(g["v"])))
    assert rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("dim", list(GRAPHS))
def test_transpose_sums_match_jax(linearized, dim):
    """J^T w, the squared column norms and the block-Jacobi blocks: the
    port's fixed-order segment sums against the JAX package's scatters."""
    g = linearized[dim]
    jt, jj = g["jac_t"], g["jac_j"]
    w = [np.random.default_rng(3).standard_normal(b.J.shape[:2]).astype(
        np.float32) for b in jt.buckets]
    from ceres_tpu.ops.bsr import RVec as JaxRVec
    from ceres_tpu_torch.ops.bsr import RVec
    assert rel(jt.rmatvec(RVec([torch.as_tensor(a) for a in w])).numpy(),
               np.asarray(jj.rmatvec(JaxRVec([jnp.asarray(a)
                                              for a in w])))) < 1e-5
    assert rel(jt.squared_column_norms().numpy(),
               np.asarray(jj.squared_column_norms())) < 1e-5
    got = block_diag_jtj(jt, g["tp"].groups)
    want = jax_block_diag_jtj(jj, g["jp"].traced_groups())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert rel(a.numpy(), np.asarray(b)) < 1e-5


def test_column_sum_is_the_scatter_add_in_order():
    """ColumnSum against numpy's unbuffered scatter-add (np.add.at adds
    in list order, as the JAX package's scatter does on the CPU): the
    same bits in f32, and an output with no contribution reads 0."""
    rng = np.random.default_rng(4)
    cols = rng.integers(0, 40, size=300)
    cols[cols == 7] = 8                      # column 7 gets nothing
    vals = (rng.standard_normal(300) * 10.0 ** rng.integers(
        -4, 4, size=300)).astype(np.float32)
    perm = rng.permutation(300)                # positions out of order
    flat = np.empty(300, np.float32)
    flat[perm] = vals
    cs = ColumnSum(perm, cols, 40, "cpu")
    got = cs([torch.as_tensor(flat[:120]), torch.as_tensor(flat[120:])])
    want = np.zeros(40, np.float32)
    np.add.at(want, cols, vals)
    assert np.array_equal(got.numpy(), want) and got[7] == 0
    assert torch.equal(got, cs([torch.as_tensor(flat)]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 513, 2397])
@pytest.mark.parametrize("r,t", [(6, 12), (3, 6), (6, 6), (20, 5), (1, 1),
                                 (32, 40), (4, 33), (2, 17)])
@pytest.mark.parametrize("repeat", [False, True])
def test_k8_kernel_matches_plain_on_the_card(n, r, t, repeat):
    """The CUDA kernel against its plain version on the card, at row
    counts that fill no tile, t past a warp's 32 lanes, and rows that
    repeat a column; into a new tensor and into `out`. Run on a machine
    with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    J, v, cols = (torch.as_tensor(a).cuda()
                  for a in _k8_inputs(n, r, t, n * r + t, repeat))
    bucket_jtjv.launches = 0
    got = bucket_jtjv(J, v, cols)
    out = torch.full((n, t), float("nan"), device="cuda")
    bucket_jtjv(J, v, cols, out=out)
    want = bucket_jtjv_plain(J, v, cols)
    torch.cuda.synchronize()
    assert bucket_jtjv.launches == 2
    assert rel(got.cpu().numpy(), want.cpu().numpy()) < 1e-5
    assert torch.equal(out, got)
