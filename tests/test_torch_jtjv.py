"""K8, the CGNR operator J^T (J v), and the block-sparse Jacobian of
ceres_tpu_torch against ceres_tpu: the plain K8 against the JAX package's
Pallas bucket_jtjv (interpret mode on the CPU) at the pose graphs' bucket
shapes; jac_normal_matvec against J^T (J v) by matvec and rmatvec and
against the JAX package's; the transpose-side sums (J^T w, squared column
norms, the block-Jacobi J^T J blocks) against the JAX package's and
against numpy; and, on a card, the CUDA kernel against the plain version
at odd row counts.

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
from ceres_tpu_torch.ops.bsr import ColumnSum, block_diag_jtj
from ceres_tpu_torch.ops.kernels import (bucket_jtjv, bucket_jtjv_plain,
                                         jac_normal_matvec)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram

torch.set_num_threads(1)

# (n, r, t): the SE3 and SE2 main buckets, the SE3 gauge bucket
SHAPES = [(37, 6, 12), (29, 3, 6), (2, 6, 6)]
GRAPHS = {"3d": dict(num_poses=25, seed=4, loop_every=5),
          "2d": dict(num_poses=40, seed=6)}


@pytest.mark.parametrize("n,r,t", SHAPES)
def test_k8_plain_matches_jax_kernel(n, r, t):
    rng = np.random.default_rng(n)
    J = rng.standard_normal((n, r, t)).astype(np.float32)
    vb = rng.standard_normal((n, t)).astype(np.float32)
    want = np.asarray(jax_bucket_jtjv(jnp.asarray(J), jnp.asarray(vb)))
    bucket_jtjv.launches = 0
    got = bucket_jtjv(torch.as_tensor(J), torch.as_tensor(vb))
    assert bucket_jtjv.launches == 0        # plain on CPU tensors
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) < 1e-5
    assert torch.equal(got, bucket_jtjv_plain(torch.as_tensor(J),
                                              torch.as_tensor(vb)))


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
@pytest.mark.parametrize("n", [1, 7, 513])
@pytest.mark.parametrize("r,t", [(6, 12), (3, 6), (6, 6), (20, 5)])
def test_k8_kernel_matches_plain_on_the_card(n, r, t):
    """The CUDA kernel against its plain version on the card. Run on a
    machine with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n * r + t)
    J = torch.as_tensor(rng.standard_normal((n, r, t)),
                        dtype=torch.float32).cuda()
    vb = torch.as_tensor(rng.standard_normal((n, t)),
                         dtype=torch.float32).cuda()
    bucket_jtjv.launches = 0
    got = bucket_jtjv(J, vb)
    want = bucket_jtjv_plain(J, vb)
    torch.cuda.synchronize()
    assert bucket_jtjv.launches == 1
    assert rel(got.cpu().numpy(), want.cpu().numpy()) < 1e-5
