"""K9, the per-row Gram blocks G_n = J_n^T J_n, on the CPU: the plain
version of ops/kernels.py's bucket_gram_blocks against the JAX package's
Pallas bucket_gram_blocks (_block_outer_kernel) in interpret mode, on
tests/test_pallas_kernels.py's case (n 21, r 3, t 5) and on each slot
view of the 25-pose SE3 graph's scaled Jacobian (the blocks that CGNR's
block Jacobi sums); block_diag_jtj calls the wrapper once per variable
slot of each bucket; a CGNR + JACOBI step on that graph against the JAX
step; and, on a card, the CUDA kernel against its plain version at odd
row counts, on contiguous tensors and on slot views read in place.

Tolerance 1e-6 relative to the largest entry: f32 on both sides, sums of
r products in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt, rel

from ceres_tpu import solver as jax_solver
from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.ops.pallas_kernels import \
    bucket_gram_blocks as jax_gram_blocks
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops.kernels import (bucket_gram_blocks,
                                         bucket_gram_blocks_plain)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import GenericLMStep
from chip_smoke import pose_graph_options

torch.set_num_threads(1)

TOL = 1e-6
GRAPH = dict(num_poses=25, seed=4, loop_every=5)
RADIUS = 1e4


def _graph(mod):
    pkg_slam, pkg_g2o = (jax_slam, jax_g2o) if mod is ct else (slam, g2o)
    poses, constraints, _ = pkg_g2o.synthetic_pose_graph_3d(**GRAPH)
    return pkg_slam.build_pose_graph_3d_problem(poses, constraints)[0]


def _options(mod):
    extra = {"device": "cpu"} if mod is ctt else {}
    return pose_graph_options(
        mod, preconditioner_type=mod.PreconditionerType.JACOBI, **extra)


@pytest.fixture(scope="module")
def slot_views():
    """The slot views [n, r, t] of every bucket of the SE3 graph's scaled
    Jacobian at a perturbed state."""
    tp = TorchProgram(_graph(ctt), device="cpu")
    x = tp.initial_state()
    x = x + 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(x.shape[0]))
    _, _, jac, _ = tp.linearize_fn_mixed(x)
    jac = jac.scale_columns(
        1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    return [(bi, si, b.slot_J(si)) for bi, b in enumerate(jac.buckets)
            for si in range(len(b.cols))]


def test_plain_matches_jax_kernel_on_its_case():
    J = np.random.default_rng(0).standard_normal((21, 3, 5)).astype(
        np.float32)
    want = np.asarray(jax_gram_blocks(jnp.asarray(J), tile_n=8))
    got = bucket_gram_blocks_plain(torch.as_tensor(J))
    assert got.dtype == torch.float32 and got.shape == (21, 5, 5)
    assert rel(got.numpy(), want) < TOL


def test_plain_matches_jax_kernel_on_slot_views(slot_views):
    assert len(slot_views) == 6            # 4 main-bucket slots, 2 gauge
    for bi, si, Js in slot_views:
        assert not Js.is_contiguous() and Js.shape[1:] == (6, 3)
        want = np.asarray(jax_gram_blocks(jnp.asarray(Js.numpy())))
        got = bucket_gram_blocks_plain(Js)
        assert rel(got.numpy(), want) < TOL, (bi, si)


def test_wrapper_takes_the_plain_version_on_cpu(slot_views):
    _, _, Js = slot_views[0]
    bucket_gram_blocks.launches = 0
    got = bucket_gram_blocks(Js)
    assert bucket_gram_blocks.launches == 0
    assert torch.equal(got, bucket_gram_blocks_plain(Js))
    assert torch.equal(got, torch.einsum("nrt,nru->ntu", Js, Js))


def test_block_jacobi_calls_k9_once_per_variable_slot(monkeypatch):
    """One linearization of a CGNR + JACOBI step asks K9 for the Grams of
    every variable slot of every bucket (the main bucket's four, the gauge
    bucket's two), and the step matches the JAX step (as
    tests/test_torch_cgnr.py holds it: the gradient to 1e-5, the model
    cost change, step and step norm to 5e-4, the same CG count)."""
    calls = []

    def counted(J):
        calls.append(tuple(J.shape))
        return bucket_gram_blocks(J)

    monkeypatch.setattr(bsr, "bucket_gram_blocks", counted)
    opts_j = _options(ct)
    jp = JaxProgram.get_cached(_graph(ct), opts_j)
    x0 = jp.initial_state()
    a = jax_solver.make_step_fn(jp, opts_j)(
        x0, jnp.asarray(RADIUS, jp.dtype),
        jax_solver.make_scale_fn(jp, opts_j)(x0))
    opts_t = _options(ctt)
    tp = TorchProgram.get_cached(_graph(ctt), opts_t)
    step = GenericLMStep(tp, opts_t)
    art = step.linearize(tp.initial_state(), *step.initial_scales(),
                         first=True)
    n_slots = sum(sl.variable for bk in tp.buckets for sl in bk.slots)
    assert len(calls) == n_slots == 6
    b = step.solve(art, RADIUS)
    assert int(b["lin_iters"]) == int(a["lin_iters"]) > 1
    for k in ["gradient_max_norm", "gradient_norm", "model_cost_change",
              "delta", "step_norm"]:
        tol = 1e-5 if k.startswith("gradient") else 5e-4
        assert rel(b[k].numpy(), np.asarray(a[k])) < tol, k


def test_identity_asks_for_no_grams(monkeypatch):
    calls = []
    monkeypatch.setattr(bsr, "bucket_gram_blocks",
                        lambda J: calls.append(J) or bucket_gram_blocks(J))
    opts = pose_graph_options(
        ctt, preconditioner_type=ctt.PreconditionerType.IDENTITY,
        device="cpu")
    tp = TorchProgram.get_cached(_graph(ctt), opts)
    step = GenericLMStep(tp, opts)
    step.linearize(tp.initial_state(), *step.initial_scales(), first=True)
    assert calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 513])
@pytest.mark.parametrize("r,t,t_total,off", [(6, 3, 12, 3), (3, 5, 5, 0),
                                             (2, 9, 12, 0), (3, 1, 6, 5)])
def test_k9_kernel_matches_plain_on_the_card(n, r, t, t_total, off):
    """The CUDA kernel against its plain version on the card: a slot
    view [n, r, t] of J [n, r, t_total] at column `off`, read in place,
    at row counts that leave the last block partly empty. Run on a
    machine with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    full = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (n, r, t_total)), dtype=torch.float32, device="cuda")
    J = full[:, :, off:off + t]
    bucket_gram_blocks.launches = 0
    got = bucket_gram_blocks(J)
    want = bucket_gram_blocks_plain(J)
    torch.cuda.synchronize()
    assert bucket_gram_blocks.launches == 1
    assert got.shape == (n, t, t) and got.is_contiguous()
    assert rel(got.cpu().numpy(), want.cpu().numpy()) < TOL
    assert torch.equal(got, got.transpose(1, 2))
