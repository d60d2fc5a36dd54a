"""K9, CGNR's block-Jacobi Grams, on the CPU: the plain per-row version
of ops/kernels.py's bucket_gram_blocks against the JAX package's Pallas
bucket_gram_blocks (_block_outer_kernel) in interpret mode, on
tests/test_pallas_kernels.py's case (n 21, r 3, t 5) and on each slot
view of the 25-pose SE3 graph's scaled Jacobian (the blocks that CGNR's
block Jacobi sums); block_diag_jtj calls the group wrapper once per
tangent-size group with every slot's view, and on the CPU sums the
slots' Grams in the group's order; a CGNR + JACOBI step on that graph
against the JAX step; csrc/gram.cu's group kernel (and the per-row form,
the same kernel on one view with the identity map) on the host under
tests/cuda_host_emu.py against the plain form; and, on a card, the
per-row form against its plain version at odd row counts, on contiguous
tensors and on slot views read in place, and the group kernel against
the per-row form and the group's sums.

Tolerance 1e-6 relative to the largest entry: f32 on both sides, sums of
r products in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu

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
from ceres_tpu_torch.ops import _cuda
from ceres_tpu_torch.ops.kernels import (GRAM_VIEWS, bucket_gram_blocks,
                                         bucket_gram_blocks_plain, gram_sum,
                                         group_gram_blocks,
                                         group_gram_blocks_plain)
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
def slot_graph():
    """The SE3 graph's program and its scaled Jacobian at a perturbed
    state."""
    tp = TorchProgram(_graph(ctt), device="cpu")
    x = tp.initial_state()
    x = x + 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(x.shape[0]))
    _, _, jac, _ = tp.linearize_fn_mixed(x)
    jac = jac.scale_columns(
        1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    return tp, jac


@pytest.fixture(scope="module")
def slot_views(slot_graph):
    """The slot views [n, r, t] of every bucket of the SE3 graph's scaled
    Jacobian at a perturbed state."""
    _, jac = slot_graph
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
    """One linearization of a CGNR + JACOBI step asks K9 once per
    tangent-size group (the SE3 graph's positions and rotations are all
    of tangent size 3: one group), with the views of every variable slot
    of every bucket (the main bucket's four, the gauge bucket's two) in
    that one call, and the step matches the JAX step (as
    tests/test_torch_cgnr.py holds it: the gradient to 1e-5, the model
    cost change, step and step norm to 5e-4, the same CG count)."""
    calls = []

    def counted(views, *maps):
        calls.append([tuple(J.shape) for J in views])
        return group_gram_blocks(views, *maps)

    monkeypatch.setattr(bsr, "group_gram_blocks", counted)
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
    assert len(calls) == len(tp.groups) == 1
    assert len(calls[0]) == n_slots == 6
    b = step.solve(art, RADIUS)
    assert int(b["lin_iters"]) == int(a["lin_iters"]) > 1
    for k in ["gradient_max_norm", "gradient_norm", "model_cost_change",
              "delta", "step_norm"]:
        tol = 1e-5 if k.startswith("gradient") else 5e-4
        assert rel(b[k].numpy(), np.asarray(a[k])) < tol, k


def test_block_diag_jtj_on_the_cpu_is_the_slots_grams_summed(slot_graph):
    """On the CPU block_diag_jtj is the plain form: each slot's per-row
    Grams, summed per block in scatter order (the same bits as a
    ColumnSum over the slots' rows, the order of every other J^T-side
    sum), and launches nothing; block k sums the rows whose slot touches
    it."""
    tp, jac = slot_graph
    group_gram_blocks.launches = bucket_gram_blocks.launches = 0
    got = bsr.block_diag_jtj(jac, tp.groups)
    assert group_gram_blocks.launches == bucket_gram_blocks.launches == 0
    for g, G in zip(tp.groups, got):
        views = [jac.buckets[bi].slot_J(si) for (bi, si, _) in
                 g.bucket_slots]
        ids = np.concatenate([s[2] for s in g.bucket_slots])
        t = g.tangent_size
        col_sum = bsr.ColumnSum(np.arange(ids.size), ids, g.num_blocks,
                                "cpu", unit=(t, t))
        assert torch.equal(G, col_sum([bucket_gram_blocks_plain(J)
                                       for J in views]))
        want = torch.zeros_like(G, dtype=torch.float64)
        for J, (_, _, ids) in zip(views, g.bucket_slots):
            want.index_add_(0, torch.as_tensor(ids),
                            torch.einsum("nrt,nru->ntu", J, J).double())
        assert rel(G.numpy(), want.numpy()) < TOL


def test_group_map_lists_each_blocks_rows_in_scatter_order(slot_graph):
    """gram_order's (gram_map, gram_off) hold the group's order as (slot
    view, row): block k's entries are its rows, slots in bucket_slots'
    order and rows in row order within a slot, the JAX package's
    scatter order; built once."""
    tp, _ = slot_graph
    for g in tp.groups:
        order = g.gram_order("cpu")
        assert g.gram_order("cpu") is order
        gmap, off = order[0].numpy(), order[1].numpy()
        assert order[0].dtype == order[1].dtype == torch.int32
        ids = [s[2] for s in g.bucket_slots]
        assert off[0] == 0 and off[-1] == gmap.shape[0]
        assert np.array_equal(np.diff(off), np.bincount(
            np.concatenate(ids), minlength=g.num_blocks))
        for k in range(g.num_blocks):
            want = [(v, i) for v, b in enumerate(ids)
                    for i in np.flatnonzero(b == k)]
            assert [tuple(e) for e in gmap[off[k]:off[k + 1]]] == want


def test_identity_asks_for_no_grams(monkeypatch):
    """IDENTITY asks K9 for nothing, and no group builds its order."""
    calls = []
    monkeypatch.setattr(
        bsr, "group_gram_blocks",
        lambda views, *maps: calls.append(views)
        or group_gram_blocks(views, *maps))
    monkeypatch.setattr(bsr.GroupMeta, "gram_order",
                        lambda g, device: calls.append(g))
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
    """The per-row form on the card (the group kernel on one view, the
    identity map) against its plain version: a slot view [n, r, t] of J
    [n, r, t_total] at column `off`, read in place, at row counts that
    leave the last block partly empty. Run on a machine with a card:
    python -m pytest tests -m cuda."""
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


# name: ([(n, r, t_total)] buckets, [(bucket, column offset)] slot views,
# t, blocks); every case leaves block 1 with no contribution
GROUP_EDGES = {
    "two-buckets": ([(37, 3, 8), (20, 2, 3)], [(0, 1), (0, 5), (1, 0)],
                    3, 9),
    "nine-views": ([(30, 2, 18)], [(0, 2 * i) for i in range(9)], 2, 12),
    "seventeen-views": ([(12, 2, 34)], [(0, 2 * i) for i in range(17)], 2,
                        6),
    "t1-one-row": ([(1, 4, 2)], [(0, 1)], 1, 3),
}


def _group_case(name, device="cpu"):
    """A seeded tangent-size group (GroupMeta) over strided slot views of
    the case's buckets, block ids drawn so that the blocks' segment
    lengths differ and block 1 has none; returns (group, views,
    buckets)."""
    bucket_shapes, view_at, t, blocks = GROUP_EDGES[name]
    rng = np.random.default_rng(len(view_at) * 100 + blocks)
    buckets = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=device) for shape in bucket_shapes]
    g = bsr.GroupMeta(t, blocks, 0)
    for bi, _ in view_at:
        n = bucket_shapes[bi][0]
        ids = rng.choice([k for k in range(blocks) if k != 1],
                         n).astype(np.int64)
        g.bucket_slots.append((bi, len(g.bucket_slots), ids))
    views = [buckets[bi][:, :, off:off + t] for bi, off in view_at]
    return g, views, buckets


def _in_order(rows, gram_map, gram_off, shape):
    """The per-row Grams rows[v] [n_v, t, t] (float32) summed per block
    in the group's order, one addition at a time from +0 in float32: what
    the group kernel's accumulator does."""
    rows = [np.asarray(R) for R in rows]
    out = np.zeros(shape, np.float32)
    gmap, off = gram_map.numpy(), gram_off.numpy()
    for k in range(shape[0]):
        for v, i in gmap[off[k]:off[k + 1]]:
            out[k] = out[k] + rows[v][i]
    return out


_GRAM_MAIN = r"""
  long* hdr = emu_read<long>("hdr", 5);
  const int nv = hdr[0], num_blocks = hdr[1], t = hdr[2];
  const long nJ = hdr[3], npos = hdr[4];
  float* J = emu_read<float>("J", nJ);
  long* vw = emu_read<long>("vw", 4 * nv);
  int* map = emu_read<int>("map", 2 * npos);
  int* off = emu_read<int>("off", num_blocks + 1);
  std::vector<long> views(4 * nv);
  for (int i = 0; i < nv; ++i) {
    views[4 * i] = (long)(J + vw[4 * i]);
    for (int j = 1; j < 4; ++j) views[4 * i + j] = vw[4 * i + j];
  }
  float* out = emu_alloc<float>((size_t)num_blocks * t * t);
  if (ceres_gram_group(views.data(), nv, map, off, num_blocks, t, out,
                       nullptr))
    return 3;
  emu_write("out", out, (size_t)num_blocks * t * t);
  // the per-row form on each view (ns[v] rows): the identity map
  int* ns = emu_read<int>("ns", nv);
  long total = 0;
  for (int v = 0; v < nv; ++v) total += ns[v];
  float* G = emu_alloc<float>((size_t)total * t * t);
  float* Gv = G;
  for (int v = 0; v < nv; ++v) {
    int* id_map = emu_alloc<int>(2 * (size_t)ns[v]);
    int* id_off = emu_alloc<int>((size_t)ns[v] + 1);
    for (int i = 0; i <= ns[v]; ++i) {
      id_off[i] = i;
      if (i < ns[v]) {
        id_map[2 * i] = 0;
        id_map[2 * i + 1] = i;
      }
    }
    if (ceres_gram_group(&views[4 * v], 1, id_map, id_off, ns[v], t, Gv,
                         nullptr))
      return 4;
    Gv += (size_t)ns[v] * t * t;
  }
  emu_write("G", G, (size_t)total * t * t);
"""
_GRAM_EXE = []


@pytest.mark.parametrize("name", list(GROUP_EDGES))
def test_k9_group_kernel_source_on_the_host(tmp_path_factory, name):
    """csrc/gram.cu emulated on the host (one std::thread per CUDA
    thread): the group kernel through ceres_gram_group against the plain
    block_diag_jtj form (each slot's Grams summed in the group's order,
    gram_sum) within 1e-6 of the largest entry, on strided slot views of
    two buckets, blocks with unequal contribution counts and one with
    none (exact zeros), nine and seventeen views (two and three launches
    of GRAM_VIEWS, each continuing the last one's sums); the per-row form
    on each view against its plain version, and the group's blocks bit
    for bit against those rows summed in the group's order."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    if not _GRAM_EXE:
        _GRAM_EXE.append(emu.build(tmp_path_factory.mktemp("k9emu"),
                                   emu.source(_cuda.CSRC / "gram.cu"),
                                   _GRAM_MAIN))
    g, views, buckets = _group_case(name)
    gmap, goff = g.gram_order("cpu")
    assert len(set(np.diff(goff.numpy()))) > 1 or name == "t1-one-row"
    base = np.cumsum([0] + [b.numel() for b in buckets])
    vw = []
    for (bi, off), J in zip(GROUP_EDGES[name][1], views):
        vw += [base[bi] + off, J.stride(0), J.stride(1), J.shape[1]]
    t, blocks = g.tangent_size, g.num_blocks
    out = emu.run(_GRAM_EXE[0], tmp_path_factory.mktemp("k9run"), {
        "hdr": np.array([len(views), blocks, t, base[-1],
                         gmap.shape[0]], np.int64),
        "J": np.concatenate([b.numpy().ravel() for b in buckets]),
        "vw": np.array(vw, np.int64), "map": gmap.numpy(),
        "off": goff.numpy(),
        "ns": np.array([J.shape[0] for J in views], np.int32)},
        {"out": (np.float32, blocks * t * t),
         "G": (np.float32, sum(J.shape[0] for J in views) * t * t)})
    want = group_gram_blocks_plain(views, gmap, goff)
    got = out["out"].reshape(blocks, t, t)
    assert rel(got, want.numpy()) < TOL
    rows = np.split(out["G"].reshape(-1, t, t),
                    np.cumsum([J.shape[0] for J in views])[:-1])
    for R, J in zip(rows, views):
        assert rel(R, bucket_gram_blocks_plain(J).numpy()) < TOL
    assert np.array_equal(got, _in_order(rows, gmap, goff, got.shape))
    assert np.all(got[1] == 0.0) and np.all(want[1].numpy() == 0.0)
    assert np.array_equal(got, got.transpose(0, 2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GROUP_EDGES) + ["se3-graph"])
def test_k9_group_kernel_matches_per_row_k9_on_the_card(name):
    """On the card: the group kernel (one launch per GRAM_VIEWS views)
    against the per-row form a slot plus gram_sum (CUB's segmented
    reduce) within 1e-6, and bit for bit against the per-row outputs
    summed in the group's order from +0; the same bits on a second call.
    Run on a machine with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if name == "se3-graph":
        tp = TorchProgram(_graph(ctt), device="cuda")
        _, _, jac, _ = tp.linearize_fn_mixed(tp.initial_state())
        g = tp.groups[0]
        views = [jac.buckets[bi].slot_J(si) for (bi, si, _) in
                 g.bucket_slots]
    else:
        g, views, _ = _group_case(name, "cuda")
    gmap, off = g.gram_order("cuda")
    group_gram_blocks.launches = 0
    got = group_gram_blocks(views, gmap, off)
    again = group_gram_blocks(views, gmap, off)
    rows = [bucket_gram_blocks(J) for J in views]
    unfused = gram_sum(rows, gmap, off)
    in_order = _in_order([R.cpu() for R in rows], gmap.cpu(), off.cpu(),
                         got.shape)
    torch.cuda.synchronize()
    assert group_gram_blocks.launches == 2 * -(-len(views) // GRAM_VIEWS)
    assert torch.equal(got, again)
    assert rel(got.cpu().numpy(), unfused.cpu().numpy()) < TOL
    assert np.array_equal(got.cpu().numpy(), in_order)
    with pytest.raises(ValueError, match="group_gram_blocks"):
        group_gram_blocks([J.double() for J in views], gmap, off)
