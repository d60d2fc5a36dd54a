"""K11, the bucket-linearize kernel, against ceres_tpu: the plain version
of ops/linearize.py against the JAX package's Pallas kernel
(make_pallas_bucket_linearize) in interpret mode on the graphs of
tests/test_pallas_linearize.py (SE3: 25 poses; SE2: 40 poses) and on the
Snavely bucket of a small BA problem (the JAX kernel with its jet
compiler's auto spec), at the start and at a perturbed state; the gauge
bucket (constant slots, no hand spec) through the port's jacfwd path
against the JAX jacfwd path; the Snavely spec's plain version against
the port's jacfwd path; and the CUDA source (csrc/linearize.cu: three
hand RowChains through csrc/linearize_auto.cuh's row kernel) against the
plain version at row counts around the 128-row tile and with xin off
16-byte alignment, on the host under tests/cuda_host_emu.py's g++ shim
and, marked `cuda`, on the card (there also at the main paths' row
counts).

Tolerances are test_pallas_linearize.py's: 2e-5 (r) and 2e-4 (J),
relative and absolute, f32 on both sides with another operation order.
Snavely's residuals are projections minus observations, which cancel,
so there r and J are held to 1e-5 relative to their largest entry. The
host emulation (no FMA contraction) and the card are held to the plain
version within the same limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu

from torch_parity_kit import (jax_problem, pallas_interpret, rel,
                              small_bal, torch_problem)

from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.ops.pallas_linearize import make_pallas_bucket_linearize
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.examples.snavely import SnavelyReprojectionError
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.ops.linearize import (SPECS, bucket_linearize,
                                           bucket_linearize_plain,
                                           linearize_spec)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram

torch.set_num_threads(1)

GRAPHS = {
    "3d": dict(args=dict(num_poses=25, seed=4, loop_every=5), sigma=0.05,
               seed=0),
    "2d": dict(args=dict(num_poses=40, seed=6), sigma=0.1, seed=1),
}


def _programs(dim):
    gen = f"synthetic_pose_graph_{dim}"
    build = f"build_pose_graph_{dim}_problem"
    args = GRAPHS[dim]["args"]
    jp = JaxProgram(getattr(jax_slam, build)(
        *getattr(jax_g2o, gen)(**args)[:2])[0])
    tp = TorchProgram(getattr(slam, build)(
        *getattr(g2o, gen)(**args)[:2])[0], device="cpu")
    return jp, tp


def _states(jp, dim):
    x0 = np.asarray(jp.initial_state())
    rng = np.random.default_rng(GRAPHS[dim]["seed"])
    return {"start": x0,
            "perturbed": x0 + GRAPHS[dim]["sigma"]
            * rng.standard_normal(x0.shape)}


@pytest.fixture(scope="module")
def graphs():
    """Both packages' programs and the JAX kernel's (r, J) on the main
    bucket at each state, the interpret-mode kernel built once per
    graph."""
    out = {}
    for dim in GRAPHS:
        jp, tp = _programs(dim)
        bi = [i for i, bk in enumerate(tp.buckets) if bk.spec is not None]
        states = _states(jp, dim)
        with pallas_interpret():
            lin = make_pallas_bucket_linearize(jp, jp.buckets[bi[0]])
            assert lin is not None
            ref = {k: tuple(np.asarray(a) for a in
                            lin(jnp.asarray(x).astype(jnp.float32)))
                   for k, x in states.items()}
        out[dim] = dict(jp=jp, tp=tp, bi=bi, states=states, ref=ref)
    return out


def _xin(tp, bk, x):
    return torch.cat([p.float() for p in tp._bucket_params(
        bk, tp.state_from_numpy(x))], dim=1).contiguous()


@pytest.mark.parametrize("dim", list(GRAPHS))
def test_gate_takes_the_main_bucket_only(graphs, dim):
    """One bucket (all slots variable) matches the hand spec; the gauge
    bucket (the edges of the constant first pose) does not, as
    _pose3d_match / _pose2d_match decide in the JAX package."""
    g = graphs[dim]
    tp, jp = g["tp"], g["jp"]
    assert [bk.n for bk in tp.buckets] == [bk.n for bk in jp.buckets]
    assert len(g["bi"]) == 1 and len(tp.buckets) == 2
    main = tp.buckets[g["bi"][0]]
    gauge = tp.buckets[1 - g["bi"][0]]
    term = (slam.PoseGraph3dErrorTerm if dim == "3d"
            else slam.PoseGraph2dErrorTerm)
    assert main.spec is SPECS[term] and linearize_spec(tp, main) is main.spec
    assert gauge.spec is None and not all(sl.variable for sl in gauge.slots)
    assert main.dat32.shape == (main.n, main.spec.p_dat)


@pytest.mark.parametrize("where", ["start", "perturbed"])
@pytest.mark.parametrize("dim", list(GRAPHS))
def test_k11_plain_matches_jax_kernel(graphs, dim, where):
    g = graphs[dim]
    tp = g["tp"]
    bk = tp.buckets[g["bi"][0]]
    r, J = bucket_linearize_plain(bk.spec, _xin(tp, bk, g["states"][where]),
                                  bk.dat32)
    r_ref, J_ref = g["ref"][where]
    assert r.dtype == J.dtype == torch.float32
    assert r.shape == r_ref.shape and J.shape == J_ref.shape
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(J.numpy(), J_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dim", list(GRAPHS))
def test_k11_wrapper_takes_the_plain_version_on_cpu(graphs, dim):
    g = graphs[dim]
    tp = g["tp"]
    bk = tp.buckets[g["bi"][0]]
    xin = _xin(tp, bk, g["states"]["start"])
    bucket_linearize.launches = 0
    got = bucket_linearize(bk.spec, xin, bk.dat32)
    want = bucket_linearize_plain(bk.spec, xin, bk.dat32)
    assert bucket_linearize.launches == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dim", list(GRAPHS))
def test_jacfwd_path_matches_jax(graphs, dim):
    """Every bucket through the port's generic linearize against the JAX
    jacfwd path in f32 (_bucket_linearize with cast_dtype=f32; on the CPU
    without interpret mode it takes no kernel): the gauge bucket (the
    port's jacfwd path, seeded through the manifolds' Plus) and the main
    bucket (K11's plain version, whose spec is the functor)."""
    g = graphs[dim]
    jp, tp = g["jp"], g["tp"]
    x = g["states"]["perturbed"]
    for bj, bt in zip(jp.buckets, tp.buckets):
        r_ref, J_ref = jp._bucket_linearize(bj, jnp.asarray(x),
                                            cast_dtype=jnp.float32)
        r, J = tp._bucket_linearize32(bt, tp.state_from_numpy(x))
        assert J.shape == J_ref.shape
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=2e-4,
                                   atol=2e-4)


@pytest.fixture(scope="module")
def snavely():
    """Both packages' programs of small_bal and the JAX kernel's (r, J) on
    its Snavely bucket at each state (the auto spec, interpret mode)."""
    bal = small_bal()
    jp = JaxProgram(jax_problem(bal))
    tp = TorchProgram(torch_problem(bal), device="cpu")
    x0 = np.asarray(jp.initial_state())
    rng = np.random.default_rng(2)
    states = {"start": x0,
              "perturbed": x0 + 0.01 * rng.standard_normal(x0.shape)}
    with pallas_interpret():
        lin = make_pallas_bucket_linearize(jp, jp.buckets[0])
        assert lin is not None
        ref = {k: tuple(np.asarray(a) for a in
                        lin(jnp.asarray(x).astype(jnp.float32)))
               for k, x in states.items()}
    return dict(tp=tp, states=states, ref=ref)


def test_snavely_bucket_takes_k11(snavely):
    tp = snavely["tp"]
    assert len(tp.buckets) == 1
    bk = tp.buckets[0]
    assert bk.spec is SPECS[SnavelyReprojectionError]
    assert bk.dat32.shape == (bk.n, 2)


@pytest.mark.parametrize("where", ["start", "perturbed"])
def test_k11_snavely_plain_matches_jax_kernel(snavely, where):
    tp = snavely["tp"]
    bk = tp.buckets[0]
    r, J = bucket_linearize_plain(bk.spec,
                                  _xin(tp, bk, snavely["states"][where]),
                                  bk.dat32)
    r_ref, J_ref = snavely["ref"][where]
    assert r.shape == r_ref.shape and J.shape == J_ref.shape
    assert rel(r.numpy(), r_ref) < 1e-5
    assert rel(J.numpy(), J_ref) < 1e-5


def test_k11_snavely_plain_is_the_jacfwd_path(snavely, monkeypatch):
    """The Snavely spec's plain version calls the functor, so on the CPU
    the bucket gives the jacfwd path's bits."""
    tp = snavely["tp"]
    bk = tp.buckets[0]
    x = tp.state_from_numpy(snavely["states"]["perturbed"])
    r, J = tp._bucket_linearize32(bk, x)
    monkeypatch.setattr(bk, "spec", None)
    r_j, J_j = tp._bucket_linearize32(bk, x)
    assert torch.equal(r, r_j) and torch.equal(J, J_j)


def _random_rows(spec, n, rng):
    """Random K11 inputs: unit quaternions in the rotation slots (SE3) and
    an upper-triangular sqrt_information, as build_pose_graph_*_problem
    gives them; for Snavely a camera a few units from points in front of
    it, with BAL-like focal length and small distortion."""
    if spec.p_in == 12:
        cam = np.concatenate([0.1 * rng.standard_normal((n, 3)),
                              0.1 * rng.standard_normal((n, 3)),
                              rng.uniform(400, 600, size=(n, 1)),
                              1e-3 * rng.standard_normal((n, 2))], axis=1)
        pt = rng.standard_normal((n, 3)) + [0.0, 0.0, -5.0]
        dat = 100.0 * rng.standard_normal((n, 2))
        return (torch.as_tensor(np.concatenate([cam, pt], axis=1),
                                dtype=torch.float32),
                torch.as_tensor(dat, dtype=torch.float32))
    xin = rng.standard_normal((n, spec.p_in))
    dat = rng.standard_normal((n, spec.p_dat))
    k = spec.r
    tri = np.triu(rng.uniform(0.5, 2.0, size=(n, k, k)))
    dat[:, -k * k:] = tri.reshape(n, k * k)
    if spec.p_in == 14:
        for a in (3, 10):
            xin[:, a:a + 4] /= np.linalg.norm(xin[:, a:a + 4], axis=1,
                                              keepdims=True)
        dat[:, 3:7] /= np.linalg.norm(dat[:, 3:7], axis=1, keepdims=True)
    return (torch.as_tensor(xin, dtype=torch.float32),
            torch.as_tensor(dat, dtype=torch.float32))


def _hold(name, r, J, r_ref, J_ref):
    r, J = np.asarray(r), np.asarray(J)
    r_ref, J_ref = np.asarray(r_ref), np.asarray(J_ref)
    assert np.isfinite(r).all() and np.isfinite(J).all()
    if name == "SnavelyReprojectionError":
        assert rel(r, r_ref) < 1e-5 and rel(J, J_ref) < 1e-5
        return
    np.testing.assert_allclose(r, r_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(J, J_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 513])
@pytest.mark.parametrize("name", [c.__name__ for c in SPECS])
def test_k11_kernel_matches_plain_on_the_card(name, n):
    """The CUDA kernel against its plain version on the card, at row
    counts that leave the last block partly empty (Snavely relative to
    the largest entry, as above). Run on a machine with a card:
    python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = {c.__name__: s for c, s in SPECS.items()}[name]
    xin, dat = _random_rows(spec, n, np.random.default_rng(n))
    xin, dat = xin.cuda(), dat.cuda()
    bucket_linearize.launches = 0
    r, J = bucket_linearize(spec, xin, dat)
    r_ref, J_ref = bucket_linearize_plain(spec, xin, dat)
    torch.cuda.synchronize()
    assert bucket_linearize.launches == 1
    assert r.dtype == J.dtype == torch.float32
    _hold(name, r.cpu(), J.cpu(), r_ref.cpu(), J_ref.cpu())


_K11_MAIN = r"""
  const int* h = emu_read<int>("hdr", 5);
  const int spec = h[0], n = h[1], shift = h[2], p_in = h[3], p_dat = h[4];
  const int nout = spec == 0 ? 6 * 13 : spec == 1 ? 3 * 7 : 2 * 13;
  float* xin = emu_alloc<float>((size_t)n * p_in + 4) + shift;
  memcpy(xin, emu_read<float>("xin", (size_t)n * p_in),
         sizeof(float) * n * p_in);
  const float* dat = emu_read<float>("dat", (size_t)n * p_dat);
  float* out = emu_alloc<float>((size_t)n * nout);
  const int r = spec == 0 ? 6 : spec == 1 ? 3 : 2;
  if (ceres_linearize(spec, xin, dat, n, out, out + (size_t)n * r, nullptr))
    return 3;
  emu_write("out", out, (size_t)n * nout);
"""
_EMU_EXE = []


def _emulated_k11(tmp_path_factory, spec, xin, dat, shift=0):
    """csrc/linearize.cu run on the host (tests/cuda_host_emu.py) through
    ceres_linearize; `shift` floats move xin off 16-byte alignment."""
    from ceres_tpu_torch.ops import _cuda
    if not _EMU_EXE:
        _EMU_EXE.append(emu.build(
            tmp_path_factory.mktemp("k11hand"),
            emu.source(_cuda.CSRC / "linearize.cu"), _K11_MAIN))
    n = xin.shape[0]
    out = emu.run(_EMU_EXE[0], tmp_path_factory.mktemp("k11run"), {
        "hdr": np.array([spec.kernel_id, n, shift, spec.p_in, spec.p_dat],
                        np.int32),
        "xin": xin.numpy(), "dat": dat.numpy()},
        {"out": (np.float32, n * spec.r * (spec.nt + 1))})["out"]
    return (out[:n * spec.r].reshape(n, spec.r),
            out[n * spec.r:].reshape(n, spec.r, spec.nt))


# name: (rows, xin shifted off 16-byte alignment by this many floats)
K11_HAND_EDGES = {"n1": (1, 0), "n127": (127, 0), "n129": (129, 0),
                  "n300": (300, 0), "n129-unaligned": (129, 1)}


@pytest.mark.parametrize("edge", list(K11_HAND_EDGES))
@pytest.mark.parametrize("name", [c.__name__ for c in SPECS])
def test_k11_hand_kernel_source_on_the_host(tmp_path_factory, name, edge):
    """csrc/linearize.cu (the SE3, SE2 and Snavely RowChains through
    linearize_auto::row_kernel in 128-row tiles), emulated on the host
    (one std::thread per CUDA thread), against bucket_linearize_plain:
    one row, a tile less one, a tile and one, several tiles with a ragged
    last one, and xin one float off 16-byte alignment (4-byte loads)."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    spec = {c.__name__: s for c, s in SPECS.items()}[name]
    n, shift = K11_HAND_EDGES[edge]
    xin, dat = _random_rows(spec, n, np.random.default_rng(n + shift))
    r, J = _emulated_k11(tmp_path_factory, spec, xin, dat, shift)
    r_ref, J_ref = bucket_linearize_plain(spec, xin, dat)
    _hold(name, r, J, r_ref.numpy(), J_ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c.__name__ for c in SPECS])
def test_k11_hand_kernel_at_the_main_paths_on_the_card(name):
    """On the card: each hand spec at its main path's row count (SE3 the
    2,000-pose graph's main bucket, 2,396 rows; SE2 the 1,000-pose
    graph's, 1,063; Snavely the 1M-observation bucket) and, at 129 rows,
    with xin one float into a buffer (4-byte loads), against the plain
    version; one launch a call, and a call repeats its bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = {c.__name__: s for c, s in SPECS.items()}[name]
    n_main = {0: 2396, 1: 1063, 2: 1_000_000}[spec.kernel_id]
    for n, shift in ((n_main, 0), (129, 1)):
        xin, dat = _random_rows(spec, n, np.random.default_rng(n))
        buf = torch.empty(xin.numel() + shift, device="cuda")
        xin_c = buf[shift:].view(xin.shape)
        xin_c.copy_(xin)
        dat_c = dat.cuda()
        bucket_linearize.launches = 0
        r, J = bucket_linearize(spec, xin_c, dat_c)
        r2, J2 = bucket_linearize(spec, xin_c, dat_c)
        torch.cuda.synchronize()
        assert bucket_linearize.launches == 2
        assert torch.equal(r, r2) and torch.equal(J, J2)
        r_ref, J_ref = bucket_linearize_plain(spec, xin_c, dat_c)
        _hold(name, r.cpu(), J.cpu(), r_ref.cpu(), J_ref.cpu())
