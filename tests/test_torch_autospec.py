"""K11 through auto specs, on the CPU: the plain version of
ops/linearize.py's bucket_linearize_auto against the JAX package's
Pallas kernel (make_pallas_bucket_linearize with its jet compiler's auto
spec) in interpret mode, on a quaternion BA bucket (600 rows) at the
start and at a perturbed state and on the Snavely subclass with a
doubled residual (which takes the auto spec in both packages); the
gate's routing (hand spec first, the row and tangent floors, constant
slots, functors that do not trace, the register cap); the emitted row
chain built with the host g++ under a shim, against the jacfwd path, for
functors of two, three and four slots (the SE3 pose graph's bucket, its
quaternion slots seeded through the manifold's Plus) with data fields
whose sorted order is not their order in the functor; the forced
implicit ITERATIVE_SCHUR solve of quaternion BA (8 cameras, 4,000
observations) against ceres_tpu.solve forced implicit; and, on a card,
the CUDA kernel against its plain version at odd row counts.

Tolerances: projections minus observations cancel, so BA's r and J are
held to 1e-5 relative to their largest entry (f32 on both sides in
another operation order), as tests/test_torch_linearize.py holds the
Snavely spec; the emitted chain to 1e-5 relative, as
tests/test_torch_autojet.py holds K5's; the forced implicit solve to the
JAX final cost within 5e-5 relative (quaternion trajectories are chaotic
in f32, ROADMAP.md section 3, so the LM and CG counts are printed, not
compared).
"""

import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_host_emu as emu

from torch_parity_kit import (JaxDoubled, TorchDoubled, ct, ctt,
                              functor_problem, jax_quaternion_problem,
                              main_path_options, pallas_interpret,
                              quaternion_bal, quaternion_solve_bal, rel,
                              small_bal, torch_quaternion_problem)

from ceres_tpu.ops.pallas_linearize import make_pallas_bucket_linearize
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.minimizers.fused import run_fused
from ceres_tpu_torch.ops import linearize as k11
from ceres_tpu_torch.ops.jet_compile import (AutoSpec, make_auto_spec,
                                             row_chain_source)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers import schur_fused as tsf
from ceres_tpu_torch.solvers.schur import detect_schur_structure

torch.set_num_threads(1)

TOL = 1e-5


def _xin(tp, bk, x):
    return torch.cat([p.float() for p in tp._bucket_params(
        bk, tp.state_from_numpy(x))], dim=1).contiguous()


def _jax_reference(jp, states):
    """The JAX kernel's (r, J) at each state (interpret mode, built
    once: a call takes seconds)."""
    with pallas_interpret():
        lin = make_pallas_bucket_linearize(jp, jp.buckets[0])
        assert lin is not None
        return {k: tuple(np.asarray(a) for a in
                         lin(jnp.asarray(x).astype(jnp.float32)))
                for k, x in states.items()}


@pytest.fixture(scope="module")
def quat():
    bal = quaternion_bal()
    jp = JaxProgram(jax_quaternion_problem(bal))
    tp = TorchProgram(torch_quaternion_problem(bal), device="cpu")
    x0 = np.asarray(jp.initial_state())
    rng = np.random.default_rng(2)
    states = {"start": x0,
              "perturbed": x0 + 0.01 * rng.standard_normal(x0.shape)}
    return dict(tp=tp, states=states, ref=_jax_reference(jp, states))


@pytest.fixture(scope="module")
def doubled():
    bal = small_bal()
    jp = JaxProgram(functor_problem(ct, JaxDoubled, bal))
    tp = TorchProgram(functor_problem(ctt, TorchDoubled, bal), device="cpu")
    x0 = np.asarray(jp.initial_state())
    rng = np.random.default_rng(3)
    states = {"perturbed": x0 + 0.01 * rng.standard_normal(x0.shape)}
    return dict(tp=tp, states=states, ref=_jax_reference(jp, states))


def test_quaternion_bucket_takes_the_auto_spec(quat):
    tp = quat["tp"]
    bk = tp.buckets[0]
    assert len(tp.buckets) == 1 and isinstance(bk.spec, AutoSpec)
    assert k11.linearize_spec(tp, bk) is bk.spec
    assert bk.spec.slot_sizes == (10, 3) and bk.spec.nt == 13
    assert bk.spec.data_names == ("observed_x", "observed_y")
    assert torch.equal(bk.dat32[:, 0], bk.data["observed_x"].float())


@pytest.mark.parametrize("where", ["start", "perturbed"])
def test_auto_plain_matches_jax_kernel(quat, where):
    tp = quat["tp"]
    bk = tp.buckets[0]
    r, J = k11.bucket_linearize_auto_plain(
        bk.spec, _xin(tp, bk, quat["states"][where]), bk.dat32)
    r_ref, J_ref = quat["ref"][where]
    assert r.dtype == J.dtype == torch.float32
    assert r.shape == r_ref.shape and J.shape == J_ref.shape
    assert rel(r.numpy(), r_ref) < TOL and rel(J.numpy(), J_ref) < TOL


def test_subclass_auto_plain_matches_jax_kernel(doubled):
    tp = doubled["tp"]
    bk = tp.buckets[0]
    assert isinstance(bk.spec, AutoSpec)
    r, J = k11.bucket_linearize_auto_plain(
        bk.spec, _xin(tp, bk, doubled["states"]["perturbed"]), bk.dat32)
    r_ref, J_ref = doubled["ref"]["perturbed"]
    assert r.shape == r_ref.shape and J.shape == J_ref.shape
    assert rel(r.numpy(), r_ref) < TOL and rel(J.numpy(), J_ref) < TOL


def test_wrapper_takes_the_plain_version_on_cpu(quat):
    tp = quat["tp"]
    bk = tp.buckets[0]
    xin = _xin(tp, bk, quat["states"]["start"])
    k11.bucket_linearize_auto.launches = 0
    got = tp._bucket_linearize32(bk, tp.state_from_numpy(
        quat["states"]["start"]))
    want = k11.bucket_linearize_auto_plain(bk.spec, xin, bk.dat32)
    assert k11.bucket_linearize_auto.launches == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- the gate ----

class _Pair:
    """Two 3-blocks, three residuals, data fields `w` (a scalar) and
    `b` (a 2-vector): sorted, b comes first."""

    def __init__(self, w, b):
        self.w = float(w)
        self.b = np.asarray(b, dtype=np.float64)

    def __call__(self, u, v):
        return torch.stack([self.w * (u[0] - v[1]) + self.b[0],
                            torch.sin(u[1]) * v[2] - self.b[1],
                            u[2] * v[0] + self.w * self.b[0] * self.b[1]])


class _Triple:
    """Three blocks (4, 2, 3), four residuals, data `w` and `b`."""

    def __init__(self, w, b):
        self.w = float(w)
        self.b = np.asarray(b, dtype=np.float64)

    def __call__(self, a, c, p):
        s = torch.sum(a * a) + c[0] * c[1]
        return torch.stack([
            torch.atan2(a[1], a[0] + 2.0) - self.w,
            torch.sqrt(s + 1.0) * p[0] - self.b[0],
            torch.exp(0.3 * c[1]) * p[1] + a[3] * self.b[1],
            p[2] * a[2] - c[0] / (2.0 + p[0] * p[0])])


class _Diff:
    """Two 3-blocks, three residuals, no data fields (block_data() is
    {}): a smoothness term between neighbouring blocks."""

    def __call__(self, u, v):
        return torch.stack([u[0] - v[0], torch.sin(u[1] - v[1]),
                            u[2] * v[2] - 1.0])


class _Prior:
    """One 3-block (tangent 3, under the floor)."""

    def __init__(self, t):
        self.t = np.asarray(t, dtype=np.float64)

    def __call__(self, p):
        return 0.1 * (p - self.t)


class _Wide:
    """Two 6-blocks, twelve residuals: R * NT = 144, past the cap."""

    def __call__(self, u, v):
        return torch.cat([u * v, u - v])


class _Full:
    """Two 8-blocks, eight residuals, data `w`: R * NT = 128, at the
    cap."""

    def __init__(self, w):
        self.w = float(w)

    def __call__(self, u, v):
        return self.w * u * v + torch.sin(u - v)


class _Cumsum:
    """An op outside the jet rules (cumsum): jacfwd takes it, the jet
    compiler does not."""

    def __call__(self, u, v):
        return torch.cumsum(u * v, dim=0)


def _custom(kind, n, seed=0, constant_first=False):
    rng = np.random.default_rng(seed)
    prob = ctt.Problem()
    if kind == "prior":
        pts = [rng.standard_normal(3) for _ in range(n)]
        for p in pts:
            prob.add_residual_block(ctt.AutoDiffCostFunction(
                _Prior(rng.standard_normal(3)), 3, [3]), None, p)
        return prob
    sizes = {"pair": [3, 3], "triple": [4, 2, 3], "wide": [6, 6],
             "cumsum": [3, 3], "diff": [3, 3], "full": [8, 8]}[kind]
    nres = {"pair": 3, "triple": 4, "wide": 12, "cumsum": 3,
            "diff": 3, "full": 8}[kind]
    blocks = [[rng.standard_normal(s) for _ in range(5)] for s in sizes]
    for i in range(n):
        if kind in ("pair", "triple"):
            functor = (_Pair if kind == "pair" else _Triple)(
                rng.uniform(0.5, 2.0), rng.standard_normal(2))
        elif kind == "full":
            functor = _Full(rng.uniform(0.5, 2.0))
        else:
            functor = {"wide": _Wide, "cumsum": _Cumsum,
                       "diff": _Diff}[kind]()
        args = [blocks[s][(i + 2 * s) % 5] for s in range(len(sizes))]
        prob.add_residual_block(ctt.AutoDiffCostFunction(functor, nres,
                                                         sizes), None, *args)
    if constant_first:
        prob.set_parameter_block_constant(blocks[0][0])
    return prob


def _buckets(prob, device="cpu"):
    tp = TorchProgram(prob, device=device)
    return tp, tp.buckets


def _pose_graph_3d():
    poses, edges, _ = g2o.synthetic_pose_graph_3d(num_poses=25, seed=4,
                                                  loop_every=5)
    return slam.build_pose_graph_3d_problem(poses, edges)[0]


def test_hand_specs_come_first():
    tp, bks = _buckets(_pose_graph_3d())
    main = [bk for bk in bks if bk.spec is not None]
    assert len(main) == 1
    assert main[0].spec is k11.SPECS[slam.PoseGraph3dErrorTerm]
    assert make_auto_spec(tp, main[0]) is not None   # it would trace too
    _, bks = _buckets(torch_quaternion_problem(quaternion_bal()))
    assert isinstance(bks[0].spec, AutoSpec)
    _, bks = _buckets(functor_problem(ctt, TorchDoubled, small_bal()))
    assert isinstance(bks[0].spec, AutoSpec)


@pytest.mark.parametrize("n", [63, 64])
def test_row_floor(n):
    _, bks = _buckets(_custom("pair", n))
    assert len(bks) == 1 and bks[0].n == n
    assert isinstance(bks[0].spec, AutoSpec) == (n >= k11.MIN_AUTO_ROWS)


def test_tangent_floor():
    _, bks = _buckets(_custom("prior", 100))
    assert bks[0].n == 100 and bks[0].spec is None
    _, bks = _buckets(_custom("pair", 100))
    assert sum(sl.tangent_size for sl in bks[0].slots) == 6
    assert isinstance(bks[0].spec, AutoSpec)


def test_constant_slot_stays_on_jacfwd():
    """The rows on the constant block form their own bucket, whose
    constant slot keeps it on jacfwd (the gauge bucket's rule)."""
    tp, bks = _buckets(_custom("pair", 200, constant_first=True))
    assert len(bks) == 2
    const = [bk for bk in bks if not all(sl.variable for sl in bk.slots)]
    assert len(const) == 1 and const[0].spec is None
    other = [bk for bk in bks if bk is not const[0]][0]
    assert isinstance(other.spec, AutoSpec)
    r, J = tp._bucket_linearize32(const[0], tp.initial_state())
    assert J.shape == (const[0].n, 3, 3)


def test_functor_that_does_not_trace_warns_and_stays_on_jacfwd(capsys):
    tp, bks = _buckets(_custom("cumsum", 100))
    assert bks[0].spec is None
    assert "_Cumsum uses ops outside the jet rules (cumsum)" in \
        capsys.readouterr().err
    r, J = tp._bucket_linearize32(bks[0], tp.initial_state())
    assert J.shape == (100, 3, 6)


def test_register_cap():
    tp, bks = _buckets(_custom("wide", 100))
    assert bks[0].spec is None
    auto = make_auto_spec(tp, bks[0])
    assert auto is not None and auto.r * auto.nt > k11.MAX_AUTO_OUTPUTS
    with pytest.raises(ValueError, match="register cap"):
        k11.build_auto(auto)


# ---- the emitted row chain ----

def _host_shim(struct):
    return f"""#include <math.h>
#include <stdio.h>
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
static inline float rsqrtf(float x) {{ return 1.0f / sqrtf(x); }}
{struct}
int main() {{
  int n;
  if (scanf("%d", &n) != 1) return 1;
  for (int i = 0; i < n; ++i) {{
    float x[RowChain::P_IN], d[RowChain::P_DAT + 1];
    for (int a = 0; a < RowChain::P_IN; ++a) scanf("%f", &x[a]);
    for (int a = 0; a < RowChain::P_DAT; ++a) scanf("%f", &d[a]);
    float rv[RowChain::R], J[RowChain::R][RowChain::NT];
    RowChain::run(x, d, rv, J);
    for (int s = 0; s < RowChain::R; ++s) {{
      printf("%.9g", rv[s]);
      for (int t = 0; t < RowChain::NT; ++t) printf(" %.9g", J[s][t]);
      printf("\\n");
    }}
  }}
  return 0;
}}
"""


CHAINS = {"quaternion": lambda: torch_quaternion_problem(quaternion_bal()),
          "pair": lambda: _custom("pair", 100),
          "triple": lambda: _custom("triple", 80),
          "diff": lambda: _custom("diff", 70),
          "se3": _pose_graph_3d}


@pytest.mark.parametrize("kind", list(CHAINS))
def test_emitted_row_chain_compiles_and_matches_jacfwd(kind, tmp_path):
    """The C++ row chain that K11's generated unit compiles, built by the
    host g++ under a shim that stands in for the CUDA qualifiers, gives
    the jacfwd path's residuals and Jacobian (the SE3 bucket's spec is
    traced directly: its hand spec takes it in the program)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host g++")
    tp, bks = _buckets(CHAINS[kind]())
    bk = max(bks, key=lambda b: b.n)
    spec = make_auto_spec(tp, bk)
    assert spec is not None and all(sl.variable for sl in bk.slots)
    src = tmp_path / "chain.cpp"
    src.write_text(_host_shim(row_chain_source(spec)))
    exe = tmp_path / "chain"
    subprocess.run([gxx, "-O1", "-std=c++17", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    x = tp.initial_state()
    xin = torch.cat([p.float() for p in tp._bucket_params(bk, x)], dim=1)
    dat = spec.data_matrix(bk)
    lines = [str(bk.n)] + [" ".join("%.9g" % float(v) for v in
                                    list(xin[i]) + list(dat[i]))
                           for i in range(bk.n)]
    out = subprocess.run([str(exe)], input="\n".join(lines), check=True,
                         capture_output=True, text=True).stdout.split()
    got = torch.tensor([float(v) for v in out]).view(bk.n, bk.r,
                                                     1 + spec.nt)
    bk.spec = None                      # the jacfwd path
    r0, J0 = tp._bucket_linearize32(bk, x)
    assert rel(got[..., 0], r0.float()) <= TOL
    assert rel(got[..., 1:], J0.float()) <= TOL


@pytest.mark.parametrize("kind", ["pair", "triple"])
def test_auto_plain_matches_jacfwd_with_sorted_data(kind):
    """Several data fields, sorted by name in the data matrix (b before
    w): the auto spec's plain version gives the jacfwd path's r and J."""
    tp, bks = _buckets(_custom(kind, 100))
    bk = bks[0]
    assert bk.spec.data_names == ("b", "w") and bk.dat32.shape[1] == 3
    x = tp.initial_state()
    r, J = tp._bucket_linearize32(bk, x)
    spec, bk.spec = bk.spec, None
    r0, J0 = tp._bucket_linearize32(bk, x)
    bk.spec = spec
    assert rel(r, r0.float()) <= TOL and rel(J, J0.float()) <= TOL


def test_data_free_functor_takes_the_auto_spec():
    """A functor with no data fields: its data matrix is [n, 0] on the
    program's device, and the auto spec's plain version gives the
    jacfwd path's r and J."""
    tp, bks = _buckets(_custom("diff", 70))
    bk = bks[0]
    assert isinstance(bk.spec, AutoSpec) and bk.spec.data_names == ()
    assert bk.dat32.shape == (70, 0) and bk.dat32.device == tp.device
    x = tp.initial_state()
    r, J = tp._bucket_linearize32(bk, x)
    spec, bk.spec = bk.spec, None
    r0, J0 = tp._bucket_linearize32(bk, x)
    bk.spec = spec
    assert rel(r, r0.float()) <= TOL and rel(J, J0.float()) <= TOL


# ---- the slice: quaternion BA in the implicit step ----

def test_forced_implicit_quaternion_solve_matches_jax(monkeypatch):
    """The implicit step on quaternion BA, its Jacobian from the auto
    spec (plain on the CPU) and its CG operator K10's plain version,
    against ceres_tpu.solve under CERES_TPU_FORCE_IMPLICIT."""
    bal = quaternion_solve_bal()

    def opts(mod):
        return main_path_options(
            mod, linear_solver_type=mod.LinearSolverType.ITERATIVE_SCHUR)

    monkeypatch.setenv("CERES_TPU_FORCE_IMPLICIT", "1")
    s_j = ct.solve(opts(ct), jax_quaternion_problem(bal))
    options = opts(ctt)
    program = TorchProgram.get_cached(torch_quaternion_problem(bal), options)
    meta = detect_schur_structure(program, options)
    assert tsf.unsupported_reason(program, options, meta,
                                  implicit=True) is None
    step = tsf.ImplicitSchurStep(program, options, meta)
    assert step.k10 and (step.te, step.tf) == (3, 10)
    assert isinstance(program.buckets[0].spec, AutoSpec)
    s_t = ctt.SolverSummary()
    program.write_back(run_fused(program, options, s_t, step))
    print(f"forced implicit quaternion BA: JAX {s_j.num_iterations} LM / "
          f"{s_j.num_linear_solver_iterations} CG -> {s_j.final_cost!r}; "
          f"port {s_t.num_iterations} LM / "
          f"{s_t.num_linear_solver_iterations} CG -> {s_t.final_cost!r}")
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_j.termination_type) == "CONVERGENCE"
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= 5e-5 * s_j.final_cost


# ---- on a card ----

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 513])
def test_auto_kernel_matches_plain_on_the_card(quat, n):
    """The generated CUDA kernel against its plain version on the card,
    on rows of the quaternion bucket (repeated and perturbed), at row
    counts that leave the last block partly empty. Run on a machine with
    a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tp = quat["tp"]
    bk = tp.buckets[0]
    rng = np.random.default_rng(n)
    idx = torch.as_tensor(rng.integers(0, bk.n, size=n))
    xin = _xin(tp, bk, quat["states"]["start"])[idx]
    xin = (xin * (1 + 1e-3 * torch.as_tensor(
        rng.standard_normal(xin.shape), dtype=torch.float32))).cuda()
    dat = bk.dat32[idx].contiguous().cuda()
    k11.bucket_linearize_auto.launches = 0
    r, J = k11.bucket_linearize_auto(bk.spec, xin.contiguous(), dat)
    r_ref, J_ref = k11.bucket_linearize_auto_plain(bk.spec, xin, dat)
    torch.cuda.synchronize()
    assert k11.bucket_linearize_auto.launches == 1
    assert r.shape == (n, 2) and J.shape == (n, 2, 13)
    assert rel(r.cpu().numpy(), r_ref.cpu().numpy()) < TOL
    assert rel(J.cpu().numpy(), J_ref.cpu().numpy()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65, 513])
def test_data_free_bucket_linearizes_on_the_card(n):
    """A bucket without data fields, built on the card, through the
    program's linearize: the generated kernel (its data matrix [n, 0] on
    the card) against its plain version on the same inputs. Run on a
    machine with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tp, bks = _buckets(_custom("diff", n), device="cuda")
    bk = bks[0]
    assert isinstance(bk.spec, AutoSpec) and bk.dat32.is_cuda
    x = tp.initial_state()
    k11.bucket_linearize_auto.launches = 0
    r, J = tp._bucket_linearize32(bk, x)
    xin = torch.cat([p.float() for p in tp._bucket_params(bk, x)],
                    dim=1).contiguous()
    r_ref, J_ref = k11.bucket_linearize_auto_plain(bk.spec, xin, bk.dat32)
    torch.cuda.synchronize()
    assert k11.bucket_linearize_auto.launches == 1
    assert r.shape == (n, 3) and J.shape == (n, 3, 6)
    assert rel(r.cpu().numpy(), r_ref.cpu().numpy()) < TOL
    assert rel(J.cpu().numpy(), J_ref.cpu().numpy()) < TOL


# ---- the kernel source on the host, and its edges on the card ----

def test_auto_tile_from_the_chain():
    """Rows a block of csrc/linearize_auto.cuh: 128 while a row's inputs
    or outputs (odd strides) fit 384 B, 64 to 768 B, 32 to 1,536 B; then
    none, and the gate leaves the bucket to jacfwd."""
    assert k11.auto_tile(2, 13, 13, 2) == 128            # quaternion BA
    assert k11.auto_tile(8, 16, 16, 1) == 64             # R * NT = 128
    assert k11.auto_tile(1, 3, 3, 0) == 128              # no data
    assert k11.auto_tile(2, 6, 6, 89) == 128             # 7 + 89 floats
    assert k11.auto_tile(2, 6, 6, 90) == 64              # 7 + 91
    assert k11.auto_tile(2, 6, 200, 100) == 32
    assert k11.auto_tile(2, 6, 300, 100) is None
    for r, nt, p_in, p_dat in [(2, 13, 13, 2), (8, 16, 16, 1), (3, 6, 6, 0),
                               (4, 9, 9, 3)]:
        t = k11.auto_tile(r, nt, p_in, p_dat)
        inp = (p_in | 1) + ((p_dat | 1) if p_dat else 0)
        assert t * 4 * max(inp, (r | 1) + ((r * nt) | 1)) <= 48 * 1024


_K11_MAIN = r"""
  const int* h = emu_read<int>("hdr", 2);
  const int n = h[0], shift = h[1];
  constexpr int R = RowChain::R, NT = RowChain::NT;
  constexpr int P_IN = RowChain::P_IN, P_DAT = RowChain::P_DAT;
  float* xin = emu_alloc<float>((size_t)n * P_IN + 4) + shift;
  memcpy(xin, emu_read<float>("xin", (size_t)n * P_IN),
         sizeof(float) * n * P_IN);
  const float* dat = emu_read<float>("dat", (size_t)n * P_DAT);
  float* r = emu_alloc<float>((size_t)n * R);
  float* J = emu_alloc<float>((size_t)n * R * NT);
  if (linearize_auto_launch<RowChain, TILE>(xin, dat, n, r, J, nullptr))
    return 3;
  emu_write("r", r, (size_t)n * R);
  emu_write("J", J, (size_t)n * R * NT);
"""
_EMU_EXE = {}


def _emulated_k11(tmp_path_factory, spec, xin, dat, shift=0):
    """csrc/linearize_auto.cuh run on the host (tests/cuda_host_emu.py)
    through linearize_auto_launch at the tile the generated unit picks;
    `shift` floats move xin off 16-byte alignment."""
    from ceres_tpu_torch.ops import _cuda
    key = (spec.digest, spec.slot_sizes, spec.data_widths)
    if key not in _EMU_EXE:
        tile = k11.auto_tile(spec.r, spec.nt, sum(spec.slot_sizes),
                             spec.p_dat)
        _EMU_EXE[key] = emu.build(
            tmp_path_factory.mktemp("k11emu"),
            (_cuda.CSRC / "linearize_auto.cuh").read_text(), _K11_MAIN,
            row_chain_source(spec) + f"constexpr int TILE = {tile};\n")
    n = xin.shape[0]
    out = emu.run(_EMU_EXE[key], tmp_path_factory.mktemp("k11run"), {
        "hdr": np.array([n, shift], np.int32), "xin": xin.numpy(),
        "dat": dat.numpy()}, {"r": (np.float32, n * spec.r),
                              "J": (np.float32, n * spec.r * spec.nt)})
    return out["r"].reshape(n, spec.r), out["J"].reshape(n, spec.r,
                                                         spec.nt)


def _quat_rows(quat, n):
    """n rows of the quaternion bucket, repeated at random and perturbed
    (seeded by n)."""
    tp = quat["tp"]
    bk = tp.buckets[0]
    rng = np.random.default_rng(n)
    idx = torch.as_tensor(rng.integers(0, bk.n, size=n))
    xin = _xin(tp, bk, quat["states"]["start"])[idx]
    xin = xin * (1 + 1e-3 * torch.as_tensor(rng.standard_normal(xin.shape),
                                            dtype=torch.float32))
    return bk.spec, xin.contiguous(), bk.dat32[idx].contiguous()


def _custom_rows(kind, n):
    tp, bks = _buckets(_custom(kind, n))
    bk = bks[0]
    assert isinstance(bk.spec, AutoSpec)
    return bk.spec, _xin(tp, bk, tp.initial_state().numpy()), bk.dat32


# name: (rows, xin shifted off 16-byte alignment by this many floats)
K11_EDGES = {"quat-1": (1, 0), "quat-7": (7, 0), "quat-200": (200, 0),
             "quat-513": (513, 0), "quat-513-unaligned": (513, 1),
             "full": (100, 0), "diff": (65, 0), "triple": (300, 1)}


def _k11_edge(quat, name):
    n, shift = K11_EDGES[name]
    if name.startswith("quat"):
        return _quat_rows(quat, n) + (shift,)
    spec, xin, dat = _custom_rows(name, n)
    return spec, xin, dat, shift


@pytest.mark.parametrize("name", list(K11_EDGES))
def test_auto_kernel_source_on_the_host(quat, tmp_path_factory, name):
    """csrc/linearize_auto.cuh, emulated on the host (one std::thread per
    CUDA thread), against the plain version: row counts of 1, 7, not a
    multiple of the tile and past it, xin off 16-byte alignment (4-byte
    loads), R * NT = 128 (a 64-row tile), no data fields, three slots."""
    if emu.gxx() is None:
        pytest.skip("no host g++")
    spec, xin, dat, shift = _k11_edge(quat, name)
    if name == "full":
        assert spec.r * spec.nt == k11.MAX_AUTO_OUTPUTS
    if name == "diff":
        assert spec.p_dat == 0
    r, J = _emulated_k11(tmp_path_factory, spec, xin, dat, shift)
    r_ref, J_ref = k11.bucket_linearize_auto_plain(spec, xin, dat)
    assert np.isfinite(r).all() and np.isfinite(J).all()
    assert rel(r, r_ref.numpy()) < TOL and rel(J, J_ref.numpy()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K11_EDGES))
def test_auto_kernel_edges_on_the_card(quat, name):
    """On the card: the edges of the host test above against the plain
    version, one launch a call (an unaligned xin is a view one float into
    a buffer). Run on a machine with a card: python -m pytest tests -m
    cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, xin, dat, shift = _k11_edge(quat, name)
    buf = torch.empty(xin.numel() + shift, device="cuda")
    xin_c = buf[shift:].view(xin.shape)
    xin_c.copy_(xin)
    dat_c = dat.cuda()
    k11.bucket_linearize_auto.launches = 0
    r, J = k11.bucket_linearize_auto(spec, xin_c, dat_c)
    torch.cuda.synchronize()
    assert k11.bucket_linearize_auto.launches == 1
    r_ref, J_ref = k11.bucket_linearize_auto_plain(spec, xin, dat)
    assert rel(r.cpu().numpy(), r_ref.numpy()) < TOL
    assert rel(J.cpu().numpy(), J_ref.numpy()) < TOL
