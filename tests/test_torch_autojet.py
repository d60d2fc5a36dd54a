"""The auto-jet compiler of ceres_tpu_torch (ops/jet_compile.py over
ops/jetlib.py), on the CPU.

The traced per-row program of a bucket, evaluated over tensor jets, is
held to torch.func.jacfwd of the same program (program.py
_bucket_linearize32's jacfwd path), for the quaternion Snavely functor,
tests/test_autolin.py's weighted pinhole and a functor with atan2, exp,
where and a reduction; the traced code of every loss of loss.py to
loss.evaluate; and the C++ that the emitter writes for K5, compiled with
the host g++ under a small shim, to jacfwd and the Triggs corrector.
Tolerance 1e-5 relative to the largest entry: the jets run in f32 in
another operation order than jacfwd (whose tangents promote to f64 where
a Python float meets a 0-d tensor).
"""

import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from torch_parity_kit import (ctt, quaternion_bal, rel,
                              torch_quaternion_problem)

from ceres_tpu_torch.loss import correct_residuals_and_jacobian
from ceres_tpu_torch.ops import jetlib as jl
from ceres_tpu_torch.ops.jet_compile import (eval_loss, loss_param_values,
                                             make_auto_spec, make_loss_spec)
from ceres_tpu_torch.ops.lin_auto import chain_source, lin_auto_spec
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.rotation import angle_axis_rotate_point

TOL = 1e-5


class WeightedPinhole:
    """tests/test_autolin.py's custom functor: 6-parameter camera
    (angle-axis, translation), 3-parameter point, weighted pinhole."""

    def __init__(self, ox, oy, w):
        self.ox, self.oy, self.w = float(ox), float(oy), float(w)

    def __call__(self, cam, pt):
        p = angle_axis_rotate_point(cam[0:3], pt) + cam[3:6]
        xp = -p[0] / p[2]
        yp = -p[1] / p[2]
        return torch.stack([self.w * (xp - self.ox), self.w * (yp - self.oy)])


class MixedOps:
    """atan2, exp, where and a reduction on a 4-parameter block and a
    2-parameter block, 3 residuals."""

    def __init__(self, t):
        self.t = float(t)

    def __call__(self, a, b):
        ang = torch.atan2(a[1], a[0] + 2.0)
        s = torch.sum(a * a) + b[0] * b[0] * b[1] * b[1]
        g = torch.where(a[2] > 0.1, torch.exp(0.3 * a[2]) * b[0],
                        a[3] - b[1])
        return torch.stack([ang - self.t, torch.sqrt(s + 1.0) * 0.5, g])


def _custom_problem(kind, seed=0):
    rng = np.random.default_rng(seed)
    prob = ctt.Problem()
    if kind == "pinhole":
        cams = [np.concatenate([0.05 * rng.standard_normal(3),
                                [0.1 * c, -0.1, 4.0]]) for c in range(5)]
        pts = [0.5 * rng.standard_normal(3) for _ in range(40)]
        for j, p in enumerate(pts):
            for c in rng.choice(5, size=3, replace=False):
                prob.add_residual_block(ctt.AutoDiffCostFunction(
                    WeightedPinhole(*rng.standard_normal(2) * 0.1,
                                    1.0 + 0.1 * (c % 3)), 2, [6, 3]),
                    None, cams[c], p)
    else:
        aa = [rng.standard_normal(4) for _ in range(4)]
        bb = [rng.standard_normal(2) for _ in range(30)]
        for j, b in enumerate(bb):
            prob.add_residual_block(ctt.AutoDiffCostFunction(
                MixedOps(rng.standard_normal()), 3, [4, 2]), None,
                aa[j % 4], b)
    return prob


def _bucket(problem):
    prog = CompiledProgram(problem, device="cpu")
    assert len(prog.buckets) == 1
    return prog, prog.buckets[0]


def _problem(kind):
    if kind == "quaternion":
        return torch_quaternion_problem(quaternion_bal())
    return _custom_problem(kind)


def _dense(jets, nt):
    """[n, R] values and [n, R, nt] partials of a list of tensor jets."""
    r = torch.stack([torch.as_tensor(j.v) for j in jets], -1)
    n = r.shape[0]
    J = torch.zeros(n, len(jets), nt)
    for s, j in enumerate(jets):
        for c, p in enumerate(jl.dense_partials(j, nt)):
            if p is not None:
                J[:, s, c] = p
    return r, J


@pytest.mark.parametrize("kind", ["quaternion", "pinhole", "mixed"])
def test_jets_match_jacfwd(kind):
    """The graph's jet evaluation over f32 tensors gives the residuals and
    the tangent Jacobian of the jacfwd path."""
    prog, bk = _bucket(_problem(kind))
    spec = make_auto_spec(prog, bk)
    assert spec is not None and spec.r == bk.r
    x = prog.initial_state()
    params = [p.float() for p in prog._bucket_params(bk, x)]
    dat = spec.data_matrix(bk)
    jets = spec.jets([[p[:, a] for a in range(p.shape[1])] for p in params],
                     [dat[:, i] for i in range(spec.p_dat)])
    r, J = _dense(jets, spec.nt)
    r0, J0 = prog._bucket_linearize32(bk, x)
    assert r.dtype == torch.float32
    assert rel(r, r0) <= TOL
    assert rel(J, J0.float()) <= TOL
    assert make_auto_spec(prog, bk) is spec          # cached per bucket


def test_quaternion_trace_ops():
    """The quaternion functor traces to the nine aten ops of its code (and
    the view of AutoDiffCostFunction's reshape)."""
    prog, bk = _bucket(_problem("quaternion"))
    spec = make_auto_spec(prog, bk)
    ops = {n.target._opname for n in spec.graph.graph.nodes
           if n.op == "call_function"}
    assert ops - {"view"} == {"add", "sub", "mul", "div", "neg", "select",
                              "slice", "stack", "linalg_cross"}
    assert spec.name == "auto:SnavelyReprojectionErrorWithQuaternions"
    assert (spec.slot_sizes, spec.tan_sizes, spec.nt) == ((10, 3), (10, 3),
                                                          13)


class _CumSum:
    def __init__(self, o):
        self.o = float(o)

    def __call__(self, a, b):
        return torch.cumsum(a, 0)[1:] * b[0] - self.o


class _Branchy:
    def __init__(self, o):
        self.o = float(o)

    def __call__(self, a, b):
        if a[0] > 0:                              # data-dependent branch
            return torch.stack([a[0] * b[0] - self.o, a[1]])
        return torch.stack([a[1] * b[0] - self.o, a[0]])


@pytest.mark.parametrize("functor", [_CumSum, _Branchy])
def test_unsupported_functors_give_no_spec(functor):
    """An op outside the rule table, or control flow on the data, makes
    make_auto_spec return None."""
    prob = ctt.Problem()
    a, b = np.array([0.5, 0.2, 0.1]), np.array([1.5])
    prob.add_residual_block(ctt.AutoDiffCostFunction(functor(0.3), 2,
                                                     [3, 1]), None, a, b)
    prog, bk = _bucket(prob)
    assert make_auto_spec(prog, bk) is None


LOSSES = [ctt.TrivialLoss(), ctt.HuberLoss(1.3), ctt.SoftLOneLoss(0.8),
          ctt.CauchyLoss(2.0), ctt.ArctanLoss(0.7), ctt.TolerantLoss(0.5, 0.3),
          ctt.TukeyLoss(2.0),
          ctt.ComposedLoss(ctt.HuberLoss(1.0), ctt.CauchyLoss(2.0)),
          ctt.ScaledLoss(ctt.SoftLOneLoss(1.5), 2.0), ctt.ScaledLoss(None, 3.0),
          ctt.LossFunctionWrapper(ctt.CauchyLoss(0.5))]


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
def test_traced_loss_matches_evaluate(loss):
    """The traced loss, its scalars as inputs, against loss.evaluate; the
    trace is shared by instances of one class structure."""
    spec = make_loss_spec(loss)
    assert spec is not None
    s = torch.cat([torch.linspace(0.0, 10.0, 41),
                   torch.tensor([35.0, 40.0, 1e3])])
    params = [torch.tensor(v, dtype=torch.float32)
              for v in loss_param_values(loss)]
    got = eval_loss(spec, s, params)
    for g, w in zip(got, loss.evaluate(s)):
        g = torch.as_tensor(g).expand_as(w)
        assert torch.allclose(g, w.float(), rtol=1e-6, atol=1e-7)
    twin = type(loss).__new__(type(loss))
    twin.__dict__.update(loss.__dict__)
    assert make_loss_spec(twin) is spec


def _host_shim(struct, n_in):
    return f"""#include <math.h>
#include <stdio.h>
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
static inline float rsqrtf(float x) {{ return 1.0f / sqrtf(x); }}
struct LossParams {{ float p[16]; }};
{struct}
int main() {{
  int n;
  if (scanf("%d", &n) != 1) return 1;
  for (int i = 0; i < n; ++i) {{
    float xf_c[Chain::TF], xe_n[Chain::TE], d[Chain::ND + 1];
    LossParams lp;
    int valid;
    for (int a = 0; a < Chain::TF; ++a) scanf("%f", &xf_c[a]);
    for (int a = 0; a < Chain::TE; ++a) scanf("%f", &xe_n[a]);
    for (int a = 0; a < Chain::ND; ++a) scanf("%f", &d[a]);
    for (int a = 0; a < {n_in}; ++a) scanf("%f", &lp.p[a]);
    scanf("%d", &valid);
    float rv[Chain::R], J[Chain::R][Chain::NT];
    Chain::run(xf_c, xe_n, d, lp, valid != 0, rv, J);
    for (int s = 0; s < Chain::R; ++s) {{
      printf("%.9g", rv[s]);
      for (int t = 0; t < Chain::NT; ++t) printf(" %.9g", J[s][t]);
      printf("\\n");
    }}
  }}
  return 0;
}}
"""


@pytest.mark.parametrize("kind,loss", [("quaternion", None),
                                       ("quaternion", ctt.HuberLoss(1.0)),
                                       ("pinhole", ctt.CauchyLoss(0.5)),
                                       ("mixed", None)],
                         ids=["quaternion", "quaternion-huber",
                              "pinhole-cauchy", "mixed"])
def test_emitted_chain_compiles_and_matches_jacfwd(kind, loss, tmp_path):
    """The C++ chain that K5 compiles, built by the host g++ under a shim
    that stands in for the CUDA qualifiers, gives the jacfwd residuals and
    Jacobian, loss-corrected (the CPU check of the emitter's C++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host g++")
    prog, bk = _bucket(_problem(kind))
    spec = make_auto_spec(prog, bk)
    e_slot = 1                             # the second slot is the point
    k5 = lin_auto_spec(spec, e_slot)
    lspec = None if loss is None else make_loss_spec(loss)
    lp = [] if loss is None else loss_param_values(loss)
    src = tmp_path / "chain.cpp"
    src.write_text(_host_shim(chain_source(k5, lspec), len(lp)))
    exe = tmp_path / "chain"
    subprocess.run([gxx, "-O1", "-std=c++17", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    x = prog.initial_state()
    params = [p.float() for p in prog._bucket_params(bk, x)]
    dat = spec.data_matrix(bk)
    n = bk.n
    valid = (torch.arange(n) % 7 != 3)            # some lanes invalid
    lines = [str(n)]
    for i in range(n):
        vals = list(params[0][i]) + list(params[1][i]) + list(dat[i]) + lp
        lines.append(" ".join("%.9g" % float(v) for v in vals)
                     + f" {int(valid[i])}")
    out = subprocess.run([str(exe)], input="\n".join(lines), check=True,
                         capture_output=True, text=True).stdout.split()
    got = torch.tensor([float(v) for v in out]).view(n, bk.r, 1 + spec.nt)
    r0, J0 = prog._bucket_linearize32(bk, x)
    r0, J0 = r0.float(), J0.float()
    if loss is not None:
        # an invalid lane takes the simple branch at sq = 0
        r_c, J_c = r0.clone(), J0.clone()
        _, r_c[valid], J_c[valid] = correct_residuals_and_jacobian(
            loss, r0[valid], J0[valid])
        sq0 = torch.zeros(int((~valid).sum()))
        rho1 = loss.evaluate(sq0)[1]
        sr = torch.sqrt(torch.clamp(rho1, min=0.0))
        r_c[~valid] = r0[~valid] * sr[:, None]
        J_c[~valid] = J0[~valid] * sr[:, None, None]
        r0, J0 = r_c, J_c
    assert all(math.isfinite(v) for v in got.reshape(-1).tolist())
    assert rel(got[..., 0], r0) <= TOL
    assert rel(got[..., 1:], J0) <= TOL


def test_emitted_code_is_f32():
    """Literals carry the f suffix and math is the f32 set: no double in
    the chain."""
    prog, bk = _bucket(_problem("mixed"))
    src = chain_source(lin_auto_spec(make_auto_spec(prog, bk), 1),
                       make_loss_spec(ctt.TolerantLoss(0.5, 0.3)))
    import re
    body = src[src.index("{", src.index("run(")):]
    assert not re.search(r"(?<![\w.])\d+\.\d*(?![\d.ef])", body)
    for fn in ("expf(", "atan2f(", "sqrtf("):
        assert fn in body
    assert not re.search(r"\b(exp|atan2|sqrt|log)\(", body)
    assert "double" not in body
