"""The port's C API (ceres_tpu_torch/c_api.py, capi/): the Python-level
API through ctypes function pointers (the C costs take program.py's host
route), a failing cost as an invalid step, the C loss, and
examples/curve_fitting_c/curve_fitting.c compiled against the port's
shim and run on the CPU (CERES_TPU_TORCH_DEVICE=cpu), against the JAX
package's C API run on the same data."""

import ctypes
import math
import os
import shutil
import site
import subprocess
from ctypes import POINTER, c_double, c_void_p

import numpy as np
import pytest
import torch

import torch_parity_kit  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _exp_cost(user_data, params, residuals, jacobians):
    row = ctypes.cast(user_data, POINTER(c_double))
    x, y = row[0], row[1]
    e = math.exp(params[0][0] * x + params[1][0])
    residuals[0] = y - e
    if jacobians:
        if jacobians[0]:
            jacobians[0][0] = -x * e
        if jacobians[1]:
            jacobians[1][0] = -e
    return 1


def _cauchy(user_data, s, out):
    """The shim's stock Cauchy loss, a = *user_data."""
    a = ctypes.cast(user_data, POINTER(c_double))[0]
    b = a * a
    total = 1.0 + s / b
    inv = 1.0 / total
    out[0] = b * math.log(total)
    out[1] = inv
    out[2] = -inv * inv / b


def _curve_solve(c_api, table, with_loss, **solve_kw):
    """curve_fitting.c's problem through `c_api` at the Python level."""
    cost = c_api.CERES_COST_FUNC_T(_exp_cost)
    loss = c_api.CERES_LOSS_FUNC_T(_cauchy)
    a = (c_double * 1)(0.5)
    pid = c_api.create_problem()
    m, c = np.array([0.0]), np.array([0.0])
    for i in range(len(table)):
        c_api.add_residual_block(
            pid, ctypes.cast(cost, c_void_p).value, table[i].ctypes.data,
            ctypes.cast(loss, c_void_p).value if with_loss else 0,
            ctypes.addressof(a) if with_loss else 0, 1, [1, 1],
            [m.ctypes.data, c.ctypes.data])
    report = c_api.solve(pid, **solve_kw)
    c_api.free_problem(pid)
    return report, m[0], c[0]


def _curve_table():
    """curve_fitting.c's data (its LCG noise)."""
    data, state = [], 12345
    for i in range(30):
        x = 5.0 * i / 29
        state = (state * 1664525 + 1013904223) % 2 ** 32
        data.append((x, math.exp(0.3 * x + 0.1)
                     + ((state >> 8) % 1000) / 10000.0 - 0.05))
    return np.ascontiguousarray(np.asarray(data, np.float64))


@pytest.fixture(scope="module")
def jax_curve():
    """The JAX package's C API run of curve_fitting.c's problem: (m, c)."""
    from ceres_tpu import c_api
    _, m, c = _curve_solve(c_api, _curve_table(), True)
    return m, c


def test_python_level_api():
    from ceres_tpu_torch import c_api
    xs = np.linspace(0.0, 5.0, 15)
    table = np.ascontiguousarray(np.stack([xs, np.exp(0.3 * xs + 0.1)], 1))
    report, m, c = _curve_solve(c_api, table, False, device="cpu")
    assert "CONVERGENCE" in report
    np.testing.assert_allclose([m, c], [0.3, 0.1], atol=1e-6)


def test_python_level_api_with_loss_matches_jax(jax_curve):
    from ceres_tpu_torch import c_api
    report, m, c = _curve_solve(c_api, _curve_table(), True, device="cpu")
    assert "CONVERGENCE" in report
    np.testing.assert_allclose([m, c], jax_curve, rtol=0, atol=1e-10)


def test_failing_cost_is_invalid_step():
    """A C cost returning 0 poisons the evaluation (NaN), which the
    solver survives at candidate points."""
    from ceres_tpu_torch import c_api

    @c_api.CERES_COST_FUNC_T
    def cost(user_data, params, residuals, jacobians):
        x = params[0][0]
        if x > 4.0:
            return 0
        residuals[0] = 3.0 - x
        if jacobians and jacobians[0]:
            jacobians[0][0] = -1.0
        return 1

    pid = c_api.create_problem()
    x = np.array([1.0])
    c_api.add_residual_block(pid, ctypes.cast(cost, c_void_p).value, 0, 0,
                             0, 1, [1], [x.ctypes.data])
    report = c_api.solve(pid, device="cpu")
    assert "CONVERGENCE" in report
    np.testing.assert_allclose(x[0], 3.0, atol=1e-8)
    c_api.free_problem(pid)


def test_host_route_rows_and_views():
    """The host route evaluates a bucket's rows with one call a row and
    gives the residuals and Jacobians vmap would; parameter views are the
    C memory itself."""
    from ceres_tpu_torch import c_api
    from ceres_tpu_torch.program import CompiledProgram
    import ceres_tpu_torch as ctt
    table = _curve_table()
    cost = c_api.CERES_COST_FUNC_T(_exp_cost)
    pid = c_api.create_problem()
    m, c = np.array([0.2]), np.array([0.05])
    for i in range(len(table)):
        c_api.add_residual_block(pid, ctypes.cast(cost, c_void_p).value,
                                 table[i].ctypes.data, 0, 0, 1, [1, 1],
                                 [m.ctypes.data, c.ctypes.data])
    cp = c_api._problems[pid]
    assert cp.views[0].ctypes.data == m.ctypes.data
    prog = CompiledProgram(cp.problem, "cpu")
    (bk,) = prog.buckets
    assert bk.jac_mode == "host"
    cost_v, grad, jac, res = prog.linearize_fn(prog.initial_state())
    e = np.exp(0.2 * table[:, 0] + 0.05)
    np.testing.assert_allclose(res.flatten().numpy(), table[:, 1] - e,
                               rtol=1e-15)
    J = jac.to_dense().numpy()
    np.testing.assert_allclose(J, np.stack([-table[:, 0] * e, -e], 1),
                               rtol=1e-15)
    np.testing.assert_allclose(float(cost_v),
                               0.5 * np.sum((table[:, 1] - e) ** 2),
                               rtol=1e-14)
    s = ctt.solve(ctt.SolverOptions(device="cpu"), cp.problem)
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    c_api.free_problem(pid)


def test_c_loss_evaluates_on_host():
    from ceres_tpu_torch import c_api
    loss_fn = c_api.CERES_LOSS_FUNC_T(_cauchy)
    a = (c_double * 1)(0.5)
    loss = c_api._loss_class(ctypes.cast(loss_fn, c_void_p).value)(
        ctypes.addressof(a))
    s = torch.tensor([[0.0, 0.1], [2.0, 7.5]], dtype=torch.float64)
    rho, d1, d2 = loss.evaluate(s)
    b = 0.25
    np.testing.assert_allclose(rho.numpy(), b * np.log1p(s.numpy() / b),
                               rtol=1e-15)
    np.testing.assert_allclose(d1.numpy(), 1 / (1 + s.numpy() / b),
                               rtol=1e-15)
    assert rho.shape == s.shape and d2.dtype == torch.float64


def _embedding_ok():
    return (shutil.which("gcc") is not None
            and shutil.which("python3-config") is not None
            and subprocess.run(["python3-config", "--embed", "--ldflags"],
                               capture_output=True).returncode == 0)


@pytest.mark.skipif(not _embedding_ok(),
                    reason="no gcc or no python3-config --embed")
def test_compiled_curve_fitting_c_on_cpu(tmp_path, jax_curve):
    """curve_fitting.c through the port's shim (built into
    ceres_tpu_torch/_build/), on the CPU: its OK line, and m and c within
    1e-10 of the JAX C API's run on the same data."""
    from ceres_tpu_torch import capi
    lib = capi.build()
    assert lib.parent.parent.name == "_build"
    assert lib.parent.parent.parent.name == "ceres_tpu_torch"
    exe = str(tmp_path / "curve_fitting_c")
    src = os.path.join(REPO, "ceres_tpu_torch", "examples",
                       "curve_fitting_c", "curve_fitting.c")
    subprocess.run(["gcc", "-O2", src, "-I" + str(capi.HEADER.parent),
                    "-L" + str(lib.parent), "-lceres_tpu_torch_c",
                    "-Wl,-rpath," + str(lib.parent), "-o", exe, "-lm"],
                   check=True, capture_output=True)
    env = dict(os.environ, CERES_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join([REPO] + site.getsitepackages()))
    out = subprocess.run([exe], env=env, capture_output=True, text=True,
                         timeout=600)
    assert "CURVE_FITTING_C_OK" in out.stdout, (out.stdout, out.stderr)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("Final m:")][0]
    m_s, c_s = line[len("Final m:"):].split(", c:")
    np.testing.assert_allclose([float(m_s), float(c_s)], jax_curve, rtol=0,
                               atol=1e-10)
    assert "Ceres-Torch Solver Report" in out.stdout


def test_capi_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output (no quiet
    'unavailable')."""
    from ceres_tpu_torch import capi
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(capi, "SRC", bad)
    with pytest.raises(RuntimeError, match="building the C API shim"):
        capi.build(build_dir=tmp_path / "build")
