"""ceres_tpu_torch's TinySolver (tiny_solver.py) against the JAX package's
tiny_solve on the CPU, in f64: Rosenbrock as least squares, the JAX
package's batch of 64 shifted identities (tests/test_aux_components.py's
vmap test, rng(0)), and a batch of 64 seeded Rosenbrock problems whose
iteration counts differ, each problem against jax.vmap's: the same count,
the same converged flag, x within 1e-10. A batched problem's trajectory
is the one it takes alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt

X_TOL = 1e-10


def rosenbrock_residual(T):
    def f(x, a):
        return T.stack([10.0 * (x[1] - x[0] ** 2), a - x[0]])
    return f


def seeded_rosenbrocks(n, seed=0):
    """n Rosenbrock problems: minimum (a, a^2), a in [0.5, 2), starts
    around (-1.2, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, n)
    x0 = np.array([-1.2, 1.0]) + 0.5 * rng.standard_normal((n, 2))
    return a, x0


def jax_batch(f, x0, args, options):
    """jax.vmap of ct.tiny_solve over the problems."""
    res = jax.vmap(lambda x, *a: ct.tiny_solve(lambda v: f(v, *a), x,
                                               options))(
        jnp.asarray(x0), *(jnp.asarray(a) for a in args))
    return [np.asarray(t) for t in res]


def assert_same(got, want):
    """got, want: [x, initial_cost, final_cost, iterations, converged]."""
    x, c0, c1, it, ok = (np.asarray(t) for t in got)
    assert np.array_equal(it, want[3])
    assert np.array_equal(ok, want[4])
    assert np.abs(x - want[0]).max() <= X_TOL
    assert np.abs(c0 - want[1]).max() <= 1e-12 * np.abs(want[1]).max()
    assert np.abs(c1 - want[2]).max() <= X_TOL


def test_rosenbrock_least_squares_matches_jax():
    opts_j = ct.TinySolverOptions(max_num_iterations=200)
    want = ct.tiny_solve(lambda x: rosenbrock_residual(jnp)(x, 1.0),
                         jnp.asarray([-1.2, 1.0]), opts_j)
    got = ctt.tiny_solve(lambda x: rosenbrock_residual(torch)(x, 1.0),
                         torch.tensor([-1.2, 1.0], dtype=torch.float64),
                         ctt.TinySolverOptions(max_num_iterations=200))
    assert_same(got, [np.asarray(t) for t in want])
    assert bool(got.converged) and int(got.iterations) > 5
    assert np.abs(got.x.numpy() - 1.0).max() < 1e-6
    assert float(got.final_cost) < 1e-12


@pytest.mark.parametrize("case", ["shifted_identity", "rosenbrock"])
def test_batch_matches_jax_vmap(case):
    """64 problems at once against jax.vmap, problem by problem."""
    if case == "shifted_identity":
        targets = np.random.default_rng(0).normal(size=(64, 2))
        x0, args = np.zeros((64, 2)), (targets,)

        def f_j(x, t):
            return x - t
        f_t = f_j
        opts = dict()
    else:
        a, x0 = seeded_rosenbrocks(64)
        args = (a,)
        f_j, f_t = rosenbrock_residual(jnp), rosenbrock_residual(torch)
        opts = dict(max_num_iterations=200)
    want = jax_batch(f_j, x0, args, ct.TinySolverOptions(**opts))
    got = ctt.tiny_solve(f_t, torch.tensor(x0, dtype=torch.float64),
                         ctt.TinySolverOptions(**opts),
                         args=tuple(torch.tensor(v) for v in args))
    assert_same(got, want)
    if case == "rosenbrock":
        assert len(set(want[3].tolist())) > 5          # counts differ
        assert want[4].all()
        sol = np.stack([a, a * a], axis=1)
        assert np.abs(got.x.numpy() - sol).max() < 1e-6
    else:
        assert np.abs(got.x.numpy() - args[0]).max() <= 1e-10


def test_batched_problem_runs_as_it_runs_alone():
    """Problems in a batch keep their own radius, count and done flag: the
    batch's result for each problem equals the single solve's, and the
    object API with an explicit Jacobian gives the same."""
    a, x0 = seeded_rosenbrocks(8, seed=3)
    f = rosenbrock_residual(torch)
    opts = ctt.TinySolverOptions(max_num_iterations=200)
    batch = ctt.tiny_solve(f, torch.tensor(x0), opts,
                           args=(torch.tensor(a),))

    def jac(x, a_):
        return torch.stack([torch.stack([-20.0 * x[0],
                                         torch.ones_like(x[0]) * 10.0]),
                            torch.stack([-torch.ones_like(x[0]),
                                         torch.zeros_like(x[0])])])
    solver = ctt.TinySolver(opts)
    for i in range(8):
        one = ctt.tiny_solve(lambda x: f(x, float(a[i])),
                             torch.tensor(x0[i]), opts)
        assert int(one.iterations) == int(batch.iterations[i])
        assert torch.allclose(one.x, batch.x[i], rtol=0, atol=1e-12)
        mine = solver.solve(f, torch.tensor(x0[i]), jacobian_fn=jac,
                            args=(torch.tensor(a[i]),))
        assert int(mine.iterations) == int(one.iterations)
        assert torch.allclose(mine.x, one.x, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["cpu_tensor", "numpy_on_cpu",
                                  "numpy_default"])
def test_x0_device(case):
    """A tensor x0 keeps its device under the default options (the card);
    numpy goes to options.device: the CPU when asked, else the card, which
    a machine without one refuses."""
    a, x0 = seeded_rosenbrocks(4, seed=5)
    f = rosenbrock_residual(torch)
    opts = ctt.TinySolverOptions(max_num_iterations=200)
    assert opts.device == "cuda"
    want = ctt.tiny_solve(f, torch.tensor(x0), opts._replace(device="cpu"),
                          args=(torch.tensor(a),))
    if case == "numpy_default":
        if torch.cuda.is_available():
            got = ctt.tiny_solve(f, x0, opts, args=(a,))
            assert got.x.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                ctt.tiny_solve(f, x0, opts, args=(a,))
        return
    if case == "cpu_tensor":
        got = ctt.tiny_solve(f, torch.tensor(x0), opts,
                             args=(torch.tensor(a),))
    else:
        got = ctt.tiny_solve(f, x0, opts._replace(device="cpu"), args=(a,))
    assert got.x.device.type == "cpu"
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.x, want.x)
