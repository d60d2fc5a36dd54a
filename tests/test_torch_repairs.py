"""Repairs of ceres_tpu_torch, on the CPU.

Nested losses key their buckets (program.py _loss_key): residual blocks
whose wrapper losses (ScaledLoss, ComposedLoss, LossFunctionWrapper)
differ only in their inner loss land in different buckets, and each
block is priced by its own loss, as Ceres prices it. Held to the closed
form (1-D residuals 3 and 5 under HuberLoss(0.1) and CauchyLoss(10):
0.5 (2 a |r| - a^2) + 0.5 b^2 log1p(r^2 / b^2) = 0.295 + 11.157), not
to the JAX package, which keys them alike (ceres_tpu/program.py:67-82).

The Snavely kernels take the port's own SnavelyReprojectionError only,
by exact type (ops/linearize.py is_snavely_bucket, the JAX package's
rule, ops/pallas_lin.py:555-575): a subclass that returns twice the base
residual takes K5 on the explicit step and the auto spec on the generic
and implicit steps, and its DENSE_SCHUR solve on the parity kit's small
problem reaches the JAX package's final cost (within 1e-6 relative, as
tests/test_torch_autolin.py holds its solves); a user's own class that
happens to be named SnavelyReprojectionError takes the same routes.

A loss's bool and str attributes key its bucket with their values, so
one instance per block still shares a bucket. Every K11 hand spec
matches by exact type: a same-named subclass of a pose-graph term
linearizes to twice the base class's r and J.
"""

import math

import numpy as np
import pytest
import torch

from torch_parity_kit import (JaxDoubled, TorchDoubled, ct, ctt,
                              functor_problem, main_path_options, small_bal)

from ceres_tpu_torch.examples.snavely import SnavelyReprojectionError
from ceres_tpu_torch.ops.jet_compile import AutoSpec
from ceres_tpu_torch.ops.linearize import SPECS, is_snavely_bucket
from ceres_tpu_torch.program import CompiledProgram

torch.set_num_threads(1)

# ---- nested losses ----

HUBER_A, CAUCHY_A = 0.1, 10.0
CLOSED_FORM = (0.5 * (2.0 * HUBER_A * 3.0 - HUBER_A ** 2)
               + 0.5 * CAUCHY_A ** 2 * math.log1p(25.0 / CAUCHY_A ** 2))

WRAPPERS = {
    "ScaledLoss": lambda rho: ctt.ScaledLoss(rho, 1.0),
    "ComposedLoss": lambda rho: ctt.ComposedLoss(rho, ctt.TrivialLoss()),
    "LossFunctionWrapper": lambda rho: ctt.LossFunctionWrapper(rho),
}


class _Offset:
    """r = x (1-D)."""

    def __call__(self, x):
        return x


def _two_block_problem(losses):
    prob = ctt.Problem()
    for value, loss in zip((3.0, 5.0), losses):
        prob.add_residual_block(ctt.AutoDiffCostFunction(_Offset(), 1, [1]),
                                loss, np.array([value]))
    return prob


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_nested_losses_take_their_own_buckets(wrapper):
    make = WRAPPERS[wrapper]
    prob = _two_block_problem([make(ctt.HuberLoss(HUBER_A)),
                               make(ctt.CauchyLoss(CAUCHY_A))])
    program = CompiledProgram(prob, device="cpu")
    assert len(program.buckets) == 2
    cost = float(program.cost_fn(program.initial_state()))
    assert abs(CLOSED_FORM - 11.452) < 5e-4
    assert abs(cost - CLOSED_FORM) <= 1e-12 * CLOSED_FORM


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_equal_nested_losses_share_a_bucket(wrapper):
    """Two instances of one loss with equal scalars still share a
    bucket, and a different inner scalar splits it."""
    make = WRAPPERS[wrapper]
    same = CompiledProgram(_two_block_problem(
        [make(ctt.HuberLoss(HUBER_A)), make(ctt.HuberLoss(HUBER_A))]),
        device="cpu")
    other = CompiledProgram(_two_block_problem(
        [make(ctt.HuberLoss(HUBER_A)), make(ctt.HuberLoss(2 * HUBER_A))]),
        device="cpu")
    assert len(same.buckets) == 1 and len(other.buckets) == 2


# ---- the Snavely kernels by exact type ----

def _own_class_named_snavely():
    """A user's own class named SnavelyReprojectionError, not derived
    from the port's, with TorchDoubled's residual."""
    port = SnavelyReprojectionError

    class SnavelyReprojectionError_:
        def __init__(self, observed_x, observed_y):
            self.observed_x = observed_x
            self.observed_y = observed_y

        def __call__(self, camera, point):
            return 2.0 * port.__call__(self, camera, point)

    SnavelyReprojectionError_.__name__ = "SnavelyReprojectionError"
    return SnavelyReprojectionError_


FUNCTORS = {"subclass": lambda: TorchDoubled,
            "same-name": _own_class_named_snavely}


@pytest.mark.parametrize("functor", list(FUNCTORS))
def test_other_snavely_classes_take_the_generic_routes(functor):
    cls = FUNCTORS[functor]()
    assert cls is not SnavelyReprojectionError
    program = CompiledProgram(functor_problem(ctt, cls, small_bal()),
                              device="cpu")
    bk = program.buckets[0]
    assert not is_snavely_bucket(bk)
    assert isinstance(bk.spec, AutoSpec)
    base = CompiledProgram(functor_problem(
        ctt, SnavelyReprojectionError, small_bal()), device="cpu")
    assert is_snavely_bucket(base.buckets[0])
    assert base.buckets[0].spec is SPECS[SnavelyReprojectionError]


@pytest.fixture(scope="module")
def jax_doubled():
    bal = small_bal()
    return bal, ct.solve(main_path_options(ct),
                         functor_problem(ct, JaxDoubled, bal))


@pytest.mark.parametrize("functor", list(FUNCTORS))
def test_subclass_solve_matches_jax(jax_doubled, functor):
    """DENSE_SCHUR on the doubled residual: the port through K5 to the
    JAX package's final cost (ROADMAP.md's check had the JAX package go
    427704.70 -> 4213.95, and the port, before the repair, solve the
    base problem to 1053.49)."""
    bal, s_j = jax_doubled
    s_t = ctt.solve(main_path_options(ctt),
                    functor_problem(ctt, FUNCTORS[functor](), bal))
    assert "K5" in s_t.message
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_iterations == s_j.num_iterations
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost
    # four times the base problem's cost at the start
    base = CompiledProgram(functor_problem(
        ctt, SnavelyReprojectionError, bal), device="cpu")
    c0 = float(base.cost_fn(base.initial_state()))
    assert abs(s_t.initial_cost - 4.0 * c0) <= 1e-9 * s_t.initial_cost


# ---- loss attributes that are neither scalars nor losses ----

class _SwitchedHuber(ctt.LossFunction):
    """HuberLoss(a) when `robust`, else the trivial loss; `tag` names
    it. One instance per residual block, as user code often makes."""

    def __init__(self, a, robust, tag):
        self.a = float(a)
        self.robust = bool(robust)
        self.tag = str(tag)

    def evaluate(self, s):
        if self.robust:
            return ctt.HuberLoss(self.a).evaluate(s)
        return ctt.TrivialLoss().evaluate(s)


SWITCHED = {   # second block's loss, buckets, closed-form cost
    "same": ((HUBER_A, True, "x"), 1,
             0.5 * (2.0 * HUBER_A * 3.0 - HUBER_A ** 2)
             + 0.5 * (2.0 * HUBER_A * 5.0 - HUBER_A ** 2)),
    "bool": ((HUBER_A, False, "x"), 2,
             0.5 * (2.0 * HUBER_A * 3.0 - HUBER_A ** 2) + 0.5 * 25.0),
    "str": ((HUBER_A, True, "y"), 2,
            0.5 * (2.0 * HUBER_A * 3.0 - HUBER_A ** 2)
            + 0.5 * (2.0 * HUBER_A * 5.0 - HUBER_A ** 2)),
}


@pytest.mark.parametrize("case", list(SWITCHED))
def test_bool_and_str_loss_attributes_key_buckets(case):
    """Bool and str attributes are part of a loss's key with their
    values: equal instances share a bucket, a different value splits
    it, and each block is priced by its own loss."""
    args, n_buckets, want = SWITCHED[case]
    program = CompiledProgram(_two_block_problem(
        [_SwitchedHuber(HUBER_A, True, "x"), _SwitchedHuber(*args)]),
        device="cpu")
    assert len(program.buckets) == n_buckets
    cost = float(program.cost_fn(program.initial_state()))
    assert abs(cost - want) <= 1e-12 * want


# ---- every hand spec by exact type ----

def _same_named_subclass(base):
    """A subclass of base under base's own name, residual doubled."""
    cls = type(base.__name__, (base,), {
        "__call__": lambda self, *ps: 2.0 * base.__call__(self, *ps)})
    assert cls.__name__ == base.__name__ and cls is not base
    return cls


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_pose_graph_hand_specs_match_by_exact_type(dim, monkeypatch):
    """A pose-graph term's same-named subclass gets no hand spec (each
    hard-codes the base residual): its bucket linearizes to twice the
    base class's r and J (the tolerances of
    tests/test_torch_linearize.py)."""
    from ceres_tpu_torch.examples import slam
    from ceres_tpu_torch.io import g2o

    name = f"PoseGraph{dim}ErrorTerm"
    base = getattr(slam, name)
    graph = getattr(g2o, f"synthetic_pose_graph_{dim}")(
        num_poses=70, seed=4, loop_every=5)
    build = getattr(slam, f"build_pose_graph_{dim}_problem")
    programs = {}
    for kind in ("base", "subclass"):
        with monkeypatch.context() as m:
            if kind == "subclass":
                m.setattr(slam, name, _same_named_subclass(base))
            programs[kind] = CompiledProgram(
                build(graph[0], graph[1])[0], device="cpu")
    out = {}
    for kind, program in programs.items():
        bk = max(program.buckets, key=lambda b: b.n)
        assert (bk.spec is SPECS[base]) == (kind == "base")
        out[kind] = program._bucket_linearize32(bk, program.initial_state())
    (r0, J0), (r1, J1) = out["base"], out["subclass"]
    np.testing.assert_allclose(r1.numpy(), 2.0 * r0.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(J1.numpy(), 2.0 * J0.numpy(),
                               rtol=2e-4, atol=2e-4)
