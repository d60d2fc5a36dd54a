"""Checkpoint and resume for long solves.

Counterpart of ceres_tpu/checkpoint.py. The reference has no built-in
checkpointing; users emulate it with update_state_every_iteration and an
IterationCallback, as CheckpointCallback does:

  * save_state / load_state: every parameter block's values (and the
    iteration and trust-region radius) to and from an .npz;
  * CheckpointCallback: an IterationCallback that snapshots the user
    arrays every k successful iterations (with
    update_state_every_iteration they hold the current iterate);
  * dump_linear_problem: the inner linear least-squares problem
    (J, b, D, x) to an .npz (the reference's
    DumpLinearLeastSquaresProblem, linear_least_squares_problems.cc:84),
    J made dense by ops/bsr.py's to_dense.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .types import CallbackReturnType


def save_state(path: str, problem, iteration: int = 0,
               trust_region_radius: float = 1e4,
               extra: Optional[dict] = None):
    """Snapshot all parameter-block values (and the scalars) to an npz."""
    blocks = problem.parameter_blocks()
    payload = {f"block_{i}": np.asarray(b) for i, b in enumerate(blocks)}
    payload["iteration"] = np.asarray(iteration)
    payload["trust_region_radius"] = np.asarray(trust_region_radius)
    for k, v in (extra or {}).items():
        payload["extra_" + k] = np.asarray(v)
    np.savez(path, **payload)


def load_state(path: str, problem) -> dict:
    """Restore the parameter-block values in place; returns the scalars
    (and the extras) of the snapshot."""
    data = np.load(path)
    for i, b in enumerate(problem.parameter_blocks()):
        key = f"block_{i}"
        if key not in data:
            raise ValueError(f"checkpoint missing {key}; problem structure "
                             "changed since the snapshot")
        if data[key].shape != b.shape:
            raise ValueError(f"{key} shape mismatch")
        b[:] = data[key]
    out = {"iteration": int(data["iteration"]),
           "trust_region_radius": float(data["trust_region_radius"])}
    for k in data.files:
        if k.startswith("extra_"):
            out[k[6:]] = data[k]
    return out


class CheckpointCallback:
    """An IterationCallback writing a snapshot every k iterations whose
    step succeeded, from the user arrays (so use it with
    update_state_every_iteration, which keeps them current)."""

    def __init__(self, problem, directory: str, every_k_iterations: int = 5,
                 prefix: str = "ceres_tpu_ckpt"):
        self.problem = problem
        self.directory = directory
        self.every = max(1, every_k_iterations)
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)

    def __call__(self, iteration_summary):
        it = iteration_summary.iteration
        if it % self.every == 0 and iteration_summary.step_is_successful:
            path = os.path.join(self.directory,
                                f"{self.prefix}_{it:05d}.npz")
            save_state(path, self.problem, iteration=it,
                       trust_region_radius=(
                           iteration_summary.trust_region_radius))
        return CallbackReturnType.SOLVER_CONTINUE


def _numpy(t):
    return (t.detach().to("cpu").numpy() if torch.is_tensor(t)
            else np.asarray(t))


def dump_linear_problem(path: str, jac, res, D, x):
    """The inner problem of one iteration: jac a BlockJacobian, res an
    RVec, D and x tensors (or arrays), to an npz (jacobian, rhs, D, x)."""
    np.savez(path, jacobian=_numpy(jac.to_dense()),
             rhs=_numpy(res.flatten()), D=_numpy(D), x=_numpy(x))
