"""NIST StRD nonlinear regression suite: parser, models, LRE scoring.

Capability parity with the reference's examples/nist.cc (716 LoC): loads the
27 NIST .dat files (both certified starting points), builds least-squares
problems over the published model formulas, and scores solutions with the
log-relative-error metric (nist.cc ComputeLRE :563-566; Ceres reports
average LRE 9.4 on this suite).

The model formulas are the public NIST StRD definitions
(https://www.itl.nist.gov/div898/strd/nls/nls_main.shtml), written as
functions of (b, x) -> y_hat in torch operations (ceres_tpu/io/nist.py
writes them in jnp), mapped across observations by the program's
torch.func.vmap. Nelson uses the log-response form as in the reference.
"""

from __future__ import annotations

import os
import re
from typing import List, NamedTuple

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


# name -> (num_params, model fn(b, x_row) -> scalar prediction)
NIST_MODELS = {
    "Misra1a": (2, lambda b, x: b[0] * (1.0 - torch.exp(-b[1] * x[0]))),
    "Misra1b": (2, lambda b, x: b[0] * (1.0 - (1.0 + b[1] * x[0] / 2.0)
                                        ** -2)),
    "Misra1c": (2, lambda b, x: b[0] * (1.0 - (1.0 + 2.0 * b[1] * x[0])
                                        ** -0.5)),
    "Misra1d": (2, lambda b, x: b[0] * b[1] * x[0]
                / (1.0 + b[1] * x[0])),
    "Chwirut1": (3, lambda b, x: torch.exp(-b[0] * x[0])
                 / (b[1] + b[2] * x[0])),
    "Chwirut2": (3, lambda b, x: torch.exp(-b[0] * x[0])
                 / (b[1] + b[2] * x[0])),
    "Lanczos1": (6, lambda b, x: b[0] * torch.exp(-b[1] * x[0])
                 + b[2] * torch.exp(-b[3] * x[0])
                 + b[4] * torch.exp(-b[5] * x[0])),
    "Lanczos2": (6, lambda b, x: b[0] * torch.exp(-b[1] * x[0])
                 + b[2] * torch.exp(-b[3] * x[0])
                 + b[4] * torch.exp(-b[5] * x[0])),
    "Lanczos3": (6, lambda b, x: b[0] * torch.exp(-b[1] * x[0])
                 + b[2] * torch.exp(-b[3] * x[0])
                 + b[4] * torch.exp(-b[5] * x[0])),
    "Gauss1": (8, lambda b, x: b[0] * torch.exp(-b[1] * x[0])
               + b[2] * torch.exp(-((x[0] - b[3]) ** 2) / b[4] ** 2)
               + b[5] * torch.exp(-((x[0] - b[6]) ** 2) / b[7] ** 2)),
    "Gauss2": (8, lambda b, x: b[0] * torch.exp(-b[1] * x[0])
               + b[2] * torch.exp(-((x[0] - b[3]) ** 2) / b[4] ** 2)
               + b[5] * torch.exp(-((x[0] - b[6]) ** 2) / b[7] ** 2)),
    "Gauss3": (8, lambda b, x: b[0] * torch.exp(-b[1] * x[0])
               + b[2] * torch.exp(-((x[0] - b[3]) ** 2) / b[4] ** 2)
               + b[5] * torch.exp(-((x[0] - b[6]) ** 2) / b[7] ** 2)),
    "DanWood": (2, lambda b, x: b[0] * x[0] ** b[1]),
    "BoxBOD": (2, lambda b, x: b[0] * (1.0 - torch.exp(-b[1] * x[0]))),
    "Rat42": (3, lambda b, x: b[0] / (1.0 + torch.exp(b[1] - b[2] * x[0]))),
    "MGH17": (5, lambda b, x: b[0] + b[1] * torch.exp(-x[0] * b[3])
              + b[2] * torch.exp(-x[0] * b[4])),
    "Thurber": (7, lambda b, x: (b[0] + b[1] * x[0] + b[2] * x[0] ** 2
                                 + b[3] * x[0] ** 3)
                / (1.0 + b[4] * x[0] + b[5] * x[0] ** 2
                   + b[6] * x[0] ** 3)),
    "MGH09": (4, lambda b, x: b[0] * (x[0] ** 2 + x[0] * b[1])
              / (x[0] ** 2 + x[0] * b[2] + b[3])),
    "MGH10": (3, lambda b, x: b[0] * torch.exp(b[1] / (x[0] + b[2]))),
    "Eckerle4": (3, lambda b, x: (b[0] / b[1])
                 * torch.exp(-0.5 * ((x[0] - b[2]) / b[1]) ** 2)),
    "Rat43": (4, lambda b, x: b[0]
              / ((1.0 + torch.exp(b[1] - b[2] * x[0])) ** (1.0 / b[3]))),
    "Bennett5": (3, lambda b, x: b[0] * (b[1] + x[0]) ** (-1.0 / b[2])),
    "Kirby2": (5, lambda b, x: (b[0] + b[1] * x[0] + b[2] * x[0] ** 2)
               / (1.0 + b[3] * x[0] + b[4] * x[0] ** 2)),
    "Hahn1": (7, lambda b, x: (b[0] + b[1] * x[0] + b[2] * x[0] ** 2
                               + b[3] * x[0] ** 3)
              / (1.0 + b[4] * x[0] + b[5] * x[0] ** 2 + b[6] * x[0] ** 3)),
    # Nelson: log(y) = b1 - b2 x1 exp(-b3 x2); residual formed on log(y).
    "Nelson": (3, lambda b, x: b[0] - b[1] * x[0] * torch.exp(-b[2] * x[1])),
    "ENSO": (9, lambda b, x: b[0]
             + b[1] * torch.cos(TWO_PI * x[0] / 12.0)
             + b[2] * torch.sin(TWO_PI * x[0] / 12.0)
             + b[4] * torch.cos(TWO_PI * x[0] / b[3])
             + b[5] * torch.sin(TWO_PI * x[0] / b[3])
             + b[7] * torch.cos(TWO_PI * x[0] / b[6])
             + b[8] * torch.sin(TWO_PI * x[0] / b[6])),
    # Roszman1 uses the atan2 branch: for this dataset x - b4 < 0 at the
    # certified optimum, and the certified parameters correspond to
    # atan2(b3, x - b4) in (0, pi), not atan(b3/(x-b4)) in (-pi/2, 0).
    "Roszman1": (4, lambda b, x: b[0] - b[1] * x[0]
                 - torch.atan2(b[2], (x[0] - b[3])) / np.pi),
}

LOG_RESPONSE = {"Nelson"}


class NISTProblem(NamedTuple):
    name: str
    starts: np.ndarray          # [num_starts, num_params]
    certified: np.ndarray       # [num_params]
    certified_cost: float       # 0.5 * residual sum of squares
    x: np.ndarray               # [n, num_predictors]
    y: np.ndarray               # [n]
    num_params: int


def parse_nist_file(path: str) -> NISTProblem:
    """Parse the NIST StRD .dat format (nist.cc NISTProblem ctor)."""
    name = os.path.splitext(os.path.basename(path))[0]
    num_params, _ = NIST_MODELS[name]
    with open(path, errors="replace") as f:
        lines = f.readlines()

    # parameter rows: "  b1 =   500   250   2.389E+02  2.707E+00"
    starts1, starts2, cert = [], [], []
    float_re = r"[-+]?[\d.]+(?:[EeDd][-+]?\d+)?"
    for ln in lines:
        m = re.match(rf"\s*b\d+\s*=\s*({float_re})\s+({float_re})\s+"
                     rf"({float_re})\s+({float_re})", ln)
        if m:
            starts1.append(float(m.group(1).replace("D", "E")))
            starts2.append(float(m.group(2).replace("D", "E")))
            cert.append(float(m.group(3).replace("D", "E")))
    rss = None
    for ln in lines:
        if "Residual Sum of Squares" in ln:
            m = re.search(rf"({float_re})\s*$", ln)
            rss = float(m.group(1).replace("D", "E"))
            break

    # data section: after the *second* "Data:" marker line
    data_start = None
    seen = 0
    for i, ln in enumerate(lines):
        if ln.strip().startswith("Data:"):
            seen += 1
            if seen == 2:
                data_start = i + 1
                break
    rows = []
    for ln in lines[data_start:]:
        vals = re.findall(float_re, ln.replace("D", "E").replace("d", "E"))
        if vals:
            rows.append([float(v) for v in vals])
    data = np.asarray(rows, dtype=np.float64)
    y = data[:, 0]
    x = data[:, 1:]

    assert len(cert) == num_params, (name, len(cert), num_params)
    return NISTProblem(
        name=name,
        starts=np.asarray([starts1, starts2]),
        certified=np.asarray(cert),
        certified_cost=0.5 * rss if rss is not None else None,
        x=x, y=y, num_params=num_params)


def load_nist_suite(directory: str) -> List[NISTProblem]:
    out = []
    for name in sorted(NIST_MODELS):
        p = os.path.join(directory, name + ".dat")
        if os.path.exists(p):
            out.append(parse_nist_file(p))
    return out


def compute_lre(estimate, certified) -> float:
    """Minimum log-relative error across parameters (nist.cc:563-566),
    clamped to [0, 11]."""
    lre = 11.0
    for est, cert in zip(np.asarray(estimate), np.asarray(certified)):
        if est == cert:
            v = 11.0
        elif cert == 0.0:
            v = -np.log10(abs(est)) if est != 0 else 11.0
        else:
            rel = abs(est - cert) / abs(cert)
            v = 11.0 if rel == 0 else -np.log10(rel)
        lre = min(lre, max(0.0, min(11.0, v)))
    return lre


class NISTResidual:
    """y - f(b, x) (or log-response for Nelson), one residual per row."""

    def __init__(self, name, x_row, y_val):
        self.name = name
        self.x_row = x_row
        self.y_val = y_val

    def __call__(self, b):
        fn = NIST_MODELS[self.name][1]
        b = torch.as_tensor(b)
        pred = fn(b, torch.as_tensor(self.x_row, dtype=b.dtype))
        if self.name in LOG_RESPONSE:
            return torch.log(torch.as_tensor(self.y_val,
                                             dtype=pred.dtype)) - pred
        return self.y_val - pred


def build_nist_problem(nist: NISTProblem, start_index: int):
    """Returns (problem, b) ready to solve."""
    import ceres_tpu_torch as ct

    b = nist.starts[start_index].copy()
    problem = ct.Problem()
    name = nist.name
    fn = NIST_MODELS[name][1]
    log_resp = name in LOG_RESPONSE

    class Row:
        def __init__(self, x_row, y_val):
            self.x_row = x_row
            self.y_val = y_val

        def __call__(self, bb):
            pred = fn(bb, self.x_row)
            return (torch.log(torch.as_tensor(self.y_val,
                                              dtype=pred.dtype)) - pred) \
                if log_resp \
                else (self.y_val - pred)

    Row.__name__ = f"NISTRow_{name}"
    Row.__qualname__ = Row.__name__

    for i in range(nist.y.shape[0]):
        problem.add_residual_block(
            ct.AutoDiffCostFunction(Row(nist.x[i], nist.y[i]), 1,
                                    [nist.num_params]),
            None, b)
    return problem, b


def write_nist_test_file(path: str, name: str, x, y, starts, certified,
                         residual_sum_of_squares: float) -> None:
    """Write a problem in the NIST StRD .dat layout that parse_nist_file
    reads (a test helper: the NIST files are not in the repo). `name`
    must be a model of NIST_MODELS (the file's basename names the model
    when it is parsed); x [n] or [n, p], y [n]; starts (start 1, start
    2); the certified parameters and residual sum of squares. Every number
    is written to 17 significant digits."""
    x = np.asarray(x, np.float64).reshape(len(y), -1)
    fmt = "{:.16E}".format
    lines = ["NIST/ITL StRD (generated)",
             f"Dataset Name:  {name}",
             "",
             "Model:         see NIST_MODELS",
             "",
             "          Start 1             Start 2             "
             "Parameter           Standard Deviation"]
    for k, b in enumerate(certified):
        lines.append(f"  b{k + 1} = {fmt(starts[0][k])}  "
                     f"{fmt(starts[1][k])}  {fmt(b)}  {fmt(0.0)}")
    lines += ["",
              f"Residual Sum of Squares:  {fmt(residual_sum_of_squares)}",
              "",
              f"Data:  1 response, {x.shape[1]} predictor(s), "
              f"{len(y)} observations",
              "",
              "Data:   y   x"]
    for yi, xi in zip(np.asarray(y, np.float64), x):
        lines.append("  " + "  ".join([fmt(yi)] + [fmt(v) for v in xi]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
