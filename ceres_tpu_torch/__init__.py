"""ceres_tpu_torch: the PyTorch and CUDA port of ceres_tpu.

The ported slices, each solved by fused Levenberg-Marquardt in mixed
precision on one device named by SolverOptions.device ("cuda" runs the
hand-written Hopper kernels of csrc/, "cpu" their plain PyTorch
versions): Snavely bundle adjustment with DENSE_SCHUR, or with
ITERATIVE_SCHUR on an explicit reduced camera matrix; bundle adjustment
past the explicit cap (nf > 4096 camera columns) with ITERATIVE_SCHUR in
the implicit, matrix-free mode (K10 as the CG operator); and any problem
without Schur structure on the generic step with CGNR, pose-graph SLAM
(examples/slam.py) first. Module names mirror the JAX
package's; this package imports torch and never jax.
"""

from .types import (  # noqa: F401
    LinearSolverType, MinimizerType, ParameterBlockOrdering,
    PreconditionerType, SolverOptions, SolverSummary, TerminationType,
    TrustRegionStrategyType,
)
from .loss import (  # noqa: F401
    ArctanLoss, CauchyLoss, ComposedLoss, HuberLoss, LossFunction,
    LossFunctionWrapper, ScaledLoss, SoftLOneLoss, TolerantLoss, TrivialLoss,
    TukeyLoss,
)
from .manifolds import (  # noqa: F401
    AutoDiffManifold, EigenQuaternionManifold, EuclideanManifold, Manifold,
    QuaternionManifold,
)
from .cost import (  # noqa: F401
    AutoDiffCostFunction, CostFunction, SizedCostFunction,
)
from .problem import Problem, ResidualBlockId  # noqa: F401
from .solver import Solver, solve  # noqa: F401
from . import rotation  # noqa: F401

__version__ = "0.1.0"
