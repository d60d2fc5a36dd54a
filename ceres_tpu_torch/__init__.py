"""ceres_tpu_torch: the PyTorch and CUDA port of ceres_tpu.

The ported slices, on one device named by SolverOptions.device ("cuda"
runs the hand-written Hopper kernels of csrc/, "cpu" their plain PyTorch
versions): Ceres's default Solve (Levenberg-Marquardt or dogleg in the
host-loop trust-region minimizer, DENSE_QR, DENSE_NORMAL_CHOLESKY or
CGNR, f64 or mixed, bounds, iteration and evaluation callbacks,
autodiff, analytic and numeric-difference costs); Snavely bundle
adjustment with DENSE_SCHUR, or with ITERATIVE_SCHUR on an explicit
reduced camera matrix, mixed, in either loop; bundle adjustment past the
explicit cap (nf > 4096 camera columns) with ITERATIVE_SCHUR in the
implicit, matrix-free mode (K10 as the CG operator); and any problem
without Schur structure on the generic step, pose-graph SLAM
(examples/slam.py) first, with SPARSE_NORMAL_CHOLESKY on the package's
native host LDL^T (native.py, built with g++ at first use), CGNR with
block Jacobi or SUBSET, dynamic sparsity; Covariance (DENSE_SVD,
SPARSE_QR); the stock manifolds; the line-search minimizer (steepest
descent, nonlinear CG, L-BFGS, BFGS; Armijo or Wolfe) on a Problem or a
GradientProblem; TinySolver, one small dense problem or a batch; and
the rest of the modeling API: Problem.evaluate on `device` (residuals,
gradient, dense or CSR Jacobian, subsets), block removal and the
accessors, ProblemOptions, the dynamic and adapter costs, the rotation
conversions, the cubic interpolators, GradientChecker and
check_gradients, checkpoints and timers; solve_batched (batch.py), many
problems of one structure in batch or pipeline mode.
Module names mirror the JAX package's; this package imports torch and
never jax.
"""

from .types import (  # noqa: F401
    CallbackReturnType, CovarianceAlgorithmType,
    DenseLinearAlgebraLibraryType, DoglegType, DumpFormatType,
    EvaluationCallback,
    IterationSummary, LineSearchDirectionType, LineSearchInterpolationType,
    LineSearchType, LinearSolverType, LoggingType, MinimizerType,
    NonlinearConjugateGradientType, NumericDiffMethodType, OrderingType,
    ParameterBlockOrdering, PreconditionerType, SolverOptions, SolverSummary,
    SparseLinearAlgebraLibraryType,
    TerminationType, TrustRegionStrategyType, VisibilityClusteringType,
)
from .loss import (  # noqa: F401
    ArctanLoss, CauchyLoss, ComposedLoss, HuberLoss, LossFunction,
    LossFunctionWrapper, ScaledLoss, SoftLOneLoss, TolerantLoss, TrivialLoss,
    TukeyLoss,
)
from .manifolds import (  # noqa: F401
    AutoDiffManifold, EigenQuaternionManifold, EuclideanManifold, LineManifold,
    Manifold, ProductManifold, QuaternionManifold, SphereManifold,
    SubsetManifold,
)
from .cost import (  # noqa: F401
    AutoDiffCostFunction, ConditionedCostFunction, CostFunction,
    CostFunctionToFunctor, DynamicAutoDiffCostFunction,
    DynamicCostFunctionToFunctor,
    DynamicNumericDiffCostFunction, NormalPrior, NumericDiffCostFunction,
    NumericDiffOptions, SizedCostFunction,
)
from .problem import Problem, ProblemOptions, ResidualBlockId  # noqa: F401
from .solver import Solver, solve  # noqa: F401
from .batch import solve_batched  # noqa: F401
from .covariance import Covariance, CovarianceOptions  # noqa: F401
from .gradient_checker import GradientChecker  # noqa: F401
from .gradient_problem import (  # noqa: F401
    AutoDiffFirstOrderFunction, FirstOrderFunction, GradientProblem,
    GradientProblemSolver, NumericDiffFirstOrderFunction,
    solve_gradient_problem,
)
from .interpolation import (  # noqa: F401
    BiCubicInterpolator, CubicInterpolator, Grid1D, Grid2D,
)
from .tiny_solver import (  # noqa: F401
    TinySolver, TinySolverOptions, TinySolverResult, tiny_solve,
)
from . import rotation  # noqa: F401

__version__ = "0.1.0"
