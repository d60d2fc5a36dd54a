// K1's entry points for no loss and the stock scalar losses: the
// instances of csrc/lin_k1.cuh's chain, one a loss class (ops/lin.py
// K1_ENTRIES picks one by the loss's exact class). Any other loss runs a
// generated unit, a loss struct emitted by ops/lin.py from the loss's
// traced rho' and rho'' around the same header.

#include "lin_k1.cuh"

CERES_LIN_ENTRY(ceres_lin, NoLoss)
CERES_LIN_ENTRY(ceres_lin_huber, HuberK1)
CERES_LIN_ENTRY(ceres_lin_soft_l_one, SoftLOneK1)
CERES_LIN_ENTRY(ceres_lin_cauchy, CauchyK1)
CERES_LIN_ENTRY(ceres_lin_arctan, ArctanK1)
CERES_LIN_ENTRY(ceres_lin_tolerant, TolerantK1)
CERES_LIN_ENTRY(ceres_lin_tukey, TukeyK1)
