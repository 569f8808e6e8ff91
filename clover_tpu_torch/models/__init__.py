"""Solvers built on the quantized ops: IHT and GD, single and batched, the
problem generators and the reference accuracy protocols."""

from .accuracy import ACCURACY_MU, GD_MU, run_gd_accuracy, run_iht_accuracy
from .batch import BatchSolveResult, gd_batched, iht_batched
from .problems import (
    make_gd_problem, make_gd_problem_reference, make_iht_problem,
    make_iht_problem_reference,
)
from .solvers import SolveResult, gd, iht

__all__ = ["iht", "gd", "SolveResult", "make_iht_problem",
           "make_gd_problem", "make_iht_problem_reference",
           "make_gd_problem_reference", "iht_batched", "gd_batched",
           "BatchSolveResult", "ACCURACY_MU", "GD_MU", "run_iht_accuracy",
           "run_gd_accuracy"]
