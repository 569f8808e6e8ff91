"""Solvers built on the quantized ops: IHT and GD, single and batched, and
the IHT problem generator."""

from .batch import BatchSolveResult, gd_batched, iht_batched
from .problems import make_iht_problem
from .solvers import SolveResult, gd, iht

__all__ = ["iht", "gd", "SolveResult", "make_iht_problem",
           "iht_batched", "gd_batched", "BatchSolveResult"]
