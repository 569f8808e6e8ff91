"""Solvers built on the quantized ops: IHT and GD, and the IHT problem
generator."""

from .problems import make_iht_problem
from .solvers import SolveResult, gd, iht

__all__ = ["iht", "gd", "SolveResult", "make_iht_problem"]
