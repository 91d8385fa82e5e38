from jaxvo.ba.window import BAProblem, ba_solve, build_problem_from_vo, linearize_ba
from jaxvo.ba.posegraph import PoseGraph, build_graph, pgo_solve

__all__ = [
    "BAProblem",
    "ba_solve",
    "build_problem_from_vo",
    "linearize_ba",
    "PoseGraph",
    "build_graph",
    "pgo_solve",
]
