from .engine import ScoringEngine
from .request import SERVED_FROM, ScoreResponse, make_window, top_k_cut

__all__ = ["SERVED_FROM", "ScoreResponse", "ScoringEngine", "make_window", "top_k_cut"]
