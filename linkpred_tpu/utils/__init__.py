"""Timing, logging, debug, RNG utilities."""
from .timing import measure_duration, measure_duration_marked
from .logging import graph_line, log, result_line
from .random import Xorshift32, xorshift32_step

__all__ = ["measure_duration", "measure_duration_marked",
           "log", "graph_line", "result_line", "Xorshift32", "xorshift32_step"]
