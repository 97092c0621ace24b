"""problem_build_s: the host seconds of the process's first
``build.problem`` span (models/maxcut.py's build_maxcut, imports
excluded), a span the program records always."""
from harness import program_spans

UNIT, SOURCE, BETTER = "s", "host_clock", "lower"
LAYER, MOVES, WORKLOADS = "problem build (host)", "setup_s", None


def read(run, tracer=None):
    return program_spans.first_host_s("build.problem", tracer)
