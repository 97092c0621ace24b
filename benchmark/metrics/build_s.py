"""build_s: a harness span around the program's problem build on the host
(models/maxcut.py's build_maxcut: the structured Hamiltonian, measurement
and initial state; the packed tables are built in the warm-up's first
call)."""
UNIT, SOURCE, BETTER = "s", "host_clock", "lower"
LAYER, MOVES, WORKLOADS = "problem build (host)", "setup_s", None


def read(run):
    return run.spans.get("build")
