"""optim_init_s: the host seconds of the process's first
``train.optim_init`` span (make_optimizer in parallel/mesh.py's
train_energy_seeds, in the warm-up job: torch.optim.Adam's first
construction, which imports torch._dynamo), a span the program records
always."""
from harness import program_spans

UNIT, SOURCE, BETTER = "s", "host_clock", "lower"
LAYER, MOVES, WORKLOADS = "set-up (host)", "setup_s", None


def read(run, tracer=None):
    return program_spans.first_host_s("train.optim_init", tracer)
