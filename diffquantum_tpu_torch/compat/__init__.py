from . import diffqc
from .sim_plain import SimulatorPlain
