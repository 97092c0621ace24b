from .config import TrainConfig
from .energy import (TrainResult, make_optimizer, train_energy,
                     train_energy_fd)
from .fidelity import train_fidelity
from .gate import gate_infidelity, train_gate
