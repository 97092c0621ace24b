from .config import TrainConfig
from .energy import (TrainResult, make_optimizer, train_energy,
                     train_energy_fd)
