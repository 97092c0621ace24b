from .checkpointing import save_checkpoint, load_checkpoint
from .device import resolve_device
from .logger import Logger, NullLogger
