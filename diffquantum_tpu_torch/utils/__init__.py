from .device import resolve_device
from .logger import Logger, NullLogger
