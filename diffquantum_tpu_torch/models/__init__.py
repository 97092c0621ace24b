from . import maxcut
from . import vqe_h2
from . import control
