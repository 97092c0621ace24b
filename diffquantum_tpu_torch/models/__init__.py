from . import maxcut
from . import vqe_h2
from . import control
from . import tfim
from . import heisenberg
from . import molecule
