from .basis import basis_matrix
from .envelope import SimpleEnvelope
