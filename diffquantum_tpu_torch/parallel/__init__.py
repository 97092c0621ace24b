from .mesh import Mesh, SeedsResult, make_mesh, train_energy_seeds
from .sharded_state import evolve_product_sharded, sharded_diag_expectation
