from .mesh import SeedsResult, make_mesh, train_energy_seeds
