from . import cpx, linalg
