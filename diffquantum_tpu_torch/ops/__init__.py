from . import cpx, expm, linalg
