from . import maxcut
