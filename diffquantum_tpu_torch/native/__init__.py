from . import bindings
