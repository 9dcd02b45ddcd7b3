# Architecture registry of the port: importing this package registers the
# dense GQA archs (the other families of the JAX package are later slices).
from . import dense_archs  # noqa: F401
from .base import arch_names, get_config  # noqa: F401
