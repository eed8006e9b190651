from .mesh import make_mesh  # noqa: F401
from .estep import sharded_estep  # noqa: F401
