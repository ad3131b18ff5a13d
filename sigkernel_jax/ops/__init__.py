from . import scan_solver, gpu_wavefront, solve  # noqa: F401
from .solve import solve as solve_goursat, solve_with_grid  # noqa: F401
