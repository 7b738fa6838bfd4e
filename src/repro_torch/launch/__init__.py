"""Device meshes for sharded sweeps (the port of ``repro.launch``)."""
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     single_device_mesh)

__all__ = ["make_local_mesh", "make_production_mesh", "single_device_mesh"]
