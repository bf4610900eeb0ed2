"""Launch helpers of the port (port of ``repro.launch``): the host and
production meshes (``mesh``), the assigned input shapes (``shapes``), the
H100 roofline and the kernels' work (``roofline``), the op-level cost
walker (``hlo_analysis``) and the whole-step dry run (``dryrun``, run as
``python -m repro_torch.launch.dryrun``)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
