"""Launch helpers of the port (port of part of ``repro.launch``): the host
and production meshes. The shapes, the roofline, the dry run and the
compiled-artifact analysis come with ``ROADMAP.md``'s queue 1 slice 11b."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
