from .lens import Lens
from .materials import Material
from .rays import RayBundle, make_rays, project_to, propagate_to
from .surfaces import SurfaceMeta, SurfaceParams, make_surface, ray_reaction

__all__ = [
    "Material", "RayBundle", "make_rays", "project_to", "propagate_to",
    "SurfaceMeta", "SurfaceParams", "make_surface", "ray_reaction", "Lens",
]
