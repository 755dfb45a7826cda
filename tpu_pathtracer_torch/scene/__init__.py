from .assets import DEFAULT_SCENE, SCENE_NAMES, golden_path, scene_path  # noqa: F401
from .objmtl import ObjMesh, load_obj, parse_mtl  # noqa: F401
from .scene import (Scene, area_light_power, attach_dispersion, attach_env,  # noqa: F401
                    build_scene, load_scene, scene_arrays, scene_to)
