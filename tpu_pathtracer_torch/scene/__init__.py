from .assets import DEFAULT_SCENE, SCENE_NAMES, golden_path, scene_path  # noqa: F401
from .objmtl import ObjMesh, load_obj, parse_mtl  # noqa: F401
from .scene import (Scene, area_light_power, attach_env, build_scene,  # noqa: F401
                    load_scene, scene_arrays, scene_to)
