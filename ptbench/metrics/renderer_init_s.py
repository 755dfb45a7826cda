"""renderer_init_s: host clock around the scene build (OBJ, env map,
dispersion) and ``Renderer(...)`` (both BVH layouts and the route)."""


def read(run):
    return run.spans["renderer_init_s"]
