"""setup_s: process start to the first timed frame (the kernel library, the
scene, its BVHs, the Renderer and the warm-up frames)."""


def read(run):
    return run.spans["setup_s"]
