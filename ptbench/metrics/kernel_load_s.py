"""kernel_load_s: host clock around ``cuda_build.build()`` and
``load_library()`` (a build on the first run in a checkout, a cached load
after it)."""


def read(run):
    return run.spans["kernel_load_s"]
