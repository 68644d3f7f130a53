"""Set-up: from the process's start to the end of the warm-up frames (the
imports, the build or load of the kernels, the scene, the guide, the
cell's shapes warmed).  Host clock."""


def read(run):
    return run.setup_s
