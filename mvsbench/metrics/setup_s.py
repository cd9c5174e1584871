"""Set-up: process start to the first timed call (imports, rendering and
writing the workspace, the kernel library's load or build, one warm call
of each pass kind)."""


def read(run):
    return run.setup_s
