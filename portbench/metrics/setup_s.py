"""``setup_s``: seconds from the process's start to the window's start (the
program's import, the kernel library's load or build, the inputs, one warm
unit)."""


def read(run):
    return run.setup_s
