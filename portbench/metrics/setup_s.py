"""setup_s: seconds from the process's start to the window's: drawing the
data, building the kernels, the inserts, the upload and the warm calls."""


def read(run):
    return run.setup_s
