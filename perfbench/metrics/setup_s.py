"""``setup_s``: host seconds from the process's start to the first
measured step (loading, drawing the weights, warming the cell's shapes;
in a run that builds the kernels, the build)."""


def read(rec):
    return rec["setup_s"]
