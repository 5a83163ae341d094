"""``setup_s``: from the start of the process to the first timed burst:
starting the device, loading (or at the first run in a checkout,
compiling) the kernels, making the structure, filling its backlog and
warming every shape the window uses."""


def read(run):
    return run.setup_s
