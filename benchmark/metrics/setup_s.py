"""Process start to the first timed call (host clock): importing torch
and the program, building or loading the kernels, making the weights
and inputs, the program's own set-up and the warm-up calls."""


def read(r):
    return r.setup_s
