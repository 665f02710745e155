"""setup_s: seconds from the process's start to the first timed call
(imports, the card, the inputs and weights, the warm-up; the kernels'
build in a checkout's first run)."""


def read(r):
    return r.setup_s
