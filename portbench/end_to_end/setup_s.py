"""setup_s: process start (the first statement of run.py) to the first timed
call: imports, the CUDA context, the code and its constants, the input
ring, the warm-up calls (and, in a checkout's first run, the kernels'
compilation)."""


def read(w):
    return w.setup_s
