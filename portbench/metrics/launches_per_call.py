"""launches_per_call: the program's kernel launches in the traced window over
its calls (layer: op dispatch)."""


def read(run):
    d = run.digest
    kernels = sum(1 for kind, *_ in d.ops if kind == "kernel")
    if not d.calls or not kernels:
        return None
    return kernels / d.calls
