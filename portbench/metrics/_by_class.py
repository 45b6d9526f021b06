"""Self device time a call of the program's kernels of one class
('hand', 'gemm' or 'torch', as ``portbench.kernels.classify`` sorts them)."""

from portbench.kernels import classify, port_kernel_names


def ms_per_call(run, cls):
    d = run.digest
    names = port_kernel_names(str(run.root))
    ns = sum(e - s for kind, name, s, e in d.ops if kind == "kernel" and classify(name, names) == cls)
    if not d.calls or not ns:
        return None
    return ns / 1e6 / d.calls
