"""wrapper_launches_per_call: launches a call counted by the program's kernel
wrappers (their ``.launches`` counters) over the window (layer: kernel
wrappers)."""


def read(run):
    total = sum(run.counters.values())
    if not run.window_calls or not total:
        return None
    return total / run.window_calls
