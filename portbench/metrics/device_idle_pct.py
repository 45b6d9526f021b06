"""device_idle_pct: the share of the traced window in which no operation ran
on the device (layer: device)."""


def read(run):
    d = run.digest
    if not d.window_ns or not d.busy_ns:
        return None
    return 100.0 * (1.0 - d.busy_ns / d.window_ns)
