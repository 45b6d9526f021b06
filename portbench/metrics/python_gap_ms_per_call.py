"""python_gap_ms_per_call: device idle ms a call in the traced window whose
innermost host span is one of the program's ``gf.`` spans: the card waiting
on the program's own Python outside any torch op (layer: decode entry)."""


def read(run):
    d = run.digest
    ns = sum(e - s for s, e, name in d.gaps if name.startswith("gf."))
    if not d.calls or not d.busy_ns or not ns:
        return None
    return ns / 1e6 / d.calls
