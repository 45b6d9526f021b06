"""call_roofline: a call's byte bound over its device busy time (layer:
kernels, as a whole). The bytes are those of the configuration's map
(``portbench/maps/<roofline_map>.py``), each input read and each output
written once; the bound is the bytes over the card's HBM bandwidth from
``portbench/peaks.json``. The busy time is the union of the program's
device operations in the window, over the calls."""

import importlib

from portbench.peaks import hbm_bytes_per_s


def read(run):
    d = run.digest
    bw = hbm_bytes_per_s(run.device_name)
    if not d.calls or not d.ops or bw is None:
        return None
    spans = sorted((s, e) for _, _, s, e in d.ops)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    moved = importlib.import_module(f"portbench.maps.{run.config['roofline_map']}").bytes_per_call(run.config, run.mix)
    return 100.0 * (moved / bw) / (busy / 1e9 / d.calls)
