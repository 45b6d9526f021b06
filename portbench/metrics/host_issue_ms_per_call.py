"""host_issue_ms_per_call: host ms from a ``gf.decode`` span's start to its
``gf.decode.readback``'s start, the host's time to issue a call's work before
it waits for the card (layer: decode entry)."""

from portbench.metrics._by_span import host_issue_ms, records


def read(run):
    return host_issue_ms(records())
