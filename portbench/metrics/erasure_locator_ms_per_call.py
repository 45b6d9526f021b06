"""erasure_locator_ms_per_call: device ms a call of the
``gf.decode.erasure_locator`` spans, in erasure decodes only: the log sums,
Gamma's powers and product, the modified syndromes (layer: decoder stages)."""

from portbench.metrics._by_span import device_ms_per_call, records


def read(run):
    return device_ms_per_call(records(), "gf.decode.erasure_locator")
