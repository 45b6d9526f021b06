"""lde_int8_products_ms_per_call: device ms a call of the
``gf.limb_matmul.products`` spans: the limb NTT's 7-bit digit planes and
their 19 diagonal int8 products a chunk (layer: limb matmul)."""

from portbench.metrics._by_window import device_ms_per_call


def read(run):
    return device_ms_per_call(run, "gf.limb_matmul.products")
