"""The table of peaks (``peaks.json``), by the card's name."""

import json
import pathlib

_TABLE = json.loads((pathlib.Path(__file__).resolve().parent / "peaks.json").read_text())


def hbm_bytes_per_s(device_name):
    """The card's HBM bandwidth in bytes/s, or None for a card not in the table."""
    row = _TABLE.get(device_name)
    return None if row is None else row["hbm_bytes_per_s"]
