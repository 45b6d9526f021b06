"""Package-global options: print options and the default device.

API parity with the reference's ``set_printoptions`` / ``get_printoptions`` /
``printoptions`` (reference: src/galois/_options.py:17-134). The default
device is the port's own option, in the same idiom: every entry point that
makes data from host input (the ``FieldArray`` constructor, ``from_numpy``,
``Zeros``, ``Random``, ``ntt``/``intt`` and ``np.fft.*`` on host input)
places it there when called with ``device=None``. It is CUDA unless the
caller asks for another device; without a card, making an array then
raises instead of landing on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Generator

import torch

__all__ = [
    "set_printoptions",
    "get_printoptions",
    "printoptions",
    "set_default_device",
    "default_device",
]

_PRINTOPTIONS: Dict[str, Any] = {
    "coeffs": "desc",
}

_DEVICE: Dict[str, torch.device] = {"device": torch.device("cuda")}


def set_printoptions(coeffs: str = "desc") -> None:
    """Set package-wide print options.

    Arguments:
        coeffs: Order in which to print polynomial coefficients, either
            ``"desc"`` (highest degree first, the default) or ``"asc"``.
    """
    if coeffs not in ("desc", "asc"):
        raise ValueError(f"Argument 'coeffs' must be 'desc' or 'asc', not {coeffs!r}.")
    _PRINTOPTIONS["coeffs"] = coeffs


def get_printoptions() -> Dict[str, Any]:
    """Return the current package-wide print options."""
    return dict(_PRINTOPTIONS)


@contextlib.contextmanager
def printoptions(**kwargs: Any) -> Generator[None, None, None]:
    """Context manager that temporarily modifies the print options."""
    saved = dict(_PRINTOPTIONS)
    try:
        set_printoptions(**kwargs)
        yield
    finally:
        _PRINTOPTIONS.clear()
        _PRINTOPTIONS.update(saved)


def set_default_device(device) -> None:
    """Set the device on which entry points place new data from host input
    (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain versions)."""
    _DEVICE["device"] = torch.device(device)


@contextlib.contextmanager
def default_device(device) -> Generator[None, None, None]:
    """Context manager that temporarily sets the default device."""
    saved = _DEVICE["device"]
    try:
        set_default_device(device)
        yield
    finally:
        _DEVICE["device"] = saved


def resolve_device(device=None) -> torch.device:
    """``device``, or the default device when it is None. A CUDA device
    without a card raises: the port never falls back to the CPU."""
    dev = torch.device(device) if device is not None else _DEVICE["device"]
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "galois_tpu_torch places new arrays on CUDA by default, and no CUDA device is "
            "available. Ask for the CPU with galois_tpu_torch.set_default_device('cpu'), "
            "the default_device('cpu') context manager, or device='cpu'."
        )
    return dev
