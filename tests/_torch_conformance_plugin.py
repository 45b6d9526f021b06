"""A pytest plugin that runs the JAX package's behaviour tests against the
torch port: ``galois_tpu`` and every one of its submodules resolve to the
same-named module of ``galois_tpu_torch``, and new arrays go to the CPU.

Load it with ``-p tests._torch_conformance_plugin`` from the repository root
(``tests/test_torch_conformance.py`` does, one subprocess per test file). The
name keeps pytest from collecting it as a test file.
"""

import importlib
import pkgutil
import sys

import galois_tpu_torch


def _alias_package() -> None:
    """Import every module of the port and enter it in ``sys.modules`` under
    the JAX package's name too, before any test file imports ``galois_tpu``."""
    if "galois_tpu" in sys.modules and sys.modules["galois_tpu"] is not galois_tpu_torch:
        raise RuntimeError("galois_tpu was imported before the conformance plugin could alias it")
    sys.modules["galois_tpu"] = galois_tpu_torch
    for info in pkgutil.walk_packages(galois_tpu_torch.__path__, "galois_tpu_torch."):
        module = importlib.import_module(info.name)
        sys.modules["galois_tpu" + info.name[len("galois_tpu_torch") :]] = module


_alias_package()
galois_tpu_torch.set_default_device("cpu")
