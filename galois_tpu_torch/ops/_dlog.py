"""Discrete logarithms over GF(p^m).

Port of ``galois_tpu/ops/_dlog.py:27-121``: ``host_log``, the exact
Pohlig-Hellman solve of one element on the host (the factorization of q-1
and baby-step/giant-step per prime-power subgroup), and ``log`` for
lookup-mode fields, which reads the LOG table on the device (kernel K6).
The batched device Pohlig-Hellman that serves ``log`` in 'jit-calculate'
mode is still to be ported.
"""

from __future__ import annotations

import functools

import numpy as np

from ..fields._hostfield import HostField, get_host_field
from ..fields._meta import FieldMeta
from ..nt import factors

__all__ = ["log", "host_log"]


@functools.lru_cache(maxsize=None)
def _subgroup_data(meta: FieldMeta, base_int: int):
    """Pohlig-Hellman constants for one base (host side)."""
    hf = get_host_field(meta)
    n = meta.order - 1
    primes, exponents = factors(n)
    groups = []
    for pi, ei in zip(primes, exponents):
        ni = pi**ei
        cofactor = n // ni
        gi = hf.power(base_int, cofactor)
        # gamma = gi^(pi^(ei-1)) has order pi; BSGS table for it
        gamma = hf.power(gi, pi ** (ei - 1))
        mstep = int(np.ceil(np.sqrt(pi)))
        baby = {}
        acc = 1
        for j in range(mstep):
            baby.setdefault(acc, j)
            acc = hf.multiply(acc, gamma)
        giant = hf.reciprocal(hf.power(gamma, mstep))
        # CRT coefficient: c_i = (n/ni) * ((n/ni)^-1 mod ni)
        crt = (n // ni) * pow(n // ni, -1, ni) % n
        groups.append(dict(pi=pi, ei=ei, ni=ni, cofactor=cofactor, gi=gi,
                           baby=baby, giant=giant, mstep=mstep, crt=crt))
    return groups, n


def _bsgs_order_p(hf: HostField, group, h: int) -> int:
    """Solve gamma^x = h where gamma has prime order pi, via BSGS."""
    baby, giant, mstep = group["baby"], group["giant"], group["mstep"]
    cur = h
    for i in range(mstep + 1):
        if cur in baby:
            return (i * mstep + baby[cur]) % group["pi"]
        cur = hf.multiply(cur, giant)
    raise ArithmeticError("Discrete log does not exist (element not in subgroup).")


def host_log(meta: FieldMeta, x: int, base: int | None = None) -> int:
    """Exact discrete log of a scalar (host Python ints)."""
    if x == 0:
        raise ArithmeticError("The discrete logarithm of 0 does not exist.")
    hf = get_host_field(meta)
    if base is None:
        base = meta.primitive_element_int
    groups, n = _subgroup_data(meta, base)
    result = 0
    for g in groups:
        # Solve gi^xi = x^cofactor in the order-ni subgroup, digit by digit.
        hi = hf.power(x, g["cofactor"])
        xi = 0
        pi, ei = g["pi"], g["ei"]
        gi_inv = hf.reciprocal(g["gi"])
        for k in range(ei):
            # strip known digits, project into the order-pi subgroup
            cur = hf.multiply(hi, hf.power(gi_inv, xi))
            proj = hf.power(cur, pi ** (ei - 1 - k))
            d = _bsgs_order_p(hf, g, proj)
            xi += d * pi**k
        result = (result + xi * g["crt"]) % n
    return result


def log(x, base=None) -> np.ndarray:
    """Elementwise discrete log of a FieldArray, as an int64 ndarray (an
    np.int64 for a 0-D array). Lookup mode only: the LOG table gives the
    log base the primitive element, and another base divides it by that
    base's log (``host_log``) mod q-1."""
    from ..ops._kernels import get_ops

    cls = type(x)
    meta = cls._meta
    if cls._mode != "jit-lookup":
        raise NotImplementedError(
            f"log() of {meta.name} in {cls._mode!r} mode (the batched device Pohlig-Hellman) is "
            "not ported yet (it needs the batched Pohlig-Hellman of ops/_dlog.py); compile the field with 'jit-lookup'."
        )
    if bool((x._data == 0).any()):
        raise ArithmeticError("The discrete logarithm of 0 does not exist.")
    base_int = None if base is None else int(cls(base, device="cpu"))

    logs = get_ops(meta, "jit-lookup").log_alpha(x._data)
    n = meta.order - 1
    if base_int is not None and base_int != meta.primitive_element_int:
        try:
            inv_lb = pow(host_log(meta, base_int), -1, n)
        except ValueError:
            raise ArithmeticError(f"Base {base_int} does not generate the multiplicative group.")
        logs = logs * inv_lb % n
    out = logs.cpu().numpy()
    return out if out.ndim else np.int64(out)
