"""Discrete logarithms over GF(p^m).

Port of ``galois_tpu/ops/_dlog.py``. ``log`` takes one of three routes, and
every route gives the log base the primitive element, the unique integer in
[0, q - 1):

- orders <= 2^20 (``LOOKUP_TABLE_MAX_ORDER``), in either mode: the field's
  LOG table, read on the device by kernel K6 through the field's lookup
  ops (``LookupOps.log_alpha``);
- larger int-storage fields whose q - 1 has no prime factor above 2^20: the
  batched Pohlig-Hellman on the device (``_device_log``): per prime-power
  subgroup a ``power_static`` by the cofactor, a digit loop of projections
  and baby-step/giant-step searches of the sorted baby table
  (``torch.searchsorted``), and the CRT combine in int64, every step a
  masked select, nothing read back;
- everything else (limb storage, or a prime factor of q - 1 above 2^20):
  ``host_log``, the exact Pohlig-Hellman of one element in Python ints.

A ``base`` other than the primitive element divides the logs by its own log
mod q - 1 on every route; a base that does not generate the group raises
ArithmeticError, as log(0) does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields._hostfield import HostField, get_host_field
from ..fields._meta import LOOKUP_TABLE_MAX_ORDER, STORAGE_INT, FieldMeta
from ..nt import factors

__all__ = ["log", "host_log"]

_DEVICE_MAX_PRIME = 1 << 20  # the BSGS tables' cap: ceil(sqrt(p_i)) <= 1024 entries


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


# ----------------------------------------------------------------------
# Batched device Pohlig-Hellman
# ----------------------------------------------------------------------

def _device_capable(meta: FieldMeta) -> bool:
    """Int storage, q - 1 < 2^62 and no prime factor of q - 1 above 2^20
    (the JAX package's rule)."""
    n = meta.order - 1
    if meta.storage != STORAGE_INT or n >= 2**62:
        return False
    return max(factors(n)[0]) <= _DEVICE_MAX_PRIME


@functools.lru_cache(maxsize=64)
def _device_groups(meta: FieldMeta, device: torch.device):
    """``_subgroup_data`` of the primitive element with, per subgroup, the
    baby table sorted by value and its indices on ``device`` (int64), and
    the strip constants gi^-(pi^k). Cached, so that a call copies nothing
    from the host."""
    hf = get_host_field(meta)
    groups = []
    for g in _subgroup_data(meta, meta.primitive_element_int)[0]:
        values, index = zip(*sorted(g["baby"].items()))
        gi_inv = hf.reciprocal(g["gi"])
        groups.append(dict(
            g,
            # the digit d_k strips as (gi^-(pi^k))^d_k
            strip=[hf.power(gi_inv, g["pi"] ** k) for k in range(g["ei"])],
            baby_sorted=torch.tensor(values, dtype=torch.int64, device=device),
            baby_perm=torch.tensor(index, dtype=torch.int64, device=device),
        ))
    return groups


def _device_log(meta: FieldMeta, ops, a: torch.Tensor) -> torch.Tensor:
    """Logs base the primitive element of the nonzero int-storage tensor a,
    as int64 on a's device (the JAX package's ``_device_log_kernel``).

    Per subgroup of order p_i^e_i: h = a^(cofactor), then for each digit k
    the projection cur^(p_i^(e_i - 1 - k)) into the order-p_i subgroup, its
    digit by baby-step/giant-step (mstep + 1 masked steps: the sorted baby
    table searched by ``torch.searchsorted``, the hit's baby index by
    ``torch.take`` of the permutation, a select and one field product by the
    giant step), and the strip cur <- cur (gi^-(p_i^k))^d_k, a power by the
    digit alone (the JAX package raises gi^-1 to the whole x_i so far; the
    digits are the same). The CRT combine runs in int64 with
    ``mulmod``."""
    from ._kernels import mulmod

    n = meta.order - 1
    total = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for g in _device_groups(meta, a.device):
        pi, ei, mstep = g["pi"], g["ei"], g["mstep"]
        baby_sorted, baby_perm = g["baby_sorted"], g["baby_perm"]
        giant = ops.const_like(a, g["giant"])
        cur = ops.power_static(a, g["cofactor"])
        xi = torch.zeros_like(total)
        for k in range(ei):
            step = ops.power_static(cur, pi ** (ei - 1 - k))
            d = torch.zeros_like(total)
            found = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
            for i in range(mstep + 1):
                key = step.to(torch.int64)
                idx = torch.searchsorted(baby_sorted, key).clamp_(max=mstep - 1)
                hit = (torch.take(baby_sorted, idx) == key) & ~found
                d = torch.where(hit, (i * mstep + torch.take(baby_perm, idx)) % pi, d)
                found = found | hit
                if i < mstep:
                    step = ops.multiply(step, giant)
            xi = xi + d * pi**k
            if k + 1 < ei:
                strip = ops.const_like(a, g["strip"][k])
                cur = ops.multiply(cur, ops.power(strip, d, max(1, (pi - 1).bit_length())))
        total = (total + mulmod(xi, g["crt"], n)) % n
    return total


# ----------------------------------------------------------------------
# The public entry
# ----------------------------------------------------------------------

def log(x, base=None):
    """Elementwise discrete log of a FieldArray, as an int64 ndarray (an
    object array of Python ints where q - 2 exceeds int64), or an np.int64
    (int) for a 0-D array. The device routes end in one copy of the logs
    to the host."""
    from ..fields._array import _storage_to_ints
    from ._kernels import get_ops, kernel_mode, mulmod

    cls = type(x)
    meta = cls._meta
    ops = get_ops(meta, kernel_mode(cls))
    if bool(ops.is_zero(x._data).any()):
        raise ArithmeticError("The discrete logarithm of 0 does not exist.")
    n = meta.order - 1
    inv_lb = 1
    if base is not None:
        base_int = int(cls(base, device="cpu"))
        if base_int != meta.primitive_element_int:
            try:
                inv_lb = pow(host_log(meta, base_int), -1, n)
            except ValueError:
                raise ArithmeticError(f"Base {base_int} does not generate the multiplicative group.") from None
    data = x._data
    if meta.order == 2:
        # GF(2) has no lookup mode; its only unit is 1 = alpha^0
        logs = torch.zeros(data.shape, dtype=torch.int64, device=data.device)
    elif meta.order <= LOOKUP_TABLE_MAX_ORDER:
        logs = get_ops(meta, "jit-lookup").log_alpha(data)
    elif _device_capable(meta):
        logs = _device_log(meta, ops, data)
    else:
        logs = None
    if logs is not None:
        if inv_lb != 1:
            logs = mulmod(logs, inv_lb, n)
        out = logs.cpu().numpy()
        return out if out.ndim else np.int64(out)
    xi = np.asarray(_storage_to_ints(meta, data), dtype=object)
    dtype = np.int64 if meta.order - 2 <= np.iinfo(np.int64).max else object
    vals = np.array([host_log(meta, int(v)) * inv_lb % n for v in xi.reshape(-1)], dtype=dtype)
    out = vals.reshape(xi.shape)
    if out.ndim:
        return out
    return np.int64(out) if dtype is np.int64 else int(out)
