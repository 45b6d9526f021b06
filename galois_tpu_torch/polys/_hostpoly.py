"""Host-side dense polynomial arithmetic over GF(p^m), on Python-int coeffs.

Port of ``galois_tpu/polys/_hostpoly.py``, unchanged in behaviour.

Coefficient lists are ASCENDING degree (index i = coeff of x^i), trimmed of
leading zeros, with coefficients in the *integer representation* of the base
field (a `HostField`). Exact arbitrary precision; runs at trace/construction
time only. This is the engine behind irreducibility/primitivity tests and
Poly's host arithmetic.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Tuple

if TYPE_CHECKING:  # a type only: fields/_meta.py imports this package
    from ..fields._hostfield import HostField

Coeffs = List[int]


def trim(a: Coeffs) -> Coeffs:
    while len(a) > 1 and a[-1] == 0:
        a = a[:-1]
    return a


def degree(a: Coeffs) -> int:
    a = trim(a)
    return -1 if a == [0] else len(a) - 1


def add(F: HostField, a: Coeffs, b: Coeffs) -> Coeffs:
    n = max(len(a), len(b))
    a = a + [0] * (n - len(a))
    b = b + [0] * (n - len(b))
    return trim([F.add(x, y) for x, y in zip(a, b)])


def neg(F: HostField, a: Coeffs) -> Coeffs:
    return [F.negative(x) for x in a]


def sub(F: HostField, a: Coeffs, b: Coeffs) -> Coeffs:
    return add(F, a, neg(F, b))


def mul(F: HostField, a: Coeffs, b: Coeffs) -> Coeffs:
    if a == [0] or b == [0]:
        return [0]
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x == 0:
            continue
        for j, y in enumerate(b):
            if y:
                out[i + j] = F.add(out[i + j], F.multiply(x, y))
    return trim(out)


def scalar_mul(F: HostField, a: Coeffs, s: int) -> Coeffs:
    return trim([F.multiply(x, s) for x in a])


def divmod_(F: HostField, a: Coeffs, b: Coeffs) -> Tuple[Coeffs, Coeffs]:
    a, b = trim(list(a)), trim(list(b))
    if b == [0]:
        raise ZeroDivisionError("Polynomial division by zero.")
    db, da = degree(b), degree(a)
    if da < db:
        return [0], a
    inv_lead = F.reciprocal(b[-1])
    r = list(a)
    q = [0] * (da - db + 1)
    for k in range(da - db, -1, -1):
        coef = F.multiply(r[db + k], inv_lead)
        q[k] = coef
        if coef:
            for j in range(db + 1):
                r[j + k] = F.subtract(r[j + k], F.multiply(coef, b[j]))
    return trim(q), trim(r[:db] if db > 0 else [0])


def mod(F: HostField, a: Coeffs, b: Coeffs) -> Coeffs:
    return divmod_(F, a, b)[1]


def gcd(F: HostField, a: Coeffs, b: Coeffs) -> Coeffs:
    a, b = trim(list(a)), trim(list(b))
    while b != [0]:
        a, b = b, mod(F, a, b)
    if a != [0]:
        a = scalar_mul(F, a, F.reciprocal(a[-1]))  # monic
    return a


def egcd(F: HostField, a: Coeffs, b: Coeffs) -> Tuple[Coeffs, Coeffs, Coeffs]:
    """Returns (g, s, t) with s*a + t*b = g, g monic."""
    r0, r1 = trim(list(a)), trim(list(b))
    s0, s1 = [1], [0]
    t0, t1 = [0], [1]
    while r1 != [0]:
        q, r = divmod_(F, r0, r1)
        r0, r1 = r1, r
        s0, s1 = s1, sub(F, s0, mul(F, q, s1))
        t0, t1 = t1, sub(F, t0, mul(F, q, t1))
    if r0 != [0]:
        lead_inv = F.reciprocal(r0[-1])
        r0 = scalar_mul(F, r0, lead_inv)
        s0 = scalar_mul(F, s0, lead_inv)
        t0 = scalar_mul(F, t0, lead_inv)
    return r0, s0, t0


def pow_mod(F: HostField, a: Coeffs, e: int, m: Coeffs) -> Coeffs:
    """a^e mod m, square-and-multiply (e may be arbitrarily large)."""
    result = [1]
    base = mod(F, a, m)
    while e:
        if e & 1:
            result = mod(F, mul(F, result, base), m)
        base = mod(F, mul(F, base, base), m)
        e >>= 1
    return result


def derivative(F: HostField, a: Coeffs, k: int = 1) -> Coeffs:
    for _ in range(k):
        if len(a) <= 1:
            return [0]
        out = []
        for i in range(1, len(a)):
            # i * a[i] = a[i] added i times = multiply by (i mod p) in GF(p^m)
            s = i % F.p
            out.append(F.multiply(a[i], s))
        a = trim(out)
    return a


def evaluate(F: HostField, a: Coeffs, x: int) -> int:
    """Horner evaluation at a field element (int repr)."""
    acc = 0
    for c in reversed(a):
        acc = F.add(F.multiply(acc, x), c)
    return acc
