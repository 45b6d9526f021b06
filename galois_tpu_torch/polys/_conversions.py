"""Host-side conversions between polynomial representations.

Integer repr <-> degree list <-> coefficient list <-> string. All functions
operate on Python ints (arbitrary precision) and run at construction
time only — never on device.

API parity with reference src/galois/_conversions.py:14-207.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = [
    "integer_to_degree",
    "integer_to_poly",
    "poly_to_integer",
    "sparse_poly_to_integer",
    "poly_to_str",
    "sparse_poly_to_str",
    "str_to_sparse_poly",
    "str_to_integer",
]


def integer_to_degree(integer: int, order: int) -> int:
    """Degree of the polynomial with integer representation `integer` over GF(order)."""
    if integer == 0:
        return 0
    degree = 0
    while integer >= order:
        integer //= order
        degree += 1
    return degree


def integer_to_poly(integer: int, order: int, degree: int | None = None) -> List[int]:
    """Integer representation -> coefficient list (descending degrees)."""
    if integer < 0:
        raise ValueError(f"Argument 'integer' must be non-negative, not {integer}.")
    coeffs = []
    while True:
        coeffs.append(integer % order)
        integer //= order
        if integer == 0:
            break
    if degree is not None:
        if degree < len(coeffs) - 1:
            raise ValueError("Argument 'degree' is smaller than the actual degree.")
        coeffs += [0] * (degree - (len(coeffs) - 1))
    return coeffs[::-1]


def poly_to_integer(coeffs: Sequence[int], order: int) -> int:
    """Coefficient list (descending degrees) -> integer representation."""
    integer = 0
    for c in coeffs:
        integer = integer * order + int(c)
    return integer


def sparse_poly_to_integer(degrees: Sequence[int], coeffs: Sequence[int], order: int) -> int:
    """Sparse (degrees, coeffs) representation -> integer representation."""
    if len(degrees) != len(coeffs):
        raise ValueError("Arguments 'degrees' and 'coeffs' must have equal length.")
    integer = 0
    for d, c in zip(degrees, coeffs):
        integer += int(c) * order ** int(d)
    return integer


_SUPERSCRIPT = str.maketrans("0123456789", "⁰¹²³⁴⁵⁶⁷⁸⁹")


def _term_to_str(degree: int, coeff: int, poly_var: str = "x") -> str:
    if degree == 0:
        return f"{coeff}"
    x = poly_var if degree == 1 else f"{poly_var}^{degree}"
    if coeff == 1:
        return x
    return f"{coeff}{x}"


def poly_to_str(coeffs: Sequence[int], poly_var: str = "x") -> str:
    """Coefficient list (descending degrees) -> human-readable string."""
    degrees = list(range(len(coeffs) - 1, -1, -1))
    return sparse_poly_to_str(degrees, coeffs, poly_var=poly_var)


def sparse_poly_to_str(
    degrees: Sequence[int], coeffs: Sequence[int], poly_var: str = "x"
) -> str:
    """Sparse representation -> human-readable string, honoring printoptions."""
    from .._options import get_printoptions

    pairs = sorted(zip(degrees, coeffs), key=lambda t: -t[0])
    if get_printoptions()["coeffs"] == "asc":
        pairs = pairs[::-1]
    terms = [_term_to_str(d, c, poly_var) for d, c in pairs if c != 0]
    if not terms:
        return "0"
    return " + ".join(terms)


def str_to_sparse_poly(poly_str: str) -> Tuple[List[int], List[int]]:
    """Poly string -> sparse (degrees, coeffs) representation.

    Accepts e.g. "x^2 + 2x + 1", "x**2 - 1", "y^3+y", unicode superscripts.
    """
    s = poly_str.replace(" ", "").replace("**", "^").replace("*", "")
    # Normalize unicode superscripts to ^k
    out = []
    i = 0
    sup_map = {c: str(d) for d, c in enumerate("⁰¹²³⁴⁵⁶⁷⁸⁹")}
    while i < len(s):
        if s[i] in sup_map:
            j = i
            digits = ""
            while j < len(s) and s[j] in sup_map:
                digits += sup_map[s[j]]
                j += 1
            out.append("^" + digits)
            i = j
        else:
            out.append(s[i])
            i += 1
    s = "".join(out)

    # Identify the variable: first alphabetic character
    var = None
    for ch in s:
        if ch.isalpha():
            var = ch
            break

    # Split into signed terms
    terms = []
    term = ""
    for idx, ch in enumerate(s):
        if ch in "+-" and idx != 0 and s[idx - 1] not in "+-^":
            terms.append(term)
            term = ch
        else:
            term += ch
    if term:
        terms.append(term)

    degrees: List[int] = []
    coeffs: List[int] = []
    for t in terms:
        if not t or t in "+-":
            raise ValueError(f"Invalid polynomial string {poly_str!r}.")
        sign = 1
        if t[0] == "+":
            t = t[1:]
        elif t[0] == "-":
            sign = -1
            t = t[1:]
        if var is not None and var in t:
            base, _, exp = t.partition("^")
            coeff_str = base[: base.index(var)]
            coeff = int(coeff_str) if coeff_str else 1
            degree = int(exp) if exp else 1
        else:
            coeff = int(t)
            degree = 0
        if degree in degrees:
            i = degrees.index(degree)
            coeffs[i] += sign * coeff
        else:
            degrees.append(degree)
            coeffs.append(sign * coeff)
    return degrees, coeffs


def str_to_integer(poly_str: str, order: int) -> int:
    """Poly string -> integer representation over GF(order)."""
    degrees, coeffs = str_to_sparse_poly(poly_str)
    coeffs = [c % order for c in coeffs]
    return sparse_poly_to_integer(degrees, coeffs, order)
