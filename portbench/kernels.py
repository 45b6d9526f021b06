"""Sorting the device's kernels into the program's own, GEMMs and the rest.

The program's own kernels are read from its sources by name: every
``__global__`` function in ``<package>/csrc`` and every function handed to
``triton.jit``. So a kernel that a later change adds to the program counts
as its own without an edit here. A profiler names a kernel by its demangled
signature ("void (anonymous namespace)::mul_kernel<8>(Operand, ...)") or, for
Triton, by the function's name; ``base_name`` takes the function's own
identifier from either.
"""

from __future__ import annotations

import functools
import pathlib
import re

__all__ = ["PACKAGE", "base_name", "port_kernel_names", "classify"]

PACKAGE = "galois_tpu_torch"

# library GEMMs (cuBLAS, cuBLASLt and CUTLASS kernels by their names)
GEMM_MARKS = ("gemm", "matmul", "nvjet", "xmma")


def _strip_balanced(text: str, word: str) -> str:
    """``text`` without each ``word(...)``, parentheses balanced."""
    out, i = [], 0
    while True:
        j = text.find(word, i)
        if j < 0:
            return "".join(out) + text[i:]
        out.append(text[i:j])
        k = text.find("(", j)
        depth = 0
        while k < len(text):
            depth += {"(": 1, ")": -1}.get(text[k], 0)
            k += 1
            if depth == 0:
                break
        i = k


@functools.lru_cache(maxsize=None)
def port_kernel_names(root: str) -> frozenset:
    """The names of the program's CUDA and Triton kernels, from its sources."""
    pkg = pathlib.Path(root) / PACKAGE
    names = set()
    for src in sorted((pkg / "csrc").glob("*.cu*")):
        text = src.read_text()
        for m in re.finditer(r"__global__", text):
            head = _strip_balanced(text[m.end() : m.end() + 600], "__launch_bounds__")
            found = re.search(r"(\w+)\s*\(", head)
            if found:
                names.add(found.group(1))
    for src in sorted(pkg.rglob("*.py")):
        text = src.read_text()
        names.update(re.findall(r"triton\.jit\(\s*(\w+)\s*\)", text))
        names.update(re.findall(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)", text))
    return frozenset(names)


def base_name(name: str) -> str:
    """The kernel function's own identifier in a profiler's kernel name."""
    s = name.strip()
    if s.startswith("void "):
        s = s[5:]
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            # "(anonymous namespace)::" is part of the qualified name
            if s.startswith("(anonymous namespace)", i):
                continue
            cut = i
            break
    qual = s[:cut]
    depth, parts, cur = 0, [], ""
    i = 0
    while i < len(qual):
        ch = qual[i]
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if depth == 0 and qual.startswith("::", i):
            parts.append(cur)
            cur = ""
            i += 2
            continue
        if depth == 0 and ch not in "<>":
            cur += ch
        i += 1
    parts.append(cur)
    return parts[-1].strip()


def classify(name: str, port_names: frozenset) -> str:
    """'hand' for the program's own kernels, 'gemm' for library GEMMs,
    'torch' for every other kernel."""
    if base_name(name) in port_names:
        return "hand"
    low = name.lower()
    if any(mark in low for mark in GEMM_MARKS):
        return "gemm"
    return "torch"
