"""galois_tpu_torch: the PyTorch and CUDA port of galois_tpu.

Finite-field arrays over torch tensors (every field the JAX package
builds: GF(p) of any size, GF(2^m) of any degree and GF(p^m), in
'jit-calculate' and, for orders <= 2^20, 'jit-lookup' mode) with the field matmul, discrete logs, square
roots, trace and norm, and primitive and normal elements; polynomials over
them (``Poly``, with batched and matrix evaluation, roots, irreducible and
primitive polynomial tests and searches, factorization, Conway and Lagrange
polynomials, and ``gcd`` and its kin for ints or Polys), Reed-Solomon and
BCH codes with batched decoding, linear-feedback shift registers and
Berlekamp-Massey, and the number-theoretic transform.
New data goes to CUDA unless the caller asks for the CPU
(``set_default_device``, ``default_device``, or ``device=``). The public
names and results match the JAX package ``galois_tpu``; this package imports
neither jax nor galois_tpu. On CUDA tensors the NTT's two matmul sides, the
lookup tables' gathers, the GF(2^m) multiply for m <= 8 and GF(2^m)
reciprocals and powers for m <= 16 (by the field's tables), the RS/BCH decoder's
Berlekamp-Massey scan, the GF(2^31 - 1) and Goldilocks multiplies, the
GF(2^m > 32) products and powers, and the LFSR and long Berlekamp-Massey
scans run hand-written CUDA C++ kernels, and the GF(2^m) multiply for 9 <= m <= 16 a
Triton kernel; CPU tensors take the kernels' plain torch versions.
"""

from ._options import (
    default_device,
    get_printoptions,
    printoptions,
    set_default_device,
    set_printoptions,
)
from . import typing
from .fields import (
    GF,
    GF2,
    Array,
    Field,
    FieldArray,
    FieldArrayMeta,
    is_normal_element,
    is_primitive_element,
    normal_element,
    normal_elements,
    primitive_element,
    primitive_elements,
)
from .polys import (
    Poly,
    conway_poly,
    irreducible_poly,
    irreducible_polys,
    lagrange_poly,
    matlab_primitive_poly,
    primitive_poly,
    primitive_polys,
)
from .codes import (
    BCH,
    ReedSolomon,
    generator_to_parity_check_matrix,
    parity_check_to_generator_matrix,
)
from .nt import (
    carmichael_lambda,
    divisor_sigma,
    divisors,
    euler_phi,
    fermat_primality_test,
    ilog,
    iroot,
    is_composite,
    is_cyclic,
    is_perfect_power,
    is_powersmooth,
    is_prime,
    is_prime_power,
    is_primitive_root,
    is_smooth,
    isqrt,
    jacobi_symbol,
    kronecker_symbol,
    kth_prime,
    legendre_symbol,
    mersenne_exponents,
    mersenne_primes,
    miller_rabin_primality_test,
    mobius,
    next_prime,
    perfect_power,
    pollard_p1,
    pollard_rho,
    prev_prime,
    primes,
    primitive_root,
    primitive_roots,
    random_prime,
    totatives,
    trial_division,
)
from .transforms import intt, ntt
from . import lfsr
from .lfsr import FLFSR, GLFSR, berlekamp_massey

# the int-or-Poly functions shadow the int-only nt versions, as in galois_tpu
from ._polymorphic import are_coprime, crt, egcd, factors, gcd, is_square_free, lcm, prod

__version__ = "0.2.0"
