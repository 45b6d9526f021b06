"""Host-side number theory for galois_tpu_torch.

Everything here is arbitrary-precision Python that runs at field-construction
or plan-build time — none of it executes on the device.  The device-side
equivalents live in `galois_tpu_torch.ops`.
"""

from .basic import egcd, gcd, ilog, iroot, isqrt, lcm, prod
from .factorization import (
    divisor_sigma,
    divisors,
    factors,
    is_perfect_power,
    is_powersmooth,
    is_prime_power,
    is_smooth,
    is_square_free,
    perfect_power,
    pollard_p1,
    pollard_rho,
    trial_division,
)
from .multiplicative import (
    carmichael_lambda,
    crt,
    euler_phi,
    is_cyclic,
    is_primitive_root,
    mobius,
    primitive_root,
    primitive_roots,
    totatives,
)
from .primality import (
    fermat_primality_test,
    is_composite,
    is_prime,
    jacobi_symbol,
    kronecker_symbol,
    kth_prime,
    legendre_symbol,
    mersenne_exponents,
    mersenne_primes,
    miller_rabin_primality_test,
    next_prime,
    prev_prime,
    primes,
    random_prime,
)
