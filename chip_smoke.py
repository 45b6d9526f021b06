#!/usr/bin/env python3
"""Drive galois_tpu_torch's main paths once on one CUDA card, and check them.

Run from the repository root on a machine with one NVIDIA GPU (Hopper,
sm_90a), the CUDA toolkit and Triton:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles the CUDA C++ sources in csrc/ with nvcc, one process
     per source, all at once, and prints the build times and ptxas resource
     usage; then launches K11 (the device probe) before any other kernel,
     prints its result and its time beside torch.add's, both by CUDA-graph
     replay and by eager calls, and an empty kernel's by graph replay (the
     launch floor), and compiles the Triton kernel;
  3. kernels: every kernel against its plain torch version on the card, at
     the main paths' shapes plus small and ragged ones; results must be
     exactly equal. K8 (GF(2^m) multiply, m <= 8, by the field's byte rows)
     at every m on every layout kind (a ragged length, a view one element
     in, one element, row and column broadcasts, the three-axis outer
     product, an inner axis below 16, four axes), at 2^24 and at the RS
     decoder's own launches (the outer product (65536, 32, 33), Forney's
     (65536, 255) times (1, 255) and (65536, 255), the derivative's (65536,
     32) times (1, 32)), timed there through the wrapper, then K8, K7 and
     K3 timed on the same GF(2^8) inputs; K7 (GF(2^m) multiply, 9 <= m <=
     16) on GF(2^9) at 2^24 and at the BCH decoder's shape; an int8 GEMM yardstick (torch._int_mm, the
     MACs of one NTT side; not the same function); K1 and K2 (NTT sides)
     and their prologue, the digit split, at the NTT's shapes and ragged
     ones with 3, 4 and 5 planes, raw and K-major tables, timed at 4096^3 x 4
     and 1024^3 x 32, and K2 at 4096 x K x 4096 for K = 4096 and 16384 (its
     main loop apart from the rest); K3 and K4 (table gathers: multiply,
     divide) over every (a, b) pair of GF(2^8) and GF(3^5), then by
     placement (printed): GF(2^8) and GF(3^5) (uint8, byte tables), GF(2^10)
     (int64, shared) and GF(2^16) (int64, LOG shared) at 2^24, GF(2^8) at
     2^20 and 2^26, GF(2^14) (shared) and GF(2^20) (int64, global) at a
     ragged 1,000,003; at GF(2^8) and GF(2^16), 2^24, also K3 on views one
     element off alignment (funnel-shifted streams), K3 with a 0-D operand
     (stride 0), and torch.bitwise_xor on the same tensors as a yardstick;
     bounds count HBM bytes and the shared-memory gathers (wavefronts at one
     a clock per SM); K5 and K6 (reciprocal, log) over every element of
     GF(2^8) and GF(3^5) in uint8 and int64 storage, aligned and one
     element in, then by placement (printed) at GF(2^8), GF(3^5), GF(2^10)
     and GF(2^16), 2^24, GF(2^8) at 2^26, GF(2^14) and GF(2^20) at a ragged
     1,000,003, with torch.take of a q-entry table as the yardstick on int64
     storage; K9 (GF(2^31 - 1) multiply) and
     K10 (Goldilocks multiply, canonical and non-canonical limbs) at 2^24
     and a ragged 1,000,003 with their edge values. Prints CUDA-event times
     of kernel and plain version (elementwise kernels timed by CUDA graph
     replay, so that host time per call does not hide them).
     K8-A (the GF(2^m) reciprocal and powers, by the field's tables) on
     GF(2^8) at 2^24 (reciprocal and an exponent tensor), at Forney's
     (65536, 255), a 0-D base against an exponent tensor, and every m =
     2..16 over all its elements: the reciprocal aligned or not, by stride
     and transposed, of 0; 64-bit exponents, the exponents 0, 1, q - 1, q
     and 2^63 - 1 with nbits 0, m and 64, a = 0, exponents broadcast over
     three axes and over four (materialized); timed beside K5 (the table
     reciprocal without the zero mask) on the same inputs, and on int64 at
     GF(2^16) 2^24 and BCH(511,493)'s (16384, 511) over GF(2^9) beside
     torch.take of the reciprocal table;
     K8-B (the Berlekamp-Massey scan) at RS(255,223)'s
     (65536, 32) with u = 0 and random u, at d = 65, at m = 4, and on int64
     storage at GF(2^9) (BCH(511,493)'s (16384, 4) and d = 33), GF(2^12) and
     GF(2^16); timed at RS(255,223)'s shape, d = 65, BCH(511,493)'s and
     GF(2^16) d = 33, with the table form's operations and shared-memory
     wavefronts beside the operations of the form with a reciprocal chain.
     K15 (a GF(2^m) product with a constant as one GF(2)-linear map) on the
     RS(255,223) and BCH(511,493) decoders' own maps at B = 65536 (seven
     products), against its plain version and the bit-plane product, timed
     beside both and bounded by the map's int8 operations or its bytes.
     K16 (the Goldilocks limb matmul's combine) on ragged, strided and
     accumulated calls and at the 2^24 LDE side's chunk shape (4096 rows by
     the chunk width _core takes there), against its plain version, timed
     beside it and bounded by its bytes (19 int32 read and 4 uint16 written
     an element).
     K7, K8, K8-A and K8-B are bounded by their bytes and, for the table
     forms, their shared-memory reads (wavefronts at one a clock per SM);
     the integer operations of K7's and K8-B's own forms, at the int32 rate
     of 132 SMs x 64 lanes at the card's maximum SM clock (nvidia-smi), are
     printed beside as counts of the form, not bounds on the map;
  4. main path 1, through the public API with every launch counter reset to
     0 first: GF(2^8) multiply of 2^24 elements, then np.fft.fft / ifft over
     GF(3*2^30+1) at N = 2^20 (batch 32) and N = 2^24 (batch 4) and ntt /
     intt of one row, with round trips and 16 bins against a direct DFT in
     NumPy; K1, K2 and K8 must have been launched;
  5. main path 2, the same way: lookup mode ('jit-lookup') GF(2^8) at 2^24
     (x * y, x / y, np.reciprocal, log, x ** e for an exponent array),
     GF(2^16) at 2^24 (x * y, np.reciprocal, log), and default-mode GF(3^5)
     at 2^24 (x * y, x + y,
     x - y, x / y), each held on a 2^16 prefix against NumPy references
     written here; K3, K4, K5 and K6 must have been launched. The modes are
     restored after;
  6. main path 3, the same way: the Goldilocks field at 2^24 (x * y, x + y,
     x - y, np.reciprocal(y), x / y), GF(2^31 - 1) at 2^24 (x * y, x / y)
     and Poly evaluation of degree 255 at 2^21 points over both, each held
     on a 2^12 prefix against Python-int references written here, with the
     K9 and K10 launches of each call; K9 and K10 must have been launched.
     Then, outside the counted run, K9 and K10 are held against their plain
     versions at Horner's inner-step shape, (16, 2^21) times x of (1, 2^21)
     passed by its period, and that step is timed in its parts: the multiply
     with x by its period and with x materialized, and the torch add; a
     degree-255 evaluation is timed both ways too;
  7. main path 4, the same way: RS(255,223) over GF(2^8) (f = 0x11D, from
     matlab_primitive_poly) encodes 65536 random messages, gets 0-16 symbol
     errors per row (40 in every 16th row) and decodes them; a second batch
     of 65536 goes through the erasure path with 2e + f <= 32; BCH(511,493)
     (GF(2^9) syndromes, f = 529) decodes 16384 words with 0-2 bit errors
     (3-6 in every 16th row). Rows within the capability must give back
     their message and error count, rows beyond it -1 or a codeword; K8 must
     have been launched in the RS decodes and K7 in the BCH decode; each
     decode must launch K8-B once and K8-A at least once, and each RS decode
     K8 at most 4 times (6 with erasures). Prints codewords/s per decode with
     the K8, K7, K8-A and K8-B launches of each, the encode time and the
     peak device memory. Then, after the launches are read, so that they
     are not counted: a torch.profiler table of one RS decode, and the RS
     and BCH decodes' times stage by stage (BCH's scan also by the plain
     loop);
  8. main path 5, the same way: BASELINE.json config 3, a Poly product of
     two random degree-(2^19 - 1) Polys over GF(3*2^30+1) (the NTT at
     N = 2^20), held on its 2^12 lowest and highest coefficients against a
     NumPy schoolbook product and by f(r) g(r) = h(r) at 4 points; divmod of
     degree 767 by 255 on the device, held by q b + r = a at 4 points;
     pow(a, 2^10 + 3, m) with deg m = 512 against a NumPy square-and-multiply;
     np.convolve at 2^12 x 2^12 taps over GF(2^8) (K8), GF(2^16) (K7),
     GF(2^31 - 1) (K9) and Goldilocks (K10), held on their 64 lowest and
     highest coefficients; config 5 on one device, np.fft.fft / ifft over
     the BLS12-381 scalar field and Goldilocks at N = 2^24 (round trips; 16
     bins against a direct DFT in Python ints at N = 2^12 on the same plan
     path; plan build, transform time, peak memory, a torch.profiler split
     of the BLS transform's int8 GEMMs); the recursive 6-step at N = 2^26
     over GF(3*2^30+1), 4096 x (128 x 128), with its round trip and 16 bins
     against a direct DFT in NumPy. K1, K2 (the 2^26 leaves included), K7,
     K8, K9 and K10 must have been launched;
  9. main path 6, the same way: linear algebra over GF(q) through the public
     API: row_reduce of mceliece8192128's parity-check matrix (GF(2), 1664 x
     8192, H[i, j] = alpha_j^i / g(alpha_j) over GF(2^13) bit-expanded),
     held as an RREF of rank 1664 with H == H[:, pivots] @ R through the
     port's matmul; over GF(2^8) at n = 1024 inv, solve, plu_decompose, det
     and matrix_rank (A @ inv(A) == I, A @ x == b, P @ L @ U == A with L unit
     lower and U upper, det of A = (L0 U0)[q] known as sign(q) prod(diag U0)),
     inv in 'jit-lookup' mode, inv over GF(2^16) at n = 512, solve and det
     over GF(2^31 - 1) at n = 1024, inv and det over Goldilocks at n = 256;
     the char and min polys at n = 512 over GF(2^8) and GF(2^31 - 1) of
     S C(f) S^-1 (both f) and S diag(C(g), C(g)) S^-1 (g^2 and g), C a
     companion matrix; then the same calls at n = 128 (Goldilocks 65) on the
     card against the port's CPU plain versions. Each line prints the ms of
     the call (CUDA events), its launches by wrapper and the peak device
     memory; inv's K8 (K3, K7) launches must be two a column and a few a
     call, its K8-A (K5, K8-A) launches one a call. K3, K5, K7, K8, K8-A, K9 and K10 must have been
     launched;
 10. main path 7, the same way: the field's element functions at 2^24
     elements: default-mode log over GF(2^8), GF(2^16) and GF(3^5) (the LOG
     table, K6) and over GF(2^31 - 1) and GF(3*2^30+1) (the batched
     Pohlig-Hellman), held by alpha ** log == x on the card through the
     exponent-array power and on a 2^10 prefix against Python-int logs
     written here; GF(2^31 - 1) also with the base alpha^5, and the base
     alpha^3 must raise; np.sqrt of squares y * y over GF(2^8) and GF(2^16)
     (K8-A), GF(2^31 - 1) (one ladder), GF(3*2^30+1) (Tonelli-Shanks, S =
     30) and Goldilocks (Tonelli-Shanks on limbs, S = 32), held by r * r ==
     x and r <= -r as integers on the card and on a 2^12 prefix in Python
     ints; is_square of random elements against Euler's criterion on a
     prefix; field_trace and field_norm over GF(2^8) and GF(3^5) against
     NumPy references on a prefix; Poly.roots of degree 255 over GF(2^16)
     (the Chien scan, K7) and of degree 32 over GF(2^8) with multiplicities
     (K8) and over GF(2^31 - 1) (the host's factors); GF(2^16)'s
     primitive elements (phi(q - 1) of them, each of order q - 1 on the
     card), GF(65537)'s squares, conway_poly(2, 20) and lagrange_poly
     through 64 points over GF(2^8). Each line prints the call's ms (CUDA
     events), its launches by wrapper and the peak device memory; K6, K7,
     K8, K8-A, K9 and K10 must have been launched.
 11. main path 8, the same way: GF(2^128) with GCM's modulus at 2^24
     elements (x * y, x * x, np.reciprocal, x / y, x ** e for an int64
     exponent array, np.sqrt; 4096 samples against Python-int carry-less
     products, y * y^-1 == 1, (x / y) * y == x and sqrt(x)^2 == x on the
     card), GF(2^233) with B-233's at 2^22 (x * y, np.reciprocal), GF(3^30)
     on planar digits at 2^20 (*, +, -, / against NumPy digit products on
     samples), an FLFSR over GF(2) of a primitive degree-20 polynomial
     (step(2^20): 2^19 ones a period, the state back after 2^20 - 1 ticks
     and after step(-(2^20 - 1))), a GLFSR over GF(2^8) whose
     characteristic polynomial is RS(255,223)'s generator (step(2^20), 4096
     outputs against the plain tick loop, to_fibonacci_lfsr's next 4096),
     an FLFSR over GF(2^31 - 1) of degree 16 (step(2^18), 256 outputs in
     Python ints), and berlekamp_massey over 2^14 random GF(2) elements,
     8192 GLFSR and 4096 FLFSR outputs (the FLFSR it returns regenerates
     each register's outputs and its c(x) divides the register's; for the
     random elements, whose connection polynomial may have degree below
     the linear complexity L, as in the JAX package, its recurrence holds
     from L on and the FLFSR regenerates the rest). Each line starts
     with nvidia-smi's card and power limit, then ms, launches and peak
     memory; K12, K13 and the two K14 entries must have been launched.
     Before the counted runs, phase 3 holds K12 (the block form's matrices
     as the wrapper builds them, at the three registers; then forward and
     backward, at 1, 31, 33, 64, 65, 1024, 8192 and 10007 ticks around its
     32-tick blocks; over GF(2^8) at 1, 31, 32, 33 and 1024 taps in every
     mode; at the order of the 2^14-element Berlekamp-Massey result, 8192,
     in shared memory, and at 20000 taps in global memory), K13 (at path
     8's sequences: the 2^14 GF(2) elements, 8192 GF(2^8) and 4096
     GF(2^31 - 1) register outputs, each timed beside its plain scan on
     the card and its form's chain; then, against the plain scan (a prime
     field's on the host), random elements of every kind across the switch
     from warp 0 to the CTA, an LFSR's output then random elements, all
     zeros, the impulse, GF(2) at 31-33 and 1023-1025 elements, and the
     global-memory form in uint8 and int64 storage) and K14
     (GF(2^128) and GF(2^233) products and squares on 2^16 elements, powers
     by 0, 1, 2^m - 2, 2^m - 1, 2^(m - 1) and exponent words with zeros on
     2^12, and the GF(2^128) reciprocal on the 2^22 elements it is timed
     at; the same at m = 33, 65 and 576 and at dense irreducible f of
     degree 64, 128 and 129) against their plain versions on the card, and
     times each, K14 beside its form's own operation and shared-memory
     counts.
 12. main path 9, the same way: element assignment on a 2^24-element
     GF(2^8) array (a half-density mask, x[::3] = 7, 2^20 distinct index
     positions), on Goldilocks at 2^22 (uint16 limbs) and GF(3^30) digits
     at 2^20, each write against the same write by raw torch ops, and a
     slice taken before the writes unchanged; np.multiply.outer and
     np.add.outer at 4096 x 4096 over GF(2^8) (K8 by stride), GF(2^16)
     (K7) and GF(2^31 - 1) (K9), 2048 x 2048 over Goldilocks (K10) and
     1024 x 1024 over GF(2^128) (K14), rows against the card's broadcast
     product and samples against Python ints, and a zero divisor of
     np.true_divide.outer raising; np.add.reduce and np.multiply.reduce of
     a (4096, 4096) array over GF(2^8) and GF(2^31 - 1) on both axes,
     against .sum and .prod and Python ints; np.subtract.reduce,
     np.true_divide.reduce, np.multiply.accumulate, np.add.reduceat and
     np.add.at on 2^16 elements (the host field); a pickle round trip of a
     2^24-element GF(2^8) and a 2^20-element Goldilocks card array (bytes
     and seconds); the python-calculate mode against jit-calculate (and
     jit-lookup, K3, for GF(2^8)) over GF(2^8), Goldilocks and BLS12-381 r
     on 4096 elements (*, /, ** 65537, an exponent array, np.sqrt), a Poly
     evaluation and np.convolve in that mode; the poly and power reprs of a
     card array against its CPU copy's, GF(2^4).repr_table() and
     GF(3^2).arithmetic_table("*"). Each line starts with nvidia-smi's card
     and power limit; K3, K7, K8, K9, K10 and K14 must have been launched.
 13. main path 10, parallel/ on torch.distributed (the JAX package's
     dryrun_multichip at real sizes): (a) NCCL at one rank in this process:
     sharded_fft over GF(3*2^30+1) and BLS12-381 r at 2^24 and Goldilocks
     at 2^22 (plans built and timed apart), sharded_batched_fft at 32 x
     2^20, sharded_decode of RS(255,223) at B = 65536 with errors and with
     erasures and of BCH(511,493) at B = 16384; K1, K2, K8 and K10 must
     have been launched; every result gathered and exactly equal to the
     single-device port (field_fft, code.decode(..., errors=True), the
     plain ops), 16 bins of a 2^12 BLS12-381 r transform against Python
     ints; each NTT's transposes, local DFTs and twiddle timed apart.
     (b) four gloo ranks spawned on the same card, which they time-share
     (their times are no scaling figure), each warmed up by small calls
     of every family first: the same calls and sizes, the
     inverse round trips, the fallback at N = 8 (which must warn) and
     dryrun_multichip's step on 65536 rows (GF(2^8) rows @ (256, 64)
     weights, h * h + h; GF(2^31 - 1) a * a + a); every rank must have
     launched K1, K2, K7, K8, K8-A, K8-B, K9 and K10, and rank 0 holds every
     gathered result against (a)'s references. Each line starts with
     nvidia-smi's card and power limit; the path's time is printed.
 14. main path 11, CUDA-graph capture where the JAX package runs under
     jax.jit (capture_path): a * b + a, a / b, a ** 3 and np.reciprocal at
     2^24 over GF(2^8) (K8, K8-A), GF(2^16) in lookup mode (K3-K5), GF(2^31
     - 1) (K9), Goldilocks (K10), GF(2^128) (K14) and GF(3^5), and
     field_trace, field_norm, vector, additive_order, multiplicative_order,
     log (K6), plu_decompose (32 x 32: the host route eagerly, the device
     route captured), is_square and sqrt over GF(2^8), GF(31), GF(3^5) and
     Goldilocks; each captured with torch.cuda.set_sync_debug_mode("error")
     and its replay exactly equal to the eager call, or, where jax.jit
     raises, the capture raising NotImplementedError; eager and replay ms
     per call. Then polynomial-string elements on the card, Random(seed=...)
     against the JAX package's draw written out in numpy over int, limb and
     digit fields, and <, <=, >, >= and mask indexing at 2^24 over GF(2^31 -
     1), Goldilocks, BLS12-381 r and GF(3^30) against numpy on the host. K3,
     K4, K5, K6, K8, K8-A, K9, K10 and K14 must have been launched.
The line before the last is one JSON object with the kernels' routes,
sources, launch counts, errors, times and bounds; the last line is the JSON
device summary. Exits non-zero without a card or without the package.
"""

import concurrent.futures
import json
import operator
import subprocess
import sys
import time

import numpy as np
import torch

P = 3 * 2**30 + 1
M31 = 2**31 - 1
GOLDILOCKS = 2**64 - 2**32 + 1
BLS_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
SMS, INT32_LANES = 132, 64  # H100 SXM: SMs, int32 lanes per SM per clock
INT32_OPS_PER_S = None  # SMS x INT32_LANES x the card's maximum SM clock, set in main()
SMEM_WAVEFRONTS_PER_S = None  # SMS x one shared-memory wavefront a clock, set in main()


def bounds_text(nbytes, form_ops, ms):
    """'bound X ms (bytes) | this form's operations Y ms, the kernel at Z% of
    them': the bound is the bytes the map moves; the integer operations are
    those of the kernel's own chain, a count for the form and not a bound on
    the map (a table form computes it with fewer)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, form_ops / INT32_OPS_PER_S * 1e3
    return (
        f"bound {t_bytes:.4f} ms (bytes) | this form's integer operations {t_ops:.4f} ms, "
        f"the kernel at {t_ops / ms:.0%} of them (a count of the form, not a bound on the map)"
    )


def bound(nbytes, ops=0, wavefronts=0):
    """(ms, what bounds it): the largest of HBM bytes over 3.35 TB/s, int8
    tensor-core operations over 1979 TOP/s and shared-memory wavefronts
    over the SMs' one a clock."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / INT8_OPS_PER_S, wavefronts / SMEM_WAVEFRONTS_PER_S if wavefronts else 0) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# 32-bit integer operations of K8-B's forms (csrc/gf2m_chain.cu), counted
# line by line as the int32 pipe would run them at best: one per shift
# (SHF), one per bitwise function of up to three inputs, an immediate mask
# included (LOP3), one per add or subtract (IADD3); multiplies run on the
# FMA pipe and count 0, and so does loop control. The time at 64 int32
# lanes per SM is a count for that form; it does not bound the scan, so
# bounds count bytes.

def nib_ops(n):
    """nib_ladder<n>: per step a shift of y, an AND, a shift of x and one
    AND-XOR; step 0 has no shifts and nothing to XOR."""
    return max(0, 4 * n - 2)


def fold_costs(m, f):
    """(rounds, operations per slot word and round) of the folds by
    r = f ^ x^m: c >> m and its mask, a shift per set bit of r above bit 0,
    XORs three inputs at a time, and (c & low) ^ t."""
    r = f ^ (1 << m)
    pop, deg_r = bin(r).count("1"), max(r.bit_length() - 1, 0)
    width, rounds = 2 * m - 1, 0
    while width > m:
        width, rounds = max(m, width - m + deg_r), rounds + 1
    return rounds, 3 + bin(r >> 1).count("1") + (pop - 1 + 1) // 2


def chain_costs(m, f):
    """Operations of one-element pieces for GF(2^m) with f: a product and a
    square in a lane, and the squares and products of the Itoh-Tsujii
    chain (K8-B's form with a reciprocal in the step)."""
    rounds, per_round = fold_costs(m, f)
    red1 = rounds * (per_round - 1)  # reduce1: one element, no mask after c >> m
    sq, pr, k = 1, 0, 1  # the final square
    for bit in bin(m - 1)[3:]:
        sq, pr, k = sq + k, pr + 1, 2 * k
        if bit == "1":
            sq, pr, k = sq + 1, pr + 1, k + 1
    return {"mul1": 5 * m - 2 + red1, "sqr1": 8 + red1, "inv_sq": sq, "inv_mul": pr}


def scan_ops_reciprocal(m, f, d, rows):
    """K8-B with a reciprocal chain in place of its table step (m <= 8) over
    rows codewords. Per step t: the window's t // 4 + 2, the dot's t // 4 + 1
    words (nibbles and the three ladders), the byte folds of its sum,
    reduce1, the scalar reciprocal and product, the multiply table (4 a
    bit), 13 for the predicates and the grow update, and the update's
    (t + 1) // 4 + 1 words (x B, 3 a bit of the table product, the
    selects)."""
    c = chain_costs(m, f)
    dot_word = nib_ops(m) if m <= 4 else 8 + 2 * nib_ops(4) + nib_ops(m - 4)
    red1 = c["mul1"] - (5 * m - 2)
    fixed = (16 if m > 4 else 4) + red1 + c["inv_sq"] * c["sqr1"] + c["inv_mul"] * c["mul1"] + c["mul1"] + 4 * m + 13
    per_row = sum(fixed + (t // 4 + 2) + (t // 4 + 1) * dot_word + ((t + 1) // 4 + 1) * (3 * m + 3) for t in range(d - 1))
    return rows * per_row


def scan_ops(m, f, d, rows):
    """K8-B's table form over rows codewords. m <= 8: as
    ``scan_ops_reciprocal`` with reduce1 replaced by the linear map of the
    sum's m - 1 high bits (a mask by two shifts and an AND-XOR a bit, 2 to
    split the sum), and the reciprocal, the product and the multiply table
    by the table step: LOG delta's byte, the add of (q-1) - LOG bb and its
    conditional subtract (3), then per bit an add and a byte permute (2m),
    and 2 to keep the new (q-1) - LOG bb on a grow. 9 <= m <= 16,
    one element a lane, per step: the window's t + 1 moves, t + 1 ladder
    products (5m - 2 each) and one reduce1, the coefficient (3 by the tables
    for m <= 14, a product above), const_table (4m), and the update's t + 2
    elements (4m a product, 2 selects), 13 for the predicates."""
    c = chain_costs(m, f)
    red1 = c["mul1"] - (5 * m - 2)
    if m <= 8:
        dot_word = nib_ops(m) if m <= 4 else 8 + 2 * nib_ops(4) + nib_ops(m - 4)
        fixed = (16 if m > 4 else 4) + 3 * (m - 1) + 2 + 3 + 2 * m + 2 + 13
        per_row = sum(fixed + (t // 4 + 2) + (t // 4 + 1) * dot_word + ((t + 1) // 4 + 1) * (3 * m + 3) for t in range(d - 1))
    else:
        coef = 3 if m <= 14 else c["mul1"]
        fixed = red1 + coef + 4 * m + 13
        per_row = sum(fixed + (t + 1) + (t + 1) * (5 * m - 2) + (t + 2) * (4 * m + 2) for t in range(d - 1))
    return rows * per_row


def scan_wavefronts(m, d, rows):
    """K8-B's shared-memory reads over rows codewords, one wavefront per
    warp and read (none conflicting: the least they can take): per step the
    row's LOG delta and coef's m EXP entries (m <= 8), else 2, and the
    staging of the table (2(q-1) words, or the uint16 segments)."""
    warps, q = -(-rows // 32), 2**m
    reads = (1 + m if m <= 8 else 2) * (d - 1) * warps
    per_block, threads = (2 * (q - 1) * 4, 64) if m <= 8 else ((q if m > 14 else 2 * q) * 2, 128)
    return reads + -(-rows // threads) * -(-per_block // 128)


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def np_ladder(g, n, p):
    """[g^0, ..., g^(n-1)] mod p in NumPy uint64, by repeated doubling."""
    out = np.empty(n, dtype=np.uint64)
    out[0] = 1
    filled, gf = 1, g % p
    while filled < n:
        take = min(filled, n - filled)
        out[filled : filled + take] = out[:take] * np.uint64(gf) % np.uint64(p)
        filled += take
        gf = gf * gf % p
    return out


def direct_dft_bins(x, bins, p, generator):
    """X[k] = sum_n x[n] omega^(n k) mod p for the given bins (NumPy uint64;
    every product of two residues < 2^32 fits, and so does a sum of 2^24
    residues)."""
    N = x.shape[0]
    omega = pow(generator, (p - 1) // N, p)
    xu = x.astype(np.uint64)
    out = []
    for k in bins:
        terms = xu * np_ladder(pow(omega, k, p), N, p) % np.uint64(p)
        out.append(int(terms.sum(dtype=np.uint64)) % p)
    return np.array(out, dtype=np.int64)


def np_conv_mod(a, b, p):
    """Schoolbook product of two coefficient arrays mod p < 2^32 (NumPy
    uint64: each product < 2^64 is reduced before it is added)."""
    a, b = np.asarray(a).astype(np.uint64) % np.uint64(p), np.asarray(b).astype(np.uint64) % np.uint64(p)
    out = np.zeros(len(a) + len(b) - 1, dtype=np.uint64)
    for j, bj in enumerate(b):
        out[j : j + len(a)] = (out[j : j + len(a)] + a * bj % np.uint64(p)) % np.uint64(p)
    return out.astype(np.int64)


def np_polymod(a, m, p):
    """Remainder of a by the monic m (descending coefficients), deg m long."""
    dm = len(m) - 1
    r = np.concatenate([np.zeros(max(0, dm - len(a)), dtype=np.uint64), np.asarray(a).astype(np.uint64) % np.uint64(p)])
    mu = np.asarray(m).astype(np.uint64)
    for i in range(len(r) - dm):
        c = int(r[i])
        if c:
            r[i : i + dm + 1] = (r[i : i + dm + 1] + np.uint64(p - c) * mu % np.uint64(p)) % np.uint64(p)
    return r[len(r) - dm :].astype(np.int64)


def np_powmod(base, e, m, p):
    """base^e mod (m, p) by square-and-multiply on NumPy arrays."""
    result = np.zeros(len(m) - 1, dtype=np.int64)
    result[-1] = 1
    while e:
        if e & 1:
            result = np_polymod(np_conv_mod(result, base, p), m, p)
        e >>= 1
        if e:
            base = np_polymod(np_conv_mod(base, base, p), m, p)
    return result


def np_gf2m_multiply(a, b, m, f):
    """Independent NumPy reference for GF(2^m) products (int64)."""
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    acc = np.zeros_like(a)
    for i in range(m):
        acc ^= np.where((b >> i) & 1, a << i, 0)
    for i in range(2 * m - 2, m - 1, -1):
        acc ^= np.where((acc >> i) & 1, f << (i - m), 0)
    return acc


def np_gfpm_multiply(a, b, p, f_asc):
    """Independent NumPy reference for GF(p^m) products of int reprs: base-p
    digit convolution, then long division by the monic f (ascending)."""
    m = len(f_asc) - 1
    da = np.stack([(a.astype(np.int64) // p**i) % p for i in range(m)], axis=-1)
    db = np.stack([(b.astype(np.int64) // p**i) % p for i in range(m)], axis=-1)
    full = np.zeros(da.shape[:-1] + (2 * m - 1,), dtype=np.int64)
    for i in range(m):
        for j in range(m):
            full[..., i + j] += da[..., i] * db[..., j]
    full %= p
    for d in range(2 * m - 2, m - 1, -1):
        c = full[..., d].copy()
        for j in range(m + 1):
            full[..., d - m + j] = (full[..., d - m + j] - c * f_asc[j]) % p
    return (full[..., :m] * (p ** np.arange(m))).sum(axis=-1)


def to_limbs(values, device):
    """Python ints below 2^64 -> planar (4, n) uint16 limbs on ``device``."""
    v = torch.tensor([x - 2**64 if x >= 2**63 else x for x in values], dtype=torch.int64, device=device)
    return torch.stack([(v >> (16 * k)) & 0xFFFF for k in range(4)]).to(torch.uint16)


def ints(x):
    """A FieldArray's int reprs as a list of Python ints."""
    return [int(v) for v in np.asarray(x, dtype=object).reshape(-1)]


def horner(coeffs_desc, xs, p):
    out = []
    for x in xs:
        acc = 0
        for c in coeffs_desc:
            acc = (acc * x + c) % p
        out.append(acc)
    return out


def np_exp_log(mul, alpha, q):
    """EXP (length q-1) and LOG (length q) tables from a reference multiply,
    by doubling: EXP[f + i] = EXP[i] * alpha^f for the f entries filled."""
    exp = np.empty(q - 1, dtype=np.int64)
    exp[0] = 1
    filled, step = 1, np.array([alpha], dtype=np.int64)  # step = alpha^filled
    while filled < q - 1:
        take = min(filled, q - 1 - filled)
        exp[filled : filled + take] = mul(exp[:take], np.repeat(step, take))
        filled += take
        step = mul(step, step)
    if len(np.unique(exp)) != q - 1:
        raise AssertionError(f"{alpha} does not generate GF({q})*")
    log = np.zeros(q, dtype=np.int64)
    log[exp] = np.arange(q - 1)
    return exp, log


# Main path 6's sizes: mceliece8192128's parity-check matrix (mt x n with m = 13,
# t = 128, n = 8192); n of the dense fields' matrices; n of the char and min polys
# (galois_tpu/ops/_charpoly.py:15); n of the card-against-CPU checks (Goldilocks
# apart: its plain Fermat reciprocal is 127 limb products a column on the host)
LINALG_SIZES = {
    "mceliece": (13, 128, 8192), "gf256": 1024, "gf65536": 512, "m31": 1024, "goldilocks": 256,
    "polys": 512, "small": 128, "goldilocks_small": 65,
}



def np_conv_gf2m(a, b, m, f):
    """Product of two coefficient arrays over GF(2^m) (NumPy int64)."""
    a, b = np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)
    out = np.zeros(len(a) + len(b) - 1, dtype=np.int64)
    for j, bj in enumerate(b):
        out[j : j + len(a)] ^= np_gf2m_multiply(a, np.full(len(a), bj), m, f)
    return out


def perm_parity(q):
    """0 for an even permutation (a list), 1 for an odd one."""
    seen, cycles = [False] * len(q), 0
    for i in range(len(q)):
        if not seen[i]:
            cycles += 1
            j = i
            while not seen[j]:
                seen[j] = True
                j = q[j]
    return (len(q) - cycles) % 2


def linalg_path(gt, dev, timed):
    """Main path 6: row reduction, inv, solve, det, PLU, rank, and the char and
    min polys of matrices, through the public API on ``dev``. Every check is
    exact and independent of the elimination: products through the port's
    matmul, determinants and polynomials known by construction, and at n = 128
    the card's results against the port's CPU plain versions. ``timed(call)``
    returns (result, ms, launches by wrapper, peak device MiB) of one call."""
    from galois_tpu_torch.ops._linalg import _i16, _where
    from scripts._timing import mceliece_parity_check

    t_path = time.perf_counter()

    def line(label, ms, used, peak, extra=""):
        print(f"[main] {label}: {ms:.1f} ms per call, launches {used}, peak device memory {peak:.0f} MiB{extra}",
              flush=True)

    def host_mul(F):
        p, m = F.characteristic, F.degree
        if p == 2 and m > 1:
            f = F._meta.irreducible_poly_int
            return lambda a, b: int(np_gf2m_multiply(np.array([a]), np.array([b]), m, f)[0])
        return lambda a, b: a * b % p

    def neg(F, a):
        return a if F.characteristic == 2 else (-a) % F.characteristic

    def is_identity(X):
        return torch.equal(X._data, type(X).Identity(X.shape[0], device=X.device)._data)

    def masks(n):
        r, c = torch.arange(n, device=dev)[:, None], torch.arange(n, device=dev)[None, :]
        return r > c, r == c, r < c

    def factors(F, n, seed):
        """L unit lower, U upper with the nonzero diagonal D, random on the card."""
        lower, diag, upper = masks(n)
        R1, R2 = (F.Random((n, n), seed=seed + k, device=dev) for k in range(2))
        D = F.Random(n, low=1, seed=seed + 2, device=dev)
        I = F.Identity(n, device=dev)._data
        L = F._view(_where(lower, R1._data, I))
        U = F._view(_where(upper, R2._data, _where(diag, D._data.unsqueeze(-2), torch.zeros_like(I))))
        return L, U, D

    def built(F, n, seed):
        """A = (L U)[q], q a random row order, and det(A) = sign(q) prod(D),
        the product in Python ints."""
        L, U, D = factors(F, n, seed)
        q = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        X = (L @ U)._data
        A = F._view(_i16(X).index_select(-2, q).view(X.dtype))
        mul, d = host_mul(F), 1
        for v in ints(D):
            d = mul(d, v)
        return A, (neg(F, d) if perm_parity(q.tolist()) else d)

    def check_inverse(label, A, used, n, kernels=None):
        """``kernels``: the (product, reciprocal) wrappers of the field, whose
        launches must be as ``_row_reduce_data`` documents them: two products
        a column, then a tree of (n + 1).bit_length() - 1 and one more, and one
        reciprocal a call."""
        Ainv, ms, calls, peak = used
        if not is_identity(A @ Ainv):
            raise AssertionError(f"{label}: A @ inv(A) != I")
        extra = ""
        if kernels:
            want = {kernels[0]: 2 * n + n.bit_length() + 1, kernels[1]: 1}
            if any(calls.get(k) != v for k, v in want.items()):
                raise AssertionError(f"{label}: launches {calls}, not {want}")
            extra = f", launches as documented: {kernels[0]} two a column, {kernels[1]} one a call"
        line(label, ms, calls, peak, " | A @ inv(A) == I" + extra)
        return Ainv

    # 1. row reduction to systematic form of mceliece8192128's parity-check matrix
    m, t, n = LINALG_SIZES["mceliece"]
    GF2 = gt.GF(2)
    rng = np.random.default_rng(60)
    bits = mceliece_parity_check(gt, dev, rng, m, t, n)
    H = GF2._view(bits)
    R, ms, used, peak = timed(lambda: H.row_reduce())
    Rd = R._data
    nzr = (Rd != 0).any(dim=1)
    rank = int(nzr.sum())
    piv = (Rd[:rank] != 0).to(torch.int32).argmax(dim=1)
    ok = (
        rank == t * m and bool(nzr[:rank].all()) and bool((piv[1:] > piv[:-1]).all())
        and torch.equal(Rd[:, piv], GF2.Identity(t * m, device=dev)._data)
        and torch.equal((GF2._view(bits[:, piv]) @ GF2._view(Rd[:rank]))._data, bits)
        and torch.equal(H._data, bits)
    )
    if not ok:
        raise AssertionError(f"GF(2) {t * m} x {n} row_reduce: not the RREF of H (rank {rank})")
    systematic = bool(torch.equal(piv, torch.arange(t * m, device=dev)))
    line(f"row_reduce, GF(2) {t * m} x {n} (mceliece8192128's H)", ms, used, peak,
         f" | RREF, rank {rank}, H == H[:, pivots] @ R, systematic {systematic}, last pivot column {int(piv[-1])}")

    # 2. GF(2^8), default mode (K8, K8-A)
    F8 = gt.GF(2**8)
    n8 = LINALG_SIZES["gf256"]
    A8, det8 = built(F8, n8, 61)
    check_inverse(f"inv, GF(2^8) n = {n8}", A8, timed(lambda: np.linalg.inv(A8)), n8,
                  ("gf2m_multiply_swar", "gf2m_power"))
    b8 = F8.Random(n8, seed=62, device=dev)
    x, ms, used, peak = timed(lambda: np.linalg.solve(A8, b8))
    if not torch.equal((A8 @ x)._data, b8._data):
        raise AssertionError("GF(2^8) solve: A @ x != b")
    line(f"solve, GF(2^8) n = {n8}", ms, used, peak, " | A @ x == b")
    (P, L, U), ms, used, peak = timed(lambda: A8.plu_decompose())
    lower, diag, upper = masks(n8)
    I8 = F8.Identity(n8, device=dev)._data
    if not (torch.equal(_where(lower, I8, L._data), I8) and not bool((U._data[lower] != 0).any())
            and torch.equal((P @ L @ U)._data, A8._data)):
        raise AssertionError("GF(2^8) plu_decompose: P @ L @ U != A, or L or U not triangular")
    line(f"plu_decompose, GF(2^8) n = {n8}", ms, used, peak, " | P @ L @ U == A, L unit lower, U upper")
    d, ms, used, peak = timed(lambda: np.linalg.det(A8))
    if int(d) != det8:
        raise AssertionError(f"GF(2^8) det: {int(d)}, not {det8}")
    line(f"det, GF(2^8) n = {n8}", ms, used, peak, f" | det {int(d)} == sign(q) prod(diag U0)")
    r, ms, used, peak = timed(lambda: np.linalg.matrix_rank(A8))
    if r != n8:
        raise AssertionError(f"GF(2^8) matrix_rank: {r}, not {n8}")
    line(f"matrix_rank, GF(2^8) n = {n8}", ms, used, peak, f" | rank {r}")

    # 3. GF(2^8) in lookup mode (K3, K5)
    F8.compile("jit-lookup")
    try:
        check_inverse(f"inv, GF(2^8) jit-lookup n = {n8}", A8, timed(lambda: np.linalg.inv(A8)), n8,
                      ("lookup_multiply", "lookup_reciprocal"))
    finally:
        F8.compile("auto")

    # 4. GF(2^16) (K7, K8-A)
    F16 = gt.GF(2**16)
    n16 = LINALG_SIZES["gf65536"]
    A16, _ = built(F16, n16, 63)
    check_inverse(f"inv, GF(2^16) n = {n16}", A16, timed(lambda: np.linalg.inv(A16)), n16,
                  ("gf2m_multiply", "gf2m_power"))

    # 5. GF(2^31 - 1) (K9; the reciprocal is a Fermat ladder)
    FM = gt.GF(M31)
    nm = LINALG_SIZES["m31"]
    AM, detM = built(FM, nm, 64)
    bM = FM.Random(nm, seed=65, device=dev)
    x, ms, used, peak = timed(lambda: np.linalg.solve(AM, bM))
    if not torch.equal((AM @ x)._data, bM._data):
        raise AssertionError("GF(2^31 - 1) solve: A @ x != b")
    line(f"solve, GF(2^31-1) n = {nm}", ms, used, peak, " | A @ x == b")
    d, ms, used, peak = timed(lambda: np.linalg.det(AM))
    if int(d) != detM:
        raise AssertionError(f"GF(2^31 - 1) det: {int(d)}, not {detM}")
    line(f"det, GF(2^31-1) n = {nm}", ms, used, peak, f" | det {int(d)} == sign(q) prod(diag U0)")

    # 6. Goldilocks, planar limbs (K10; the reciprocal is a Fermat ladder)
    FG = gt.GF(GOLDILOCKS)
    ng = LINALG_SIZES["goldilocks"]
    AG, detG = built(FG, ng, 66)
    check_inverse(f"inv, Goldilocks n = {ng}", AG, timed(lambda: np.linalg.inv(AG)), ng)
    d, ms, used, peak = timed(lambda: np.linalg.det(AG))
    if int(d) != detG:
        raise AssertionError(f"Goldilocks det: {int(d)}, not {detG}")
    line(f"det, Goldilocks n = {ng}", ms, used, peak, f" | det {int(d)} == sign(q) prod(diag U0)")

    # 7. char and min polys: A = S C(f) S^-1 (charpoly = minpoly = f) and
    # A = S diag(C(g), C(g)) S^-1 (charpoly g^2, minpoly g), C a companion matrix
    npoly = LINALG_SIZES["polys"]

    def companion(F, coeffs_asc):
        k = len(coeffs_asc)
        C = torch.zeros((k, k), dtype=torch.int64, device=dev)
        C[torch.arange(1, k), torch.arange(k - 1)] = 1
        C[:, k - 1] = torch.tensor([neg(F, c) for c in coeffs_asc], device=dev)
        return C

    for F, seed in ((F8, 70), (FM, 71)):
        L, U, _ = factors(F, npoly, seed)
        S = L @ U
        Sinv = np.linalg.inv(S)
        if not is_identity(S @ Sinv):
            raise AssertionError(f"{F.name}: S @ inv(S) != I")
        fc = rng.integers(0, F.order, npoly).tolist()
        gc = rng.integers(0, F.order, npoly // 2).tolist()
        Cg = companion(F, gc)
        D = torch.zeros((npoly, npoly), dtype=torch.int64, device=dev)
        D[: npoly // 2, : npoly // 2] = D[npoly // 2 :, npoly // 2 :] = Cg
        g_desc = [1] + gc[::-1]
        if F.characteristic == 2:
            g2 = np_conv_gf2m(g_desc, g_desc, F.degree, F._meta.irreducible_poly_int).tolist()
        else:
            g2 = np_conv_mod(g_desc, g_desc, F.order).tolist()
        for label, Cm, want_char, want_min in (
            ("S C(f) S^-1", companion(F, fc), [1] + fc[::-1], [1] + fc[::-1]),
            ("S diag(C(g), C(g)) S^-1", D, g2, g_desc),
        ):
            A = S @ F._view(Cm.to(F._meta.torch_dtype)) @ Sinv
            for name, want in (("characteristic_poly", want_char), ("minimal_poly", want_min)):
                poly, ms, used, peak = timed(getattr(A, name))
                if ints(poly.coefficients()) != want:
                    raise AssertionError(f"{F.name} {name} of {label}: not the polynomial it was built with")
                line(f"{name}, {F.name} n = {npoly}, A = {label}", ms, used, peak, f" | degree {poly.degree}, as built")

    # 8. the same calls at n = 128: the card's results against the port's CPU plain versions
    ns, ngs = LINALG_SIZES["small"], LINALG_SIZES["goldilocks_small"]

    def on_cpu(X):
        return type(X)._view(X._data.cpu(), X._dtype)

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, gt.Poly):
            return a == b
        if hasattr(a, "_data"):
            return a._data.device == dev and torch.equal(a._data.cpu(), b._data)
        return a == b

    Hs = GF2._view(bits[:ns, : 5 * ns].contiguous())
    cases = [("GF(2) row_reduce", Hs, lambda X, b: X.row_reduce())]
    A, _ = built(F8, ns, 80)
    b = F8.Random(ns, seed=81, device=dev)
    cases += [
        ("GF(2^8) inv", A, lambda X, b: np.linalg.inv(X)),
        ("GF(2^8) solve", A, lambda X, b: np.linalg.solve(X, b)),
        ("GF(2^8) det", A, lambda X, b: np.linalg.det(X)),
        ("GF(2^8) plu_decompose", A, lambda X, b: X.plu_decompose()),
        ("GF(2^8) matrix_rank", A, lambda X, b: np.linalg.matrix_rank(X)),
    ]
    A16s, _ = built(F16, ns, 82)
    cases.append(("GF(2^16) inv", A16s, lambda X, b: np.linalg.inv(X)))
    AMs, _ = built(FM, ns, 83)
    bMs = FM.Random(ns, seed=84, device=dev)
    cases += [("GF(2^31-1) solve", AMs, lambda X, b: np.linalg.solve(X, b)), ("GF(2^31-1) det", AMs, lambda X, b: np.linalg.det(X))]
    AGs, _ = built(FG, ngs, 85)
    cases += [(f"Goldilocks inv (n = {ngs})", AGs, lambda X, b: np.linalg.inv(X)), (f"Goldilocks det (n = {ngs})", AGs, lambda X, b: np.linalg.det(X))]
    for F, seed in ((F8, 86), (FM, 87)):
        Ar = F.Random((ns, ns), seed=seed, device=dev)
        cases += [(f"{F.name} characteristic_poly", Ar, lambda X, b: X.characteristic_poly()),
                  (f"{F.name} minimal_poly", Ar, lambda X, b: X.minimal_poly())]
    seconds = {"card": 0.0, "cpu": 0.0}
    for label, X, call in cases:
        rhs = {F8: b, FM: bMs}.get(type(X))
        t0 = time.perf_counter()
        got = call(X, rhs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = call(on_cpu(X), None if rhs is None else on_cpu(rhs))
        seconds["card"] += t1 - t0
        seconds["cpu"] += time.perf_counter() - t1
        if not same(got, want):
            raise AssertionError(f"n = {ns}: {label} on the card differs from the port's CPU result")
    F8.compile("jit-lookup")
    try:
        got, want = np.linalg.inv(A), np.linalg.inv(on_cpu(A))
    finally:
        F8.compile("auto")
    if not same(got, want):
        raise AssertionError(f"n = {ns}: GF(2^8) jit-lookup inv on the card differs from the port's CPU result")
    print(
        f"[main] n = {ns} ({len(cases) + 1} calls: {', '.join(c[0] for c in cases)}, GF(2^8) jit-lookup inv): the card's "
        f"results equal the port's CPU plain versions | card {seconds['card']:.1f} s, CPU {seconds['cpu']:.1f} s",
        flush=True,
    )
    print(f"[main] main path 6 took {time.perf_counter() - t_path:.1f} s", flush=True)


def py_factor(n):
    """{prime: exponent} of n by trial division."""
    out, d = {}, 2
    while d * d <= n:
        while n % d == 0:
            out[d] = out.get(d, 0) + 1
            n //= d
        d += 1
    if n > 1:
        out[n] = out.get(n, 0) + 1
    return out


def py_dlog(xs, g, p):
    """Discrete logs base g of the units xs of GF(p) in Python ints:
    Pohlig-Hellman over the factors of p - 1, each digit by a table of the
    order-q subgroup, then the CRT."""
    n = p - 1
    parts = []
    for q, e in py_factor(n).items():
        gq = pow(g, n // q**e, p)
        table = {pow(gq, d * q ** (e - 1), p): d for d in range(q)}
        parts.append((q, e, gq, table))
    out = []
    for x in xs:
        r = 0
        for q, e, gq, table in parts:
            hq, xk = pow(x, n // q**e, p), 0
            for k in range(e):
                xk += table[pow(hq * pow(gq, -xk, p) % p, q ** (e - 1 - k), p)] * q**k
            m = n // q**e
            r += xk * m * pow(m, -1, q**e)
        out.append(r % n)
    return out


def elements_path(gt, dev, timed):
    """Main path 7: the field's element functions through the public API on
    ``dev`` at 2^24 elements: default-mode logs, square roots, squares,
    trace and norm, roots of polynomials, and the element collections and
    helper polynomials. Every check is exact: on the card (alpha ** log ==
    x, r * r == x, r <= -r) and on prefixes against Python-int and NumPy
    references written in this script. ``timed(call)`` returns (result, ms,
    launches by wrapper, peak device MiB) of one call."""
    n = 2**24
    t_path = time.perf_counter()
    rng = np.random.default_rng(70)

    def line(label, ms, used, peak, extra=""):
        print(f"[main] {label}: {ms:.1f} ms, launches {used}, peak device memory {peak:.0f} MiB{extra}", flush=True)

    def field_mul(F):
        """An independent NumPy product of F's int reprs (int64)."""
        p, m = F.characteristic, F.degree
        if m == 1:
            return lambda a, b: (a.astype(object) * b.astype(object) % p).astype(np.int64)
        f = F._meta.irreducible_poly_int
        if p == 2:
            return lambda a, b: np_gf2m_multiply(a, b, m, f)
        f_asc = [(f // p**i) % p for i in range(m + 1)]
        return lambda a, b: np_gfpm_multiply(a, b, p, f_asc)

    def ref_logs(F, xs):
        alpha = int(F.primitive_element)
        if F.degree == 1:
            return py_dlog(xs, alpha, F.order)
        _, log = np_exp_log(field_mul(F), alpha, F.order)
        return [int(v) for v in log[np.asarray(xs)]]

    def field_add(F):
        """An independent NumPy sum of F's int reprs: digit by digit mod p."""
        p, m = F.characteristic, F.degree
        if p == 2:
            return lambda a, b: a ^ b
        w = p ** np.arange(m)
        return lambda a, b: (((a[..., None] // w) % p + (b[..., None] // w) % p) % p * w).sum(axis=-1)

    def le_on_card(A, B):
        """A <= B as integers, elementwise on the card: int storage directly,
        planar limbs from the top limb down."""
        a, b = A._data.to(torch.int64), B._data.to(torch.int64)
        if a.ndim == len(A.shape):
            return a <= b
        le, decided = torch.ones_like(a[0], dtype=torch.bool), torch.zeros_like(a[0], dtype=torch.bool)
        for k in reversed(range(a.shape[0])):
            ne = a[k] != b[k]
            le = torch.where(decided | ~ne, le, a[k] < b[k])
            decided = decided | ne
        return le

    F8, F16, F35 = gt.GF(2**8), gt.GF(2**16), gt.GF(3**5)
    FM, FN, FG = gt.GF(2**31 - 1), gt.GF(P), gt.GF(GOLDILOCKS)

    # 1. default-mode log: the LOG table (K6) up to 2^20, the batched Pohlig-Hellman above
    for F, route in ((F8, "K6"), (F16, "K6"), (F35, "K6"), (FM, "Pohlig-Hellman"), (FN, "Pohlig-Hellman")):
        x = F.Random(n, low=1, seed=F.order % 1000, device=dev)
        logs, ms, used, peak = timed(x.log)
        back = F.primitive_element ** logs
        if not (isinstance(logs, np.ndarray) and logs.dtype == np.int64 and logs.shape == (n,)):
            raise AssertionError(f"{F.name} log: not an int64 ndarray of shape ({n},)")
        if not torch.equal(back._data.to(dev), x._data):
            raise AssertionError(f"{F.name} log: alpha ** log != x on the card")
        if logs[: 2**10].tolist() != ref_logs(F, ints(x[: 2**10])):
            raise AssertionError(f"{F.name} log disagrees with the Python-int discrete logs")
        line(f"{F.name} x.log() ({route}), 2^24 elements", ms, used, peak, " | alpha ** log == x, 2^10 prefix exact")
        if F is FM:
            alpha = int(F.primitive_element)
            b5 = pow(alpha, 5, F.order)
            logs5, ms, used, peak = timed(lambda: x.log(b5))
            if not torch.equal((F(b5, device=dev) ** logs5)._data, x._data):
                raise AssertionError("GF(2^31-1) log base alpha^5: (alpha^5) ** log != x on the card")
            line("GF(2^31-1) x.log(alpha^5), 2^24 elements", ms, used, peak, " | (alpha^5) ** log == x")
            try:
                x[:4].log(pow(alpha, 3, F.order))
            except ArithmeticError:
                pass
            else:
                raise AssertionError("GF(2^31-1) log base alpha^3 (not a generator) did not raise")
        del x, back

    # 2. square roots of squares, is_square of random elements
    for F in (F8, F16, FM, FN, FG):
        y = F.Random(n, seed=F.order % 997, device=dev)
        x = y * y
        r, ms, used, peak = timed(lambda: np.sqrt(x))
        if not torch.equal((r * r)._data, x._data):
            raise AssertionError(f"{F.name} sqrt: r * r != x on the card")
        if F.characteristic != 2 and not bool(le_on_card(r, -r).all()):
            raise AssertionError(f"{F.name} sqrt: some root is above its negation")
        xs, rs, mul = ints(x[: 2**12]), ints(r[: 2**12]), field_mul(F)
        if F.characteristic == 2:
            ok = mul(np.array(rs), np.array(rs)).tolist() == xs
        else:
            p = F.order
            ok = all(v * v % p == u and v <= (p - v) % p for u, v in zip(xs, rs))
        if not ok:
            raise AssertionError(f"{F.name} sqrt disagrees with the Python-int check")
        line(f"{F.name} np.sqrt(y * y), 2^24 elements", ms, used, peak, " | r * r == x, r <= -r, 2^12 prefix exact")
        z = F.Random(n, seed=F.order % 991, device=dev)
        sq, ms, used, peak = timed(z.is_square)
        zs = ints(z[: 2**12])
        want = [True] * len(zs) if F.characteristic == 2 else [pow(v, (F.order - 1) // 2, F.order) in (0, 1) for v in zs]
        if sq.shape != (n,) or sq[: 2**12].tolist() != want:
            raise AssertionError(f"{F.name} is_square disagrees with Euler's criterion")
        line(f"{F.name} is_square(), 2^24 elements", ms, used, peak, f" | Euler's criterion on a 2^12 prefix, {int(sq.sum())} squares")
        del y, x, r, z

    # 3. trace and norm, against products of the conjugates x^(p^i) in NumPy
    for F in (F8, F35):
        x = F.Random(n, seed=F.order % 983, device=dev)
        p, m, mul, add = F.characteristic, F.degree, field_mul(F), field_add(F)
        xs = np.array(ints(x[: 2**12]))
        conj, tr, nm = xs.copy(), np.zeros_like(xs), np.ones_like(xs)
        for _ in range(m):  # the sum and the product of the conjugates x^(p^i)
            tr = add(tr, conj)
            nm = mul(nm, conj)
            nxt = conj
            for _ in range(p - 1):
                nxt = mul(nxt, conj)
            conj = nxt
        for name, want in (("field_trace", tr), ("field_norm", nm)):
            out, ms, used, peak = timed(getattr(x, name))
            if type(out).order != p or out.shape != (n,) or ints(out[: 2**12]) != want.tolist():
                raise AssertionError(f"{F.name} {name} disagrees with the NumPy reference")
            line(f"{F.name} {name}(), 2^24 elements", ms, used, peak, " | 2^12 prefix exact")
        del x

    # 4. roots: the Chien scan over GF(2^16) (K7) and GF(2^8) (K8), the host factors over GF(2^31 - 1)
    roots16 = [int(v) for v in rng.choice(2**16, 255, replace=False)]
    f16 = gt.Poly.Roots(roots16, field=F16)
    got, ms, used, peak = timed(f16.roots)
    if ints(got) != sorted(roots16):
        raise AssertionError("GF(2^16) roots of a degree-255 Poly.Roots: not its roots")
    line("GF(2^16) Poly.roots(), degree 255 (Chien scan over 2^16 elements)", ms, used, peak, " | the 255 roots")
    mults = []
    while sum(mults) < 32:
        mults.append(min(int(rng.integers(1, 4)), 32 - sum(mults)))
    roots8 = [int(v) for v in rng.choice(256, len(mults), replace=False)]
    f8 = gt.Poly.Roots(roots8, mults, field=F8)
    (got, mult), ms, used, peak = timed(lambda: f8.roots(multiplicity=True))
    if list(zip(ints(got), mult.tolist())) != sorted(zip(roots8, mults)):
        raise AssertionError("GF(2^8) roots with multiplicity of a degree-32 Poly.Roots: not its roots")
    line(f"GF(2^8) Poly.roots(multiplicity=True), degree 32, {len(mults)} roots", ms, used, peak, " | roots and multiplicities")
    rootsM = sorted({int(v) for v in rng.integers(1, FM.order, 32)})
    fM = gt.Poly.Roots(rootsM, field=FM)
    got, ms, used, peak = timed(fM.roots)
    if ints(got) != rootsM:
        raise AssertionError("GF(2^31-1) roots of a degree-32 Poly.Roots: not its roots")
    line("GF(2^31-1) Poly.roots(), degree 32 (host factors)", ms, used, peak, " | the 32 roots")

    # 5. the collections and the helper polynomials
    prim, ms, used, peak = timed(lambda: F16.primitive_elements)
    phi = 2**16 - 1
    for q in py_factor(2**16 - 1):
        phi = phi // q * (q - 1)
    orders = prim.multiplicative_order()
    pi = ints(prim)
    if len(pi) != phi or pi != sorted(set(pi)) or not (orders == 2**16 - 1).all():
        raise AssertionError("GF(2^16).primitive_elements: not phi(q - 1) distinct elements of order q - 1")
    line("GF(2^16).primitive_elements", ms, used, peak, f" | {len(pi)} = phi(65535), each of order 65535 (multiplicative_order on the card)")
    F65537 = gt.GF(65537)
    sq, ms, used, peak = timed(lambda: F65537.squares)
    if ints(sq) != np.unique(np.arange(65537, dtype=np.int64) ** 2 % 65537).tolist():
        raise AssertionError("GF(65537).squares disagrees with the squares in NumPy")
    line("GF(65537).squares", ms, used, peak, f" | {len(ints(sq))} squares, as NumPy's")
    c20, ms, used, peak = timed(lambda: gt.conway_poly(2, 20))
    if int(c20) != 2**20 + 2**10 + 2**9 + 2**7 + 2**6 + 2**5 + 2**4 + 2 + 1 or not c20.is_conway():
        raise AssertionError("conway_poly(2, 20) is not x^20 + x^10 + x^9 + x^7 + x^6 + x^5 + x^4 + x + 1")
    line("conway_poly(2, 20)", ms, used, peak, f" | {c20}")
    xs = F8([int(v) for v in rng.choice(256, 64, replace=False)], device=dev)
    ys = F8.Random(64, seed=71, device=dev)
    L, ms, used, peak = timed(lambda: gt.lagrange_poly(xs, ys))
    if L.degree >= 64 or not torch.equal(L(xs)._data, ys._data):
        raise AssertionError("lagrange_poly through 64 points over GF(2^8) misses a point")
    line("lagrange_poly, 64 points over GF(2^8)", ms, used, peak, f" | degree {L.degree}, L(x_i) == y_i on the card")
    print(f"[main] main path 7 took {time.perf_counter() - t_path:.1f} s", flush=True)


def py_clmul_mod(a, b, m, f):
    """Independent Python-int reference for GF(2^m) products, any m."""
    c = 0
    while b:
        if b & 1:
            c ^= a
        b >>= 1
        a <<= 1
    for i in range(2 * m - 2, m - 1, -1):
        if (c >> i) & 1:
            c ^= f << (i - m)
    return c


def py_inv_mod(a, m, f):
    """a^(2^m - 2) over GF(2)[x]/f by square-and-multiply in Python ints."""
    r = 1
    for bit in bin(2**m - 2)[2:]:
        r = py_clmul_mod(r, r, m, f)
        if bit == "1":
            r = py_clmul_mod(r, a, m, f)
    return r


def k14_costs(m, f):
    """32-bit integer operations and shared-memory words of K14's forms
    (csrc/gf2_limb.cu) per element, counted as ``scan_ops`` counts: N = 2
    ceil(m / 64) words, T terms of f - x^m. Product: a into the frame and
    its shifts by 1, 2, 3 (4 (N + 1) SHF), the 16 multiples (12 (N + 1)
    LOP3), the comb (8 positions of N nibbles at 2 operations and N (N + 1)
    XORs at two a LOP3, 7 shifts of 2N words), the reduction, the shift out
    of the frame (N) and the limb packing (2N); 16 (N + 1) table writes and
    8 N (N + 1) reads. Square: 2N spread words at 7, the shift into the
    frame (2N), the reduction, N and 2N. Reduction: sparse f two passes of
    T (N + 1) SHF and (N + 1) / 2 LOP3; dense f 4N bytes of 2 + 1.5 (N + 1)
    and N table reads each. The reciprocal is ``chain_costs``' squares and
    products."""
    from galois_tpu_torch.ops._limb_binary import fold_inputs

    N = 2 * -(-m // 64)
    terms = fold_inputs(m, f)[1]
    sparse, T = terms is not None, len(terms or ())
    red = 2 * T * 1.5 * (N + 1) if sparse else 4 * N * (2 + 1.5 * (N + 1))
    red_smem = 0 if sparse else 4 * N * N
    mul = 16 * (N + 1) + 16 * N + 4 * N * (N + 1) + 14 * N + red + N + 2 * N
    mul_smem = 16 * (N + 1) + 8 * N * (N + 1) + red_smem
    sqr = 14 * N + 2 * N + red + N + 2 * N
    c = chain_costs(m, f)
    return {"mul": mul, "mul_smem": mul_smem, "sqr": sqr, "inv_sq": c["inv_sq"], "inv_mul": c["inv_mul"],
            "inv": c["inv_sq"] * sqr + c["inv_mul"] * mul, "inv_smem": c["inv_sq"] * red_smem + c["inv_mul"] * mul_smem}


def smem_text(words, ms):
    """The shared-memory words of a form at one conflict-free wavefront (32
    words) a clock per SM: a count of the form, not a bound on the map."""
    t = words / 32 / SMEM_WAVEFRONTS_PER_S * 1e3
    return f"its shared-memory words {t:.4f} ms at one wavefront a clock per SM, the kernel at {t / ms:.0%} of them"


def scan_limb_kernels(gt, dev, record, smi):
    """Phase 3 for K12, K13 and K14: each kernel against its plain torch
    version on the card at the shapes main path 8 gives it (exact), timed
    beside its plain version where that finishes in seconds. ``record``
    stores the kernel's line of the report."""
    from scripts._timing import eager_ms, graph_ms

    from galois_tpu_torch.fields._hostfield import get_host_field
    from galois_tpu_torch.ops._kernels import get_ops
    from galois_tpu_torch.ops._lfsr_scan import (
        BLOCK_TICKS,
        _blocks,
        _field,
        berlekamp_massey_long,
        berlekamp_massey_long_plain,
        block_inputs,
        block_matrices,
        lfsr_step,
        lfsr_step_plain,
    )
    from galois_tpu_torch.ops._limb_binary import (
        DENSE_MODULI,
        EDGE_MODULI,
        fold_inputs,
        gf2_limb_multiply,
        gf2_limb_multiply_plain,
        gf2_limb_power,
        gf2_limb_power_plain,
        gf2_limb_square,
        gf2_limb_square_plain,
    )

    def check(tag, got, want):
        err = max_abs_err(got.to(torch.int64), want.to(torch.int64))
        print(f"[kernel] {smi} | {tag}: max_abs_err {err}", flush=True)
        if err:
            raise AssertionError(f"{tag} disagrees with its plain version")
        return err

    def once_ms(fn):
        """fn()'s result and its CUDA-event time, one call."""
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        torch.cuda.synchronize()
        return out, t0.elapsed_time(t1)

    # K14: GF(2^128) (GCM's f) at the main path's 2^24, held on a 2^16 slice; GF(2^233) (B-233's f)
    def k14_case(tag, x, y, m, fi, n_pow):
        """Product, square, a one-element operand, the power entries (0, 1,
        the reciprocal, 2^m - 1, the square root, exponent words with zeros)
        against the plain versions on the card; (product error, power error)."""
        err = check(f"K14 gf2_limb_multiply {tag}", gf2_limb_multiply(x, y, m, fi), gf2_limb_multiply_plain(x, y, m, fi))
        err = max(err, check(f"K14 square {tag}", gf2_limb_square(x, m, fi), gf2_limb_square_plain(x, m, fi)))
        one = y[:, :1].reshape(-1)
        err = max(err, check(f"K14 gf2_limb_multiply {tag} one-element operand", gf2_limb_multiply(x, one, m, fi),
                             gf2_limb_multiply_plain(x, one, m, fi)))
        u, perr = x[:, :n_pow], 0
        for e, name in ((0, "0"), (1, "1"), (2**m - 2, "reciprocal"), (2**m - 1, "2^m - 1"), (2 ** (m - 1), "sqrt")):
            perr = max(perr, check(f"K14 gf2_limb_power {tag} e = {name}, {n_pow} elements", gf2_limb_power(u, e, m, fi),
                                   gf2_limb_power_plain(u, e, m, fi)))
        ew = [torch.randint(0, 2**62, (n_pow,), device=dev), torch.randint(0, 2, (n_pow,), device=dev)]
        ew[0][::4] = 0
        ew[1][::2] = 0
        perr = max(perr, check(f"K14 gf2_limb_power {tag} exponent words with zeros, {n_pow} elements",
                               gf2_limb_power(u, ew, m, fi, 63), gf2_limb_power_plain(u, ew, m, fi, 63)))
        return err, perr

    for q, f, n in ((2**128, "x^128 + x^7 + x^2 + x + 1", 2**24), (2**233, "x^233 + x^74 + 1", 2**22)):
        F = gt.GF(q, irreducible_poly=f)
        m, fi, L = F._meta.degree, F._meta.irreducible_poly_int, F._meta.storage_width
        x = F.Random(n, seed=m, device=dev)._data
        y = F.Random(n, seed=m + 1, device=dev)._data
        s = slice(0, 2**16)
        err = check(f"K14 gf2_limb_multiply GF(2^{m}) 2^16 of {n}", gf2_limb_multiply(x, y, m, fi)[:, s],
                    gf2_limb_multiply_plain(x[:, s], y[:, s], m, fi))
        e2, perr = k14_case(f"GF(2^{m}) 2^16", x[:, s], y[:, s], m, fi, 2**12)
        err = max(err, e2)
        if q == 2**128:
            # timed at 2^24: the product by graph replay, its plain form once; bound: 3 x 2^24 x 16 bytes
            costs = k14_costs(m, fi)
            ms = graph_ms(lambda: gf2_limb_multiply(x, y, m, fi), 10)
            pms = eager_ms(lambda: gf2_limb_multiply_plain(x, y, m, fi), 1)
            nbytes = 3 * n * 2 * L
            record("gf2_limb_multiply", err, ms, pms, bound(nbytes))
            print(f"[kernel] {smi} | K14 gf2_limb_multiply GF(2^128) n=2^24: {ms:.3f} ms (graph replay) | plain {pms:.1f} ms | "
                  + bounds_text(nbytes, n * costs["mul"], ms) + " | " + smem_text(n * costs["mul_smem"], ms), flush=True)
            # the reciprocal at 2^22, held whole against the plain version's result from its timed call
            u = x[:, : 2**22]
            ms = graph_ms(lambda: gf2_limb_power(u, 2**m - 2, m, fi), 2)
            want, pms = once_ms(lambda: gf2_limb_power_plain(u, 2**m - 2, m, fi))
            perr = max(perr, check("K14 gf2_limb_power GF(2^128) reciprocal, 2^22 elements", gf2_limb_power(u, 2**m - 2, m, fi),
                                   want))
            del want
            nbytes = 2 * 2**22 * 2 * L
            record("gf2_limb_power", perr, ms, pms, bound(nbytes))
            print(f"[kernel] {smi} | K14 gf2_limb_power GF(2^128) reciprocal n=2^22 (Itoh-Tsujii: {costs['inv_sq']} squares, "
                  f"{costs['inv_mul']} products): {ms:.3f} ms (graph replay) | plain (Itoh-Tsujii) {pms:.1f} ms | "
                  + bounds_text(nbytes, 2**22 * costs["inv"], ms) + " | " + smem_text(2**22 * costs["inv_smem"], ms), flush=True)
        else:
            record("gf2_limb_multiply", err)
            record("gf2_limb_power", perr)
        del x, y
        torch.cuda.empty_cache()
    # K14 at the word edges (m = 33, 65, 576; sparse f) and at dense irreducible moduli (the byte
    # table): raw moduli on random limbs, no field built
    gen = torch.Generator(device=dev).manual_seed(15)
    for m, fi in EDGE_MODULI + DENSE_MODULI:
        L = -(-m // 16)
        top = m - 16 * (L - 1)
        masks = torch.tensor([0xFFFF] * (L - 1) + [(1 << top) - 1], device=dev).reshape(L, 1)
        x, y = ((torch.randint(0, 2**16, (L, 4096), generator=gen, device=dev) & masks).to(torch.int32).to(torch.int16)
                .view(torch.uint16) for _ in range(2))
        kind = "sparse" if fold_inputs(m, fi)[1] else "dense"
        err, perr = k14_case(f"m = {m} ({kind} f) 4096", x, y, m, fi, 16)
        record("gf2_limb_multiply", err)
        record("gf2_limb_power", perr)

    def k12_check(tag, ops, st, tp, kind, direction, n, inv, blocks=None):
        s, y = lfsr_step(ops, st, tp, n, kind, direction, inv, blocks)
        inv_t = torch.full((1,), inv, dtype=st.dtype, device=dev)
        s_p, y_p = lfsr_step_plain(ops, st, tp, n, kind, direction, inv_t)
        return check(f"K12 lfsr_step {tag} {kind} {direction} {n} ticks", torch.cat([s, y]), torch.cat([s_p, y_p])), y

    def k13_check(tag, ops, seq, host=False):
        """K13 against its plain scan on the same input: on the card (timed), or on the host (host: over
        a prime field 2-3x quicker than one torch launch a step on the card; an extension field's plain
        products and reciprocals are chains of torch passes there, slower than the card's kernels)."""
        c, Lc = berlekamp_massey_long(ops, seq)
        if host:
            t0 = time.perf_counter()
            c_p, L_p = berlekamp_massey_long_plain(ops, seq.cpu())
            pms = (time.perf_counter() - t0) * 1e3
            c, Lc = c.cpu(), Lc.cpu()
        else:
            (c_p, L_p), pms = once_ms(lambda: berlekamp_massey_long_plain(ops, seq))
        err = check(f"K13 berlekamp_massey_long {tag} N={seq.shape[0]} (L = {int(Lc)})",
                    torch.cat([c.to(torch.int64), Lc.reshape(1)]), torch.cat([c_p.to(torch.int64), L_p.reshape(1)]))
        return err, c, int(Lc), pms

    # K12: the main path's registers, against the plain tick loop on the card
    rng = np.random.default_rng(110)
    F2, F8, FM = gt.GF(2), gt.GF(2**8), gt.GF(2**31 - 1)
    gen = gt.ReedSolomon(255, 223).generator_poly
    regs = [
        ("GF(2) degree-20", F2, gt.primitive_poly(2, 20).coefficients(), "fibonacci"),
        ("GF(2^8) RS(255,223) generator", F8, gen.coefficients(), "galois"),
        ("GF(2^31-1) degree-16", FM, [1] + [int(v) for v in rng.integers(1, 2**31 - 1, 16)], "fibonacci"),
    ]
    err, outputs = 0, {}
    for tag, F, c, kind in regs:
        ops = get_ops(F._meta, F._mode)
        c = [int(v) for v in np.asarray(c, dtype=object)]
        hf = get_host_field(F._meta)
        taps = [hf.negative(v) for v in c[1:]]
        taps = taps[::-1] if kind == "galois" else taps
        k = len(taps)
        st = F(rng.integers(1, F.order, k), device=dev)._data
        tp = F(taps, device=dev)._data
        inv = hf.reciprocal(taps[k - 1 if kind == "fibonacci" else 0])
        blocks = {}  # the block form's matrices, kept as a register keeps them
        for direction, n in (("forward", 8192), ("backward", 1024)):
            # the matrices as the wrapper builds them (one launch on the k basis states) and as the
            # plain tick loop does on the identity, in the kernel's layout
            inv_t = torch.full((1,), inv, dtype=st.dtype, device=dev)
            got = _blocks(ops, tp, kind, direction, inv, _field(ops, dev))
            want = block_inputs(ops, *block_matrices(ops, tp, kind, direction, inv_t)[:2], k)
            err = max(err, check(f"K12 block form's matrices {tag} {kind} {direction}",
                                 torch.cat([x.reshape(-1) for x in got if x is not None]),
                                 torch.cat([x.reshape(-1) for x in want if x is not None])))
            e, y = k12_check(tag, ops, st, tp, kind, direction, n, inv, blocks)
            err = max(err, e)
            outputs[F.name, direction] = y
        # the block form's edges: fewer than two blocks (tick by tick), whole blocks, a tail
        for direction in ("forward", "backward"):
            for n in (1, BLOCK_TICKS - 1, BLOCK_TICKS + 1, 2 * BLOCK_TICKS, 2 * BLOCK_TICKS + 1, 10007):
                err = max(err, k12_check(tag, ops, st, tp, kind, direction, n, inv, blocks)[0])
        if F is F2:
            n = 2**14
            ms = eager_ms(lambda: lfsr_step(ops, st, tp, n, kind, "forward", 0, blocks), 3)
            pms = eager_ms(lambda: lfsr_step_plain(ops, st, tp, n, kind, "forward"), 1)
            nbytes = 2 * k + n  # state and taps in, the state and n outputs out (uint8)
            k12_line = (err, ms, pms, bound(nbytes))
            print(f"[kernel] {smi} | K12 lfsr_step {tag} Fibonacci {n} ticks: {ms:.3f} ms ({ms / n * 1e3:.3f} us a tick) | "
                  f"plain {pms:.1f} ms | bound {bound(nbytes)[0]:.6f} ms (bytes; a chain of {n} dependent ticks)", flush=True)

    # the block form at k = 1, 31, 32, 33 (one warp) and 1024 (32 warps), every mode, over GF(2^8)
    ops8, hf8 = get_ops(F8._meta, F8._mode), get_host_field(F8._meta)
    for k in (1, 31, 32, 33, 1024):
        st = F8(rng.integers(0, 256, k), device=dev)._data
        tp = F8(rng.integers(1, 256, k), device=dev)._data
        for kind, end in (("fibonacci", k - 1), ("galois", 0)):
            blocks = {}
            for direction in ("forward", "backward"):
                for n in (1031, BLOCK_TICKS - 1, 2 * BLOCK_TICKS + 1):  # the first builds the block form
                    err = max(err, k12_check(f"GF(2^8) order {k}", ops8, st, tp, kind, direction, n,
                                             hf8.reciprocal(int(tp[end])), blocks)[0])

    # K13 at the main path's shapes: its 2^14 random GF(2) elements (the lookahead, 32 steps a block),
    # 8192 outputs of the GF(2^8) register and 4096 of the GF(2^31-1) one (warp 0's steps, runs of
    # d = 0 32 at a time), each timed beside its plain scan on the card (run once, as it is checked)
    from galois_tpu_torch.ops import _lfsr_scan

    t13 = time.perf_counter()
    ops2 = get_ops(F2._meta, F2._mode)
    seq = F2(bm_sequence(), device=dev)._data
    err13, c, L, pms = k13_check("GF(2) random", ops2, seq)
    timed13 = [("GF(2) 2^14 random", ops2, seq, L, pms)]
    for tag, F, y in (("GF(2^8) 8192 GLFSR outputs", F8, outputs[F8.name, "forward"]),
                      ("GF(2^31-1) 4096 FLFSR outputs", FM, outputs[FM.name, "forward"][:4096])):
        ops = get_ops(F._meta, F._mode)
        e, _, Ly, py = k13_check(tag, ops, y)
        err13 = max(err13, e)
        timed13.append((tag, ops, y, Ly, py))
    # the forms' edges: random elements across the switch from warp 0 to the CTA (256 elements) in
    # every kind, N not a multiple of 32, L changing inside a block (an LFSR's output, then random
    # elements), all zeros, the impulse (L = N), GF(2) at its word edges, and the global-memory form
    # (no shared-memory budget) in uint8 and int64 storage; a prime field's against the plain scan on
    # the host
    t_edges = time.perf_counter()
    edges = [(F, F(rng.integers(0, F.order, n), device=dev)._data)
             for F, n in ((F8, 1024), (FM, 1024), (gt.GF(3**5), 600), (gt.GF(2**17), 300), (F2, 1000), (FM, 300))]
    edges += [(F2, torch.cat([outputs[F2.name, "forward"][:600], F2(rng.integers(0, 2, 300), device=dev)._data])),
              (F8, torch.cat([outputs[F8.name, "forward"][:600], F8(rng.integers(0, 256, 400), device=dev)._data])),
              (F2, torch.zeros(700, dtype=torch.uint8, device=dev)), (F8, torch.zeros(700, dtype=torch.uint8, device=dev)),
              (F2, F2([0] * 699 + [1], device=dev)._data), (FM, FM([0] * 299 + [1], device=dev)._data)]
    edges += [(F2, F2(rng.integers(0, 2, n), device=dev)._data) for n in (31, 32, 33, 1023, 1024, 1025)]
    for F, y in edges:
        err13 = max(err13, k13_check(f"{F.name} edge", get_ops(F._meta, F._mode), y, host=F.degree == 1)[0])
    budget = _lfsr_scan.BM_SMEM_BYTES
    _lfsr_scan.BM_SMEM_BYTES = 0
    try:
        for F, y in (edges[4], edges[7], edges[5]):  # GF(2), GF(2^8): uint8; GF(2^31 - 1): int64
            err13 = max(err13, k13_check(f"{F.name} global memory", get_ops(F._meta, F._mode), y,
                                         host=F.degree == 1)[0])
    finally:
        _lfsr_scan.BM_SMEM_BYTES = budget
    t_edges = time.perf_counter() - t_edges
    for i, (tag, ops, y, Ly, py) in enumerate(timed13):
        n = y.shape[0]
        ms = eager_ms(lambda: berlekamp_massey_long(ops, y), 3)
        nbytes = y.element_size() * (2 * n + 1) + 8  # the sequence in, c and L out
        if i == 0:
            record("berlekamp_massey_long", err13, ms, pms, bound(nbytes))
            form = (f"a chain of {-(-n // 32)} blocks of 32 steps, each one barrier and 32 dependent scalar "
                    f"steps on 32-bit words")
        else:  # d = 0 from step 2 L on: warp 0's single steps, then batches of 32 steps
            form = (f"a chain of at most {2 * Ly} steps on warp 0, each a warp reduction and no barrier, "
                    f"then {-(-(n - 2 * Ly) // 32)} batches of 32 steps")
        print(f"[kernel] {smi} | K13 berlekamp_massey_long {tag} (L = {Ly}): {ms:.3f} ms "
              f"({ms / n * 1e3:.3f} us a step) | plain {py:.1f} ms | bound {bound(nbytes)[0]:.6f} ms (bytes; the "
              f"form: {form})", flush=True)
    print(f"[main] phase 3's K13 block took {time.perf_counter() - t13:.1f} s: the plain scans of path 8's "
          f"sequences on the card {sum(t[4] for t in timed13) / 1e3:.1f} s, the {len(edges) + 3} edge checks "
          f"(prime fields' plain scans on the host) {t_edges:.1f} s", flush=True)
    n = seq.shape[0]

    # K12's shared-memory form at the order of that sequence's minimal LFSR: the FLFSR that
    # berlekamp_massey returns (state: the first L elements reversed, taps: c_1..c_L) regenerates it
    # as main path 8 does; backward, and the Galois form, with the end taps set to 1
    st = seq[:L].flip(0).contiguous()
    tp = c[1 : L + 1].contiguous()
    e, y = k12_check(f"GF(2) order {L}", ops2, st, tp, "fibonacci", "forward", n, 0)
    err = max(err, e)
    if not torch.equal(y, seq):
        raise AssertionError("K12 at the order of the Berlekamp-Massey result does not regenerate the sequence")
    ms = eager_ms(lambda: lfsr_step(ops2, st, tp, n, "fibonacci", "forward"), 3)
    print(f"[kernel] {smi} | K12 lfsr_step GF(2) order {L} (shared memory), {n} ticks: {ms:.3f} ms "
          f"({ms / n * 1e3:.3f} us a tick)", flush=True)
    tp1 = tp.clone()
    tp1[-1].fill_(1)
    err = max(err, k12_check(f"GF(2) order {L}", ops2, st, tp1, "fibonacci", "backward", n, 1)[0])
    for direction in ("forward", "backward"):
        err = max(err, k12_check(f"GF(2) order {L}", ops2, st, tp1.flip(0), "galois", direction, 4096, 1)[0])
    # above the shared memory: the state in the wrapper's global scratch
    k = 20000
    st = F8(rng.integers(0, 256, k), device=dev)._data
    tp = F8(rng.integers(1, 256, k), device=dev)._data
    for kind, end in (("fibonacci", k - 1), ("galois", 0)):
        for direction in ("forward", "backward"):
            err = max(err, k12_check(f"GF(2^8) order {k} (global memory)", ops8, st, tp, kind, direction, 512, hf8.reciprocal(int(tp[end])))[0])
    record("lfsr_step", err, *k12_line[1:])


def bm_sequence():
    """Main path 8's 2^14 random GF(2) elements for berlekamp_massey, which
    phase 3 also holds K13 and K12 against their plain versions on."""
    return np.random.default_rng(14).integers(0, 2, 2**14)


def lfsr_path(gt, dev, timed, smi):
    """Main path 8: GF(2^128) (GCM's field) at 2^24 elements, GF(2^233)
    (B-233's) at 2^22, GF(3^30) on digits at 2^20, LFSRs over GF(2),
    GF(2^8) and GF(2^31 - 1) at 2^18-2^20 ticks, and berlekamp_massey over
    up to 2^14 elements, through the public API on ``dev``. Every check is
    exact. ``timed(call)`` returns (result, ms, launches by wrapper, peak
    device MiB) of one call."""
    from galois_tpu_torch.ops._kernels import get_ops
    from galois_tpu_torch.ops._lfsr_scan import lfsr_step_plain

    t_path = time.perf_counter()
    rng = np.random.default_rng(80)

    def line(label, ms, used, peak, extra=""):
        print(f"[main] {smi} | {label}: {ms:.1f} ms, launches {used}, peak device memory {peak:.0f} MiB{extra}", flush=True)

    def sample(X, idx):
        return ints(X[torch.as_tensor(idx, device=dev)])

    def same(A, B):
        """Equal storage, uint16 limbs compared through int16 views."""
        a, b = A._data, B._data
        if a.dtype == torch.uint16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        return torch.equal(a, b)

    # 1. GF(2^128), GCM's field, at 2^24 elements
    F = gt.GF(2**128, irreducible_poly="x^128 + x^7 + x^2 + x + 1")
    m, f = 128, F._meta.irreducible_poly_int
    n = 2**24
    x = F.Random(n, seed=1, device=dev)
    y = F.Random(n, low=1, seed=2, device=dev)
    idx = np.sort(rng.choice(n, 4096, replace=False))
    xs, ys = sample(x, idx), sample(y, idx)
    z, ms, used, peak = timed(lambda: x * y)
    if sample(z, idx) != [py_clmul_mod(a, b, m, f) for a, b in zip(xs, ys)]:
        raise AssertionError("GF(2^128) x * y disagrees with the Python-int carry-less product")
    line("GF(2^128) x * y, 2^24 elements", ms, used, peak, " | 4096 sampled elements exact")
    z, ms, used, peak = timed(lambda: x * x)
    if sample(z, idx) != [py_clmul_mod(a, a, m, f) for a in xs]:
        raise AssertionError("GF(2^128) x * x disagrees with the Python-int square")
    line("GF(2^128) x * x, 2^24 elements", ms, used, peak, " | 4096 sampled elements exact")
    r, ms, used, peak = timed(lambda: np.reciprocal(y))
    ones = (r * y)._data
    if not (bool((ones[0] == 1).all()) and bool((ones[1:].to(torch.int32) == 0).all())):
        raise AssertionError("GF(2^128) y * y^-1 != 1 somewhere on the card")
    if sample(r, idx[:256]) != [py_inv_mod(b, m, f) for b in ys[:256]]:
        raise AssertionError("GF(2^128) reciprocal disagrees with the Python-int ladder")
    line("GF(2^128) np.reciprocal(y), 2^24 elements", ms, used, peak, " | y * y^-1 == 1 everywhere, 256 samples exact")
    q_, ms, used, peak = timed(lambda: x / y)
    if not same(q_ * y, x):
        raise AssertionError("GF(2^128) (x / y) * y != x on the card")
    line("GF(2^128) x / y, 2^24 elements", ms, used, peak, " | (x / y) * y == x everywhere")
    e = rng.integers(0, 2**63 - 1, n, dtype=np.int64)
    p_, ms, used, peak = timed(lambda: x ** e)
    want = []
    for a, k in zip(xs[:64], e[idx[:64]].tolist()):
        w, b = 1, a
        while k:
            if k & 1:
                w = py_clmul_mod(w, b, m, f)
            b = py_clmul_mod(b, b, m, f)
            k >>= 1
        want.append(w)
    if sample(p_, idx[:64]) != want:
        raise AssertionError("GF(2^128) x ** e disagrees with the Python-int ladder")
    line("GF(2^128) x ** e, int64 exponent array, 2^24 elements", ms, used, peak, " | 64 samples exact")
    s_, ms, used, peak = timed(lambda: np.sqrt(x))
    if not same(s_ * s_, x):
        raise AssertionError("GF(2^128) sqrt(x)^2 != x on the card")
    line("GF(2^128) np.sqrt(x), 2^24 elements", ms, used, peak, " | sqrt(x)^2 == x everywhere")
    del x, y, z, r, ones, q_, p_, s_
    torch.cuda.empty_cache()

    # 2. GF(2^233), NIST B-233's field, at 2^22 (building it factors 2^233 - 1 through the table)
    t0 = time.perf_counter()
    F = gt.GF(2**233, irreducible_poly="x^233 + x^74 + 1")
    print(f"[main] GF(2^233, x^233 + x^74 + 1) built in {time.perf_counter() - t0:.2f} s (host)", flush=True)
    m, f = 233, F._meta.irreducible_poly_int
    n = 2**22
    x = F.Random(n, seed=3, device=dev)
    y = F.Random(n, low=1, seed=4, device=dev)
    idx = np.sort(rng.choice(n, 1024, replace=False))
    xs, ys = sample(x, idx), sample(y, idx)
    z, ms, used, peak = timed(lambda: x * y)
    if sample(z, idx) != [py_clmul_mod(a, b, m, f) for a, b in zip(xs, ys)]:
        raise AssertionError("GF(2^233) x * y disagrees with the Python-int carry-less product")
    line("GF(2^233) x * y, 2^22 elements", ms, used, peak, " | 1024 sampled elements exact")
    r, ms, used, peak = timed(lambda: np.reciprocal(y))
    if sample(r * y, idx) != [1] * len(idx) or sample(r, idx[:64]) != [py_inv_mod(b, m, f) for b in ys[:64]]:
        raise AssertionError("GF(2^233) reciprocal disagrees with the Python-int ladder")
    line("GF(2^233) np.reciprocal(y), 2^22 elements", ms, used, peak, " | y * y^-1 == 1 on 1024 samples, 64 exact")
    del x, y, z, r
    torch.cuda.empty_cache()

    # 3. GF(3^30) on planar digits at 2^20
    F = gt.GF(3**30)
    p, m = 3, 30
    f_asc = [(F._meta.irreducible_poly_int // p**i) % p for i in range(m + 1)]
    n = 2**20
    x = F.Random(n, seed=5, device=dev)
    y = F.Random(n, low=1, seed=6, device=dev)
    idx = np.sort(rng.choice(n, 4096, replace=False))
    xs, ys = np.array(sample(x, idx), dtype=np.int64), np.array(sample(y, idx), dtype=np.int64)
    w = p ** np.arange(m)
    dig_add = lambda a, b, s: ((((a[:, None] // w) % p) + s * ((b[:, None] // w) % p)) % p * w).sum(axis=1)
    for label, call, want in (
        ("x * y", lambda: x * y, lambda: np_gfpm_multiply(xs, ys, p, f_asc)),
        ("x + y", lambda: x + y, lambda: dig_add(xs, ys, 1)),
        ("x - y", lambda: x - y, lambda: dig_add(xs, ys, -1)),
    ):
        z, ms, used, peak = timed(call)
        if sample(z, idx) != want().tolist():
            raise AssertionError(f"GF(3^30) {label} disagrees with the NumPy digit reference")
        line(f"GF(3^30) {label}, 2^20 elements (digits)", ms, used, peak, " | 4096 samples exact")
    z, ms, used, peak = timed(lambda: x / y)
    if sample(z * y, idx) != xs.tolist() or sample(z, idx[:16]) != np_gfpm_multiply(xs[:16], np.array([int(F(int(v)) ** -1) for v in ys[:16]]), p, f_asc).tolist():
        raise AssertionError("GF(3^30) x / y disagrees with the NumPy digit reference")
    line("GF(3^30) x / y, 2^20 elements (digits)", ms, used, peak, " | (x / y) * y == x on 4096 samples")
    del x, y, z
    torch.cuda.empty_cache()

    # 4. FLFSR over GF(2), a primitive feedback polynomial of degree 20
    c = gt.primitive_poly(2, 20)
    state = [int(v) for v in rng.integers(0, 2, 20)]
    state[0] = 1
    L = gt.FLFSR(c.reverse(), state=gt.GF(2)(state, device=dev))
    y, ms, used, peak = timed(lambda: L.step(2**20))
    yd = y._data
    one = gt.FLFSR(c.reverse(), state=gt.GF(2)(state, device=dev))
    one.step(1)
    if int(yd[: 2**20 - 1].sum()) != 2**19 or int(yd[-1]) != int(yd[0]) or not torch.equal(L.state._data, one.state._data):
        raise AssertionError("GF(2) FLFSR of degree 20: not an m-sequence of period 2^20 - 1")
    line("GF(2) FLFSR degree 20, step(2^20)", ms, used, peak, f" | {ms / 2**20 * 1e3:.3f} us a tick, 2^19 ones in a period")
    L.reset()
    L.step(2**20 - 1)
    if not torch.equal(L.state._data, L.initial_state._data):
        raise AssertionError("GF(2) FLFSR: the state after 2^20 - 1 ticks is not the initial state")
    back, ms, used, peak = timed(lambda: L.step(-(2**20 - 1)))
    if not torch.equal(L.state._data, L.initial_state._data):
        raise AssertionError("GF(2) FLFSR: step(-(2^20 - 1)) did not return to the initial state")
    line("GF(2) FLFSR degree 20, step(-(2^20 - 1))", ms, used, peak, " | back to the initial state")
    m_seq = yd

    # 5. GLFSR over GF(2^8) with RS(255,223)'s generator as its characteristic polynomial
    F8 = gt.GF(2**8)
    gen = gt.ReedSolomon(255, 223).generator_poly
    G = gt.GLFSR(gen.reverse(), state=F8(rng.integers(0, 256, 32), device=dev))
    G0 = gt.GLFSR(gen.reverse(), state=G.state)
    y8, ms, used, peak = timed(lambda: G.step(2**20))
    ops = get_ops(F8._meta, F8._mode)
    _, y_plain = lfsr_step_plain(ops, G0.state._data, G0.taps._data, 4096, "galois", "forward")
    if not torch.equal(y8._data[:4096], y_plain):
        raise AssertionError("GF(2^8) GLFSR: the first 4096 outputs differ from the plain tick loop")
    line("GF(2^8) GLFSR (RS(255,223) generator, degree 32), step(2^20)", ms, used, peak, f" | {ms / 2**20 * 1e3:.3f} us a tick, 4096 outputs as the plain loop's")
    Fib = G.to_fibonacci_lfsr()
    if not torch.equal(Fib.step(4096)._data, G.step(4096)._data):
        raise AssertionError("GF(2^8) GLFSR.to_fibonacci_lfsr() does not give the same outputs")
    line("GF(2^8) to_fibonacci_lfsr(), next 4096 outputs", 0.0, {}, 0.0, " | equal")

    # 6. FLFSR over GF(2^31 - 1) of degree 16
    FM = gt.GF(2**31 - 1)
    cm = [1] + [int(v) for v in rng.integers(1, 2**31 - 1, 16)]
    LM = gt.FLFSR(gt.Poly(cm, field=FM).reverse(), state=FM(rng.integers(0, 2**31 - 1, 16), device=dev))
    st0 = ints(LM.state)
    yM, ms, used, peak = timed(lambda: LM.step(2**18))
    pm = 2**31 - 1
    taps = [(-v) % pm for v in cm[1:]]
    s, want = list(st0), []
    for _ in range(256):
        want.append(s[-1])
        s = [sum(a * b for a, b in zip(s, taps)) % pm] + s[:-1]
    if ints(yM[:256]) != want:
        raise AssertionError("GF(2^31-1) FLFSR: the first 256 outputs differ from the Python-int ticks")
    line("GF(2^31-1) FLFSR degree 16, step(2^18)", ms, used, peak, f" | {ms / 2**18 * 1e3:.3f} us a tick, 256 outputs exact")

    # 7. berlekamp_massey (K13): random GF(2) elements, the GLFSR's and the FLFSR's outputs
    F2 = gt.GF(2)
    seq = F2(bm_sequence(), device=dev)
    N = seq.size
    fib, ms, used, peak = timed(lambda: gt.berlekamp_massey(seq, output="fibonacci"))
    # The minimal LFSR has length L and a connection polynomial C of degree d = fib.order <= L: d < L
    # where its coefficient c_L is 0, and then the FLFSR seeded with the first d elements, as the JAX
    # package returns it, does not regenerate them. C's recurrence holds for every t >= L and fails
    # at t = L - 1 (else L - 1 cells would do): its residuals over GF(2) give L, and the FLFSR seeded
    # with the d elements before L (it puts out its seed first) regenerates the rest through K12.
    d = fib.order
    conn = torch.tensor([1] + ints(fib.taps), dtype=torch.float32, device=dev)  # GF(2): taps = c_1..c_d
    win = seq._data.to(torch.float32).unfold(0, d + 1, 1)  # rows s[t - d], ..., s[t] for t = d..N-1
    nz = torch.nonzero((win @ conn.flip(0)).to(torch.int64) & 1).flatten()
    Lc = d + (int(nz[-1]) + 1 if nz.numel() else 0)
    fib.reset(F2(np.asarray(ints(seq[Lc - d : Lc]))[::-1].copy(), device=dev))
    if abs(Lc - 2**13) > 256 or not torch.equal(fib.step(N - Lc + d)._data, seq._data[Lc - d :]):
        raise AssertionError("GF(2) berlekamp_massey over 2^14 random elements: its FLFSR does not regenerate them")
    line(f"GF(2) berlekamp_massey, 2^14 random elements (L = {Lc}, deg C = {d})", ms, used, peak,
         f" | C's recurrence holds from t = L on, fails at L - 1; its FLFSR regenerates the last {N - Lc}")
    for label, F, s_, charp in (
        ("GF(2^8) 8192 GLFSR outputs", F8, y8[:8192], G.characteristic_poly),
        ("GF(2^31-1) 4096 FLFSR outputs", FM, yM[:4096], LM.characteristic_poly),
    ):
        fib, ms, used, peak = timed(lambda: gt.berlekamp_massey(s_, output="fibonacci"))
        if not (charp % fib.characteristic_poly).is_zero or not torch.equal(fib.step(s_.size)._data, s_._data):
            raise AssertionError(f"{label}: berlekamp_massey's LFSR does not divide c(x) or regenerate the outputs")
        line(f"berlekamp_massey, {label} (L = {fib.order})", ms, used, peak, " | divides c(x), regenerates every output")
    del m_seq, y8, yM
    print(f"[main] {smi} | main path 8 took {time.perf_counter() - t_path:.1f} s", flush=True)


def api_path(gt, dev, timed, smi):
    """Main path 9: the rest of the FieldArray API through the public calls
    on ``dev``: element assignment (a 2^24-element GF(2^8) array by a mask,
    a strided slice and 2^20 index positions; Goldilocks at 2^22; GF(3^30)
    digits at 2^20), np.multiply.outer and np.add.outer (4096^2 over
    GF(2^8), GF(2^16), GF(2^31 - 1), 2048^2 over Goldilocks, 1024^2 over
    GF(2^128)), the device reductions of a (4096, 4096) array, the ufunc
    methods that run on the host at 2^16 elements, pickling, the
    python-calculate mode against the device modes, and the element reprs.
    Each result is held against an independent answer: raw torch ops on the
    storage, the card's own elementwise product, or Python ints on samples.
    ``timed(call)`` returns (result, ms, launches by wrapper, peak device
    MiB) of one call."""
    import pickle

    t_path = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(90)
    rng = np.random.default_rng(90)

    def line(label, ms, used, peak, extra=""):
        print(f"[main] {smi} | {label}: {ms:.1f} ms, launches {used}, peak device memory {peak:.0f} MiB{extra}", flush=True)

    def raw(X):
        """A FieldArray's storage; uint16 limbs as int16 (CUDA has no uint16 scatter)."""
        return X._data.view(torch.int16) if X._data.dtype == torch.uint16 else X._data

    def host_mul(F):
        p, m = F.characteristic, F.degree
        if p == 2:
            f = F._meta.irreducible_poly_int
            return lambda a, b: py_clmul_mod(a, b, m, f)
        return lambda a, b: a * b % p

    def host_add(F):
        p = F.characteristic
        return (lambda a, b: a ^ b) if p == 2 else (lambda a, b: (a + b) % p)

    # 1. element assignment: each write against the same write by raw torch ops on a copy of the storage,
    # and a slice taken before the writes keeps its values
    F8, FG, F330 = gt.GF(2**8), gt.GF(GOLDILOCKS), gt.GF(3**30)
    for F, n, tag in ((F8, 2**24, "GF(2^8) 2^24"), (FG, 2**22, "Goldilocks 2^22"), (F330, 2**20, "GF(3^30) digits 2^20")):
        x = F.Random(n, seed=1, device=dev)
        head = x[: 1 << 12]
        head_before = raw(head).clone()
        want = raw(x).clone()
        lead = (slice(None),) * x._storage_ndim()
        mask = torch.rand(n, generator=gen, device=dev) < 0.5
        idx = torch.randperm(n, generator=gen, device=dev)[: 1 << 20]
        vals = F.Random(1 << 20, seed=2, device=dev)
        seven = raw(F(7, device=dev))
        seven = seven.reshape(-1, 1) if lead else seven  # planar words as a column: they broadcast over elements
        writes = (
            ("x[mask] = 7, half-density mask", mask, 7, lambda w: torch.where(mask, seven, w)),
            ("x[::3] = 7", slice(None, None, 3), 7, lambda w: w.index_copy(
                len(lead), torch.arange(0, n, 3, device=dev), seven.expand(*w.shape[:-1], len(range(0, n, 3))))),
            ("x[idx] = values, 2^20 distinct index positions", idx, vals,
             lambda w: w.index_copy(len(lead), idx, raw(vals))),
        )
        for label, index, value, by_torch in writes:
            _, ms, used, peak = timed(lambda: x.__setitem__(index, value))
            want = by_torch(want)
            if not (x.device == dev and torch.equal(raw(x), want)):
                raise AssertionError(f"{tag} {label} disagrees with the same write by raw torch ops")
            line(f"{tag} {label}", ms, used, peak, " | equal to the same write by torch.where / index_copy")
        if not torch.equal(raw(head), head_before):
            raise AssertionError(f"{tag}: a slice taken before the assignments changed")
    print(f"[main] {smi} | assignment: the slices taken before the writes kept their values", flush=True)
    del x, head, want, mask, idx, vals
    torch.cuda.empty_cache()

    # 2. outer products: rows against the card's own broadcast product, samples against Python ints
    F128 = gt.GF(2**128, irreducible_poly="x^128 + x^7 + x^2 + x + 1")
    for F, n, tag in ((F8, 4096, "GF(2^8)"), (gt.GF(2**16), 4096, "GF(2^16)"), (gt.GF(2**31 - 1), 4096, "GF(2^31-1)"),
                      (FG, 2048, "Goldilocks"), (F128, 1024, "GF(2^128)")):
        a = F.Random(n, seed=3, device=dev)
        b = F.Random(n, low=1, seed=4, device=dev)
        rows = torch.as_tensor(np.sort(rng.choice(n, 16, replace=False)), device=dev)
        ii, jj = rng.integers(0, n, 256), rng.integers(0, n, 256)
        av, bv = ints(a), ints(b)
        for ufunc, ref in ((np.multiply, host_mul(F)), (np.add, host_add(F))):
            z, ms, used, peak = timed(lambda: ufunc.outer(a, b))
            if z.shape != (n, n) or z.device != dev:
                raise AssertionError(f"{tag} {ufunc.__name__}.outer: shape {z.shape} on {z.device}")
            for r in rows.tolist():
                if not torch.equal(raw(z[r]), raw(ufunc(a[r], b))):
                    raise AssertionError(f"{tag} {ufunc.__name__}.outer row {r} != a[r] op b on the card")
            got = ints(z[torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev)])
            if got != [ref(av[i], bv[j]) for i, j in zip(ii, jj)]:
                raise AssertionError(f"{tag} {ufunc.__name__}.outer disagrees with Python ints")
            line(f"{tag} np.{ufunc.__name__}.outer, {n} x {n}", ms, used, peak,
                 " | 16 rows equal a[r] op b on the card, 256 samples exact")
        del z
        torch.cuda.empty_cache()
    try:
        np.true_divide.outer(b, a.__class__(torch.zeros_like(a._data[..., :4])))
    except ZeroDivisionError:
        print(f"[main] {smi} | np.true_divide.outer with a zero divisor raised ZeroDivisionError", flush=True)
    else:
        raise AssertionError("np.true_divide.outer with a zero divisor did not raise")

    # 3. the device reductions of a (4096, 4096) array, against .sum and .prod and Python ints
    for F, tag in ((F8, "GF(2^8)"), (gt.GF(2**31 - 1), "GF(2^31-1)")):
        X = F.Random((4096, 4096), low=1, seed=5, device=dev)
        cols = rng.integers(0, 4096, 4)
        for ufunc, method, ref in ((np.add, "sum", host_add(F)), (np.multiply, "prod", host_mul(F))):
            for axis in (0, 1):
                r, ms, used, peak = timed(lambda: ufunc.reduce(X, axis=axis))
                if not torch.equal(raw(r), raw(getattr(X, method)(axis=axis))):
                    raise AssertionError(f"{tag} np.{ufunc.__name__}.reduce axis {axis} != .{method}")
                for c in cols.tolist():
                    line_vals = ints(X[:, c] if axis == 0 else X[c])
                    acc = line_vals[0]
                    for v in line_vals[1:]:
                        acc = ref(acc, v)
                    if int(r[c]) != acc:
                        raise AssertionError(f"{tag} np.{ufunc.__name__}.reduce axis {axis} disagrees with Python ints")
                line(f"{tag} np.{ufunc.__name__}.reduce, (4096, 4096), axis {axis}", ms, used, peak,
                     f" | equal to .{method}, 4 lines exact in Python ints")
        del X, r
        torch.cuda.empty_cache()

    # 4. the ufunc methods that run on the host field, at 2^16 elements of GF(2^31 - 1), against Python ints
    FM = gt.GF(2**31 - 1)
    p = FM.order
    x = FM.Random(2**16, low=1, seed=6, device=dev)
    xv = ints(x)
    inv = lambda v: pow(v, p - 2, p)  # noqa: E731
    prod_rest = 1
    for v in xv[1:]:
        prod_rest = prod_rest * v % p
    at_idx = rng.integers(0, 2**16, 4096)
    for label, call, want in (
        ("np.subtract.reduce", lambda: np.subtract.reduce(x), (xv[0] - sum(xv[1:])) % p),
        ("np.true_divide.reduce", lambda: np.true_divide.reduce(x), xv[0] * inv(prod_rest) % p),
        ("np.multiply.accumulate", lambda: np.multiply.accumulate(x), None),
        ("np.add.reduceat, 256 segments", lambda: np.add.reduceat(x, np.arange(0, 2**16, 256)), None),
        ("np.add.at, 4096 positions", lambda: np.add.at(x, at_idx, FM(1, device=dev)), None),
    ):
        before = list(xv)
        r, ms, used, peak = timed(call)
        if label == "np.multiply.accumulate":
            acc, want = 1, []
            for v in before:
                acc = acc * v % p
                want.append(acc)
            got = ints(r)
        elif label.startswith("np.add.reduceat"):
            want = [sum(before[s : s + 256]) % p for s in range(0, 2**16, 256)]
            got = ints(r)
        elif label.startswith("np.add.at"):
            want = list(before)
            for i in at_idx.tolist():
                want[i] = (want[i] + 1) % p
            got, r = ints(x), x
        else:
            got = int(r)
        if got != want or r.device != dev:
            raise AssertionError(f"GF(2^31-1) {label} disagrees with Python ints or left the card")
        line(f"GF(2^31-1) {label}, 2^16 elements (host field)", ms, used, peak, " | exact in Python ints, result on the card")

    # 5. pickling: a round trip of the card's arrays, back on the card (the default device)
    for F, n, tag in ((F8, 2**24, "GF(2^8) 2^24"), (FG, 2**20, "Goldilocks 2^20")):
        x = F.Random(n, seed=7, device=dev)
        t0 = time.perf_counter()
        data = pickle.dumps(x)
        t1 = time.perf_counter()
        y = pickle.loads(data)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not (type(y) is F and y.device.type == "cuda" and y.dtype == x.dtype and torch.equal(raw(y), raw(x))):
            raise AssertionError(f"{tag} pickle round trip: not equal, not the cached class or not on the card")
        print(f"[main] {smi} | pickle {tag}: {len(data)} bytes, dumps {t1 - t0:.3f} s, loads {t2 - t1:.3f} s"
              " | equal, the cached class, on the card", flush=True)
    del x, y, data

    # 6. python-calculate against the device modes on the card, 4096 elements
    FB = gt.GF(BLS_R)
    for F, tag in ((F8, "GF(2^8)"), (FG, "Goldilocks"), (FB, "BLS12-381 r")):
        x = F.Random(4096, seed=8, device=dev)
        y = F.Random(4096, low=1, seed=9, device=dev)
        e = rng.integers(-(2**62), 2**62, 4096, dtype=np.int64)
        calls = (("x * y", lambda: x * y), ("x / y", lambda: x / y), ("x ** 65537", lambda: x**65537),
                 ("y ** e, int64 exponent array", lambda: y**e), ("np.sqrt(x * x)", lambda: np.sqrt(x * x)))
        modes = ("jit-calculate", "jit-lookup") if F is F8 else ("jit-calculate",)
        try:
            for label, call in calls:
                # BLS12-381 r's jit-calculate np.sqrt is about 2300 launch-bound limb products (21 s at
                # 4096 elements, PERF.md): its python-calculate roots are held against Python ints instead
                skip_device = F is FB and label.startswith("np.sqrt")
                results = {}
                for mode in (() if skip_device else modes) + ("python-calculate",):
                    F.compile(mode)
                    results[mode], ms, used, peak = timed(call)
                    line(f"{tag} {label}, {mode}, 4096 elements", ms, used, peak)
                host = results["python-calculate"]
                if host.device != dev or not all(torch.equal(raw(host), raw(r)) for r in results.values()):
                    raise AssertionError(f"{tag} {label}: python-calculate disagrees with the device modes")
                if skip_device:
                    p = F.order
                    if any(r * r % p != a * a % p or r > p - r for r, a in zip(ints(host), ints(x))):
                        raise AssertionError(f"{tag} {label}: a python-calculate root is not the canonical root")
                    print(f"[main] {smi} | {tag} {label}: r * r == x * x and r <= -r for every root, in Python ints",
                          flush=True)
        finally:
            F.compile("auto")
    coeffs = rng.integers(0, 256, 64).tolist()
    xs = F8.Random(4096, seed=10, device=dev)
    a8, b8 = F8.Random(4096, seed=11, device=dev), F8.Random(4096, seed=12, device=dev)
    results = {}
    try:
        for mode in ("jit-calculate", "python-calculate"):
            F8.compile(mode)
            poly = gt.Poly(coeffs, field=F8)
            ev, ms, used, peak = timed(lambda: poly(xs))
            line(f"GF(2^8) degree-63 Poly evaluation at 4096 points, {mode}", ms, used, peak)
            cv, ms, used, peak = timed(lambda: np.convolve(a8, b8))
            line(f"GF(2^8) np.convolve 4096 x 4096, {mode} (the default mode's device product)", ms, used, peak)
            results[mode] = (ev, cv)
    finally:
        F8.compile("auto")
    (e1, c1), (e2, c2) = results["jit-calculate"], results["python-calculate"]
    if not (e2.device == dev and torch.equal(raw(e1), raw(e2)) and torch.equal(raw(c1), raw(c2))):
        raise AssertionError("GF(2^8) Poly evaluation or np.convolve: python-calculate disagrees with jit-calculate")
    print(f"[main] {smi} | python-calculate: every call equal to the device modes, results on the card", flush=True)

    # 7. reprs: a card array prints as its CPU copy; the tables print
    x = F8.Random(64, seed=13, device=dev)
    xc = F8(x._data.cpu())
    for element_repr in ("poly", "power"):
        with F8.repr(element_repr):
            if str(x) != str(xc) or repr(x) != repr(xc):
                raise AssertionError(f"GF(2^8) {element_repr} repr of a card array differs from its CPU copy's")
    print(f"[main] {smi} | GF(2^8) poly and power reprs of a card array equal its CPU copy's", flush=True)
    print(gt.GF(2**4).repr_table(), flush=True)
    print(gt.GF(3**2).arithmetic_table("*"), flush=True)
    print(f"[main] {smi} | main path 9 took {time.perf_counter() - t_path:.1f} s", flush=True)


def launch_counters():
    """Every kernel wrapper, each with its launch count in ``.launches``."""
    from galois_tpu_torch.ops import _lookup
    from galois_tpu_torch.ops._bm_scan import berlekamp_massey_scan
    from galois_tpu_torch.ops._elementwise import (
        device_probe,
        gf2m_multiply,
        gf2m_multiply_swar,
        gf2m_power,
        goldilocks_multiply,
        m31_multiply,
    )
    from galois_tpu_torch.ops._gf2_linear import gf2_linear
    from galois_tpu_torch.ops._lfsr_scan import berlekamp_massey_long, lfsr_step
    from galois_tpu_torch.ops._limb_binary import gf2_limb_multiply, gf2_limb_power
    from galois_tpu_torch.ops._limb_matmul import goldilocks_combine
    from galois_tpu_torch.ops._plane_matmul import plane_matmul_data_left, plane_matmul_data_right

    return (
        plane_matmul_data_right, plane_matmul_data_left, gf2m_multiply, gf2m_multiply_swar,
        gf2m_power, berlekamp_massey_scan, gf2_linear, goldilocks_combine,
        _lookup.lookup_multiply, _lookup.lookup_divide, _lookup.lookup_reciprocal, _lookup.lookup_log,
        m31_multiply, goldilocks_multiply, device_probe,
        lfsr_step, berlekamp_massey_long, gf2_limb_multiply, gf2_limb_power,
    )


# Main path 10's sizes: the transforms of config 5 (BLS12-381 r and GF(3*2^30+1) at 2^24,
# Goldilocks at 2^22), the NTT metric's batch, main path 4's decodes, dryrun_multichip's step
PARALLEL = {"p": 2**24, "bls": 2**24, "gold": 2**22, "batch": (32, 2**20), "rs": 65536, "bch": 16384,
            "bins": 2**12, "fallback": 8, "step": 65536}
# the kernels each rank of the four-rank run must launch, and the one-rank run
PARALLEL_NEEDED = {
    4: ("plane_matmul_data_right", "plane_matmul_data_left", "gf2m_multiply", "gf2m_multiply_swar", "gf2m_power",
        "berlekamp_massey_scan", "m31_multiply", "goldilocks_multiply", "goldilocks_combine"),
    1: ("plane_matmul_data_right", "plane_matmul_data_left", "gf2m_multiply_swar", "goldilocks_multiply",
        "goldilocks_combine"),
}
PARALLEL_RANKS, PARALLEL_TIMEOUT_S = 4, 600


def parallel_inputs(gt, dev):
    """Main path 10's inputs, made on ``dev`` from seeds, so that every
    process makes the same ones: random field elements; RS(255,223) words
    with 0-16 errors (40 in every 16th row), and a batch with f erasures and
    e errors, 2e + f <= 32, as main path 4's; BCH(511,493) words with 0-2
    bit errors (3-6 in every 16th row); GF(2^8) rows, (256, 64) weights and
    GF(2^31 - 1) rows for dryrun_multichip's step."""
    S = PARALLEL
    F, Fb, Fg = gt.GF(P), gt.GF(BLS_R), gt.GF(GOLDILOCKS)
    inp = {
        "p": F.Random(S["p"], seed=101, device=dev),
        "bls": Fb.Random(S["bls"], seed=102, device=dev),
        "gold": Fg.Random(S["gold"], seed=103, device=dev),
        "batch": F.Random(S["batch"], seed=104, device=dev),
        "bins": Fb.Random(S["bins"], seed=105, device=dev),
        "fallback": F.Random(S["fallback"], seed=106, device=dev),
    }
    from scripts._timing import corrupt, ranks

    gen = torch.Generator(device=dev).manual_seed(107)
    rs, bch = gt.ReedSolomon(255, 223), gt.BCH(511, 493)
    B = S["rs"]
    cw = rs.encode(rs.field.Random((B, rs.k), generator=gen, device=dev))._data
    counts = torch.randint(0, rs.t + 1, (B,), generator=gen, device=dev)
    counts[::16] = 40
    inp["rs"] = rs.field._view(corrupt(cw, ranks(B, rs.n, gen) < counts[:, None], 256, gen))
    cw = rs.encode(rs.field.Random((B, rs.k), generator=gen, device=dev))._data
    f_cnt = torch.randint(0, rs.d, (B,), generator=gen, device=dev)
    e_cnt = (torch.rand(B, generator=gen, device=dev) * ((rs.d - 1 - f_cnt) // 2 + 1)).long()
    rk = ranks(B, rs.n, gen)
    inp["rs_erasures"] = rk < f_cnt[:, None]
    inp["rs_era"] = rs.field._view(corrupt(cw, rk < (f_cnt + e_cnt)[:, None], 256, gen))
    Bb = S["bch"]
    cw = bch.encode(bch.field.Random((Bb, bch.k), generator=gen, device=dev))._data
    counts = torch.randint(0, bch.t + 1, (Bb,), generator=gen, device=dev)
    counts[::16] = torch.randint(bch.t + 1, 7, (Bb // 16,), generator=gen, device=dev)
    inp["bch"] = bch.field._view(corrupt(cw, ranks(Bb, bch.n, gen) < counts[:, None], 2, gen))
    G8, G31 = gt.GF(2**8), gt.GF(M31)
    inp["step_x"] = G8.Random((S["step"], 256), seed=108, device=dev)
    inp["step_w"] = G8.Random((256, 64), seed=109, device=dev)
    inp["step_a"] = G31.Random((S["step"], 128), seed=110, device=dev)
    return inp, rs, bch


def parallel_warmup(inp, rs, bch):
    """One small call of each family path 10 runs, on a rank that has not
    launched anything yet, so that its timed calls do not include a
    kernel's first launch in the process (a library's load, Triton's,
    cuBLAS's handle): 64 words of each decode and 2^10-point transforms
    over the three prime fields (not 2^12, whose plans are the 2^24
    transforms' local plans: their build is timed)."""
    from galois_tpu_torch.ops._ntt import field_fft

    rs.decode(inp["rs"][:64])
    rs.decode(inp["rs_era"][:64], erasures=inp["rs_erasures"][:64])
    bch.decode(inp["bch"][:64])
    for key in ("p", "bls", "gold"):
        field_fft(inp[key][: 2**10])
    torch.cuda.synchronize()


def dist_ms(fn, group):
    """(fn(), ms): CUDA events around one call that starts after a barrier of ``group``."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def parallel_calls(gt, mesh, dev, inp, rs, bch, four):
    """Main path 10's calls on one rank of ``mesh`` (mesh dim "x"): the
    sharded NTTs (each plan built first and timed apart), the batched NTT,
    the three decodes; with ``four``, also the inverse round trips, the
    D^2-not-dividing-N fallback (which must warn) and dryrun_multichip's
    data-parallel step on this rank's rows. Returns (this rank's results,
    {call: (ms, plan or decoder build s, or None)})."""
    import warnings

    from galois_tpu_torch.ops import _ntt
    from galois_tpu_torch.ops._kernels import kernel_mode
    from galois_tpu_torch.parallel import _fec_sharded, _ntt_sharded, sharded_batched_fft, sharded_decode, sharded_fft

    group = mesh.get_group("x")
    D, r = group.size(), mesh.get_local_rank("x")
    out, times = {}, {}
    for key, label in (("p", "GF(3*2^30+1)"), ("bls", "BLS12-381 r"), ("gold", "Goldilocks")):
        x = inp[key]
        F, N = type(x), x.shape[-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = _ntt_sharded._sharded_plan(F._meta, N, _ntt._get_omega(F, N), kernel_mode(F), mesh, "x")
        plan._build_twiddle()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        out[key], ms = dist_ms(lambda: sharded_fft(F, x, mesh, "x"), group)
        times[f"sharded_fft {label} N=2^{N.bit_length() - 1} ({plan.N1} x {plan.N2})"] = (ms, build_s)
    x = inp["bins"]
    out["bins"] = sharded_fft(type(x), x, mesh, "x")
    x = inp["batch"]
    F = type(x)
    t0 = time.perf_counter()
    _ntt._plan(F._meta, x.shape[-1], _ntt._get_omega(F, x.shape[-1]), kernel_mode(F), dev)
    build_s = time.perf_counter() - t0
    out["batch"], ms = dist_ms(lambda: sharded_batched_fft(F, x, mesh, "x"), group)
    times[f"sharded_batched_fft GF(3*2^30+1) {tuple(x.shape)}"] = (ms, build_s)
    for key, code, label, kw in (
        ("rs", rs, "RS(255,223)", {}),
        ("rs_era", rs, "RS(255,223) with erasures", {"erasures": inp["rs_erasures"]}),
        ("bch", bch, "BCH(511,493)", {}),
    ):
        x = inp[key]
        t0 = time.perf_counter()
        _fec_sharded._raw_decoder(code, code.n, "erasures" in kw)[1].consts(dev)
        build_s = time.perf_counter() - t0
        out[key], ms = dist_ms(lambda: sharded_decode(code, x, mesh, "x", **kw), group)
        times[f"sharded_decode {label}, B={x.shape[0]} ({x.shape[0] // D} a rank)"] = (ms, build_s)
    if four:
        for key in ("p", "bls", "gold"):
            F = type(inp[key])
            whole = gather_shards(out[key]._data, group, D, 1 if F._meta.storage_first else 0)
            out[key + "_inverse"], ms = dist_ms(lambda: sharded_fft(F, F._view(whole), mesh, "x", inverse=True), group)
            del whole
            times[f"sharded_fft {key} inverse (its plan built in the call)"] = (ms, None)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            x = inp["fallback"]
            out["fallback"] = sharded_fft(type(x), x, mesh, "x")
        if not any(issubclass(w.category, RuntimeWarning) and "REPLICATED" in str(w.message) for w in caught):
            raise AssertionError(f"the fallback at N = {x.shape[0]} over {D} ranks did not warn")
        b = PARALLEL["step"] // D
        rows = slice(r * b, (r + 1) * b)

        def step():
            h = inp["step_x"][rows] @ inp["step_w"]
            a = inp["step_a"][rows]
            return h * h + h, a * a + a

        (out["step_h"], out["step_g"]), ms = dist_ms(step, group)
        times[f"dryrun_multichip's step, {b} rows a rank"] = (ms, None)
    return out, times


def gather_shards(shard, group, D, dim):
    """The whole of a tensor sharded along ``dim``, by all_gather in rank order."""
    from galois_tpu_torch.parallel._mesh import all_gather

    whole = all_gather(shard, group, D).movedim(0, dim)
    return whole.reshape(tuple(shard.shape[:dim]) + (D * shard.shape[dim],) + tuple(shard.shape[dim + 1 :]))


def parallel_split(mesh, inp):
    """The parts of one sharded NTT on this rank at each field's plan (built
    by parallel_calls), each by CUDA events after a barrier: {field: (the
    three transposes' ms, the local DFTs' ms (size N2, then N1), the twiddle
    multiply's ms)}."""
    from galois_tpu_torch.ops import _ntt
    from galois_tpu_torch.ops._kernels import kernel_mode
    from galois_tpu_torch.parallel import _ntt_sharded

    group = mesh.get_group("x")
    parts = {}
    for key in ("p", "bls", "gold"):
        x = inp[key]
        F, N = type(x), x.shape[-1]
        plan = _ntt_sharded._sharded_plan(F._meta, N, _ntt._get_omega(F, N), kernel_mode(F), mesh, "x")
        D, lead = plan.D, 1 if F._meta.storage_first else 0
        head = tuple(x._data.shape[:lead])
        a = torch.zeros(head + (plan.N2 // D, plan.N1), dtype=x._data.dtype, device=x.device)
        b = torch.zeros(head + (plan.N1 // D, plan.N2), dtype=x._data.dtype, device=x.device)
        t = [dist_ms(lambda: _ntt_sharded._transpose(m, D, group, lead), group)[1] for m in (a, b, a)]
        d2 = dist_ms(lambda: plan.plan2.transform(b), group)[1]
        tw = dist_ms(lambda: _ntt._multiply_chunked(plan.ops, b, plan._build_twiddle()), group)[1]
        d1 = dist_ms(lambda: plan.plan1.transform(a), group)[1]
        parts[key] = (t, (d2, d1), tw)
        del a, b
    return parts


def split_text(key, ranks_parts):
    """One line of parallel_split's parts for ``key``, rank by rank."""
    def each(fn):
        return ", ".join(f"{fn(p[key]):.1f}" for p in ranks_parts)

    return (f"{key}'s NTT split, ms by rank: transposes [{each(lambda v: sum(v[0]))}] (the three: "
            f"{', '.join('/'.join(f'{t:.1f}' for t in p[key][0]) for p in ranks_parts)}), local DFTs "
            f"[{each(lambda v: sum(v[1]))}], twiddle [{each(lambda v: v[2])}]")


def times_text(label, ranks_times):
    """One line of parallel_calls' times for ``label``, rank by rank."""
    ms = ", ".join(f"{t[label][0]:.1f}" for t in ranks_times)
    build = ranks_times[0][label][1]
    return f"{label}: ms by rank [{ms}]" + ("" if build is None else f", plan or decoder build {build:.2f} s (rank 0)")


def parallel_refs(gt, inp, rs, bch):
    """The single-device port's results for main path 10's inputs, on the card."""
    from galois_tpu_torch.ops._ntt import field_fft

    refs = {key: field_fft(inp[key])._data for key in ("p", "bls", "gold", "batch", "bins", "fallback")}
    for key, code, kw in (("rs", rs, {}), ("rs_era", rs, {"erasures": inp["rs_erasures"]}), ("bch", bch, {})):
        dec, nerr = code.decode(inp[key], output="codeword", errors=True, **kw)
        refs[key], refs[key + "_nerr"] = dec._data, torch.from_numpy(nerr).to(dec.device)
    h = inp["step_x"] @ inp["step_w"]
    a = inp["step_a"]
    refs["step_h"], refs["step_g"] = (h * h + h)._data, (a * a + a)._data
    return refs


def parallel_check(out, refs, inp, group, D):
    """Gathers every result of parallel_calls (on every rank) and, where
    ``refs`` is given, holds it for exact equality against the single-device
    port, the inverse round trips against the inputs and 16 bins of the
    BLS12-381 r transform at 2^12 against a direct DFT in Python ints.
    Returns the names checked."""
    checked, bins = [], None
    for key, res in out.items():
        if isinstance(res, tuple):  # sharded_decode: (words, n_errors)
            got = {key: gather_shards(res[0]._data, group, D, 0), key + "_nerr": gather_shards(res[1], group, D, 0)}
        else:
            got = {key: gather_shards(res._data, group, D, 1 if type(res)._meta.storage_first else 0)}
        if refs is None:
            continue
        for k, v in got.items():
            want = inp[k[: -len("_inverse")]]._data if k.endswith("_inverse") else refs[k]
            if v.shape != want.shape or not torch.equal(v, want):
                raise AssertionError(f"main path 10: {k} over {D} ranks differs from the single-device port")
            checked.append(k)
        if key == "bins":
            bins = type(res)._view(got[key])
    if refs is not None:
        N, p = PARALLEL["bins"], BLS_R
        xs, Xs = ints(inp["bins"]), ints(bins)
        omega = pow(int(type(bins).primitive_element), (p - 1) // N, p)
        for k in [0, 1, 2, 3, 5, N // 2, N - 1] + [int(k) for k in np.random.default_rng(10).integers(0, N, 9)]:
            wk, acc = pow(omega, k, p), 0
            for v in reversed(xs):  # Horner in omega^k
                acc = (acc * wk + v) % p
            if Xs[k] != acc:
                raise AssertionError(f"main path 10: BLS12-381 r bin {k} over {D} ranks disagrees with the direct DFT")
        checked.append("16 BLS12-381 r bins against Python ints")
    return checked


def parallel_rank(rank, world, store_path, ref_path, queue):
    """One of main path 10's gloo ranks on the one card, spawned: its
    inputs, a warm-up, its calls with every launch count set to 0 first, the counts,
    the parts of its NTTs, and the gathers (rank 0 also holds the results
    against the references at ``ref_path``). Puts one dict on ``queue``."""
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    msg = {"rank": rank}
    try:
        import galois_tpu_torch as gt

        counters = launch_counters()
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
        dev = torch.device("cuda", 0)  # the one card, shared by every rank
        torch.cuda.set_device(dev)
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("x",))
        inp, rs, bch = parallel_inputs(gt, dev)
        parallel_warmup(inp, rs, bch)
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out, msg["times"] = parallel_calls(gt, mesh, dev, inp, rs, bch, four=True)
        msg["counts"] = {fn.__name__: fn.launches for fn in counters}
        msg["peak"] = torch.cuda.max_memory_allocated() / 2**30
        msg["parts"] = parallel_split(mesh, inp)
        refs = None
        if rank == 0:
            refs = {k: v.view(torch.uint16) if v.dtype == torch.int16 else v
                    for k, v in torch.load(ref_path, map_location=dev).items()}
        msg["checked"] = parallel_check(out, refs, inp, mesh.get_group("x"), world)
        dist.barrier()
    except Exception:  # the parent prints it and fails the path
        msg["error"] = traceback.format_exc()
    finally:
        queue.put(msg)
        if dist.is_initialized():
            dist.destroy_process_group()


def parallel_path(gt, dev, smi, counters, read_counts):
    """Main path 10: parallel/ on torch.distributed, the counterpart of the
    JAX package's dryrun_multichip at real sizes. (a) NCCL at one rank in
    this process: the sharded NTTs, the batched NTT and the decodes, with
    the launch counts set to 0 first and read after; each result against the
    single-device port. (b) PARALLEL_RANKS gloo ranks spawned on the same
    card, with the same calls and sizes, the inverse round trips, the
    fallback and dryrun_multichip's step; each rank's counts must show every
    kernel of PARALLEL_NEEDED[4], and rank 0 holds every gathered result
    against the references (a) saved. The ranks of (b) time-share one card:
    their times are no scaling figure."""
    import multiprocessing
    import os
    import queue as queue_mod
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from galois_tpu_torch.ops import _ntt
    from galois_tpu_torch.parallel import _ntt_sharded

    t_path = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        # (a) NCCL, one rank
        torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(tmp, "nccl"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("x",))
            inp, rs, bch = parallel_inputs(gt, dev)
            for fn in counters:
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out, times = parallel_calls(gt, mesh, dev, inp, rs, bch, four=False)
            peak = torch.cuda.max_memory_allocated() / 2**30
            read_counts(10, [fn for fn in counters if fn.__name__ in PARALLEL_NEEDED[1]])
            parts = parallel_split(mesh, inp)
            refs = parallel_refs(gt, inp, rs, bch)
            checked = parallel_check(out, refs, inp, mesh.get_group("x"), 1)
        finally:
            dist.destroy_process_group()
        texts = [times_text(label, [times]) for label in times] + [split_text(key, [parts]) for key in parts]
        for text in texts:
            print(f"[main] {smi} | path 10 (a), NCCL, 1 rank: {text}", flush=True)
        print(f"[main] {smi} | path 10 (a): peak device memory {peak:.2f} GiB; equal to the single-device port: "
              f"{', '.join(checked)}", flush=True)
        ref_path = os.path.join(tmp, "refs.pt")
        t0 = time.perf_counter()
        # uint16 limbs as int16, which every torch build saves and loads
        torch.save({k: (v.view(torch.int16) if v.dtype == torch.uint16 else v).cpu() for k, v in refs.items()}, ref_path)
        print(f"[main] {smi} | path 10: references saved for (b) in {time.perf_counter() - t0:.1f} s", flush=True)
        del inp, out, refs
        _ntt._plan.cache_clear()
        _ntt_sharded._sharded_plan.cache_clear()
        _ntt_sharded._replicated_fallback_fn.cache_clear()
        torch.cuda.empty_cache()

        # (b) PARALLEL_RANKS gloo ranks on the one card
        ctx = multiprocessing.get_context("spawn")
        q = ctx.Queue()
        procs = [
            ctx.Process(target=parallel_rank, args=(r, PARALLEL_RANKS, os.path.join(tmp, "gloo"), ref_path, q))
            for r in range(PARALLEL_RANKS)
        ]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        msgs = {}
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        try:
            while len(msgs) < PARALLEL_RANKS:
                m = q.get(timeout=max(deadline - time.monotonic(), 1))
                msgs[m["rank"]] = m
        except queue_mod.Empty:
            raise AssertionError(f"main path 10 (b): only ranks {sorted(msgs)} reported within {PARALLEL_TIMEOUT_S} s")
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        wall_b = time.perf_counter() - t0
        for r in range(PARALLEL_RANKS):
            if "error" in msgs[r]:
                raise AssertionError(f"main path 10 (b), rank {r}:\n{msgs[r]['error']}")
        ms = [msgs[r] for r in range(PARALLEL_RANKS)]
        head = f"[main] {smi} | path 10 (b), gloo, {PARALLEL_RANKS} ranks time-sharing one card (no scaling figure)"
        texts = [times_text(label, [m["times"] for m in ms]) for label in ms[0]["times"]]
        texts += [split_text(key, [m["parts"] for m in ms]) for key in ms[0]["parts"]]
        for text in texts:
            print(f"{head}: {text}", flush=True)
        for r, m in enumerate(ms):
            print(f"{head}: rank {r}: peak device memory {m['peak']:.2f} GiB | launches {dict((k, v) for k, v in m['counts'].items() if v)}", flush=True)
            missing = [k for k in PARALLEL_NEEDED[PARALLEL_RANKS] if not m["counts"][k]]
            if missing:
                raise AssertionError(f"main path 10 (b): rank {r} never launched {missing}")
        print(f"[main] {smi} | path 10 (b): {wall_b:.1f} s for {PARALLEL_RANKS} spawned ranks, their start included; "
              f"rank 0's gathers equal to the single-device port: {', '.join(msgs[0]['checked'])}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[main] {smi} | main path 10 took {time.perf_counter() - t_path:.1f} s", flush=True)


# Main path 11's sizes: the elementwise calls and the methods at 2^24, PLU at 32 x 32 (the host route
# eagerly, the device route under capture, as in the JAX package's jit test)
CAPTURE_N, CAPTURE_PLU_N = 2**24, 32
F128_POLY = "x^128 + x^7 + x^2 + x + 1"


def jax_random_ints(order, low, high, n, seed):
    """The JAX package's ``Random`` draw (galois_tpu/fields/_array.py:457-470),
    written out here, since the card has no JAX: int64 draws of
    ``np.random.default_rng(seed)`` up to order 2^63, else one
    ``rng.integers(0, 2^62)`` an element, scaled into [low, high) in Python ints."""
    rng = np.random.default_rng(seed)
    if order <= 2**63:
        return rng.integers(low, high, size=n, dtype=np.int64)
    flat = np.empty(n, dtype=object)
    for i in range(n):
        flat[i] = low + int(rng.integers(0, 2**62)) * (high - low) // 2**62
    return flat


def capture_path(gt, dev, smi):
    """Main path 11: the public calls that the JAX package runs under jax.jit,
    captured in a CUDA graph (torch.cuda.graph) and replayed: a * b + a,
    a / b, a ** 3 and np.reciprocal at 2^24 over GF(2^8) (K8, K8-A),
    lookup-mode GF(2^16) (K3-K5), GF(2^31 - 1) (K9), Goldilocks (K10),
    GF(2^128) (K14) and GF(3^5); field_trace, field_norm, vector,
    additive_order, multiplicative_order, log, plu_decompose, is_square and
    sqrt over GF(2^8), GF(31), GF(3^5) and Goldilocks. Each call runs once
    eagerly, then is captured with torch.cuda.set_sync_debug_mode("error"),
    so that a read-back during the capture raises; its replay must equal
    the eager result exactly (log, the orders and is_square return their
    device tensors under capture, as the JAX package returns device arrays
    under jit), and where the JAX package raises under jit (the limb
    field's vector, multiplicative_order and host log, additive_order of a
    characteristic above 2^63) the capture must raise NotImplementedError.
    Each line gives eager ms and replay ms per call (CUDA events): the host
    time a graph removes (and, where the eager call returns a host array,
    the copy to the host). Then the repaired
    API on the card: polynomial-string elements (the constructor, lists,
    assignment), Random(seed=...) against the JAX package's draw written
    out (jax_random_ints) over int, limb and digit fields, and <, <=, >, >=
    and mask indexing at 2^24 over GF(2^31 - 1), Goldilocks, BLS12-381 r
    and GF(3^30) against numpy on the host."""
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(110)

    def line(text):
        print(f"[main] {smi} | {text}", flush=True)

    def same(out, eager):
        if isinstance(eager, tuple):
            return len(out) == len(eager) and all(same(o, e) for o, e in zip(out, eager))
        if isinstance(out, torch.Tensor):  # a device result where the eager call gives a host one
            host = out.cpu().numpy()
            return host.dtype == np.asarray(eager).dtype and np.array_equal(host, eager)
        return type(out) is type(eager) and out._data.dtype == eager._data.dtype and torch.equal(out._data, eager._data)

    def replayed(tag, fn, raises=None):
        """Eager call, capture with host syncs an error, replay; the replay
        against the eager result; eager and replay ms per call."""
        t0 = time.perf_counter()
        eager = None if raises else fn()
        torch.cuda.synchronize()
        reps = max(1, min(50, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        except NotImplementedError as e:
            if raises is None:
                raise
            line(f"{tag}: the capture raises NotImplementedError, as jax.jit does ({e})")
            return
        if raises:
            raise AssertionError(f"{tag}: the capture should raise NotImplementedError, as jax.jit does")
        graph.replay()
        torch.cuda.synchronize()
        if not same(out, eager):
            raise AssertionError(f"{tag}: the replay differs from the eager call")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        e_ms = start.elapsed_time(end) / reps
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        r_ms = start.elapsed_time(end) / reps
        line(f"{tag}: replay equals the eager call; eager {e_ms:.4f} ms, replay {r_ms:.4f} ms per call "
             f"({reps} each): {e_ms - r_ms:.4f} ms a call of host time")
        del graph, out, eager

    # (a) arithmetic at 2^24
    n = CAPTURE_N
    F16 = gt.GF(2**16)
    fields = [
        ("GF(2^8)", gt.GF(2**8)), ("GF(2^16) lookup", F16), ("GF(2^31-1)", gt.GF(M31)),
        ("Goldilocks", gt.GF(GOLDILOCKS)), ("GF(2^128)", gt.GF(2**128, irreducible_poly=F128_POLY)),
        ("GF(3^5)", gt.GF(3**5)),
    ]
    F16.compile("jit-lookup")
    try:
        for tag, F in fields:
            a = F.Random(n, generator=gen, device=dev)
            b = F.Random(n, low=1, generator=gen, device=dev)
            for op, fn in (("a * b + a", lambda: a * b + a), ("a / b", lambda: a / b), ("a ** 3", lambda: a**3),
                           ("np.reciprocal(b)", lambda: np.reciprocal(b))):
                replayed(f"captured {tag} {op}, 2^24", fn)
            del a, b
            torch.cuda.empty_cache()
    finally:
        F16.compile("auto")

    # the nine methods of the JAX package's jit tests
    for tag, F in (("GF(2^8)", gt.GF(2**8)), ("GF(31)", gt.GF(31)), ("GF(3^5)", gt.GF(3**5)),
                   ("Goldilocks", gt.GF(GOLDILOCKS))):
        x = F.Random(n, low=1, generator=gen, device=dev)
        sq = x * x
        m = CAPTURE_PLU_N
        mat = x[: m * m].reshape(m, m)
        # where jax.jit raises: a prime field on limbs (vector), limb storage (the order, the host log), a
        # characteristic above 2^63 (additive_order)
        limbs, wide = F._meta.storage != "int", F.characteristic > 2**63 - 1
        methods = [
            ("field_trace", lambda: x.field_trace(), None), ("field_norm", lambda: x.field_norm(), None),
            ("vector", lambda: x.vector(), limbs), ("additive_order", lambda: x.additive_order(), wide),
            ("multiplicative_order", lambda: x.multiplicative_order(), limbs), ("log", lambda: x.log(), limbs),
            (f"plu_decompose {m} x {m}", lambda: mat.plu_decompose(), None),
            ("is_square", lambda: sq.is_square(), None), ("sqrt", lambda: sq.sqrt(), None),
        ]
        for name, fn, raises in methods:
            replayed(f"captured {tag} {name}" + ("" if name.startswith("plu") else ", 2^24"), fn, raises)
        del x, sq, mat
        torch.cuda.empty_cache()

    # (b) polynomial strings
    F8, F3 = gt.GF(2**3), gt.GF(3**5)
    checks = [
        (int(F8("x^2 + 1", device=dev)), 5), (int(F8("α^2 + α", device=dev)), 6),
        (int(gt.GF(2**8)("α", device=dev)), int(gt.GF(2**8).primitive_element)),
        (np.asarray(F3(["2x^4 + x + 1", 7, "x^2"], device=dev)).tolist(), [2 * 81 + 3 + 1, 7, 9]),
    ]
    x = gt.GF(2**8).Random(n, seed=111, device=dev)
    x[5] = "x^7 + x"
    x[[1, 2]] = ["x + 1", 9]
    checks.append((np.asarray(x[:6]).tolist()[1:3] + [int(x[5])], [3, 9, 130]))
    for got, want in checks:
        if got != want:
            raise AssertionError(f"polynomial strings on the card: {got} != {want}")
    line(f"polynomial-string elements on the card: {len(checks)} checks pass")

    # (b) Random(seed=...) against the JAX package's draw
    for tag, F, count, low in (("GF(2^8)", gt.GF(2**8), n, 0), ("GF(3^30) digits", gt.GF(3**30), 2**20, 1),
                               ("Goldilocks", gt.GF(GOLDILOCKS), 2**20, 0), ("BLS12-381 r", gt.GF(BLS_R), 2**16, 5),
                               ("GF(2^128)", gt.GF(2**128, irreducible_poly=F128_POLY), 2**16, 0)):
        t0 = time.perf_counter()
        got = F.Random(count, low=low, seed=112, device=dev)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        want = jax_random_ints(F.order, low, F.order, count, 112)
        if got.device != dev or not np.array_equal(np.asarray(got, dtype=object), want.astype(object)):
            raise AssertionError(f"{tag} Random(seed=112) differs from the JAX package's draw")
        line(f"{tag} Random({count}, low={low}, seed=112) on the card equals the JAX package's draw "
             f"(numpy, written out); {draw_s * 1e3:.1f} ms")

    # (b) ordering comparisons at 2^24 against numpy
    def host_keys(F, data):
        """Int reprs on the host in a form numpy orders: int64, uint64 (Goldilocks) or big-endian bytes."""
        h = data.cpu().numpy()
        if F._meta.storage == "int":
            return h.astype(np.int64)
        if F._meta.storage == "digits":
            acc = np.zeros(h.shape[1:], dtype=np.int64)
            for k in reversed(range(h.shape[0])):
                acc = acc * F.characteristic + h[k]
            return acc
        if h.shape[0] <= 4:
            acc = np.zeros(h.shape[1:], dtype=np.uint64)
            for k in range(h.shape[0]):
                acc |= h[k].astype(np.uint64) << np.uint64(16 * k)
            return acc
        return np.ascontiguousarray(h[::-1].T).astype(">u2").view(f"S{2 * h.shape[0]}").reshape(-1)

    ops = (("<", operator.lt, np.less), ("<=", operator.le, np.less_equal), (">", operator.gt, np.greater),
           (">=", operator.ge, np.greater_equal))
    for tag, F in (("GF(2^31-1)", gt.GF(M31)), ("Goldilocks", gt.GF(GOLDILOCKS)), ("BLS12-381 r", gt.GF(BLS_R)),
                   ("GF(3^30) digits", gt.GF(3**30))):
        a = F.Random(n, generator=gen, device=dev)
        r = F.Random(n, generator=gen, device=dev)._data.to(torch.int64)
        pick = torch.randint(0, 4, (n,), generator=gen, device=dev)
        a64 = a._data.to(torch.int64)
        if a._storage_ndim():  # equal top words a quarter of the time: the lowest word decides
            low_word = torch.minimum(a64[0], r[0])
            b64 = torch.where(pick == 0, a64, torch.where(pick == 1, torch.cat([low_word[None], a64[1:]]), r))
        else:
            b64 = torch.where(pick == 0, a64, torch.where(pick == 1, torch.minimum(a64, r), r))
        b = F(b64.to(F._meta.torch_dtype))
        ka, kb = host_keys(F, a._data), host_keys(F, b._data)
        for sym, op, np_op in ops:
            t0 = time.perf_counter()
            got = op(a, b)
            ms = (time.perf_counter() - t0) * 1e3
            if got.dtype != np.bool_ or not np.array_equal(got, np_op(ka, kb)):
                raise AssertionError(f"{tag} a {sym} b differs from numpy")
            line(f"{tag} a {sym} b at 2^24: equals numpy on the host; {ms:.1f} ms a call (the bools' copy to the host included)")
        pivot = a[12345]
        sel = a[a > pivot]
        want = ka[ka > ka[12345]]
        if sel.shape != want.shape or not np.array_equal(host_keys(F, sel._data), want):
            raise AssertionError(f"{tag} a[a > a[12345]] differs from numpy")
        if not np.array_equal(a <= pivot, ka <= ka[12345]):
            raise AssertionError(f"{tag} a <= a[12345] (a 0-D operand) differs from numpy")
        line(f"{tag} a[a > a[12345]] ({sel.shape[0]} elements) and a <= a[12345] equal numpy")
        del a, b, r, pick, a64, b64, sel
        torch.cuda.empty_cache()
    line(f"main path 11 took {time.perf_counter() - t_path:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available.", file=sys.stderr)
        return 1

    import galois_tpu_torch as gt
    from galois_tpu_torch import _build
    from scripts._timing import card, corrupt, graph_ms, ranks
    from scripts._timing import eager_ms as cuda_ms
    from galois_tpu_torch.codes._decoder import make_decoder
    from galois_tpu_torch.ops import _elementwise, _lookup
    from galois_tpu_torch.ops._bm_scan import berlekamp_massey_scan, berlekamp_massey_scan_plain
    from galois_tpu_torch.ops._binary_matmul import binary_matmul
    from galois_tpu_torch.ops._gf2_linear import gf2_linear, gf2_linear_plain
    from galois_tpu_torch.ops import _limb_matmul
    from galois_tpu_torch.ops._limb_matmul import goldilocks_combine, goldilocks_combine_plain
    from galois_tpu_torch.ops._elementwise import (
        device_probe,
        device_probe_plain,
        gf2m_multiply,
        gf2m_multiply_plain,
        gf2m_multiply_swar,
        gf2m_multiply_swar_plain,
        gf2m_power,
        gf2m_power_plain,
        goldilocks_multiply,
        goldilocks_multiply_plain,
        m31_multiply,
        m31_multiply_plain,
    )
    from galois_tpu_torch.ops._kernels import get_ops
    from galois_tpu_torch.ops._lfsr_scan import berlekamp_massey_long, lfsr_step
    from galois_tpu_torch.ops._limb_binary import gf2_limb_multiply, gf2_limb_power
    from galois_tpu_torch.ops._linalg import balanced_plane_count, balanced_planes_np
    from galois_tpu_torch.ops._plane_matmul import (
        KMajorPlanes,
        kmajor_planes,
        plane_digits,
        plane_digits_plain,
        plane_matmul_data_left,
        plane_matmul_data_left_plain,
        plane_matmul_data_right,
        plane_matmul_data_right_plain,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = card()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    global INT32_OPS_PER_S, SMEM_WAVEFRONTS_PER_S
    INT32_OPS_PER_S = SMS * INT32_LANES * sm_mhz * 1e6
    SMEM_WAVEFRONTS_PER_S = SMS * sm_mhz * 1e6
    print(
        f"[device] {smi} | max SM clock {sm_mhz:.0f} MHz, int32 rate {INT32_OPS_PER_S / 1e12:.2f} Tops/s | "
        f"torch {torch.__version__} cuda {torch.version.cuda}",
        flush=True,
    )

    # -- 2. build ------------------------------------------------------
    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    sources = (
        "plane_matmul", "lookup", "prime_mul", "probe", "gf2m_swar", "gf2m_chain", "gf2_limb", "lfsr", "gf2_linear",
        "gold_combine",
    )
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        secs = dict(zip(sources, pool.map(build, sources)))
    print(f"[build] nvcc, {len(sources)} sources at once: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sources:
        print(f"[build] {name}.cu: {secs[name]:.1f} s")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning", "setmaxnreg", "wgmma")):
                print(f"[build]   {line.strip()}")

    report = {}

    def record(name, err, ms=None, plain_ms=None, bnd=None, library_ms=None):
        r = report.setdefault(name, {"max_abs_err": 0, "ms": None, "plain_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms
            r["bound_ms"], r["bound_by"] = bnd
            # one PyTorch call that computes the same function, where there is one
            r["library_ms"] = library_ms

    launches = {}

    # K11 first: a broken toolchain or CUDA runtime shows here, apart from any kernel's own fault
    device_probe.launches = 0
    block = torch.zeros((8, 1024), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    got = device_probe(block)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches["device_probe"] = device_probe.launches
    err = max_abs_err(got, device_probe_plain(block))
    if device_probe.launches != 1 or err or int(got.min()) != 1 or int(got.max()) != 1:
        raise AssertionError(f"K11 device_probe failed: launches {device_probe.launches}, max_abs_err {err}")
    # K11 and torch.add on equal footing: by CUDA-graph replay (device time) and by eager calls
    # (launch latency); the replay times go into the report
    ms = graph_ms(lambda: device_probe(block), 200)
    eager = cuda_ms(lambda: device_probe(block), 200)
    pms = cuda_ms(lambda: device_probe_plain(block), 200)
    lib = graph_ms(lambda: torch.add(block, 1), 200)
    lib_eager = cuda_ms(lambda: torch.add(block, 1), 200)
    # the launch floor: an empty kernel (torch.cuda._sleep spins for 0 cycles), by graph replay
    empty = graph_ms(lambda: torch.cuda._sleep(0), 200)
    record("device_probe", err, ms, pms, bound(2 * 4 * block.numel()), lib)
    print(
        f"[build] K11 device_probe (8, 1024) int32: every element 1, max_abs_err {err} | first launch "
        f"{first_s * 1e3:.3f} ms host wall | kernel {ms:.4f} ms by graph replay, {eager:.4f} ms per eager call "
        f"(CUDA events) | torch.add(block, 1) {lib:.4f} ms by graph replay, {lib_eager:.4f} ms per eager call | "
        f"an empty kernel (launch floor) {empty:.4f} ms by graph replay | plain x + 1 {pms:.4f} ms",
        flush=True,
    )
    GF8 = gt.GF(2**8)
    f8 = GF8._meta.irreducible_poly_int
    t0 = time.perf_counter()
    probe = torch.arange(256, dtype=torch.uint8, device=dev)
    gf2m_multiply(probe, probe, 8, f8)
    torch.cuda.synchronize()
    print(f"[build] triton gf2m_multiply (first launch): {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    a8 = torch.randint(0, 256, (2**24,), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
    b8 = torch.randint(0, 256, (2**24,), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
    # K8: every m = 2..8 on every layout kind (whole tensors with a ragged
    # tail, a view one element in, one element, a row and a column
    # broadcast, the three-axis outer product, an inner axis below 16, four
    # axes, which the wrapper materializes); GF(2^8) at 2^24 and at the RS
    # decoder's own launches (B = 65536): the outer product of conv_trunc,
    # the derivative's and Forney's products
    B_k8 = 65536
    k8_main = {  # (a, b, b's LOG read twice a run of 16: the operand constant along the inner axis)
        "outer product (65536, 1, 33) x (65536, 32, 1)":
            (a8[: B_k8 * 33].reshape(B_k8, 1, 33), b8[: B_k8 * 32].reshape(B_k8, 32, 1), True),
        "Forney's (65536, 255) x (1, 255)": (a8[: B_k8 * 255].reshape(B_k8, 255), b8[:255].reshape(1, 255), False),
        "Forney's (65536, 255) x (65536, 255)":
            (a8[: B_k8 * 255].reshape(B_k8, 255), b8[: B_k8 * 255].reshape(B_k8, 255), False),
        "derivative (65536, 32) x (1, 32)": (a8[: B_k8 * 32].reshape(B_k8, 32), b8[:32].reshape(1, 32), False),
    }
    k8_layouts = {
        "ragged n=1,000,003": lambda x, y: (x[:1_000_003], y[:1_000_003]),
        "view one element in": lambda x, y: (x[1:1_000_001], y[3:1_000_003]),
        "one element": lambda x, y: (x[5:6], y[:100_003]),
        "row broadcast (4096, 255) x (1, 255)": lambda x, y: (x[: 4096 * 255].reshape(4096, 255), y[:255].reshape(1, 255)),
        "column broadcast (4096, 33) x (4096, 1)": lambda x, y: (x[: 4096 * 33].reshape(4096, 33), y[:4096].reshape(4096, 1)),
        "outer product (4096, 1, 33) x (4096, 32, 1)":
            lambda x, y: (x[: 4096 * 33].reshape(4096, 1, 33), y[: 4096 * 32].reshape(4096, 32, 1)),
        "inner axis of 5 (4096, 3, 5)": lambda x, y: (x[: 4096 * 5].reshape(4096, 1, 5), y[: 4096 * 3].reshape(4096, 3, 1)),
        "four axes, materialized": lambda x, y: (x[: 64 * 16].reshape(64, 1, 16, 1), y[: 7 * 9].reshape(1, 7, 1, 9)),
    }
    k8_cases = [(8, f8, "n=2^24", a8, b8)] + [(8, f8, tag, x, y) for tag, (x, y, _) in k8_main.items()]
    for m in range(2, 9):
        mask, f_m = 2**m - 1, gt.GF(2**m)._meta.irreducible_poly_int
        k8_cases += [(m, f_m, tag, *lay(a8 & mask, b8 & mask)) for tag, lay in k8_layouts.items()]
    for m, f, tag, x, y in k8_cases:
        got = gf2m_multiply_swar(x, y, m, f)
        torch.cuda.synchronize()
        err = max(max_abs_err(got, gf2m_multiply_swar_plain(x, y, m, f)), max_abs_err(got, gf2m_multiply_plain(x, y, m, f)))
        record("gf2m_multiply_swar", err)
        print(f"[kernel] K8 gf2m_multiply_swar m={m} {tag}: max_abs_err {err} (against its plain version and the ladder)", flush=True)
        if err:
            raise AssertionError(f"K8 disagrees with its plain version at m = {m}, {tag}")
    del got, k8_cases

    def k8_bound(x, y, row_const=False):
        """(ms, what) of K8: each operand's elements read once by stride, the
        output written once, the byte rows' 2(q - 1) words; three table reads
        an output at one conflict-free wavefront a warp (LOG b twice a run of
        16 where b is constant along the inner axis)."""
        n = max(x.numel(), y.numel(), torch.broadcast_shapes(x.shape, y.shape).numel())
        reads = n * (2 + (2 / 16 if row_const else 1))
        return bound(x.numel() + y.numel() + n + 2 * 255 * 4, wavefronts=reads / 32)

    k8 = graph_ms(lambda: gf2m_multiply_swar(a8, b8, 8, f8), 50)
    k8_eager = cuda_ms(lambda: gf2m_multiply_swar(a8, b8, 8, f8), 50)
    pms = cuda_ms(lambda: gf2m_multiply_swar_plain(a8, b8, 8, f8), 5)
    bnd = k8_bound(a8, b8)
    record("gf2m_multiply_swar", 0, k8, pms, bnd)
    print(
        f"[kernel] K8 gf2m_multiply_swar m=8 n=2^24: kernel {k8:.4f} ms (eager calls {k8_eager:.4f} ms) | "
        f"plain {pms:.4f} ms | bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at {bnd[0] / k8:.0%}",
        flush=True,
    )
    for tag, (x, y, row_const) in k8_main.items():  # wrapper calls, as the decoder makes them
        ms = graph_ms(lambda: gf2m_multiply_swar(x, y, 8, f8), 20)
        bnd = k8_bound(x, y, row_const)
        print(
            f"[kernel] K8 gf2m_multiply_swar m=8 at the RS decoder's {tag}, operands by stride: {ms:.4f} ms a "
            f"wrapper call by graph replay | bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at {bnd[0] / ms:.0%}",
            flush=True,
        )
    del k8_main
    # K7 and K3 on the same GF(2^8) inputs: the three kernels that compute this map
    want = gf2m_multiply_plain(a8, b8, 8, f8)
    got = gf2m_multiply(a8, b8, 8, f8)
    torch.cuda.synchronize()
    if max_abs_err(got, want):
        raise AssertionError("K7 disagrees with its plain version on GF(2^8)")
    record("gf2m_multiply", 0)
    ops8 = get_ops(GF8._meta, "jit-lookup")
    exp8, log8 = (torch.from_numpy(t).to(dev) for t in (ops8.EXP, ops8.LOG))
    pk8 = _lookup.pack_tables(exp8, log8, 256, torch.uint8)
    got = _lookup.lookup_multiply(a8, b8, exp8, log8, 256, pk8)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K3 and K7 disagree on GF(2^8) products")
    k7 = graph_ms(lambda: gf2m_multiply(a8, b8, 8, f8), 50)
    k7_eager = cuda_ms(lambda: gf2m_multiply(a8, b8, 8, f8), 50)
    k3 = graph_ms(lambda: _lookup.lookup_multiply(a8, b8, exp8, log8, 256, pk8), 50)
    k3_eager = cuda_ms(lambda: _lookup.lookup_multiply(a8, b8, exp8, log8, 256, pk8), 50)
    print(
        f"[kernel] GF(2^8) multiply n=2^24, same inputs: K8 {k8:.4f} ms (eager calls {k8_eager:.4f} ms) | "
        f"K7 ladder {k7:.4f} ms (eager calls {k7_eager:.4f} ms) | K3 table gathers {k3:.4f} ms "
        f"(eager calls {k3_eager:.4f} ms)",
        flush=True,
    )
    del got, want
    # K7 on its main path's field: GF(2^9) (BCH(511)'s syndromes), int64 storage
    f9 = 529  # x^9 + x^4 + 1
    a9 = torch.randint(0, 512, (2**24,), generator=gen, device=dev)
    b9 = torch.randint(0, 512, (2**24,), generator=gen, device=dev)
    for tag, x, y in (("n=2^24", a9, b9), ("(16384, 5) x (16384, 1)", a9[: 16384 * 5].reshape(16384, 5), b9[:16384].reshape(16384, 1))):
        got = gf2m_multiply(x, y, 9, f9)
        torch.cuda.synchronize()
        err = max_abs_err(got, gf2m_multiply_plain(x, y, 9, f9))
        record("gf2m_multiply", err)
        print(f"[kernel] K7 gf2m_multiply m=9 (int64) {tag}: max_abs_err {err}", flush=True)
        if err:
            raise AssertionError(f"K7 disagrees with its plain version on GF(2^9), {tag}")
    del got
    ms = graph_ms(lambda: gf2m_multiply(a9, b9, 9, f9), 20)
    eager = cuda_ms(lambda: gf2m_multiply(a9, b9, 9, f9), 20)
    pms = cuda_ms(lambda: gf2m_multiply_plain(a9, b9, 9, f9), 5)
    # K7's ladder a element: 5 a bit of b (3 for bit 0), 4 a folded bit, 1 to widen the store
    k7_ops = (9 * 9 - 5) * 2**24
    record("gf2m_multiply", 0, ms, pms, bound(3 * 8 * 2**24))
    print(
        f"[kernel] K7 gf2m_multiply m=9 (int64) n=2^24: kernel {ms:.4f} ms (eager calls {eager:.4f} ms) | "
        f"plain {pms:.4f} ms | {bounds_text(3 * 8 * 2**24, k7_ops, ms)}",
        flush=True,
    )
    del a9, b9
    torch.cuda.empty_cache()

    # K8-A: at GF(2^8) the reciprocal and an exponent tensor at 2^24,
    # Forney's (65536, 255) reciprocal and the erasure locator's 0-D base
    # against (65536, 33) exponents; then every m = 2..16 over all its
    # elements: the reciprocal on a view one element in with a ragged tail
    # (K5's pass), by stride 3 and transposed (the strided pass), random
    # 64-bit exponents, the exponents 0, 1, q - 1, q and 2^63 - 1 against
    # every element with nbits 0, m and 64, and a = 0
    e8 = torch.randint(0, 2**40, (2**24,), generator=gen, device=dev)
    forney = a8[: 65536 * 255].reshape(65536, 255)
    pow_cases = [
        (8, f8, "reciprocal n=2^24", a8, None, 0),
        (8, f8, "exponent tensor n=2^24 (40 bits)", a8, e8, 40),
        (8, f8, "reciprocal at Forney's (65536, 255)", forney, None, 0),
        (8, f8, "0-D base, exponents (65536, 33) (the erasure locator)", a8[7], e8[: 65536 * 33].reshape(65536, 33) % 255, 8),
    ]
    for m in range(2, 17):
        Fm = gt.GF(2**m)
        q, f_m, dt_m = 2**m, Fm._meta.irreducible_poly_int, Fm._meta.torch_dtype
        every = torch.arange(q, device=dev).to(dt_m)
        thrice = every.repeat(3)
        ex = torch.randint(-2**62, 2**62, (3 * q - 1,), generator=gen, device=dev)
        edges = torch.tensor([0, 1, q - 1, q, 2**63 - 1], device=dev)
        pow_cases += [
            (m, f_m, f"reciprocal, every element, view one element in, n={3 * q - 1}", thrice[1:], None, 0),
            (m, f_m, "reciprocal, every element by stride 3", thrice[::3], None, 0),
            (m, f_m, "reciprocal, every element transposed", every.reshape(-1, 2).t(), None, 0),
            (m, f_m, "reciprocal of 0", torch.zeros(3, dtype=dt_m, device=dev), None, 0),
            (m, f_m, f"exponent tensor (64 bits), view one element in, n={3 * q - 1}", thrice[1:], ex, 64),
        ] + [
            (m, f_m, f"exponents 0, 1, q-1, q, 2^63-1 against every element, nbits {nb}", every[:, None], edges[None, :], nb)
            for nb in (0, m, 64)
        ] + [
            (m, f_m, "a = 0 against the same exponents", torch.zeros(5, dtype=dt_m, device=dev), edges, 64),
            (m, f_m, "three axes: (2, 1, q/2) against (1, 3, 1)", every.reshape(2, 1, -1), ex[:3].reshape(1, 3, 1), 64),
            (m, f_m, "four axes, materialized: (2, 1, q/2, 1) against (1, 3, 1, 5)",
             every.reshape(2, 1, -1, 1), torch.randint(-2**62, 2**62, (1, 3, 1, 5), generator=gen, device=dev), 64),
        ]
    for m, f, tag, x, y, nb in pow_cases:
        got = gf2m_power(x, y, m, f, nb)
        torch.cuda.synchronize()
        err = max_abs_err(got, gf2m_power_plain(x, y, m, f, nb))
        record("gf2m_power", err)
        print(f"[kernel] K8-A gf2m_power m={m} {tag}: max_abs_err {err}", flush=True)
        if err:
            raise AssertionError(f"K8-A disagrees with its plain version at m = {m}, {tag}")
    del got, pow_cases, every, thrice, ex
    # K5, the table reciprocal, computes the same map on GF(2^8) (0 at 0 aside)
    inv_a = gf2m_power(a8, None, 8, f8)
    inv_k5 = _lookup.lookup_reciprocal(a8, exp8, log8, 256, pk8)
    torch.cuda.synchronize()
    if not torch.equal(inv_a[a8 != 0], inv_k5[a8 != 0]) or inv_a[a8 == 0].any():
        raise AssertionError("K8-A and K5 disagree on GF(2^8) reciprocals, or 1 / 0 is not 0")
    del inv_a, inv_k5
    # bounds: bytes, and the table reads (one an element for a reciprocal, LOG
    # and EXP for a power) at one conflict-free wavefront a warp
    n8, n_fy = 2**24, forney.numel()
    recip_ms = graph_ms(lambda: gf2m_power(a8, None, 8, f8), 20)
    k5_ms = graph_ms(lambda: _lookup.lookup_reciprocal(a8, exp8, log8, 256, pk8), 20)
    recip_plain = cuda_ms(lambda: gf2m_power_plain(a8, None, 8, f8), 2)
    pow_ms = graph_ms(lambda: gf2m_power(a8, e8, 8, f8, 40), 10)
    pow_plain = cuda_ms(lambda: gf2m_power_plain(a8, e8, 8, f8, 40), 1)
    fy_ms = graph_ms(lambda: gf2m_power(forney, None, 8, f8), 20)
    fy_k5 = graph_ms(lambda: _lookup.lookup_reciprocal(forney, exp8, log8, 256, pk8), 20)
    bnd = bound(2 * n8 + 255 * 4, wavefronts=n8 / 32)
    record("gf2m_power", 0, recip_ms, recip_plain, bnd)
    print(
        f"[kernel] K8-A gf2m_power m=8 reciprocal n=2^24: kernel {recip_ms:.4f} ms by graph replay | K5 "
        f"lookup_reciprocal (hand kernel, the same table read without the zero mask) {k5_ms:.4f} ms | plain "
        f"{recip_plain:.4f} ms | bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at {bnd[0] / recip_ms:.0%}",
        flush=True,
    )
    bnd = bound(10 * n8 + 255 * 4, wavefronts=2 * n8 / 32)
    print(
        f"[kernel] K8-A gf2m_power m=8 exponent tensor n=2^24: kernel {pow_ms:.4f} ms | plain {pow_plain:.4f} ms | "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at {bnd[0] / pow_ms:.0%}",
        flush=True,
    )
    bnd = bound(2 * n_fy + 255 * 4, wavefronts=n_fy / 32)
    print(
        f"[kernel] K8-A gf2m_power m=8 reciprocal at Forney's (65536, 255): kernel {fy_ms:.4f} ms | K5 {fy_k5:.4f} ms | "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at {bnd[0] / fy_ms:.0%}",
        flush=True,
    )
    del e8, forney
    # on int64 storage: GF(2^16) at 2^24 (INV staged, 128 KB) and BCH(511,493)'s
    # (16384, 511) over GF(2^9), beside torch.take of the q-entry reciprocal table
    for m, shape in ((16, (2**24,)), (9, (16384, 511))):
        f_m = gt.GF(2**m)._meta.irreducible_poly_int
        x = torch.randint(0, 2**m, shape, generator=gen, device=dev)
        inv64 = gf2m_power_plain(torch.arange(2**m, device=dev), None, m, f_m)
        err = max_abs_err(gf2m_power(x, None, m, f_m), torch.take(inv64, x))
        record("gf2m_power", err)
        if err:
            raise AssertionError(f"K8-A disagrees with torch.take of the reciprocal table at m = {m}")
        ms = graph_ms(lambda: gf2m_power(x, None, m, f_m), 20)
        take_ms = graph_ms(lambda: torch.take(inv64, x), 20)
        bnd = bound(16 * x.numel() + 6 * 2**m, wavefronts=x.numel() / 32)
        print(
            f"[kernel] K8-A gf2m_power m={m} reciprocal {shape} int64: max_abs_err {err} | kernel {ms:.4f} ms by graph "
            f"replay | torch.take(INV64, a) {take_ms:.4f} ms | bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at "
            f"{bnd[0] / ms:.0%}",
            flush=True,
        )
        del x
    torch.cuda.empty_cache()

    # K8-B: RS(255,223)'s (65536, 32) with u = 0 and random u (0 to past d - 1,
    # rows of zero discrepancies among them), d = 65, m = 4 at d = 5 and 17,
    # and above m = 8 (int64 storage, one element a lane): BCH(511,493)'s
    # GF(2^9) at d = 5 (16384 rows) and 33, GF(2^12) at d = 17, GF(2^16) (INV
    # staged) at d = 9 and 33
    B_scan = 65536
    scans = {}
    for m, d, rows in ((8, 33, B_scan), (8, 65, B_scan), (4, 5, B_scan), (4, 17, B_scan), (9, 5, 16384),
                       (9, 33, B_scan), (12, 17, B_scan), (16, 9, B_scan), (16, 33, B_scan)):
        Fm = gt.GF(2**m)
        ops_m = get_ops(Fm._meta, "jit-calculate")
        S = torch.randint(0, 2**m, (rows, d - 1), generator=gen, device=dev).to(Fm._meta.torch_dtype)
        S[1::97] = 0
        S[2::97] = 2**m - 1
        u_r = torch.randint(0, d + 3, (rows,), generator=gen, device=dev)
        u_0 = torch.zeros(rows, dtype=torch.int64, device=dev)
        scans[(m, d)] = (ops_m, S, u_0, u_r)
        for tag, uu in (("u = 0", u_0), ("random u", u_r)):
            C, L = berlekamp_massey_scan(ops_m, S, uu, d)
            torch.cuda.synchronize()
            Cp, Lp = berlekamp_massey_scan_plain(ops_m, S, uu, d)
            err = max(max_abs_err(C, Cp), max_abs_err(L, Lp))
            record("berlekamp_massey_scan", err)
            print(f"[kernel] K8-B berlekamp_massey_scan m={m} d={d} ({rows}, {d - 1}), {tag}: max_abs_err {err}", flush=True)
            if err:
                raise AssertionError(f"K8-B disagrees with its plain version at m = {m}, d = {d}, {tag}")
    del C, L, Cp, Lp

    def scan_bound(m, d, rows):
        """(ms, what) of K8-B on rows codewords: the bytes of S', u in, C, L
        out and the table once. No operation count bounds the scan itself:
        the counts below are those of the kernel's own forms."""
        item = 1 if m <= 8 else 8
        return bound(rows * ((d - 1) * item + 8 + d * item + 8) + (2 * (2**m - 1) * 4 if m <= 8 else 3 * 2**m * 2))

    def scan_costs(m, f, d, rows, ms):
        ops_new, wf = scan_ops(m, f, d, rows), scan_wavefronts(m, d, rows)
        t_form = max(ops_new / INT32_OPS_PER_S, wf / SMEM_WAVEFRONTS_PER_S) * 1e3
        text = (
            f"table form's own count: {ops_new:.4g} operations ({ops_new / INT32_OPS_PER_S * 1e3:.4f} ms), "
            f"{wf:.4g} shared-memory wavefronts ({wf / SMEM_WAVEFRONTS_PER_S * 1e3:.4f} ms), the kernel at "
            f"{t_form / ms:.0%} of the larger"
        )
        if m <= 8:
            old = scan_ops_reciprocal(m, f, d, rows)
            text += f"; with the reciprocal chain {old:.4g} operations ({old / INT32_OPS_PER_S * 1e3:.4f} ms)"
        return text

    f_scan = GF8._meta.irreducible_poly_int
    ops_m, S, u_0, u_r = scans[(8, 33)]
    scan_ms = graph_ms(lambda: berlekamp_massey_scan(ops_m, S, u_0, 33), 20)
    scan_ms_u = graph_ms(lambda: berlekamp_massey_scan(ops_m, S, u_r, 33), 20)
    scan_plain = cuda_ms(lambda: berlekamp_massey_scan_plain(ops_m, S, u_0, 33), 2)
    bnd33 = scan_bound(8, 33, B_scan)
    record("berlekamp_massey_scan", 0, scan_ms, scan_plain, bnd33)
    print(
        f"[kernel] K8-B berlekamp_massey_scan RS(255,223)'s (65536, 32): kernel {scan_ms:.4f} ms (u = 0), "
        f"{scan_ms_u:.4f} ms (random u) by graph replay | plain {scan_plain:.3f} ms | bound {bnd33[0]:.4f} ms "
        f"({bnd33[1]}) | {scan_costs(8, f_scan, 33, B_scan, scan_ms)}",
        flush=True,
    )
    ops_m, S, u_0, _ = scans[(8, 65)]
    scan65_ms = graph_ms(lambda: berlekamp_massey_scan(ops_m, S, u_0, 65), 10)
    bnd65 = scan_bound(8, 65, B_scan)
    print(
        f"[kernel] K8-B berlekamp_massey_scan d = 65 (65536, 64): kernel {scan65_ms:.4f} ms by graph replay | "
        f"bound {bnd65[0]:.4f} ms ({bnd65[1]}) | {scan_costs(8, f_scan, 65, B_scan, scan65_ms)}",
        flush=True,
    )
    for m, d in ((9, 5), (16, 33)):
        ops_m, S, u_0, _ = scans[(m, d)]
        f_m, rows = ops_m.meta.irreducible_poly_int, S.shape[0]
        wide_ms = graph_ms(lambda: berlekamp_massey_scan(ops_m, S, u_0, d), 20)
        wide_plain = cuda_ms(lambda: berlekamp_massey_scan_plain(ops_m, S, u_0, d), 2)
        bnd_w = scan_bound(m, d, rows)
        print(
            f"[kernel] K8-B berlekamp_massey_scan m={m} d={d} ({rows}, {d - 1}), int64: kernel {wide_ms:.4f} ms by "
            f"graph replay | plain {wide_plain:.3f} ms | bound {bnd_w[0]:.4f} ms ({bnd_w[1]}) | "
            f"{scan_costs(m, f_m, d, rows, wide_ms)}",
            flush=True,
        )
    del scans, S, u_0, u_r
    torch.cuda.empty_cache()

    # K15: the decoders' products with their constants at B = 65536, on the decoders' own maps:
    # RS(255,223) over GF(2^8) (W, CH_T, CHn_T, and Vinv_T of the erasure locator) and BCH(511,493)
    # over GF(2^9) (W, CH_T, CHn_T). Each against the plain version on the same card tensors, bit
    # for bit, then timed by graph replay beside the plain version and the bit-plane product that
    # the decoders ran before K15 (eager). Bound: the map's int8 multiply-adds (2 rows K m N m) or
    # the storage read and written once with the map, whichever is larger.
    B_lin = 65536
    rs_lin, bch_lin = gt.ReedSolomon(255, 223), gt.BCH(511, 493)
    ext_lin = bch_lin.extension_field
    lin_decoders = (
        ("RS(255,223)", rs_lin.field, make_decoder(
            rs_lin.field._meta, rs_lin.field._mode, rs_lin.field.order, rs_lin.n, rs_lin.n, rs_lin.d, rs_lin.c,
            int(rs_lin.alpha), True), ("W", "CH_T", "CHn_T", "Vinv_T")),
        ("BCH(511,493)", ext_lin, make_decoder(
            ext_lin._meta, ext_lin._mode, bch_lin.field.order, bch_lin.n, bch_lin.n, bch_lin.d, bch_lin.c,
            int(bch_lin.alpha), False), ("W", "CH_T", "CHn_T")),
    )
    for code_name, fld, dec_lin, names in lin_decoders:
        K_lin, meta_lin = dec_lin.consts(dev), fld._meta
        m_lin = meta_lin.degree
        for cname in names:
            M_lin, frags = K_lin[cname], K_lin[f"T_{cname}"]
            k_lin, n_lin = M_lin.shape
            x = torch.randint(0, fld.order, (B_lin, k_lin), generator=gen, device=dev).to(meta_lin.torch_dtype)
            x[1::97] = 0
            x[2::97] = fld.order - 1
            got = gf2_linear(x, frags, m_lin, n_lin)
            torch.cuda.synchronize()
            err = max_abs_err(got, gf2_linear_plain(x, frags, m_lin, n_lin))
            planes_err = max_abs_err(got, binary_matmul(meta_lin, x, M_lin))
            record("gf2_linear", max(err, planes_err))
            if err or planes_err:
                raise AssertionError(
                    f"K15 disagrees with its plain version ({err}) or the bit-plane product ({planes_err}) "
                    f"at {code_name}'s {cname}"
                )
            ms = graph_ms(lambda: gf2_linear(x, frags, m_lin, n_lin), 20)
            plain_ms = cuda_ms(lambda: gf2_linear_plain(x, frags, m_lin, n_lin), 2)
            planes_ms = cuda_ms(lambda: binary_matmul(meta_lin, x, M_lin), 2)
            bnd = bound(B_lin * (k_lin + n_lin) * x.element_size() + frags.numel(),
                        2 * B_lin * k_lin * m_lin * n_lin * m_lin)
            if (code_name, cname) == ("RS(255,223)", "W"):
                record("gf2_linear", 0, ms, plain_ms, bnd)
            print(
                f"[kernel] K15 gf2_linear {code_name} {cname} ({B_lin}, {k_lin}) x ({k_lin}, {n_lin}) GF(2^{m_lin}) "
                f"{x.dtype}, map {frags.numel()} bytes: max_abs_err {err} (bit planes {planes_err}) | kernel "
                f"{ms:.4f} ms by graph replay | plain {plain_ms:.3f} ms | bit-plane product {planes_ms:.3f} ms | "
                f"bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at {bnd[0] / ms:.0%}",
                flush=True,
            )
            del x, got
    del lin_decoders, K_lin, frags
    torch.cuda.empty_cache()

    # K16: the Goldilocks limb matmul's combine at the 2^24 LDE side's chunk shape (side 1: M = K =
    # 4096, by the chunk width _core takes there); ragged, strided and accumulated calls. Each against
    # the plain version on the same card tensors, exactly; timed by graph replay beside the plain
    # version (eager, over the whole chunk in slices of 2048 columns) and the bound: 19 int32 read and
    # 4 uint16 written an element.
    ops_g = get_ops(gt.GF(GOLDILOCKS)._meta, "jit-calculate")
    highs_g = [(min(s, 9) - max(0, s - 9) + 1) * 127**2 * _limb_matmul._MAX_BLOCK_K for s in range(19)]

    def gold_diag(rows, cols):
        return torch.stack([torch.randint(0, h + 1, (rows, cols), generator=gen, device=dev).to(torch.int32)
                            for h in highs_g])

    rows_g = 4096
    cols_g = _limb_matmul._chunk_columns(_limb_matmul._gold_bytes_per_column(rows_g, 4096))
    for (rows, cols, acc) in ((33, 1000, False), (1000, 33, True), (1, 1, True), (rows_g, 1000, True)):
        d = gold_diag(rows, cols)
        wide = torch.randint(0, 2**16, (4, rows, cols + 40), generator=gen, device=dev)
        wide[3] %= 2**15  # canonical residues to accumulate into
        wide = wide.to(torch.uint16)
        out, want = wide[:, :, 8 : 8 + cols], wide[:, :, 8 : 8 + cols].clone()
        goldilocks_combine(ops_g, d, out, accumulate=acc)
        torch.cuda.synchronize()
        err = max_abs_err(out, goldilocks_combine_plain(ops_g, d, want, accumulate=acc))
        record("goldilocks_combine", err)
        print(f"[kernel] K16 goldilocks_combine ({rows}, {cols}) into a view of rows {cols + 40} long, accumulate "
              f"{acc}: max_abs_err {err}", flush=True)
        if err:
            raise AssertionError(f"K16 disagrees with its plain version at ({rows}, {cols}), accumulate {acc}")
    d = gold_diag(rows_g, cols_g)
    out = torch.empty((4, rows_g, cols_g), dtype=torch.uint16, device=dev)
    goldilocks_combine(ops_g, d, out)
    torch.cuda.synchronize()
    want = torch.empty_like(out)

    def gold_plain():  # the plain version's int64 columns in slices
        for j in range(0, cols_g, 2048):
            goldilocks_combine_plain(ops_g, d[:, :, j : j + 2048], want[:, :, j : j + 2048])

    gold_plain()
    err = max_abs_err(out, want)
    record("goldilocks_combine", err)
    if err:
        raise AssertionError(f"K16 disagrees with its plain version at ({rows_g}, {cols_g})")
    ms = graph_ms(lambda: goldilocks_combine(ops_g, d, out), 20)
    plain_ms = cuda_ms(gold_plain, 2)
    bnd = bound(rows_g * cols_g * (19 * 4 + 4 * 2))
    record("goldilocks_combine", 0, ms, plain_ms, bnd)
    print(
        f"[kernel] K16 goldilocks_combine (19, {rows_g}, {cols_g}) int32 -> (4, {rows_g}, {cols_g}) uint16, the 2^24 "
        f"side's chunk: max_abs_err {err} | kernel {ms:.4f} ms by graph replay | plain {plain_ms:.3f} ms (eager, "
        f"2048 columns at a time) | bound {bnd[0]:.4f} ms ({bnd[1]}), the kernel at {bnd[0] / ms:.0%}",
        flush=True,
    )
    del d, out, want
    torch.cuda.empty_cache()

    # K1/K2: the prologue and both sides against their plain versions at the
    # NTT's shapes and at ragged tiles (M % 128, N % BN, K % 16 and K % 64 not
    # 0), batch 1 and 3, and 3 and 5 planes inside the gate. Raw tables take
    # the wrapper's repack; K-major ones (as MatmulFFTPlan keeps them) none,
    # and those are timed.
    ys_a = torch.randint(-128, 128, (4096, 16 * 4096), generator=gen, device=dev, dtype=torch.int8)
    ys_b = torch.randint(-128, 128, (4096, 16 * 4096), generator=gen, device=dev, dtype=torch.int8).t()
    ys_bnd = bound(0, 4 * 2 * 4096 * 16 * 4096 * 4096)
    try:
        ys = cuda_ms(lambda: [torch._int_mm(ys_a, ys_b) for _ in range(4)], 3)
        print(
            f"[kernel] yardstick, not the same function: torch._int_mm int8 (4096, 65536) @ (65536, 4096) "
            f"four times, the MACs of one NTT side at 4096^3 x 4: {ys:.3f} ms | bound {ys_bnd[0]:.3f} ms "
            f"({ys_bnd[0] / ys:.1%})",
            flush=True,
        )
    except RuntimeError as exc:  # a yardstick: no check depends on it
        print(f"[kernel] yardstick torch._int_mm not measured: {type(exc).__name__}: {exc}", flush=True)
    del ys_a, ys_b
    rng = np.random.default_rng(1)
    shapes = [  # (p, M, K, N, batch, reps); None reps: check only
        (P, 1024, 1024, 1024, 2, None),
        (P, 300, 520, 200, 3, None),
        (P, 130, 100, 50, 1, None),
        (P, 257, 1000, 97, 3, None),
        (7340033, 200, 120, 100, 3, None),  # 3 planes
        (2**32 - 5, 260, 1000, 130, 1, None),  # 5 planes
        (P, 1024, 1024, 1024, 32, 5),  # NTT 2^20 sides
        (P, 4096, 4096, 4096, 4, 3),  # NTT 2^24 sides
    ]
    for p, M, K, N, B, reps in shapes:
        n_planes = balanced_plane_count(p)
        A_raw = torch.from_numpy(balanced_planes_np(rng.integers(0, p, (M, K)), p)).to(dev)
        W_raw = torch.from_numpy(balanced_planes_np(rng.integers(0, p, (K, N)), p)).to(dev)
        A, W = kmajor_planes(A_raw, 2), kmajor_planes(W_raw, 1)
        T = torch.from_numpy(rng.integers(0, p, (M, N))).to(dev)
        xr = torch.randint(0, p, (B, K, N), generator=gen, device=dev)
        xl = torch.randint(0, p, (B, M, K), generator=gen, device=dev)
        edges = torch.tensor([0, p // 2, p // 2 + 1, p - 1], device=dev)
        xr.view(-1)[:4] = edges
        xl.view(-1)[:4] = edges
        tag = f"p={p} ({n_planes} planes) {M}x{K}x{N} batch {B}"
        side_ops = n_planes**2 * 2 * M * K * N * B  # int8 plane-pair products

        err = 0
        for data, cols in ((xr, True), (xl, False)):
            got = plane_digits(data, p, cols)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, plane_digits_plain(data, p, cols)))
            del got
        print(f"[kernel] K1/K2 prologue plane_digits {tag}: max_abs_err {err}", flush=True)
        if err:
            raise AssertionError("the K1/K2 prologue disagrees with its plain version")

        got = plane_matmul_data_right(A, xr, p, twiddle=T)
        torch.cuda.synchronize()
        err = max_abs_err(got, plane_matmul_data_right_plain(A, xr, p, T))
        del got
        got = plane_matmul_data_right(A_raw, xr, p)  # raw table: the wrapper's repack
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, plane_matmul_data_right_plain(A_raw, xr, p)))
        del got
        timing = ""
        if reps:
            ms = cuda_ms(lambda: plane_matmul_data_right(A, xr, p, twiddle=T), reps)
            dms = cuda_ms(lambda: plane_digits(xr, p, True), reps)
            pms = cuda_ms(lambda: plane_matmul_data_right_plain(A, xr, p, T), reps)
            bnd = bound(n_planes * M * K + 8 * (B * K * N + M * N + B * M * N), side_ops)
            record("plane_matmul_data_right", err, ms, pms, bnd)
            timing = (f" | kernel {ms:.3f} ms (prologue {dms:.3f} ms of it) | plain {pms:.3f} ms | "
                      f"bound {bnd[0]:.3f} ms ({bnd[1]}), {bnd[0] / ms:.1%} of it")
        else:
            record("plane_matmul_data_right", err)
        print(f"[kernel] K1 data_right(+twiddle) {tag}: max_abs_err {err}{timing}", flush=True)
        if err:
            raise AssertionError("K1 disagrees with its plain version")

        got = plane_matmul_data_left(xl, W, p, transpose_out=True)
        torch.cuda.synchronize()
        err = max_abs_err(got, plane_matmul_data_left_plain(xl, W, p, True))
        del got
        got = plane_matmul_data_left(xl, W_raw, p)  # raw table: the wrapper's repack
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, plane_matmul_data_left_plain(xl, W_raw, p)))
        del got
        timing = ""
        if reps:
            ms = cuda_ms(lambda: plane_matmul_data_left(xl, W, p, transpose_out=True), reps)
            dms = cuda_ms(lambda: plane_digits(xl, p), reps)
            pms = cuda_ms(lambda: plane_matmul_data_left_plain(xl, W, p, True), reps)
            bnd = bound(n_planes * K * N + 8 * (B * M * K + B * M * N), side_ops)
            record("plane_matmul_data_left", err, ms, pms, bnd)
            timing = (f" | kernel {ms:.3f} ms (prologue {dms:.3f} ms of it) | plain {pms:.3f} ms | "
                      f"bound {bnd[0]:.3f} ms ({bnd[1]}), {bnd[0] / ms:.1%} of it")
        else:
            record("plane_matmul_data_left", err)
        print(f"[kernel] K2 data_left(+transpose) {tag}: max_abs_err {err}{timing}", flush=True)
        if err:
            raise AssertionError("K2 disagrees with its plain version")
        del A, W, A_raw, W_raw, T, xr, xl
        torch.cuda.empty_cache()

    # What bounds the sides: K2 at 4096 x K x 4096 (batch 1) for K = 4096 and
    # 16384. The difference is the main loop's time for 3 x 4096 of K; what
    # it leaves of the shorter call is the part that does not grow with K
    # (prologue, ring fill, epilogue fold and stores).
    t_k = {}
    for K in (4096, 16384):
        wt = torch.randint(0, P, (1, 4096, K), generator=gen, device=dev)
        W = KMajorPlanes(plane_digits(wt, P)[0], K)  # the K-major planes of the (K, 4096) table wt^T
        xl = torch.randint(0, P, (1, 4096, K), generator=gen, device=dev)
        t_k[K] = cuda_ms(lambda: plane_matmul_data_left(xl, W, P, transpose_out=True), 3)
        del wt, W, xl
    loop_ms = (t_k[16384] - t_k[4096]) / 3
    loop_bnd = bound(0, 16 * 2 * 4096**3)
    print(
        f"[kernel] K2 at 4096 x K x 4096 batch 1: K = 4096 {t_k[4096]:.3f} ms, K = 16384 {t_k[16384]:.3f} ms | "
        f"main loop per 4096 of K {loop_ms:.3f} ms, {loop_bnd[0] / loop_ms:.1%} of its bound {loop_bnd[0]:.3f} ms | "
        f"the rest {t_k[4096] - loop_ms:.3f} ms",
        flush=True,
    )
    torch.cuda.empty_cache()

    # K3 and K4, by placement. First every (a, b) pair of GF(2^8) and GF(3^5)
    k3_k4 = (
        ("lookup_multiply", "K3", _lookup.lookup_multiply, _lookup.lookup_multiply_plain),
        ("lookup_divide", "K4", _lookup.lookup_divide, _lookup.lookup_divide_plain),
    )
    for q in (2**8, 3**5):
        F = gt.GF(q)
        ops = get_ops(F._meta, "jit-lookup")
        exp_t, log_t = (torch.from_numpy(t).to(dev) for t in (ops.EXP, ops.LOG))
        packed = _lookup.pack_tables(exp_t, log_t, q, torch.uint8)
        a, b = (v.reshape(-1).to(torch.uint8) for v in torch.meshgrid(
            torch.arange(q, device=dev), torch.arange(q, device=dev), indexing="ij"))
        for name, tag, kernel, plain in k3_k4:
            got = kernel(a, b, exp_t, log_t, q, packed)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain(a, b, exp_t, log_t, q))
            record(name, err)
            print(f"[kernel] {tag} {name} GF({q}) every (a, b) pair ({q * q}): max_abs_err {err}", flush=True)
            if err:
                raise AssertionError(f"{tag} disagrees with its plain version on a pair of GF({q})")

    def lookup_bound(place, q, n, width, operands):
        """K3/K4's bound: HBM bytes (the streamed operands, the output and the
        packed table, once each) against the shared-memory gathers counted from
        csrc/lookup.cu at one wavefront each, conflict-free at best."""
        q8, e8 = -(-q // 8) * 8, -(-(q - 1) // 8) * 8
        table = {"bytes": 4 * 2 * (q - 1), "global": 4 * (3 * q - 2)}.get(place, 2 * (q8 + e8))
        gathers = {"bytes": 3, "shared": 3, "log-shared": 2, "global": 0}[place]
        return bound((operands + 1) * width * n + table, wavefronts=gathers * n / 32)

    # then each placement at 2^24 (GF(2^8) also at 2^20, BASELINE config 1's
    # 1M elements, and at 2^26) and ragged orders and sizes; GF(2^8) at 2^24
    # goes into the report
    bin_cases = [  # (order, n, reps); None reps: check only
        (2**8, 2**24, 50),
        (3**5, 2**24, 50),
        (2**10, 2**24, 20),
        (2**16, 2**24, 20),
        (2**8, 2**20, 200),
        (2**8, 2**26, 20),  # three 64 MB tensors: no replay finds them in the 50 MB L2
        (2**14, 1_000_003, None),
        (2**20, 1_000_003, None),
    ]
    for q, n, reps in bin_cases:
        F = gt.GF(q)
        ops = get_ops(F._meta, "jit-lookup")
        exp_t, log_t = (torch.from_numpy(t).to(dev) for t in (ops.EXP, ops.LOG))
        dt = F._meta.torch_dtype
        packed = _lookup.pack_tables(exp_t, log_t, q, dt)
        place = _lookup.lookup_placement(q, dt)
        a = torch.randint(0, q, (n,), generator=gen, device=dev).to(dt)
        b = torch.randint(0, q, (n,), generator=gen, device=dev).to(dt)
        a[::1009] = 0  # zeros on each side and on both, also where q is large
        b[::997] = 0
        for name, tag, kernel, plain in k3_k4:
            got = kernel(a, b, exp_t, log_t, q, packed)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain(a, b, exp_t, log_t, q))
            del got
            timing = ""
            if reps:
                ms = graph_ms(lambda: kernel(a, b, exp_t, log_t, q, packed), reps)
                pms = cuda_ms(lambda: plain(a, b, exp_t, log_t, q), max(2, reps // 10))
                bnd = lookup_bound(place, q, n, a.element_size(), 2)
                if (q, n) == bin_cases[0][:2]:
                    record(name, err, ms, pms, bnd)
                else:
                    record(name, err)
                timing = (
                    f" | kernel {ms:.4f} ms | plain {pms:.4f} ms | bound {bnd[0]:.4f} ms ({bnd[1]}), "
                    f"{bnd[0] / ms:.1%} of it"
                )
            else:
                record(name, err)
            print(f"[kernel] {tag} {name} GF({q}) n={n} ({dt}, placement {place}): max_abs_err {err}{timing}",
                  flush=True)
            if err:
                raise AssertionError(f"{tag} disagrees with its plain version on GF({q}), n = {n}")
        if (q, n) in ((2**8, 2**24), (2**16, 2**24)):
            # views one element off alignment (funnel-shifted streams) and a 0-D operand (stride 0)
            for label, x, y, operands in (
                ("a[1:] * b[:-1], unaligned views", a[1:], b[:-1], 2),
                ("a * b[5], b[5] 0-D", a, b[5], 1),
            ):
                got = _lookup.lookup_multiply(x, y, exp_t, log_t, q, packed)
                torch.cuda.synchronize()
                err = max_abs_err(got, _lookup.lookup_multiply_plain(x, y, exp_t, log_t, q))
                del got
                record("lookup_multiply", err)
                ms = graph_ms(lambda: _lookup.lookup_multiply(x, y, exp_t, log_t, q, packed), reps)
                bnd = lookup_bound(place, q, x.numel() if y.dim() else n, a.element_size(), operands)
                print(
                    f"[kernel] K3 lookup_multiply GF({q}) {label}: max_abs_err {err} | kernel {ms:.4f} ms | "
                    f"bound {bnd[0]:.4f} ms ({bnd[1]})",
                    flush=True,
                )
                if err:
                    raise AssertionError(f"K3 disagrees with its plain version on GF({q}), {label}")
            # a yardstick, not the same function: torch's elementwise kernel on the same tensors
            xor = graph_ms(lambda: torch.bitwise_xor(a, b), reps)
            bnd = bound(3 * a.element_size() * n)
            print(
                f"[kernel] yardstick torch.bitwise_xor(a, b) on the GF({q}) tensors ({dt}): {xor:.4f} ms | "
                f"bytes bound {bnd[0]:.4f} ms, {bnd[0] / xor:.1%} of it",
                flush=True,
            )
        del a, b, exp_t, log_t, packed
        torch.cuda.empty_cache()

    # K5 and K6, by placement. First every element of GF(2^8) and GF(3^5), in
    # uint8 storage ('bytes') and in int64 ('shared'), 0 included
    k5_k6 = (
        ("lookup_reciprocal", "K5", lambda a, e, l, q, pk: _lookup.lookup_reciprocal(a, e, l, q, pk),
         lambda a, e, l, q: _lookup.lookup_reciprocal_plain(a, e, l, q)),
        ("lookup_log", "K6", lambda a, e, l, q, pk: _lookup.lookup_log(a, l, q, pk),
         lambda a, e, l, q: _lookup.lookup_log_plain(a, l, q)),
    )
    for q in (2**8, 3**5):
        F = gt.GF(q)
        ops = get_ops(F._meta, "jit-lookup")
        exp_t, log_t = (torch.from_numpy(t).to(dev) for t in (ops.EXP, ops.LOG))
        for dt in (torch.uint8, torch.int64):
            packed = _lookup.pack_tables(exp_t, log_t, q, dt)
            place = _lookup.lookup_placement(q, dt)
            every = torch.arange(q, device=dev).to(dt)
            for name, tag, kernel, plain in k5_k6:
                for label, x in (("every element", every), ("every element, a view one element in", every[1:])):
                    got = kernel(x, exp_t, log_t, q, packed)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, plain(x, exp_t, log_t, q))
                    record(name, err)
                    print(f"[kernel] {tag} {name} GF({q}) {label} ({dt}, placement {place}): max_abs_err {err}",
                          flush=True)
                    if err:
                        raise AssertionError(f"{tag} disagrees with its plain version on GF({q}), {label}")

    # then each placement at 2^24 and GF(2^8) at 2^26 (timed), ragged orders
    # and sizes (checked); on int64 storage torch.take of a q-entry table is
    # the yardstick (torch has no gather by a uint8 index in one call). The
    # GF(2^16) times go into the report.
    lookup_cases = [  # (order, n, reps); None reps: check only
        (2**8, 2**24, 50),
        (3**5, 2**24, 50),
        (2**10, 2**24, 20),
        (2**16, 2**24, 20),
        (2**8, 2**26, 20),  # 64 MB in, 64 MB (K5) or 512 MB (K6) out: no replay finds them in the 50 MB L2
        (2**14, 1_000_003, None),
        (2**20, 1_000_003, None),
    ]
    for q, n, reps in lookup_cases:
        F = gt.GF(q)
        ops = get_ops(F._meta, "jit-lookup")
        exp_t, log_t = (torch.from_numpy(t).to(dev) for t in (ops.EXP, ops.LOG))
        dt = F._meta.torch_dtype
        packed = _lookup.pack_tables(exp_t, log_t, q, dt)
        place = _lookup.lookup_placement(q, dt)
        a = torch.randint(0, q, (n,), generator=gen, device=dev).to(dt)
        a[::1009] = 0
        width = a.element_size()
        # the table bytes a kernel reads: q rows of 4 bytes, a uint16 segment, or the int32 tables
        table = {"bytes": 4 * q, "global": 4 * q}.get(place, 2 * (-(-q // 8) * 8))
        yard = {  # one PyTorch call computing the same map on int64 storage
            "lookup_reciprocal": _lookup.lookup_reciprocal_plain(torch.arange(q, device=dev), exp_t, log_t, q),
            "lookup_log": log_t.to(torch.int64),
        }
        for name, tag, kernel, plain in k5_k6:
            got = kernel(a, exp_t, log_t, q, packed)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain(a, exp_t, log_t, q))
            del got
            timing = ""
            if reps:
                ms = graph_ms(lambda: kernel(a, exp_t, log_t, q, packed), reps)
                pms = cuda_ms(lambda: plain(a, exp_t, log_t, q), max(2, reps // 10))
                out_width = width if tag == "K5" else 8
                extra = 4 * 2 * (q - 1) if (tag, place) == ("K5", "global") else 0
                bnd = bound((width + out_width) * n + table + extra)
                lib = None
                if dt == torch.int64:
                    lib = graph_ms(lambda: torch.take(yard[name], a), reps)
                    if not torch.equal(torch.take(yard[name], a).to(dt if tag == "K5" else torch.int64),
                                       plain(a, exp_t, log_t, q)):
                        raise AssertionError(f"the torch.take yardstick of {tag} is not its function")
                if (q, n) == (2**16, 2**24):
                    record(name, err, ms, pms, bnd, lib)
                else:
                    record(name, err)
                timing = (
                    f" | kernel {ms:.4f} ms | plain {pms:.4f} ms | bound {bnd[0]:.4f} ms ({bnd[1]}), "
                    f"{bnd[0] / ms:.1%} of it"
                    + ("" if lib is None else f" | yardstick torch.take {lib:.4f} ms, {bnd[0] / lib:.1%} of bound")
                )
            else:
                record(name, err)
            print(f"[kernel] {tag} {name} GF({q}) n={n} ({dt}, placement {place}): max_abs_err {err}{timing}",
                  flush=True)
            if err:
                raise AssertionError(f"{tag} disagrees with its plain version on GF({q}), n = {n}")
        del a, exp_t, log_t, packed, yard
        torch.cuda.empty_cache()

    # K9 and K10: 2^24 (timed) and a ragged 1,000,003, edge values first
    gold_edges = [0, 1, GOLDILOCKS - 1, 2**32 - 1, 2**32, 2**64 - 1, GOLDILOCKS, GOLDILOCKS + 5]
    for n, reps in ((2**24, 50), (1_000_003, None)):
        a = torch.randint(0, M31, (n,), generator=gen, device=dev)
        b = torch.randint(0, M31, (n,), generator=gen, device=dev)
        a[:6] = torch.tensor([0, 1, M31 - 1, M31 - 1, 0, 1], device=dev)
        b[:6] = torch.tensor([M31 - 1, M31 - 1, M31 - 1, 1, 0, 1], device=dev)
        # random limbs: values anywhere in [0, 2^64), canonical or not
        A = torch.randint(0, 2**16, (4, n), generator=gen, device=dev).to(torch.uint16)
        B = torch.randint(0, 2**16, (4, n), generator=gen, device=dev).to(torch.uint16)
        A[:, : len(gold_edges)] = to_limbs(gold_edges, dev)
        B[:, : len(gold_edges)] = to_limbs(gold_edges[::-1], dev)
        B[:, len(gold_edges) : 2 * len(gold_edges)] = to_limbs(gold_edges, dev)
        cases = [
            ("m31_multiply", "K9", lambda: m31_multiply(a, b), lambda: m31_multiply_plain(a, b)),
            ("goldilocks_multiply", "K10", lambda: goldilocks_multiply(A, B), lambda: goldilocks_multiply_plain(A, B)),
        ]
        for name, tag, kernel, plain in cases:
            got = kernel()
            torch.cuda.synchronize()
            err = max_abs_err(got, plain())
            del got
            timing = ""
            if reps:
                ms = graph_ms(kernel, reps)
                pms = cuda_ms(plain, 5)
                bnd = bound(24 * n)  # two operands in, one out, 8 bytes each
                record(name, err, ms, pms, bnd)
                timing = f" | kernel {ms:.4f} ms | plain {pms:.4f} ms | bound {bnd[0]:.4f} ms ({bnd[1]})"
            else:
                record(name, err)
            print(f"[kernel] {tag} {name} n={n}: max_abs_err {err}{timing}", flush=True)
            if err:
                raise AssertionError(f"{tag} disagrees with its plain version at n = {n}")
        del a, b, A, B
        torch.cuda.empty_cache()

    # K12, K13 and K14 against their plain versions at main path 8's shapes
    scan_limb_kernels(gt, dev, record, smi)

    counters = launch_counters()

    def read_counts(phase, needed):
        counts = {fn.__name__: fn.launches for fn in counters}
        print(f"[main] launches during main path {phase}: {counts}", flush=True)
        missing = [fn.__name__ for fn in needed if counts[fn.__name__] == 0]
        if missing:
            raise AssertionError(f"main path {phase} never launched {missing}")
        launches.update({fn.__name__: counts[fn.__name__] for fn in needed})

    # -- 4. main path 1: GF(2^8) multiply and the NTT ----------------------
    for fn in counters:
        fn.launches = 0

    x = GF8.Random(2**24, seed=1, device=dev)
    y = GF8.Random(2**24, seed=2, device=dev)
    z = x * y
    torch.cuda.synchronize()
    assert z.shape == (2**24,) and z.device == dev and z._data.dtype == torch.uint8
    xs, ys, zs = (np.asarray(v[: 2**16]) for v in (x, y, z))
    if not np.array_equal(zs.astype(np.int64), np_gf2m_multiply(xs, ys, 8, f8)):
        raise AssertionError("GF(2^8) multiply disagrees with the NumPy reference")
    ms = cuda_ms(lambda: x * y, 20)
    print(f"[main] GF(2^8) multiply, 2^24 elements: {ms:.4f} ms, {2**24 / ms / 1e6:.3f} Gmul/s", flush=True)

    F = gt.GF(P)
    alpha = int(F.primitive_element)
    for log_n, batch, reps in ((20, 32, 5), (24, 4, 3)):
        N = 2**log_n
        x = F.Random((batch, N), seed=log_n, device=dev)
        t0 = time.perf_counter()
        X = np.fft.fft(x)
        xb = np.fft.ifft(X)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if X.shape != (batch, N) or X.device != dev or not torch.equal(xb._data, x._data):
            raise AssertionError(f"np.fft.ifft(np.fft.fft(x)) != x at N = 2^{log_n}")
        row = x[batch - 1]
        Y = gt.ntt(row)
        if not torch.equal(Y._data, X[batch - 1]._data) or not torch.equal(gt.intt(Y)._data, row._data):
            raise AssertionError(f"intt(ntt(x)) != x or ntt != np.fft.fft on a row at N = 2^{log_n}")
        bins = [0, 1, 2, 3, 5, N // 2, N - 1] + [int(k) for k in np.random.default_rng(log_n).integers(0, N, 9)]
        want = direct_dft_bins(np.asarray(row).astype(np.int64), bins, P, alpha)
        got = np.asarray(X[batch - 1]).astype(np.int64)[bins]
        if not np.array_equal(got, want):
            raise AssertionError(f"NTT bins disagree with the direct DFT at N = 2^{log_n}")
        ms = cuda_ms(lambda: np.fft.fft(x), reps)
        print(
            f"[main] NTT N=2^{log_n} batch {batch}: {ms:.3f} ms per batched forward transform, "
            f"{batch * 1e3 / ms:.2f} transforms/s (plans built and first round trip {first_s:.1f} s)",
            flush=True,
        )
        del x, X, xb, Y, row
        torch.cuda.empty_cache()
    read_counts(1, (plane_matmul_data_right, plane_matmul_data_left, gf2m_multiply_swar))

    # -- 5. main path 2: lookup mode and GF(3^5) ----------------------------
    for fn in counters:
        fn.launches = 0
    n_chk = 2**16
    GF16, GF35 = gt.GF(2**16), gt.GF(3**5)
    f16 = 0x1002D  # Conway: x^16 + x^5 + x^3 + x^2 + 1
    f35 = [1, 2, 0, 0, 0, 1]  # Conway, ascending: x^5 + 2x + 1
    if (f8, GF16._meta.irreducible_poly_int, GF35._meta.irreducible_poly_int) != (0x11D, f16, 250):
        raise AssertionError("the fields' polynomials are not the Conway polynomials the references use")
    try:
        GF8.compile("jit-lookup")
        GF16.compile("jit-lookup")
        exp_r, log_r = np_exp_log(lambda u, v: np_gf2m_multiply(u, v, 8, 0x11D), int(GF8.primitive_element), 256)
        x = GF8.Random(2**24, seed=3, device=dev)
        y = GF8.Random(2**24, seed=4, low=1, device=dev)
        e = np.random.default_rng(5).integers(0, 1000, 2**24)
        results = {
            "x * y": lambda: x * y,
            "x / y": lambda: x / y,
            "np.reciprocal(y)": lambda: np.reciprocal(y),
            "y.log()": lambda: y.log(),
            "x ** e": lambda: x**e,
        }
        xs, ys, es = (np.asarray(v[:n_chk]).astype(np.int64) for v in (x, y, e))
        lx, ly = log_r[xs], log_r[ys]
        refs = {
            "x * y": np_gf2m_multiply(xs, ys, 8, 0x11D),
            "x / y": np.where(xs == 0, 0, exp_r[(lx - ly) % 255]),
            "np.reciprocal(y)": exp_r[(-ly) % 255],
            "y.log()": ly,
            "x ** e": np.where(xs == 0, (es == 0).astype(np.int64), exp_r[(lx * es) % 255]),
        }
        for label, fn in results.items():
            out = fn()
            got = out if isinstance(out, np.ndarray) else np.asarray(out)
            if got.shape != (2**24,) or not np.array_equal(got[:n_chk].astype(np.int64), refs[label]):
                raise AssertionError(f"lookup-mode GF(2^8) {label} disagrees with the NumPy reference")
            ms = cuda_ms(fn, 5)
            print(f"[main] GF(2^8) jit-lookup {label}, 2^24 elements: {ms:.4f} ms", flush=True)

        x16 = GF16.Random(2**24, seed=6, device=dev)
        y16 = GF16.Random(2**24, seed=7, device=dev)
        z16 = x16 * y16
        ref = np_gf2m_multiply(*(np.asarray(v[:n_chk]) for v in (x16, y16)), 16, f16)
        if z16._data.dtype != torch.int64 or not np.array_equal(np.asarray(z16[:n_chk]).astype(np.int64), ref):
            raise AssertionError("lookup-mode GF(2^16) multiply disagrees with the NumPy reference")
        ms = cuda_ms(lambda: x16 * y16, 5)
        print(f"[main] GF(2^16) jit-lookup x * y, 2^24 elements: {ms:.4f} ms", flush=True)
        del x16, y16, z16
        exp16, log16 = np_exp_log(lambda u, v: np_gf2m_multiply(u, v, 16, f16), int(GF16.primitive_element), 2**16)
        y16 = GF16.Random(2**24, seed=10, low=1, device=dev)
        ys = np.asarray(y16[:n_chk]).astype(np.int64)
        results = {"np.reciprocal(y16)": lambda: np.reciprocal(y16), "y16.log()": lambda: y16.log()}
        refs = {"np.reciprocal(y16)": exp16[(-log16[ys]) % (2**16 - 1)], "y16.log()": log16[ys]}
        if not (np_gf2m_multiply(ys, refs["np.reciprocal(y16)"], 16, f16) == 1).all():
            raise AssertionError("the NumPy GF(2^16) reciprocals are not inverses")
        for label, fn in results.items():
            out = fn()
            got = out if isinstance(out, np.ndarray) else np.asarray(out)
            if got.shape != (2**24,) or not np.array_equal(got[:n_chk].astype(np.int64), refs[label]):
                raise AssertionError(f"lookup-mode GF(2^16) {label} disagrees with the NumPy reference")
            ms = cuda_ms(fn, 5)
            print(f"[main] GF(2^16) jit-lookup {label}, 2^24 elements: {ms:.4f} ms", flush=True)
        del y16, out, got

        mul35 = lambda u, v: np_gfpm_multiply(u, v, 3, f35)  # noqa: E731
        exp35, log35 = np_exp_log(mul35, int(GF35.primitive_element), 243)
        x = GF35.Random(2**24, seed=8, device=dev)
        y = GF35.Random(2**24, seed=9, low=1, device=dev)
        xs, ys = (np.asarray(v[:n_chk]).astype(np.int64) for v in (x, y))
        dx = np.stack([(xs // 3**i) % 3 for i in range(5)], axis=-1)
        dy = np.stack([(ys // 3**i) % 3 for i in range(5)], axis=-1)
        w = 3 ** np.arange(5)
        results = {"x * y": lambda: x * y, "x + y": lambda: x + y, "x - y": lambda: x - y, "x / y": lambda: x / y}
        refs = {
            "x * y": mul35(xs, ys),
            "x + y": ((dx + dy) % 3 * w).sum(-1),
            "x - y": ((dx - dy) % 3 * w).sum(-1),
            "x / y": np.where(xs == 0, 0, exp35[(log35[xs] - log35[ys]) % 242]),
        }
        for label, fn in results.items():
            out = fn()
            if out.shape != (2**24,) or not np.array_equal(np.asarray(out[:n_chk]).astype(np.int64), refs[label]):
                raise AssertionError(f"GF(3^5) {label} disagrees with the NumPy reference")
            ms = cuda_ms(fn, 3)
            print(f"[main] GF(3^5) jit-calculate {label}, 2^24 elements: {ms:.4f} ms", flush=True)
        del x, y
    finally:
        GF8.compile("auto")
        GF16.compile("auto")
    torch.cuda.empty_cache()
    read_counts(2, (_lookup.lookup_multiply, _lookup.lookup_divide, _lookup.lookup_reciprocal, _lookup.lookup_log))

    # -- 6. main path 3: large prime fields and batched Poly evaluation ----
    for fn in counters:
        fn.launches = 0
    n_chk = 2**12
    for p, n_elem, seeds in ((GOLDILOCKS, 2**24, (11, 12)), (M31, 2**24, (13, 14))):
        F = gt.GF(p)
        tag = "Goldilocks" if p == GOLDILOCKS else "GF(2^31-1)"
        x = F.Random(n_elem, seed=seeds[0], device=dev)
        y = F.Random(n_elem, seed=seeds[1], low=1, device=dev)
        xs, ys = ints(x[:n_chk]), ints(y[:n_chk])
        results = {"x * y": lambda: x * y, "x / y": lambda: x / y}
        refs = {
            "x * y": [u * v % p for u, v in zip(xs, ys)],
            "x / y": [u * pow(v, -1, p) % p for u, v in zip(xs, ys)],
        }
        if p == GOLDILOCKS:
            results.update({"x + y": lambda: x + y, "x - y": lambda: x - y, "np.reciprocal(y)": lambda: np.reciprocal(y)})
            refs.update({
                "x + y": [(u + v) % p for u, v in zip(xs, ys)],
                "x - y": [(u - v) % p for u, v in zip(xs, ys)],
                "np.reciprocal(y)": [pow(v, -1, p) for v in ys],
            })
        for label, fn in results.items():
            k9, k10 = m31_multiply.launches, goldilocks_multiply.launches
            out = fn()
            torch.cuda.synchronize()
            k9, k10 = m31_multiply.launches - k9, goldilocks_multiply.launches - k10
            if out.shape != (n_elem,) or out.device != dev or ints(out[:n_chk]) != refs[label]:
                raise AssertionError(f"{tag} {label} disagrees with the Python-int reference")
            ms = cuda_ms(fn, 3)
            print(f"[main] {tag} {label}, 2^24 elements: {ms:.4f} ms | K9 launches {k9}, K10 launches {k10} per call", flush=True)
        del x, y
        torch.cuda.empty_cache()

        f = gt.Poly.Random(255, seed=seeds[0], field=F)
        coeffs = ints(f.coefficients())
        pts = F.Random(2**21, seed=seeds[1] + 100, device=dev)
        k9, k10 = m31_multiply.launches, goldilocks_multiply.launches
        t0 = time.perf_counter()
        out = f(pts)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        k9, k10 = m31_multiply.launches - k9, goldilocks_multiply.launches - k10
        if out.shape != (2**21,) or out.device != dev or ints(out[:n_chk]) != horner(coeffs, ints(pts[:n_chk]), p):
            raise AssertionError(f"{tag} Poly evaluation disagrees with the Python-int Horner reference")
        ms = cuda_ms(lambda: f(pts), 3)
        print(
            f"[main] {tag} Poly(degree 255)(x), 2^21 points: {ms:.3f} ms (first call {first_s * 1e3:.1f} ms) | "
            f"K9 launches {k9}, K10 launches {k10} per call",
            flush=True,
        )
        del pts, out
        torch.cuda.empty_cache()
    read_counts(3, (m31_multiply, goldilocks_multiply))

    # Horner's inner step at its (16, 2^21) shape, outside the counted run.
    # K9 and K10 against their plain versions on the operands the path gives
    # them: x of shape (1, 2^21) goes in with its period (the kernels' 2-D
    # grid). Then where the step's time goes: the multiply with the period,
    # the multiply with x materialized to (16, 2^21) first (copy included),
    # the torch add beside it; and a whole evaluation both ways.
    for p, name, tag, kernel, plain in (
        (GOLDILOCKS, "goldilocks_multiply", "K10", goldilocks_multiply, goldilocks_multiply_plain),
        (M31, "m31_multiply", "K9", m31_multiply, m31_multiply_plain),
    ):
        F = gt.GF(p)
        ops = get_ops(F._meta, F._mode)
        acc = F.Random((16, 2**21), seed=15, device=dev)._data
        lead = acc.ndim - 2  # the planar limb axis, if any
        xb = F.Random((1, 2**21), seed=16, device=dev)._data
        cj = F.Random((16, 1), seed=17, device=dev)._data
        got = ops.multiply(acc, xb)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain(acc, xb))
        del got
        record(name, err)
        field = "Goldilocks" if p == GOLDILOCKS else "GF(2^31-1)"
        shape = f"16 x 2^21{' (4 limb planes)' if lead else ''}"
        print(f"[kernel] {tag} {name} {shape} times x of 1 x 2^21 by its period: max_abs_err {err}", flush=True)
        if err:
            raise AssertionError(f"{tag} disagrees with its plain version at Horner's inner-step shape")
        mul_ms = cuda_ms(lambda: ops.multiply(acc, xb), 10)
        full_ms = cuda_ms(lambda: ops.multiply(acc, xb.expand(acc.shape).contiguous()), 10)
        add_ms = cuda_ms(lambda: ops.add(acc, cj), 10)
        kern_ms = graph_ms(lambda: kernel(acc, xb), 10)
        bnd = bound(2 * acc.numel() * acc.element_size() + xb.numel() * xb.element_size())
        print(
            f"[main] {field} Horner inner step at {shape}: multiply {mul_ms:.4f} ms with x by its period, "
            f"{full_ms:.4f} ms with x materialized; add {add_ms:.4f} ms | {tag} alone by graph replay "
            f"{kern_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})",
            flush=True,
        )
        del acc, xb, cj

        f = gt.Poly.Random(255, seed=18, field=F)
        pts = F.Random(2**21, seed=19, device=dev)
        want = f(pts)
        per_ms = cuda_ms(lambda: f(pts), 3)
        saved = _elementwise._MIN_PERIOD
        _elementwise._MIN_PERIOD = 2**63  # every broadcast operand materialized
        try:
            same = torch.equal(f(pts)._data, want._data)
            full_ms = cuda_ms(lambda: f(pts), 3)
        finally:
            _elementwise._MIN_PERIOD = saved
        if not same:
            raise AssertionError(f"{field} Poly evaluation differs with the broadcast materialized")
        print(
            f"[main] {field} Poly(degree 255)(x), 2^21 points: {per_ms:.3f} ms with x by its period, "
            f"{full_ms:.3f} ms with every broadcast materialized",
            flush=True,
        )
        del pts, want
        torch.cuda.empty_cache()

    # -- 7. main path 4: RS(255,223) and BCH(511,493) decoding ----------------
    for fn in counters:
        fn.launches = 0
    gen = torch.Generator(device=dev).manual_seed(40)

    def check_decode(code, label, msg, counts, dec, nerr):
        """Rows within the capability: their message and error count; rows
        beyond it: -1, or a codeword (a legal miscorrection)."""
        cnt = counts.cpu().numpy()
        ok = cnt <= code.t
        same = (dec._data[:, : code.k] == msg._data).all(dim=1).cpu().numpy()
        if dec.shape != (msg.shape[0], code.n) or not same[ok].all() or not np.array_equal(nerr[ok], cnt[ok]):
            raise AssertionError(f"{label}: rows within the capability did not give back their message and count")
        claimed = ~ok & (nerr >= 0)
        if claimed.any() and code.detect(dec[torch.from_numpy(claimed).to(dev)]).any():
            raise AssertionError(f"{label}: a row beyond the capability decoded to a word that is not a codeword")
        return (
            f"{int(ok.sum())} rows within the capability exact; beyond it {int((nerr[~ok] == -1).sum())} "
            f"rows -1 and {int(claimed.sum())} miscorrected to a codeword"
        )

    def timed_decode(code, label, x, msg, counts, kw, reps, scans, k8_max=None):
        """One decode, checked, with its launches: K8-B ``scans`` times,
        K8-A at least once, K8 at most ``k8_max`` times; then timed."""
        kernels = (gf2m_multiply, gf2m_multiply_swar, gf2m_power, berlekamp_massey_scan)
        before = [fn.launches for fn in kernels]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dec, nerr = code.decode(x, output="codeword", errors=True, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        k7, k8, ka, kb = (fn.launches - b for fn, b in zip(kernels, before))
        # the syndrome field's products: K8 for GF(2^m), m <= 8, else K7
        if (k8 if getattr(code, "extension_field", code.field).degree <= 8 else k7) == 0:
            raise AssertionError(f"{label} did not launch its syndrome field's multiply kernel")
        if kb != scans or ka < 1 or (k8_max is not None and k8 > k8_max):
            raise AssertionError(f"{label}: K8-B {kb} (want {scans}), K8-A {ka} (want >= 1), K8 {k8} (want <= {k8_max})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        result = check_decode(code, label, msg, counts, dec, nerr)
        ms = cuda_ms(lambda: code.decode(x, **kw), reps)
        B = x.shape[0]
        print(
            f"[main] {label}, {B} codewords: {ms:.3f} ms per decode, {B / ms * 1e3:.0f} codewords/s "
            f"(first call {first_s * 1e3:.1f} ms) | K8 {k8}, K7 {k7}, K8-A {ka}, K8-B {kb} launches per decode | "
            f"peak device memory {peak:.2f} GiB | {result}",
            flush=True,
        )
        return ms

    t0 = time.perf_counter()
    rs = gt.ReedSolomon(255, 223)
    bch = gt.BCH(511, 493)
    print(f"[main] RS(255,223) and BCH(511,493) built in {time.perf_counter() - t0:.2f} s", flush=True)
    if (rs.field._meta.irreducible_poly_int, bch.extension_field._meta.irreducible_poly_int) != (0x11D, 529):
        raise AssertionError("RS(255,223) or BCH(511,493) did not pick Matlab's primitive polynomial")

    B = 65536
    msg = rs.field.Random((B, rs.k), generator=gen, device=dev)
    cw = rs.encode(msg)
    torch.cuda.synchronize()
    enc_ms = cuda_ms(lambda: rs.encode(msg), 5)
    if cw.shape != (B, rs.n) or rs.detect(cw).any() or not torch.equal(cw._data[:, : rs.k], msg._data):
        raise AssertionError("RS(255,223) encode did not give systematic codewords")
    print(f"[main] RS(255,223) encode, {B} messages: {enc_ms:.3f} ms, {B / enc_ms * 1e3:.0f} codewords/s", flush=True)
    counts = torch.randint(0, rs.t + 1, (B,), generator=gen, device=dev)
    counts[::16] = 40
    x = rs.field._view(corrupt(cw._data, ranks(B, rs.n, gen) < counts[:, None], 256, gen))
    rs_ms = timed_decode(rs, "RS(255,223) decode", x, msg, counts, {}, 3, scans=1, k8_max=4)

    # the erasure path: f erasures and e errors with 2e + f <= d - 1 = 32,
    # at disjoint positions, garbage under the erasures
    msg2 = rs.field.Random((B, rs.k), generator=gen, device=dev)
    f_cnt = torch.randint(0, rs.d, (B,), generator=gen, device=dev)
    e_cnt = (torch.rand(B, generator=gen, device=dev) * ((rs.d - 1 - f_cnt) // 2 + 1)).long()
    rk = ranks(B, rs.n, gen)
    era = rk < f_cnt[:, None]
    x2 = rs.field._view(corrupt(rs.encode(msg2)._data, rk < (f_cnt + e_cnt)[:, None], 256, gen))
    timed_decode(rs, "RS(255,223) decode with erasures", x2, msg2, e_cnt, {"erasures": era}, 3, scans=1, k8_max=6)
    del msg2, x2, era, rk

    B_b = 16384
    msg_b = bch.field.Random((B_b, bch.k), generator=gen, device=dev)
    cw_b = bch.encode(msg_b)
    torch.cuda.synchronize()
    enc_ms = cuda_ms(lambda: bch.encode(msg_b), 5)
    if bch.detect(cw_b).any() or not torch.equal(cw_b._data[:, : bch.k], msg_b._data):
        raise AssertionError("BCH(511,493) encode did not give systematic codewords")
    print(f"[main] BCH(511,493) encode, {B_b} messages: {enc_ms:.3f} ms, {B_b / enc_ms * 1e3:.0f} codewords/s", flush=True)
    counts_b = torch.randint(0, bch.t + 1, (B_b,), generator=gen, device=dev)
    counts_b[::16] = torch.randint(bch.t + 1, 7, (B_b // 16,), generator=gen, device=dev)
    x_b = bch.field._view(corrupt(cw_b._data, ranks(B_b, bch.n, gen) < counts_b[:, None], 2, gen))
    bch_ms = timed_decode(bch, "BCH(511,493) decode", x_b, msg_b, counts_b, {}, 3, scans=1)

    read_counts(4, (gf2m_multiply_swar, gf2m_multiply, gf2m_power, berlekamp_massey_scan, gf2_linear))

    # diagnostics of main path 4's decodes, after its counts are read, so
    # that their launches are not counted as the main path's. First one RS
    # decode under torch.profiler: where the device time goes
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rs.decode(x)
            torch.cuda.synchronize()
        events = prof.key_averages()
        print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
        groups = {"K8 mul_kernel": 0.0, "K8-A kernels": 0.0, "K8-B bm_scan_kernel": 0.0,
                  "matmul kernels": 0.0, "other kernels": 0.0}
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = e.key.lower()
            key = (
                "K8 mul_kernel" if "::mul_kernel(" in name
                # K8-A: the strided pass, or K5's pass with zero masked (the template's last argument)
                else "K8-A kernels" if "::power_kernel<" in name or ("unary_kernel<2," in name and "true>" in name)
                else "K8-B bm_scan_kernel" if "bm_scan_kernel" in name
                else "matmul kernels" if "gemm" in name or "matmul" in name
                else "other kernels"
            )
            groups[key] += e.self_device_time_total / 1e3
        busy = sum(groups.values())
        print(
            f"[main] RS(255,223) decode, device time by kernel (torch.profiler): "
            + ", ".join(f"{k} {v:.3f} ms ({v / max(busy, 1e-9):.1%})" for k, v in groups.items())
            + f"; device busy {busy:.3f} ms of a {rs_ms:.3f} ms decode (CUDA events)",
            flush=True,
        )
    except Exception as exc:  # a diagnostic: the checks above do not depend on it
        print(f"[main] torch.profiler gave no table: {type(exc).__name__}: {exc}", flush=True)

    # the same decode stage by stage (CUDA events around each Python call,
    # so host time shows where the device waits)
    dec = make_decoder(rs.field._meta, rs.field._mode, rs.field.order, rs.n, rs.n, rs.d, rs.c, int(rs.alpha), False)
    K = dec.consts(dev)
    r = x._data.flip(1)
    S = dec.fmatmul(r, K, "W")
    u = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    C, v = dec.berlekamp_massey(S, u)
    stages = {
        "syndromes (K15)": lambda: dec.fmatmul(r, K, "W"),
        f"Berlekamp-Massey ({dec.nroots} steps, K8-B)": lambda: dec.berlekamp_massey(S, u),
        "Chien (K15)": lambda: dec.fmatmul(C, K, "CH_T"),
        "Chien, Forney and correction": lambda: dec.finish(x._data, r, C, S, C, v, u, 2 * v > dec.nroots),
        f"one reciprocal of ({x.shape[0]}, {rs.n}) (Forney's shape, K8-A)": lambda: dec.ops.reciprocal(r),
        f"conv_trunc's outer product ({x.shape[0]}, {rs.d - 1}, {rs.d}) (K8, operands by stride)":
            lambda: dec.ops.multiply(C[:, None, :], S[:, :, None]),
    }
    print(
        f"[main] RS(255,223) decode by stage, {x.shape[0]} codewords: "
        + "; ".join(f"{name} {cuda_ms(fn, 3):.3f} ms" for name, fn in stages.items()),
        flush=True,
    )
    del dec, K, r, S, u, C, v, stages

    # BCH's decode stage by stage, as RS's above; its scan is K8-B over GF(2^9)
    ext = bch.extension_field
    dec = make_decoder(ext._meta, ext._mode, bch.field.order, bch.n, bch.n, bch.d, bch.c, int(bch.alpha), False)
    K = dec.consts(dev)
    r = x_b._data.flip(1).to(dec.dt)
    S = dec.fmatmul(r, K, "W")
    u = torch.zeros(B_b, dtype=torch.int64, device=dev)
    C, v = dec.berlekamp_massey(S, u)
    stages = {
        "syndromes (K15)": lambda: dec.fmatmul(r, K, "W"),
        f"Berlekamp-Massey ({dec.nroots} steps, K8-B)": lambda: dec.berlekamp_massey(S, u),
        "Berlekamp-Massey by the plain torch loop": lambda: berlekamp_massey_scan_plain(dec.ops, S, u, dec.d),
        "Chien (K15)": lambda: dec.fmatmul(C, K, "CH_T"),
        "Chien, Forney and correction": lambda: dec.finish(x_b._data, r, C, S, C, v, u, 2 * v > dec.nroots),
    }
    print(
        f"[main] BCH(511,493) decode by stage, {B_b} codewords ({bch_ms:.3f} ms a decode): "
        + "; ".join(f"{name} {cuda_ms(fn, 3):.3f} ms" for name, fn in stages.items()),
        flush=True,
    )
    del dec, K, r, S, u, C, v, stages
    del msg, cw, x, msg_b, cw_b, x_b
    torch.cuda.empty_cache()

    # -- 8. main path 5: Poly mul via NTT, np.convolve, the limb NTT, the recursive NTT --
    # sizes are BASELINE.json's: config 3 (a Poly product of degree 2^20 - 2 through
    # the NTT at N = 2^20) and config 5 (the BLS12-381 scalar field's NTT at 2^24, on
    # one device, and the Goldilocks NTT beside it); then the 6-step at N = 2^26,
    # which no two-factor split <= 4096 reaches
    from galois_tpu_torch.ops import _ntt

    for fn in counters:
        fn.launches = 0
    rng = np.random.default_rng(50)

    def deltas(fn_call):
        """Run fn_call, synchronize; return its result and the launches it made."""
        before = {fn.__name__: fn.launches for fn in counters}
        out = fn_call()
        torch.cuda.synchronize()
        return out, {k: fn.launches - before[k] for k, fn in zip(before, counters) if fn.launches > before[k]}

    def poly_at(coeffs_desc, r, p):
        """sum c_k r^k mod p of a descending NumPy coefficient array (np_ladder's powers)."""
        pw = np_ladder(r, len(coeffs_desc), p)
        return int((coeffs_desc[::-1].astype(np.uint64) * pw % np.uint64(p)).sum(dtype=np.uint64)) % p

    F = gt.GF(P)
    alpha = int(F.primitive_element)
    half = 2**19
    fc, gc = rng.integers(0, P, half), rng.integers(0, P, half)
    fc[0] = gc[0] = 1
    f, g = gt.Poly(fc, field=F), gt.Poly(gc, field=F)
    t0 = time.perf_counter()
    h, used = deltas(lambda: f * g)
    first_s = time.perf_counter() - t0
    if h.degree != 2**20 - 2 or not (used.get("plane_matmul_data_right") and used.get("plane_matmul_data_left")):
        raise AssertionError(f"Poly product of degree 2^20 - 2: degree {h.degree}, launches {used}")
    hc = np.asarray(h.coefficients()).astype(np.int64)
    ends = 2**12
    if not (np.array_equal(hc[:ends], np_conv_mod(fc[:ends], gc[:ends], P)[:ends])
            and np.array_equal(hc[-ends:], np_conv_mod(fc[-ends:], gc[-ends:], P)[-ends:])):
        raise AssertionError("Poly product's ends disagree with the NumPy schoolbook product")
    for r in rng.integers(2, P, 4):
        if poly_at(fc, int(r), P) * poly_at(gc, int(r), P) % P != poly_at(hc, int(r), P):
            raise AssertionError(f"Poly product: f(r) g(r) != h(r) at r = {r}")
    ms = cuda_ms(lambda: f * g, 3)
    fa, ga = f.coefficients(), g.coefficients()
    dev_ms = cuda_ms(lambda: np.convolve(fa, ga), 5)
    N = 2**20
    both = torch.zeros((2, N), dtype=torch.int64, device=dev)
    both[0, :half], both[1, :half] = fa._data, ga._data
    XY = _ntt.fft_data(F, both, N)
    stages = {
        "forward NTT batch 2 (K1 + K2)": lambda: _ntt.fft_data(F, both, N),
        "pointwise product": lambda: get_ops(F._meta, F._mode).multiply(XY[0], XY[1]),
        "inverse NTT with 1/N (K1 + K2, scaling)": lambda: _ntt.fft_data(F, XY[0], N, inverse=True),
        "zero padding of both operands": lambda: both.new_zeros((2, N)).narrow(1, 0, half).copy_(both[:, :half]),
        "coefficients to a device array (host)": lambda: f.coefficients(),
    }
    print(
        f"[main] Poly product, degree 2^19 - 1 x 2^19 - 1 over GF(3*2^30+1) (NTT at N = 2^20): {ms:.3f} ms per "
        f"product through Poly (host coefficients included; first call {first_s * 1e3:.1f} ms with the plans), "
        f"{dev_ms:.3f} ms per np.convolve of the device coefficient arrays | launches per product {used} | by stage: "
        + "; ".join(f"{k} {cuda_ms(fn, 5):.3f} ms" for k, fn in stages.items()),
        flush=True,
    )
    del h, hc, fa, ga, both, XY

    ac, bc = rng.integers(0, P, 768), rng.integers(0, P, 256)
    ac[0] = bc[0] = 7
    a_p, b_p = gt.Poly(ac, field=F), gt.Poly(bc, field=F)
    (q, r), used = deltas(lambda: divmod(a_p, b_p))
    qc, rc = (np.asarray(v.coefficients()).astype(np.int64) for v in (q, r))
    for x0 in rng.integers(2, P, 4):
        x0 = int(x0)
        if (poly_at(qc, x0, P) * poly_at(bc, x0, P) + poly_at(rc, x0, P)) % P != poly_at(ac, x0, P):
            raise AssertionError(f"divmod: q b + r != a at {x0}")
    div_ms = cuda_ms(lambda: divmod(a_p, b_p), 3)
    mc = rng.integers(0, P, 513)
    mc[0] = 1
    m_p = gt.Poly(mc, field=F)
    e = 2**10 + 3
    (w, pow_used) = deltas(lambda: pow(a_p, e, m_p))
    want = np_powmod(np_polymod(ac, mc, P), e, mc, P)
    if not np.array_equal(np.asarray(w.coefficients(size=512)).astype(np.int64), want):
        raise AssertionError("pow(a, e, m) disagrees with the NumPy square-and-multiply")
    pow_ms = cuda_ms(lambda: pow(a_p, e, m_p), 1)
    print(
        f"[main] Poly divmod, degree 767 by 255 over GF(3*2^30+1) (513 x 256 >= 2^17: the device division): "
        f"{div_ms:.3f} ms, launches {used} | pow(a, 2^10 + 3, m), deg m = 512: {pow_ms:.3f} ms, launches {pow_used}",
        flush=True,
    )

    # np.convolve at 2^12 x 2^12 taps, held on its 64 lowest and highest coefficients
    taps = 2**12
    for q_f, need, label in (
        (2**8, gf2m_multiply_swar, "GF(2^8)"), (2**16, gf2m_multiply, "GF(2^16)"),
        (M31, m31_multiply, "GF(2^31-1)"), (GOLDILOCKS, goldilocks_multiply, "Goldilocks"),
    ):
        Fq = gt.GF(q_f)
        u, v = Fq.Random(taps, seed=60, device=dev), Fq.Random(taps, seed=61, device=dev)
        t0 = time.perf_counter()
        c, used = deltas(lambda: np.convolve(u, v))
        first_s = time.perf_counter() - t0
        if c.shape != (2 * taps - 1,) or c.device != dev or not used.get(need.__name__):
            raise AssertionError(f"np.convolve over {label}: shape {c.shape}, launches {used}")
        us, vs, cs = ints(u), ints(v), ints(c)
        for k_range in (range(64), range(2 * taps - 65, 2 * taps - 1)):
            for k in k_range:
                lo, hi_ = max(0, k - taps + 1), min(k, taps - 1)
                if q_f in (2**8, 2**16):
                    m_deg = 8 if q_f == 2**8 else 16
                    f_red = f8 if q_f == 2**8 else 0x1002D
                    terms = np_gf2m_multiply(np.array(us[lo : hi_ + 1]), np.array(vs[k - hi_ : k - lo + 1][::-1]), m_deg, f_red)
                    want_k = int(np.bitwise_xor.reduce(terms))
                else:
                    want_k = sum(us[i] * vs[k - i] for i in range(lo, hi_ + 1)) % q_f
                if cs[k] != want_k:
                    raise AssertionError(f"np.convolve over {label} disagrees with the schoolbook product at {k}")
        ms = cuda_ms(lambda: np.convolve(u, v), 3)
        print(
            f"[main] np.convolve over {label}, {taps} x {taps} taps: {ms:.3f} ms (first call {first_s * 1e3:.1f} ms) | "
            f"launches per product {used}",
            flush=True,
        )
        del u, v, c
    torch.cuda.empty_cache()

    # config 5 on one device: the BLS12-381 scalar field's and Goldilocks' NTT at 2^24
    for p_f, label in ((BLS_R, "BLS12-381 r"), (GOLDILOCKS, "Goldilocks")):
        Fq = gt.GF(p_f)
        x12 = Fq.Random(2**12, seed=70, device=dev)
        X12 = np.fft.fft(x12)
        om12 = _ntt._get_omega(Fq, 2**12)
        xs12 = ints(x12)
        bins = [0, 1, 2, 3, 5, 2**11, 2**12 - 1] + [int(k) for k in rng.integers(0, 2**12, 9)]
        Xs12 = ints(X12)
        for k in bins:
            wk, acc = pow(om12, k, p_f), 0
            for n_i in range(2**12 - 1, -1, -1):  # Horner in w^k
                acc = (acc * wk + xs12[n_i]) % p_f
            if Xs12[k] != acc:
                raise AssertionError(f"{label} NTT at 2^12 disagrees with the direct DFT at bin {k}")
        if not torch.equal(np.fft.ifft(X12)._data, x12._data):
            raise AssertionError(f"{label} NTT at 2^12 does not round-trip")
        del x12, X12
        N = 2**24
        x = Fq.Random(N, seed=71, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plan = _ntt._plan(Fq._meta, N, _ntt._get_omega(Fq, N), Fq._mode, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        X, used = deltas(lambda: np.fft.fft(x))
        xb, used_inv = deltas(lambda: np.fft.ifft(X))
        if X.shape != (N,) or X.device != dev or not torch.equal(xb._data, x._data):
            raise AssertionError(f"{label} NTT at 2^24 does not round-trip")
        if p_f == GOLDILOCKS and not used.get("goldilocks_multiply"):
            raise AssertionError(f"{label} NTT at 2^24 did not launch K10: {used}")
        del xb
        ms = cuda_ms(lambda: np.fft.fft(x), 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        sides = {
            "side 1 limb matmul": lambda: _ntt.limb_matmul(Fq._meta, plan.w1, x._data.reshape(-1, plan.n1, plan.n2)),
            "twiddle multiply": lambda: _ntt._multiply_chunked(plan.ops, x._data.reshape(-1, plan.n1, plan.n2), plan.t),
        }
        print(
            f"[main] {label} NTT N=2^24 batch 1 ({plan.n1} x {plan.n2}, {Fq._meta.storage_width} limbs): plan build "
            f"{build_s:.2f} s, {ms:.1f} ms per forward transform, peak device memory {peak:.2f} GiB | launches "
            f"forward {used}, inverse {used_inv} | "
            + "; ".join(f"{k} {cuda_ms(fn, 1):.1f} ms" for k, fn in sides.items()),
            flush=True,
        )
        if p_f == BLS_R:
            # the int8 product of the middle diagonal of one output chunk, 32 digit pairs
            # side by side (K = 32 x 2048), as _limb_matmul runs it (B K-major), with B
            # row-major beside it
            from galois_tpu_torch.ops import _limb_matmul

            nc = _limb_matmul._chunk_columns(_limb_matmul._bytes_per_column(4096, 63, 34, 16))
            ga = torch.randint(-128, 128, (4096, 32 * 2048), generator=gen, device=dev, dtype=torch.int8)
            gbt = torch.randint(-128, 128, (nc, 32 * 2048), generator=gen, device=dev, dtype=torch.int8)
            gb = gbt.t().contiguous()
            km_ms = cuda_ms(lambda: torch._int_mm(ga, gbt.t()), 10)
            rm_ms = cuda_ms(lambda: torch._int_mm(ga, gb), 10)
            gemm_bnd = bound(0, 2 * 4096 * 32 * 2048 * nc)[0]
            print(
                f"[main] {label} side's middle-diagonal int8 product, (4096, {32 * 2048}) @ ({32 * 2048}, {nc}): "
                f"{km_ms:.3f} ms with B K-major ({gemm_bnd / km_ms:.1%} of the int8 peak), {rm_ms:.3f} ms with B "
                f"row-major | 63 diagonals x 2 K blocks x {-(-4096 // nc)} output chunks a side",
                flush=True,
            )
            del ga, gbt, gb
            # where a transform's device time goes: the int8 GEMMs against the rest
            try:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    np.fft.fft(x)
                    torch.cuda.synchronize()
                groups = {"int8 GEMM (torch._int_mm)": 0.0, "other kernels": 0.0}
                for ev in prof.key_averages():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        name = ev.key.lower()
                        key = "int8 GEMM (torch._int_mm)" if ("gemm" in name or "imma" in name or "i8" in name) else "other kernels"
                        groups[key] += ev.self_device_time_total / 1e3
                busy = sum(groups.values())
                print(
                    f"[main] {label} NTT N=2^24, device time by kernel (torch.profiler): "
                    + ", ".join(f"{k} {v:.1f} ms ({v / max(busy, 1e-9):.1%})" for k, v in groups.items())
                    + f"; device busy {busy:.1f} ms of a {ms:.1f} ms transform",
                    flush=True,
                )
            except Exception as exc:  # a diagnostic: the checks above do not depend on it
                print(f"[main] torch.profiler gave no table: {type(exc).__name__}: {exc}", flush=True)
        del x, X, plan
        _ntt._plan.cache_clear()
        torch.cuda.empty_cache()

    # the recursive 6-step: GF(3*2^30+1) at N = 2^26 = 4096 x 16384, the second
    # side a 128 x 128 sub-plan
    N = 2**26
    x = F.Random(N, seed=80, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = _ntt._plan(F._meta, N, _ntt._get_omega(F, N), F._mode, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if (plan.n1, plan.n2) != (4096, 16384) or plan.sub2 is None or (plan.sub2.n1, plan.sub2.n2) != (128, 128):
        raise AssertionError("the 2^26 plan is not 4096 x (128 x 128)")
    X, used = deltas(lambda: np.fft.fft(x))
    leaves = plan.sub2.kernel_sides and used.get("plane_matmul_data_right", 0) >= 2 and used.get("plane_matmul_data_left")
    if not leaves:
        raise AssertionError(f"the 2^26 NTT did not launch K1/K2 in its leaves: {used}")
    if not torch.equal(np.fft.ifft(X)._data, x._data):
        raise AssertionError("the 2^26 NTT does not round-trip")
    bins = [0, 1, 2, 3, 5, N // 2, N - 1] + [int(k) for k in rng.integers(0, N, 9)]
    if not np.array_equal(np.asarray(X._data[bins].cpu()), direct_dft_bins(np.asarray(x._data.cpu()), bins, P, alpha)):
        raise AssertionError("the 2^26 NTT disagrees with the direct DFT")
    ms = cuda_ms(lambda: np.fft.fft(x), 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"[main] NTT N=2^26 batch 1 over GF(3*2^30+1) (4096 x (128 x 128), recursive): plan build {build_s:.2f} s, "
        f"{ms:.3f} ms per forward transform, peak device memory {peak:.2f} GiB | launches per transform {used}",
        flush=True,
    )
    del x, X, plan
    _ntt._plan.cache_clear()
    torch.cuda.empty_cache()
    read_counts(5, (plane_matmul_data_right, plane_matmul_data_left, gf2m_multiply_swar, gf2m_multiply,
                    m31_multiply, goldilocks_multiply, goldilocks_combine))

    # -- 9. main path 6: linear algebra over GF(q) on the card ------------------
    for fn in counters:
        fn.launches = 0

    def timed(call):
        """One call: its result, ms (CUDA events around it), launches by wrapper, peak MiB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out, used = deltas(call)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), used, torch.cuda.max_memory_allocated() / 2**20

    linalg_path(gt, dev, timed)
    read_counts(6, (gf2m_multiply_swar, gf2m_power, _lookup.lookup_multiply, _lookup.lookup_reciprocal,
                    gf2m_multiply, m31_multiply, goldilocks_multiply))

    # -- 10. main path 7: the field's element functions at 2^24 ----------------
    for fn in counters:
        fn.launches = 0
    elements_path(gt, dev, timed)
    read_counts(7, (_lookup.lookup_log, gf2m_multiply, gf2m_multiply_swar, gf2m_power, m31_multiply,
                    goldilocks_multiply))

    # -- 11. main path 8: GF(2^m > 32), digit fields, LFSRs and Berlekamp-Massey
    for fn in counters:
        fn.launches = 0
    lfsr_path(gt, dev, timed, smi)
    read_counts(8, (lfsr_step, berlekamp_massey_long, gf2_limb_multiply, gf2_limb_power))

    # -- 12. main path 9: assignment, the ufunc methods, pickling, python-calculate, reprs
    for fn in counters:
        fn.launches = 0
    api_path(gt, dev, timed, smi)
    read_counts(9, (gf2m_multiply_swar, gf2m_multiply, m31_multiply, goldilocks_multiply, gf2_limb_multiply,
                    _lookup.lookup_multiply))

    # -- 13. main path 10: parallel/ on torch.distributed, NCCL at one rank and gloo ranks on the card
    parallel_path(gt, dev, smi, counters, read_counts)

    # -- 14. main path 11: CUDA-graph capture where the JAX package runs under jax.jit; strings, seeded
    # Random and ordering comparisons on the card
    for fn in counters:
        fn.launches = 0
    capture_path(gt, dev, smi)
    read_counts(11, (gf2m_multiply_swar, gf2m_power, _lookup.lookup_multiply, _lookup.lookup_divide,
                     _lookup.lookup_reciprocal, _lookup.lookup_log, m31_multiply, goldilocks_multiply,
                     gf2_limb_multiply, gf2_limb_power))

    sources = {
        "plane_matmul_data_right": ("cuda", "galois_tpu_torch/csrc/plane_matmul.cu", "galois_tpu/ops/_pallas/_plane_matmul.py:323"),
        "plane_matmul_data_left": ("cuda", "galois_tpu_torch/csrc/plane_matmul.cu", "galois_tpu/ops/_pallas/_plane_matmul.py:261"),
        "gf2m_multiply": ("triton", "galois_tpu_torch/ops/_elementwise.py", "galois_tpu/ops/_pallas/_elementwise.py:493"),
        "gf2m_multiply_swar": ("cuda", "galois_tpu_torch/csrc/gf2m_swar.cu", "galois_tpu/ops/_pallas/_elementwise.py:447"),
        # K8-A and K8-B: K8 redesigned for the decoder, its core run across whole chains
        "gf2m_power": ("cuda", "galois_tpu_torch/csrc/gf2m_chain.cu", "galois_tpu/ops/_pallas/_elementwise.py:447"),
        "berlekamp_massey_scan": ("cuda", "galois_tpu_torch/csrc/gf2m_chain.cu", "galois_tpu/ops/_pallas/_elementwise.py:447"),
        "lookup_multiply": ("cuda", "galois_tpu_torch/csrc/lookup.cu", "galois_tpu/ops/_pallas/_elementwise.py:324"),
        "lookup_divide": ("cuda", "galois_tpu_torch/csrc/lookup.cu", "galois_tpu/ops/_pallas/_elementwise.py:341"),
        "lookup_reciprocal": ("cuda", "galois_tpu_torch/csrc/lookup.cu", "galois_tpu/ops/_pallas/_elementwise.py:358"),
        "lookup_log": ("cuda", "galois_tpu_torch/csrc/lookup.cu", "galois_tpu/ops/_pallas/_elementwise.py:372"),
        "m31_multiply": ("cuda", "galois_tpu_torch/csrc/prime_mul.cu", "galois_tpu/ops/_pallas/_elementwise.py:89"),
        "goldilocks_multiply": ("cuda", "galois_tpu_torch/csrc/prime_mul.cu", "galois_tpu/ops/_pallas/_elementwise.py:186"),
        "device_probe": ("cuda", "galois_tpu_torch/csrc/probe.cu", "galois_tpu/ops/_pallas/_elementwise.py:73"),
        # K12-K14: no Pallas kernel behind them; each replaces a JAX lax.scan
        "lfsr_step": ("cuda", "galois_tpu_torch/csrc/lfsr.cu", "galois_tpu/lfsr.py:63"),
        "berlekamp_massey_long": ("cuda", "galois_tpu_torch/csrc/lfsr.cu", "galois_tpu/lfsr.py:281"),
        "gf2_limb_multiply": ("cuda", "galois_tpu_torch/csrc/gf2_limb.cu", "galois_tpu/ops/_kernels.py:1345"),
        "gf2_limb_power": ("cuda", "galois_tpu_torch/csrc/gf2_limb.cu", "galois_tpu/ops/_kernels.py:1345"),
        # K15: no Pallas kernel behind it; it replaces the decoder's jnp.matmul of bit planes
        "gf2_linear": ("cuda", "galois_tpu_torch/csrc/gf2_linear.cu", "galois_tpu/ops/_binary_matmul.py:75"),
        # K16: no Pallas kernel behind it; it replaces the jnp combine of the Goldilocks limb matmul
        "goldilocks_combine": ("cuda", "galois_tpu_torch/csrc/gold_combine.cu", "galois_tpu/ops/_limb_matmul.py:101"),
    }
    kernels = [
        {"name": name, "route": route, "source": src, "replaces": rep, "launches": launches[name], **report[name]}
        for name, (route, src, rep) in sources.items()
    ]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
