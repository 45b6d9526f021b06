#!/usr/bin/env python3
"""Drive galois_tpu_torch's main path once on one CUDA card, and check it.

Run from the repository root on a machine with one NVIDIA GPU (Hopper,
sm_90a), the CUDA toolkit and Triton:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles the CUDA C++ kernels from csrc/ with nvcc and the
     Triton kernel, and prints the build times and ptxas resource usage;
  3. kernels: K1, K2 and K7 against their plain torch versions on the card,
     at the main path's shapes plus a small and a ragged one; results must
     be exactly equal; prints CUDA-event times of kernel and plain version;
  4. main path, through the public API with every launch counter reset to
     0 first: GF(2^8) multiply of 2^24 elements, then np.fft.fft / ifft and
     ntt / intt over GF(3*2^30+1) at N = 2^20 (batch 32) and N = 2^24
     (batch 4), with round trips and 16 bins against a direct DFT in NumPy;
     every kernel must have been launched by this phase.
The line before the last is one JSON object with the kernels' routes,
sources, launch counts, errors and times; the last line is the JSON
device summary. Exits non-zero without a card or without the package.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

P = 3 * 2**30 + 1


def cuda_ms(fn, reps):
    """Mean CUDA-event time of fn() over reps runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available.", file=sys.stderr)
        return 1

    import galois_tpu_torch as gt
    from galois_tpu_torch import _build
    from galois_tpu_torch.ops._elementwise import gf2m_multiply, gf2m_multiply_plain
    from galois_tpu_torch.ops._linalg import balanced_planes_np
    from galois_tpu_torch.ops._plane_matmul import (
        plane_matmul_data_left,
        plane_matmul_data_left_plain,
        plane_matmul_data_right,
        plane_matmul_data_right_plain,
    )

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("plane_matmul")
    print(f"[build] nvcc plane_matmul.cu: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.BUILD_LOGS.get("plane_matmul", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")
    GF8 = gt.GF(2**8)
    f8 = GF8._meta.irreducible_poly_int
    t0 = time.perf_counter()
    probe = torch.arange(256, dtype=torch.uint8, device=dev)
    gf2m_multiply(probe, probe, 8, f8)
    torch.cuda.synchronize()
    print(f"[build] triton gf2m_multiply (first launch): {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernels against their plain versions -------------------------
    report = {}

    def record(name, err, ms=None, plain_ms=None):
        r = report.setdefault(name, {"max_abs_err": 0, "ms": None, "plain_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    a8 = torch.randint(0, 256, (2**24,), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
    b8 = torch.randint(0, 256, (2**24,), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
    got = gf2m_multiply(a8, b8, 8, f8)
    torch.cuda.synchronize()
    want = gf2m_multiply_plain(a8, b8, 8, f8)
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: gf2m_multiply(a8, b8, 8, f8), 50)
    pms = cuda_ms(lambda: gf2m_multiply_plain(a8, b8, 8, f8), 10)
    record("gf2m_multiply", err, ms, pms)
    print(f"[kernel] K7 gf2m_multiply m=8 n=2^24: max_abs_err {err} | kernel {ms:.4f} ms | plain {pms:.4f} ms", flush=True)
    if err:
        raise AssertionError("K7 disagrees with its plain version")

    rng = np.random.default_rng(1)
    shapes = [  # (M, K, N, batch, reps); None reps: check only
        (1024, 1024, 1024, 2, None),
        (300, 520, 200, 3, None),
        (1024, 1024, 1024, 32, 5),  # NTT 2^20 sides
        (4096, 4096, 4096, 4, 2),  # NTT 2^24 sides
    ]
    for M, K, N, B, reps in shapes:
        A = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (M, K)), P)).to(dev)
        W = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (K, N)), P)).to(dev)
        T = torch.from_numpy(rng.integers(0, P, (M, N))).to(dev)
        xr = torch.randint(0, P, (B, K, N), generator=gen, device=dev)
        xl = torch.randint(0, P, (B, M, K), generator=gen, device=dev)
        tag = f"{M}x{K}x{N} batch {B}"

        got = plane_matmul_data_right(A, xr, P, twiddle=T)
        torch.cuda.synchronize()
        err = max_abs_err(got, plane_matmul_data_right_plain(A, xr, P, T))
        del got
        got = plane_matmul_data_right(A, xr, P)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, plane_matmul_data_right_plain(A, xr, P)))
        del got
        timing = ""
        if reps:
            ms = cuda_ms(lambda: plane_matmul_data_right(A, xr, P, twiddle=T), reps)
            pms = cuda_ms(lambda: plane_matmul_data_right_plain(A, xr, P, T), reps)
            record("plane_matmul_data_right", err, ms, pms)
            timing = f" | kernel {ms:.3f} ms | plain {pms:.3f} ms"
        else:
            record("plane_matmul_data_right", err)
        print(f"[kernel] K1 data_right(+twiddle) {tag}: max_abs_err {err}{timing}", flush=True)
        if err:
            raise AssertionError("K1 disagrees with its plain version")

        got = plane_matmul_data_left(xl, W, P, transpose_out=True)
        torch.cuda.synchronize()
        err = max_abs_err(got, plane_matmul_data_left_plain(xl, W, P, True))
        del got
        got = plane_matmul_data_left(xl, W, P)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, plane_matmul_data_left_plain(xl, W, P)))
        del got
        timing = ""
        if reps:
            ms = cuda_ms(lambda: plane_matmul_data_left(xl, W, P, transpose_out=True), reps)
            pms = cuda_ms(lambda: plane_matmul_data_left_plain(xl, W, P, True), reps)
            record("plane_matmul_data_left", err, ms, pms)
            timing = f" | kernel {ms:.3f} ms | plain {pms:.3f} ms"
        else:
            record("plane_matmul_data_left", err)
        print(f"[kernel] K2 data_left(+transpose) {tag}: max_abs_err {err}{timing}", flush=True)
        if err:
            raise AssertionError("K2 disagrees with its plain version")
        del A, W, T, xr, xl
        torch.cuda.empty_cache()

    # -- 4. main path through the public API -----------------------------
    counters = (gf2m_multiply, plane_matmul_data_right, plane_matmul_data_left)
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
        Y = gt.ntt(x)
        if not torch.equal(Y._data, X._data) or not torch.equal(gt.intt(Y)._data, x._data):
            raise AssertionError(f"intt(ntt(x)) != x or ntt != np.fft.fft at N = 2^{log_n}")
        bins = [0, 1, 2, 3, 5, N // 2, N - 1] + [int(k) for k in np.random.default_rng(log_n).integers(0, N, 9)]
        want = direct_dft_bins(np.asarray(x[batch - 1]).astype(np.int64), bins, P, alpha)
        got = np.asarray(X[batch - 1]).astype(np.int64)[bins]
        if not np.array_equal(got, want):
            raise AssertionError(f"NTT bins disagree with the direct DFT at N = 2^{log_n}")
        ms = cuda_ms(lambda: np.fft.fft(x), reps)
        print(
            f"[main] NTT N=2^{log_n} batch {batch}: {ms:.3f} ms per batched forward transform, "
            f"{batch * 1e3 / ms:.2f} transforms/s (plans built and first round trip {first_s:.1f} s)",
            flush=True,
        )
        del x, X, xb, Y
        torch.cuda.empty_cache()

    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[main] launches during the main path: {launches}", flush=True)
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

    sources = {
        "plane_matmul_data_right": ("cuda", "galois_tpu_torch/csrc/plane_matmul.cu", "galois_tpu/ops/_pallas/_plane_matmul.py:323"),
        "plane_matmul_data_left": ("cuda", "galois_tpu_torch/csrc/plane_matmul.cu", "galois_tpu/ops/_pallas/_plane_matmul.py:261"),
        "gf2m_multiply": ("triton", "galois_tpu_torch/ops/_elementwise.py", "galois_tpu/ops/_pallas/_elementwise.py:493"),
    }
    kernels = [
        {"name": name, "route": route, "source": src, "replaces": rep, "launches": launches[name], **report[name]}
        for name, (route, src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
