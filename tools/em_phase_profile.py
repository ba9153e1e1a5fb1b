#!/usr/bin/env python3
"""Where kernel 15 (the fused CGMM/CACGMM EM) spends its cycles.

    python3 tools/em_phase_profile.py [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/cacgmm_em.cu
with -DSETK_EM_PHASES (the shipped build carries no counters) into the
build directory: lane 0 of every warp reads clock64() at the kernel's
phase boundaries and adds each phase's SM cycles into a device counter.
It runs cgmm with the Higuchi init at the bench shape (B = 128 x 257 bins,
6 mics, the 512-frame bucket, 20 iterations) and at WPD's (B = 32, T =
251, 10 iterations) and prints one JSON line per run with a warp's
cycles by phase (the mean over warps; a warp holds the bins
cacgmm_em_layout gives):

  frame_pass   the passes over z: the E-step's quadratic forms and
               posterior with the next M-step's sums, the Higuchi init's
               sample covariance, the operands' first M-step
  sum_lanes    the sums over the warp's lanes through the transpose tile
  jacobi       the floored inverses, a lane group a class, laid out for
               the E-step
  other        the frame mask's sum, the M-step's scaling into the
               Jacobi's input, alpha and the covariance output

beside their shares, the instrumented and the shipped build's ms a call
(CUDA events), the warps in flight an SM on average (every warp's cycles
over the SMs' cycles in the shipped call), the instrumented output's
largest error against the plain version, and the card's SM clock.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ["frame_pass", "sum_lanes", "jacobi", "other"]
# (label, B, T, iterations, frame mask): the bench bucket and WPD's shape
SHAPES = [("bench_B128_T512", 128, 512, 20, True),
          ("wpd_B32_T251", 32, 251, 10, False)]


def _time_ms(torch, fn, iters=3, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    beg = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    beg.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return beg.elapsed_time(end) / iters


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("em_phase_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from setk_tpu_torch.ops.cuda import _build
    from setk_tpu_torch.ops.cuda import cacgmm_em as ce
    from setk_tpu_torch.ops.cuda.lstm_seq import device_limits

    smi = _smi("name,power.limit")
    print(smi)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "libcacgmm_em_phases.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-DSETK_EM_PHASES",
                           "-o", str(lib_path),
                           str(_build.SOURCE_DIR / "cacgmm_em.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    fn = "cacgmm_em_launch"
    for name, argtypes in _build._SIGNATURES["cacgmm_em"].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.em_phase_read.argtypes = [ctypes.c_void_p]
    lib.em_phase_read.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    sms = device_limits(dev)[0]
    gen = torch.Generator(device=dev)
    lines = []
    for label, b, t, iters, masked in SHAPES:
        f, m, k = 257, 6, 2
        gen.manual_seed(b + t)
        obs = torch.complex(
            torch.randn((b, f, m, t), generator=gen, device=dev),
            torch.randn((b, f, m, t), generator=gen, device=dev))
        obs[:, :, 1:] += 0.5 * obs[:, :, :1]
        fm = None
        if masked:
            fm = torch.ones((b, 1, t), device=dev)
            fm[b // 2:, 0, 501:] = 0.0   # a bucket's padded frames
        nb = b * f
        gamma = torch.empty((k, nb, t), device=dev)
        kern = torch.empty_like(gamma)
        q = torch.empty((iters, nb), device=dev)
        covar = torch.empty((k, nb, m, m), dtype=torch.complex64, device=dev)
        alpha = torch.empty((k, nb), device=dev)
        strides = (0, 0, 0) if fm is None else fm.expand(b, f, t).stride()
        ref = ce.em_plain(obs, None, None, iters, "cg", False, frame_mask=fm,
                          init="higuchi")[0]
        layout = (ctypes.c_int * 3)()
        _build.check(lib.cacgmm_em_layout(m, k, ctypes.addressof(layout)),
                     "cacgmm_em_layout")
        bins, lanes, smem = layout
        warps = -(-nb // bins)

        def run_phases():
            _build.check(getattr(lib, fn)(
                obs.data_ptr(), None if fm is None else fm.data_ptr(),
                *strides, None, None, gamma.data_ptr(), kern.data_ptr(),
                q.data_ptr(), covar.data_ptr(), alpha.data_ptr(), nb, f, t,
                m, k, iters, 1, 1, 0, ce.SWEEPS,
                torch.cuda.current_stream().cuda_stream),
                "instrumented kernel 15")

        cycles = (ctypes.c_ulonglong * 4)()
        _build.check(lib.em_phase_read(ctypes.addressof(cycles)),
                     "em_phase_read")   # zero the counters
        run_phases()
        torch.cuda.synchronize()
        _build.check(lib.em_phase_read(ctypes.addressof(cycles)),
                     "em_phase_read")
        per_warp = [c / warps for c in cycles]
        total = sum(per_warp)
        err = float((gamma.reshape(k, b, f, t) - ref).abs().max())
        kernel_ms = _time_ms(torch, lambda: ce.em(
            obs, None, None, iters, "cg", False, frame_mask=fm,
            init="higuchi"))
        clock = _smi("clocks.sm")
        mhz = float(clock.split()[0])
        line = {"kernel": 15, "shape": label, "B": b, "T": t, "iters": iters,
                "bins_a_warp": bins, "lanes_a_class": lanes,
                "smem_bytes": smem, "warps": warps,
                "warp_cycles": dict(zip(PHASES, per_warp)),
                "share": {p: c / total for p, c in zip(PHASES, per_warp)},
                "instrumented_ms": _time_ms(torch, run_phases),
                "kernel_ms": kernel_ms,
                "warps_in_flight_per_sm": total * warps / (
                    sms * kernel_ms * 1e-3 * mhz * 1e6),
                "gamma_max_abs_err": err, "sm_clock": clock, "card": smi}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
