#!/usr/bin/env python3
"""Where a step of kernels 20 and 21's resident variants spends its time.

    python3 tools/lstm_phase_profile.py [--out FILE]

Needs one CUDA card and nvcc.  It copies setk_tpu_torch/csrc/lstm_seq.cu,
inserts clock64() readings at the resident kernels' phase boundaries
(block 0, thread 0, each reading taken just after the block barrier that
closes a phase), builds the copy with the port's nvcc flags into the
build directory, and runs it at T = 400 over the shapes below, printing
one JSON line per shape and kernel.  Kernel 20: SM cycles a step spent in

  load_h          reading the previous h from L2 into the shared tile,
                  rounded, with the step's first gate inputs issued
  product         the tile's recurrent product on the CUDA cores
  store_partials  the k shares' partial sums into shared memory
  sum_shares      adding the shares (next to nothing when a share is
                  the whole of k; the first step's reading also holds the
                  W_h slice's copy into shared memory, over T)
  gate_math       the gate math and the h, c writes
  grid_sync       the L2 prefetch of the next step's gates and the grid
                  barrier, with the wait for the slowest block

Kernel 21: the SM cycles of phase 1 in all (the column slice's copy, the
gate recompute of every frame, the row slice's copy), then a step's

  read_dgates     the chain inputs issued and the previous step's rounded
                  dgates read from the exchange into the shared tile (every
                  chunk)
  product         dh's product over the chunks on the CUDA cores
  sum_shares      the column shares' partial sums stored and added
  chain           the gate chain and the dxg and exchange writes (all of
                  step 0, which has no product)
  grid_sync       the L2 prefetch of the next step's inputs and the grid
                  barrier, with the wait for the slowest block

beside the instrumented and the port's own build's ms a call (CUDA
events), the instrumented output's largest error against the plain
version over its peak, and the card's SM clock.  Block 0 owns units
0 .. u - 1 of the forward direction; every busy block does the same work.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (T, B, H, W_h's type): the floor, B = 1 and 8, the bench shape in bf16
# and f32, H = 1024 (three h tiles) and B = 128 (two)
SHAPES = [(400, 1, 8, "bfloat16"), (400, 1, 512, "bfloat16"),
          (400, 8, 512, "bfloat16"), (400, 64, 512, "bfloat16"),
          (400, 64, 512, "float32"), (400, 64, 1024, "bfloat16"),
          (400, 128, 512, "bfloat16")]
PHASES = ["load_h", "product", "store_partials", "sum_shares", "gate_math",
          "grid_sync"]
BWD_PHASES = ["phase1", "read_dgates", "product", "sum_shares", "chain",
              "grid_sync"]
# (line that closes a phase, phase index): the reading goes after the
# first occurrence, which is kernel 20's
MARKS = [
    ("                       rows, h);\n        __syncthreads();\n", 0),
    ("        __syncthreads();   // every thread has read the tile\n", 1),
    ("        if (ks < split) store_partials(acc, hs, slots, na);\n"
     "        __syncthreads();\n", 2),
    ("          sum_shares(hs, slots, items, na, split);\n"
     "          __syncthreads();\n        }\n      }\n", 3),
    ("      __syncthreads();   // the tile's space is free for the next"
     " tile\n", 4),
    ("    grid.sync();   // h_t and c_t of every block before step s + 1"
     " reads\n", 5),
]
# kernel 21's, each unique in the source
BWD_MARKS = [
    ("    __syncthreads();   // phase 1's gates and the slice in place\n", 0),
    ("          __syncthreads();   // the chunk in place\n", 1),
    ("          __syncthreads();   // every thread has read the chunk\n", 2),
    ("        __syncthreads();   // dh of the tile's pairs in place\n", 3),
    ("      __syncthreads();   // the tile's dxg and dgates written\n", 4),
    ("    grid.sync();   // dgates of every block before step s + 1 reads"
     " them\n", 5),
]
BWD_START = ("  float* part = reinterpret_cast<float*>(tile);   // partial "
             "sums, both phases\n")


def _mark(acc, last, i):
    return (f"if (blockIdx.x == 0 && threadIdx.x == 0) {{ "
            f"long long q_ = clock64(); {acc}[{i}] += q_ - {last}; "
            f"{last} = q_; }}\n")


def _insert(text, old, new):
    if old not in text:
        raise SystemExit(f"lstm_phase_profile: the kernel no longer has "
                         f"{old!r}; update MARKS")
    return text.replace(old, new, 1)


def _store(acc, sym, last_line):
    """Block 0's readings into ``sym`` at the kernel's end."""
    return (last_line + _mark(acc, acc + "_t", 5) + "  }\n  if (blockIdx.x "
            f"== 0 && threadIdx.x == 0)\n    for (int i = 0; i < 6; ++i) "
            f"{sym}[i] = {acc}[i];\n}}\n")


def _instrumented(src: str) -> str:
    src = _insert(src, "namespace {\n",
                  "namespace {\n__device__ unsigned long long g_prof[6];\n"
                  "__device__ unsigned long long g_prof_bwd[6];\n")
    # kernel 20
    src = _insert(
        src, "  cooperative_groups::grid_group grid = "
        "cooperative_groups::this_grid();\n",
        "  cooperative_groups::grid_group grid = "
        "cooperative_groups::this_grid();\n"
        "  long long pf[6] = {0, 0, 0, 0, 0, 0};\n"
        "  long long pf_t = clock64();\n")
    for line, i in MARKS:
        src = _insert(src, line, line + _mark("pf", "pf_t", i))
    src = _insert(src, MARKS[5][0] + _mark("pf", "pf_t", 5) + "  }\n}\n",
                  _store("pf", "g_prof", MARKS[5][0]))
    # kernel 21
    src = _insert(src, BWD_START, BWD_START +
                  "  long long pb[6] = {0, 0, 0, 0, 0, 0};\n"
                  "  long long pb_t = clock64();\n")
    for line, i in BWD_MARKS:
        src = _insert(src, line, line + _mark("pb", "pb_t", i))
    src = _insert(src, BWD_MARKS[5][0] + _mark("pb", "pb_t", 5) + "  }\n}\n",
                  _store("pb", "g_prof_bwd", BWD_MARKS[5][0]))
    return src + (
        '\nextern "C" int lstm_phase_read(unsigned long long* out) {\n'
        '  int err = cudaMemcpyFromSymbol(out, g_prof, 6 * 8);\n'
        '  if (err != cudaSuccess) return err;\n'
        '  return cudaMemcpyFromSymbol(out + 6, g_prof_bwd, 6 * 8);\n}\n')


def _time_ms(torch, fn, iters=5, warmup=2):
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


def _err(got, ref):
    return max(float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lstm_phase_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from setk_tpu_torch.ops.cuda import _build
    from setk_tpu_torch.ops.cuda import lstm_seq as ls

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "lstm_phase_profile.cu"
    lib_path = _build.BUILD_DIR / "liblstm_phase_profile.so"
    cu.write_text(_instrumented(
        (_build.SOURCE_DIR / _build.SOURCES["lstm_seq"]).read_text()))
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-I",
                           str(_build.SOURCE_DIR), "-o", str(lib_path),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("lstm_fwd_resident_launch", "lstm_bwd_resident_launch"):
        getattr(lib, fn).argtypes = _build._SIGNATURES["lstm_seq"][fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.lstm_phase_read.argtypes = [ctypes.c_void_p]
    lib.lstm_phase_read.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    lines = []
    for t, b, h, dtype in SHAPES:
        rng = np.random.default_rng(b)
        xg = [torch.from_numpy(rng.standard_normal((t, b, 4 * h)).astype(
            np.float32) * 0.5).to(dev) for _ in "fb"]
        wh = [torch.from_numpy((rng.standard_normal((h, 4 * h)) /
                                np.sqrt(h)).astype(np.float32)).to(
            dev, getattr(torch, dtype)) for _ in "fb"]
        dy = [torch.from_numpy(rng.standard_normal((t, b, h)).astype(
            np.float32)).to(dev) for _ in "fb"]
        out = [torch.empty((t, b, h), device=dev) for _ in range(4)]
        ref = ls.lstm_seq_forward_plain(*xg, *wh)
        bargs = (*dy, *xg, *ref[::2], *ref[1::2], *wh)
        dx = [torch.empty_like(x) for x in xg]
        ex = [torch.empty((2, b, 4 * h), dtype=wh[0].dtype, device=dev)
              for _ in "fb"]
        stream = torch.cuda.current_stream().cuda_stream
        bf16 = int(dtype == "bfloat16")

        def run_fwd():
            _build.check(lib.lstm_fwd_resident_launch(
                *(x.data_ptr() for x in (*xg, *wh, *out)), t, b, h, bf16,
                stream), "instrumented kernel 20")

        def run_bwd():
            _build.check(lib.lstm_bwd_resident_launch(
                *(x.data_ptr() for x in (*bargs, *ex, *dx)), t, b, h, bf16,
                stream), "instrumented kernel 21")

        run_fwd()
        run_bwd()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 12)()
        _build.check(lib.lstm_phase_read(ctypes.addressof(cycles)),
                     "lstm_phase_read")
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader"],
                               capture_output=True,
                               text=True).stdout.strip()
        shape = {"T": t, "B": b, "H": h, "dtype": dtype}
        fwd = {"kernel": 20, **shape,
               "cycles_per_step": {p: c / t for p, c in zip(PHASES,
                                                            cycles[:6])},
               "instrumented_ms": _time_ms(torch, run_fwd),
               "kernel_ms": _time_ms(
                   torch, lambda: ls.lstm_seq_forward_resident(*xg, *wh)),
               "max_rel_err": _err(out, ref), "sm_clock": clock,
               "card": smi}
        bcyc = list(cycles[6:])
        bwd = {"kernel": 21, **shape, "phase1_cycles": bcyc[0],
               "cycles_per_step": {p: c / t for p, c in zip(BWD_PHASES[1:],
                                                            bcyc[1:])},
               "layout": ls.backward_resident_layout(
                   b, h, wh[0].dtype.itemsize, *ls.device_limits(dev)),
               "instrumented_ms": _time_ms(torch, run_bwd),
               "kernel_ms": _time_ms(
                   torch, lambda: ls.lstm_seq_backward_resident(*bargs)),
               "max_rel_err": _err(dx, ls.lstm_seq_backward_plain(*bargs)),
               "sm_clock": clock, "card": smi}
        for line in (fwd, bwd):
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
