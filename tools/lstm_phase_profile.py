#!/usr/bin/env python3
"""Where a step of kernel 20's resident variant spends its time.

    python3 tools/lstm_phase_profile.py [--out FILE]

Needs one CUDA card and nvcc.  It copies setk_tpu_torch/csrc/lstm_seq.cu,
inserts clock64() readings at the resident kernel's phase boundaries
(block 0, thread 0, each reading taken just after the block barrier that
closes a phase), builds the copy with the port's nvcc flags into the
build directory, and runs it at T = 400 over the shapes below, printing
one JSON line per shape: SM cycles a step spent in

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
# (line that closes a phase, phase index): the reading goes after it
MARKS = [
    ("                       rows, h);\n        __syncthreads();\n", 0),
    ("        __syncthreads();   // every thread has read the tile\n", 1),
    ("                hs[(i * 4 + g) * na + tid] = acc[i][g];\n"
     "        }\n        __syncthreads();\n", 2),
    ("          }\n          __syncthreads();\n        }\n      }\n", 3),
    ("      __syncthreads();   // the tile's space is free for the next"
     " tile\n", 4),
    ("    grid.sync();   // h_t and c_t of every block before step s + 1"
     " reads\n", 5),
]


def _instrumented(src: str) -> str:
    def mark(i):
        return (f"if (blockIdx.x == 0 && threadIdx.x == 0) {{ "
                f"long long q_ = clock64(); prof_acc[{i}] += q_ - pt; "
                f"pt = q_; }}\n")

    def insert(text, old, new):
        if old not in text:
            raise SystemExit(f"lstm_phase_profile: the kernel no longer has "
                             f"{old!r}; update MARKS")
        return text.replace(old, new, 1)

    src = insert(src, "namespace {\n",
                 "namespace {\n__device__ unsigned long long g_prof[6];\n")
    src = insert(
        src, "  cooperative_groups::grid_group grid = "
        "cooperative_groups::this_grid();\n",
        "  cooperative_groups::grid_group grid = "
        "cooperative_groups::this_grid();\n"
        "  long long prof_acc[6] = {0, 0, 0, 0, 0, 0};\n"
        "  long long pt = clock64();\n")
    for line, i in MARKS:
        src = insert(src, line, line + mark(i))
    src = insert(
        src, "    grid.sync();   // h_t and c_t of every block before step "
        "s + 1 reads\n" + mark(5) + "  }\n}\n",
        "    grid.sync();   // h_t and c_t of every block before step s + 1 "
        "reads\n" + mark(5) + "  }\n  if (blockIdx.x == 0 && threadIdx.x == "
        "0)\n    for (int i = 0; i < 6; ++i) g_prof[i] = prof_acc[i];\n}\n")
    return src + ('\nextern "C" int lstm_phase_read(unsigned long long* out) '
                  '{\n  return cudaMemcpyFromSymbol(out, g_prof, 6 * 8);\n}\n')


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
    lib.lstm_fwd_resident_launch.argtypes = \
        _build._SIGNATURES["lstm_seq"]["lstm_fwd_resident_launch"]
    lib.lstm_fwd_resident_launch.restype = ctypes.c_int
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
        out = [torch.empty((t, b, h), device=dev) for _ in range(4)]
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            _build.check(lib.lstm_fwd_resident_launch(
                *(x.data_ptr() for x in (*xg, *wh, *out)), t, b, h,
                int(dtype == "bfloat16"), stream), "instrumented launch")

        run()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 6)()
        _build.check(lib.lstm_phase_read(ctypes.addressof(cycles)),
                     "lstm_phase_read")
        ref = ls.lstm_seq_forward_plain(*xg, *wh)
        err = max(float((g - r).abs().max() / r.abs().max())
                  for g, r in zip(out, ref))
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        line = {"T": t, "B": b, "H": h, "dtype": dtype,
                "cycles_per_step": {p: c / t for p, c in zip(PHASES,
                                                             cycles)},
                "instrumented_ms": _time_ms(torch, run),
                "kernel_ms": _time_ms(
                    torch, lambda: ls.lstm_seq_forward_resident(*xg, *wh)),
                "max_rel_err": err, "sm_clock": clock, "card": smi}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
