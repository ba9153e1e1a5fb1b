#!/usr/bin/env python3
"""The batched Hermitian EVD kernel (csrc/eigh_small.cu, the last row of
PERF.md's kernel table) measured, and with --parent timed in turns beside
another build.

    python3 tools/eigh_profile.py [--parent DIR] [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/eigh_small.cu
as shipped and with -DSETK_EIGH_PHASES (every thread of a matrix adds the
SM cycles of each phase to device counters), and prints, one JSON line
each:

  ptxas     registers, spills and stack of every EVD instance (M = 1-8,
            plain and generalized, both forms), and the SASS instructions
            of the M = 6 instances (cuobjdump -sass)
  sweeps    the sweeps each of the gated scene's matrices takes before the
            stopping test passes (eigh_small.eigh_sweeps_needed), mean,
            largest and histogram, plain and generalized, at 257, 4,112
            and 32,896 matrices (M = 6: one utterance's bins, an 8 s
            utterance's at chunk 32, a batch of 128); the operation bound
            recounted from them (chip_smoke._flops_eigh)
  phases    a thread's cycles by phase (load and whitening, angles with
            the stopping test, updates with the round's broadcast, the
            lane form's hand-over, store with the back substitution and
            sort), and the sweeps its warp ran and its own matrix took,
            at 257, 4,112 and 32,896 matrices, each form, plain and
            generalized; a lane of the lane form counts as a thread
  turns     the kernel's ms from a CUDA-graph replay (and eager) at the
            three counts, plain and generalized, each form and the
            launcher's pick, and the forms built at M = 2-8 at 1,028 to
            65,792 matrices, where they cross (the gated scene at M = 6
            up to 32,896, else a quarter rank one, the rest full rank);
            errors against the plain version; the fused mvdr step with
            the eigh steer (chip_smoke.py V3's B = 128 gated scene): its
            ms, the host's enqueue ms a call and self time by operation,
            and its device profile (through the port's table too for
            this build)

Inputs are chip_smoke.py's gated scene (numpy.random.default_rng seeds):
Rs and Rn of B = 128 utterances x 257 bins from kernel A, the last matrix
zero (a bin with no speech).

--parent DIR: DIR holds another eigh_small.cu (with jacobi.cuh), e.g. a
parent commit's setk_tpu_torch/csrc unpacked by `git archive` into a
gitignored directory.  It is built as it is and, for the phases, with the
clock marks of PARENT_MARKS written into a copy (a mark whose text moved
stops the tool); a source without hermitian_eigh_form_launch runs its
hermitian_eigh_launch (one form).  Both builds are timed in turns
(parent, this, this, parent), each with its library in the port's table,
and kernel 14 (regularized_inverse, same source) is checked to give the
same bits from both where the parent's entry takes its form argument
(tools/inverse_profile.py times kernel 14 against an older one).
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from wpe_phase_profile import _smi  # noqa: E402

COUNTS = (257, 4112, 32896)
CROSS_COUNTS = (1028, 4112, 8224, 16448, 32896, 65792)
PHASE_COUNTS = (257, 4112, 32896)
PHASES = ["load", "angles", "updates", "handover", "store"]

# the instrumented build's clock, for a parent source that has none
_CLOCK = """
__device__ unsigned long long g_eigh_phase[8];
__device__ __forceinline__ long long eigh_clock() { return clock64(); }
struct EighClock {
  long long t, acc[5];
  __device__ EighClock() : t(eigh_clock()), acc{0, 0, 0, 0, 0} {}
  __device__ void mark(int i) {
    const long long now = eigh_clock();
    acc[i] += now - t;
    t = now;
  }
  __device__ void flush(bool active) {
    if (!active) return;
    for (int i = 0; i < 5; ++i)
      atomicAdd(&g_eigh_phase[i], (unsigned long long)acc[i]);
    atomicAdd(&g_eigh_phase[5], 1ull);
  }
};
"""
_READ = """
extern "C" int eigh_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_eigh_phase, 8 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return cudaMemcpyToSymbol(g_eigh_phase, zero, 8 * 8);
}
"""
# (file, old, new): the clock marks of the phase split in a source whose
# EVD runs jacobi.cuh's cyclic jacobi_sweeps (the first design's): load
# and whitening (0), each rotation's angle (1) and its updates (2), the
# back substitution, sort and store (4)
PARENT_MARKS = [
    ("jacobi.cuh", "#include <cuda_runtime.h>\n",
     "#include <cuda_runtime.h>\n" + _CLOCK),
    ("jacobi.cuh", " " * 46 + "int sweeps) {",
     " " * 46 + "int sweeps, EighClock& clk) {"),
    ("jacobi.cuh", "        const float apq_re = a_re[p][q], apq_im = "
     "a_im[p][q];\n",
     "        clk.mark(2);\n        const float apq_re = a_re[p][q], "
     "apq_im = a_im[p][q];\n"),
    ("jacobi.cuh", "        // columns: A <- A G on columns p, q\n",
     "        clk.mark(1);\n        // columns: A <- A G on columns p, q\n"),
    ("jacobi.cuh", "  jacobi_sweeps<M, false>(a_re, a_im, v_re, v_im, "
     "sweeps);",
     "  EighClock clk;\n  jacobi_sweeps<M, false>(a_re, a_im, v_re, v_im, "
     "sweeps, clk);"),
    ("eigh_small.cu", "  if (idx >= n) return;\n  float a_re[M][M], "
     "a_im[M][M];\n",
     "  if (idx >= n) return;\n  EighClock clk;\n  float a_re[M][M], "
     "a_im[M][M];\n"),
    ("eigh_small.cu", "  setk::jacobi_sweeps<M, true>(a_re, a_im, v_re, "
     "v_im, sweeps);\n",
     "  clk.mark(0);\n  setk::jacobi_sweeps<M, true>(a_re, a_im, v_re, "
     "v_im, sweeps, clk);\n  clk.mark(2);\n"),
    ("eigh_small.cu", "      v_dst[k * M + rank] = make_float2(v_re[k][i], "
     "v_im[k][i]);\n  }\n}\n",
     "      v_dst[k * M + rank] = make_float2(v_re[k][i], v_im[k][i]);\n"
     "  }\n  clk.mark(4);\n  clk.flush(true);\n}\n"),
]


def _marked_copy(src_dir: Path, out_dir: Path) -> Path:
    """eigh_small.cu and jacobi.cuh of ``src_dir`` with PARENT_MARKS
    written in, under ``out_dir``; returns the source's path."""
    texts = {name: (src_dir / name).read_text()
             for name in ("eigh_small.cu", "jacobi.cuh")}
    for name, old, new in PARENT_MARKS:
        if texts[name].count(old) != 1:
            raise SystemExit(f"eigh_profile: the mark {old[:50]!r} is not "
                             f"once in {src_dir / name}")
        texts[name] = texts[name].replace(old, new)
    texts["eigh_small.cu"] += _READ
    for name, text in texts.items():
        (out_dir / name).write_text(text)
    return out_dir / "eigh_small.cu"


def _build_all(_b, jobs: dict) -> dict:
    """nvcc every {label: (source, defines)} into BUILD_DIR at once:
    -> {label: (CDLL, nvcc log)}, the EVD entries typed."""
    _b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, defines) in jobs.items():
        out = _b.BUILD_DIR / f"libeigh_small-{label}.so"
        cmd = [_b._nvcc(), *_b._FLAGS, *defines, "-o", str(out), str(src)]
        procs[label] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for label, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {jobs[label][0]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _b._SIGNATURES["eigh_small"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        built[label] = (lib, log)
    return built


def _sass_sizes(lib_path: Path) -> dict:
    """SASS instructions of the M = 6 EVD instances in a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr[-200:]}
    sizes, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : \S*?(hermitian_eigh(?:_lanes)?)_kernel"
                      r"ILi(\d)ELb([01])E", line)
        if "Function :" in line:
            name = (f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
                    if m and m.group(2) == "6" else None)
            if name:
                sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return sizes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a directory with another eigh_small.cu (and "
                             "jacobi.cuh) to time beside this one")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("eigh_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.enhance import pipeline
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import eigh_small as es
    from setk_tpu_torch.ops.cuda import fused_mvdr as fm
    from setk_tpu_torch.parallel.enhance_step import enhance_batch

    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    sources = {"this": _b.SOURCE_DIR / "eigh_small.cu"}
    _b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    scratch = Path(tempfile.mkdtemp(dir=_b.BUILD_DIR))
    marked = {"this": sources["this"]}
    if args.parent:
        sources["parent"] = Path(args.parent) / "eigh_small.cu"
        (scratch / "parent_phases").mkdir()
        marked["parent"] = _marked_copy(Path(args.parent),
                                        scratch / "parent_phases")
    built = _build_all(_b, {
        **{k: (v, []) for k, v in sources.items()},
        **{f"{k}-phases": (v, ["-DSETK_EIGH_PHASES"])
           for k, v in marked.items()}})
    shipped = {k: built[k] for k in sources}
    phased = {k: built[f"{k}-phases"] for k in marked}
    for lib, _ in phased.values():
        lib.eigh_phase_read.argtypes = [ctypes.c_void_p]
        lib.eigh_phase_read.restype = ctypes.c_int
    shutil.rmtree(scratch)
    emit({"ptxas": {k: {key: val for key, val in cs._ptxas_summary(
        log).items() if key.startswith("hermitian_eigh")}
        for k, (_, log) in shipped.items()},
        "sass_instructions_M6": {k: _sass_sizes(
            _b.BUILD_DIR / f"libeigh_small-{k}.so") for k in shipped},
        "card": card})

    dev = torch.device("cuda", 0)
    cfg = StftConfig()
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    gwav16, gmask, _ = cs._gated_scene(cs.B, cs.N, cs.S, seed=1)
    gwav_d = torch.from_numpy(gwav16).to(dev)
    gmask_d = torch.from_numpy(gmask).to(dev)
    rs_num, rn_num = fm.stft_covar(gwav_d, gmask_d, window)
    den = gmask_d.sum(1)
    scene = (rs_num / torch.clamp(den, min=1e-6)[..., None, None],
             rn_num / torch.clamp(cfg.num_frames(cs.S) - den,
                                  min=1e-6)[..., None, None])
    mats = {n: cs._eigh_inputs(torch, dev, n, cs.N, seed=7, scene=scene)
            for n in COUNTS}

    # ---- the sweeps the stopping test lets each matrix take ----
    sweeps = {}
    for n, (a, b) in mats.items():
        for gen in (False, True):
            taken = es.eigh_sweeps_needed(a, b if gen else None)
            nbytes = a.nbytes * (2 if gen else 1) + a.nbytes + n * cs.N * 4
            flops = (cs._flops_eigh(cs.N, float(taken.sum()), False) +
                     n * (cs._flops_eigh(cs.N, 0, gen)))
            sweeps[f"n{n},{'gen' if gen else 'eigh'}"] = {
                "mean": float(taken.float().mean()),
                "max": int(taken.max()),
                "histogram": torch.bincount(
                    taken, minlength=es.EIGH_SWEEPS + 1).tolist(),
                "bound": cs._bound(nbytes, flops),
                "bound_at_cap": cs._bound(nbytes, n * cs._flops_eigh(
                    cs.N, es.EIGH_SWEEPS, gen))}
    emit({"sweeps": sweeps, "test": "|a_pq|^2 <= (M EPS ||A||_F)^2",
          "cap": es.EIGH_SWEEPS, "card": card})

    def launch(lib, a, b, form):
        m = a.shape[-1]
        n = a.numel() // (m * m)
        w = torch.empty(a.shape[:-1], device=dev)
        v = torch.empty_like(a)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (a.data_ptr(), None if b is None else b.data_ptr(),
                w.data_ptr(), v.data_ptr(), n, m, es.EIGH_SWEEPS, 1e-6)
        if hasattr(lib, "hermitian_eigh_form_launch"):
            err = lib.hermitian_eigh_form_launch(
                *ptrs, {None: -1, "thread": 0, "lanes": 1}[form], stream)
        else:
            err = lib.hermitian_eigh_launch(*ptrs, stream)
        _b.check(err, "hermitian_eigh")
        return w, v

    def forms(lib, m=cs.N):
        """The pick and the forms built at M (the pick alone in a source
        with one form)."""
        return ((None,) + es.eigh_forms(m)
                if hasattr(lib, "hermitian_eigh_form_launch") else (None,))

    # ---- a thread's cycles by phase ----
    phases = {}
    for build, (lib, _) in phased.items():
        for n in PHASE_COUNTS:
            a, b = mats[n]
            for gen in (False, True):
                for form in forms(lib)[1:] or (None,):
                    cycles = (ctypes.c_ulonglong * 8)()
                    _b.check(lib.eigh_phase_read(ctypes.addressof(cycles)),
                             "eigh_phase_read")
                    launch(lib, a, b if gen else None, form)
                    torch.cuda.synchronize()
                    _b.check(lib.eigh_phase_read(ctypes.addressof(cycles)),
                             "eigh_phase_read")
                    threads = max(int(cycles[5]), 1)
                    per = [c / threads for c in cycles[:5]]
                    total = sum(per) or 1.0
                    phases[f"{build},n{n},{'gen' if gen else 'eigh'},"
                           f"{form or 'one'}"] = {
                        "thread_cycles": dict(zip(PHASES, per)),
                        "share": {p: c / total for p, c in zip(PHASES, per)},
                        "threads": threads,
                        # the parent's clock counts no sweeps (it runs
                        # the cap)
                        "sweeps_run": int(cycles[6]) / threads,
                        "sweeps_taken": int(cycles[7]) / threads}
    emit({"phases": phases, "sm_clock": _smi("clocks.sm"), "card": card})

    # ---- kernel 14 from both builds: the same bits (a parent with its
    # form argument) ----
    if "parent" in shipped and hasattr(shipped["parent"][0],
                                       "regularized_inverse_pick"):
        k14 = {}
        for label, count in (("resume_514", 514), ("c1_65792", 65792)):
            x = torch.complex(*torch.randn((2, count, cs.N, 16), device=dev,
                                           generator=torch.Generator(
                                               device=dev).manual_seed(3)))
            a = (x @ x.conj().transpose(-1, -2) / 16).contiguous()
            outs = []
            for build in ("this", "parent"):
                _b._loaded["eigh_small"] = shipped[build][0]
                inv, ld = es.regularized_inverse(a)
                outs.append((inv, ld))
            k14[label] = bool(torch.equal(outs[0][0], outs[1][0]) and
                              torch.equal(outs[0][1], outs[1][1]))
        emit({"kernel14_same_bits": k14, "card": card})

    # ---- turns ----
    plain = {n: {gen: es.hermitian_eigh_plain(a, b if gen else None)
                 for gen in (False, True)} for n, (a, b) in mats.items()}
    kernels_now = pipeline._KERNELS
    turns = ("parent", "this", "this", "parent") if args.parent else (
        "this",)
    def step():
        return enhance_batch(gwav_d, gmask_d, cfg, steer="eigh")

    def step_row():
        """The eigh-steer step: ms (CUDA events over 10 calls), the host's
        enqueue ms a call (no synchronize inside the 10), the device
        profile, and the host's own time by operation (self CPU ms a
        call, the largest 8: a synchronize or a blocking copy shows
        here)."""
        from torch.profiler import ProfilerActivity, profile
        ms = cs._time_ms(torch, step, iters=10, warmup=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        enqueue = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        host = sorted(((ev.self_cpu_time_total / 3e3, ev.key[:60])
                       for ev in prof.key_averages()), reverse=True)[:8]
        return {"ms": ms, "enqueue_ms": enqueue,
                "host_top": [[k, v] for v, k in host],
                "profile": cs._device_profile(torch, step, ms, iters=3)}

    for turn, build in enumerate(turns):
        lib = shipped[build][0]
        _b._loaded["eigh_small"] = lib
        row = {"turn": turn, "build": build, "card": card, "kernels": {}}
        # the step first, through the port's table as it stands (this
        # build) and through the tool's own launch (either build)
        if build == "this":
            row["eigh_steer_step_shipped"] = step_row()
        pipeline._KERNELS = kernels_now._replace(
            hermitian_eigh=lambda a, b=None: launch(lib, a.contiguous(), b,
                                                    None))
        row["eigh_steer_step"] = step_row()
        pipeline._KERNELS = kernels_now
        for n, (a, b) in mats.items():
            for gen in (False, True):
                bb = b if gen else None
                for form in forms(lib):
                    key = f"n{n},{'gen' if gen else 'eigh'},{form or 'pick'}"
                    w, v = launch(lib, a, bb, form)
                    w_p, v_p = plain[n][gen]
                    w_err, _, cos, _ = cs._eigh_errs(torch, w, v, w_p, v_p)
                    row["kernels"][key] = {
                        "ms": cs._graph_ms(torch, lambda: launch(
                            lib, a, bb, form), iters=20),
                        "eager_ms": cs._time_ms(torch, lambda: launch(
                            lib, a, bb, form), iters=20),
                        "w_err": w_err, "principal_min_cos": cos}
        # where the forms cross, at every M
        for n, m in [(n, m) for m in range(2, 9) for n in CROSS_COUNTS]:
            a, _ = cs._eigh_inputs(
                torch, dev, n, m, seed=7,
                scene=scene if m == cs.N and n <= COUNTS[-1] else None)
            for form in forms(lib, m)[1:] or (None,):
                row["kernels"][f"n{n},M{m},eigh,{form or 'pick'}"] = {
                    "ms": cs._graph_ms(torch, lambda: launch(
                        lib, a, None, form), iters=20)}
        emit(row)
    _b._loaded["eigh_small"] = shipped["this"][0]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
