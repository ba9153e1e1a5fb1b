#!/usr/bin/env python3
"""The OM-LSA kernels (csrc/omlsa.cu, row "— OM-LSA" of PERF.md's kernel
table) measured, and with --parent timed in turns beside another build.

    python3 tools/omlsa_profile.py [--parent DIR] [--counts] [--floor]
                                   [--sass DIR] [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/omlsa.cu
with the port's flags (-fmad=false included), each build with nvcc at
once, and prints, one JSON line each, after the card's name and power
limit (nvidia-smi) and its largest SM clock:

  ptxas     registers, spills and stack of every kernel of every build
  check     each build through its C entry against the plain version on
            the card at one 8 s utterance (T = 501) of chip_smoke.py's O1
            scene, both estimators, F = 257, 513, 1025 and O1's
            non-default configurations: the largest gain difference and
            the gains more than 1e-3 apart (a crossed threshold)
  turns     each build's ms (a CUDA graph's replay of 5 calls, 3 at L =
            128) in turns (builds in order, then in reverse: parent,
            this, this, parent), both estimators at F = 257, 513 and
            1025 (one row) and F = 257 at L = 128 rows of the same scene
  stages    this build's device ms by kernel (chip_smoke._stage_ms:
            torch.profiler over 3 calls, checked against the call's
            launches and graph ms) at F = 257, 1025 and at L = 128, with the
            chain kernel's ns and SM cycles (at the largest clock) a
            frame

--parent DIR: DIR holds another omlsa.cu (e.g. a parent commit's
setk_tpu_torch/csrc unpacked by `git archive` into a gitignored
directory).  A source of the one-block-a-row design (one without
floats_a_frame) is launched with its scratch of omlsa_layout's out[5]
floats a row.
--counts: this source also built with counters (-DSETK_OMLSA_COUNTS:
the chain threads' frames, the frames run again with the exact
division, their loops' SM cycles, the counters' own cost included; a
"counts" line for each check case and for a scene of bins out of the
fast division's range), timed in the same turns.
--sass DIR: each build's SASS (cuobjdump -sass) into DIR, and a line of
each kernel's instructions and branches.
--floor: the chain kernels' floor, counted from this build's SASS by
tools/sass_floor.py with the latencies it measures on the card: SM
cycles a frame, and ms at T = 501 at the largest SM clock.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import sass_floor  # noqa: E402


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _build_all(_b, sources):
    """nvcc each {label: (path, extra flags)} into BUILD_DIR at once:
    -> {label: (CDLL, nvcc log)}."""
    _b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, (src, extra) in sources.items():
        out = _b.BUILD_DIR / f"libomlsa-{label}.so"
        cmd = [_b._nvcc(), *_b._flags("omlsa"), *extra, "-o", str(out),
               str(src)]
        jobs[label] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for label, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _b._SIGNATURES["omlsa"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        built[label] = (lib, log)
    return built


def _ptxas(log):
    """{kernel<args>: {registers, spill bytes, stack}} from -Xptxas -v."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"\d+(\w+?_kernel)I(L[ib]\d+E)+E", line)
        if "Compiling entry function" in line and m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(0)))
            key = f"{m.group(1)}<{args}>"
            out[key] = {}
        elif key and "spill stores" in line:
            out[key]["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", line))
            out[key]["stack_bytes"] = int(
                re.search(r"(\d+) bytes stack frame", line).group(1))
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def _sass(_b, built, out_dir):
    """Each build's SASS into ``out_dir``: -> {build: {kernel:
    [instructions, branches]}}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tool = Path(_b._nvcc()).with_name("cuobjdump")
    counts = {}
    for label in built:
        lib = _b.BUILD_DIR / f"libomlsa-{label}.so"
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        (out_dir / f"omlsa-{label}.sass").write_text(text)
        kernel, per = None, {}
        for line in text.splitlines():
            m = re.search(r"Function : \S*?(\w+_kernel)I(L[ib]\d+E)+E",
                          line)
            if m:
                args = ",".join(re.findall(r"L[ib](\d+)E", m.group(0)))
                kernel = f"{m.group(1)}<{args}>"
                per[kernel] = [0, 0]
            elif kernel and re.search(r"/\*[0-9a-f]{4,}\*/", line):
                per[kernel][0] += 1
                per[kernel][1] += bool(re.search(r"\bBRA\b", line))
        counts[label] = per
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a directory with another omlsa.cu to time "
                             "beside this one")
    parser.add_argument("--counts", action="store_true",
                        help="also build and time this source with its "
                             "counters")
    parser.add_argument("--floor", action="store_true",
                        help="count the chain kernels' floor from the SASS")
    parser.add_argument("--sass", default=None,
                        help="write each build's SASS into this directory")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("omlsa_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.enhance import ns
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import omlsa as om

    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    emit({"card": card, "max_sm_clock_mhz": clock_mhz})
    src = _b.SOURCE_DIR / _b.SOURCES["omlsa"]
    sources = {"this": (src, [])}
    if args.parent:
        sources["parent"] = (Path(args.parent) / _b.SOURCES["omlsa"], [])
    if args.counts:
        sources["counts"] = (src, ["-DSETK_OMLSA_COUNTS"])
    built = _build_all(_b, sources)
    one_block_a_row = {label for label, (path, _) in sources.items()
                       if "floats_a_frame" not in path.read_text()}
    emit({"ptxas": {label: _ptxas(log) for label, (_, log) in
                    built.items()}})
    sass_dir = Path(args.sass) if args.sass else _b.BUILD_DIR / "sass"
    if args.sass or args.floor:
        emit({"sass": _sass(_b, built, sass_dir)})
    if args.floor:
        table, probes = sass_floor.probe_latencies(_b._nvcc(),
                                                   _b.BUILD_DIR)
        emit({"latency": table, "probes": probes})
        text = (sass_dir / "omlsa-this.sass").read_text()
        for kernel in ("mcra_chain_kernel", "imcra_chain_kernel"):
            got = sass_floor.floor_of(text, kernel, table)
            got["floor_ms_at_max_clock"] = (
                got["floor_cycles_a_frame"] * cs.O_T / (clock_mhz * 1e3))
            emit({"floor": got})

    dev = torch.device("cuda", 0)
    configs = {"mcra": ns.MCRAConfig, "imcra": ns.IMCRAConfig}

    def launcher(label, est, cfg, pw):
        """A call of build ``label`` on ``pw``, its buffers made once:
        -> (run, gain, the layout omlsa_layout reports)."""
        lib = built[label][0]
        rows, t, f = pw.shape
        floats, ints, taps = om._params(est, cfg, 1e-7, t, f)
        taps_d = torch.from_numpy(taps).to(dev)
        out = (ctypes.c_int * 6)()
        _b.check(lib.omlsa_layout(int(est == "imcra"), f,
                                  ints[om._INT_FIELDS.index("U")], taps.size,
                                  ctypes.addressof(out)), "omlsa_layout")
        # the one-block-a-row layout's out[5] is the scratch floats a row
        floats_n = rows * out[5] if label in one_block_a_row else \
            rows * (t * out[2] + out[3])
        scratch = torch.empty(max(floats_n, 1), device=dev)
        gain = torch.empty_like(pw)

        def run():
            _b.check(lib.omlsa_launch(
                pw.data_ptr(), gain.data_ptr(), taps_d.data_ptr(),
                scratch.data_ptr(), ctypes.addressof(floats),
                ctypes.addressof(ints), rows, int(est == "imcra"),
                torch.cuda.current_stream().cuda_stream), label)
        return run, gain, list(out)

    def scene(f, rows=1):
        pw = torch.from_numpy(cs._o_scene(np, cs.O_T, f, seed=f))[None]
        return pw.expand(rows, -1, -1).contiguous().to(dev)

    # ---- check ----
    cases = [(est, f, {}) for est in configs for f in cs.O_F] + [
        (est, cs.O_F[0], conf) for est, conf in cs.O_CONF.items()]
    for est, f, conf in cases:
        cfg = configs[est](**conf)
        pw = scene(f)
        ref = om.omlsa_plain(pw, est, cfg)
        row = {"check": f"{est},F={f}" + "".join(
            f",{k}={v}" for k, v in conf.items())}
        for label in built:
            run, gain, _ = launcher(label, est, cfg, pw)
            run()
            torch.cuda.synchronize()
            gap = (gain - ref).abs()
            row[label] = {"max_abs_err": float(gap.max()),
                          "flipped": int((gap > cs.O_FLIP).sum())}
        emit(row)

    # ---- counts: frames run again, SM cycles a frame of a chain thread
    if "counts" in built:
        lib = built["counts"][0]
        lib.omlsa_counts_read.argtypes = [ctypes.c_void_p]
        lib.omlsa_counts_read.restype = ctypes.c_int
        got = (ctypes.c_ulonglong * 6)()
        counted = [(est, f"{est},F={f}" + "".join(
            f",{key}={v}" for key, v in conf.items()), configs[est](**conf),
            scene(f)) for est, f, conf in cases]
        # bins out of the fast division's range (tests/test_torch_gpu.py's
        # scene of frames run again, on O1's scene: every fifth bin at
        # 1e-30, every seventh at 1e30, every eleventh silent)
        extremes = scene(70)[:, :60].clone()
        bins = torch.arange(70, device=dev)
        extremes[..., bins % 5 == 0] = 1e-30
        extremes[..., bins % 7 == 0] = 1e30
        extremes[..., bins % 11 == 0] = 0.0
        counted += [(est, f"{est},extremes", make(), extremes)
                    for est, make in configs.items()]
        for est, label, cfg, pw in counted:
            run, _, _ = launcher("counts", est, cfg, pw)
            _b.check(lib.omlsa_counts_read(ctypes.addressof(got)), "read")
            run()
            torch.cuda.synchronize()
            _b.check(lib.omlsa_counts_read(ctypes.addressof(got)), "read")
            k = 3 * int(est == "imcra")
            frames, again, cycles = got[k], got[k + 1], got[k + 2]
            emit({"counts": label, "frames": frames,
                  "run_again_share": again / frames,
                  "cycles_a_frame": cycles / frames})

    # ---- turns ----
    labels = list(built)
    order = labels + labels[::-1]
    for est, make in configs.items():
        cfg = make()
        for f, rows in [(f, 1) for f in cs.O_F] + [(cs.O_F[0], 128)]:
            pw = scene(f, rows)
            runs = {label: launcher(label, est, cfg, pw)[0]
                    for label in labels}
            times = {label: [] for label in labels}
            for label in order:
                times[label].append(cs._graph_ms(
                    torch, runs[label], iters=5 if rows == 1 else 3))
            emit({"turns": f"{est},F={f},L={rows}", "order": order,
                  "ms": times})

    # ---- stages ----
    for est, make in configs.items():
        cfg = make()
        for f, rows in ((cs.O_F[0], 1), (cs.O_F[-1], 1), (cs.O_F[0], 128)):
            pw = scene(f, rows)
            run, _, layout = launcher("this", est, cfg, pw)
            ms = cs._graph_ms(torch, run, iters=5)
            stages = cs._stage_ms(torch, run, ms, layout[5])
            chain = [v for name, v in stages["by_kernel"] if "chain" in name]
            ns_a_frame = chain[0] * 1e6 / cs.O_T \
                if chain and stages["agrees"] else None
            emit({"stages": f"{est},F={f},L={rows}", "ms": ms, **stages,
                  "chain_ns_a_frame": ns_a_frame,
                  "chain_cycles_a_frame_at_max_clock":
                      None if ns_a_frame is None
                      else ns_a_frame * clock_mhz / 1e3,
                  "layout": layout})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(
            [card] + [json.dumps(line) for line in lines]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
