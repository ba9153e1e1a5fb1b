#!/usr/bin/env python3
"""Kernel 10 (the planar iSTFT, alone and with the beamform) built in
several variants of setk_tpu_torch/csrc/planar_stft.cu, timed side by
side, with a warp's cycles by phase.

    python3 tools/planar_variants.py [--variants FILE] [--out FILE]

Needs one CUDA card and nvcc.  A variant is a list of [old, new] text
substitutions on the source; each is built with nvcc, all at once, beside
a build of the source as it is with -DSETK_ISTFT_PHASES (the shipped
build carries no counters).  --variants FILE reads {name: variant} from a
JSON file (tools/planar_variants.json holds kernel 10's design choices);
without it only the source as it is is built.

It prints each build's -Xptxas -v registers, spills and shared memory of
kernel 10's instances and the launch's layout (shared memory, blocks an
SM, output hop blocks a block: istft_planar_layout), then times every
variant in turns (in order, then in reverse) from a CUDA-graph replay at
chip_smoke.py's widths: with the beamform at P1 (B = 128, 6 mics, n_fft
1024, T = 251, 8 s), P2 (512/256, T = 501, S = 128,100) and at n_fft
2048 with 8 mics (T = 126), alone at P1 (mic 0's planes), each with its
largest error against its plain version
relative to its peak.  Planes, Nyquist rows and weights come from a
seeded generator (|w| ~ 1 / N); the kernel's time does not depend on the
values.  Last, the phase build's counters at each case: a warp's SM
cycles by phase (the tables and weights, the beamform, the inverse, the
overlap-add before the tile barrier, the barrier, the blocks written
after it), summed over the warps of one launch.
"""

import argparse
import concurrent.futures
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from wpe_phase_profile import _nvcc_all, _smi  # noqa: E402

PHASES = ("tables", "beamform", "inverse", "ola_write", "tile_barrier",
          "after_barrier")


def _sources(variants, out_dir):
    """Write each variant's planar_stft.cu under out_dir: {name: path}."""
    base = (ROOT / "setk_tpu_torch" / "csrc" / "planar_stft.cu").read_text()
    paths = {}
    for name, variant in variants.items():
        text = base
        for old, new in variant:
            if old not in text:
                raise SystemExit(f"{name}: {old[:60]!r} is not in the "
                                 f"source")
            text = text.replace(old, new)
        path = out_dir / name / "planar_stft.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths[name] = path
    return paths


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=None,
                        help="a JSON file of {name: variant}")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("planar_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import planar as pl

    variants = {"as_is": []}
    if args.variants:
        variants.update(json.loads(Path(args.variants).read_text()))
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    out_dir = _b.BUILD_DIR / "planar_variants"
    paths = _sources(variants, out_dir)
    paths["phases"] = paths["as_is"]
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        jobs = {name: pool.submit(
            _nvcc_all, _b, {"planar_stft": path}, f"planar-{name}",
            ["-DSETK_ISTFT_PHASES"] if name == "phases" else [])
            for name, path in paths.items()}
        built = {name: job.result()["planar_stft"]
                 for name, job in jobs.items()}
    phase_lib = built.pop("phases")[0]
    phase_lib.istft_phase_read.argtypes = [ctypes.c_void_p]
    phase_lib.istft_phase_read.restype = ctypes.c_int
    for name, (lib, log) in built.items():
        layout = {}
        for n_fft, mics in ((1024, 6), (1024, 0), (512, 6), (2048, 8)):
            out = (ctypes.c_int * 3)()
            err = lib.istft_planar_layout(n_fft, mics, ctypes.addressof(out))
            layout[f"{n_fft},{mics}"] = {"smem_bytes": out[0],
                                         "blocks_an_sm": out[1],
                                         "run": out[2], "cuda_error": err}
        emit({"variant": name, "card": card, "layout": layout, "ptxas": {
            k: v for k, v in cs._ptxas_summary(log).items()
            if k.startswith("istft_planar<")}})

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for label, n_fft, n, s in (("P1", 1024, cs.N, cs.S),
                               ("P2", 512, cs.N, cs.P2_S),
                               ("2048_N8", 2048, 8, cs.S)):
        cfg = StftConfig(frame_len=n_fft, frame_hop=n_fft // 2)
        t, fh = cfg.num_frames(s), n_fft // 2
        re, im = torch.randn((2, cs.B, n, t, fh), device=dev, generator=gen)
        nyq = torch.randn((cs.B, n, t), device=dev, generator=gen)
        w = torch.complex(*torch.randn((2, cs.B, fh + 1, n), device=dev,
                                       generator=gen)) / n
        window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                                 device=dev)
        wss = torch.as_tensor(pl.istft_wss_inverse(cfg.padded_window, t, s),
                              device=dev)
        fused = (re, im, nyq, w, window, wss, s)
        cases[f"beamform_istft_planar@{label}"] = (
            lambda a=fused: pl.beamform_istft_planar(*a),
            pl.beamform_istft_planar_plain(*fused))
        if label == "P1":
            alone = (re[:, 0].contiguous(), im[:, 0].contiguous(),
                     nyq[:, 0].contiguous(), window, wss, s)
            cases["istft_planar@P1"] = (
                lambda a=alone: pl.istft_planar(*a),
                pl.istft_planar_plain(*alone))
    names = list(built)
    for turn, name in enumerate(names + names[::-1]):
        _b._loaded["planar_stft"] = built[name][0]
        row = {"turn": turn, "variant": name, "card": card}
        for label, (fn, ref) in cases.items():
            try:
                row[label] = {"ms": cs._graph_ms(torch, fn, iters=20),
                              "max_rel_err": cs._rel(fn(), ref)}
            except RuntimeError as exc:  # a variant the launch refuses
                row[label] = {"error": str(exc)[:100]}
        emit(row)
    # a warp's cycles by phase, one launch of each case
    _b._loaded["planar_stft"] = phase_lib
    cycles = (ctypes.c_ulonglong * 6)()
    phases = {"variant": "as_is", "card": card}
    for label, (fn, ref) in cases.items():
        fn()
        torch.cuda.synchronize()
        _b.check(phase_lib.istft_phase_read(ctypes.addressof(cycles)),
                 "istft_phase_read")  # zero them
        err = cs._rel(fn(), ref)
        torch.cuda.synchronize()
        _b.check(phase_lib.istft_phase_read(ctypes.addressof(cycles)),
                 "istft_phase_read")
        total = sum(cycles)
        phases[label] = {"max_rel_err": err, "warp_cycles": total,
                         "share": {p: cycles[i] / total
                                   for i, p in enumerate(PHASES)}}
    emit(phases)
    _b._loaded.pop("planar_stft")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
