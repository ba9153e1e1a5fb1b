#!/usr/bin/env python3
"""Kernels A (the fused STFT + masked covariance) and B (the fused
beamform + iSTFT) built in several variants of
setk_tpu_torch/csrc/fused_mvdr.cu and timed side by side.

    python3 tools/fused_variants.py [--variants FILE] [--sass DIR]
                                    [--out FILE]

Needs one CUDA card and nvcc.  A variant is a list of [old, new] text
substitutions on the source, or the path (from the repository root) of
another fused_mvdr.cu with the same C entry points; each is built with
nvcc, all at once.  Without --variants it builds the source as it is
beside three variants that drop work, for timing only, since their
results are wrong: no_samples (kernel A's next tile's samples not
copied), no_mask (the mask not copied), neither; the difference bounds
what the copies cost.  --variants FILE reads {name: variant} from a JSON
file; tools/fused_b_variants.json holds kernel B's design choices (warps a
block, offline weights from shared memory or through L1).

It prints each build's -Xptxas -v registers, spills and shared memory for
kernels A and B's int16 instances, then times both in turns (every
variant, then in reverse) at chip_smoke.py's bench scene: kernel A offline
at B = 128, 6 mics, 8 s (offline_N6), per chunk at chunk 32 (chunk32_N6)
and offline at 8 mics (offline_N8); kernel B offline (b_offline_N6,
b_offline_N8) and online at chunk 32 (b_chunk32_N6) with the plain MVDR
solve's weights; each from a CUDA-graph replay, with its largest error
against the plain version relative to its peak.  --sass DIR writes each
build's SASS of kernels A and B at N = 6 and 8 (int16) there
(cuobjdump).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from fused_phase_profile import CHUNK, _scene, _weights  # noqa: E402
from wpe_phase_profile import _nvcc_all, _smi  # noqa: E402

_NEXT_SAMPLES = """    if (t0 + C::TF < t_end)
      a_stage<N, T>(ring, x, S, t0 + C::TF,"""
_MASK = "ms + a_stage_mask(ms, mrows + (size_t)t0 * kBins, nv);"
STAGING = {
    "as_is": [],
    "no_samples": [[_NEXT_SAMPLES, _NEXT_SAMPLES.replace(
        "t0 + C::TF < t_end", "t0 + C::TF < t_end && S < 0")]],
    "no_mask": [[_MASK, "ms;"]],
    "neither": [[_NEXT_SAMPLES, _NEXT_SAMPLES.replace(
        "t0 + C::TF < t_end", "t0 + C::TF < t_end && S < 0")],
        [_MASK, "ms;"]],
}
SASS_KEYS = ("stft_covar_kernelILi6EsE", "stft_covar_kernelILi8EsE",
             "beamform_istft_kernelILi6EsE", "beamform_istft_kernelILi8EsE")


def _sources(variants, out_dir):
    """Write each variant's fused_mvdr.cu under out_dir: {name: path}."""
    base = (ROOT / "setk_tpu_torch" / "csrc" / "fused_mvdr.cu").read_text()
    paths = {}
    for name, variant in variants.items():
        if isinstance(variant, str):
            text = (ROOT / variant).read_text()
        else:
            text = base
            for old, new in variant:
                if old not in text:
                    raise SystemExit(f"{name}: {old[:60]!r} is not in the "
                                     f"source")
                text = text.replace(old, new)
        path = out_dir / name / "fused_mvdr.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths[name] = path
    return paths


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=None,
                        help="a JSON file of {name: variant}")
    parser.add_argument("--sass", default=None,
                        help="write kernels A and B's SASS of each build "
                             "here")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.dsp.window import wss_inverse_blocks
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import fused_mvdr as fm
    from setk_tpu_torch.ops.cuda import mvdr as mv

    variants = (json.loads(Path(args.variants).read_text()) if args.variants
                else STAGING)
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    paths = _sources(variants, _b.BUILD_DIR / "variants")
    built = {name: _nvcc_all(_b, {"fused_mvdr": path}, f"variant-{name}")[
        "fused_mvdr"] for name, path in paths.items()}
    for name, (_, log) in built.items():
        emit({"variant": name, "card": card, "ptxas": {
            k: v for k, v in cs._ptxas_summary(log).items()
            if k.startswith(("stft_covar<", "beamform_istft"))
            and k.endswith("int16>")}})
        if args.sass:
            so = _b.BUILD_DIR / f"libfused_mvdr-variant-{name}.so"
            sass = subprocess.run([_b._nvcc().replace("nvcc", "cuobjdump"),
                                   "-sass", str(so)], capture_output=True,
                                  text=True, check=True).stdout
            keep, kept = False, []
            for line in sass.splitlines():
                if "Function :" in line:
                    keep = any(key in line for key in SASS_KEYS)
                if keep:
                    kept.append(line)
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            (Path(args.sass) / f"sass_{name}.txt").write_text(
                "\n".join(kept))

    dev = torch.device("cuda", 0)
    cfg = StftConfig()
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    wav, mask = (torch.from_numpy(x).to(dev)
                 for x in _scene(np, cs.B, cs.N, cs.S, 0))
    wav8, mask8 = (torch.from_numpy(x).to(dev)
                   for x in _scene(np, cs.B, 8, cs.S, 1))

    def flat(x):
        return torch.cat(x, -1) if isinstance(x, tuple) else x

    cases = {
        "offline_N6": (lambda: fm.stft_covar(wav, mask, window),
                       fm.stft_covar_plain(wav, mask, window)),
        "chunk32_N6": (lambda: fm.stft_covar_chunks(wav, mask, window, 32),
                       fm.stft_covar_chunks_plain(wav, mask, window, 32)),
        "offline_N8": (lambda: fm.stft_covar(wav8, mask8, window),
                       fm.stft_covar_plain(wav8, mask8, window)),
    }
    wss = torch.as_tensor(wss_inverse_blocks(
        cfg.padded_window, cs.S // 256 + 1, 256, 512, cs.S), device=dev)
    w, w_on = _weights(torch, fm, mv, wav, mask, window)
    w8, _ = _weights(torch, fm, mv, wav8, mask8, window)
    cases.update({
        "b_offline_N6": (lambda: fm.beamform_istft(wav, w, wss, window),
                         fm.beamform_istft_plain(wav, w, wss, window)),
        "b_chunk32_N6": (lambda: fm.beamform_istft_online(
            wav, w_on, wss, window, CHUNK), fm.beamform_istft_online_plain(
                wav, w_on, wss, window, CHUNK)),
        "b_offline_N8": (lambda: fm.beamform_istft(wav8, w8, wss, window),
                         fm.beamform_istft_plain(wav8, w8, wss, window)),
    })
    names = list(built)
    for turn, name in enumerate(names + names[::-1]):
        _b._loaded["fused_mvdr"] = built[name][0]
        row = {"turn": turn, "variant": name, "card": card}
        for label, (fn, ref) in cases.items():
            row[label] = {"ms": cs._graph_ms(torch, fn, iters=10),
                          "max_rel_err": cs._rel(flat(fn()), flat(ref))}
        emit(row)
    _b._loaded.pop("fused_mvdr")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
