#!/usr/bin/env python3
"""How kernel 18's accumulation form moves its time and the WPE loop's
float64 distance.

    python3 tools/wpe_gram_forms.py [--out-dir DIR]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/wpe_gram.cu
three ways, by text substitutions of the shipped source (it stops if a
substituted line is missing):

  fma           as shipped: each complex multiply-add as explicit FFMAs
  pairsum_prod  the Gram's products as acc += a.x b.x + a.y b.y (a FMUL,
                an FFMA and a FADD a component, one rounding into the
                accumulator a term)
  pairsum_both  that form in the dereverberation's tap sums too

times each (CUDA events, two turns) at the WPE scene (32 x 8 s, 8,224
bins, T = 501: use_g, the first iteration) and WPD's shape (32 x 4 s,
external lambda), then runs tools/wpe_precision.py with each build in the
port's library table and prints its `kernels` and `kgram_psolve`
variants' distances from the float64 loop (largest |diff| over the peak,
the median utterance's, the relative Frobenius norm).  Each form's full
wpe_precision lines go to DIR/wpe_precision_<form>.jsonl.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PRODUCTS = """\
              acc_re[r][c] = fmaf(a[r].x, b[c].x, acc_re[r][c]);
              acc_re[r][c] = fmaf(a[r].y, b[c].y, acc_re[r][c]);
              acc_im[r][c] = fmaf(a[r].y, b[c].x, acc_im[r][c]);
              acc_im[r][c] = fmaf(-a[r].x, b[c].y, acc_im[r][c]);"""
PRODUCTS_PAIRSUM = """\
              acc_re[r][c] += a[r].x * b[c].x + a[r].y * b[c].y;
              acc_im[r][c] += a[r].y * b[c].x - a[r].x * b[c].y;"""
TAPS = """\
            acc[m].x = fmaf(g.x, x.x, acc[m].x);
            acc[m].x = fmaf(g.y, x.y, acc[m].x);
            acc[m].y = fmaf(g.x, x.y, acc[m].y);
            acc[m].y = fmaf(-g.y, x.x, acc[m].y);"""
TAPS_PAIRSUM = """\
            acc[m].x += g.x * x.x + g.y * x.y;
            acc[m].y += g.x * x.y - g.y * x.x;"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out-dir", default=str(ROOT / "chiprun_out"),
                        help="where each form's wpe_precision lines go")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wpe_gram_forms: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.enhance.wpe import compute_lambda
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import cholesky as ch
    from setk_tpu_torch.ops.cuda import wpe_gram as wg
    spec = importlib.util.spec_from_file_location(
        "wpe_precision", ROOT / "tools" / "wpe_precision.py")
    precision = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(precision)

    src = (_b.SOURCE_DIR / "wpe_gram.cu").read_text()
    if PRODUCTS not in src or TAPS not in src:
        print("wpe_gram_forms: the shipped source no longer has the lines "
              "it substitutes", file=sys.stderr)
        return 1
    forms = {"fma": src,
             "pairsum_prod": src.replace(PRODUCTS, PRODUCTS_PAIRSUM),
             "pairsum_both": src.replace(PRODUCTS, PRODUCTS_PAIRSUM)
                                .replace(TAPS, TAPS_PAIRSUM)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    build = _b.BUILD_DIR / "forms"
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in forms.items():
        (build / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_b._nvcc(), *_b._FLAGS, f"-I{_b.SOURCE_DIR}", "-o",
             str(build / f"{name}.so"), str(build / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        print(json.dumps({"form": name, "ptxas": cs._ptxas_summary(log)}))
        lib = ctypes.CDLL(str(build / f"{name}.so"))
        for fn, argtypes in _b._SIGNATURES["wpe_gram"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    cfg = StftConfig()
    n, taps, delay = cs.N, cs.W_TAPS, cs.W_DELAY
    nk = n * taps
    wav = torch.from_numpy(cs._wpe_scene(cs.W_B, n, cs.W_SECS * cs.SR, 20,
                                         False)).to(dev)
    obs = cs._spectra(torch, wav, cfg)
    flat = obs.reshape(-1, n, obs.shape[-1]).contiguous()
    g = ch.solve_wpe_gram_plain(wg.wpe_gram_plain(
        flat, None, taps, delay, cs.W_CONTEXT, False), n, nk, n)
    wav = torch.from_numpy(cs._wpe_scene(cs.W_B, n, cs.WPD_SECS * cs.SR, 24,
                                         False)).to(dev)
    obs_d = cs._spectra(torch, wav, cfg)
    flat_d = obs_d.reshape(-1, n, obs_d.shape[-1]).contiguous()
    lam = compute_lambda(obs_d, cs.W_CONTEXT).reshape(
        flat_d.shape[0], -1).contiguous()
    cases = {"use_g": (flat, g, None, cs.W_CONTEXT, True),
             "first": (flat, None, None, cs.W_CONTEXT, False),
             "wpd": (flat_d, None, lam, 0, False)}
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            _b._loaded["wpe_gram"] = lib
            for case, (o, gg, ll, ctx, use_g) in cases.items():
                times.setdefault(f"{name}@{case}", []).append(cs._time_ms(
                    torch, lambda: wg.wpe_gram(o, gg, taps, delay, ctx,
                                               use_g, ll),
                    iters=10, warmup=1))
    print(json.dumps({"kernel_18_ms": times, "card": card}))
    del flat, g, flat_d, lam, obs, obs_d, wav
    torch.cuda.empty_cache()
    out_dir = Path(args.out_dir)
    for name, lib in libs.items():
        _b._loaded["wpe_gram"] = lib
        out = out_dir / f"wpe_precision_{name}.jsonl"
        sys.argv = ["wpe_precision", "--out", str(out)]
        if precision.main() != 0:
            return 1
        for line in out.read_text().splitlines():
            rec = json.loads(line)
            if rec.get("variant") in ("kernels", "kgram_psolve"):
                print(json.dumps({
                    "form": name, "scene": rec["scene"],
                    "variant": rec["variant"], "max_rel": rec["max_rel"],
                    "per_utt_median": rec["per_utt_median"],
                    "rel_fro": rec["rel_fro"]}))
    _b._loaded.pop("wpe_gram")
    return 0


if __name__ == "__main__":
    sys.exit(main())
