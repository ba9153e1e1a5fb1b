#!/usr/bin/env python3
"""Where the spatial and separation commands' time goes on the card.

    python3 tools/spatial_profile.py [--out FILE]

Needs one CUDA card (and nvcc: kernel 13 and the EVD kernel build on
first use).  It writes chip_smoke.py's S scene (8 utterances of 8 s on
the default 6-mic circle, 0.95/0.05 masks) under setk_tpu_torch/_build
and runs each command below on the card in this process: three timed
runs (seconds an utterance; the first pays each kernel's and library's
first use), then one run under torch.profiler.  For that run it prints
the wall seconds, the device time by kernel (the 8 largest), the host's
self time by operator (the 8 largest) and the idle share, 1 - (device
kernel time) / (wall time), one JSON line a command:

  do_ssl ml / srp / music, offline and online (--chunk-len 32
  --look-back 125, 2 utterances), compute_circular_srp,
  compute_ipd_and_linear_srp --type srp, compute_df_on_mask,
  apply_sd_beamformer --utt2doa, wav_separate.

The card's name and power limit come first (nvidia-smi).
"""

import argparse
import importlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _commands(root, sv):
    wav, mask = str(root / "wav.scp"), str(root / "mask.scp")
    online = ["--chunk-len", "32", "--look-back", "125"]
    ssl = ["--doa-range", "0,360", "--mask-scp", mask]
    out = []
    for backend in ("ml", "srp", "music"):
        extra = ssl + ["--backend", backend] + (
            ["--srp-pair", "0,3;1,4;2,5"] if backend == "srp" else [])
        out.append((f"do_ssl-{backend}", "do_ssl", 8,
                    lambda o, e=extra: [wav, sv, str(o / "doa")] + e))
        out.append((f"do_ssl-{backend}-online", "do_ssl", 2,
                    lambda o, e=extra: [str(root / "online.scp"), sv,
                                        str(o / "doa")] + e + online))
    feats = (lambda o: [str(o / "f.ark"), "--scp", str(o / "f.scp")])
    out += [
        ("compute_circular_srp", "compute_circular_srp", 8,
         lambda o: [wav] + feats(o)),
        ("compute_ipd_and_linear_srp-srp", "compute_ipd_and_linear_srp", 8,
         lambda o: [wav] + feats(o) + [
             "--type", "srp", "--linear-topo",
             "0,0.05,0.1,0.15,0.2,0.25"]),
        ("compute_df_on_mask", "compute_df_on_mask", 8,
         lambda o: [wav, mask] + feats(o) + ["--fmt", "numpy"]),
        ("apply_sd_beamformer", "apply_sd_beamformer", 8,
         lambda o: [wav, str(o), "--geometry", "circular", "--utt2doa",
                    str(root / "utt2doa.scp")]),
        ("wav_separate", "wav_separate", 8,
         lambda o: [wav, mask, str(o), "--fmt", "numpy"])]
    return out


def _profile(torch, run, top=8):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    device = sorted(((ev.self_device_time_total / 1e3, ev.key[:70])
                     for ev in events
                     if ev.device_type == torch.autograd.DeviceType.CUDA),
                    reverse=True)
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.key[:70])
                   for ev in events), reverse=True)
    busy = sum(ms for ms, _ in device)
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "device_top": [[k, ms] for ms, k in device[:top]],
            "host_self_top": [[k, ms] for ms, k in host[:top]]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="", help="Also write the lines "
                        "to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("spatial_profile: no CUDA device")
        return 2
    import chip_smoke as cs
    from setk_tpu_torch.ops.cuda import _build
    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]]
    print(lines[0])
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        root = Path(tmp)
        cs._write_spatial_corpus(np, root, "circular", cs.S_UTTS,
                                 cs.S_SECS, seed=42)
        (root / "online.scp").write_text("".join(
            (root / "wav.scp").read_text().splitlines(True)[:2]))
        sv = root / "sv.npy"
        from setk_tpu_torch.cli import compute_steer_vector as csv_cli
        csv_cli.run(csv_cli.make_parser().parse_args(
            [str(sv), "--geometry", "circular", "--num-doas", "360",
             "--device", "cpu"]))
        for label, command, utts, argv_of in _commands(root, str(sv)):
            mod = importlib.import_module(f"setk_tpu_torch.cli.{command}")
            row = {"command": label, "utterances": utts, "s_per_utt": []}
            for k in range(4):
                out = root / f"{label}-{k}"
                out.mkdir()
                margs = mod.make_parser().parse_args(argv_of(out) + [
                    "--device", "cuda"])
                if k < 3:
                    t0 = time.perf_counter()
                    mod.run(margs)
                    torch.cuda.synchronize()
                    row["s_per_utt"].append(
                        (time.perf_counter() - t0) / utts)
                else:
                    row["profile"] = _profile(torch,
                                              lambda: mod.run(margs))
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
