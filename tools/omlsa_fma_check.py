#!/usr/bin/env python3
"""The OM-LSA kernel built with and without FMA contraction, against its
plain version on the card.

    python3 tools/omlsa_fma_check.py [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/omlsa.cu
through the port's own build twice, once with its flags as shipped
(-fmad=false) and once with nvcc's default contraction (-fmad=true; the
library's name hashes its flags, so both stay built), and holds each,
through the port's wrapper ``omlsa``, against ``omlsa_plain`` on the
card at one 8 s utterance (T = 501) of chip_smoke.py's O1 scene, both
estimators, F = 257, 513 and 1025 and O1's non-default configurations.
For each it prints one JSON line: the largest absolute gain difference,
the share of gains more than 1e-5 apart, the gains more than 1e-3 apart
(a threshold crossed: MCRA's rising frame, iMCRA's indicator, a presence
band) and the kernel's ms (CUDA events over 20 launches after 2).  The
card's name and power limit come first (nvidia-smi).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from setk_tpu_torch.enhance import ns
    from setk_tpu_torch.ops.cuda import _build as bld
    from setk_tpu_torch.ops.cuda import omlsa as om
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [smi]
    print(smi)
    dev = torch.device("cuda", 0)
    variants = {"no_fma (shipped)": bld._SOURCE_FLAGS["omlsa"],
                "fma": ["-fmad=true"]}
    configs = {"mcra": ns.MCRAConfig, "imcra": ns.IMCRAConfig}
    cases = [(est, f, {}) for est in configs for f in cs.O_F] + [
        (est, cs.O_F[0], conf) for est, conf in cs.O_CONF.items()]
    for est, f, conf in cases:
        cfg = configs[est](**conf)
        pw = torch.from_numpy(cs._o_scene(np, cs.O_T, f, seed=f))[None].to(
            dev)
        ref = om.omlsa_plain(pw, est, cfg)
        row = {"estimator": est, "F": f, "config": conf}
        for name, flags in variants.items():
            bld._SOURCE_FLAGS["omlsa"] = flags
            bld._loaded.pop("omlsa", None)
            run = lambda: om.omlsa(pw, est, cfg)
            gap = (run() - ref).abs()
            row[name] = {"max_abs_err": float(gap.max()),
                         "share_above_1e-5": float(
                             (gap > cs.O_SHARE).float().mean()),
                         "above_1e-3": int((gap > cs.O_FLIP).sum()),
                         "ms": cs._time_ms(torch, run)}
        bld._SOURCE_FLAGS["omlsa"] = variants["no_fma (shipped)"]
        bld._loaded.pop("omlsa", None)
        line = json.dumps(row)
        lines.append(line)
        print(line, flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
