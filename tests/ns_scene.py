"""The noise-suppression scene of the OM-LSA tests (numpy only).

A noise floor with speech-like bursts, so that the OM-LSA estimators
take their speech-presence branches; tests/test_torch_ns.py,
tests/test_torch_cuda_emu.py and tests/test_torch_gpu.py share it.
``jax_mcra_gain_without_fma`` runs setk_tpu's MCRA in a process of its
own (tests/test_torch_ns.py, tests/test_torch_longtail_cli.py).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
_MCRA_WITHOUT_FMA = """
import json, sys
import jax.numpy as jnp
import numpy as np
from setk_tpu.enhance import ns
data = np.load(sys.argv[1])
confs = json.loads(sys.argv[2])
np.savez(sys.argv[3], *[np.asarray(ns.mcra_gain(
    jnp.asarray(data[f"arr_{i}"]), ns.MCRAConfig(**conf)))
    for i, conf in enumerate(confs)])
"""


def scene(t, f, seed):
    """A noise floor (0.1) with bursts of 3.0 in a band around F / 3, in
    every third run of 12 frames: (T, F) complex64."""
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal((t, f)) +
             1j * rng.standard_normal((t, f))) * 0.1
    gate = ((np.arange(t) // 12) % 3 == 1)[:, None]
    band = np.exp(-((np.arange(f) - f / 3) / (f / 6))**2)[None]
    speech = (rng.standard_normal((t, f)) +
              1j * rng.standard_normal((t, f))) * 3.0 * band * gate
    return (noise + speech).astype(np.complex64)


def jax_mcra_gain_without_fma(cases, tmp_dir):
    """setk_tpu's jitted ``mcra_gain`` of each (x, conf) in ``cases``,
    with XLA's FMA contraction off: a process of its own under
    ``--xla_cpu_max_isa=AVX`` (no FMA instructions, so a * b + c rounds
    twice, as in the port; the flag is read once a process).  Returns
    the (T, F) gains in order."""
    tmp_dir = Path(tmp_dir)
    src, dst = tmp_dir / "mcra_in.npz", tmp_dir / "mcra_out.npz"
    np.savez(src, *[x for x, _ in cases])
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(_REPO), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _MCRA_WITHOUT_FMA, str(src),
                    json.dumps([conf for _, conf in cases]), str(dst)],
                   env=env, check=True, capture_output=True)
    with np.load(dst) as out:
        return [out[f"arr_{i}"] for i in range(len(cases))]
