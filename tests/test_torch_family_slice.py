"""The supervised beamformer family end to end: setk_tpu_torch against
setk_tpu on the CPU.

Inputs are made with numpy and handed to both packages:
``enhance_plain(beamformer=X)`` (what the fused kernels compute) against
the JAX ``enhance_fused`` in interpret mode at tests/test_pallas.py:396's
size; ``enhance_batch`` on the CPU, one-shot and online (chunked EMA);
``BatchEnhancer(beamformer="pmwf-0")``.  Each bar is stated with its
test.  The parts are in tests/test_torch_family.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.dsp.stft import StftConfig as JaxStftConfig
from setk_tpu.enhance.pipeline import enhance_fused as jax_fused
from setk_tpu.parallel import executor as jex
from setk_tpu.parallel.enhance_step import enhance_batch as jax_enhance
from setk_tpu_torch.convert import stft_config_from_fields
from setk_tpu_torch.enhance import pipeline
from setk_tpu_torch.parallel import executor as tex
from setk_tpu_torch.parallel.enhance_step import enhance_batch

JCFG = JaxStftConfig()
CFG = stft_config_from_fields(**dataclasses.asdict(JCFG))
FAMILY = ("gevd", "pmwf-0", "pmwf-1", "mpdr", "mpdr-whiten")
SLICE_TOL = 1e-3   # the JAX package's CPU parity bar for its pipelines


def _peak_err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _gated(seed, b, n, s, int16=False):
    """Waveform scene of test_pallas.py:413-424 (a source in on/off bursts
    of 2048 samples, delayed one sample per mic, noise at 0.05, a 0.95 /
    0.05 mask that follows the bursts), with the source nearest mic 0:
    attenuated 1/(1 + k/4) at mic k, so that PMWF's SNR-selected reference
    channel is mic 0 with a clear margin.  Returns wav, mask and the
    source as mic 0 sees it."""
    rng = np.random.default_rng(seed)
    gate_t = (np.arange(s) // 2048) % 2 == 0
    src = (rng.standard_normal((b, 1, s)) * 0.5 * gate_t).astype(np.float32)
    wav = np.concatenate([np.roll(src, k, axis=-1) / (1 + k / 4)
                          for k in range(n)], axis=1)
    wav = (wav + rng.standard_normal((b, n, s)) * 0.05).astype(np.float32)
    if int16:
        wav = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    t = CFG.num_frames(s)
    gate_f = gate_t[np.minimum(np.arange(t) * CFG.frame_hop, s - 1)]
    mask = np.broadcast_to(np.where(gate_f, 0.95, 0.05)[:, None],
                           (b, t, CFG.num_bins)).astype(np.float32)
    return wav, mask, src[:, 0]


# the fused pipeline's plain path against the JAX enhance_fused in
# interpret mode: 2e-3 is the JAX package's own fused-vs-XLA bar for the
# family (test_pallas.py:449); both sides run the same solves, and every
# name holds 1e-3 here
FUSED_CASES = [(name, False) for name in ("mvdr",) + FAMILY] + \
    [("gevd", True)]


@pytest.mark.parametrize("name,ban", FUSED_CASES)
def test_enhance_plain_family_matches_jax_fused(name, ban):
    wav, mask, _ = _gated(11, 1, 3, 8192)
    ref = jax_fused(jnp.asarray(wav), jnp.asarray(mask), JCFG,
                    beamformer=name, ban=ban, steer="power", interpret=True)
    got = pipeline.enhance_plain(torch.from_numpy(wav), torch.from_numpy(mask),
                                 CFG, beamformer=name, ban=ban)
    assert _peak_err(got, ref) <= SLICE_TOL


@pytest.mark.parametrize("name", FAMILY)
@pytest.mark.parametrize("ban", [False, True])
def test_enhance_batch_family_matches_jax(name, ban):
    wav, mask, _ = _gated(12, 2, 3, 8192, int16=True)
    ref = jax_enhance(jnp.asarray(wav), jnp.asarray(mask), JCFG,
                      beamformer=name, ban=ban)
    got = enhance_batch(wav, mask, CFG, beamformer=name, ban=ban,
                        device="cpu")
    assert _peak_err(got, ref) <= SLICE_TOL


@pytest.mark.parametrize("name", ["mvdr", "gevd", "pmwf-0"])
def test_online_enhance_batch_matches_jax(name):
    wav, mask, _ = _gated(13, 2, 3, 16384)
    ref = jax_enhance(jnp.asarray(wav), jnp.asarray(mask), JCFG,
                      beamformer=name, chunk_size=32, alpha=0.8)
    got = enhance_batch(wav, mask, CFG, beamformer=name, chunk_size=32,
                        alpha=0.8, device="cpu")
    assert _peak_err(got, ref) <= SLICE_TOL


def test_batch_enhancer_pmwf_matches_jax():
    j_enh = jex.BatchEnhancer(JCFG, beamformer="pmwf-0", batch_size=2,
                              samples_per_bucket=8192)
    t_enh = tex.BatchEnhancer(CFG, beamformer="pmwf-0", batch_size=2,
                              samples_per_bucket=8192, device="cpu")
    assert t_enh.beamformer == "pmwf-0"
    ref, got, sources = {}, {}, {}
    for i, n in enumerate([8192, 12000, 16384]):
        wav, mask, src = _gated(20 + i, 1, 3, n, int16=bool(i % 2))
        sources[f"u{i}"] = src[0]
        ref.update(j_enh.add(f"u{i}", wav[0], mask[0]))
        got.update(t_enh.add(f"u{i}", wav[0], mask[0]))
    ref.update(j_enh.flush())
    got.update(t_enh.flush())
    assert set(got) == set(ref) == set(sources)
    for key, out in got.items():
        assert out.shape == sources[key].shape and np.isfinite(out).all()
        assert _peak_err(out, ref[key]) <= SLICE_TOL
        assert np.corrcoef(out, sources[key])[0, 1] > 0.9
