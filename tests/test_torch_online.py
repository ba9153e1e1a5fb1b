"""The online (chunked EMA) MVDR slice of setk_tpu_torch against setk_tpu.

Inputs come from numpy seeds and go through both packages on the CPU:

- the online kernels' plain versions (kernel A per chunk, the EMA, the
  online kernel B) and their composition ``enhance_plain_online``
  against setk_tpu's ``compute_covar``/``beamform``/``inverse_stft`` and
  ``online_supervised_run`` with the power steer swapped in, as
  tests/test_pallas.py:588-596 does, at chunk 16 and at chunk 5, which the
  TPU gate refuses: 1e-3 of the peak, tighter than the JAX package's own
  2e-3 (tests/test_pallas.py:600);
- ``mvdr_enhance_fused_online`` against the Pallas online pair in
  interpret mode;
- ``enhance_batch(chunk_size>0)`` and ``BatchEnhancer(chunk_size=16)`` on
  the CPU against the JAX entry points, 1e-3 of the peak;
- on a CUDA device (the device check mocked) the entry sends online mvdr
  to the online kernels for any chunk and refuses every other online
  option before anything is copied to the card.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.dsp.stft import StftConfig as JaxStftConfig
from setk_tpu.dsp.stft import forward_stft as jax_stft
from setk_tpu.dsp.stft import inverse_stft as jax_istft
from setk_tpu.dsp.window import wss_inverse_blocks
from setk_tpu.enhance import beamformer as jbf
from setk_tpu.enhance.pipeline import \
    mvdr_enhance_fused_online as jax_fused_online
from setk_tpu.parallel import executor as jex
from setk_tpu.parallel.enhance_step import enhance_batch as jax_enhance
from setk_tpu_torch.convert import stft_config_from_fields
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance import pipeline
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.parallel import enhance_step
from setk_tpu_torch.parallel import executor as tex
from setk_tpu_torch.parallel.enhance_step import enhance_batch

JCFG = JaxStftConfig()
CFG = stft_config_from_fields(**dataclasses.asdict(JCFG))
TOL = 1e-3
B, N, S, ALPHA = 2, 3, 16384, 0.7
CHUNKS = [16, 5]


def _peak_err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _scene(seed, b=B, n=N, s=S):
    """A source seen by every mic plus independent noise, and a mask."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((b, 1, s)).astype(np.float32) * 0.2
    wav = clean + rng.standard_normal((b, n, s)).astype(np.float32) * 0.05
    mask = rng.random((b, CFG.num_frames(s), CFG.num_bins)).astype(
        np.float32)
    return wav, mask


def _jax_chunks(wav, mask, chunk):
    """setk_tpu's spectrum (B, F, N, T') and masks (B, F, T'), padded to
    a whole number of chunks with the noise mask made before padding, as
    setk_tpu/parallel/enhance_step.py:80-98 does."""
    obs = jnp.transpose(jax_stft(jnp.asarray(wav), JCFG), (0, 3, 1, 2))
    mk = jnp.transpose(jnp.asarray(mask), (0, 2, 1))
    mn = jnp.maximum(1.0 - mk, 0.0)
    pad = (-obs.shape[-1]) % chunk
    width = ((0, 0), (0, 0), (0, pad))
    return (jnp.pad(obs, ((0, 0),) + width), jnp.pad(mk, width),
            jnp.pad(mn, width))


def _window():
    return torch.as_tensor(CFG.padded_window, dtype=torch.float32)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunk_covariances_and_ema_match_setk_tpu(chunk):
    """Kernel A per chunk and the EMA (plain versions) against setk_tpu's
    compute_covar per chunk, blended as online_supervised_run does."""
    wav, mask = _scene(10 + chunk)
    part = fm.stft_covar_chunks_plain(torch.from_numpy(wav),
                                      torch.from_numpy(mask), _window(),
                                      chunk)
    es, en = fm.covar_ema_plain(part, torch.from_numpy(mask), chunk, ALPHA)
    obs, mk, mn = _jax_chunks(wav, mask, chunk)
    c = fm.num_chunks(CFG.num_frames(S), chunk)
    assert es.shape == (B, c, CFG.num_bins, N, N)
    ref_s = ref_n = None
    for i in range(c):
        sl = slice(i * chunk, (i + 1) * chunk)
        rs = jbf.compute_covar(obs[..., sl], mk[..., sl])
        rn = jbf.compute_covar(obs[..., sl], mn[..., sl])
        ref_s = rs if ref_s is None else ref_s * ALPHA + (1 - ALPHA) * rs
        ref_n = rn if ref_n is None else ref_n * ALPHA + (1 - ALPHA) * rn
        assert _peak_err(es[:, i], ref_s) < TOL
        assert _peak_err(en[:, i], ref_n) < TOL


@pytest.mark.parametrize("chunk", CHUNKS)
def test_online_beamform_istft_matches_setk_tpu(chunk):
    """The online kernel B's plain version against setk_tpu's beamform
    with each chunk's weights and inverse_stft."""
    wav, _ = _scene(20 + chunk)
    rng = np.random.default_rng(chunk)
    t = CFG.num_frames(S)
    c = fm.num_chunks(t, chunk)
    w = (rng.standard_normal((B, c, CFG.num_bins, N)) + 1j *
         rng.standard_normal((B, c, CFG.num_bins, N))).astype(np.complex64)
    wss = torch.from_numpy(wss_inverse_blocks(CFG.padded_window, t, 256, 512,
                                              S))
    got = fm.beamform_istft_online_plain(torch.from_numpy(wav),
                                         torch.from_numpy(w), wss, _window(),
                                         chunk)
    obs, _, _ = _jax_chunks(wav, np.zeros((B, t, CFG.num_bins), np.float32),
                            chunk)
    enh = jnp.concatenate(
        [jbf.beamform(jnp.asarray(w[:, i]),
                      obs[..., i * chunk:(i + 1) * chunk]) for i in range(c)],
        axis=-1)[..., :t]
    ref = jax_istft(jnp.swapaxes(enh, -1, -2), JCFG, nsamps=S)
    assert _peak_err(got, ref) < TOL


def _jax_online_power(wav, mask, chunk):
    """setk_tpu's online_supervised_run with the power steer
    (tests/test_pallas.py:588-596), through inverse_stft."""
    obs, mk, mn = _jax_chunks(wav, mask, chunk)
    t = CFG.num_frames(S)
    power = functools.partial(jbf.mvdr_weights, steer="power",
                              use_pallas=False)
    orig = jbf.WEIGHT_FNS["mvdr"]
    jbf.WEIGHT_FNS["mvdr"] = power
    try:
        enh = jbf.online_supervised_run("mvdr", obs, mk, mask_n=mn,
                                        chunk_size=chunk,
                                        alpha=ALPHA)[..., :t]
    finally:
        jbf.WEIGHT_FNS["mvdr"] = orig
    return jax_istft(jnp.swapaxes(enh, -1, -2), JCFG, nsamps=S)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("int16", [False, True])
def test_enhance_plain_online_matches_setk_tpu(chunk, int16):
    wav, mask = _scene(30 + chunk)
    if int16:
        wav = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    ref = _jax_online_power(
        wav.astype(np.float32) / 32768.0 if int16 else wav, mask, chunk)
    for fn in (pipeline.enhance_plain_online,
               pipeline.mvdr_enhance_fused_online):
        got = fn(torch.from_numpy(wav), torch.from_numpy(mask), CFG,
                 chunk_size=chunk, alpha=ALPHA)
        assert _peak_err(got, ref) < TOL


def test_fused_online_matches_pallas_online_pair():
    """The port's online pipeline against setk_tpu's Pallas online pair
    in interpret mode (chunk 16: the TPU gate needs chunk | 128)."""
    wav, mask = _scene(40)
    ref = jax_fused_online(jnp.asarray(wav), jnp.asarray(mask), JCFG,
                           chunk_size=16, alpha=ALPHA, interpret=True)
    got = pipeline.mvdr_enhance_fused_online(
        torch.from_numpy(wav), torch.from_numpy(mask), CFG, chunk_size=16,
        alpha=ALPHA)
    assert _peak_err(got, ref) < TOL


@pytest.mark.parametrize("chunk", CHUNKS)
def test_enhance_batch_online_cpu_matches_setk_tpu(chunk):
    wav, mask = _scene(50 + chunk)
    wav16 = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    got = enhance_batch(wav16, mask, CFG, chunk_size=chunk, alpha=ALPHA,
                        device="cpu")
    ref = jax_enhance(jnp.asarray(wav16), jnp.asarray(mask), JCFG,
                      chunk_size=chunk, alpha=ALPHA)
    assert _peak_err(got, ref) < TOL


def test_batch_enhancer_online_matches_setk_tpu():
    rng = np.random.default_rng(60)
    utts = []
    for i, s in enumerate((12000, 16384, 9000)):
        clean = rng.standard_normal(s).astype(np.float32) * 0.2
        x = clean + rng.standard_normal((N, s)).astype(np.float32) * 0.05
        m = rng.random((CFG.num_frames(s), CFG.num_bins)).astype(np.float32)
        utts.append((f"u{i}", x, m))
    kw = {"batch_size": 2, "chunk_size": 16, "alpha": ALPHA}
    port = tex.BatchEnhancer(CFG, device="cpu", **kw)
    ref = jex.BatchEnhancer(JCFG, **kw)
    got, want = {}, {}
    for key, x, m in utts:
        got.update(port.add(key, x, m))
        want.update(ref.add(key, x, m))
    got.update(port.flush())
    want.update(ref.flush())
    assert set(got) == set(want) == {k for k, _, _ in utts}
    for key, x, _ in utts:
        assert got[key].shape == (x.shape[-1],)
        assert _peak_err(got[key], want[key]) < TOL


def test_cuda_entry_runs_online_kernels(monkeypatch):
    """On a CUDA device (the device check mocked, the tensors kept on the
    CPU) online mvdr goes to mvdr_enhance_fused_online for any chunk,
    the TPU gate's refusals (5, 24, T > 512) included."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(enhance_step, "_as_tensor",
                        lambda x, dev: torch.as_tensor(x))
    calls = []

    def fused_online(wav, mask, cfg, chunk_size, alpha, nsamps):
        calls.append((chunk_size, alpha, nsamps))
        return pipeline.mvdr_enhance_fused_online(
            wav, mask, cfg, chunk_size=chunk_size, alpha=alpha,
            nsamps=nsamps)

    monkeypatch.setattr(enhance_step, "mvdr_enhance_fused_online",
                        fused_online)
    counted = (fm.stft_covar, fm.covar_ema, mv.mvdr_power,
               fm.beamform_istft_online)
    for fn in counted:
        monkeypatch.setattr(fn, "launches", 0)
    for chunk, s in ((5, 4096), (24, 4096), (32, 131072)):
        wav, mask = _scene(70 + chunk, b=1, n=2, s=s)
        out = enhance_batch(wav, mask, CFG, chunk_size=chunk, device="cuda")
        assert out.shape == (1, s) and torch.isfinite(out).all()
    assert calls == [(5, 0.8, None), (24, 0.8, None), (32, 0.8, None)]
    # CPU tensors never count a kernel launch
    assert [fn.launches for fn in counted] == [0, 0, 0, 0]


def test_cuda_entry_refuses_other_online_options(monkeypatch):
    """On a CUDA device gevd/pmwf online, mvdr+BAN online, the eigh steer
    online and online outside the fused gate take the spectrum-domain
    online run (the covariance and EVD kernels), which computes what the
    CPU's run computes; an unknown name raises ValueError before anything
    is copied to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(enhance_step, "_as_tensor",
                        lambda x, dev: torch.as_tensor(x))
    calls = []

    def record(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(enhance_step, "mvdr_enhance_fused_online",
                        record("online kernels",
                               enhance_step.mvdr_enhance_fused_online))
    monkeypatch.setattr(enhance_step.bf, "online_supervised_run",
                        record("spectrum", bf.online_supervised_run))
    wav, mask = _scene(80, b=1, n=2, s=4096)
    for kw in ({"beamformer": "gevd"}, {"beamformer": "pmwf-0"},
               {"beamformer": "pmwf-1"}, {"ban": True},
               {"steer": "eigh"}, {"nsamps": 4000}):
        calls.clear()
        got = enhance_batch(wav, mask, CFG, chunk_size=32, device="cuda",
                            **kw)
        assert calls == ["spectrum"], kw
        ref = enhance_batch(wav, mask, CFG, chunk_size=32, device="cpu",
                            **kw)
        assert torch.equal(got, ref), kw

    def no_copy(x, dev):
        raise AssertionError("copied to the card before refusing")

    monkeypatch.setattr(enhance_step, "_as_tensor", no_copy)
    with pytest.raises(ValueError, match="Unknown online beamformer"):
        enhance_batch(wav, mask, CFG, chunk_size=32, beamformer="mpdr",
                      device="cuda")
    assert not pipeline.fused_online_supported(CFG, 2, 4096, 4096, 0)
    assert pipeline.fused_online_supported(CFG, 2, 4096, 4096, 1)
