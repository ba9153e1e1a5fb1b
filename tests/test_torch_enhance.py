"""The MVDR enhancement slice of setk_tpu_torch against setk_tpu on the CPU.

- kernel A's and kernel B's plain versions against the Pallas kernels
  in interpret mode (B=1, N=2, S=4096, int16 and f32), the covariances
  unscrambled from the TPU lane order with ``lane_permutation()``:
  1e-4 of the peak, the TPU kernels' error-compensated bf16 DFT;
- the whole slice (``enhance_batch``, the fused pipeline's plain path
  and ``BatchEnhancer``) against setk_tpu on the CPU at 1e-3 of the
  peak, the JAX package's bar for its fused pipeline
  (tests/test_pallas.py:306);
- the device rule: no CUDA and no ``device="cpu"`` raises, and CPU
  tensors never count a kernel launch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.dsp.stft import StftConfig as JaxStftConfig
from setk_tpu.dsp.window import wss_inverse_blocks
from setk_tpu.ops.pallas.fused_mvdr import (_T_PAD, beamform_istft_pallas,
                                            lane_permutation,
                                            stft_covar_pallas)
from setk_tpu.parallel import executor as jex
from setk_tpu.parallel.enhance_step import enhance_batch as jax_enhance
from setk_tpu_torch.convert import stft_config_from_fields
from setk_tpu_torch.enhance import pipeline
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.parallel import enhance_step
from setk_tpu_torch.parallel import executor as tex
from setk_tpu_torch.parallel.enhance_step import enhance_batch

JCFG = JaxStftConfig()
CFG = stft_config_from_fields(**dataclasses.asdict(JCFG))
SLICE_TOL = 1e-3
KERNEL_TOL = 1e-4


def _peak_err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _scene(seed, b, n, s, int16=False):
    """A source seen by every mic plus independent noise, and a mask."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((b, 1, s)).astype(np.float32) * 0.2
    wav = clean + rng.standard_normal((b, n, s)).astype(np.float32) * 0.05
    if int16:
        wav = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    mask = rng.random((b, CFG.num_frames(s), CFG.num_bins)).astype(
        np.float32)
    return wav, mask


def _pallas_edges(wav):
    """The TPU kernels' hop blocks and reflect edges (pipeline.py:104-106)."""
    b, n, s = wav.shape
    w = jnp.asarray(wav)
    return (w.reshape(b, n, s // 256, 256),
            jnp.stack([w[..., 256:0:-1], w[..., -2:-258:-1]], axis=2))


def _window_key():
    return np.asarray(JCFG.padded_window, np.float64).tobytes()


@pytest.mark.parametrize("int16", [False, True])
def test_stft_covar_plain_matches_pallas_kernel(int16):
    wav, mask = _scene(0, 1, 2, 4096, int16)
    t = CFG.num_frames(4096)
    wavb, edges = _pallas_edges(wav)
    m = jnp.asarray(mask)
    mask0 = jnp.pad(m[..., :256], ((0, 0), (0, _T_PAD - t), (0, 0)))
    mask_ny = jnp.pad(jnp.broadcast_to(m[..., 256:257], (1, t, 128)),
                      ((0, 0), (0, _T_PAD - t), (0, 0)))
    planes = stft_covar_pallas(wavb, edges, mask0, mask_ny, _window_key(),
                               n_valid_t=t, interpret=True)
    perm = lane_permutation()
    ref = []
    for re, im in (planes[:2], planes[2:]):
        lanes = (np.asarray(re) + 1j * np.asarray(im))[..., :257]
        nat = np.empty_like(lanes)
        nat[..., perm] = lanes                        # (B, N, N, F)
        ref.append(np.moveaxis(nat, -1, 1))           # (B, F, N, N)
    window = torch.as_tensor(CFG.padded_window)
    rs, rn = fm.stft_covar_plain(torch.from_numpy(wav),
                                 torch.from_numpy(mask), window)
    assert rs.dtype == torch.complex64 and rs.shape == (1, 257, 2, 2)
    assert _peak_err(rs, ref[0]) < KERNEL_TOL
    assert _peak_err(rn, ref[1]) < KERNEL_TOL


@pytest.mark.parametrize("int16", [False, True])
def test_beamform_istft_plain_matches_pallas_kernel(int16):
    b, n, s = 1, 2, 4096
    wav, _ = _scene(1, b, n, s, int16)
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((b, 257, n)) +
         1j * rng.standard_normal((b, 257, n))).astype(np.complex64)
    t = CFG.num_frames(s)
    wss = wss_inverse_blocks(JCFG.padded_window, t, 256, 512, s)
    # pack the weights the TPU way: lanes in [even | odd] bin order
    wl = w[:, lane_permutation()]
    wcat = np.concatenate(
        [np.real(wl[:, :256]).transpose(0, 2, 1),
         np.imag(wl[:, :256]).transpose(0, 2, 1),
         np.real(wl[:, 256:257]).transpose(0, 2, 1),
         np.zeros((b, n, 127), np.float32)], axis=-1).astype(np.float32)
    wavb, edges = _pallas_edges(wav)
    ref = np.asarray(beamform_istft_pallas(
        wavb, edges, jnp.asarray(wcat), jnp.asarray(wss), _window_key(),
        nblk_out=s // 256, interpret=True)).reshape(b, s)
    got = fm.beamform_istft_plain(torch.from_numpy(wav), torch.from_numpy(w),
                                  torch.from_numpy(wss),
                                  torch.as_tensor(CFG.padded_window))
    assert _peak_err(got, ref) < KERNEL_TOL


@pytest.mark.parametrize("steer,ban,int16", [
    ("auto", False, False), ("power", False, True), ("power", True, False),
    ("eigh", True, True)])
def test_enhance_batch_matches_jax(steer, ban, int16):
    wav, mask = _scene(3, 2, 3, 8192, int16)
    ref = jax_enhance(jnp.asarray(wav), jnp.asarray(mask), JCFG, ban=ban,
                      steer=steer)
    got = enhance_batch(wav, mask, CFG, ban=ban, steer=steer, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert _peak_err(got, ref) < SLICE_TOL


@pytest.mark.parametrize("ban", [False, True])
def test_fused_pipeline_plain_matches_jax(ban):
    """What the three kernels compute, end to end, against the JAX
    package's power-steer path; on CPU tensors the kernel wrappers run
    their plain versions and count no launch."""
    wav, mask = _scene(4, 2, 3, 16384, int16=True)
    ref = jax_enhance(jnp.asarray(wav), jnp.asarray(mask), JCFG, ban=ban,
                      steer="power")
    wt, mt = torch.from_numpy(wav), torch.from_numpy(mask)
    plain = pipeline.enhance_plain(wt, mt, CFG, ban=ban)
    assert _peak_err(plain, ref) < SLICE_TOL
    counted = (fm.stft_covar, mv.mvdr_power, fm.beamform_istft)
    before = [fn.launches for fn in counted]
    fused = pipeline.enhance_fused(wt, mt, CFG, ban=ban)
    assert [fn.launches for fn in counted] == before
    np.testing.assert_array_equal(fused.numpy(), plain.numpy())


def test_batch_enhancer_matches_jax():
    rng = np.random.default_rng(5)
    j_enh = jex.BatchEnhancer(JCFG, batch_size=2, samples_per_bucket=8192)
    t_enh = tex.BatchEnhancer(CFG, batch_size=2, samples_per_bucket=8192,
                              device="cpu")
    ref, got, cleans = {}, {}, {}
    for i, n in enumerate([8000, 8192, 12000, 9000, 16384]):
        clean = rng.standard_normal(n).astype(np.float32) * 0.2
        wav = (np.stack([clean] * 3) +
               rng.standard_normal((3, n)).astype(np.float32) * 0.05)
        if i % 2:
            wav = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
        mask = rng.random((CFG.num_frames(n), CFG.num_bins)).astype(
            np.float32)
        cleans[f"u{i}"] = clean
        ref.update(j_enh.add(f"u{i}", wav, mask))
        got.update(t_enh.add(f"u{i}", wav, mask))
    ref.update(j_enh.flush())
    got.update(t_enh.flush())
    assert set(got) == set(ref) == set(cleans)
    for key, out in got.items():
        assert out.shape == cleans[key].shape and np.isfinite(out).all()
        assert _peak_err(out, ref[key]) < SLICE_TOL
        assert np.corrcoef(out, cleans[key])[0, 1] > 0.9


def test_executor_helpers_match_jax():
    keys = [f"u{i}" for i in range(11)]
    for shards in (1, 3, 4):
        for idx in range(shards):
            assert tex.shard_manifest(keys, shards, idx) == \
                jex.shard_manifest(keys, shards, idx)
    jb, tb = jex.LengthBucketer(JCFG, 8192), tex.LengthBucketer(CFG, 8192)
    for n in (1, 8191, 8192, 8193, 100000, 128000):
        assert tb.bucket(n) == jb.bucket(n)
    with pytest.raises(ValueError):
        tex.shard_manifest(keys, 2, 2)


def test_fused_gate_is_the_ports_own():
    # an 8 s utterance buckets to 131072 samples, T = 513 > the TPU's 512
    assert pipeline.fused_supported(CFG, 6, 131072, 131072)
    assert pipeline.fused_supported(CFG, 8, 512, 512)
    assert not pipeline.fused_supported(CFG, 9, 4096, 4096)
    assert not pipeline.fused_supported(CFG, 2, 4000, 4000)
    assert not pipeline.fused_supported(CFG, 2, 256, 256)
    assert not pipeline.fused_supported(CFG, 2, 4096, 4000)
    for fields in ({"frame_hop": 128}, {"frame_len": 400, "frame_hop": 160},
                   {"center": False}, {"frame_len": 1024, "frame_hop": 512}):
        cfg = stft_config_from_fields(**{**dataclasses.asdict(JCFG),
                                         **fields})
        assert not pipeline.fused_supported(cfg, 2, 8192, 8192)
    wav, mask = _scene(6, 1, 2, 4096)
    with pytest.raises(ValueError, match="gate"):
        pipeline.enhance_plain(torch.from_numpy(wav), torch.from_numpy(mask),
                               CFG, nsamps=4000)


def test_uncovered_options_raise(monkeypatch):
    """What still raises names its ROADMAP item; the family, mvdr's eigh
    steer in the fused pipeline and the online family do not, and on a
    CUDA device each takes its branch."""
    wav, mask = _scene(7, 1, 2, 4096)
    wt, mt = torch.from_numpy(wav), torch.from_numpy(mask)
    # the family runs through the fused pipeline (plain versions on the
    # CPU) and through the CPU entry, one-shot and online
    for name in pipeline.FUSED_BEAMFORMERS:
        pipeline.check_fused_options(name, "power")
        pipeline.check_fused_options(name, "eigh")
        out = pipeline.enhance_fused(wt, mt, CFG, beamformer=name)
        assert out.shape == (1, 4096) and torch.isfinite(out).all()
        assert torch.isfinite(enhance_batch(wt, mt, CFG, beamformer=name,
                                            ban=True)).all()
    assert torch.isfinite(enhance_batch(wt, mt, CFG, chunk_size=32)).all()
    # mvdr's eigh steer in the fused pipeline: the EVD and the Capon solve
    # between kernels A and B (the EVD kernel's plain version on the CPU),
    # the spectrum-domain eigh run's MVDR by another route
    out = pipeline.enhance_fused(wt, mt, CFG, steer="eigh")
    assert torch.equal(out, pipeline.enhance_plain(wt, mt, CFG,
                                                   steer="eigh"))
    ref = enhance_batch(wt, mt, CFG, steer="eigh", device="cpu")
    assert _peak_err(out, ref) < SLICE_TOL
    with pytest.raises(ValueError, match="Unknown steer method"):
        pipeline.enhance_fused(wt, mt, CFG, steer="cholesky")
    with pytest.raises(ValueError, match="Unsupported fused beamformer"):
        pipeline.enhance_fused(wt, mt, CFG, beamformer="ds")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        tex.BatchEnhancer(CFG, mesh=object(), device="cpu")
    # on a CUDA device (the device check monkeypatched, as below): the
    # options the EVD kernel brings take their branch, N = 9 is refused
    # before anything is copied to the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for kw, branch in (({"chunk_size": 32, "beamformer": "gevd"},
                        "spectrum"),
                       ({"chunk_size": 32, "ban": True}, "spectrum"),
                       ({"steer": "eigh"}, "fused"),
                       ({"nsamps": 4000, "beamformer": "gevd"},
                        "spectrum")):
        assert enhance_step.check_cuda_options(
            kw.get("beamformer", "mvdr"), kw.get("ban", False),
            kw.get("steer", "power"), kw.get("chunk_size", -1), CFG, 2,
            4096, kw.get("nsamps", 4096)) == branch, kw
    wav9, mask9 = _scene(7, 1, 9, 4096)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 15"):
        enhance_batch(wav9, mask9, CFG, steer="eigh", device="cuda")
    with pytest.raises(ValueError, match="Unsupported fused beamformer"):
        enhance_batch(wav, mask, CFG, beamformer="ds", device="cuda")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav, mask = _scene(8, 1, 2, 4096)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enhance_batch(wav, mask, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enhance_batch(wav, mask, CFG, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.BatchEnhancer(CFG)
    # a tensor keeps its own device
    out = enhance_batch(torch.from_numpy(wav), torch.from_numpy(mask), CFG)
    assert out.device.type == "cpu" and torch.isfinite(out).all()
