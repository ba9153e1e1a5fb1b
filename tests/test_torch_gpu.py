"""CUDA kernels of setk_tpu_torch against their plain versions, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, never at collection).  This file imports neither jax
nor setk_tpu, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.dsp.window import wss_inverse_blocks
from setk_tpu_torch.enhance.pipeline import enhance_plain
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.parallel.enhance_step import enhance_batch

pytestmark = pytest.mark.gpu

TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _inputs(b, n, s, int16, seed=0):
    cfg = StftConfig()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, s)).astype(np.float32) * 0.3
    wav = (np.clip(x * 32768, -32768, 32767).astype(np.int16) if int16
           else x)
    mask = rng.random((b, cfg.num_frames(s), cfg.num_bins)).astype(
        np.float32)
    return cfg, wav, mask


@pytest.mark.parametrize("n,s,int16", [(1, 512, False), (3, 4096, True),
                                       (6, 131072, True), (8, 8192, False)])
def test_fused_kernels_match_plain(n, s, int16):
    dev = _card()
    cfg, wav, mask = _inputs(2, n, s, int16)
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    rs_k, rn_k = fm.stft_covar(wav_d, mask_d, window)
    rs_p, rn_p = fm.stft_covar_plain(wav_d, mask_d, window)
    assert _rel(rs_k, rs_p) < TOL and _rel(rn_k, rn_p) < TOL
    t = cfg.num_frames(s)
    den = mask_d.sum(1)
    rs = (rs_p / den[..., None, None]).contiguous()
    rn = (rn_p / (t - den)[..., None, None]).contiguous()
    w_k = mv.mvdr_power(rs, rn)
    assert _rel(w_k, mv.mvdr_power_plain(rs, rn)) < TOL
    wss = torch.as_tensor(wss_inverse_blocks(cfg.padded_window, t, 256, 512,
                                             s), device=dev)
    out_k = fm.beamform_istft(wav_d, w_k, wss, window)
    out_p = fm.beamform_istft_plain(wav_d, w_k, wss, window)
    assert _rel(out_k, out_p) < TOL


def test_enhance_batch_runs_kernels_only():
    dev = _card()
    cfg, wav, mask = _inputs(2, 4, 16384, True, seed=1)
    counted = (fm.stft_covar, mv.mvdr_power, fm.beamform_istft)
    for fn in counted:
        fn.launches = 0
    out = enhance_batch(torch.from_numpy(wav).to(dev),
                        torch.from_numpy(mask).to(dev), cfg)
    assert [fn.launches for fn in counted] == [1, 1, 1]
    ref = enhance_plain(torch.from_numpy(wav).to(dev),
                        torch.from_numpy(mask).to(dev), cfg)
    assert torch.isfinite(out).all() and _rel(out, ref) < TOL


def test_uncovered_cases_raise_on_the_card():
    dev = _card()
    cfg, wav, mask = _inputs(1, 2, 4096, False)
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    for kw in ({"beamformer": "gevd"}, {"chunk_size": 32},
               {"steer": "eigh"}, {"nsamps": 4000}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            enhance_batch(wav_d, mask_d, cfg, **kw)
