"""Far-field test scenes for the spatial tests (numpy only).

A source in noise bursts reaches each mic by a fractional delay applied
in the frequency domain (the plane-wave model of ``plane_steer_vector``
at c = 340 m/s), and every mic adds its own noise at 0.05 of the
source's level, so that no likelihood reads rounding noise.  Masks
follow the bursts (0.95 on, 0.05 off), T x F.
"""

import numpy as np

SR = 16000
SPEED = 340.0
LINEAR_TOPO = (0.0, 0.05, 0.1, 0.15)
CIRCLE_RADIUS, CIRCLE_MICS = 0.05, 6
BURST = 2048


def mic_delays(geometry: str, doa: float) -> np.ndarray:
    """Seconds each mic hears the far-field source after the origin, for
    the CLIs' default arrays (the steer vectors' sign convention)."""
    rad = doa * np.pi / 180
    if geometry == "linear":
        return np.asarray(LINEAR_TOPO) * np.cos(rad) / SPEED
    dirc = np.arange(CIRCLE_MICS) * 2 * np.pi / CIRCLE_MICS
    return -CIRCLE_RADIUS * np.cos(dirc - rad) / SPEED


def scene(rng, geometry: str, doa: float, s: int, band=(0.0, SR / 2),
          noise: float = 0.05, level: float = 0.2):
    """(wav (N, S) float32, the source as each mic hears it (N, S)
    float32, gate (S,) bool).  The source itself is heard at the
    origin: mic 0 of the line, the circle's center."""
    gate = (np.arange(s) // BURST) % 2 == 0
    freqs = np.fft.rfftfreq(s, 1 / SR)
    spec = np.fft.rfft(rng.standard_normal(s))
    spec *= (freqs >= band[0]) & (freqs <= band[1])
    src = np.fft.irfft(spec, n=s)
    src = src / src.std() * level * gate
    tau = mic_delays(geometry, doa)
    clean = np.fft.irfft(np.fft.rfft(src)[None] * np.exp(
        -2j * np.pi * freqs[None] * tau[:, None]), n=s)
    wav = clean + rng.standard_normal(clean.shape) * noise * level
    return wav.astype(np.float32), clean.astype(np.float32), gate


def burst_mask(gate, num_frames: int, num_bins: int, hop: int = 256):
    """A (T, F) float32 mask, 0.95 on the bursts' frames, 0.05 off."""
    idx = np.minimum(np.arange(num_frames) * hop, gate.size - 1)
    on = gate[idx][:, None]
    return np.broadcast_to(np.where(on, 0.95, 0.05),
                           (num_frames, num_bins)).astype(np.float32)


def write_corpus(root, geometry: str, doas, seconds, seed: int,
                 hop: int = 256, num_bins: int = 257, band=(0.0, SR / 2)):
    """One scene an utterance under ``root`` (int16 wav files, .npy masks)
    and its scps; returns {key: (doa, frames, the source at the origin)}.

    scps: ``wav`` (N channels), ``mask`` (T x F), ``mask_ft`` (F x T),
    ``src`` (the source as mic 0 hears it), ``other`` (a second source,
    in the first's gaps), ``mix`` (mic 0 plus the second source).
    """
    from setk_tpu_torch.io.wave import write_wav
    rng = np.random.default_rng(seed)
    info, lines = {}, {}
    for i, (doa, secs) in enumerate(zip(doas, seconds)):
        key = f"{geometry[0]}{i}"
        s = int(secs * SR)
        wav, clean, gate = scene(rng, geometry, doa, s, band=band)
        freqs = np.fft.rfftfreq(s, 1 / SR)
        origin = np.fft.irfft(np.fft.rfft(clean[0]) * np.exp(
            2j * np.pi * freqs * mic_delays(geometry, doa)[0]), n=s)
        frames = 1 + s // hop
        other = np.roll(clean[0], BURST) * 0.8
        mask = burst_mask(gate, frames, num_bins, hop)
        files = {"wav": (wav, ".wav"), "src": (clean[0], ".src.wav"),
                 "other": (other, ".other.wav"),
                 "mix": (wav[0] + other, ".mix.wav")}
        for name, (data, suffix) in files.items():
            write_wav(root / f"{key}{suffix}", data, sr=SR)
            lines.setdefault(name, []).append(f"{key} {root}/{key}{suffix}")
        for name, suffix, m in (("mask", ".npy", mask),
                                ("mask_ft", ".ft.npy", mask.T)):
            np.save(root / f"{key}{suffix}", np.ascontiguousarray(m))
            lines.setdefault(name, []).append(f"{key} {root}/{key}{suffix}")
        info[key] = (doa, frames, origin.astype(np.float32))
    for name, rows in lines.items():
        (root / f"{name}.scp").write_text("\n".join(rows) + "\n")
    return info


def run_cli(package: str, command: str, argv, device="cpu"):
    """``package``'s command on ``argv`` (the port's with ``--device``)."""
    import importlib
    mod = importlib.import_module(f"{package}.cli.{command}")
    if package == "setk_tpu_torch" and device:
        argv = list(argv) + ["--device", device]
    mod.run(mod.make_parser().parse_args(argv))


def run_both(command: str, argv_of, tmp_path):
    """Both packages' command, ``argv_of(out_dir)`` giving each one's
    argv; returns (setk_tpu's out_dir, the port's)."""
    outs = {}
    for package in ("setk_tpu", "setk_tpu_torch"):
        outs[package] = tmp_path / package
        outs[package].mkdir()
        run_cli(package, command, argv_of(outs[package]))
    return outs["setk_tpu"], outs["setk_tpu_torch"]
