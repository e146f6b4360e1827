"""F0 extraction and pitch utilities (a copy of `mixgantts_tpu/audio/f0.py`;
host numpy, as there).

The reference uses two native F0 backends at preprocess time: pyworld
DIO+StoneMask (`preprocessor/preprocessor.py:294-300`) and Praat/parselmouth
autocorrelation (`utils/pitch_tools.py:84-121`).  Neither library exists in
this image, so we ship an in-repo normalized-autocorrelation (NCCF) tracker
with parabolic peak interpolation and median smoothing — the same family of
algorithm as Praat's `to_pitch_ac`.  It runs vectorized numpy at preprocess
time only (F0 never touches the device).

The coarse-quantization / normalization helpers mirror
`utils/pitch_tools.py:19-81`, and the continuous-wavelet pitch decomposition
(Mexican-hat CWT, `utils/pitch_tools.py:175-282`) is re-derived without
pycwt.
"""

import numpy as np
from scipy.interpolate import interp1d

f0_bin = 256
f0_max = 1100.0
f0_min = 50.0
f0_mel_min = 1127 * np.log(1 + f0_min / 700)
f0_mel_max = 1127 * np.log(1 + f0_max / 700)


# --- extraction ----------------------------------------------------------------

def extract_f0(wav, sr, hop_length, f0_floor=71.0, f0_ceil=800.0,
               voicing_threshold=0.45):
    """Frame-synchronous F0 track (0 = unvoiced), one value per hop.

    Normalized autocorrelation per frame (via FFT), peak picked in the
    [sr/f0_ceil, sr/f0_floor] lag range with parabolic refinement, a
    voicing decision on the normalized peak height, then 3-tap median
    smoothing.  Frame count = 1 + len(wav) // hop_length, matching the
    mel frame count of the centered STFT.
    """
    wav = np.asarray(wav, dtype=np.float64)
    win = int(2 * sr / f0_floor)
    win = min(win, max(len(wav) - 1, 1))
    n_frames = 1 + len(wav) // hop_length
    pad = win // 2
    x = np.pad(wav, (pad, pad + win), mode="constant")

    starts = np.arange(n_frames) * hop_length
    idx = starts[:, None] + np.arange(win)[None, :]
    frames = x[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)

    # autocorrelation via rfft (power spectrum roundtrip)
    nfft = int(2 ** np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, axis=1)[:, :win]
    ac0 = np.maximum(ac[:, :1], 1e-12)
    # Unbiased normalization: the zero-padded linear autocorrelation of a
    # perfectly periodic frame still decays as (win - lag)/win, so without
    # this correction the small-lag shoulder outscores the true period peak
    # for low F0 (lag near win/2) — Praat divides by the window
    # autocorrelation the same way (`utils/pitch_tools.py:84-121` backend).
    lags = np.arange(win)
    norm = np.maximum(win - lags, 1) / win
    nac = ac / ac0 / norm[None, :]

    lag_min = max(int(sr / f0_ceil), 2)
    lag_max = min(int(sr / f0_floor), win - 2)
    # Period candidates must be true local maxima: a raw argmax that lands
    # on the lag_min boundary is the still-decaying lag-0 shoulder, not a
    # pitch peak.  A small octave cost (Praat-style) favors the shorter
    # lag when two harmonically-related peaks tie within noise.
    is_peak = np.zeros_like(nac, dtype=bool)
    is_peak[:, 1:-1] = ((nac[:, 1:-1] >= nac[:, :-2])
                        & (nac[:, 1:-1] >= nac[:, 2:]))
    octave_cost = 0.01
    score = np.where(is_peak, nac, -np.inf) \
        - octave_cost * np.log2(np.maximum(lags, 1) / lag_min)
    score[:, :lag_min] = -np.inf
    score[:, lag_max:] = -np.inf

    # Praat-style path finding instead of greedy argmax (to_pitch_ac's
    # candidate Viterbi, the backend behind `utils/pitch_tools.py:84-121`):
    # keep the K best local maxima per frame plus an explicit unvoiced
    # candidate, then pick the track maximizing candidate strength minus
    # octave-jump and voicing-transition costs.  Greedy picking takes the
    # subharmonic (half-octave-down) peak on ~10% of vibrato/noisy frames;
    # the jump cost removes those (measured in tests/test_f0_agreement.py).
    K = 4
    cand_rel = np.argsort(-score, axis=1)[:, :K]
    rows = np.arange(n_frames)[:, None]
    cand_score = score[rows, cand_rel]
    cand_nac = nac[rows, cand_rel]

    # parabolic interpolation around each candidate peak
    y0 = nac[rows, cand_rel - 1]
    y1 = nac[rows, cand_rel]
    y2 = nac[rows, cand_rel + 1]
    denom = y0 - 2 * y1 + y2
    offset = np.where(np.abs(denom) > 1e-12,
                      0.5 * (y0 - y2) / np.where(np.abs(denom) > 1e-12,
                                                 denom, 1.0), 0.0)
    cand_lag = cand_rel + np.clip(offset, -1.0, 1.0)
    cand_f0 = sr / np.maximum(cand_lag, 1e-6)

    energy = np.sqrt(np.mean(frames ** 2, axis=1))
    cand_valid = (np.isfinite(cand_score) & (cand_nac > voicing_threshold)
                  & (energy[:, None] > 1e-4)
                  & (cand_f0 >= f0_floor) & (cand_f0 <= f0_ceil))
    # candidate K is the unvoiced state with a fixed strength floor
    strengths = np.where(cand_valid, cand_score, -np.inf)
    strengths = np.concatenate(
        [strengths, np.full((n_frames, 1), voicing_threshold)], axis=1)
    cand_f0 = np.concatenate([cand_f0, np.zeros((n_frames, 1))], axis=1)

    octave_jump_cost = 0.35
    vuv_cost = 0.14
    prev = np.zeros((n_frames, K + 1), np.int64)
    acc = strengths[0].copy()
    for i in range(1, n_frames):
        f_prev, f_here = cand_f0[i - 1], cand_f0[i]
        both_v = (f_prev[:, None] > 0) & (f_here[None, :] > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            jump = np.abs(np.log2(
                np.where(both_v, f_prev[:, None], 1.0)
                / np.where(both_v, f_here[None, :], 1.0)))
        trans = np.where(both_v, octave_jump_cost * jump, 0.0)
        trans += np.where((f_prev[:, None] > 0) != (f_here[None, :] > 0),
                          vuv_cost, 0.0)
        total = acc[:, None] - trans
        prev[i] = np.argmax(total, axis=0)
        acc = total[prev[i], np.arange(K + 1)] + strengths[i]
    path = np.empty(n_frames, np.int64)
    path[-1] = int(np.argmax(acc))
    for i in range(n_frames - 1, 0, -1):
        path[i - 1] = prev[i, path[i]]
    f0 = cand_f0[np.arange(n_frames), path]

    # 3-tap median smoothing on the full track (keeps 0 runs intact)
    if n_frames >= 3:
        padded = np.pad(f0, 1, mode="edge")
        stacked = np.stack([padded[:-2], padded[1:-1], padded[2:]])
        f0 = np.median(stacked, axis=0)
    return f0.astype(np.float64)


def interpolate_unvoiced(pitch):
    """Linear interpolation over unvoiced (zero) regions, edge-filled
    (`preprocessor/preprocessor.py:311-323`)."""
    pitch = np.asarray(pitch, dtype=np.float64).copy()
    nonzero = np.where(pitch != 0)[0]
    if len(nonzero) == 0:
        return pitch
    fn = interp1d(nonzero, pitch[nonzero],
                  fill_value=(pitch[nonzero[0]], pitch[nonzero[-1]]),
                  bounds_error=False)
    return fn(np.arange(len(pitch)))


# --- DIO-style second tracker (drift-quantification oracle) -------------------
# The reference preprocesses pitch with pyworld DIO+StoneMask
# (`preprocessor/preprocessor.py:294-300`); pyworld is not installable in
# this image, so to *bound* the drift between our NCCF tracker and the
# reference's we re-derive the DIO algorithm itself from the papers
# (Morise 2009 "DIO"; Morise 2011 "StoneMask" instantaneous-frequency
# refinement) as an in-repo second opinion.  The two trackers share no
# machinery (band-filtered zero-crossing/peak interval statistics +
# spectral IF refinement vs normalized autocorrelation peak picking), so
# their agreement statistics — reported by tests/test_f0_agreement.py and
# recorded in BASELINE.md — quantify the "different pitch stats" risk.

def _event_rate_tracks(y, sr, frame_times):
    """The four DIO interval detectors on a (low-passed) signal: f0
    estimates at `frame_times` from negative-going / positive-going zero
    crossings and peak / dip spacings.  Returns [4, n_frames] (NaN where a
    detector saw < 2 events)."""
    out = np.full((4, len(frame_times)), np.nan)
    dy = np.diff(y)
    for row, (sig, polarity) in enumerate(
            ((y, +1), (y, -1), (dy, +1), (dy, -1))):
        s = polarity * sig
        cross = np.nonzero((s[:-1] < 0) & (s[1:] >= 0))[0]
        if len(cross) < 2:
            continue
        # sub-sample crossing instants by linear interpolation
        frac = s[cross] / (s[cross] - s[cross + 1])
        t = cross + frac
        periods = np.diff(t)
        centers = 0.5 * (t[1:] + t[:-1])
        good = periods > 0
        if good.sum() < 1:
            continue
        out[row] = sr / np.interp(frame_times, centers[good], periods[good])
    return out


def _lowpass(wav, sr, cutoff):
    """Windowed-sinc FIR low-pass (Nuttall window, as in DIO), linear
    phase, applied zero-delay."""
    from scipy.signal import fftconvolve
    half = max(int(1.5 * sr / cutoff), 8)
    n = np.arange(-half, half + 1)
    h = np.sinc(2.0 * cutoff / sr * n)
    m = (n + half) / (2 * half)
    nuttall = (0.355768 - 0.487396 * np.cos(2 * np.pi * m)
               + 0.144232 * np.cos(4 * np.pi * m)
               - 0.012604 * np.cos(6 * np.pi * m))
    h = h * nuttall
    h /= h.sum()
    return fftconvolve(wav, h, mode="same")


def _refine_if(wav, sr, f0, frame_centers):
    """StoneMask-style refinement: harmonic-power-weighted instantaneous
    frequency around each rough f0 (IF from the window-derivative spectrum,
    Flanagan's relation arg'(X) = Im(X_dw · conj(X)) / |X|^2)."""
    refined = f0.copy()
    n = len(wav)
    for i in np.nonzero(f0 > 0)[0]:
        T0 = sr / f0[i]
        half = int(1.5 * T0)
        c = int(frame_centers[i])
        lo, hi = c - half, c + half + 1
        if lo < 0 or hi > n or half < 4:
            continue
        x = wav[lo:hi]
        L = len(x)
        tt = np.arange(L) - half
        w = 0.5 * (1 + np.cos(np.pi * tt / (half + 1)))     # Hann
        dw = -0.5 * np.pi / (half + 1) * np.sin(np.pi * tt / (half + 1))
        n_h = max(1, min(3, int(sr / 2 / f0[i])))
        num = den = 0.0
        for h in range(1, n_h + 1):
            omega = 2 * np.pi * h * f0[i] / sr
            e = np.exp(-1j * omega * tt)
            X = np.dot(x * w, e)
            Xd = np.dot(x * dw * sr, e)                      # d/dt of window
            p = np.abs(X) ** 2
            if p < 1e-20:
                continue
            inst = omega * sr / (2 * np.pi) + \
                np.imag(Xd * np.conj(X)) / (2 * np.pi * p)
            num += p * inst / h
            den += p
        if den > 0 and f0_min / 2 < num / den < f0_max * 2:
            refined[i] = num / den
    return refined


def extract_f0_dio(wav, sr, hop_length, f0_floor=71.0, f0_ceil=800.0,
                   dev_threshold=0.02):
    """DIO+StoneMask-style F0 track (0 = unvoiced), one value per hop.

    Per half-octave channel: low-pass at the boundary frequency, measure
    the four event-interval rates, take their mean as the candidate and
    their relative spread as its cost; per frame pick the lowest-cost
    in-band candidate, declare unvoiced above `dev_threshold`, then refine
    voiced frames twice with the instantaneous-frequency estimator.
    Frame count matches `extract_f0` (1 + len(wav) // hop_length).
    """
    wav = np.asarray(wav, dtype=np.float64)
    n_frames = 1 + len(wav) // hop_length
    frame_centers = np.arange(n_frames) * hop_length
    if len(wav) < sr / f0_floor * 2:
        return np.zeros(n_frames)

    # half-octave-spaced low-pass boundaries; a channel cut at c keeps an
    # f0 in (c/2, c] essentially sinusoidal so all four detectors agree
    n_ch = int(np.ceil(2 * np.log2(2 * f0_ceil / (2 * f0_floor)))) + 1
    cutoffs = 2 * f0_floor * 2.0 ** (0.5 * np.arange(n_ch))
    cands = np.full((n_ch, n_frames), np.nan)
    costs = np.full((n_ch, n_frames), np.inf)
    for ci, cutoff in enumerate(cutoffs):
        y = _lowpass(wav, sr, min(cutoff, sr / 2 * 0.95))
        tracks = _event_rate_tracks(y, sr, frame_centers)
        if np.isnan(tracks).all():
            continue
        mean = np.nanmean(tracks, axis=0)
        spread = np.sqrt(np.nanmean((tracks - mean) ** 2, axis=0))
        with np.errstate(invalid="ignore", divide="ignore"):
            cost = spread / np.maximum(mean, 1e-9)
            in_band = (mean > max(cutoff / 4, f0_floor * 0.9)) \
                & (mean <= min(cutoff, f0_ceil * 1.1))
        ok = in_band & np.isfinite(cost)
        cands[ci, ok] = mean[ok]
        costs[ci, ok] = cost[ok]

    best = np.argmin(costs, axis=0)
    rows = np.arange(n_frames)
    f0 = cands[best, rows]
    best_cost = costs[best, rows]
    # frame energy gate (match extract_f0's silence behavior)
    win = int(2 * sr / f0_floor)
    pad = win // 2
    xp = np.pad(wav, (pad, pad + win))
    idx = frame_centers[:, None] + np.arange(win)[None, :]
    energy = np.sqrt(np.mean(xp[idx] ** 2, axis=1))
    voiced = np.isfinite(f0) & (best_cost < dev_threshold) \
        & (energy > 1e-4)
    f0 = np.where(voiced, np.nan_to_num(f0), 0.0)
    f0 = np.clip(f0, 0, f0_ceil)
    f0[(f0 > 0) & (f0 < f0_floor)] = 0.0

    for _ in range(2):  # StoneMask runs the IF refinement twice
        f0 = _refine_if(wav, sr, f0, frame_centers)
    f0[(f0 < f0_floor) | (f0 > f0_ceil)] = 0.0

    if n_frames >= 3:  # same final smoothing as extract_f0
        padded = np.pad(f0, 1, mode="edge")
        f0 = np.median(np.stack([padded[:-2], padded[1:-1], padded[2:]]),
                       axis=0)
    return f0.astype(np.float64)


# --- quantization / normalization (utils/pitch_tools.py parity) ---------------

def f0_to_coarse(f0):
    """256-bin mel-scale pitch quantization (`utils/pitch_tools.py:26-35`)."""
    f0 = np.asarray(f0, dtype=np.float64)
    f0_mel = 1127 * np.log(1 + f0 / 700)
    f0_mel = np.where(
        f0_mel > 0,
        (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1,
        f0_mel)
    f0_mel = np.clip(f0_mel, 1, f0_bin - 1)
    return np.rint(f0_mel).astype(np.int64)


def norm_f0(f0, uv, pitch_norm="log", f0_mean=None, f0_std=None, eps=1e-8,
            use_uv=True):
    f0 = np.asarray(f0, dtype=np.float64).copy()
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0 = np.log2(f0 + eps)
    if uv is not None and use_uv:
        f0[uv > 0] = 0
    return f0


def norm_interp_f0(f0, **kwargs):
    f0 = np.asarray(f0, dtype=np.float64)
    uv = f0 == 0
    f0 = norm_f0(f0, uv, **kwargs)
    if uv.all():
        f0[uv] = 0
    elif uv.any():
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0, uv


def denorm_f0(f0, uv, pitch_norm="log", f0_mean=None, f0_std=None,
              use_uv=True, pitch_padding=None, fmin=None, fmax=None):
    f0 = np.asarray(f0, dtype=np.float64).copy()
    if pitch_norm == "standard":
        f0 = f0 * f0_std + f0_mean
    elif pitch_norm == "log":
        f0 = 2.0 ** f0
    if fmin is not None:
        f0 = np.maximum(f0, fmin)
    if fmax is not None:
        f0 = np.minimum(f0, fmax)
    if uv is not None and use_uv:
        f0[uv > 0] = 0
    if pitch_padding is not None:
        f0[pitch_padding] = 0
    return f0


# --- continuous wavelet pitch decomposition ------------------------------------

def _mexican_hat(t):
    # Ricker wavelet psi(t) = (2/(sqrt(3) pi^{1/4})) (1 - t^2) exp(-t^2/2)
    c = 2.0 / (np.sqrt(3.0) * np.pi ** 0.25)
    return c * (1 - t ** 2) * np.exp(-t ** 2 / 2)


def get_lf0_cwt(lf0, dt=0.005, dj=1.0, n_scales=10, s0_factor=2.0):
    """Decompose a log-F0 contour into `n_scales` wavelet components
    (Mexican-hat CWT at dyadic scales), the reference's CWT pitch
    representation (`utils/pitch_tools.py:226-249`).

    Returns (components [T, n_scales], scales [n_scales])."""
    lf0 = np.asarray(lf0, dtype=np.float64)
    T = len(lf0)
    s0 = dt * s0_factor
    scales = s0 * 2.0 ** (np.arange(n_scales) * dj)
    t = (np.arange(T) - T / 2.0) * dt
    out = np.zeros((T, n_scales))
    x = lf0 - lf0.mean()
    for i, s in enumerate(scales):
        # sampled, L1-normalized wavelet at this scale
        width = min(T, max(int(10 * s / dt), 3))
        tt = (np.arange(width) - width / 2.0) * dt
        psi = _mexican_hat(tt / s)
        psi = psi / np.sqrt(s)
        wav = np.convolve(x, psi[::-1], mode="same") * dt
        # the standard CWT component scaling for reconstruction
        out[:, i] = wav * (i + 2.5) ** (-2.5)
    return out, scales


def inverse_cwt(components, scales, dj=1.0, dt=0.005):
    """Approximate inverse of `get_lf0_cwt` (sum of rescaled components,
    `utils/pitch_tools.py:251-262` formulation)."""
    components = np.asarray(components, dtype=np.float64)
    out = np.zeros(components.shape[0])
    for i in range(components.shape[1]):
        out += components[:, i] * (i + 2.5) ** 2.5
    return out * dj * dt ** 0.5
