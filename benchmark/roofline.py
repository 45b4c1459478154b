"""The yardstick's arithmetic: the card's peaks, the least time a kernel's
work could take on it, and the analytic FLOPs of the two models.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
(the run prints the card's own limit beside every share). The least time
of a call is the larger of its bytes over the memory rate and its
operations over the rate of their type; each input byte is counted read
once and each output byte written once, and where the work depends on the
data (the attention's valid frames), what these inputs need.

The FLOP counts are 2 x output positions x fan-in a convolution or
product, from the architecture; elementwise and normalisation work is left
out (under 1 %). They are frozen from the program's utils/flops.py, so
that a change there cannot move the yardstick.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 494.7e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: Dict[str, float]) -> Tuple[float, str]:
    """(least seconds, what bounds them)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = sum(f / PEAK_FLOPS[dtype] for dtype, f in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def asp_bound_s(valid_frames: float, rows: int, T: int, C: int, A: int, dtype: str) -> float:
    """One fused ASP call over ``rows`` rows of x (C, T) and tanh(attention)
    (A, T), of which ``valid_frames`` frames lie under the mask: the valid
    frames of x and a_tanh read, W (C, A) read once, mean and std written,
    bias and mask read; 2 C A operations a valid frame (float32: as three
    TF32 products, the kernel's 3xTF32)."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * (valid_frames * (C + A) + C * A + 2 * rows * C) + 4.0 * (C + rows * T)
    flops = 2.0 * C * A * valid_frames
    ops = {"bfloat16": flops} if dtype == "bfloat16" else {"tfloat32": 3 * flops}
    return bound_s(nbytes, ops)[0]


def log_mel_bound_s(rows: int, samples: int, frames: int, n_fft: int, n_mels: int,
                    mel_nonzeros: int) -> float:
    """One fused log-mel call: the waveforms read and the features written
    (float32), the windowed DFT basis (n_fft, 2 (n_fft // 2 + 1)) and the
    filterbank read once; the DFT product as three TF32 products, the mel
    projection over each band's own bins in float32."""
    ncol = 2 * (n_fft // 2 + 1)
    nbytes = 4.0 * (rows * samples + rows * frames * n_mels + n_fft * ncol
                    + (n_fft // 2 + 1) * n_mels)
    flops = {"tfloat32": 3 * 2.0 * rows * frames * n_fft * ncol,
             "float32": 2.0 * rows * frames * mel_nonzeros}
    return bound_s(nbytes, flops)[0]


def _conv(t: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * t * cin * cout * k


def pyannet_flops(num_samples: int, c: Dict) -> float:
    """One PyanNet forward on a ``num_samples`` window."""
    t1 = (num_samples - c["kernel_size"]) // c["stride"] + 1
    f = _conv(t1, 1, c["num_filters"], c["kernel_size"])
    t3 = (t1 - 3) // 3 + 1 - 4
    f += _conv(t3, c["num_filters"], c["conv_channels"], 5)
    t5 = (t3 - 3) // 3 + 1 - 4
    f += _conv(t5, c["conv_channels"], c["conv_channels"], 5)
    frames = (t5 - 3) // 3 + 1
    h, inp = c["lstm_hidden"], c["conv_channels"]
    for _ in range(c["lstm_layers"]):
        f += 2 * frames * 2.0 * (inp + h) * 4 * h
        inp = 2 * h
    lin = 2 * h
    for _ in range(c["linear_layers"]):
        f += 2.0 * frames * lin * c["linear_hidden"]
        lin = c["linear_hidden"]
    return f + 2.0 * frames * lin * c["num_classes"]


def ecapa_flops(num_frames: int, c: Dict) -> float:
    """One ECAPA-TDNN forward on ``num_frames`` feature frames."""
    ch, t = c["channels"], num_frames
    f = _conv(t, c["in_channels"], ch[0], c["kernel_sizes"][0])
    width = ch[1] // c["res2net_scale"]
    for i in (1, 2, 3):
        f += _conv(t, ch[i - 1], ch[i], 1)
        f += (c["res2net_scale"] - 1) * _conv(t, width, width, c["kernel_sizes"][i])
        f += _conv(t, ch[i], ch[i], 1)
        f += _conv(1, ch[i], c["se_channels"], 1) + _conv(1, c["se_channels"], ch[i], 1)
    f += _conv(t, sum(ch[1:4]), ch[-1], c["kernel_sizes"][-1])
    f += _conv(t, ch[-1], c["attention_channels"], 1)
    f += 2 * _conv(1, ch[-1], c["attention_channels"], 1)
    f += _conv(t, c["attention_channels"], ch[-1], 1)
    return f + _conv(1, 2 * ch[-1], c["emb_dim"], 1)


def recording_flops(num_chunks: int, cfg: Dict) -> float:
    """The work a recording needs: PyanNet on each of its windows and
    ECAPA-TDNN on each (window, local speaker) row. Padding windows and
    rows are the program's own overhead and are not counted."""
    sr, seg = cfg["sample_rate"], cfg["segmentation"]
    window = round(seg["duration"] * sr)
    frames = window // cfg["frontend"]["hop_length"] + 1
    rows = num_chunks * cfg["pyannet"]["num_classes"]
    return num_chunks * pyannet_flops(window, cfg["pyannet"]) + rows * ecapa_flops(frames, cfg["ecapa"])
