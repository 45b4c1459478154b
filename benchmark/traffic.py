"""The traffic of a cell: synthetic recordings and the order they are sent in.

A traffic file (``traffic/<name>.json``) holds only parameters:

- ``lengths_s``: the recording lengths; a run cycles through the list, and
  ``--seed`` only shuffles its order in each cycle, so every run does the
  same work. ``tail_s`` is added to each length, so that recordings end
  inside a 0.5 s hop, as real ones do (the last window is then short);
- ``speakers``: voices in each recording, and the turn-taking:
  ``turn_mean_s`` (exponential, clipped to ``turn_min_s``..``turn_max_s``),
  ``pause_mean_s`` between turns, ``overlap_share`` of the turns that start
  ``overlap_min_s``..``overlap_max_s`` before the previous one ends;
- ``f0_hz``, ``formant_hz``: the range of each voice's pitch and of its
  three formants; ``noise_db``: background noise below the speech peak;
- ``group``: recordings handed to the pipeline at once (``map``);
  ``bounds``: speaker bounds passed with every request;
- ``checked_per_run``: distinct recordings whose answers the run checks.

Voices are additive harmonic sources under formant envelopes, with a
slowly wandering pitch and a syllable-rate amplitude; each turn fades in
and out over 20 ms. The audio is quantized to 16 bits, as a WAV file is.
Everything comes from the seed: the same seed gives the same recordings.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for any whole ``seed`` (negative or above 64 bits
    included) and a sub-stream."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *stream]))


def schedule(traffic: Dict, seed: int, cycles: int) -> List[List[int]]:
    """Groups of indices into ``lengths_s``: each cycle a seed-drawn order
    of the whole list, cut into groups of ``group``."""
    n, g = len(traffic["lengths_s"]), traffic["group"]
    rng = rng_for(seed, 1)
    groups = []
    for _ in range(cycles):
        order = rng.permutation(n).tolist()
        groups += [order[i : i + g] for i in range(0, n, g)]
    return groups


def turns(traffic: Dict, seconds: float, rng: np.random.Generator):
    """[(start s, end s, speaker)] covering ``seconds``."""
    t = rng.uniform(0.0, 1.0)
    out, prev = [], -1
    while t < seconds:
        spk = int(rng.integers(traffic["speakers"]))
        if spk == prev and traffic["speakers"] > 1:
            spk = (spk + 1 + int(rng.integers(traffic["speakers"] - 1))) % traffic["speakers"]
        dur = float(np.clip(rng.exponential(traffic["turn_mean_s"]), traffic["turn_min_s"],
                            traffic["turn_max_s"]))
        out.append((t, min(t + dur, seconds), spk))
        prev = spk
        if rng.uniform() < traffic["overlap_share"]:
            t = t + dur - rng.uniform(traffic["overlap_min_s"], traffic["overlap_max_s"])
        else:
            t = t + dur + rng.exponential(traffic["pause_mean_s"])
    return out


def recording(traffic: Dict, seconds: float, seed: int, index: int, device,
              sample_rate: int = 16000) -> np.ndarray:
    """One synthetic recording, float32 in [-1, 1) on 16-bit steps."""
    rng = rng_for(seed, 2, index)
    n = int(round(seconds * sample_rate))
    env_rate = 100
    n_env = int(math.ceil(seconds * env_rate)) + 2
    speakers = traffic["speakers"]
    envelopes = np.zeros((speakers, n_env), np.float32)
    ramp = 0.02 * env_rate
    grid = np.arange(n_env, dtype=np.float64)
    for s, e, k in turns(traffic, seconds, rng):
        a, b = s * env_rate, e * env_rate
        envelopes[k] = np.maximum(
            envelopes[k], np.clip(np.minimum(grid - a, b - grid) / ramp, 0.0, 1.0))
    f0_lo, f0_hi = traffic["f0_hz"]
    voices = []
    for _ in range(speakers):
        voices.append({
            "f0": rng.uniform(f0_lo, f0_hi),
            "formants": [rng.uniform(lo, hi) for lo, hi in traffic["formant_hz"]],
            "phase": rng.uniform(0, 2 * math.pi, 4),
            "syllable_hz": rng.uniform(3.0, 5.5),
            "gain": rng.uniform(0.6, 1.0),
        })
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**62)))
    t = torch.arange(n, device=dev, dtype=torch.float64) / sample_rate
    audio = torch.zeros(n, device=dev, dtype=torch.float32)
    env_t = torch.from_numpy(envelopes).to(dev)
    pos = (t * env_rate).to(torch.float32)
    i0 = pos.floor().long().clamp(max=n_env - 2)
    frac = pos - i0.to(torch.float32)
    for k, v in enumerate(voices):
        env = env_t[k, i0] * (1 - frac) + env_t[k, i0 + 1] * frac
        if not bool(env.any()):
            continue
        p = v["phase"]
        f0 = v["f0"] * (1 + 0.08 * torch.sin(2 * math.pi * 0.31 * t + p[0])
                        + 0.03 * torch.sin(2 * math.pi * 1.7 * t + p[1]))
        phase = torch.cumsum(2 * math.pi * f0 / sample_rate, 0)
        syll = 0.55 + 0.45 * torch.sin(2 * math.pi * v["syllable_hz"] * t + p[2]).abs()
        voice = torch.zeros(n, device=dev, dtype=torch.float32)
        for h in range(1, int(3800 // v["f0"]) + 1):
            fh = h * v["f0"]
            amp = sum(math.exp(-(((fh - f) / (0.12 * f + 60)) ** 2)) for f in v["formants"])
            amp = (amp + 0.02) / math.sqrt(h)
            voice += amp * torch.sin(h * phase + h * p[3]).to(torch.float32)
        audio += v["gain"] * (env * syll.to(torch.float32)) * voice
    peak = audio.abs().max().clamp(min=1e-6)
    audio = audio / peak * 0.5
    noise = torch.randn(n, generator=gen, device=dev) * (0.5 * 10 ** (traffic["noise_db"] / 20))
    audio = torch.clamp(audio + noise, -1.0, 32767 / 32768)
    return (torch.round(audio * 32768) / 32768).to(torch.float32).cpu().numpy()


def recordings(traffic: Dict, seed: int, device, sample_rate: int = 16000) -> List[np.ndarray]:
    """One recording of each length of the list, in list order."""
    return [
        recording(traffic, length + traffic.get("tail_s", 0.0), seed, i, device, sample_rate)
        for i, length in enumerate(traffic["lengths_s"])
    ]


def checked(traffic: Dict, seed: int) -> List[int]:
    """The distinct recordings (indices into ``lengths_s``) whose answers a
    run checks, drawn from the seed; the longest is always among them."""
    n = len(traffic["lengths_s"])
    longest = int(np.argmax(traffic["lengths_s"]))
    rest = [i for i in rng_for(seed, 3).permutation(n).tolist() if i != longest]
    return sorted([longest] + rest[: max(traffic["checked_per_run"] - 1, 0)])
