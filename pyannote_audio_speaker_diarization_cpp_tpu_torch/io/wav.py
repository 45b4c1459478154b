"""WAV (RIFF) reading and writing, host-side.

Re-design of the reference's header-only wav I/O
(reference pipeline/src/frontend/wav.h:57-235): RIFF parse with sub-chunk
skipping, 8/16/32-bit integer PCM plus IEEE float, batch and streaming
writers. Like the reference reader, samples come back as raw integer values
in float32 — the /32768 scaling happens in the pipeline
(speakerDiarizer.cpp:2948-2951) so numerics line up stage by stage.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Union

import numpy as np


@dataclasses.dataclass
class WavData:
    samples: np.ndarray  # (num_channels, num_samples) float32, raw amplitude
    sample_rate: int
    bits_per_sample: int
    is_float: bool = False  # IEEE-float data is already in [-1, 1]

    @property
    def num_channels(self) -> int:
        return self.samples.shape[0]

    @property
    def num_samples(self) -> int:
        return self.samples.shape[1]

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate

    def normalized_mono(self) -> np.ndarray:
        """Channel-averaged waveform scaled to [-1, 1] float32."""
        if self.is_float:
            return self.samples.mean(axis=0).astype(np.float32)
        scale = float(1 << (self.bits_per_sample - 1)) if self.bits_per_sample > 0 else 1.0
        return (self.samples.mean(axis=0) / scale).astype(np.float32)


_PCM_DTYPES = {8: np.uint8, 16: np.int16, 32: np.int32}


def _discard(f: BinaryIO, num_bytes: int) -> None:
    """Advance the stream: seek when possible, bounded reads otherwise."""
    if num_bytes <= 0:
        return
    if f.seekable():
        f.seek(num_bytes, 1)
        return
    while num_bytes > 0:
        chunk = f.read(min(num_bytes, 1 << 20))
        if not chunk:
            return
        num_bytes -= len(chunk)


def read_wav(
    path_or_file: Union[str, BinaryIO],
    start_frame: int = 0,
    max_frames: int | None = None,
) -> WavData:
    """Parse a RIFF WAV file (integer PCM 8/16/32-bit or float32).

    ``start_frame``/``max_frames`` select a per-channel sample range without
    materializing the rest of the file — the long-form multi-host path reads
    only each host's slice of an hour-long recording
    (parallel/longform.py)."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "rb") as f:
            return read_wav(f, start_frame=start_frame, max_frames=max_frames)
    f = path_or_file

    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            raise ValueError("no data chunk found")
        chunk_id, chunk_size = struct.unpack("<4sI", header)
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", f.read(16))
            if chunk_size > 16:
                f.read(chunk_size - 16)
        elif chunk_id == b"data":
            if start_frame or max_frames is not None:
                block_align = fmt[4] if fmt else 0
                if not block_align:
                    raise ValueError("fmt chunk missing or zero block align")
                skip = min(start_frame * block_align, chunk_size)
                _discard(f, skip)
                remaining = chunk_size - skip
                if max_frames is not None:
                    remaining = min(remaining, max_frames * block_align)
                raw = f.read(remaining)
            else:
                raw = f.read(chunk_size)
            break
        else:
            # skip LIST/fact/etc sub-chunks (wav.h:94-117)
            _discard(f, chunk_size + (chunk_size & 1))

    if fmt is None:
        raise ValueError("fmt chunk missing")
    audio_format, num_channels, sample_rate, _byte_rate, _block_align, bits = fmt

    is_float = audio_format == 3
    if is_float:
        if bits == 32:
            data = np.frombuffer(raw, dtype=np.float32).astype(np.float32)
        elif bits == 64:
            data = np.frombuffer(raw, dtype=np.float64).astype(np.float32)
        else:
            raise ValueError(f"unsupported float bits_per_sample: {bits}")
    elif bits in _PCM_DTYPES:
        data = np.frombuffer(raw, dtype=_PCM_DTYPES[bits]).astype(np.float32)
        if bits == 8:
            data = data - 128.0  # 8-bit PCM is unsigned
    else:
        raise ValueError(f"unsupported bits_per_sample: {bits}")

    usable = (len(data) // num_channels) * num_channels
    samples = data[:usable].reshape(-1, num_channels).T.copy()
    return WavData(
        samples=samples,
        sample_rate=sample_rate,
        bits_per_sample=bits,
        is_float=is_float,
    )


@dataclasses.dataclass
class WavInfo:
    num_channels: int
    sample_rate: int
    bits_per_sample: int
    num_frames: int
    is_float: bool


def wav_info(path: str) -> WavInfo:
    """Header-only probe: channel/rate/length without reading sample data."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError("no data chunk found")
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                fmt = struct.unpack("<HHIIHH", f.read(16))
                if chunk_size > 16:
                    f.read(chunk_size - 16)
            elif chunk_id == b"data":
                if fmt is None:
                    raise ValueError("fmt chunk missing")
                audio_format, channels, rate, _br, block_align, bits = fmt
                return WavInfo(
                    num_channels=channels,
                    sample_rate=rate,
                    bits_per_sample=bits,
                    num_frames=chunk_size // block_align if block_align else 0,
                    is_float=audio_format == 3,
                )
            else:
                _discard(f, chunk_size + (chunk_size & 1))


def _wav_header(num_samples: int, num_channels: int, sample_rate: int, bits: int) -> bytes:
    byte_rate = sample_rate * num_channels * bits // 8
    block_align = num_channels * bits // 8
    data_size = num_samples * num_channels * bits // 8
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF",
        36 + data_size,
        b"WAVE",
        b"fmt ",
        16,
        1,
        num_channels,
        sample_rate,
        byte_rate,
        block_align,
        bits,
        b"data",
        data_size,
    )


def write_wav(
    path: str,
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int = 16,
) -> None:
    """Write (num_channels, num_samples) or (num_samples,) raw-amplitude
    samples as integer PCM (wav.h WavWriter:145-191)."""
    if samples.ndim == 1:
        samples = samples[None, :]
    num_channels, num_samples = samples.shape
    interleaved = samples.T.reshape(-1)
    dtype = _PCM_DTYPES[bits_per_sample]
    if bits_per_sample == 8:
        interleaved = interleaved + 128.0
    with open(path, "wb") as f:
        f.write(_wav_header(num_samples, num_channels, sample_rate, bits_per_sample))
        f.write(np.clip(interleaved, np.iinfo(dtype).min, np.iinfo(dtype).max)
                .astype(dtype).tobytes())


class StreamWavWriter:
    """Incremental writer: append sample blocks, finalize header on close
    (wav.h StreamWavWriter:193-235)."""

    def __init__(self, path: str, num_channels: int, sample_rate: int, bits_per_sample: int = 16):
        self._f = open(path, "wb")
        self._channels = num_channels
        self._rate = sample_rate
        self._bits = bits_per_sample
        self._written = 0
        self._f.write(_wav_header(0, num_channels, sample_rate, bits_per_sample))

    def write(self, samples: np.ndarray) -> None:
        """Append (num_samples,) interleaved or (channels, n) samples."""
        if samples.ndim == 2:
            samples = samples.T.reshape(-1)
        dtype = _PCM_DTYPES[self._bits]
        if self._bits == 8:
            samples = samples + 128.0
        self._f.write(np.clip(samples, np.iinfo(dtype).min, np.iinfo(dtype).max)
                      .astype(dtype).tobytes())
        self._written += len(samples) // self._channels

    def close(self) -> None:
        self._f.seek(0)
        self._f.write(
            _wav_header(self._written, self._channels, self._rate, self._bits)
        )
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
