"""Diarization serving daemon, on the CUDA card.

Port of the JAX package's runtime/server.py. It keeps one pipeline resident
(the kernels built, the models on the card) and serves requests over HTTP
(stdlib only):

    python -m pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime.server \\
        [--port 8787] [--checkpoint DIR] [--device cpu]

Endpoints:
  GET  /health            -> {"status": "ok", "requests": N, "streams": M}
  POST /diarize           body: RIFF WAV bytes
       query params: num_speakers, min_speakers, max_speakers,
                     format=json|rttm (default json)
       -> {"turns": [{"start": s, "end": e, "speaker": "Speaker_k"}, ...],
           "audio_seconds": T, "wall_seconds": W}
  POST /stream/open       query params: emit_every, recluster_every,
                            schedule=fixed|doubling, num_speakers,
                            min_speakers, max_speakers
       -> {"stream_id": "..."}
  POST /stream/feed?id=X  body: raw mono 16 kHz PCM samples —
                            little-endian int16 (default) or f32
                            (?format=f32)
       -> {"emitted": bool, "turns": [...] | null, "stream_seconds": T}
  POST /stream/close?id=X -> final flush: {"turns": [...],
                            "stream_seconds": T} (session removed)

Online sessions wrap pipelines.streaming.StreamingDiarizer. Sessions are
capped (--max-streams) and idle-evicted (--stream-ttl); each is serialized
by its own lock, while different sessions and offline /diarize requests
interleave freely. A malformed query gets a 400 and a session whose flush
raises is still closed.

Concurrent requests pipeline on the card: only the dispatch (host prep and
the launch of the device stages, which never waits for the card) is
serialized, so one request's fetch and decode overlap the card's work on
the next (as ``pipeline.map`` does). Every request runs inside the
pipeline's ``precision_scope``, which threads share. ``--mesh`` is
accepted for the JAX CLI's sake and changes nothing: the JAX flag spreads a
request over one process's chips, while a process of the port drives one
card, and a pipeline on a mesh of several processes (parallel/mesh.py)
needs every rank to make each call.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

# how much of a refused (413) body is read and dropped before the close
_DISCARD_BYTES = 64 << 20
_DISCARD_S = 10.0


def build_pipeline(checkpoint=None, seg_batch=None, emb_batch=None, device=None):
    """The served pipeline: weights from ``checkpoint`` (anything
    models/ingest.py ``load_params_auto`` reads; None: seeded weights), on
    ``device`` (None: the CUDA card)."""
    from ..pipelines.diarization import SpeakerDiarizationPipeline

    params = None
    if checkpoint:
        from ..models.ingest import load_params_auto

        params = load_params_auto(checkpoint)
    return SpeakerDiarizationPipeline(
        params=params, seg_batch=seg_batch, emb_batch=emb_batch, device=device
    )


class ServiceBusy(Exception):
    """The dispatch lock was not acquired within the admission timeout —
    the pipeline is wedged or overloaded; fail fast instead of queueing."""


class DiarizationService:
    """Thread-safe wrapper: one pipeline, pipelined concurrent inference.

    Only the dispatch (host prep + launching the device stages) is
    serialized; the collect (the wait for the card, the fetch, host
    clustering on the host route, the decode) runs outside the lock. Each
    request carries its own StageTimings through _dispatch/_collect, so
    concurrent requests never mix their attribution on the shared
    pipeline. Both run inside the pipeline's ``precision_scope``.

    ``admission_timeout``: seconds to wait for the dispatch lock before
    raising ServiceBusy (503).
    """

    def __init__(
        self,
        pipeline,
        admission_timeout: float = 30.0,
        max_streams: int = 16,
        stream_ttl: float = 600.0,
    ):
        self.pipeline = pipeline
        self.admission_timeout = admission_timeout
        self._lock = threading.Lock()
        self.requests = 0
        self.streams = StreamSessions(pipeline, max_streams=max_streams, ttl=stream_ttl)

    def diarize(self, wav_bytes: bytes, **bounds):
        from ..io import wav as wavio
        from ..pipelines.diarization import StageTimings, precision_scope

        data = wavio.read_wav(io.BytesIO(wav_bytes))
        waveform = data.normalized_mono()
        timings = StageTimings()
        t0 = time.perf_counter()
        with precision_scope(self.pipeline.precision):
            if not self._lock.acquire(timeout=self.admission_timeout):
                raise ServiceBusy(
                    f"dispatch queue stalled for {self.admission_timeout:.0f}s"
                )
            try:
                pending = self.pipeline._dispatch(
                    waveform, data.sample_rate, timings=timings, **bounds
                )
                self.requests += 1
            finally:
                self._lock.release()
            annotation = self.pipeline._collect(pending, timings=timings, **bounds)
        wall = time.perf_counter() - t0
        return annotation, data.num_samples / data.sample_rate, wall


class StreamLimit(Exception):
    """Too many live streaming sessions (HTTP 429)."""


class StreamSessions:
    """Online diarization sessions over the shared pipeline.

    Each session owns a StreamingDiarizer plus a lock (feeds on one session
    are serialized; different sessions and offline requests interleave).
    Idle sessions are evicted after ``ttl`` seconds, checked whenever a
    session is opened."""

    def __init__(self, pipeline, max_streams: int = 16, ttl: float = 600.0):
        self.pipeline = pipeline
        self.max_streams = max_streams
        self.ttl = ttl
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self._next_id = 0

    def open(self, **kwargs) -> str:
        from ..pipelines.streaming import StreamingDiarizer

        stream = StreamingDiarizer(self.pipeline, **kwargs)
        with self._lock:
            now = time.monotonic()
            for sid in [
                s for s, (_, _, last) in self._sessions.items() if now - last > self.ttl
            ]:
                del self._sessions[sid]
            if len(self._sessions) >= self.max_streams:
                raise StreamLimit(f"{self.max_streams} live streams (close or wait for TTL)")
            sid = f"s{self._next_id}"
            self._next_id += 1
            self._sessions[sid] = (stream, threading.Lock(), now)
        return sid

    def _get(self, sid: str):
        with self._lock:
            entry = self._sessions.get(sid)
            if entry is None:
                raise KeyError(sid)
            stream, lock, _ = entry
            self._sessions[sid] = (stream, lock, time.monotonic())
        return stream, lock

    def feed(self, sid: str, samples):
        stream, lock = self._get(sid)
        with lock:
            ann = stream.feed(samples)
            seconds = stream.total_samples / 16000.0
        return ann, seconds

    def close(self, sid: str):
        """Flush and remove the session; it is removed even when the flush
        raises."""
        stream, lock = self._get(sid)
        try:
            with lock:
                ann = stream.flush()
                seconds = stream.total_samples / 16000.0
        finally:
            with self._lock:
                self._sessions.pop(sid, None)
        return ann, seconds

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)


def _turns_json(annotation):
    return [
        {
            "start": round(t.start, 3),
            "end": round(t.end, 3),
            "speaker": f"Speaker_{t.label}",
        }
        for t in annotation.turns()
    ]


def make_handler(service: DiarizationService, max_request_bytes: int = 256 << 20):
    class Handler(BaseHTTPRequestHandler):
        # socket read timeout: a client that stops sending mid-body cannot
        # hold a handler thread forever
        timeout = 60

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str):
            self._send(code, json.dumps({"error": message}).encode())

        def _discard_body(self, length: int):
            """Read and drop up to ``length`` body bytes (at most
            ``_DISCARD_BYTES``, for at most ``_DISCARD_S``). A client that
            sends its whole body before reading the reply (urllib does) is
            otherwise cut off mid-write when the server closes on unread
            bytes, and never reads the answer."""
            self.wfile.flush()
            left = min(length, _DISCARD_BYTES)
            deadline = time.monotonic() + _DISCARD_S
            try:
                while left > 0 and time.monotonic() < deadline:
                    chunk = self.rfile.read1(min(left, 1 << 16))
                    if not chunk:
                        break
                    left -= len(chunk)
            except OSError:
                pass

        def do_GET(self):
            if urlparse(self.path).path == "/health":
                self._send(
                    200,
                    json.dumps(
                        {
                            "status": "ok",
                            "requests": service.requests,
                            "streams": len(service.streams),
                        }
                    ).encode(),
                )
            else:
                self._error(404, "not found")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/diarize", "/stream/open", "/stream/feed", "/stream/close"):
                self._error(404, "not found")
                return
            query = parse_qs(url.query)

            def q_int(name):
                return int(query[name][0]) if name in query else None

            try:
                length = int(self.headers.get("Content-Length", 0))
                if length < 0:
                    raise ValueError("negative Content-Length")
            except (TypeError, ValueError):
                # the body length is unknown, so the keep-alive stream cannot
                # be resynchronized: answer and close it
                self.close_connection = True
                self._error(400, "bad Content-Length")
                return
            if length > max_request_bytes:
                # refuse before reading the body into memory, then close the
                # connection
                self.close_connection = True
                self._send(
                    413,
                    json.dumps(
                        {"error": "request too large", "max_bytes": max_request_bytes}
                    ).encode(),
                )
                self._discard_body(length)
                return
            body = self.rfile.read(length)
            if url.path != "/diarize":
                self._stream_request(url.path, query, body, q_int)
                return
            try:
                annotation, audio_s, wall_s = service.diarize(
                    body,
                    num_speakers=q_int("num_speakers"),
                    min_speakers=q_int("min_speakers"),
                    max_speakers=q_int("max_speakers"),
                )
            except ServiceBusy as exc:
                self._error(503, str(exc))
                return
            except Exception as exc:  # malformed wav or query etc.
                self._error(400, str(exc))
                return
            if query.get("format", ["json"])[0] == "rttm":
                self._send(200, (annotation.to_rttm("stream") + "\n").encode(), "text/plain")
                return
            self._send(
                200,
                json.dumps(
                    {
                        "turns": _turns_json(annotation),
                        "audio_seconds": round(audio_s, 3),
                        "wall_seconds": round(wall_s, 4),
                    }
                ).encode(),
            )

        def _stream_request(self, path, query, body, q_int):
            import numpy as np

            if path == "/stream/open":
                try:
                    kwargs = {}
                    for name in ("emit_every", "recluster_every"):
                        if name in query:
                            kwargs[name] = q_int(name)
                    if "schedule" in query:
                        kwargs["recluster_schedule"] = query["schedule"][0]
                    for b in ("num_speakers", "min_speakers", "max_speakers"):
                        if b in query:
                            kwargs[b] = q_int(b)
                    sid = service.streams.open(**kwargs)
                except StreamLimit as exc:
                    self._error(429, str(exc))
                    return
                except (TypeError, ValueError) as exc:
                    self._error(400, str(exc))
                    return
                self._send(200, json.dumps({"stream_id": sid}).encode())
                return

            sid = query.get("id", [None])[0]
            if sid is None:
                self._error(400, "missing id")
                return
            try:
                if path == "/stream/feed":
                    fmt = query.get("format", ["i16"])[0]
                    if fmt == "i16":
                        samples = np.frombuffer(body, dtype="<i2").astype(np.float32) / 32768.0
                    elif fmt == "f32":
                        samples = np.frombuffer(body, dtype="<f4")
                    else:
                        self._error(400, "format must be i16|f32")
                        return
                    ann, seconds = service.streams.feed(sid, samples)
                    self._send(
                        200,
                        json.dumps(
                            {
                                "emitted": ann is not None,
                                "turns": None if ann is None else _turns_json(ann),
                                "stream_seconds": round(seconds, 3),
                            }
                        ).encode(),
                    )
                else:  # /stream/close
                    ann, seconds = service.streams.close(sid)
                    self._send(
                        200,
                        json.dumps(
                            {"turns": _turns_json(ann), "stream_seconds": round(seconds, 3)}
                        ).encode(),
                    )
            except KeyError:
                self._error(404, "unknown stream id")
            except Exception as exc:
                self._error(400, str(exc))

    return Handler


def serve(
    service: DiarizationService,
    host="127.0.0.1",
    port=8787,
    max_request_bytes: int = 256 << 20,
):
    """A ThreadingHTTPServer for ``service``, bound but not yet serving
    (call ``serve_forever``); ``port`` 0 takes a free one
    (``server.server_address[1]``)."""
    return ThreadingHTTPServer((host, port), make_handler(service, max_request_bytes))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="diarization serving daemon on a CUDA card")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--device", default=None, help="torch device; the CUDA card by default, 'cpu' for the CPU"
    )
    parser.add_argument(
        "--mesh",
        action="store_true",
        help="accepted for the JAX CLI; one process serves one card, so it changes nothing",
    )
    parser.add_argument("--seg-batch", type=int, default=None)
    parser.add_argument("--emb-batch", type=int, default=None)
    parser.add_argument(
        "--max-request-mb",
        type=int,
        default=256,
        help="reject request bodies larger than this (HTTP 413) before "
        "reading them into memory",
    )
    parser.add_argument(
        "--admission-timeout",
        type=float,
        default=30.0,
        help="seconds a request may wait for the dispatch slot before "
        "failing fast with HTTP 503 (guards against a wedged device)",
    )
    parser.add_argument(
        "--warmup",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="run every chunk bucket up to this audio length before "
        "accepting requests (no first-request stall)",
    )
    parser.add_argument(
        "--max-streams",
        type=int,
        default=16,
        help="cap on live /stream sessions (HTTP 429 beyond it)",
    )
    parser.add_argument(
        "--stream-ttl",
        type=float,
        default=600.0,
        help="seconds of inactivity before a /stream session is evicted",
    )
    args = parser.parse_args(argv)

    pipeline = build_pipeline(args.checkpoint, args.seg_batch, args.emb_batch, args.device)
    if args.warmup > 0:
        warmed = pipeline.warmup(args.warmup)
        print(f"warmed {len(warmed)} chunk buckets (up to {args.warmup:.0f} s audio)")
    service = DiarizationService(
        pipeline,
        admission_timeout=args.admission_timeout,
        max_streams=args.max_streams,
        stream_ttl=args.stream_ttl,
    )
    server = serve(service, args.host, args.port, max_request_bytes=args.max_request_mb << 20)
    print(f"serving on http://{args.host}:{args.port} (POST /diarize)", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
