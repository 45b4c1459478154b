"""Diarization serving daemon, on the CUDA card.

Port of the JAX package's runtime/server.py. It keeps one pipeline resident
(the kernels built, the models on the card) and serves requests over HTTP
(stdlib only):

    python -m pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime.server \\
        [--port 8787] [--checkpoint DIR] [--device cpu] [--mesh]

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
pipeline's ``precision_scope``, which threads share.

``--mesh`` serves one pipeline across the ranks of a ``torch.distributed``
group, the port's form of the JAX flag (which spreads each request's
batches over all of one process's chips): every rank builds the pipeline
on its ``parallel/mesh.py`` ``DataMesh`` and runs each request on its block
of the batches. Under torchrun it joins torchrun's group (NCCL on cards,
gloo with ``--device cpu``); alone it starts one rank a visible card
(``parallel/dryrun.py`` ``spawn``). Rank 0 serves HTTP; the follower ranks
run ``follow``: ``MeshControl`` broadcasts each operation (a header of
int64 fields, then the float32 samples) on a gloo group of its own, and
rank 0 holds one lock from that broadcast through every call that makes a
collective, so that every rank makes them in one order (a /diarize's
dispatch; a stream's whole feed or flush). Whatever can be refused is
refused on rank 0 before the broadcast. A follower that stops answering
turns every later request into a 503.

    torchrun --nproc-per-node=N -m \\
        pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime.server --mesh
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import datetime
import io
import json
import logging
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

# how much of a refused (413) body is read and dropped before the close
_DISCARD_BYTES = 64 << 20
_DISCARD_S = 10.0

logger = logging.getLogger(__name__)


def build_pipeline(checkpoint=None, seg_batch=None, emb_batch=None, device=None, mesh=None):
    """The served pipeline: weights from ``checkpoint`` (anything
    models/ingest.py ``load_params_auto`` reads; None: seeded weights), on
    ``device`` (None: the CUDA card), or on ``mesh`` (a parallel/mesh.py
    ``DataMesh``: the mesh's device, each rank its block of the batches)."""
    from ..pipelines.diarization import SpeakerDiarizationPipeline

    params = None
    if checkpoint:
        from ..models.ingest import load_params_auto

        params = load_params_auto(checkpoint)
    return SpeakerDiarizationPipeline(
        params=params,
        seg_batch=seg_batch,
        emb_batch=emb_batch,
        device=None if mesh is not None else device,
        mesh=mesh,
    )


class ServiceBusy(Exception):
    """The dispatch lock was not acquired within the admission timeout —
    the pipeline is wedged or overloaded; fail fast instead of queueing."""


class MeshDown(ServiceBusy):
    """A rank of the mesh stopped answering; every later request is
    refused (HTTP 503)."""


# the control channel's operations
DIARIZE, OPEN, FEED, CLOSE, EVICT, STOP, HEARTBEAT = range(1, 8)
OP_NAMES = {
    DIARIZE: "diarize",
    OPEN: "open",
    FEED: "feed",
    CLOSE: "close",
    EVICT: "evict",
    STOP: "stop",
    HEARTBEAT: "heartbeat",
}
# the header's int64 fields, in order; ``count`` is the payload's length
# (float32 samples, or the int64 session ids of an evict)
HEADER = (
    "op",
    "sid",
    "count",
    "sample_rate",
    "num_speakers",
    "min_speakers",
    "max_speakers",
    "emit_every",
    "recluster_every",
    "schedule",
)
SCHEDULES = ("fixed", "doubling")
_NONE = -(1 << 63)  # a field that is not given
DEFAULT_MESH_TIMEOUT = 300.0


def _field(name, value) -> int:
    if value is None:
        return _NONE
    value = int(value)
    if not _NONE < value < 1 << 63:
        raise ValueError(f"{name}={value} is out of range")
    return value


class MeshControl:
    """The control channel of a pipeline served over a ``DataMesh``: rank 0
    broadcasts each operation to the follower ranks on a gloo group of its
    own (``dist.new_group``), so that host bytes never travel over NCCL.

    On rank 0, ``locked`` holds ``lock`` from an operation's ``send``
    through every pipeline call that makes a collective. ``start`` begins a
    heartbeat: whenever ``timeout / 4`` passes with no operation, one is
    sent, so an idle follower's wait never reaches ``timeout``, the control
    group's (gloo closes a group whose wait timed out). A send that fails
    (a follower died, or did not answer within ``timeout``) marks the mesh
    down for good. ``ops`` counts the operations sent (rank 0) or received
    (a follower) by name. Every rank constructs it, in the same order as
    its other groups."""

    def __init__(self, mesh, timeout: float = DEFAULT_MESH_TIMEOUT):
        import torch.distributed as dist

        self.mesh = mesh
        self.timeout = timeout
        self.group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout))
        self.lock = threading.Lock()
        self.down = None  # why the mesh is down, once it is
        self.ops = collections.Counter()
        self._evictions = []
        self._broadcast = False
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._heartbeat = None

    def header(self, op, payload=None, sid=None, **fields):
        """The int64 header of ``op``; raises ValueError on a field out of
        int64 range (before anything is sent)."""
        import torch

        unknown = set(fields) - set(HEADER)
        if unknown:
            raise TypeError(f"the control header has no field {sorted(unknown)}")
        values = dict.fromkeys(HEADER)
        values.update(fields, op=op, sid=sid, count=0 if payload is None else len(payload))
        return torch.tensor([_field(k, values[k]) for k in HEADER], dtype=torch.int64)

    @contextlib.contextmanager
    def locked(self, admission_timeout: float):
        """Hold the mesh lock: ServiceBusy when it is not free within
        ``admission_timeout``, MeshDown once the mesh is down. An exception
        raised inside after a ``send`` is checked with a heartbeat: a
        pipeline error is raised again (every follower raised it at the same
        point), a follower that does not answer raises MeshDown."""
        if not self.lock.acquire(timeout=admission_timeout):
            raise ServiceBusy(f"dispatch queue stalled for {admission_timeout:.0f}s")
        try:
            if self.down is not None:
                raise MeshDown(self.down)
            self._broadcast = False
            try:
                yield
            except MeshDown:
                raise
            except Exception:
                if self._broadcast:
                    self.send(self.header(HEARTBEAT))
                raise
        finally:
            self.lock.release()

    def evict(self, sids) -> None:
        """Queue session ids for the followers to drop; they go out before
        the next operation (rank 0, holding the lock)."""
        self._evictions.extend(sids)

    def send(self, header, payload=None) -> None:
        """Broadcast one operation (rank 0, holding the lock): the queued
        evictions first, then ``header`` and its payload."""
        import torch
        import torch.distributed as dist

        if self._evictions:
            ids, self._evictions = np.asarray(self._evictions, np.int64), []
            self.send(self.header(EVICT, payload=ids), ids)
        name = OP_NAMES[int(header[0])]
        try:
            dist.broadcast(header, 0, group=self.group)
            if payload is not None and len(payload):
                data = np.require(payload, requirements=["C", "W"])
                dist.broadcast(torch.from_numpy(data), 0, group=self.group)
        except RuntimeError as exc:
            self.down = f"the mesh is down: {name} to the followers failed: {exc}"
            raise MeshDown(self.down) from exc
        self._last = time.monotonic()
        self._broadcast = True
        self.ops[name] += 1

    def recv(self):
        """The next operation (a follower): (op, {field: value or None},
        payload as a numpy array, empty when there is none). Raises MeshDown
        when none came within ``timeout`` (rank 0 is gone)."""
        import torch
        import torch.distributed as dist

        header = torch.empty(len(HEADER), dtype=torch.int64)
        try:
            dist.broadcast(header, 0, group=self.group)
            fields = {k: (None if v == _NONE else v) for k, v in zip(HEADER, header.tolist())}
            op = fields.pop("op")
            dtype = torch.int64 if op == EVICT else torch.float32
            payload = torch.empty(fields["count"], dtype=dtype)
            if len(payload):
                dist.broadcast(payload, 0, group=self.group)
        except RuntimeError as exc:
            raise MeshDown(f"no operation from rank 0: {exc}") from exc
        self.ops[OP_NAMES[op]] += 1
        return op, fields, payload.numpy()

    def start(self) -> None:
        """Begin the heartbeat (rank 0, once it serves)."""
        if self.mesh.rank == 0 and self._heartbeat is None:
            self._heartbeat = threading.Thread(target=self._beat, name="mesh-heartbeat", daemon=True)
            self._heartbeat.start()

    def _beat(self) -> None:
        interval = self.timeout / 4
        while not self._stop.wait(interval / 4):
            if time.monotonic() - self._last < interval or not self.lock.acquire(blocking=False):
                continue
            try:
                if self.down is not None:
                    return
                self.send(self.header(HEARTBEAT))
            except MeshDown:
                return
            finally:
                self.lock.release()

    def close(self, admission_timeout: float = 30.0) -> None:
        """Stop the heartbeat and send ``stop``: each follower's ``follow``
        returns (rank 0)."""
        self._stop.set()
        if self._heartbeat is not None:
            self._heartbeat.join()
        if self.mesh.rank != 0 or not self.lock.acquire(timeout=admission_timeout):
            return
        try:
            if self.down is None:
                self.send(self.header(STOP))
        except MeshDown:
            pass
        finally:
            self.lock.release()


def follow(pipeline, control: MeshControl) -> dict:
    """A follower rank's loop: receive each operation from rank 0 and make
    the pipeline calls rank 0 makes for it, in its order, inside the same
    ``precision_scope``: a /diarize's ``_dispatch`` and ``_collect`` (whose
    result is dropped), and one ``StreamingDiarizer`` a session (open, feed,
    close, evict). A pipeline exception is the one rank 0 raises at the same
    point: it is logged and the loop goes on. Returns on ``stop``: the
    operations received by name, the errors and the live sessions. Raises
    MeshDown when rank 0 sent nothing within the control timeout."""
    from ..pipelines.diarization import precision_scope
    from ..pipelines.streaming import StreamingDiarizer

    streams = {}
    errors = 0
    while True:
        op, f, payload = control.recv()
        if op == STOP:
            break
        if op == HEARTBEAT:
            continue
        bounds = {k: f[k] for k in ("num_speakers", "min_speakers", "max_speakers")}
        try:
            with precision_scope(pipeline.precision):
                if op == DIARIZE:
                    pending = pipeline._dispatch(payload, f["sample_rate"], **bounds)
                    pipeline._collect(pending, **bounds)
                elif op == OPEN:
                    kwargs = {k: v for k, v in bounds.items() if v is not None}
                    for k in ("emit_every", "recluster_every"):
                        if f[k] is not None:
                            kwargs[k] = f[k]
                    if f["schedule"] is not None:
                        kwargs["recluster_schedule"] = SCHEDULES[f["schedule"]]
                    streams[f["sid"]] = StreamingDiarizer(pipeline, **kwargs)
                elif op == FEED:
                    streams[f["sid"]].feed(payload)
                elif op == CLOSE:
                    streams.pop(f["sid"]).flush()
                elif op == EVICT:
                    for sid in payload.tolist():
                        streams.pop(sid, None)
        except Exception:  # noqa: BLE001 - rank 0 raised it too; stay in step
            errors += 1
            logger.exception("rank %d: %s failed", control.mesh.rank, OP_NAMES[op])
    return {"ops": dict(control.ops), "errors": errors, "streams": len(streams)}


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

    ``control``: a ``MeshControl`` when the pipeline is on a mesh (rank 0):
    its lock is the dispatch lock, each request is broadcast to the
    followers inside it, and the streams take it too.
    """

    def __init__(
        self,
        pipeline,
        admission_timeout: float = 30.0,
        max_streams: int = 16,
        stream_ttl: float = 600.0,
        control: MeshControl = None,
    ):
        self.pipeline = pipeline
        self.admission_timeout = admission_timeout
        self.control = control
        self._lock = threading.Lock() if control is None else control.lock
        self.requests = 0
        self.streams = StreamSessions(
            pipeline,
            max_streams=max_streams,
            ttl=stream_ttl,
            control=control,
            admission_timeout=admission_timeout,
        )
        if control is not None:
            control.start()

    @contextlib.contextmanager
    def _dispatch_slot(self):
        if self.control is not None:
            with self.control.locked(self.admission_timeout):
                yield
            return
        if not self._lock.acquire(timeout=self.admission_timeout):
            raise ServiceBusy(f"dispatch queue stalled for {self.admission_timeout:.0f}s")
        try:
            yield
        finally:
            self._lock.release()

    def diarize(self, wav_bytes: bytes, **bounds):
        from ..io import wav as wavio
        from ..pipelines.diarization import StageTimings, precision_scope

        data = wavio.read_wav(io.BytesIO(wav_bytes))
        waveform = data.normalized_mono()
        header = None
        if self.control is not None:
            header = self.control.header(
                DIARIZE, payload=waveform, sample_rate=data.sample_rate, **bounds
            )
        timings = StageTimings()
        t0 = time.perf_counter()
        with precision_scope(self.pipeline.precision):
            with self._dispatch_slot():
                if header is not None:
                    self.control.send(header, waveform)
                pending = self.pipeline._dispatch(
                    waveform, data.sample_rate, timings=timings, **bounds
                )
                self.requests += 1
            annotation = self.pipeline._collect(pending, timings=timings, **bounds)
        wall = time.perf_counter() - t0
        return annotation, data.num_samples / data.sample_rate, wall

    def close(self) -> None:
        """On a mesh, stop the followers (``MeshControl.close``)."""
        if self.control is not None:
            self.control.close(self.admission_timeout)


class StreamLimit(Exception):
    """Too many live streaming sessions (HTTP 429)."""


class StreamSessions:
    """Online diarization sessions over the shared pipeline.

    Each session owns a StreamingDiarizer plus a lock (feeds on one session
    are serialized; different sessions and offline requests interleave).
    Idle sessions are evicted after ``ttl`` seconds, checked whenever a
    session is opened.

    With ``control`` (a mesh, rank 0) each open, feed and close is broadcast
    to the followers, and a feed or close holds the mesh lock (``ServiceBusy``
    after ``admission_timeout``) through the whole feed or flush, whose
    ``run_chunks`` gathers across the ranks; evicted ids go to the followers
    before the next operation."""

    def __init__(
        self,
        pipeline,
        max_streams: int = 16,
        ttl: float = 600.0,
        control: MeshControl = None,
        admission_timeout: float = 30.0,
    ):
        self.pipeline = pipeline
        self.max_streams = max_streams
        self.ttl = ttl
        self.control = control
        self.admission_timeout = admission_timeout
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self._next_id = 0

    def open(self, **kwargs) -> str:
        from ..pipelines.streaming import StreamingDiarizer

        stream = StreamingDiarizer(self.pipeline, **kwargs)
        if self.control is None:
            return self._register(stream)
        schedule = kwargs.pop("recluster_schedule", None)
        header = self.control.header(
            OPEN, schedule=None if schedule is None else SCHEDULES.index(schedule), **kwargs
        )
        with self.control.locked(self.admission_timeout):
            sid = self._register(stream)
            header[HEADER.index("sid")] = int(sid[1:])
            try:
                self.control.send(header)
            except MeshDown:
                with self._lock:
                    self._sessions.pop(sid, None)
                raise
        return sid

    def _register(self, stream) -> str:
        with self._lock:
            now = time.monotonic()
            idle = [s for s, (_, _, last) in self._sessions.items() if now - last > self.ttl]
            for sid in idle:
                del self._sessions[sid]
            if self.control is not None:
                self.control.evict(int(sid[1:]) for sid in idle)
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

    @contextlib.contextmanager
    def _broadcast(self, op, sid: str, stream, payload=None):
        """On a mesh: hold the mesh lock, check that ``sid`` is still live
        (an eviction may have come first: KeyError), broadcast ``op``."""
        header = self.control.header(op, payload=payload, sid=int(sid[1:]))
        with self.control.locked(self.admission_timeout):
            with self._lock:
                if self._sessions.get(sid, (None,))[0] is not stream:
                    raise KeyError(sid)
            self.control.send(header, payload)
            yield

    def feed(self, sid: str, samples):
        stream, lock = self._get(sid)
        with lock:
            if self.control is None:
                ann = stream.feed(samples)
            else:
                samples = np.asarray(samples, dtype=np.float32).reshape(-1)
                with self._broadcast(FEED, sid, stream, samples):
                    ann = stream.feed(samples)
            seconds = stream.total_samples / 16000.0
        return ann, seconds

    def close(self, sid: str):
        """Flush and remove the session; it is removed even when the flush
        raises."""
        stream, lock = self._get(sid)
        if self.control is not None:
            with lock, self._broadcast(CLOSE, sid, stream):
                try:
                    return stream.flush(), stream.total_samples / 16000.0
                finally:
                    with self._lock:
                        self._sessions.pop(sid, None)
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
                health = {
                    "status": "ok",
                    "requests": service.requests,
                    "streams": len(service.streams),
                }
                code = 200
                if service.control is not None:
                    health["ranks"] = service.control.mesh.world_size
                    if service.control.down is not None:
                        health["status"], code = "mesh down", 503
                self._send(code, json.dumps(health).encode())
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
                except ServiceBusy as exc:
                    self._error(503, str(exc))
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
            except ServiceBusy as exc:
                self._error(503, str(exc))
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
        help="serve one pipeline across the ranks of a torch.distributed group, each "
        "request's batches split over them: under torchrun, its group (NCCL on cards, "
        "gloo with --device cpu); alone, one rank a visible card (one with --device "
        "cpu). Rank 0 serves HTTP, the other ranks run each request with it; "
        "--seg-batch and --emb-batch must divide by the ranks",
    )
    parser.add_argument(
        "--mesh-timeout",
        type=float,
        default=DEFAULT_MESH_TIMEOUT,
        metavar="SECONDS",
        help="with --mesh: how long the ranks wait for one another, to form the group "
        "and on the control channel (a follower that hears nothing from rank 0 for "
        "this long exits; one that does not answer within it gets every request a "
        "503)",
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
    if args.mesh:
        return _main_mesh(args)

    pipeline = build_pipeline(args.checkpoint, args.seg_batch, args.emb_batch, args.device)
    if args.warmup > 0:
        warmed = pipeline.warmup(args.warmup)
        print(f"warmed {len(warmed)} chunk buckets (up to {args.warmup:.0f} s audio)")
    return _serve_forever(pipeline, args)


def _serve_forever(pipeline, args, control=None) -> int:
    service = DiarizationService(
        pipeline,
        admission_timeout=args.admission_timeout,
        max_streams=args.max_streams,
        stream_ttl=args.stream_ttl,
        control=control,
    )
    server = serve(service, args.host, args.port, max_request_bytes=args.max_request_mb << 20)
    print(f"serving on http://{args.host}:{args.port} (POST /diarize)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
    return 0


def serve_rank(mesh, args) -> int:
    """One rank of ``--mesh``: the pipeline on ``mesh``, its control channel,
    ``--warmup`` (every rank, before rank 0 accepts requests); then rank 0
    serves and the others ``follow``."""
    pipeline = build_pipeline(args.checkpoint, args.seg_batch, args.emb_batch, mesh=mesh)
    control = MeshControl(mesh, timeout=args.mesh_timeout)
    if args.warmup > 0:
        warmed = pipeline.warmup(args.warmup)
        if mesh.rank == 0:
            print(f"warmed {len(warmed)} chunk buckets (up to {args.warmup:.0f} s audio)")
    if mesh.rank != 0:
        follow(pipeline, control)
        return 0
    print(f"{mesh.world_size} ranks, {mesh.backend}", flush=True)
    return _serve_forever(pipeline, args, control)


def _main_mesh(args) -> int:
    import torch
    import torch.distributed as dist

    from ..parallel import dryrun
    from ..parallel.mesh import backend_for, make_mesh

    device = torch.device(args.device or "cuda")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        try:
            dist.init_process_group(
                backend_for(device), timeout=datetime.timedelta(seconds=args.mesh_timeout)
            )
        except (RuntimeError, ValueError) as exc:
            print(f"--mesh: the group did not form: {exc}", file=sys.stderr)
            return 1
        try:
            return serve_rank(make_mesh(device=device), args)
        finally:
            dist.destroy_process_group()
    world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world == 0:
        print("--mesh: no CUDA card (pass --device cpu for a gloo rank)", file=sys.stderr)
        return 1
    codes = dryrun.spawn(serve_rank, world, args, device=device.type, timeout=float("inf"))
    return max(codes)


if __name__ == "__main__":
    raise SystemExit(main())
