"""The port's serving daemon over a mesh (runtime/server.py ``--mesh``) on the
CPU: two gloo ranks spawned with parallel/dryrun.py ``spawn``, each with the
tiny1s pipeline on its ``DataMesh`` (the JAX package's weights, shared
through ``save_checkpoint``). Rank 0 serves on an ephemeral port and runs
the client; the follower runs ``follow``. The JSON turns of /diarize (with
and without ``num_speakers``) and of an HTTP stream equal the JAX package's
server on a 2-device mesh; concurrent requests and interleaved streams equal
serial ones; refused requests broadcast nothing; an idle server outlives
its control timeout; ``stop`` ends both ranks with exit 0; a follower that
dies turns every request into a 503 within the timeout.

The rank functions live here and import no JAX: the spawned ranks import
this module."""

import concurrent.futures
import contextlib
import functools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_parallel import TINY
from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun
from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import server as tserver

# the control channel's timeout: short in the group that idles and loses
# its follower, so that those cases run in seconds; the busy group's leaves
# room for a follower that a loaded host delays (rank 0's broadcast waits
# for the follower to finish its previous operation)
TIMEOUT = 2.0
BUSY_TIMEOUT = 60.0


def _wav_bytes(seconds, seed):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.io import wav as wavio
    import tempfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    samples = 3000 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0)
    samples = (samples + 600 * rng.normal(size=t.shape)).round()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.wav")
        wavio.write_wav(path, samples.astype(np.float32), 16000, 16)
        with open(path, "rb") as f:
            return f.read()


def _post(url, data=b""):
    """(status, JSON body)."""
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _health(url):
    try:
        with urllib.request.urlopen(f"{url}/health", timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@functools.cache
def _inputs():
    """The requests' inputs: a 6.3 s WAV, 6.5 s of stream audio, four WAVs
    of 3-6 s."""
    return (
        _wav_bytes(6.3, seed=1),
        (0.1 * np.random.default_rng(50).normal(size=int(6.5 * 16000))).astype(np.float32),
        [_wav_bytes(3.0 + s, seed=s) for s in range(4)],
    )


def _stream(url, audio, pieces=5, emit_every=2):
    """Open, feed ``audio`` in f32 pieces, close: every answer's body."""
    sid = _post(f"{url}/stream/open?emit_every={emit_every}")[1]["stream_id"]
    out = [_post(f"{url}/stream/feed?id={sid}&format=f32", b.astype("<f4").tobytes())[1]
           for b in np.array_split(audio, pieces)]
    return out + [_post(f"{url}/stream/close?id={sid}")[1]]


def _parity_requests(url):
    """The answers compared with the JAX package's server."""
    WAV, STREAM, _ = _inputs()
    return {
        "diarize": _post(f"{url}/diarize", WAV)[1]["turns"],
        "diarize_num_speakers": _post(f"{url}/diarize?num_speakers=2", WAV)[1]["turns"],
        "stream": _stream(url, STREAM),
    }


def _interleaved_streams(url, audios):
    """Two stream sessions fed in turns: each one's answers."""
    sids = [_post(f"{url}/stream/open?emit_every=2")[1]["stream_id"] for _ in audios]
    out = [[] for _ in audios]
    for blocks in zip(*(np.array_split(a, 4) for a in audios)):
        for i, (sid, b) in enumerate(zip(sids, blocks)):
            out[i].append(_post(f"{url}/stream/feed?id={sid}&format=f32", b.astype("<f4").tobytes())[1])
    for i, sid in enumerate(sids):
        out[i].append(_post(f"{url}/stream/close?id={sid}")[1])
    return out


def _served_client(url, service):
    """Rank 0's client on the healthy group."""
    WAV, STREAM, WAVS = _inputs()
    control = service.control
    out = {"parity": _parity_requests(url)}
    # serial, then four /diarize calls and two interleaved streams at once
    audios = [STREAM[: 3 * 16000], STREAM[16000 : 5 * 16000]]
    serial = {
        "diarize": [_post(f"{url}/diarize", w)[1]["turns"] for w in WAVS],
        "streams": _interleaved_streams(url, audios),
    }
    got = {"diarize": [None] * 4}

    def diarize(i):
        got["diarize"][i] = _post(f"{url}/diarize", WAVS[i])[1]["turns"]

    def streams():
        got["streams"] = _interleaved_streams(url, audios)

    threads = [threading.Thread(target=diarize, args=(i,)) for i in range(4)]
    threads.append(threading.Thread(target=streams))
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    out["concurrent_equal_serial"] = got == serial and not any(t.is_alive() for t in threads)
    # refused requests: nothing is broadcast
    before = dict(control.ops)
    service.streams.max_streams = 1
    held = _post(f"{url}/stream/open")[1]["stream_id"]
    after_open = dict(control.ops)
    refused = [
        _post(f"{url}/diarize", b"not a wav")[0],
        _post(f"{url}/diarize?num_speakers=two", WAV)[0],
        _post(f"{url}/diarize?num_speakers={1 << 70}", WAV)[0],
        _post(f"{url}/stream/open?emit_every=abc")[0],
        _post(f"{url}/stream/open?schedule=weekly")[0],
        _post(f"{url}/stream/open")[0],  # the cap
        _post(f"{url}/stream/feed?id=s999", b"")[0],
        _post(f"{url}/stream/feed", b"")[0],
        _post(f"{url}/nope")[0],
    ]
    with _serving(service, max_request_bytes=1024) as small:
        refused.append(_post(f"{small}/diarize", WAV)[0])
    out["refused"] = refused
    out["refused_sent_nothing"] = _without_heartbeats(control.ops) == _without_heartbeats(after_open)
    out["open_sent_one"] = _without_heartbeats(after_open) == {
        **_without_heartbeats(before),
        "open": before.get("open", 0) + 1,
    }
    _post(f"{url}/stream/close?id={held}")
    # a TTL eviction on rank 0 reaches the follower before the next operation
    service.streams.max_streams, service.streams.ttl = 4, 0.0
    idle = _post(f"{url}/stream/open")[1]["stream_id"]
    time.sleep(0.01)
    fresh = _post(f"{url}/stream/open")[1]["stream_id"]
    out["evicted"] = [_post(f"{url}/stream/feed?id={idle}", b"")[0], control.ops["evict"]]
    _post(f"{url}/stream/close?id={fresh}")
    out["health"] = _health(url)
    return out


def _idle_then_dead_client(url, service):
    """Rank 0's client in the short-timeout group: idle for twice the
    timeout, a request; then one in whose dispatch the follower leaves."""
    WAV = _inputs()[0]
    time.sleep(2 * service.control.timeout)
    status, body = _post(f"{url}/diarize", WAV)
    out = {"after_idle": (status, body.get("turns")), "heartbeats": service.control.ops["heartbeat"]}
    time.sleep(0.5)  # the follower's collect: it then waits for the next header
    t0 = time.monotonic()
    out["dead"] = _post(f"{url}/diarize", WAV)[0]
    out["dead_s"] = time.monotonic() - t0
    out["later"] = [_post(f"{url}/diarize", WAV)[0], _post(f"{url}/stream/open")[0]]
    out["health"] = _health(url)
    return out


class _Leave(BaseException):
    """Ends a follower in the middle of a request, as its death would: the
    rank returns, and its sockets close."""


def _leave_in_second_dispatch(pipeline):
    dispatch, calls = pipeline._dispatch, []

    def leaving(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise _Leave
        return dispatch(*args, **kwargs)

    pipeline._dispatch = leaving


@contextlib.contextmanager
def _serving(service, module=tserver, **kwargs):
    """``module``'s server for ``service`` on an ephemeral port: its URL."""
    server = module.serve(service, host="127.0.0.1", port=0, **kwargs)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


def _without_heartbeats(ops):
    return {k: v for k, v in ops.items() if k != "heartbeat"}


def _rank(mesh, ckpt, plan):
    """One rank of the served group: rank 0 serves and runs the ``plan``'s
    client, then stops the followers; a follower follows."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import load_checkpoint
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    pipeline = SpeakerDiarizationPipeline(params=load_checkpoint(ckpt), mesh=mesh, **TINY)
    control = tserver.MeshControl(mesh, timeout=BUSY_TIMEOUT if plan == "served" else TIMEOUT)
    if mesh.rank:
        if plan == "idle_then_dead":
            _leave_in_second_dispatch(pipeline)
            try:
                tserver.follow(pipeline, control)
            except _Leave:
                return {"left": True}
        return tserver.follow(pipeline, control)
    service = tserver.DiarizationService(pipeline, control=control, max_streams=4)
    client = {"served": _served_client, "idle_then_dead": _idle_then_dead_client}[plan]
    with _serving(service) as url:
        out = client(url, service)
    t0 = time.monotonic()
    service.close()
    out["close_s"] = time.monotonic() - t0
    out["ops"] = _without_heartbeats(control.ops)
    return out


# ---------------------------------------------------------------------------
# the reference: the JAX package's server on a 2-device mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, jax_pipeline):
    """The JAX pipeline's tiny1s weights, as ``save_checkpoint`` writes
    them."""
    import jax
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import save_checkpoint

    path = str(tmp_path_factory.mktemp("tiny1s") / "ckpt")
    save_checkpoint(path, jax.tree.map(np.asarray, jax_pipeline.params))
    return path


@pytest.fixture(scope="module")
def jax_pipeline():
    """The JAX package's tiny1s pipeline on a 2-device mesh, float32."""
    import dataclasses

    import jax
    from _cfg import SMALL_ECAPA, SMALL_PYANNET, TINY1S_CFG
    from pyannote_audio_speaker_diarization_cpp_tpu.parallel.mesh import make_mesh
    from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.diarization import (
        SpeakerDiarizationPipeline as JaxPipeline,
    )

    cfg = dataclasses.replace(TINY1S_CFG, compute_dtype="float32", transfer_dtype="float32")
    return JaxPipeline(
        cfg,
        seed=0,
        seg_batch=TINY["seg_batch"],
        emb_batch=TINY["emb_batch"],
        pyannet_cfg=SMALL_PYANNET,
        ecapa_cfg=SMALL_ECAPA,
        precision=jax.lax.Precision.HIGHEST,
        mesh=make_mesh(jax.devices()[:2]),
    )


@pytest.fixture(scope="module")
def served(checkpoint, jax_pipeline):
    """(each rank's result of the healthy group, the JAX package's server's
    answers): the JAX server, on a 2-device mesh, answers while the ranks
    run."""
    from pyannote_audio_speaker_diarization_cpp_tpu.runtime import server as jserver

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            dryrun.spawn, _rank, 2, checkpoint, "served", device="cpu", threads=1, timeout=240
        )
        with _serving(jserver.DiarizationService(jax_pipeline), jserver) as url:
            want = _parity_requests(url)
        return ranks.result(), want


def test_diarize_turns_equal_the_jax_mesh_server(served):
    got, want = served[0][0]["parity"], served[1]
    assert got["diarize"] and got["diarize"] == want["diarize"]
    assert got["diarize_num_speakers"] == want["diarize_num_speakers"]


def test_stream_equals_the_jax_mesh_server(served):
    got, want = served[0][0]["parity"]["stream"], served[1]["stream"]
    assert got == want and got[-1]["stream_seconds"] == 6.5
    assert any(answer.get("emitted") for answer in got)


def test_concurrent_requests_and_streams_equal_serial(served):
    assert served[0][0]["concurrent_equal_serial"]


def test_refused_requests_broadcast_nothing(served):
    rank0 = served[0][0]
    assert rank0["refused"] == [400, 400, 400, 400, 400, 429, 404, 400, 404, 413]
    assert rank0["open_sent_one"] and rank0["refused_sent_nothing"]


def test_ttl_eviction_reaches_the_follower(served):
    """The evicted session answers 404 on rank 0, one evict went out, and
    the follower ends holding no session (``stop`` test)."""
    assert served[0][0]["evicted"] == [404, 1]
    assert served[0][1]["streams"] == 0 and served[0][1]["ops"]["evict"] == 1


def test_stop_ends_every_rank_in_step(served):
    """spawn returned, so both ranks exited 0 after ``stop``; the follower
    received every operation rank 0 sent, raised nothing and holds no
    session."""
    rank0, follower = served[0]
    assert _without_heartbeats(follower["ops"]) == rank0["ops"]
    assert rank0["ops"]["stop"] == 1
    assert rank0["ops"]["diarize"] >= 10 and rank0["ops"]["feed"] >= 10
    assert follower["errors"] == 0 and follower["streams"] == 0
    assert rank0["close_s"] < TIMEOUT
    status, health = rank0["health"]
    assert status == 200 and health["status"] == "ok" and health["ranks"] == 2


@pytest.fixture(scope="module")
def idle_then_dead(checkpoint):
    """Each rank's result of the group with a 2 s control timeout: rank 0
    idles, serves, then loses its follower in the next request's dispatch."""
    return dryrun.spawn(
        _rank, 2, checkpoint, "idle_then_dead", device="cpu", threads=1, timeout=240
    )


def test_idle_server_outlives_its_control_timeout(idle_then_dead, served):
    rank0 = idle_then_dead[0]
    assert rank0["after_idle"] == (200, served[0][0]["parity"]["diarize"])
    assert rank0["heartbeats"] >= 2


def test_dead_follower_gives_503_within_the_timeout(idle_then_dead):
    rank0, follower = idle_then_dead
    assert follower == {"left": True}
    assert rank0["dead"] == 503 and rank0["dead_s"] < TIMEOUT + 1.0
    assert rank0["later"] == [503, 503]
    status, health = rank0["health"]
    assert status == 503 and health["status"] == "mesh down"
    assert rank0["ops"] == {"diarize": 2} and rank0["close_s"] < TIMEOUT
