"""The port's serving daemon (runtime/server.py) on the CPU against the JAX
package's: each serves its tiny1s pipeline (the same weights, float32,
host clustering) on an ephemeral port. The same WAV gives equal JSON turns
and RTTM, an HTTP stream equal turns, and the limit, TTL, 413, 404 and 503
cases the same answers. The port alone: a malformed integer query answers
400 (the JAX server drops the connection on /stream/open), a session whose
flush raises is still closed, concurrent requests equal serial ones,
``precision_scope`` keeps TF32 off until the last thread leaves it, and
``--mesh`` builds the pipeline on a ``DataMesh`` or exits non-zero when its
group does not form (tests/test_torch_server_mesh.py serves over one)."""

import contextlib
import http.client
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _cfg import TINY1S_CFG
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import build_pair
from pyannote_audio_speaker_diarization_cpp_tpu.runtime import server as jserver
from pyannote_audio_speaker_diarization_cpp_tpu_torch.io import wav as wavio
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import diarization as tdia
from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import server as tserver


@contextlib.contextmanager
def running(module, pipeline, **kwargs):
    """``module``'s server for ``pipeline`` on an ephemeral port: (url,
    service)."""
    max_request_bytes = kwargs.pop("max_request_bytes", 256 << 20)
    service = module.DiarizationService(pipeline, **kwargs)
    server = module.serve(service, host="127.0.0.1", port=0, max_request_bytes=max_request_bytes)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", service
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def pair():
    """(JAX pipeline, port pipeline): tiny1s, the same weights, float32,
    host clustering."""
    return build_pair(TINY1S_CFG, batch=8, device_clustering=False)


@pytest.fixture(scope="module")
def urls(pair):
    with running(jserver, pair[0]) as (jax_url, _), running(tserver, pair[1]) as (port_url, _):
        yield jax_url, port_url


def _wav_bytes(seconds=3.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    samples = 3000 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0)
    samples = (samples + 600 * rng.normal(size=t.shape)).round()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.wav")
        wavio.write_wav(path, samples.astype(np.float32), 16000, 16)
        return open(path, "rb").read()


def _post(url, data=b""):
    """(status, body): the JSON body, or the text of a text/plain one."""
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            status, body, ctype = r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as err:
        status, body, ctype = err.code, err.read(), err.headers.get("Content-Type")
    return status, (json.loads(body) if ctype == "application/json" else body.decode())


def test_diarize_json_and_rttm_equal_the_jax_servers(urls):
    wav = _wav_bytes(seconds=6.3, seed=1)
    (js, jbody), (ts, tbody) = (_post(f"{u}/diarize", wav) for u in urls)
    assert js == ts == 200
    assert tbody["turns"] and tbody["turns"] == jbody["turns"]
    assert tbody["audio_seconds"] == jbody["audio_seconds"] == 6.3
    (js, jrttm), (ts, trttm) = (_post(f"{u}/diarize?format=rttm", wav) for u in urls)
    assert js == ts == 200
    assert trttm == jrttm and trttm.startswith("SPEAKER ")
    # speaker bounds take the query through to the clusterer
    (_, jbody), (_, tbody) = (_post(f"{u}/diarize?num_speakers=2", wav) for u in urls)
    assert tbody["turns"] == jbody["turns"]


def test_stream_over_http_equals_the_jax_servers(urls):
    rng = np.random.default_rng(50)
    audio = (0.1 * rng.normal(size=int(6.5 * 16000))).astype(np.float32)
    sids = [_post(f"{u}/stream/open?emit_every=2")[1]["stream_id"] for u in urls]
    for block in np.array_split(audio, 5):
        (_, jbody), (_, tbody) = (
            _post(f"{u}/stream/feed?id={sid}&format=f32", block.astype("<f4").tobytes())
            for u, sid in zip(urls, sids)
        )
        assert tbody == jbody
    (_, jfinal), (_, tfinal) = (_post(f"{u}/stream/close?id={sid}") for u, sid in zip(urls, sids))
    assert tfinal == jfinal and tfinal["stream_seconds"] == 6.5
    # i16 feeds and the health count
    sids = [_post(f"{u}/stream/open")[1]["stream_id"] for u in urls]
    health = [json.load(urllib.request.urlopen(f"{u}/health")) for u in urls]
    assert health[0]["streams"] == health[1]["streams"] >= 1
    samples = (rng.normal(size=16000) * 3000).astype("<i2").tobytes()
    (_, jbody), (_, tbody) = (_post(f"{u}/stream/feed?id={sid}", samples) for u, sid in zip(urls, sids))
    assert tbody == jbody and tbody["stream_seconds"] == 1.0
    for u, sid in zip(urls, sids):
        _post(f"{u}/stream/close?id={sid}")
    # a closed session is gone
    assert [_post(f"{u}/stream/feed?id={sid}")[0] for u, sid in zip(urls, sids)] == [404, 404]


def _raw_post(url, path, headers, body=b""):
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", path)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        return conn.getresponse().status
    finally:
        conn.close()


def test_error_answers_equal_the_jax_servers(pair, urls):
    for u in urls:
        assert _post(f"{u}/nope")[0] == 404
        assert urllib.request.urlopen(f"{u}/health").status == 200
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{u}/nope")
        assert err.value.code == 404
        assert _post(f"{u}/diarize", b"not a wav")[0] == 400
        assert _post(f"{u}/stream/feed", b"")[0] == 400  # missing id
        assert _post(f"{u}/stream/feed?id=zz", b"")[0] == 404
        assert _raw_post(u, "/diarize", {"Content-Length": "abc"}) == 400
    answers = []
    for module, pipe in zip((jserver, tserver), pair):
        with running(module, pipe, max_request_bytes=1024) as (url, _):
            got = [_post(f"{url}/diarize", b"x" * 2048)[0], _post(f"{url}/diarize", b"small")[0]]
        with running(module, pipe, admission_timeout=0.2) as (url, service):
            service._lock.acquire()  # a wedged dispatch
            try:
                got.append(_post(f"{url}/diarize", _wav_bytes())[0])
            finally:
                service._lock.release()
        with running(module, pipe, max_streams=1) as (url, _):
            first = _post(f"{url}/stream/open")
            got += [first[0], _post(f"{url}/stream/open")[0]]
            _post(f"{url}/stream/close?id={first[1]['stream_id']}")
            got.append(_post(f"{url}/stream/open")[0])  # capacity freed
        answers.append(got)
    assert answers[0] == answers[1] == [413, 400, 503, 200, 429, 200]


@pytest.mark.parametrize("module", [jserver, tserver], ids=["jax", "port"])
def test_stream_limits_and_ttl(pair, module):
    pipe = pair[0] if module is jserver else pair[1]
    sessions = module.StreamSessions(pipe, max_streams=2, ttl=1e9)
    a, b = sessions.open(), sessions.open()
    with pytest.raises(module.StreamLimit):
        sessions.open()
    sessions.close(a)
    sessions.open(emit_every=4)  # capacity freed
    assert len(sessions) == 2
    with pytest.raises(KeyError):
        sessions.feed("nope", np.zeros(10, np.float32))
    sessions.ttl = 0.0  # evicts everything at the next open
    time.sleep(0.01)
    sessions.open()
    assert len(sessions) == 1


def test_malformed_integer_query_answers_400(urls):
    port_url = urls[1]
    assert _post(f"{port_url}/stream/open?emit_every=abc")[0] == 400
    assert _post(f"{port_url}/stream/open?num_speakers=1.5")[0] == 400
    assert _post(f"{port_url}/diarize?num_speakers=two", _wav_bytes())[0] == 400
    # the server still answers
    assert urllib.request.urlopen(f"{port_url}/health").status == 200


def test_large_refused_body_still_gets_its_413(pair):
    """A client that sends a whole body over the limit before it reads the
    reply (urllib does) reads the 413 every time, and is not cut off
    mid-write by the server closing on unread bytes."""
    body = _wav_bytes(seconds=59.0)
    with running(tserver, pair[1], max_request_bytes=1024) as (url, _):
        assert [_post(f"{url}/diarize", body)[0] for _ in range(8)] == [413] * 8
        assert urllib.request.urlopen(f"{url}/health").status == 200


def test_failed_flush_still_frees_the_session(pair):
    sessions = tserver.StreamSessions(pair[1], max_streams=1)
    sid = sessions.open()
    stream = sessions._sessions[sid][0]

    def broken():
        raise RuntimeError("flush failed")

    stream.flush = broken
    with pytest.raises(RuntimeError):
        sessions.close(sid)
    assert len(sessions) == 0
    sessions.close(sessions.open())  # the slot is free


def test_concurrent_requests_equal_serial(urls):
    port_url = urls[1]
    payloads = [_wav_bytes(seconds=3.0 + s, seed=s) for s in range(4)]
    serial = [_post(f"{port_url}/diarize", p)[1]["turns"] for p in payloads]
    results = [None] * 4

    def worker(i):
        results[i] = _post(f"{port_url}/diarize", payloads[i])[1]["turns"]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == serial
    health = json.load(urllib.request.urlopen(f"{port_url}/health"))
    assert health["status"] == "ok" and health["requests"] >= 8


def test_precision_scope_keeps_tf32_off_until_the_last_thread_leaves():
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)  # noqa: E731
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    a_in, b_in, a_out, b_leave = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with tdia.precision_scope("highest"):
            a_in.set()
            b_in.wait()
        a_out.set()

    def thread_b():
        a_in.wait()
        with tdia.precision_scope("highest"):
            b_in.set()
            a_out.wait()
            seen["after_a_left"] = flags()  # A has left, B is inside
            b_leave.wait()
        seen["after_b_left"] = flags()

    try:
        threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
        for t in threads:
            t.start()
        a_out.wait(10)
        time.sleep(0.05)
        seen["main_while_b_inside"] = flags()
        b_leave.set()
        for t in threads:
            t.join(10)
        assert seen == {
            "after_a_left": (False, False),
            "main_while_b_inside": (False, False),
            "after_b_left": (True, True),
        }
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_mesh_flag_builds_the_pipeline_on_a_data_mesh(monkeypatch):
    """Under torchrun's variables ``--mesh`` joins the group (gloo with
    ``--device cpu``, here of one rank) and builds the pipeline on its
    ``DataMesh``; without the flag the pipeline gets the device and no mesh.
    The group is gone afterwards."""
    import torch.distributed as dist

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.mesh import DataMesh

    built = []

    class Built(Exception):
        pass

    def build(*args, **kwargs):
        built.append((args, kwargs))
        raise Built

    monkeypatch.setattr(tserver, "build_pipeline", build)
    with pytest.raises(Built):
        tserver.main(["--device", "cpu"])
    assert built.pop() == ((None, None, None, "cpu"), {})
    for name, value in dict(
        RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(dryrun.free_port()),
    ).items():
        monkeypatch.setenv(name, value)
    with pytest.raises(Built):
        tserver.main(["--device", "cpu", "--mesh", "--seg-batch", "4"])
    (args, kwargs), = built
    mesh = kwargs["mesh"]
    assert args == (None, 4, None) and isinstance(mesh, DataMesh)
    assert (mesh.rank, mesh.world_size, mesh.backend, str(mesh.device)) == (0, 1, "gloo", "cpu")
    assert not dist.is_initialized()


def test_mesh_group_that_does_not_form_exits_nonzero(monkeypatch, capsys):
    """Rank 0 of two, with no second rank: ``main`` gives up after
    ``--mesh-timeout`` and returns 1; it never serves from one rank."""
    import torch.distributed as dist

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun

    monkeypatch.setattr(tserver, "build_pipeline", pytest.fail)
    for name, value in dict(
        RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dryrun.free_port())
    ).items():
        monkeypatch.setenv(name, value)
    assert tserver.main(["--device", "cpu", "--mesh", "--mesh-timeout", "1"]) == 1
    assert "the group did not form" in capsys.readouterr().err
    assert not dist.is_initialized()
