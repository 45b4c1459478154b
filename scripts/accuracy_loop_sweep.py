#!/usr/bin/env python3
"""The train-then-diarize accuracy loop over several inits, in the JAX
package and in the port, on the CPU.

    python scripts/accuracy_loop_sweep.py --package port --keys 0-9
    python scripts/accuracy_loop_sweep.py --package jax --keys 0-9
    python scripts/accuracy_loop_sweep.py --package port-from-jax --keys 0-5
    python scripts/accuracy_loop_sweep.py --same-init 478

Each run is tests/test_accuracy_loop.py's loop (the data, the stop rule and
the thresholds) from init key ``k``: the JAX package with PRNG keys k,
k + 2 and k + 1 for PyanNet, the ECAPA trunk and the AAM head (the JAX
test's keys at k = 0); the port (tests/_torch_accuracy.py) with torch
generator seeds k, k + 2 and k + 1; or the port from the JAX package's
init of key k. One JSON line a run: PyanNet's steps and final loss, the
embeddings' within/across cosines, the DER and its parts against the
truth, the labels, and the thresholds missed.

``--same-init STEPS`` trains PyanNet from the JAX init of key 0 on the same
batches in both packages for STEPS steps with no stop, and prints the mean
loss of each step window, the largest difference between the two, the
loss of both on 16 held-out batches, and the DER each PyanNet gives with
the port's ECAPA trained as in the loop.

Torch and XLA run on ``--threads`` threads (default 2, as the port's
tests): float32 training takes another trajectory on another count. The
JAX package only runs here, on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _keys(text: str):
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(k) for k in text.split(",")]


def _jax_init(k: int) -> dict:
    import jax
    import numpy as np
    from _cfg import SMALL_ECAPA, SMALL_PYANNET

    from pyannote_audio_speaker_diarization_cpp_tpu.models import ecapa as E
    from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as P
    from pyannote_audio_speaker_diarization_cpp_tpu.models import training as JT

    tree = {
        "segmentation": P.init_pyannet(jax.random.PRNGKey(k), SMALL_PYANNET),
        "embedding": E.init_ecapa(jax.random.PRNGKey(k + 2), SMALL_ECAPA),
        "head": JT.init_aam_head(jax.random.PRNGKey(k + 1), SMALL_ECAPA.emb_dim, 2),
    }
    return jax.tree.map(np.asarray, tree)


def jax_loop(k: int) -> dict:
    """tests/test_accuracy_loop.py's body from ``_jax_init(k)``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import _torch_accuracy as A
    from _cfg import SMALL_ECAPA, SMALL_PYANNET, TINY1S_CFG, make_tiny1s_pipeline

    from pyannote_audio_speaker_diarization_cpp_tpu.core.annotation import Annotation
    from pyannote_audio_speaker_diarization_cpp_tpu.metrics.der import diarization_error_rate
    from pyannote_audio_speaker_diarization_cpp_tpu.models import ecapa as E
    from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as P
    from pyannote_audio_speaker_diarization_cpp_tpu.models import training as JT
    from pyannote_audio_speaker_diarization_cpp_tpu.ops import frontend as FE

    init = _jax_init(k)
    rng = np.random.default_rng(0)
    frames = P.pyannet_num_frames(A.SR, SMALL_PYANNET)
    opt = optax.adam(1e-3)
    params = jax.tree.map(jnp.asarray, init["segmentation"])
    state = JT.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(JT.make_segmentation_train_step(opt, SMALL_PYANNET))
    for it in range(A.SEG_MAX_STEPS):
        ws, ls = zip(*[A._make_window(rng, frames) for _ in range(A.BATCH)])
        state, loss = step(state, jnp.asarray(np.stack(ws)), jnp.asarray(np.stack(ls)))
        if it >= A.SEG_MIN_STEPS and float(loss) < A.SEG_TARGET:
            break
    tree = jax.tree.map(jnp.asarray, {"params": init["embedding"], "head": init["head"]})
    estate = JT.TrainState(tree, opt.init(tree), jnp.zeros((), jnp.int32))
    estep = jax.jit(JT.make_embedding_train_step(opt, SMALL_ECAPA))
    fcfg = TINY1S_CFG.frontend
    lens = jnp.ones((A.BATCH,), jnp.float32)
    for _ in range(A.ECAPA_STEPS):
        labs = rng.integers(0, 2, size=A.BATCH)
        wavs = np.stack([A._tone(rng, lab, A.SR) for lab in labs])
        feats = FE.compute_features(jnp.asarray(wavs), lens, fcfg)
        estate, _ = estep(estate, feats, lens, jnp.asarray(labs))
    emb = estate.params["params"]
    evalw = np.stack([A._tone(rng, lab, A.SR) for lab in (0, 1, 0, 1, 0, 1)])
    lens6 = jnp.ones((6,), jnp.float32)
    embs = np.array(
        E.ecapa_forward(emb, FE.compute_features(jnp.asarray(evalw), lens6, fcfg), lens6, SMALL_ECAPA)
    )
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    wav = A._conversation(rng)
    pipe = make_tiny1s_pipeline(params={"segmentation": state.params, "embedding": emb})
    hyp = pipe(wav, num_speakers=2)
    truth = Annotation()
    for spk, s, e in A.SEGMENTS:
        truth.add(s, e, spk)
    parts = diarization_error_rate(truth, hyp)
    return {
        "pyannet_steps": it + 1,
        "pyannet_loss": float(loss),
        "within": float((embs[0] @ embs[2] + embs[1] @ embs[3]) / 2),
        "across": float(embs[0] @ embs[1]),
        "der": parts.der,
        "missed_s": parts.missed,
        "false_alarm_s": parts.false_alarm,
        "confusion_s": parts.confusion,
        "labels": len(hyp.labels),
    }


def port_loop(init: dict) -> dict:
    import _torch_accuracy as A

    report = A.run_accuracy_loop("cpu", init=init)
    keep = ("pyannet_steps", "pyannet_loss", "within", "across", "der", "missed_s",
            "false_alarm_s", "confusion_s", "labels")
    return {key: report[key] for key in keep}


def same_init(steps: int) -> dict:
    """Both packages' PyanNet from the JAX init of key 0 on the same
    batches, ``steps`` steps, no stop."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import _torch_accuracy as A
    from _cfg import SMALL_PYANNET
    from _torch_cfg import make_tiny1s_pipeline

    from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as P
    from pyannote_audio_speaker_diarization_cpp_tpu.models import training as JT
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import training as T
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        precision_scope,
    )

    frames = P.pyannet_num_frames(A.SR, SMALL_PYANNET)

    def batches(rng, n):
        return [
            tuple(np.stack(x) for x in zip(*[A._make_window(rng, frames) for _ in range(A.BATCH)]))
            for _ in range(n)
        ]

    rng = np.random.default_rng(0)
    train = batches(rng, steps)
    held_out = batches(np.random.default_rng(123), 16)
    init = _jax_init(0)
    opt = optax.adam(1e-3)
    params = jax.tree.map(jnp.asarray, init["segmentation"])
    state = JT.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(JT.make_segmentation_train_step(opt, SMALL_PYANNET))
    jax_losses = []
    for w, lab in train:
        state, loss = step(state, jnp.asarray(w), jnp.asarray(lab))
        jax_losses.append(float(loss))
    with precision_scope("highest"):
        tstate = T.init_train_state(init["segmentation"], device="cpu")
        tstep = T.make_segmentation_train_step(A.SMALL_PYANNET)
        port_losses = []
        for w, lab in train:
            tstate, loss = tstep(tstate, w, lab)
            port_losses.append(float(loss))
    trees = {"jax": jax.tree.map(np.asarray, state.params), "port": A._numpy_tree(tstate.params)}

    def held_out_loss(tree):
        p = jax.tree.map(jnp.asarray, tree)
        return float(np.mean([JT.pit_bce_loss(p, jnp.asarray(w), jnp.asarray(lab), SMALL_PYANNET)
                              for w, lab in held_out]))

    # the port's ECAPA as the loop trains it after these steps, so only
    # PyanNet differs
    init_port = A.initial_weights(0)
    with precision_scope("highest"):
        emb, _, _ = A._train_ecapa(rng, "cpu", init_port["embedding"], init_port["head"])
        A._separation(rng, emb, "cpu")
    wav = A._conversation(rng)
    ders = {}
    for name, tree in trees.items():
        pipe = make_tiny1s_pipeline(params={"segmentation": tree, "embedding": emb}, device="cpu")
        ders[name] = A.der(A._truth(), pipe(wav, num_speakers=2))
    jl, pl = np.array(jax_losses), np.array(port_losses)
    windows = [(0, 10), (10, 100), (100, 200), (200, 300), (300, 400), (400, steps)]
    return {
        "same_init_steps": steps,
        "windows": [
            {"steps": [a, b], "jax": float(jl[a:b].mean()), "port": float(pl[a:b].mean()),
             "max_abs_diff": float(np.abs(jl[a:b] - pl[a:b]).max())}
            for a, b in windows if a < steps
        ],
        "held_out_loss": {name: held_out_loss(tree) for name, tree in trees.items()},
        "der": ders,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=("jax", "port", "port-from-jax"), default="port")
    parser.add_argument("--keys", default="0", help="init keys: 0-9 or 0,10,20")
    parser.add_argument("--threads", type=int, default=2)
    parser.add_argument("--same-init", type=int, default=0, metavar="STEPS")
    args = parser.parse_args(argv)
    os.environ["XLA_FLAGS"] = (
        "--xla_cpu_multi_thread_eigen=false "
        f"intra_op_parallelism_threads={args.threads}"
    )
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    import _torch_accuracy as A

    if args.same_init:
        print(json.dumps(same_init(args.same_init)), flush=True)
        return 0
    for k in _keys(args.keys):
        if args.package == "jax":
            out = jax_loop(k)
        elif args.package == "port":
            out = port_loop(A.initial_weights(k))
        else:
            out = port_loop(_jax_init(k))
        out = dict(package=args.package, key=k, threads=args.threads, **out)
        out["failures"] = A.failures(out)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
