"""Command-line entry point.

Reference: ``./speakerDiarizer <segment.onnx> <embedding.onnx> <wav>``
(pipeline/src/speakerDiarizer.cpp:3415-3442) printing
``[start -- end] --> Speaker_k`` lines plus per-stage timings. The port of
the JAX package's cli.py, with the same arguments and output, plus
``--device``: the CUDA card by default, ``cpu`` to run on the CPU.

    python -m pyannote_audio_speaker_diarization_cpp_tpu_torch.cli audio.wav \\
        [--checkpoint DIR] [--num-speakers N] [--rttm out.rttm] [--device cpu]

Weights: whatever models/ingest.py ``load_params_auto`` reads — a
converted checkpoint directory (``segmentation.npz`` and/or
``embedding.npz``, models/convert.py ``save_checkpoint``), a pyannote
Lightning checkpoint (``.ckpt``/``.bin``), a speechbrain savedir or its
``embedding_model.ckpt``, an ONNX export (segment2.onnx / emd4.onnx
layouts), or a directory holding a mix of them. Without one, or for a part
the artifacts lack, seeded (seed 0) random weights, with a warning.
"""

from __future__ import annotations

import argparse
import sys
import time

from .models.ingest import load_params_auto
from .pipelines.diarization import SpeakerDiarizationPipeline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="speaker diarization on a CUDA card")
    parser.add_argument(
        "wav", nargs="+", help="input audio (RIFF wav); several files run pipelined (map)"
    )
    parser.add_argument(
        "--checkpoint",
        default=None,
        help="weights: .npz checkpoint dir, pyannote .ckpt/.bin, speechbrain savedir, "
        "ONNX, or a directory of those",
    )
    parser.add_argument(
        "--seg-model",
        default=None,
        help="segmentation weights only (.ckpt/.bin/.onnx/.npz dir), overrides --checkpoint",
    )
    parser.add_argument(
        "--emb-model",
        default=None,
        help="embedding weights only (.ckpt/.onnx/savedir/.npz dir), overrides --checkpoint",
    )
    parser.add_argument("--num-speakers", type=int, default=None)
    parser.add_argument("--min-speakers", type=int, default=None)
    parser.add_argument("--max-speakers", type=int, default=None)
    parser.add_argument("--rttm", default=None, help="write RTTM to this path")
    parser.add_argument("--seg-batch", type=int, default=None)
    parser.add_argument("--emb-batch", type=int, default=None)
    parser.add_argument(
        "--device", default=None, help="torch device; the CUDA card by default, 'cpu' for the CPU"
    )
    args = parser.parse_args(argv)

    params = None
    if args.checkpoint:
        params = load_params_auto(args.checkpoint)
    if args.seg_model or args.emb_model:
        params = dict(params or {})
        if args.seg_model:
            params["segmentation"] = load_params_auto(args.seg_model)["segmentation"]
        if args.emb_model:
            params["embedding"] = load_params_auto(args.emb_model)["embedding"]
    if params is not None and ("segmentation" not in params or "embedding" not in params):
        # partial artifact: the pipeline fills the other model with seed-0
        # weights; say so, a silently random model makes the output
        # meaningless
        missing = [k for k in ("segmentation", "embedding") if k not in params]
        print(
            f"warning: no {' or '.join(missing)} weights in the given "
            "artifact(s); filling with RANDOM (seed-0) weights — the "
            "diarization will not be meaningful",
            file=sys.stderr,
        )

    t0 = time.perf_counter()
    pipeline = SpeakerDiarizationPipeline(
        params=params,
        seed=0,
        seg_batch=args.seg_batch,
        emb_batch=args.emb_batch,
        device=args.device,
    )
    bounds = dict(
        num_speakers=args.num_speakers,
        min_speakers=args.min_speakers,
        max_speakers=args.max_speakers,
    )
    if len(args.wav) == 1:
        annotations = [pipeline(args.wav[0], **bounds)]
    else:
        # several files: every request launched before the first is
        # collected, so one file's fetch and decode overlap the others'
        # device work
        annotations = pipeline.map(args.wav, **bounds)
    total = time.perf_counter() - t0

    for path, annotation in zip(args.wav, annotations):
        if len(args.wav) > 1:
            print(f"== {path}")
        for turn in annotation.turns():
            print(f"[{turn.start:.3f} -- {turn.end:.3f}] --> Speaker_{turn.label}")
    t = pipeline.timings
    print("-----------", file=sys.stderr)
    print(f"Segmentation time: {t.segmentation*1000:.0f}ms", file=sys.stderr)
    # stage 2's device time (CUDA events; 0 on the CPU): the dispatch does
    # not wait for the card, so there is no host span of it
    print(f"Embedding time: {t.stage2_ms:.0f}ms", file=sys.stderr)
    print(f"Fetch time: {t.fetch*1000:.0f}ms", file=sys.stderr)
    print(f"Clustering time: {t.clustering*1000:.0f}ms", file=sys.stderr)
    print(f"Total time: {total*1000:.0f}ms", file=sys.stderr)

    if args.rttm:
        with open(args.rttm, "w") as f:
            for path, annotation in zip(args.wav, annotations):
                f.write(annotation.to_rttm(path) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
