"""Command-line entry point.

Reference: ``./speakerDiarizer <segment.onnx> <embedding.onnx> <wav>``
(pipeline/src/speakerDiarizer.cpp:3415-3442) printing
``[start -- end] --> Speaker_k`` lines plus per-stage timings. The port of
the JAX package's cli.py, with the same arguments and output, plus
``--device``: the CUDA card by default, ``cpu`` to run on the CPU.

    python -m pyannote_audio_speaker_diarization_cpp_tpu_torch.cli audio.wav \\
        [--checkpoint DIR] [--num-speakers N] [--rttm out.rttm] [--device cpu]

Weights: a converted checkpoint directory (``segmentation.npz`` and/or
``embedding.npz``, models/convert.py ``save_checkpoint``); without one, or
for a part the directory lacks, seeded (seed 0) random weights. The other
artifacts the JAX package's CLI reads (pyannote ``.ckpt``/``.bin``,
speechbrain savedir, ONNX) need its weight ingest (models/ingest.py), which
the port does not have yet: they raise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .models.convert import load_checkpoint
from .pipelines.diarization import SpeakerDiarizationPipeline


def load_artifact(path: str) -> dict:
    """The parts of a converted ``.npz`` checkpoint directory; raises for
    any other artifact."""
    has_npz = os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f"{name}.npz"))
        for name in ("segmentation", "embedding")
    )
    if not has_npz:
        raise ValueError(
            f"{path}: not a converted .npz checkpoint directory; other weight "
            "formats (pyannote .ckpt/.bin, speechbrain savedir, ONNX) need the "
            "weight-ingest port (models/ingest.py), which this package does not "
            "have yet"
        )
    return load_checkpoint(path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="speaker diarization on a CUDA card")
    parser.add_argument(
        "wav", nargs="+", help="input audio (RIFF wav); several files run pipelined (map)"
    )
    parser.add_argument(
        "--checkpoint",
        default=None,
        help="weights: a converted .npz checkpoint directory (segmentation.npz, embedding.npz)",
    )
    parser.add_argument(
        "--seg-model",
        default=None,
        help="segmentation weights only (a converted .npz directory), overrides --checkpoint",
    )
    parser.add_argument(
        "--emb-model",
        default=None,
        help="embedding weights only (a converted .npz directory), overrides --checkpoint",
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
        params = load_artifact(args.checkpoint)
    if args.seg_model or args.emb_model:
        params = dict(params or {})
        if args.seg_model:
            params["segmentation"] = load_artifact(args.seg_model)["segmentation"]
        if args.emb_model:
            params["embedding"] = load_artifact(args.emb_model)["embedding"]
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
