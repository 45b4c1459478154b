"""Readings for a cell's limits, at the cell's own size, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 3,4,5] [--fault-seeds 6,7,8] [--out FILE]

The pipeline is set up once. For each seed of ``--seeds`` the recordings
of that seed run as one cycle of the cell's traffic, grouped as in its
window, and every distinct recording's answer is compared with the plain
reference (a run compares a seed-drawn sample of them). For each seed of
``--control-seeds`` the reference one precision below the configuration's
stands in the program's place (check.control_answer). For each seed of
``--fault-seeds`` the program runs with its answers altered where they are
produced (``FAULTS``): every request's turns moved by one frame, one
binarized score of every seventh window flipped, the speaker count of
every fiftieth frame scaled by 0.6, and on the device route a twentieth
of the rows moved to another cluster.

Prints one JSON line a seed and a summary: for each number the largest
reading of the sound runs (the lower reading), and the smallest of the
control's and of the faults' (the upper readings). Runs the benchmark's
own check code, never the program's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, run, traffic as traffic_mod, weights as weights_mod


def _turns_moved(pipe):
    """Every turn's end moved one frame later, where the decode makes it."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.core.annotation import Annotation

    decode, frame = pipe._decode, pipe.config.segmentation.frame_step

    def faulty(*a, **k):
        out = Annotation()
        for t in decode(*a, **k).turns():
            out.add(t.start, t.end + frame, t.label)
        return out

    pipe._decode = faulty
    return lambda: setattr(pipe, "_decode", decode)


def _stage1_altered(pipe):
    """One binarized score of every seventh window flipped and the speaker
    count of every fiftieth frame scaled by 0.6, where stage 1 makes them."""
    post = pipe._post_process

    def faulty(segs, valid_frames):
        binarized, chosen, count_raw, inactive = post(segs, valid_frames)
        binarized, count_raw = binarized.clone(), count_raw.clone()
        binarized[::7, 100, 0] = 1.0 - binarized[::7, 100, 0]
        count_raw[::50] *= 0.6
        return binarized, chosen, count_raw, inactive

    pipe._post_process = faulty
    return lambda: setattr(pipe, "_post_process", post)


def _half_batch(pipe):
    """ECAPA run on the first half of each batch, the rest given the mean
    of that half's embeddings."""
    import torch

    model = pipe.embedding_model
    forward = model.forward

    def faulty(feats, lengths=None):
        half = max(feats.shape[0] // 2, 1)
        out = forward(feats[:half], None if lengths is None else lengths[:half])
        rest = out.mean(dim=0, keepdim=True).expand(feats.shape[0] - half, -1)
        return torch.cat([out, rest])

    model.forward = faulty
    return lambda: delattr(model, "forward")


def _labels_moved(pipe):
    """A twentieth of the rows moved to another cluster, where the device
    stage 3 labels them."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import diarization

    stage3 = diarization.stage3

    def faulty(*a, **k):
        act, hard, num_large = stage3(*a, **k)
        hard = hard.clone()
        hard[::20] = (hard[::20] + 1) % 8
        return act, hard, num_large

    diarization.stage3 = faulty
    return lambda: setattr(diarization, "stage3", stage3)


FAULTS = {
    "turns_moved": _turns_moved,
    "stage1_altered": _stage1_altered,
    "half_batch": _half_batch,
    "labels_moved": _labels_moved,
}


def plant_faults(pipe, names=("turns_moved", "stage1_altered", "labels_moved")):
    """Alter the program's answers where it produces them; returns the
    undo of each."""
    return [FAULTS[n](pipe) for n in names]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]

    import torch

    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, cfg, traffic, _ = run.cell_files(manifest, args.workload)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    weights = weights_mod.make(cfg, device)
    params = {p: weights_mod.nested(f) for p, f in weights.items()}
    pipe = run.build_pipeline(cfg, params, device)
    drv = run.Driver(pipe, traffic["bounds"])
    g = traffic["group"]
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    def program_readings(seed, kind):
        recs = traffic_mod.recordings(traffic, seed, device, cfg["sample_rate"])
        answers = {}
        for grp in traffic_mod.schedule(traffic, seed, 1):
            for i, (ann, pending, _) in zip(grp, drv.group([recs[i] for i in grp])):
                answers[i] = run.fetch_answer(pipe, pending, ann)
        torch.cuda.synchronize()
        per = [check.numbers_for(answers[i], recs[i], weights, cfg, traffic, device)
               for i in sorted(answers)]
        emit({"kind": kind, "seed": seed, "numbers": check.worst(per),
              "per_recording": per})

    for seed in seeds:
        program_readings(seed, "program")
    emit({"setup_and_program_s": time.perf_counter() - t0})
    for seed in control:
        recs = traffic_mod.recordings(traffic, seed, device, cfg["sample_rate"])
        per = [check.numbers_for(check.control_answer(r, weights, cfg, traffic, device), r,
                                 weights, cfg, traffic, device) for r in recs]
        emit({"kind": "control", "seed": seed, "numbers": check.worst(per), "per_recording": per})
    if faults:
        plant_faults(pipe)
        for seed in faults:
            program_readings(seed, "fault")
    summary = {}
    for kind, pick in (("program", max), ("control", min), ("fault", min)):
        got = [ln["numbers"] for ln in lines if ln.get("kind") == kind]
        names = sorted({k for n in got for k in n})
        summary[kind] = {k: pick(n[k] for n in got if k in n) for k in names}
    emit({"summary": summary, "workload": args.workload, "card": run.power_limit(),
          "seconds": time.perf_counter() - t0})
    if args.out:
        with open(args.out, "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
