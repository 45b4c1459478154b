"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); its limits are
``benchmark/limits/<workload>.json`` and each per-layer metric's reader is
``benchmark/metrics/<metric>.py``. Nothing here names a cell.

Set-up: the program's CUDA kernels are built (or found built) in the
checkout, the weights are drawn on the card from the configuration's seed,
the recordings are synthesized from ``--seed``, and one cycle of the
traffic runs through the pipeline, largest group first, so that every
shape of the cell is planned and allocated before the window.

The window: the traffic's groups, cycle after cycle, each group launched
and then collected in order as ``SpeakerDiarizationPipeline.map`` does
(through its two steps, ``_dispatch`` and ``_collect``, so that each
request keeps its own ``StageTimings`` and its outputs for the check);
it closes at the end of the first cycle that ends after ``--seconds``.

The check, after the window: the program's outputs for a seed-drawn
sample of the recordings against the plain reference (``benchmark/check.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
CACHE = HERE / ".cache"
# every build and kernel cache of the program and its libraries stays in
# the checkout, at fixed paths, so that only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
# the load comes from one process with few host threads: the pipeline's
# host work is one thread launching the card's work, and idle helper
# threads of the CPU thread pools only take cores from it
THREADS = 2
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

FORBIDDEN = ("jax", "jaxlib", "flax", "pyannote_audio_speaker_diarization_cpp_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(manifest, name: str):
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def cell_files(manifest, name: str):
    """(cell, config dict, traffic dict, limits dict) of a workload."""
    cell, conf = find_cell(manifest, name)
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return cell, cfg, traffic, limits


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program_config(cfg):
    """The program's configuration objects for a configuration file."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch import config as pc
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig

    seg, clu, fe = cfg["segmentation"], cfg["clustering"], cfg["frontend"]
    dia = pc.DiarizationConfig(
        frontend=pc.FrontendConfig(
            sample_rate=cfg["sample_rate"], n_fft=fe["n_fft"], n_mels=fe["n_mels"],
            f_min=fe["f_min"], f_max=fe["f_max"], amin=fe["amin"], top_db=fe["top_db"],
            win_length_ms=1000.0 * fe["n_fft"] / cfg["sample_rate"],
            hop_length_ms=1000.0 * fe["hop_length"] / cfg["sample_rate"],
        ),
        segmentation=pc.SegmentationConfig(
            duration=seg["duration"], step=seg["step"], batch_size=seg["batch_size"],
            sample_rate=cfg["sample_rate"], num_frames=seg["num_frames"],
            num_speakers=cfg["pyannet"]["num_classes"], onset=seg["onset"],
            offset=seg["offset"], min_duration_on=seg["min_duration_on"],
            min_duration_off=seg["min_duration_off"], warm_up=tuple(seg["warm_up"]),
            frame_step=seg["frame_step"], frame_duration=seg["frame_step"],
        ),
        embedding=pc.EmbeddingConfig(
            batch_size=cfg["embedding"]["batch_size"], dimension=cfg["ecapa"]["emb_dim"],
            min_num_samples=cfg["embedding"]["min_num_samples"],
            sample_rate=cfg["sample_rate"], mask_threshold=cfg["embedding"]["mask_threshold"],
        ),
        clustering=pc.ClusteringConfig(
            method=clu["method"], threshold=clu["threshold"],
            min_cluster_size=clu["min_cluster_size"],
            max_num_embeddings=clu["max_num_embeddings"],
        ),
        compute_dtype=cfg["compute_dtype"],
        transfer_dtype=cfg["transfer_dtype"],
        chunk_bucket=cfg["chunk_bucket"],
    )
    pn = cfg["pyannet"]
    pyannet = PyanNetConfig(
        sample_rate=cfg["sample_rate"],
        **{k: pn[k] for k in ("num_filters", "kernel_size", "stride", "min_low_hz",
                              "min_band_hz", "conv_channels", "lstm_hidden", "lstm_layers",
                              "linear_hidden", "linear_layers", "num_classes",
                              "leaky_slope")},
    )
    ec = cfg["ecapa"]
    ecapa = EcapaConfig(
        in_channels=ec["in_channels"], channels=tuple(ec["channels"]),
        kernel_sizes=tuple(ec["kernel_sizes"]), dilations=tuple(ec["dilations"]),
        attention_channels=ec["attention_channels"], res2net_scale=ec["res2net_scale"],
        se_channels=ec["se_channels"], emb_dim=ec["emb_dim"], eps=ec["eps"],
    )
    return dia, pyannet, ecapa


def build_pipeline(cfg, params, device):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    dia, pyannet, ecapa = program_config(cfg)
    return SpeakerDiarizationPipeline(
        config=dia, params=params, device=device, precision=cfg["precision"],
        pyannet_cfg=pyannet, ecapa_cfg=ecapa,
    )


class Driver:
    """Runs groups of recordings through the pipeline as ``map`` does, one
    ``StageTimings`` a request."""

    def __init__(self, pipe, bounds):
        from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import diarization

        self.pipe, self.bounds, self.dia = pipe, bounds, diarization

    def group(self, audios):
        """[(annotation, pending, timings)] of one group, in order."""
        pipe = self.pipe
        with self.dia.precision_scope(pipe.precision):
            timings = [self.dia.StageTimings() for _ in audios]
            pendings = [pipe._dispatch(a, timings=t, **self.bounds) for a, t in zip(audios, timings)]
            return [
                (pipe._collect(p, timings=t, **self.bounds), p, t)
                for p, t in zip(pendings, timings)
            ]


def fetch_answer(pipe, pending, annotation):
    """The program's outputs of one request, on the host: window scores,
    binarized scores, raw count, embedding rows (NaN where too short), the
    too-short and silent flags, the device route's labels, the turns."""
    import numpy as np
    import torch

    n = pending["num_chunks"]
    S = pipe.config.segmentation.num_speakers
    dc = pending.get("device_clu")
    tensors = [pending["segmentations"][:n], pending["binarized"][:n], pending["count_raw"],
               pending["emb"][: n * S], pending["too_short"][: n * S],
               pending["inactive"][:n]]
    if dc is not None:
        tensors += [dc["hard"][: n * S], dc["num_large"]]
    host = [t.detach().to("cpu").to(torch.float32 if t.is_floating_point() else t.dtype).numpy()
            for t in tensors]
    emb = host[3].astype(np.float32)
    emb[host[4]] = np.nan
    num_large = int(host[7]) if dc is not None else 0
    device_route = dc is not None and 1 <= num_large <= pipe.k_max
    return {
        "scores": host[0], "binarized": host[1], "count_raw": host[2].astype(np.float64),
        "emb": emb, "too_short": host[4], "inactive": host[5],
        "hard": host[6].reshape(n, S) if device_route else None,
        "num_large": num_large, "device_route": device_route,
        "turns": [(t.start, t.end, t.label) for t in annotation.turns()],
    }


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


@dataclasses.dataclass
class Request:
    index: int
    audio_s: float
    num_chunks: int
    num_padded: int
    timings: object


def main(argv=None, device=None, patch=None, cell_override=None):
    """``device``: None runs on the card (and stops without one); a test may
    pass "cpu". ``patch``: a test's function applied to the pipeline after
    its set-up (a fault planted in the timed path). ``cell_override``: a
    test's (cell, cfg, traffic, limits, per-layer metrics)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(THREADS)
    if cell_override is None:
        manifest = load_json(ROOT / "BENCHMARK.json")
        cell, cfg, traffic, limits = cell_files(manifest, args.workload)
        per_layer = manifest["per_layer"]
    else:
        cell, cfg, traffic, limits, per_layer = cell_override
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)

    from . import check, trace as tracing, traffic as traffic_mod, weights as weights_mod

    # ---- set-up --------------------------------------------------------
    weights = weights_mod.make(cfg, device)
    params = {part: weights_mod.nested(flat) for part, flat in weights.items()}
    pipe = build_pipeline(cfg, params, device)
    del params
    if patch is not None:
        patch(pipe)
    recs = traffic_mod.recordings(traffic, args.seed, device, cfg["sample_rate"])
    audio_s = [len(r) / cfg["sample_rate"] for r in recs]
    drv = Driver(pipe, traffic["bounds"])
    by_length = sorted(range(len(recs)), key=lambda i: -len(recs[i]))
    g = traffic["group"]
    for k in range(0, len(by_length), g):
        drv.group([recs[i] for i in by_length[k : k + g]])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    # ---- the window ----------------------------------------------------
    checked = traffic_mod.checked(traffic, args.seed)
    pick = traffic_mod.rng_for(args.seed, 4)
    held_cycle = {i: int(pick.integers(2)) for i in checked}
    per_cycle = -(-len(recs) // g)

    def window():
        held, requests, cycle = {}, [], 0
        t0 = time.perf_counter()
        while True:
            for grp in traffic_mod.schedule(traffic, args.seed, cycle + 1)[-per_cycle:]:
                for i, (ann, pending, timings) in zip(grp, drv.group([recs[i] for i in grp])):
                    requests.append(Request(i, audio_s[i], pending["num_chunks"],
                                            pending["num_padded"], timings))
                    if i in held_cycle and cycle <= held_cycle[i]:
                        held[i] = (pending, ann)
            cycle += 1
            if time.perf_counter() - t0 >= args.seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        return held, requests, cycle, t0, time.perf_counter()

    # the card's profiler has dropped the first events of a session: a
    # traced window whose marker kernels did not all reach the trace runs
    # again after a longer lead-in
    for lead_s in (0.5, 2.0, 4.0):
        try:
            with tracing.traced(torch, args.trace == 1 and on_card, lead_s) as tr:
                held, requests, cycle, t0, t1 = window()
            break
        except tracing.Incomplete as err:
            print(f"trace: {err}; the window runs again", file=sys.stderr)
    else:
        raise RuntimeError("the trace never held both marker kernels")
    window_s = t1 - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    answers = {i: fetch_answer(pipe, p, a) for i, (p, a) in held.items()}
    held.clear()
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del pipe, drv
    if on_card:
        torch.cuda.empty_cache()

    # ---- the check -------------------------------------------------------
    t_check = time.perf_counter()
    refs = {}
    stage1_all = args.trace == 1
    for i in range(len(recs)):
        if i in answers or stage1_all:
            refs[i] = check.reference_stage1(recs[i], weights, cfg, device)
    per_recording = []
    for i, ans in answers.items():
        ref2 = check.reference_stage2(recs[i], refs[i], weights, cfg, device)
        per_recording.append(check.numbers(ans, refs[i], ref2, cfg, traffic))
    failed = sum(1 for nums in per_recording
                 if not all(c["ok"] for c in check.judge(nums, limits).values()))
    checks = check.judge(check.worst(per_recording), limits)
    correct = failed == 0 and len(answers) == len(checked)
    check_s = time.perf_counter() - t_check

    # ---- metrics ---------------------------------------------------------
    total_audio = sum(r.audio_s for r in requests)
    result = {
        "correct": bool(correct),
        "attempted": len(requests),
        "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)},
    }
    if args.trace == 0:
        result["metrics"]["audio_s_per_s"] = {"value": total_audio / window_s, "unit": "audio-s/s"}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        ctx = {
            "requests": requests, "trace": tr, "window_s": window_s, "audio_s": total_audio,
            "cfg": cfg, "traffic": traffic, "refs": refs, "peak_bytes": peak,
            "workload": cell["name"], "on_card": on_card,
        }
        for metric in per_layer:
            if cell["name"] not in metric.get("workloads", [cell["name"]]):
                continue
            value = load_reader(metric["name"])(ctx)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        if on_card:
            result["device"]["busy_s"] = tr.busy_s()
            result["device"]["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
    result["checks"] = {
        name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()
    }

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    minutes = total_audio / 60.0
    spans = {f: sum(getattr(r.timings, f) for r in requests) / minutes
             for f in ("segmentation", "fetch", "clustering", "stage1_ms", "stage2_ms", "stage3_ms")}
    print(f"card: {power_limit() if on_card else 'cpu'}; window {window_s:.3f} s, "
          f"{len(requests)} requests, {cycle} cycles; set-up {setup_s:.3f} s; "
          f"check {check_s:.3f} s; a minute of audio: host enqueue "
          f"{1000 * spans['segmentation']:.2f} ms, collect "
          f"{1000 * (spans['fetch'] + spans['clustering']):.2f} ms, device stage spans "
          f"{spans['stage1_ms']:.2f} / {spans['stage2_ms']:.2f} / {spans['stage3_ms']:.2f} ms",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
