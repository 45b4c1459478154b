"""Data-parallel dry run: the pipeline on a mesh of n ranks against one rank.

The port's counterpart of the JAX package's ``dryrun_multichip`` inference
cases, on ``torch.distributed`` ranks (one process a rank):

  1. the pipeline on the mesh equals the mesh-less pipeline on the rank's
     device, with ``num_speakers=2`` (the host dendrogram search);
  1b. the same with no speaker bound (device clustering, when the pipeline
     takes it);
  1c. long-form with 2 shards on the mesh equals long-form on one rank;
  2. one data-parallel PIT-BCE Adam step of a slim PyanNet (batch 2 x
     world rows of 4000 samples; ``train_case``) equals the same step in one
     process: loss and gradients, and every rank holds the same parameters.

Every rank asserts its cases (``require_equal``) and reports the largest
difference between the mesh's and the single rank's embeddings, and the
launches of each CUDA kernel: in the mesh pipeline's one request, where
the rank runs its block of the stage-2 batches, and in all its cases. A
rank that fails or outlives the time limit fails the run.

    python -m pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.dryrun \\
        --ranks 2 --device cpu            # gloo ranks on the CPU
    torchrun --nproc-per-node=<cards> -m \\
        pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.dryrun --device cuda

(NCCL, one card a rank.) ``--share-card`` runs ``--ranks`` gloo ranks on
cuda:0, where NCCL refuses two ranks on one card. The model is the
published PyanNet and ECAPA-TDNN with seeded weights, ``--seconds`` of a
synthetic clip; ``--float32`` runs the parity mode (float32 compute and
transfer, precision "highest").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue as queue_mod
import socket
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DataMesh, backend_for, batch_spec, make_mesh


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, share_card, threads, fn, args, results):
    """One spawned rank: join the group, build its mesh, run ``fn(mesh,
    *args)`` and send back (rank, its result)."""
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", 0 if share_card else rank)
        torch.cuda.set_device(device)
    backend = "gloo" if share_card else backend_for(device)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank
    )
    try:
        results.put((rank, fn(make_mesh(device=device), *args)))
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable,
    world: int,
    *args,
    device: str = "cuda",
    share_card: bool = False,
    threads: Optional[int] = None,
    timeout: float = 600.0,
) -> List:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks and return each
    rank's result, in rank order. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). ``device``: "cuda" (NCCL, rank r on cuda:r; the
    default) or "cpu" (gloo); ``share_card``: gloo ranks all on cuda:0.
    ``threads``: torch threads a rank. A rank that raises, dies or is still
    running after ``timeout`` seconds raises here, and every rank is
    stopped."""
    on_card = torch.device(device).type == "cuda"
    if share_card and not on_card:
        raise ValueError("share_card runs the ranks on cuda:0")
    cards = 1 if share_card else world
    if on_card and torch.cuda.device_count() < cards:
        raise RuntimeError(
            f"{world} ranks on {device} need {cards} CUDA card(s), "
            f"{torch.cuda.device_count()} visible; pass device=\"cpu\" for gloo ranks "
            "on the CPU"
        )
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = torch.multiprocessing.start_processes(
        _rank_main,
        args=(world, free_port(), device, share_card, threads, fn, args, results),
        nprocs=world,
        join=False,
        start_method="spawn",
    )
    out: Dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                rank, value = results.get(timeout=0.5)
                out[rank] = value
            except queue_mod.Empty:
                pass
            if procs.join(timeout=0):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    while len(out) < world:
        rank, value = results.get(timeout=10)
        out[rank] = value
    return [out[r] for r in range(world)]


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launch count in this process so far (0 on
    the CPU, where the wrappers run their plain versions)."""
    from ..ops import asp_cuda, frontend_cuda, linkage_cuda, pack_cuda

    return {
        "pack_frames": pack_cuda.pack_frames.launches,
        "log_mel": frontend_cuda.log_mel_spectrogram.launches,
        "asp_pool": asp_cuda.asp_pool.bfloat16_launches,
        "asp_pool_float32": asp_cuda.asp_pool.float32_launches,
        "linkage": linkage_cuda.linkage_labels.launches,
    }


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in kernel_launches().items()}


def turns(annotation) -> List[tuple]:
    return [(round(t.start, 6), round(t.end, 6), t.label) for t in annotation.turns()]


def dryrun_cases(
    mesh: DataMesh,
    pipeline_kwargs: dict,
    params,
    audio: np.ndarray,
    require_equal: bool = True,
    rtol: float = 1e-3,
    atol: float = 1e-4,
) -> dict:
    """Cases 1, 1b, 1c and 2 on this rank. ``params``: a params tree, a
    directory written by models/convert.py ``save_checkpoint``, or None
    (seeded weights, the same on every rank). Returns each case's turns and
    whether they are equal, and the embeddings' largest difference (valid
    rows) and whether it is within ``rtol``/``atol``."""
    from ..models.convert import load_checkpoint
    from ..pipelines.diarization import SpeakerDiarizationPipeline, precision_scope
    from .longform import LongFormDiarizer

    if isinstance(params, str):
        params = load_checkpoint(params)
    single = SpeakerDiarizationPipeline(params=params, device=mesh.device, **pipeline_kwargs)
    sharded = SpeakerDiarizationPipeline(params=params, mesh=mesh, **pipeline_kwargs)
    report = {
        "rank": mesh.rank,
        "world": mesh.world_size,
        "backend": mesh.backend,
        "device": str(mesh.device),
    }
    start = kernel_launches()
    with precision_scope(single.precision):
        a = single._dispatch(audio)
        before = kernel_launches()
        b = sharded._dispatch(audio)
        report["mesh_request_launches"] = _since(before)
        valid = ~a["too_short"]
        emb_a, emb_b = a["emb"][valid].float(), b["emb"][valid].float()
        report["too_short_equal"] = bool(torch.equal(a["too_short"], b["too_short"]))
        report["emb_max_abs_err"] = float((emb_a - emb_b).abs().max()) if len(emb_a) else 0.0
        report["emb_within"] = bool(torch.isclose(emb_b, emb_a, rtol=rtol, atol=atol).all())
        report["embedding_rows"] = int(valid.sum())
    cases = {
        "1": lambda pipe: pipe(audio, num_speakers=2),
        "1b": lambda pipe: pipe(audio),
        "1c": lambda pipe: LongFormDiarizer(pipe, num_shards=2)(audio),
    }
    for name, run in cases.items():
        want, got = turns(run(single)), turns(run(sharded))
        report[name] = {"turns": len(want), "turns_equal": want == got}
        if require_equal and want != got:
            raise AssertionError(f"case {name}: the mesh diverged\n single: {want}\n mesh: {got}")
    report["launches"] = _since(start)
    if require_equal and not (report["too_short_equal"] and report["emb_within"]):
        raise AssertionError(f"the mesh's embeddings diverged: {report}")
    report["2"] = train_case(mesh)
    return report


# the JAX package's dry-run training model: a slim PyanNet
SLIM_PYANNET = dict(
    num_filters=16, conv_channels=12, lstm_hidden=16, lstm_layers=2, linear_hidden=16
)


def train_case(
    mesh: DataMesh,
    batch: Optional[int] = None,
    num_samples: int = 4000,
    seed: int = 0,
    rtol: float = 1e-4,
    atol: float = 1e-6,
) -> dict:
    """Case 2 on this rank: one PIT-BCE step with Adam of a slim PyanNet
    (seeded weights) on the mesh, each rank on its block of the batch's
    rows (``batch`` default 2 x world; uneven blocks allowed), against the
    same step on the whole batch in this process, both on the rank's device
    with TF32 off. The losses and the (summed) gradients must agree at
    ``rtol``/``atol``; raises otherwise. Returns the losses, this rank's rows,
    the gradients' largest difference and a digest of the stepped
    parameters (equal on every rank)."""
    from ..models.convert import pyannet_tree
    from ..models.pyannet import PyanNet, PyanNetConfig, pyannet_num_frames
    from ..models.trainer import segmentation_trainer
    from ..pipelines.diarization import precision_scope
    from ..utils.checkpoint import tree_leaves

    cfg = PyanNetConfig(**SLIM_PYANNET)
    params = pyannet_tree(PyanNet(cfg))
    batch = batch or 2 * mesh.world_size
    rng = np.random.default_rng(seed)
    frames = pyannet_num_frames(num_samples, cfg)
    waveforms = rng.normal(size=(batch, num_samples)).astype(np.float32)
    labels = (rng.uniform(size=(batch, frames, cfg.num_classes)) > 0.5).astype(np.float32)
    with precision_scope("highest"):
        dp = segmentation_trainer(params, cfg, mesh=mesh)
        one = segmentation_trainer(params, cfg, device=mesh.device)
        loss, loss_one = dp.step(waveforms, labels), one.step(waveforms, labels)
    grads = [(p.grad, q.grad) for p, q in zip(tree_leaves(dp.params), tree_leaves(one.params))]
    err = max(float((g - h).abs().max()) for g, h in grads)
    within = all(bool(torch.isclose(g, h, rtol=rtol, atol=atol).all()) for g, h in grads)
    report = {
        "batch": [batch, num_samples],
        "rows": len(batch_spec(mesh, batch)),
        "loss": loss,
        "loss_single": loss_one,
        "grad_max_abs_err": err,
        "grads_within": within,
        "step": dp.state.step,
        "params_digest": float(sum(p.detach().double().sum() for p in tree_leaves(dp.params))),
    }
    if not (np.isfinite(loss) and within and np.isclose(loss, loss_one, rtol=rtol, atol=atol)):
        raise AssertionError(f"case 2: the data-parallel step diverged: {report}")
    return report


def dryrun_multichip(
    n_ranks: int,
    pipeline_kwargs: dict,
    audio: np.ndarray,
    params=None,
    device: str = "cuda",
    share_card: bool = False,
    require_equal: bool = True,
    threads: Optional[int] = None,
    timeout: float = 600.0,
) -> List[dict]:
    """Spawn ``n_ranks`` ranks (``spawn``: on the card unless ``device`` is
    "cpu") and run ``dryrun_cases`` on each; returns every rank's report
    (each rank's turns must also equal rank 0's)."""
    reports = spawn(
        dryrun_cases,
        n_ranks,
        pipeline_kwargs,
        params,
        audio,
        require_equal,
        device=device,
        share_card=share_card,
        threads=threads,
        timeout=timeout,
    )
    for r in reports[1:]:
        for case in ("1", "1b", "1c"):
            if r[case] != reports[0][case]:
                raise AssertionError(f"rank {r['rank']} case {case} differs from rank 0")
        for key in ("loss", "params_digest"):
            if r["2"][key] != reports[0]["2"][key]:
                raise AssertionError(f"rank {r['rank']} case 2: {key} differs from rank 0")
    return reports


def synthetic_clip(seconds: float, seed: int = 0, sr: int = 16000) -> np.ndarray:
    """Two gated tones and noise (the JAX package's dry-run clip)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.4 * t) > 0)
        + 0.2 * np.sin(2 * np.pi * 880 * t) * (np.sin(2 * np.pi * 0.27 * t + 1) > 0)
        + 0.02 * rng.normal(size=t.shape)
    ).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2, help="ranks to spawn (not under torchrun)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--share-card", action="store_true", help="gloo ranks all on cuda:0")
    ap.add_argument("--seconds", type=float, default=59.0)
    ap.add_argument("--float32", action="store_true", help="the parity mode")
    args = ap.parse_args(argv)

    from ..config import DEFAULT_CONFIG

    cfg = DEFAULT_CONFIG
    kwargs = {"seed": 0}
    if args.float32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32", transfer_dtype="float32")
        kwargs["precision"] = "highest"
    kwargs["config"] = cfg
    audio = synthetic_clip(args.seconds)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(device))
        try:
            reports = [dryrun_cases(make_mesh(device=device), kwargs, None, audio, args.float32)]
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) != 0:
            return 0
    else:
        reports = dryrun_multichip(
            args.ranks,
            kwargs,
            audio,
            device=args.device,
            share_card=args.share_card,
            require_equal=args.float32,
        )
    print(json.dumps(reports[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
