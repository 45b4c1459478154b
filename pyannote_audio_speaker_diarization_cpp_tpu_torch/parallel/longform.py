"""Long-form diarization: the chunk axis in contiguous shards.

Ported from the JAX package's parallel/longform.py. The reference scales
only by a sequential sliding-window loop in one process, with the whole
waveform in memory (reference pipeline/src/speakerDiarizer.cpp:1419-1480).
Here the 5 s / 0.5 s chunk axis is the sequence axis, split into contiguous
shards:

  - chunk ``i`` covers samples ``[i * step, i * step + window)``, so a shard
    of chunks ``[lo, hi)`` reads only samples ``[lo * step, (hi - 1) * step
    + window)``, from a WAV file by partial reads (io/wav.py); its halo past
    its nominal span is at most ``window - step`` (4.5 s);
  - each shard runs stages 1 and 2 through the pipeline's
    ``run_chunks_device(fetch=False)``: the scores and the embeddings stay
    on the device, and the host launches up to ``max_inflight_shards``
    shards before it collects the oldest, so the device's working set is
    O(window), not O(audio);
  - the speaker-count overlap-add and the post-clustering overlap-add are
    linear in the chunks: each shard computes its parts on the device on the
    global frame grid (pipelines/diarization.py ``count_parts``,
    ``post_cluster_from_hard``), and the host adds them;
  - stage 3 runs once over the whole request. When the request is eligible
    (the default AHC recipe, no speaker bounds, one process), it runs fused
    on the device over the concatenated resident shard embeddings
    (clustering/device.py, its merge loop one launch of ``csrc/linkage.cu``
    at the train-capped size); otherwise the host fetches the embeddings
    and clusters them, and each shard's post-clustering runs on the device.

The result equals the single-shot pipeline's (tested). With a pipeline
built on a mesh (``SpeakerDiarizationPipeline(mesh=...)``), every rank runs
the shards in turn and the pipeline splits each shard's batches over the
ranks. One shard a process instead (the JAX package's one shard a host)
is taken only when the caller passes a comm over several processes
(``TorchHostComm``), each process with its own mesh-less pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..clustering import device as devclu
from ..core.annotation import Annotation
from ..io import resample as rs
from ..io import wav as wavio
from ..models.pyannet import pyannet_num_frames
from ..ops import windows as win
from ..pipelines import reconstruct as rec
from ..pipelines.diarization import (
    SpeakerDiarizationPipeline,
    _ceil_to,
    count_parts,
    finalize_embeddings,
    post_cluster,
    post_cluster_from_hard,
    precision_scope,
    to_host,
)


class LocalComm:
    """One process: the default. In the JAX package a process is a host and
    its default comm counts the hosts; in the port a process is a card, and
    a pipeline on a mesh already splits each shard's batches over the ranks,
    so the one-shard-a-process branch must not engage by itself. With one
    process nothing is gathered."""

    def process_count(self) -> int:
        return 1

    def process_index(self) -> int:
        return 0


class TorchHostComm:
    """The collective surface of the one-shard-a-process branch over a
    ``torch.distributed`` process group (the default group when None):
    ``process_count``, ``process_index`` and ``allgather`` of numpy arrays.
    On an NCCL group the arrays travel through the current CUDA device."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD

    def process_count(self) -> int:
        return dist.get_world_size(self.group)

    def process_index(self) -> int:
        return dist.get_rank(self.group)

    def allgather(self, x: np.ndarray) -> np.ndarray:
        """(local ...) -> (processes, ...) stacked over the process axis."""
        x = np.ascontiguousarray(x)
        block = torch.from_numpy(x.view(np.uint8) if x.dtype == np.bool_ else x)
        if str(dist.get_backend(self.group)) == "nccl":
            block = block.to(torch.device("cuda", torch.cuda.current_device()))
        parts = [torch.empty_like(block) for _ in range(self.process_count())]
        dist.all_gather(parts, block, group=self.group)
        out = np.stack([p.cpu().numpy() for p in parts])
        return out.view(np.bool_) if x.dtype == np.bool_ else out


@dataclasses.dataclass(frozen=True)
class ChunkShard:
    """A contiguous range of global chunk indices and the sample window
    (including the trailing halo) needed to compute them."""

    chunk_lo: int
    chunk_hi: int  # exclusive
    sample_lo: int
    sample_hi: int  # exclusive; may exceed the file (zero-padded)

    @property
    def num_chunks(self) -> int:
        return self.chunk_hi - self.chunk_lo


def plan_shards(
    num_chunks: int, num_shards: int, window_size: int, step_size: int
) -> List[ChunkShard]:
    """Split ``num_chunks`` into ``num_shards`` contiguous, near-even ranges
    (the first ``num_chunks % num_shards`` shards get one extra chunk;
    trailing shards are empty when there are more shards than chunks)."""
    base, extra = divmod(num_chunks, num_shards)
    shards = []
    lo = 0
    for s in range(num_shards):
        hi = lo + base + (1 if s < extra else 0)
        sample_hi = (hi - 1) * step_size + window_size if hi > lo else lo * step_size
        shards.append(ChunkShard(lo, hi, lo * step_size, sample_hi))
        lo = hi
    return shards


class LongFormDiarizer:
    """Chunk-sharded wrapper around a SpeakerDiarizationPipeline.

    ``num_shards`` defaults to the comm's process count: one shard in a
    single process. In one process the shards run in turn, the
    bounded-memory long-form mode. ``comm``: None (one process), or a comm
    over several processes (``TorchHostComm``) for one shard a process, each
    process with its own pipeline on its own device. ``max_inflight_shards``:
    how many shards are launched ahead of the oldest one's collect (its
    small count grids; on the host route also its embeddings) — the
    host's fetches overlap later shards' device work, and the device holds
    O(max_inflight_shards) shards' working sets.

    ``host_waits`` counts the host's waits for the device in the last call:
    one collect a shard, then one for stage 3's result (and one more when
    the fused stage 3 falls back to the host clusterer).
    """

    # padded embedding rows the fused device stage 3 accepts (~4.7 h of
    # audio; the merge loop is train-cap-bounded, this sizes only the
    # O(rows) selection and assignment buffers)
    _DEVICE_CLU_MAX_ROWS = 65536

    def __init__(
        self,
        pipeline: SpeakerDiarizationPipeline,
        num_shards: Optional[int] = None,
        comm=None,
        max_inflight_shards: int = 3,
    ):
        self.pipeline = pipeline
        self.comm = comm if comm is not None else LocalComm()
        self._multihost = self.comm.process_count() > 1
        if self._multihost and pipeline.mesh is not None:
            raise ValueError(
                "one shard a process takes a mesh-less pipeline in each process; "
                "a pipeline on a mesh runs the shards in turn (comm=None)"
            )
        if num_shards is None:
            num_shards = self.comm.process_count()
        if self._multihost and num_shards != self.comm.process_count():
            raise ValueError(
                "multi-process runs need exactly one shard per process "
                f"(num_shards={num_shards}, processes={self.comm.process_count()})"
            )
        self.num_shards = num_shards
        self.max_inflight_shards = max(1, max_inflight_shards)
        self.host_waits = 0

    def _device_clu_eligible(
        self, total_rows: int, num_speakers, min_speakers, max_speakers
    ) -> bool:
        """Fused device stage 3 for the whole request: one process (the
        one-shard-a-process branch gathers the embeddings on the host
        anyway), the pipeline's device clustering enabled, a merge loop the
        device takes, at most ``_DEVICE_CLU_MAX_ROWS`` rows, no speaker
        bounds."""
        p = self.pipeline
        if self._multihost:
            return False
        key = p._device_clu_key()
        if key is None:
            return False
        if p._device_train_size(total_rows, key[3]) > p._UNCAPPED_DEVICE_ROWS:
            return False
        if total_rows > self._DEVICE_CLU_MAX_ROWS:
            return False
        return p._no_speaker_bounds(num_speakers, min_speakers, max_speakers)

    def _fetch(self, *tensors: torch.Tensor):
        """Device tensors -> numpy, one host wait for all of them."""
        self.host_waits += 1
        return to_host(*tensors)

    # ------------------------------------------------------------------

    def _load_shard(self, audio, shard: ChunkShard) -> np.ndarray:
        """Waveform slice [sample_lo, sample_hi), zero-padded to full length."""
        out = np.zeros(shard.sample_hi - shard.sample_lo, dtype=np.float32)
        if isinstance(audio, str):
            data = wavio.read_wav(
                audio,
                start_frame=shard.sample_lo,
                max_frames=shard.sample_hi - shard.sample_lo,
            )
            piece = data.normalized_mono()
        else:
            piece = audio[shard.sample_lo : shard.sample_hi]
        out[: piece.shape[0]] = piece
        return out

    def _gather(self, local, counts: List[int]):
        """Allgather per-process arrays of uneven length (``counts`` rows
        each): pad the leading axis to the largest, gather over the
        processes, drop the padding rows."""
        padded = np.zeros((max(counts),) + local.shape[1:], dtype=local.dtype)
        padded[: local.shape[0]] = local
        gathered = self.comm.allgather(padded)
        return np.concatenate([gathered[h, :n] for h, n in enumerate(counts)], axis=0)

    # ------------------------------------------------------------------

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        sample_rate: Optional[int] = None,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
    ) -> Annotation:
        p = self.pipeline
        seg_cfg = p.config.segmentation
        sr = seg_cfg.sample_rate
        self.host_waits = 0

        if isinstance(audio, str):
            info = wavio.wav_info(audio)
            if info.sample_rate != sr:
                # resampling is stateful across slice boundaries: a file at
                # another rate is read whole
                data = wavio.read_wav(audio)
                audio = rs.resample(data.normalized_mono(), data.sample_rate, sr).astype(
                    np.float32
                )
                num_samples = audio.shape[0]
            else:
                num_samples = info.num_frames
        else:
            audio = np.asarray(audio, dtype=np.float32)
            if audio.ndim == 2:
                audio = rs.downmix(audio)
            if sample_rate is not None and sample_rate != sr:
                audio = rs.resample(audio, sample_rate, sr)
            num_samples = audio.shape[0]

        num_chunks = win.chunk_count(num_samples, seg_cfg.window_size, seg_cfg.step_size)
        shards = plan_shards(num_chunks, self.num_shards, seg_cfg.window_size, seg_cfg.step_size)

        # the global orphan chunk (the short tail) is in the last non-empty shard
        orphan_samples = num_samples - (num_chunks - 1) * seg_cfg.step_size
        orphan_frames = None
        if orphan_samples < seg_cfg.window_size:
            orphan_frames = max(pyannet_num_frames(orphan_samples, p.pyannet_cfg), 0)

        with precision_scope(p.precision), torch.inference_mode():
            return self._run_device_resident(
                audio,
                shards,
                num_chunks,
                num_samples,
                orphan_frames,
                orphan_samples,
                num_speakers,
                min_speakers,
                max_speakers,
            )

    # ------------------------------------------------------------------

    def _run_device_resident(
        self,
        audio,
        shards: List[ChunkShard],
        num_chunks: int,
        num_samples: int,
        orphan_frames,
        orphan_samples,
        num_speakers,
        min_speakers,
        max_speakers,
    ) -> Annotation:
        """Each shard's score tensors stay on the device; the host receives
        its two count grids (and, on the host route, its embeddings). The
        count and activation grids are linear in the chunks, so per-shard
        grids on globally consistent start frames stitch by addition (a sum
        over processes in the one-shard-a-process branch)."""
        p = self.pipeline
        cfg = p.config
        seg_cfg = cfg.segmentation
        F = seg_cfg.num_frames
        S = seg_cfg.num_speakers
        left = math.floor(F * seg_cfg.warm_up[0])
        right = math.floor(F * seg_cfg.warm_up[1])
        tspan = F - left - right

        if self._multihost:
            local_shards = [shards[self.comm.process_index()]]
        else:
            local_shards = [s for s in shards if s.num_chunks]

        count_plan = p._count_plan(num_chunks)
        dia_plan = p._diarization_plan(num_chunks)
        num_acc = np.zeros(count_plan.num_frames, np.float64)
        den_acc = np.zeros(count_plan.num_frames, np.float64)

        total_rows = sum(p.chunk_lattice(s.num_chunks) * S for s in local_shards if s.num_chunks)
        use_devclu = self._device_clu_eligible(
            total_rows, num_speakers, min_speakers, max_speakers
        )

        embs, inacts, resident = [], [], []
        # the fused stage 3's inputs (and its fallback's), still on the device
        emb_handles = []

        def collect_one(item):
            """One fetch a shard, in launch order: it overlaps the device
            work of the shards launched after it."""
            shard, segs, valid, emb, too_short, inact, n_dev, d_dev, gofs, local_n = item
            if use_devclu:
                n_h, d_h = self._fetch(n_dev, d_dev)
                emb_handles.append((shard, emb, too_short, inact))
            else:
                emb_h, ts_h, inact_h, n_h, d_h = self._fetch(emb, too_short, inact, n_dev, d_dev)
                embs.append(finalize_embeddings(emb_h, ts_h, shard.num_chunks, S))
                inacts.append(inact_h[: shard.num_chunks])
            take = min(local_n, count_plan.num_frames - gofs)
            num_acc[gofs : gofs + take] += n_h[:take]
            den_acc[gofs : gofs + take] += d_h[:take]
            resident.append((shard, segs, valid))

        # launch up to max_inflight_shards shards ahead of the oldest
        # one's collect
        pending = []
        for shard in local_shards:
            if shard.num_chunks == 0:
                continue  # an empty shard (more processes than chunks) still
                # joins every collective below, with nothing to add
            is_last = shard.chunk_hi == num_chunks
            segs, binarized, valid, emb, too_short, inact = p.run_chunks_device(
                self._load_shard(audio, shard),
                shard.num_chunks,
                orphan_frames if is_last else None,
                orphan_samples if is_last else None,
                fetch=False,
            )
            lo, hi = shard.chunk_lo, shard.chunk_hi
            gofs = int(count_plan.start_frames[lo])
            cstart = count_plan.start_frames[lo:hi] - gofs
            local_n = _ceil_to(int(cstart[-1]) + tspan, 512)
            cstart_pad = np.zeros(valid.shape[0], np.int32)
            cstart_pad[: hi - lo] = cstart
            n_dev, d_dev = count_parts(
                binarized,
                p._to_device(valid),
                p._to_device(cstart_pad),
                local_n,
                left,
                right,
            )
            pending.append(
                (shard, segs, valid, emb, too_short, inact, n_dev, d_dev, gofs, local_n)
            )
            if len(pending) >= self.max_inflight_shards:
                collect_one(pending.pop(0))
        for item in pending:
            collect_one(item)

        if use_devclu:
            # the fused global stage 3 over the concatenated resident shard
            # embeddings, and every shard's post-clustering from its
            # labels, launched before the one wait for num_large and the
            # activations
            threshold, mcs, k_max, cap = p._device_clu_key()
            res = devclu.device_cluster(
                torch.cat([e.to(torch.float32) for _, e, _, _ in emb_handles]),
                ~torch.cat([t for _, _, t, _ in emb_handles]),
                torch.cat([i.reshape(-1) for _, _, _, i in emb_handles]),
                threshold,
                mcs,
                k_max,
                train_cap=cap,
            )
            acts = self._post_from_hard(p, resident, res.hard, dia_plan, F, p.k_max)
            num_large_h, *acts_h = self._fetch(res.num_large, *(a for a, _, _ in acts))
            num_clusters = int(num_large_h)
            if 1 <= num_clusters <= p.k_max:
                activations = self._stitch(acts_h, acts, dia_plan, p.k_max)
                return self._decode(
                    p, activations, num_clusters, num_acc, den_acc, count_plan, dia_plan,
                    num_samples,
                )
            # no cluster, or more than k_max: the host route below, from the
            # still resident embeddings (one more fetch)
            fetched = self._fetch(*(t for _, *handles in emb_handles for t in handles))
            for i, (shard, *_) in enumerate(emb_handles):
                emb_h, ts_h, inact_h = fetched[3 * i : 3 * i + 3]
                embs.append(finalize_embeddings(emb_h, ts_h, shard.num_chunks, S))
                inacts.append(inact_h[: shard.num_chunks])

        D = p.ecapa_cfg.emb_dim
        if embs:
            local_emb = np.concatenate(embs, axis=0)
            local_inact = np.concatenate(inacts, axis=0)
        else:
            local_emb = np.zeros((0, S, D), np.float64)
            local_inact = np.zeros((0, S), bool)

        if self._multihost:
            # what crosses processes: the embeddings and the two count grids
            counts = [s.num_chunks for s in shards]
            embeddings = self._gather(local_emb, counts)
            inactive = self._gather(local_inact, counts)
            num_acc = self.comm.allgather(num_acc).sum(axis=0)
            den_acc = self.comm.allgather(den_acc).sum(axis=0)
        else:
            embeddings = local_emb
            inactive = local_inact

        # global clustering, the same on every process
        hard, _soft = p.clusterer(
            embeddings,
            num_clusters=num_speakers or cfg.num_speakers,
            min_clusters=min_speakers or cfg.min_speakers,
            max_clusters=max_speakers or cfg.max_speakers,
        )
        hard = np.asarray(hard)
        hard[inactive] = -2  # speakerDiarizer.cpp:3166-3191
        num_clusters = max(int(hard.max()) + 1, 1)
        k_pad = _ceil_to(num_clusters, 4)

        # each shard's post-clustering on its resident scores
        acts = []
        for shard, segs, valid in resident:
            lo, hi = shard.chunk_lo, shard.chunk_hi
            gofs, dstart_pad, local_n = self._dia_range(dia_plan, shard, valid.shape[0], F)
            membership = np.zeros((valid.shape[0], S, k_pad), bool)
            h = hard[lo:hi]
            ci, si = np.nonzero(h >= 0)
            membership[ci, si, h[ci, si]] = True
            acts.append(
                (
                    post_cluster(
                        segs, p._to_device(membership), p._to_device(dstart_pad), local_n
                    ),
                    gofs,
                    local_n,
                )
            )
        acts_h = self._fetch(*(a for a, _, _ in acts)) if acts else []
        activations = self._stitch(acts_h, acts, dia_plan, k_pad)
        if self._multihost:
            activations = self.comm.allgather(activations).sum(axis=0)

        return self._decode(
            p, activations, num_clusters, num_acc, den_acc, count_plan, dia_plan, num_samples
        )

    # ------------------------------------------------------------------

    @staticmethod
    def _dia_range(dia_plan, shard: ChunkShard, num_padded: int, F: int):
        """(global offset, padded local start frames, local grid length) of
        a shard's post-clustering overlap-add."""
        lo, hi = shard.chunk_lo, shard.chunk_hi
        gofs = int(dia_plan.start_frames[lo])
        dstart = dia_plan.start_frames[lo:hi] - gofs
        dstart_pad = np.zeros(num_padded, np.int32)
        dstart_pad[: hi - lo] = dstart
        return gofs, dstart_pad, _ceil_to(int(dstart[-1]) + F, 512)

    @staticmethod
    def _stitch(acts_h, acts, dia_plan, width: int) -> np.ndarray:
        """Per-shard activation grids -> the global grid, by addition in
        float64."""
        activations = np.zeros((dia_plan.num_frames, width), np.float64)
        for act, (_, gofs, local_n) in zip(acts_h, acts):
            take = min(local_n, dia_plan.num_frames - gofs)
            activations[gofs : gofs + take] += act[:take]
        return activations

    @classmethod
    def _post_from_hard(cls, p, resident, hard_dev, dia_plan, F, k_max):
        """Every shard's post-clustering from the device-resident global hard
        labels, launched without a wait: [(activations on the device,
        global offset, local grid length)]."""
        S = p.config.segmentation.num_speakers
        acts = []
        ofs = 0
        for shard, segs, valid in resident:
            gofs, dstart_pad, local_n = cls._dia_range(dia_plan, shard, valid.shape[0], F)
            act = post_cluster_from_hard(
                segs, hard_dev, ofs, p._to_device(dstart_pad), local_n, k_max
            )
            acts.append((act, gofs, local_n))
            ofs += valid.shape[0] * S
        return acts

    @staticmethod
    def _decode(
        p, activations, num_clusters, num_acc, den_acc, count_plan, dia_plan, num_samples
    ) -> Annotation:
        """Stitched count grids -> per-frame count, top-count binarization,
        hysteresis and support timeline."""
        cfg = p.config
        seg_cfg = cfg.segmentation
        eps = float(np.finfo(np.float64).eps)
        count_data = np.where(den_acc == 0.0, 0.0, num_acc / np.maximum(den_acc, eps))
        count = np.rint(count_data).astype(np.int64)
        count_frames = dataclasses.replace(count_plan.frames, num_samples=num_samples)
        binary, binary_frames = rec.binarize_by_count(
            activations[:, :num_clusters].astype(np.float32),
            dia_plan.frames,
            count,
            count_frames,
        )
        return rec.to_annotation(
            binary,
            binary_frames,
            onset=cfg.clustering.binarize_onset,
            offset=cfg.clustering.binarize_offset,
            min_duration_on=seg_cfg.min_duration_on,
            min_duration_off=seg_cfg.min_duration_off,
        )
