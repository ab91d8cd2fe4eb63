"""SFX diffusion dataset: shard → resample → onset tracks → chunk slices
(a copy of ``syncfusion_tpu/data/sfx_dataset.py``: numpy, seeded, so that
the same seed gives the same batches as the JAX package).

Reproduces the reference pipeline semantics end to end
(main/dataset_diffusion.py):

  * decode ``resampled.wav`` + ``times.csv`` (+ optional ``times.pred.csv``),
    resample to the target rate (``_fn_resample:15-16``)
  * binary onset track with 1.0 at ``int(time·sr)`` sample indices
    (``_get_slices:58-72``)
  * split each track into ``chunk_size`` windows with optional random shift
    augmentation (shift ∈ [0, length mod chunk_size]), skipping chunks with
    no onset inside ``onset_check_length`` (``:77-97``)
  * optional ``cut_prefix``: zero audio before the first onset (``:104-105``)
  * conditioning chunk = audio between one uniformly-chosen onset and the
    next (``_get_cond_chunk:37-45``)
  * random label text drawn from the chunk's annotation labels, skipping
    'None' (``:59-65``)
  * ``collate``: stack wav/onsets, right-pad cond chunks (``:134-143``)

Randomness is a seeded ``np.random.Generator`` (reproducible runs — the
reference uses global ``random``/``torch`` state).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from syncfusion_tpu_torch.data.shards import (
    decode_times_csv,
    decode_wav_member,
    iter_tar_samples,
)
from syncfusion_tpu_torch.ops.resample import resample


@dataclasses.dataclass
class SfxItem:
    wav: np.ndarray          # (1, chunk_size)
    onsets: np.ndarray       # (1, chunk_size) — pred onsets if provided
    cond: np.ndarray         # (1, variable) conditioning chunk
    text: str
    filename: str


def _track_slices(
    wav: np.ndarray,
    sr: int,
    onset_metadata: dict,
    pred_onset_metadata: Optional[dict],
    filename: str,
    chunk_size: int,
    onset_check_length: int,
    rng: np.random.Generator,
    shift_augment: bool = False,
    cut_prefix: bool = True,
    one_chunk_per_track: bool = False,
) -> Iterator[SfxItem]:
    channels, length = wav.shape
    if pred_onset_metadata is None:
        pred_onset_metadata = onset_metadata

    onset_idx = [int(k * sr) for k in onset_metadata.keys()]
    texts = [t for t in onset_metadata.values() if t is not None and "None" not in t]
    # ONE label text per track, drawn before the chunk loop — every chunk of
    # a multi-chunk track shares it (reference dataset_diffusion.py:59-65).
    text = str(rng.choice(texts)) if texts else ""
    if not onset_idx:
        raise ValueError(f"track {filename} has no onsets")

    onset = np.zeros_like(wav)
    onset[:, [i for i in onset_idx if i < length]] = 1.0
    pred_idx = [int(k * sr) for k in pred_onset_metadata.keys()]
    pred_onset = np.zeros_like(wav)
    pred_onset[:, [i for i in pred_idx if i < length]] = 1.0

    if length < chunk_size:
        raise ValueError(f"track {filename} shorter than chunk")

    if shift_augment:
        max_shift = length - (length // chunk_size) * chunk_size
        shift = int(rng.integers(0, max_shift + 1))
    else:
        shift = 0

    done = False
    for i in range(length // chunk_size):
        if done and one_chunk_per_track:
            break
        start = min(length - chunk_size, i * chunk_size + shift)
        end = start + chunk_size
        wav_chunk = wav[:, start:end].copy()
        onset_chunk = onset[:, start:end]
        pred_chunk = pred_onset[:, start:end].copy()

        if not onset_chunk[:, :onset_check_length].any():
            if one_chunk_per_track:
                break
            continue

        onset_indices = np.nonzero(onset_chunk[0])[0]
        if cut_prefix:
            wav_chunk[:, : onset_indices[0]] = 0.0

        # conditioning chunk between one random onset and the next
        oi = int(rng.integers(0, len(onset_indices)))
        c_start = onset_indices[oi]
        c_end = wav_chunk.shape[1] if oi == len(onset_indices) - 1 else onset_indices[oi + 1]
        cond = wav_chunk[:, c_start:c_end]

        done = True
        yield SfxItem(
            wav=wav_chunk,
            onsets=pred_chunk,
            cond=cond,
            text=text,
            filename=filename,
        )


def create_sfx_dataset(
    path: str | Sequence[str],
    sample_rate: int,
    chunk_size: Optional[int] = None,
    shardshuffle: bool = False,
    shift_augment: bool = False,
    cut_prefix: bool = True,
    one_chunk_per_track: bool = True,
    onset_check_length: Optional[int] = None,
    seed: int = 0,
) -> Iterator[SfxItem]:
    """Stream dataset items (generator; re-call for a new epoch/seed).

    Mirrors the reference factory signature (dataset_diffusion.py:111-131).
    """
    rng = np.random.default_rng(seed)
    check = onset_check_length if onset_check_length else chunk_size
    for sample in iter_tar_samples(path, shardshuffle=shardshuffle, seed=seed):
        wav, sr = decode_wav_member(sample["resampled.wav"])
        if sr != sample_rate:
            wav = resample(wav, sr, sample_rate)
            sr = sample_rate
        onset_md = decode_times_csv(sample["times.csv"])
        pred_md = (
            decode_times_csv(sample["times.pred.csv"])
            if "times.pred.csv" in sample
            else None
        )
        if chunk_size is None:
            yield SfxItem(wav=wav, onsets=np.zeros_like(wav), cond=wav,
                          text="", filename=sample["__key__"])
            continue
        yield from _track_slices(
            wav, sr, onset_md, pred_md, sample["__key__"],
            chunk_size=chunk_size, onset_check_length=check, rng=rng,
            shift_augment=shift_augment, cut_prefix=cut_prefix,
            one_chunk_per_track=one_chunk_per_track,
        )


def collate(items: Sequence[SfxItem]) -> dict:
    """Stack into arrays; right-pad cond chunks (reference collate_fn).

    Returns the model-facing batch layout: (B, L, 1) NLC waveforms.
    """
    wav = np.stack([it.wav for it in items])        # (B, 1, L)
    onsets = np.stack([it.onsets for it in items])
    max_cond = max(it.cond.shape[1] for it in items)
    cond = np.stack(
        [np.pad(it.cond, ((0, 0), (0, max_cond - it.cond.shape[1]))) for it in items]
    )
    return {
        "wav": np.transpose(wav, (0, 2, 1)),
        "onsets": np.transpose(onsets, (0, 2, 1)),
        "cond": np.transpose(cond, (0, 2, 1)),
        "text": [it.text for it in items],
        "filename": [it.filename for it in items],
    }


def batched(
    dataset: Iterator[SfxItem],
    batch_size: int,
    drop_last: bool = False,
    shuffle_size: int = 0,
    seed: int = 0,
) -> Iterator[dict]:
    """Batch (and optionally shuffle with a reservoir of ``shuffle_size``,
    the wds ``.shuffle(200)`` equivalent — datamodule_diffusion.py:34)."""
    rng = np.random.default_rng(seed)
    buf: list[SfxItem] = []

    def drain(items):
        batch: list[SfxItem] = []
        for it in items:
            batch.append(it)
            if len(batch) == batch_size:
                yield collate(batch)
                batch = []
        if batch and not drop_last:
            yield collate(batch)

    if shuffle_size <= 0:
        yield from drain(dataset)
        return

    def shuffled():
        for it in dataset:
            buf.append(it)
            if len(buf) >= shuffle_size:
                j = int(rng.integers(0, len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    yield from drain(shuffled())
