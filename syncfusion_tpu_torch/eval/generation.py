"""Test-set generation and GT preparation, the reference's evaluation entry
points (port of ``syncfusion_tpu/eval/generation.py``).

``generate_dataset`` mirrors main/generation.py:11-123: iterate the test
stream, draw each batch's noise, embed its conditioning audio (or text),
sample with ``SyncFusionDiffusion.sample``, optionally zero the
pre-first-onset prefix, crop to ``cut_length``, resample on the host and
write wavs, with the same skip-if-exists resume.  ``prepare_gt_for_fad``
mirrors dataset_diffusion.py:146-197.

Batch ``i``'s noise depends on ``(seed, i)`` alone (``batch_noise``), as the
JAX package's ``fold_in(key(seed), i)``, so a resumed run draws the same
noise for the batches it still has to make.  A ragged last batch samples
its valid rows only, on the first rows of its batch's noise: rows are
independent (GroupNorm is per sample), so they are the rows the JAX package
computes in its padded batch.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from syncfusion_tpu_torch.data.sfx_dataset import SfxItem, collate
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.ops.wav import write_wav

log = logging.getLogger(__name__)

EmbedAudioFn = Callable[[np.ndarray], torch.Tensor]  # (B, L, 1) -> (B, 1, E)
EmbedTextFn = Callable[[list[str]], torch.Tensor]    # [str] -> (B, 1, E)


def _batches(dataset: Iterable[SfxItem], batch_size: int) -> Iterator[dict]:
    buf: list[SfxItem] = []
    for item in dataset:
        buf.append(item)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf:
        yield collate(buf)


def batch_noise(seed: int, batch_idx: int, shape: tuple, device) -> torch.Tensor:
    """Batch ``batch_idx``'s standard normal noise of ``shape`` on
    ``device``, from a generator seeded by ``(seed, batch_idx)`` alone."""
    state = np.random.SeedSequence([seed, batch_idx]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(state))
    return torch.randn(shape, generator=gen, device=device)


def generate_dataset(
    experiment_path: str | Path,
    model,
    dataset: Iterable[SfxItem],
    embed_audio: Optional[EmbedAudioFn] = None,
    embed_text: Optional[EmbedTextFn] = None,
    batch_size: int = 16,
    sample_rate: int = 48000,
    num_steps: int = 150,
    length: int = 2**18,
    embedding_scale: float = 7.5,
    guidance_interval=None,
    sampler: str = "ddim",
    deep_cache_interval: int = 0,
    deep_split: int = 4,
    deep_cache_pow: float = 1.0,
    cut_prefix: bool = False,
    cond_text: bool = False,
    one_chunk_per_track: bool = False,
    cut_length: Optional[int] = None,
    downsample_rate: Optional[int] = None,
    save_cond: bool = False,
    seed: int = 0,
) -> dict:
    """Writes the clips of ``dataset`` generated by ``model`` (a
    ``SyncFusionDiffusion`` on its device) into ``experiment_path``.
    Returns ``{"clips", "generation_s", "post_s"}``: the clips made (not
    skipped), the seconds of noise, embedding and sampling up to the
    clips' copy to the host, and the seconds of post-processing (resample
    and write)."""
    cut_length = cut_length or length
    experiment_path = Path(experiment_path)
    experiment_path.mkdir(exist_ok=True, parents=True)
    device = next(model.parameters()).device
    emb_features = model.unet.cfg.embedding_features
    chunk_id = 0
    stats = {"clips": 0, "generation_s": 0.0, "post_s": 0.0}
    for batch_idx, batch in enumerate(_batches(dataset, batch_size)):
        n_valid = batch["wav"].shape[0]
        filenames = batch["filename"]

        # -------- resume: skip batches whose outputs already exist --------
        if not one_chunk_per_track:
            last_path = experiment_path / f"{chunk_id + n_valid - 1}.wav"
            if last_path.exists():
                log.info("Skipping batch ending at %s", last_path)
                chunk_id += n_valid
                continue
        else:
            last_name = filenames[-1].split("/")[-1]
            if (experiment_path / f"{last_name}.wav").exists():
                log.info("Skipping existing %s", last_name)
                continue

        t0 = time.perf_counter()
        if cond_text and embed_text is not None:
            embedding = embed_text(list(batch["text"]))
        elif embed_audio is not None:
            embedding = embed_audio(batch["cond"])
        else:
            embedding = torch.zeros((n_valid, 1, emb_features))
        noise = batch_noise(seed, batch_idx, (batch_size, length, 1), device)[:n_valid]
        gen = model.sample(
            noise, torch.from_numpy(batch["onsets"]).to(device),
            torch.as_tensor(embedding, device=device).float(),
            num_steps=num_steps, embedding_scale=embedding_scale,
            guidance_interval=tuple(guidance_interval) if guidance_interval else None,
            sampler=sampler, deep_cache_interval=deep_cache_interval,
            deep_split=deep_split, deep_cache_pow=deep_cache_pow,
        )[:, :, 0].float().cpu().numpy()
        t1 = time.perf_counter()

        # -------- post-process + save --------------------------------------
        for i in range(n_valid):
            out = gen[i]
            if cut_prefix:
                nz = np.nonzero(batch["onsets"][i, :, 0])[0]
                if nz.size:
                    out = out.copy()
                    out[: nz[0]] = 0.0
            out = out[:cut_length]
            out_sr = sample_rate
            cond_wav = batch["cond"][i, :, 0]
            if downsample_rate:
                out = resample(out, sample_rate, downsample_rate)
                cond_wav = resample(cond_wav, sample_rate, downsample_rate)
                out_sr = downsample_rate

            if one_chunk_per_track:
                stem = filenames[i].split("/")[-1]
            else:
                stem = str(chunk_id)
                chunk_id += 1
            if save_cond and cond_text:
                stem = f"{stem}_{batch['text'][i]}"
            write_wav(experiment_path / f"{stem}.wav", out, out_sr)
            if save_cond and not cond_text:
                write_wav(experiment_path / f"{stem}_cond.wav", cond_wav, out_sr)
        stats["clips"] += n_valid
        stats["generation_s"] += t1 - t0
        stats["post_s"] += time.perf_counter() - t1
        elapsed = stats["generation_s"] + stats["post_s"]
        log.info(
            "generated batch %d (%d clips): %.1f clips/min (%.1f 8s-clips/min)",
            batch_idx, n_valid, stats["clips"] / elapsed * 60.0,
            stats["clips"] * (length / sample_rate / 8.0) / elapsed * 60.0,
        )
    return stats


def prepare_gt_for_fad(
    experiment_path: str | Path,
    dataset: Iterable[SfxItem],
    batch_size: int = 16,
    sample_rate: int = 48000,
    one_chunk_per_track: bool = False,
    downsample_rate: Optional[int] = None,
) -> None:
    """Dump ground-truth chunks as wavs for FAD scoring
    (reference dataset_diffusion.py:146-197)."""
    experiment_path = Path(experiment_path)
    experiment_path.mkdir(exist_ok=True, parents=True)
    chunk_id = 0
    for batch in _batches(dataset, batch_size):
        wavs = batch["wav"][:, :, 0]
        for i in range(wavs.shape[0]):
            out, out_sr = wavs[i], sample_rate
            if downsample_rate:
                out = resample(out, sample_rate, downsample_rate)
                out_sr = downsample_rate
            if one_chunk_per_track:
                stem = batch["filename"][i].split("/")[-1]
            else:
                stem = str(chunk_id)
                chunk_id += 1
            path = experiment_path / f"{stem}.wav"
            if path.exists():
                continue
            write_wav(path, out, out_sr)
