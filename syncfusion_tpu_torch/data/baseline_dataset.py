"""CondFoleyGen baseline datasets on the processed Greatest Hits layout
(port of ``syncfusion_tpu/data/baseline_dataset.py``).

  * ``GreatestHitsWaveDataset``: one item per annotated onset, a 2-s
    22.05 kHz audio chunk starting at the onset time, with an optional
    random shift of ±0.5 s (clamped to [0, duration - 2]); mono, zero-padded
    to the chunk's length.
  * ``CondGreatestHitsWaveCondOnImage``: also the 30 ref frames, and a
    conditioning onset chunk from the same video or, with probability
    ``p_outside_cond``, from another one; the frames stacked cond + ref as
    (2T, H, W, 3).

Host code: numpy, with the same seeded ``np.random`` draws as the JAX
package, so the same seed gives the same items.  Frames are channels-last
float32, audio (T,) float32.  PIL decodes and resizes inside functions.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from syncfusion_tpu_torch.data.onset_dataset import decode_frames
from syncfusion_tpu_torch.data.transforms import center_crop, normalize, resize
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.ops.wav import read_wav


def _load_audio_chunk(path, sample_rate, offset_s, duration_s) -> np.ndarray:
    wav, sr = read_wav(path)
    y = wav.mean(axis=0)
    if sr != sample_rate:
        y = resample(y, sr, sample_rate)
    start = int(offset_s * sample_rate)
    target = int(duration_s * sample_rate)
    chunk = y[start:start + target]
    if chunk.shape[0] < target:
        chunk = np.pad(chunk, (0, target - chunk.shape[0]))
    return chunk.astype(np.float32)


class GreatestHitsWaveDataset:
    def __init__(self, root_dir: str, split_file_path: str, data_to_use: float = 1.0,
                 chunk_length_in_seconds: float = 2.0, sample_rate: int = 22050,
                 rand_shift: bool = True, rand_shift_range=(-0.5, 0.5),
                 audio_file_suffix: str = ".resampled.wav",
                 annotations_file_suffix: str = ".times.csv",
                 metadata_file_suffix: str = ".metadata.json", seed: int = 0):
        self.root = Path(root_dir)
        self.chunk_s = chunk_length_in_seconds
        self.sample_rate = sample_rate
        self.rand_shift = rand_shift
        self.shift_range = rand_shift_range
        self.audio_suffix = audio_file_suffix
        self.rng = np.random.default_rng(seed)

        samples = Path(split_file_path).read_text().splitlines()
        if data_to_use < 1.0:
            self.rng.shuffle(samples)
            samples = sorted(samples[:int(len(samples) * data_to_use)])
        self.list_samples = samples

        self.list_onsets: list[tuple[str, float, float]] = []
        self.dict_video_onsets: dict[str, list[int]] = {}
        self.video_fps: dict[str, float] = {}
        for sample in samples:
            ann = self.root / sample / f"{sample}{annotations_file_suffix}"
            meta = json.loads(
                (self.root / sample / f"{sample}{metadata_file_suffix}").read_text())
            duration = meta["processed"]["video_duration"]
            self.video_fps[sample] = meta["processed"]["video_frame_rate"]
            for line in ann.read_text().splitlines():
                if not line.strip():
                    continue
                t = float(line.split(",")[0])
                self.dict_video_onsets.setdefault(sample, []).append(len(self.list_onsets))
                self.list_onsets.append((sample, t, duration))

    def __len__(self) -> int:
        return len(self.list_onsets)

    def _chunk_start(self, onset_time: float, duration: float) -> float:
        start = onset_time
        if self.rand_shift:
            start = max(start + self.rng.uniform(*self.shift_range), 0.0)
        return min(start, duration - self.chunk_s)

    def _audio(self, sample: str, start: float) -> np.ndarray:
        path = self.root / sample / "audio" / f"{sample}{self.audio_suffix}"
        return _load_audio_chunk(path, self.sample_rate, start, self.chunk_s)

    def __getitem__(self, idx: int) -> dict:
        sample, onset_time, duration = self.list_onsets[idx]
        audio = self._audio(sample, self._chunk_start(onset_time, duration))
        return {"image": audio, "file_path_wav_": str(self.root / sample)}

    def print(self) -> None:
        print(f"GreatestHitsWave: {len(self.list_samples)} videos, "
              f"{len(self.list_onsets)} onsets")


class CondGreatestHitsWaveCondOnImage(GreatestHitsWaveDataset):
    def __init__(self, *args, p_outside_cond: float = 0.0,
                 frame_file_suffix: str = ".jpg", frame_size: int = 112, **kwargs):
        super().__init__(*args, **kwargs)
        self.p_outside_cond = p_outside_cond
        self.frame_file_suffix = frame_file_suffix
        self.frame_size = frame_size

    def _frames(self, sample: str, start_time: float) -> np.ndarray:
        """The chunk's frames: Resize(128/112 · size), CenterCrop(size),
        ImageNet Normalize."""
        fps = self.video_fps[sample]
        frames_dir = self.root / sample / "frames"
        frames = decode_frames(
            frames_dir / f"{sample}.frame_{i + 1:06d}{self.frame_file_suffix}"
            for i in range(int(start_time * fps), int((start_time + self.chunk_s) * fps)))
        frames = resize(frames, round(self.frame_size * 128 / 112))
        return normalize(center_crop(frames, self.frame_size)).astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        sample, onset_time, duration = self.list_onsets[idx]
        start = self._chunk_start(onset_time, duration)
        audio = self._audio(sample, start)
        frames = self._frames(sample, start)

        # the conditioning chunk: another video with probability
        # p_outside_cond, else another onset of the same video
        if self.rng.random() < self.p_outside_cond:
            cond_idx = idx
            while self.list_onsets[cond_idx][0] == sample:
                cond_idx = int(self.rng.integers(0, len(self)))
        else:
            candidates = [i for i in self.dict_video_onsets[sample] if i != idx]
            cond_idx = int(self.rng.choice(candidates)) if candidates else idx
        cond_sample, cond_onset, cond_dur = self.list_onsets[cond_idx]
        cond_start = self._chunk_start(cond_onset, cond_dur)
        cond_audio = self._audio(cond_sample, cond_start)
        cond_frames = self._frames(cond_sample, cond_start)

        return {
            "image": audio,
            "cond_image": cond_audio,
            "feature": np.concatenate([cond_frames, frames], axis=0),
            "file_path_wav_": str(self.root / sample),
            "file_path_cond_wav_": str(self.root / cond_sample),
            # each chunk's first frame and its video's frame rate: the
            # generation entry point muxes its videos from them
            "start_frame_": int(start * self.video_fps[sample]),
            "cond_start_frame_": int(cond_start * self.video_fps[cond_sample]),
            "frame_rate_": float(self.video_fps[sample]),
            "cond_frame_rate_": float(self.video_fps[cond_sample]),
        }


def baseline_loader(dataset, batch_size: int, shuffle: bool = False,
                    drop_last: bool = False, seed: int = 0):
    """Batches of the baseline datasets: arrays stacked, the rest listed."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for s in range(0, len(order), batch_size):
        idx = order[s:s + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        items = [dataset[int(i)] for i in idx]
        out = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        yield out
