"""Onset metrics on generated audio: NMS + greedy matching vs ground truth
(a copy of ``syncfusion_tpu/eval/onset_metrics.py``, numpy).

Behavioral port of the reference's evaluation protocol
(script/evaluate_onset.py:35-93): amplitude-confidence NMS within 50 ms,
greedy GT→prediction matching within ``delta`` seconds (highest-confidence
candidate wins, each prediction used once), detection accuracy = matched
fraction of GT onsets, AP over matched/unmatched labels with amplitude
confidences, and "#onsets accuracy" = fraction of files where the
NMS-survivor count equals the GT onset count (evaluate_onset.py:150-163).
AP is ``average_precision``, scikit-learn's ``average_precision_score`` in
numpy: the card's machine has no scikit-learn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from syncfusion_tpu_torch.eval.onset_detect import SR, onset_detect
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.ops.wav import read_wav

CONF_INTERVAL = int(0.05 * SR)


def average_precision(target, score) -> float:
    """scikit-learn's ``average_precision_score`` for binary labels:
    sum over the distinct scores, in decreasing order, of (recall gained)
    times the precision there; tied scores form one threshold."""
    score = np.asarray(score)
    order = np.argsort(score, kind="mergesort")[::-1]
    score, target = score[order], np.asarray(target, np.float64)[order]
    last = np.r_[np.flatnonzero(np.diff(score)), score.size - 1]
    tps = np.cumsum(target)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _confidence(wav_abs: np.ndarray, o: int) -> float:
    lo, hi = max(0, o - CONF_INTERVAL), o + CONF_INTERVAL
    seg = wav_abs[lo:hi]
    return float(seg.max()) if seg.size else 0.0


def onset_nms(
    onsets: np.ndarray, confidence: Sequence[float], window: float = 0.05, sr: int = SR
) -> np.ndarray:
    """Keep highest-confidence onsets, suppressing neighbours within
    ``window`` seconds (reference onset_nms:35-48)."""
    remain = list(onsets.tolist())
    out = []
    for idx in np.argsort(np.asarray(confidence))[::-1]:
        cur = int(onsets[idx])
        if cur not in remain:
            continue
        out.append(cur)
        remain.remove(cur)
        remain = [o for o in remain if abs(cur - o) >= window * sr]
    return np.asarray(sorted(out), int)


def match_onsets(
    gt_onsets: np.ndarray,
    pred_onsets: np.ndarray,
    pred_wav: np.ndarray,
    delta: float = 0.1,
    sr: int = SR,
) -> dict:
    """Greedy matching of GT onsets to NMS'd predictions.

    Returns detection accuracy, AP inputs (y_true, y_score), and whether the
    NMS-survivor count equals the GT count.
    """
    wav_abs = np.abs(pred_wav)
    rng = wav_abs.max() - wav_abs.min()
    if rng > 0:
        wav_abs = (wav_abs - wav_abs.min()) / rng

    conf = [_confidence(wav_abs, o) for o in pred_onsets]
    kept = onset_nms(pred_onsets, conf, sr=sr)
    # count-match is on RAW detections, before NMS (evaluate_onset.py:173)
    raw_count_match = len(pred_onsets) == len(gt_onsets)

    on_use = list(kept.tolist())
    hit = 0
    y_true: list[int] = []
    y_score: list[float] = []
    for o in gt_onsets:
        in_window = [i for i, p in enumerate(on_use) if abs(p - o) < delta * sr]
        if not in_window:
            y_true.append(1)
            y_score.append(0.0)
            continue
        confs = [wav_abs[on_use[i]] for i in in_window]
        best = in_window[int(np.argmax(confs))]
        hit += 1
        y_true.append(1)
        y_score.append(_confidence(wav_abs, on_use[best]))
        on_use.pop(best)
        if not on_use:
            # remaining GT onsets unmatched
            for _ in range(len(gt_onsets) - len(y_true)):
                y_true.append(1)
                y_score.append(0.0)
            break
    for p in on_use:  # unmatched predictions = false positives
        y_true.append(0)
        y_score.append(_confidence(wav_abs, p))

    acc = hit / len(gt_onsets) if len(gt_onsets) else 0.0
    return {
        "acc": acc,
        "y_true": y_true,
        "y_score": y_score,
        "count_match": raw_count_match,
    }


def score_onset_pairs(
    pairs: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray]],
    deltas: Sequence[float],
    empty_count_match_when_equal: bool = False,
) -> dict[str, float]:
    """Aggregate Acc / pooled AP / #onset-match over precomputed
    ``(gen_wav, gen_onsets, gt_onsets)`` pairs, averaged over the match
    windows ``deltas`` (--multi_delta).  Onset detection happens ONCE per
    file in the caller — only the matching depends on delta.

    Zero-onset pairs score acc 0; their count-match is False for the
    diffusion protocol (reference evaluate_onset.py:165-168) but raw length
    equality for the baseline protocol, whose reference counts cnt_match
    BEFORE any skip (evaluate_onset_baseline.py:193)."""
    accs, aps, matches = [], [], []
    for d in deltas:
        y_true_all: list[int] = []
        y_score_all: list[float] = []
        file_accs, file_matches = [], []
        for g_wav, g_on, t_on in pairs:
            if len(t_on) == 0 or len(g_on) == 0:
                file_accs.append(0.0)
                file_matches.append(
                    len(t_on) == len(g_on) if empty_count_match_when_equal
                    else False
                )
                continue
            res = match_onsets(t_on, g_on, g_wav, delta=d)
            file_accs.append(res["acc"])
            file_matches.append(res["count_match"])
            y_true_all += res["y_true"]
            y_score_all += res["y_score"]
        accs.append(float(np.mean(file_accs)) if file_accs else 0.0)
        matches.append(float(np.mean(file_matches)) if file_matches else 0.0)
        if len(set(y_true_all)) > 1:
            aps.append(average_precision(y_true_all, y_score_all))
        elif y_true_all:
            aps.append(float(np.mean(y_true_all)))

    return {
        "detection_acc": float(np.mean(accs)),
        "detection_ap": float(np.mean(aps)) if aps else float("nan"),
        "onset_count_match": float(np.mean(matches)),
        "num_files": float(len(pairs)),
    }


def evaluate_onset_dirs(
    gen_dir: str | Path,
    tar_dir: str | Path,
    delta: float = 0.1,
    deltas: Optional[Sequence[float]] = None,
) -> dict[str, float]:
    """Directory-level protocol: detect onsets in every wav of both dirs
    (paired by sorted order), aggregate Acc / AP / #onset-match rate.
    ``deltas`` averages over multiple match windows (--multi_delta)."""
    def load_all(d):
        out = {}
        for p in sorted(Path(d).glob("*.wav")):
            wav, sr = read_wav(p)
            y = wav.mean(axis=0)
            if sr != SR:
                y = resample(y, sr, SR)
            out[p.name] = (y, onset_detect(y, SR, delta=0.3))
        return out

    gen = load_all(gen_dir)
    tar = load_all(tar_dir)
    names = sorted(set(gen) & set(tar)) or list(zip(sorted(gen), sorted(tar)))

    pairs = []
    for entry in names:
        gname, tname = (entry, entry) if isinstance(entry, str) else entry
        g_wav, g_on = gen[gname]
        _, t_on = tar[tname]
        pairs.append((g_wav, g_on, t_on))
    return score_onset_pairs(pairs, list(deltas) if deltas else [delta])
