"""Onset metrics of generated audio against the ground truth (the
counterpart of ``script/evaluate_onset.py``).

    python -m syncfusion_tpu_torch.evaluate_onset --gen_dir DIR --tar_dir DIR \\
        [--delta 0.1] [--multi_delta]

Both directories hold wavs, paired by name (else by sorted order); prints
one JSON line of ``detection_acc``, ``detection_ap``, ``onset_count_match``
and ``num_files``.  Host code (numpy); needs no card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from syncfusion_tpu_torch.eval.onset_metrics import evaluate_onset_dirs


def main(argv=None) -> dict:
    """Prints the metrics' JSON line and returns the unrounded metrics."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gen_dir", required=True)
    ap.add_argument("--tar_dir", required=True)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--multi_delta", action="store_true",
                    help="average over delta in arange(0.1, delta+0.05, 0.05) "
                         "(reference evaluate_onset.py:175)")
    args = ap.parse_args(argv)
    deltas = (list(np.arange(0.1, args.delta + 0.05, 0.05)) if args.multi_delta
              else None)
    metrics = evaluate_onset_dirs(args.gen_dir, args.tar_dir, delta=args.delta,
                                  deltas=deltas)
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main()
