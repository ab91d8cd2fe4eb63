"""Pack processed Greatest Hits videos into webdataset shards (the
counterpart of ``script/gh_make_shards.py``; the same tars).

    python -m syncfusion_tpu_torch.gh_make_shards \
        --root data/gh/mic-mp4-processed \
        --split data/gh/mic-mp4-processed/train.txt \
        --output "data/gh/webdataset/train_shard_%d.tar" [--shard_size 256] \
        [--pred_csv_dir LOGDIR/media/annotations/pred]

Host work only: no device is used.
"""

from __future__ import annotations

import argparse

from syncfusion_tpu_torch.data.shard_writer import write_shards


def main(argv=None) -> list[str]:
    """Write the shards; returns their paths (also printed, one a line)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--split", required=True)
    ap.add_argument("--output", required=True, help="pattern with %%d shard index")
    ap.add_argument("--shard_size", type=int, default=256)
    ap.add_argument("--pred_csv_dir", default=None)
    args = ap.parse_args(argv)
    paths = write_shards(args.root, args.split, args.output,
                         shard_size=args.shard_size,
                         pred_csv_dir=args.pred_csv_dir)
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main()
