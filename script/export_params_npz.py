#!/usr/bin/env python
"""Export the parameters of a JAX checkpoint as one ``.npz``, the tree the
PyTorch port reads with ``--params_npz`` ('/'-joined keys).

    python script/export_params_npz.py --kind diffusion --ckpt RUN/ckpts \\
        --out params.npz
    python script/export_params_npz.py --kind condfoleygen \\
        -c cfg/condfoleygen/greatesthit_transformer.yaml \\
        [--vq_ckpt DIR] [--transformer_ckpt_path DIR] --out params.npz

``diffusion``: the ``{"unet", "encoder"}`` parameters of a diffusion
training run's checkpoint directory, its best step by the monitored metric,
else its latest (as ``script/video_to_foley.py`` restores them), for
``python -m syncfusion_tpu_torch.generate --params_npz``.

``condfoleygen``: the ``{"vq", "video", "gpt"}`` tree exactly as
``script/generate_audio.py`` assembles it: the model of the config
initialised from ``jax.random.key(0)`` (the video net and every part no
checkpoint supplies), the codebook run's ``params`` from ``--vq_ckpt`` in
place of ``vq`` and the transformer run's ``gpt_params`` from
``--transformer_ckpt_path`` in place of ``gpt`` (each at its latest step),
for ``python -m syncfusion_tpu_torch.generate_audio --params_npz``.

Needs the JAX package (and orbax); the port imports nothing of this script.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Mapping

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from syncfusion_tpu.core.checkpoint import CheckpointConfig, Checkpointer  # noqa: E402
from syncfusion_tpu.core.config import Config, yaml_load  # noqa: E402


def flat_arrays(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts of arrays -> ``{"a/b/c": numpy array}``."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flat_arrays(val, name + "/"))
        else:
            out[name] = np.asarray(val)
    return out


def diffusion_params(ckpt: str) -> dict:
    return Checkpointer(CheckpointConfig(directory=ckpt)).restore_params()


def _restored_field(directory: str, field: str, like: Mapping) -> Mapping:
    """``field`` of the latest checkpoint in ``directory``, restored without
    a template; raises unless it has ``like``'s keys and shapes."""
    tree = Checkpointer(CheckpointConfig(directory=directory)).restore_tree()[field]
    got = {k: v.shape for k, v in flat_arrays(tree).items()}
    want = {k: v.shape for k, v in flat_arrays(like).items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:8]
        raise ValueError(f"{directory}: its {field} does not fit the config's "
                         f"model (first differences: {diff})")
    return tree


def condfoleygen_params(config: str, vq_ckpt: str | None,
                        transformer_ckpt_path: str | None) -> dict:
    from train_transformer import build_model

    with open(config) as f:
        cfg = Config.wrap(yaml_load(f))
    model = build_model(cfg)
    params = model.init(jax.random.key(0), n_frames=cfg.get("n_frames", 60))
    if vq_ckpt:
        params["vq"] = _restored_field(vq_ckpt, "params", params["vq"])
    if transformer_ckpt_path:
        params["gpt"] = _restored_field(transformer_ckpt_path, "gpt_params",
                                        params["gpt"])
    return params


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=("diffusion", "condfoleygen"), required=True)
    ap.add_argument("--ckpt", help="diffusion: the run's checkpoint directory")
    ap.add_argument("-c", "--config", help="condfoleygen: the transformer config")
    ap.add_argument("--vq_ckpt", default=None, help="condfoleygen: codebook run dir")
    ap.add_argument("--transformer_ckpt_path", default=None,
                    help="condfoleygen: transformer run dir")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.kind == "diffusion":
        if not args.ckpt:
            ap.error("--kind diffusion needs --ckpt")
        params = diffusion_params(args.ckpt)
    else:
        if not args.config:
            ap.error("--kind condfoleygen needs -c")
        params = condfoleygen_params(args.config, args.vq_ckpt,
                                     args.transformer_ckpt_path)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat_arrays(params))
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
