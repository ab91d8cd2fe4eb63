"""CondFoleyGen baseline generation on the Greatest Hits test set (the
counterpart of ``script/generate_audio.py``).

    python -m syncfusion_tpu_torch.generate_audio --gh_testset \\
        -c cfg/condfoleygen/greatesthit_transformer.yaml \\
        [--params_npz params.npz | --vq_ckpt DIR --transformer_ckpt_path DIR] \\
        [--melgan_ckpt best_netG.pt] \\
        [--output_dir output/condfoleygen] [--W_scale 1] [--batch_size 4] \\
        [--top_k 512] [--temperature 1.0] [--audio_only] [--seed 0] \\
        [--style_transfer [--vgg19_ckpt vgg19.pth] [--style_steps 300]]

Per test item (the cond video is never the ref video): the cond audio ->
``wav_to_spec`` -> VQ tokens; the cond + ref frames -> R(2+1)D features;
the GPT samples the 50 ref tokens (KV-cached, top-k); the tokens -> the VQ
decoder's mel -> MelGAN (``--melgan_ckpt``) or, without it, 32 iterations
of Griffin-Lim -> a 22.05 kHz wav.  f32 without TF32, as the JAX script
computes.

Writes ``generated_audio/{ref}_to_{cond}_{i}.wav``; without
``--audio_only`` also the orig and cond VQ reconstructions
(``orig_audio/{ref}.wav``, ``cond_audio/{cond}.wav``), three muxed videos
(``generated_video/``, ``orig_video/``, ``cond_video/``; from the processed
frames, or trimmed from ``--orig_videos_dir`` with ffmpeg) and a coolwarm
spectrogram ``.jpg`` beside each video.

``--style_transfer`` replaces the GPT's sampling with the reference's
legacy style transfer (``eval/style_transfer.py``): per item, the VQ
reconstruction of the ref audio's mel is optimised toward the gram
matrices of the cond audio's (VGG19's first five convs, ``--style_steps``
L-BFGS steps), and the result is vocoded as above.  ``--vgg19_ckpt`` is a
torchvision ``vgg19`` state dict; without it the VGG weights are seeded
random ones (with a warning), as in the JAX script.

The config (``-c``, JSON, or YAML where PyYAML is installed) is read as
``core.config.BaselineConfig``; its defaults are
``cfg/condfoleygen/*.yaml``'s.  ``--params_npz`` is the JAX ``{"vq",
"video", "gpt"}`` tree as ``script/export_params_npz.py --kind
condfoleygen`` writes it.  ``--vq_ckpt`` and ``--transformer_ckpt_path``
take the port's own runs instead (``train_codebook``'s and
``train_transformer``'s checkpoint directories, each its best step by
``val/rec_loss`` or ``val/loss``, else its latest); the frozen video net
is then the one the transformer trainer had, seeded from the config's
``seed``.  Without either the weights are seeded random ones.
Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from syncfusion_tpu_torch.convert import av_transformer_state_dict, unflatten
from syncfusion_tpu_torch.core.checkpoint import restore_best
from syncfusion_tpu_torch.core.config import BaselineConfig
from syncfusion_tpu_torch.data.baseline_dataset import (
    CondGreatestHitsWaveCondOnImage,
    baseline_loader,
)
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.eval.style_transfer import (
    Vgg19Prefix,
    convert_torch_vgg19,
    style_transfer_mel,
)
from syncfusion_tpu_torch.models.melgan import Vocoder
from syncfusion_tpu_torch.models.mingpt import GPTFeats
from syncfusion_tpu_torch.models.transformer_av import AVCondTransformer
from syncfusion_tpu_torch.models.vqgan.model import VQModel, wav_to_spec
from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl
from syncfusion_tpu_torch.ops.wav import write_wav

log = logging.getLogger("syncfusion_tpu_torch.generate_audio")

SR = 22050


def build_model(cfg: BaselineConfig, device, seed: Optional[int] = 0) -> AVCondTransformer:
    """The baseline at ``cfg``'s widths in eval mode, with seeded random
    weights; ``seed=None`` leaves them unset, for parameters to be loaded."""
    vq = VQModel(**dataclasses.asdict(cfg.model))
    model = AVCondTransformer(vq, GPTFeats(cfg.transformer), pkeep=cfg.pkeep).to(device)
    return (model if seed is None else model.init(seed)).eval()


def load_params_npz(model: AVCondTransformer, path) -> None:
    """The exporter's ``.npz`` (the JAX tree, '/'-joined keys) into
    ``model``, strictly."""
    with np.load(path) as npz:
        model.load_state_dict(av_transformer_state_dict(unflatten(dict(npz))),
                              strict=True)


def load_runs(model: AVCondTransformer, vq_ckpt=None, transformer_ckpt_path=None) -> None:
    """The VQ of a ``train_codebook`` run and the GPT of a
    ``train_transformer`` run into ``model``, strictly: each directory's
    best step by its monitored metric, else its latest."""
    if vq_ckpt:
        model.vq.load_state_dict(restore_best(vq_ckpt, "val/rec_loss")["vq"], strict=True)
    if transformer_ckpt_path:
        model.gpt.load_state_dict(restore_best(transformer_ckpt_path, "val/loss")["model"],
                                  strict=True)


def spec01(model: AVCondTransformer, grid: torch.Tensor) -> torch.Tensor:
    """A token grid -> its decoded mel in [0, 1], (B, 80, 16·W')."""
    return (model.decode_grid(grid)[:, 0] + 1.0) / 2.0


def reconstruction01(model: AVCondTransformer, spec: torch.Tensor) -> torch.Tensor:
    """The VQ round trip of a spectrogram (B, 1, 80, 160), in [0, 1]."""
    return spec01(model, model.vq.encode_indices(spec))


def load_vgg19(path, device, seed: int = 0) -> Vgg19Prefix:
    """The style transfer's VGG19 prefix on ``device``: from a torchvision
    ``vgg19`` state dict at ``path``, else seeded random weights."""
    vgg = Vgg19Prefix().to(device)
    if path:
        sd = torch.load(path, map_location="cpu")
        sd = sd.get("state_dict", sd)
        vgg.load_state_dict(convert_torch_vgg19(
            {k: v for k, v in sd.items() if k.startswith("features.")}), strict=True)
    else:
        log.warning("--style_transfer without --vgg19_ckpt: the VGG19 weights are "
                    "random")
        vgg.init(seed)
    return vgg.eval()


def main(argv=None) -> dict:
    """Writes the artifact set; returns ``{"clips", "output_dir"}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gh_testset", action="store_true",
                    help="the Greatest Hits test split (the only set)")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--params_npz", default=None,
                    help="the JAX {vq, video, gpt} tree as .npz with '/'-joined "
                         "keys (script/export_params_npz.py)")
    ap.add_argument("--vq_ckpt", default=None,
                    help="a train_codebook run's ckpts directory (not with --params_npz)")
    ap.add_argument("--transformer_ckpt_path", default=None,
                    help="a train_transformer run's ckpts directory (not with "
                         "--params_npz)")
    ap.add_argument("--melgan_ckpt", default=None,
                    help="the reference MelGAN's best_netG.pt (without it: "
                         "Griffin-Lim)")
    ap.add_argument("--output_dir", default="output/condfoleygen")
    ap.add_argument("--W_scale", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--top_k", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--data_to_use", type=float, default=1.0)
    ap.add_argument("--style_transfer", action="store_true",
                    help="VGG19 gram-matrix style transfer between the VQ "
                         "reconstructions in place of the GPT's sampling")
    ap.add_argument("--vgg19_ckpt", default=None,
                    help="torchvision vgg19 state dict for --style_transfer")
    ap.add_argument("--style_steps", type=int, default=300,
                    help="L-BFGS steps of --style_transfer")
    ap.add_argument("--orig_videos_dir", default=None,
                    help="the original videos to mux the outputs from (needs "
                         "ffmpeg); without it the videos are rebuilt from the "
                         "processed frames")
    ap.add_argument("--orig_videos_suffix", default="_mic.mp4")
    ap.add_argument("--audio_only", action="store_true",
                    help="write only generated_audio/*.wav")
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the GPT's draws and of the random weights")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    runs = args.vq_ckpt or args.transformer_ckpt_path
    if args.params_npz and runs:
        ap.error("--params_npz excludes --vq_ckpt and --transformer_ckpt_path")

    cfg = BaselineConfig.from_files([args.config])
    device = default_device(args.device)
    set_exact_f32()
    model = build_model(cfg, device, seed=None if args.params_npz else
                        cfg.seed if runs else args.seed)
    if args.params_npz:
        load_params_npz(model, args.params_npz)
    elif runs:
        load_runs(model, args.vq_ckpt, args.transformer_ckpt_path)
    if not (args.params_npz or args.transformer_ckpt_path):
        log.warning("no --params_npz or --transformer_ckpt_path: the GPT's weights "
                    "are random, the output is noise-shaped")
    vocoder = Vocoder(args.melgan_ckpt, device) if args.melgan_ckpt else None
    vgg = load_vgg19(args.vgg19_ckpt, device, args.seed) if args.style_transfer else None

    d = cfg.data
    ds = CondGreatestHitsWaveCondOnImage(
        d.root_dir, d.test_split_file_path, data_to_use=args.data_to_use,
        chunk_length_in_seconds=d.chunk_length_in_seconds, sample_rate=d.sample_rate,
        rand_shift=False, p_outside_cond=1.0, frame_size=d.frame_size)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def decode(s01: torch.Tensor) -> np.ndarray:
        wav = vocoder(s01) if vocoder is not None else mel01_to_waveform_gl(s01, SR)
        return wav.cpu().numpy()

    chunk_s = d.chunk_length_in_seconds * args.W_scale
    n_samp = int(SR * chunk_s)
    idx = 0
    for batch in baseline_loader(ds, args.batch_size):
        with torch.inference_mode():
            cond_spec = wav_to_spec(torch.from_numpy(batch["cond_image"]).to(device))[:, None]
            if args.style_transfer:
                orig01 = reconstruction01(
                    model, wav_to_spec(torch.from_numpy(batch["image"]).to(device))[:, None])
                cond01 = reconstruction01(model, cond_spec)
            else:
                frames = torch.from_numpy(batch["feature"]).to(device)
                gen01 = spec01(model, model.sample(cond_spec, frames, gen,
                                                   temperature=args.temperature,
                                                   top_k=args.top_k))
        if args.style_transfer:  # autograd: outside inference mode
            gen01 = torch.stack([
                style_transfer_mel(vgg, orig01[i], cond01[i],
                                   spec_take_first=orig01.shape[-1],
                                   num_steps=args.style_steps)
                for i in range(orig01.shape[0])])
        with torch.inference_mode():
            wavs = decode(gen01)
            if not args.audio_only:
                if not args.style_transfer:
                    orig01 = reconstruction01(
                        model,
                        wav_to_spec(torch.from_numpy(batch["image"]).to(device))[:, None])
                    cond01 = reconstruction01(model, cond_spec)
                orig_wavs, cond_wavs = decode(orig01), decode(cond01)
                gen01, orig01, cond01 = (s.cpu().numpy() for s in (gen01, orig01, cond01))
        for i in range(wavs.shape[0]):
            # {ref}_to_{cond}: the onset evaluation splits on "_to_"; the
            # running index keeps repeated pairs apart
            name = Path(batch["file_path_wav_"][i]).name
            cname = Path(batch["file_path_cond_wav_"][i]).name
            pair = f"{name}_to_{cname}_{idx}"
            gen_wav_path = out / "generated_audio" / f"{pair}.wav"
            gen_wav_path.parent.mkdir(parents=True, exist_ok=True)
            write_wav(gen_wav_path, wavs[i][:n_samp], SR)
            if not args.audio_only:
                _write_item_artifacts(args, out, ds, batch, i, pair, name, cname,
                                      gen_wav_path, orig_wavs[i][:n_samp],
                                      cond_wavs[i][:n_samp], gen01[i], orig01[i],
                                      cond01[i], chunk_s)
            idx += 1
        log.info("generated %d clips", idx)
    return {"clips": idx, "output_dir": str(out)}


def _write_item_artifacts(args, out, ds, batch, i, pair, name, cname, gen_wav_path,
                          orig_wav, cond_wav, gen01, orig01, cond01, chunk_s):
    """The reconstruction wavs, the three muxed videos and a spectrogram
    image beside each video."""
    from syncfusion_tpu_torch.eval.mux import attach_audio_to_frames, attach_audio_to_video
    from syncfusion_tpu_torch.eval.panels import write_spec_image

    orig_wav_path = out / "orig_audio" / f"{name}.wav"
    cond_wav_path = out / "cond_audio" / f"{cname}.wav"
    for path, wav in ((orig_wav_path, orig_wav), (cond_wav_path, cond_wav)):
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(path, wav, SR)

    ref_fps = float(batch["frame_rate_"][i])
    cond_fps = float(batch["cond_frame_rate_"][i])
    for vdir, vname, start_f, fps, wav_path, src in (
            ("generated_video", pair, batch["start_frame_"][i], ref_fps, gen_wav_path, name),
            ("orig_video", name, batch["start_frame_"][i], ref_fps, orig_wav_path, name),
            ("cond_video", cname, batch["cond_start_frame_"][i], cond_fps, cond_wav_path,
             cname)):
        dest = out / vdir / f"{vname}.mp4"
        if args.orig_videos_dir:
            attach_audio_to_video(
                Path(args.orig_videos_dir) / f"{src}{args.orig_videos_suffix}",
                wav_path, dest, fps=fps, video_start_in_seconds=start_f / fps,
                video_duration_in_seconds=chunk_s)
        else:
            attach_audio_to_frames(
                Path(ds.root) / src / "frames", f"{src}.frame_%06d.jpg", wav_path, dest,
                fps=fps, start_frame=int(start_f), n_frames=int(round(chunk_s * fps)))

    write_spec_image(gen01, out / "generated_video" / f"{pair}.jpg")
    write_spec_image(orig01, out / "orig_video" / f"{name}.jpg")
    write_spec_image(cond01, out / "cond_video" / f"{cname}.jpg")


if __name__ == "__main__":
    main()
