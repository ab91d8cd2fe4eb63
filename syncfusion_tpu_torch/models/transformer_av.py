"""The AV-conditional transformer, CondFoleyGen's stage 2 (port of
``column_major``, ``column_major_inverse`` and the inference side of
``AVCondTransformer`` of ``syncfusion_tpu/models/transformer_av.py``).

A frozen SpecVQGAN turns 2-s mel spectrograms into 5 x 10 token grids, read
column-major so that generation runs in time; a frozen keep-temporal
R(2+1)D-18 (``onset_net.R2Plus1D18KeepTemp``, in eval mode) gives per-frame
features of the cond + ref 60-frame stack, each 30-frame half on its own;
the GPT samples the ref tokens given the cond tokens and the features.
``loss`` is training's cross entropy on the ref half, with ``pkeep``'s
token corruption; ``log_images`` the trainer's validation media.

Submodules ``vq``, ``video`` and ``gpt`` mirror the JAX ``{"vq", "video",
"gpt"}`` parameter tree (``convert.av_transformer_state_dict``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.core.config import GPTConfig
from syncfusion_tpu_torch.models import onset_net
from syncfusion_tpu_torch.models.init import flax_init
from syncfusion_tpu_torch.models.mingpt import GPTFeats
from syncfusion_tpu_torch.models.mingpt_decode import sample_tokens_cached
from syncfusion_tpu_torch.models.vqgan.model import VQModel

GRID_H, GRID_W = 5, 10  # the token grid of one 2-s clip
CLIP = GRID_H * GRID_W  # 50


def column_major(indices: torch.Tensor) -> torch.Tensor:
    """(B, 5, W) grid -> (B, 5·W) column-major (time-major) sequence."""
    return indices.transpose(1, 2).reshape(indices.shape[0], -1)


def column_major_inverse(seq: torch.Tensor, w: int = GRID_W) -> torch.Tensor:
    """(B, 5·w) sequence -> (B, 5, w) grid."""
    return seq.reshape(seq.shape[0], w, GRID_H).transpose(1, 2)


class AVCondTransformer(nn.Module):
    clip = CLIP  # tokens a 2-s clip

    def __init__(self, vq: Optional[VQModel] = None, gpt: Optional[GPTFeats] = None,
                 pkeep: float = 1.0):
        super().__init__()
        self.vq = vq if vq is not None else VQModel()
        self.video = onset_net.R2Plus1D18KeepTemp()
        self.gpt = gpt if gpt is not None else GPTFeats(GPTConfig())
        self.pkeep = pkeep

    def init(self, seed: int) -> "AVCondTransformer":
        """Seeded random parameters with Flax's distributions (the video
        net's BatchNorm statistics 0 and 1)."""
        flax_init(self.vq, seed)
        flax_init(self.video, seed + 1)
        flax_init(self.gpt, seed + 2)
        return self

    def encode_to_z(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, 1, 80, 160) -> (B, 50) column-major token ids."""
        return column_major(self.vq.encode_indices(spec))

    def encode_to_c(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, 2T, H, W, 3) cond + ref frames -> (B, 2T, 512) features,
        each half through the video net on its own (eval mode: its running
        BatchNorm statistics, as the frozen reference net)."""
        self.video.train(False)
        x = frames.permute(0, 4, 1, 2, 3)
        half = x.shape[2] // 2
        return torch.cat([self.video(x[:, :, :half]), self.video(x[:, :, half:])], dim=1)

    @torch.no_grad()
    def encode(self, spec: torch.Tensor, cond_spec: torch.Tensor,
               frames: torch.Tensor) -> tuple:
        """The frozen stages of a training batch, without gradients: (ref
        tokens z (B, 50), cond tokens zp (B, 50), features (B, 2T, 512))."""
        return (self.encode_to_z(spec)[:, :self.clip],
                self.encode_to_z(cond_spec)[:, :self.clip], self.encode_to_c(frames))

    def draw_pkeep(self, shape: tuple, generator: Optional[torch.Generator],
                   device=None) -> tuple:
        """The token corruption's draws for ``shape``: (keep mask, bool,
        True with probability ``pkeep``; random tokens below the vocabulary
        size)."""
        mask = torch.rand(shape, generator=generator, device=device) < self.pkeep
        rand = torch.randint(0, self.gpt.cfg.vocab_size, shape, generator=generator,
                             device=device)
        return mask, rand

    def loss(self, spec: torch.Tensor, cond_spec: torch.Tensor, frames: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws: Optional[tuple] = None,
             gpt: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """The cross entropy of the ref half (the JAX ``loss``):
        ``loss_on_codes`` of ``encode``'s output."""
        return self.loss_on_codes(*self.encode(spec, cond_spec, frames),
                                  generator=generator, draws=draws, gpt=gpt)

    def loss_on_codes(self, z: torch.Tensor, zp: torch.Tensor, feats: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[tuple] = None,
                      gpt: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """The GPT (``gpt``, a trainer's wrapped one, or ``self.gpt``) reads
        the features and ``(zp ++ z)[:, :-1]``; its logits from position
        ``cond_size − 1`` on, past the first 50, predict z; their mean cross
        entropy.  With ``pkeep < 1`` each token is kept with probability
        ``pkeep``, else replaced by a random one: ``draws`` (mask, rand) of
        ``draw_pkeep``'s form, or drawn from ``generator``; with neither
        (evaluation, as the JAX loss without a key) nothing is replaced."""
        tokens = torch.cat([zp, z], dim=1)
        if self.pkeep < 1.0 and (draws is not None or generator is not None):
            mask, rand = draws if draws is not None else self.draw_pkeep(
                tuple(tokens.shape), generator, tokens.device)
            tokens = torch.where(mask, tokens, rand.to(tokens.dtype))
        logits = (gpt if gpt is not None else self.gpt)(tokens[:, :-1], feats)
        logits = logits[:, feats.shape[1] - 1:][:, self.clip:]
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), z.reshape(-1))

    @torch.no_grad()
    def log_images(self, spec: torch.Tensor, cond_spec: torch.Tensor, frames: torch.Tensor,
                   generator: Optional[torch.Generator] = None, temperature: float = 1.0,
                   top_k: Optional[int] = 100) -> dict:
        """The validation media (the JAX ``log_images``): ``inputs`` and the
        VQ ``reconstructions`` of the ref tokens, and three samples decoded
        to (B, 1, 80, 160) spectrograms: ``samples_half`` (the last 25 ref
        tokens given the cond tokens and the first 25), ``samples_nopix``
        (all 50 from the cond tokens) and ``samples_det`` (greedy); with
        ``att_half``, ``att_nopix`` and ``att_det``, the GPT's last-layer
        attention (B, H, T, T) of a full forward over each final buffer.
        ``top_k`` is clamped to the vocabulary; the draws come from
        ``generator`` in that order."""
        z, zp, feats = self.encode(spec, cond_spec, frames)
        if top_k is not None:
            top_k = min(top_k, self.gpt.cfg.vocab_size)

        def run(prefix, steps, greedy=False):
            buf = sample_tokens_cached(self.gpt, feats, prefix, steps, generator,
                                       temperature=temperature, top_k=top_k, greedy=greedy)
            _, att = self.gpt(buf, feats, return_att=True)
            return self.decode_grid(column_major_inverse(buf[:, self.clip:])), att

        half = self.clip // 2
        x_half, att_half = run(torch.cat([zp, z[:, :half]], dim=1), self.clip - half)
        x_nopix, att_nopix = run(zp, self.clip)
        x_det, att_det = run(zp, self.clip, greedy=True)
        return {"inputs": spec, "reconstructions": self.decode_grid(column_major_inverse(z)),
                "samples_half": x_half, "samples_nopix": x_nopix, "samples_det": x_det,
                "att_half": att_half, "att_nopix": att_nopix, "att_det": att_det}

    @torch.no_grad()
    def sample(self, cond_spec: torch.Tensor, frames: torch.Tensor,
               generator: Optional[torch.Generator] = None, temperature: float = 1.0,
               top_k: Optional[int] = 512, greedy: bool = False) -> torch.Tensor:
        """Ref tokens given the cond audio and the video -> (B, 5, 10) grid,
        through the KV-cached decode."""
        zp = self.encode_to_z(cond_spec)[:, :self.clip]
        feats = self.encode_to_c(frames)
        buf = sample_tokens_cached(self.gpt, feats, zp, self.clip, generator,
                                   temperature=temperature, top_k=top_k, greedy=greedy)
        return column_major_inverse(buf[:, self.clip:])

    def decode_grid(self, grid: torch.Tensor) -> torch.Tensor:
        """(B, 5, W') token grid -> (B, 1, 80, 16·W') spectrogram."""
        return self.vq.decode_indices(grid)

    @torch.no_grad()
    def sample_long(self, cond_grid: torch.Tensor, feats: torch.Tensor, w_scale: int,
                    generator: Optional[torch.Generator] = None, patch_cols: int = 10,
                    window_cols: int = 10, temperature: float = 1.0,
                    top_k: Optional[int] = 512,
                    frames_per_col: Optional[float] = None) -> torch.Tensor:
        """Sliding-window generation of a (B, 5, 10·w_scale) grid: patches of
        ``patch_cols`` columns, each conditioned on the last
        ``window_cols`` generated columns (the cond grid's to start) and
        the time-aligned slice of the features."""
        total_cols = GRID_W * w_scale
        fpc = frames_per_col if frames_per_col else feats.shape[1] / (2 * total_cols)
        out_cols = []
        context = column_major(cond_grid)[:, -window_cols * GRID_H:]
        produced = 0
        while produced < total_cols:
            n_cols = min(patch_cols, total_cols - produced)
            f_start = int(max(0, (produced - window_cols) + total_cols) * fpc)
            f_len = int((window_cols + n_cols) * fpc)
            f_slice = feats[:, f_start:f_start + f_len]
            if f_slice.shape[1] == 0:
                f_slice = feats[:, -1:]
            buf = sample_tokens_cached(self.gpt, f_slice, context, n_cols * GRID_H,
                                       generator, temperature=temperature, top_k=top_k)
            out_cols.append(buf[:, context.shape[1]:])
            produced += n_cols
            context = buf[:, -window_cols * GRID_H:]
        return column_major_inverse(torch.cat(out_cols, dim=1), total_cols)

