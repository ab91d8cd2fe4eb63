"""CLAP: the two towers, their projection heads and the reference's
embedding API (port of ``syncfusion_tpu/models/clap/model.py``).

``ClapEmbedder`` is what training and video to Foley call, as the reference
calls ``laion_clap.CLAP_Module``:

  * ``embed_audio``: the int16 round trip, repeat-pad or truncate to 10 s at
    48 kHz, mel (BatchNorm from running statistics), HTSAT, projection, L2
    normalisation -> (B, 1, 512);
  * ``embed_text``: RoBERTa's ``<s>`` token, projection, L2 normalisation.

Both return tensors on the embedder's device, so the training feed needs no
host round trip: the work is queued on the calling thread's current stream
and nothing waits for it.  Everything computes in f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.device import default_device
from syncfusion_tpu_torch.models.clap.htsat import (
    CLAP_SAMPLES,
    HTSAT,
    N_MELS,
    clap_mel,
    prepare_audio,
    reshape_mel_to_image,
)
from syncfusion_tpu_torch.models.clap.roberta import RobertaModel, tokenize
from syncfusion_tpu_torch.models.init import flax_init
from syncfusion_tpu_torch.ops.quantize import float32_to_int16

BN_EPS = 1e-5


class Projection(nn.Module):
    """Linear -> ReLU -> Linear (laion_clap's projection MLP)."""

    def __init__(self, in_features: int, out_features: int = 512):
        super().__init__()
        self.linear1 = nn.Linear(in_features, out_features)
        self.linear2 = nn.Linear(out_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


class ClapModel(nn.Module):
    """HTSAT + RoBERTa + projections.  ``audio`` and ``text`` are keyword
    arguments of ``HTSAT`` and ``RobertaModel`` (default: HTSAT-tiny and
    roberta-base).  The mel BatchNorm's four vectors (HTSAT's ``bn0``,
    inference statistics) are buffers."""

    def __init__(self, embed_dim: int = 512, audio: Optional[dict] = None,
                 text: Optional[dict] = None):
        super().__init__()
        self.audio_branch = HTSAT(**(audio or {}))
        self.text_branch = RobertaModel(**(text or {}))
        self.audio_projection = Projection(self.audio_branch.norm.normalized_shape[0],
                                           embed_dim)
        self.text_projection = Projection(self.text_branch.embeddings.LayerNorm
                                          .normalized_shape[0], embed_dim)
        self.register_buffer("mel_bn_scale", torch.ones(N_MELS))
        self.register_buffer("mel_bn_bias", torch.zeros(N_MELS))
        self.register_buffer("mel_bn_mean", torch.zeros(N_MELS))
        self.register_buffer("mel_bn_var", torch.ones(N_MELS))

    def encode_audio(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, 480000) f32 -> (B, 512) L2-normalised embedding."""
        mel = clap_mel(wav)
        mel = (mel - self.mel_bn_mean) / torch.sqrt(self.mel_bn_var + BN_EPS)
        mel = mel * self.mel_bn_scale + self.mel_bn_bias
        emb = self.audio_projection(self.audio_branch(reshape_mel_to_image(mel)))
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids and mask -> (B, 512) L2-normalised embedding of the
        ``<s>`` token."""
        cls = self.text_branch(input_ids, attention_mask)[:, 0]
        emb = self.text_projection(cls)
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


@torch.no_grad()
def clap_init(model: ClapModel, seed: int) -> ClapModel:
    """Random parameters from ``seed`` with Flax's distributions: Dense and
    Conv kernels lecun-normal (a normal of variance 1/fan_in truncated at two
    standard deviations), zero biases, unit LayerNorm scales, embeddings
    normal of variance 1/width, bias tables normal(0.02) truncated at two
    standard deviations, the mel BatchNorm the identity.  The numbers differ
    from JAX's for the same seed; load converted parameters to match."""
    flax_init(model, seed)
    for buf, val in (("mel_bn_scale", 1.0), ("mel_bn_bias", 0.0),
                     ("mel_bn_mean", 0.0), ("mel_bn_var", 1.0)):
        getattr(model, buf).fill_(val)
    return model


class ClapEmbedder:
    """The frozen CLAP embedder of training and generation.

    ``checkpoint_path``: laion_clap's ``630k-audioset-best.pt`` (or a file of
    the same keys), loaded through ``convert.load_laion_clap``; without it
    the weights are random from ``seed`` (complete in shape, meaningless in
    value).  ``model``: a ``ClapModel`` to wrap in place of HTSAT-tiny and
    roberta-base.  Runs on ``device`` (default: the card).
    """

    def __init__(self, checkpoint_path: Optional[str] = None,
                 tokenizer_path: Optional[str] = None, device=None, seed: int = 0,
                 model: Optional[ClapModel] = None):
        self.device = default_device(device)
        self.tokenizer_path = tokenizer_path
        if model is None:
            with torch.device(self.device):
                model = ClapModel()
            clap_init(model.to(self.device), seed)
        self.model = model.to(self.device).eval().requires_grad_(False)
        if checkpoint_path:
            from syncfusion_tpu_torch.core.checkpoint import load_torch_state_dict
            from syncfusion_tpu_torch.models.clap.convert import load_laion_clap

            self.model.load_state_dict(
                load_laion_clap(load_torch_state_dict(checkpoint_path)), strict=True)

    @torch.no_grad()
    def embed_audio(self, wav) -> torch.Tensor:
        """(B, L, 1) or (B, L) waveform (numpy) -> (B, 1, 512) on the device.

        The int16 round trip that the reference applies before CLAP is split
        over the wire: int16 samples go to the device (half the bytes) and
        are scaled back there, in f32 as the JAX package does."""
        wav = np.asarray(wav)
        if wav.ndim == 3:
            wav = wav[:, :, 0]
        wav = prepare_audio(float32_to_int16(wav.astype(np.float32)), CLAP_SAMPLES)
        x = self._to_device(wav).float() / 32767.0
        return self.model.encode_audio(x)[:, None, :]

    @torch.no_grad()
    def embed_text(self, texts: list[str]) -> torch.Tensor:
        """Prompts -> (B, 1, 512) on the device."""
        toks = tokenize(texts, tokenizer_path=self.tokenizer_path)
        return self.model.encode_text(self._to_device(toks["input_ids"].astype(np.int64)),
                                      self._to_device(toks["attention_mask"]))[:, None, :]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: a
        pinned copy, queued (a pageable one waits for the queue to drain)."""
        x = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)
