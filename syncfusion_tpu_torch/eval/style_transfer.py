"""Spectrogram style transfer by VGG19 gram matrices (port of
``syncfusion_tpu/eval/style_transfer.py``).

The CondFoleyGen reference's legacy style-transfer generation: the content
image is the VQGAN reconstruction mel of the reference audio, the style
image the cond audio's, both read as RGB images in [0, 1]; starting from
the content, the image is optimised to match the content features at
conv_4 and the gram matrices at conv_1..conv_5 of an ImageNet VGG19, then
averaged over RGB back to a mel panel.  Only the first five convs of VGG19
are evaluated (the reference trims the trunk after its last loss, conv3_1).

The optimiser is the JAX package's, ``optax.lbfgs()`` at its defaults
(``train/lbfgs.py``), with a clamp to [0, 1] after every step.  Images are
(B, H, W, 3) at the public functions, as in JAX; the convolutions run in
(B, C, H, W) on the image's device (cuDNN on the card; no TPU kernel lies
on this path).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.train.lbfgs import minimize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# VGG19 features, config "E", through conv3_1: (out_channels, maxpool before)
_VGG_PREFIX = ((64, False), (64, False), (128, True), (128, False), (256, True))
# torchvision's indices of those convs in ``features``
_TORCHVISION_INDEX = (0, 2, 5, 7, 10)

CONTENT_LAYERS = ("conv_4",)
STYLE_LAYERS = ("conv_1", "conv_2", "conv_3", "conv_4", "conv_5")


class Vgg19Prefix(nn.Module):
    """The first five convs of VGG19 ``features``; returns their pre-ReLU
    activations ``{conv_1..conv_5}``, each (B, H, W, C) (the reference taps
    its losses right after each Conv2d, before the ReLU)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, _) in enumerate(_VGG_PREFIX, start=1):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Vgg19Prefix":
        """Seeded random weights (kernels normal with variance 1/fan_in, zero
        biases), for runs without the ImageNet weights."""
        gen = torch.Generator(device=self.conv_1.weight.device).manual_seed(seed)
        for i in range(1, len(_VGG_PREFIX) + 1):
            conv = getattr(self, f"conv_{i}")
            conv.weight.normal_(0.0, 1.0 / math.sqrt(conv.weight[0].numel()), generator=gen)
            conv.bias.zero_()
        return self

    def forward(self, x) -> dict[str, torch.Tensor]:
        """x (B, H, W, 3) in [0, 1]."""
        h = (x.permute(0, 3, 1, 2) - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        acts = {}
        for i, (_, pool_before) in enumerate(_VGG_PREFIX, start=1):
            if pool_before:
                h = F.max_pool2d(h, 2, 2)
            h = getattr(self, f"conv_{i}")(h)
            acts[f"conv_{i}"] = h.permute(0, 2, 3, 1)
            h = F.relu(h)
        return acts


def convert_torch_vgg19(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A torchvision ``vgg19`` state dict (its ``features.*``; torch
    tensors or numpy arrays) -> a state dict for ``Vgg19Prefix``: the convs
    at ``features.0, 2, 5, 7, 10``."""
    sd = {}
    for i, index in enumerate(_TORCHVISION_INDEX, start=1):
        for name in ("weight", "bias"):
            sd[f"conv_{i}.{name}"] = torch.as_tensor(
                np.asarray(state_dict[f"features.{index}.{name}"], dtype=np.float32))
    return sd


def load_specs_as_img(spec, spec_take_first: int = 192) -> torch.Tensor:
    """A mel panel in [0, 1] (numpy or tensor) -> a (1, 80, W, 3) f32 RGB
    image on the CPU, through the reference's uint8 round trip
    (``Image.fromarray((spec * 255).uint8)``, a same-size resize, ToTensor)."""
    if isinstance(spec, torch.Tensor):
        spec = spec.detach().cpu().numpy()
    spec = np.asarray(spec)[:, :spec_take_first]
    q = (spec * 255.0).astype(np.uint8).astype(np.float32) / 255.0
    return torch.from_numpy(np.repeat(q[..., None], 3, axis=-1)[None])


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """The reference's gram matrix of (B, H, W, C) features: F (B·C, H·W),
    G = F Fᵀ / (B·C·H·W)."""
    b, h, w, c = feat.shape
    f = feat.permute(0, 3, 1, 2).reshape(b * c, h * w)
    return (f @ f.T) / (b * c * h * w)


def style_content_loss(vgg: Vgg19Prefix, input_img, content_targets: Mapping,
                       style_grams: Mapping, style_weight: float,
                       content_weight: float) -> torch.Tensor:
    acts = vgg(input_img)
    style = sum(torch.mean((gram_matrix(acts[layer]) - style_grams[layer]) ** 2)
                for layer in STYLE_LAYERS)
    content = sum(torch.mean((acts[layer] - content_targets[layer]) ** 2)
                  for layer in CONTENT_LAYERS)
    return style_weight * style + content_weight * content


def run_style_transfer(vgg: Vgg19Prefix, content_img, style_img, input_img=None,
                       num_steps: int = 300, style_weight: float = 1_000_000.0,
                       content_weight: float = 1.0) -> tuple[torch.Tensor, float]:
    """Optimise ``input_img`` (default: the content image), each (1, H, W,
    3) in [0, 1] on ``vgg``'s device, toward the style image's texture:
    ``num_steps`` L-BFGS steps, each followed by a clamp to [0, 1] (the
    reference clamps in every closure).  Returns (the image, the loss the
    last step started from), as the JAX function does."""
    if input_img is None:
        input_img = content_img
    with torch.no_grad():
        content_targets = {layer: a for layer, a in vgg(content_img).items()
                           if layer in CONTENT_LAYERS}
        style_grams = {layer: gram_matrix(a) for layer, a in vgg(style_img).items()
                       if layer in STYLE_LAYERS}
    weights = list(vgg.parameters())
    frozen = [p.requires_grad for p in weights]
    for p in weights:
        p.requires_grad_(False)

    def value_and_grad(img):
        with torch.enable_grad():
            img = img.detach().requires_grad_(True)
            loss = style_content_loss(vgg, img, content_targets, style_grams,
                                      style_weight, content_weight)
            (grad,) = torch.autograd.grad(loss, img)
        return loss.detach(), grad

    try:
        img, values = minimize(value_and_grad, input_img.detach(), num_steps,
                               project=lambda x: x.clamp(0.0, 1.0))
    finally:
        for p, flag in zip(weights, frozen):
            p.requires_grad_(flag)
    return img, float(values[-1])


def style_transfer_mel(vgg: Vgg19Prefix, content_mel, style_mel,
                       spec_take_first: int = 192, num_steps: int = 300,
                       style_weight: float = 1_000_000.0,
                       content_weight: float = 1.0) -> torch.Tensor:
    """The reference's call site: two mel panels in [0, 1] (numpy or
    tensors) in, the styled panel (80, spec_take_first) out, on ``vgg``'s
    device (the RGB mean, as the reference's ``torch.mean(generated_spec,
    dim=1)``)."""
    device = next(vgg.parameters()).device
    content = load_specs_as_img(content_mel, spec_take_first).to(device)
    style = load_specs_as_img(style_mel, spec_take_first).to(device)
    img, _ = run_style_transfer(vgg, content, style, num_steps=num_steps,
                                style_weight=style_weight, content_weight=content_weight)
    return img[0].mean(dim=-1)
