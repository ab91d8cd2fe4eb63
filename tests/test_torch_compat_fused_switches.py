"""A compat config that also sets a fused switch builds the a-unet twins in
the port, as in the JAX package: ``SyncFusionDiffusion.from_config`` of
both packages selects ``UNetV0Compat`` / ``Encoder1dCompat`` and ignores
``model.fused_stats`` and ``model.fused_resnet`` (the port logs a
warning), at ``exp/model/diffusion.yaml``'s widths and on the tiny compat
node of ``tests/test_torch_adp_compat.py``, where the twins' forwards agree
with the JAX twins' to 1e-4 of max |JAX| (that file's tolerance)."""

import copy
import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import adp_compat as jcompat
from syncfusion_tpu.models import adp_convert as jconvert
from syncfusion_tpu.models import adp_torch_recon as jrecon
from syncfusion_tpu.models.syncfusion import SyncFusionDiffusion as JaxSyncFusion
from syncfusion_tpu_torch.convert import to_state_dict
from syncfusion_tpu_torch.core.config import from_yaml
from syncfusion_tpu_torch.models import adp_compat
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from test_torch_adp_compat import NODE, _inputs, _recon_sd, _rel
from torch_port_helpers import n

ROOT = Path(__file__).resolve().parent.parent
SWITCHES = ("fused_stats", "fused_resnet")


def _with_switch(node, switch):
    out = copy.deepcopy(node)
    out["compat"] = True
    out["model"][switch] = True
    return out


@pytest.mark.parametrize("switch", SWITCHES)
def test_diffusion_yaml_with_a_fused_switch_builds_the_twins(switch, monkeypatch, caplog):
    """The file's node at its full widths, on the meta device (shapes
    only: the parameter draw needs a real device, so it is skipped)."""
    node = _with_switch(from_yaml(ROOT / "exp/model/diffusion.yaml", raw=True)["model"],
                        switch)
    jm = JaxSyncFusion.from_config(node)
    assert isinstance(jm.unet, jcompat.UNetV0Compat)
    assert isinstance(jm.onsets_encoder, jcompat.Encoder1dCompat)
    monkeypatch.setattr(SyncFusionDiffusion, "init", lambda self, seed: self)
    with caplog.at_level(logging.WARNING, logger="syncfusion_tpu_torch.syncfusion"):
        model = SyncFusionDiffusion.from_config(node, device="meta")
    assert isinstance(model.unet, adp_compat.UNetV0Compat)
    assert isinstance(model.onsets_encoder, adp_compat.Encoder1dCompat)
    assert model.compat
    assert any("ignore the fused resnet chain" in r.getMessage() for r in caplog.records)
    # the twins take the JAX twins' configurations, field by field
    assert model.unet.cfg.__dict__ == jm.unet.cfg.__dict__
    assert model.onsets_encoder.cfg.__dict__ == jm.onsets_encoder.cfg.__dict__


@pytest.mark.parametrize("switch", [*SWITCHES, "fused_stats_keyword"])
def test_tiny_compat_node_with_a_fused_switch_matches_the_jax_twins(switch):
    """Both packages build the twins from the tiny node with the switch set
    (or, for ``fused_stats_keyword``, with ``from_config``'s own
    ``fused_stats=True``); the reference-layout weights converted once load
    into both; the encoder's context and the UNet's forward on it agree."""
    keyword = switch.endswith("_keyword")
    node = {"compat": True, **copy.deepcopy(NODE)} if keyword else _with_switch(NODE, switch)
    extra = {"fused_stats": True} if keyword else {}
    jm = JaxSyncFusion.from_config(node, **extra)
    ucfg, ecfg = jm.unet.cfg, jm.onsets_encoder.cfg
    ckpt = {**{f"model.net.{k}": v for k, v in
               _recon_sd(jrecon.build_unet_recon, ucfg, 21).items()},
            **{f"onsets_encoder.{k}": v for k, v in
               _recon_sd(jrecon.build_encoder_recon, ecfg, 22).items()}}
    params = jconvert.convert_diffusion_ckpt(ckpt, ucfg, ecfg)
    tm = SyncFusionDiffusion.from_config(node, device="cpu", **extra)
    assert isinstance(tm.unet, adp_compat.UNetV0Compat) and tm.compat
    tm.load_state_dict(to_state_dict(params), strict=True)
    tm.eval()

    x, sigma, emb, _ = _inputs(ucfg, length=32, seed=23)
    onsets = np.zeros((2, 32, 1), np.float32)
    onsets[:, [3, 11, 20, 29], 0] = 1.0
    jctx = jm.encode_context(params["encoder"], jnp.asarray(onsets))
    want = np.asarray(jm.unet.apply(params["unet"], jnp.asarray(x), jnp.asarray(sigma),
                                    context=jctx, embedding=jnp.asarray(emb)))
    with torch.no_grad():
        ctx = tm.encode_context(torch.from_numpy(onsets))
        got = tm.unet(torch.from_numpy(x), torch.from_numpy(sigma), context=ctx,
                      embedding=torch.from_numpy(emb))
    assert len(ctx) == len(jctx)
    for c, jc in zip(ctx, jctx):
        if jc is None:
            assert c is None
        else:
            assert _rel(n(c), np.asarray(jc)) < 1e-4
    assert got.shape == want.shape
    assert _rel(n(got), want) < 1e-4
