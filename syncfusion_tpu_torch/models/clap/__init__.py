"""CLAP (LAION's Contrastive Language-Audio Pretraining), the conditioning
embedder of the reference (``laion_clap.CLAP_Module(enable_fusion=False,
amodel='HTSAT-tiny')``, checkpoint ``630k-audioset-best.pt``): port of
``syncfusion_tpu/models/clap``.  HTSAT-tiny audio tower, RoBERTa-base text
tower, projection heads and the laion checkpoint loader."""

from syncfusion_tpu_torch.models.clap.model import ClapEmbedder, ClapModel

__all__ = ["ClapEmbedder", "ClapModel"]
