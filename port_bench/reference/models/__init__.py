"""The model's parts."""

from .meta_arch.maskformer import MaskFormer


def build_model(cfg):
    """The configuration's model, in `.eval()` mode."""
    return MaskFormer.from_config(cfg).eval()
