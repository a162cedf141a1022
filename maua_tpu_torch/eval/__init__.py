"""Evaluation: FID / PRDC / PPL and the LPIPS distance (counterpart of
maua_tpu/eval; SWD is `eval.swd`). The feature networks carry torchvision's
key names, so pretrained InceptionV3 / VGG16 / AlexNet weights and the
richzhang LPIPS heads load as they are; without them they are random from a
seed, and the metric JSON says which weights were used."""

from .inception import InceptionV3
from .lpips import LPIPS, make_perceptual_loss, perceptual_lpips
from .metrics import (
    cached_dataset_stats,
    compute_stats,
    fid,
    fid_from_features,
    frechet_distance,
    ppl,
    prdc,
    vae_fid,
    weights_fingerprint,
)

__all__ = [
    "InceptionV3",
    "LPIPS",
    "cached_dataset_stats",
    "compute_stats",
    "fid",
    "fid_from_features",
    "frechet_distance",
    "make_perceptual_loss",
    "perceptual_lpips",
    "ppl",
    "prdc",
    "vae_fid",
    "weights_fingerprint",
]
