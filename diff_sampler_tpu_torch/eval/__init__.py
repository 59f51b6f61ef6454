"""Evaluation of the port: the FID Inception-V3 detector, FID and PRDC, the
CLIP score (``eval.clip_score``, not re-exported here: its function would
shadow the module), and the image dataset reader that feeds them."""

from .dataset import ImageFolderDataset
from .fid import (FIDAccumulator, calculate_stats, compute_fid, load_stats,
                  make_inception_feature_fn, save_stats)
from .inception import FEATURE_DIM, InceptionV3FID, import_inception_state_dict
from .prdc import compute_prdc, knn_radii, pairwise_distances
