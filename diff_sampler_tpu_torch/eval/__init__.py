"""Evaluation of the port: the FID Inception-V3 detector, FID and PRDC, and
the image dataset reader that feeds them.  The CLIP score of the JAX
package's ``eval`` is not ported yet."""

from .dataset import ImageFolderDataset
from .fid import (FIDAccumulator, calculate_stats, compute_fid, load_stats,
                  make_inception_feature_fn, save_stats)
from .inception import FEATURE_DIM, InceptionV3FID, import_inception_state_dict
from .prdc import compute_prdc, knn_radii, pairwise_distances
