"""Data layer: KITTI odometry IO, synthetic GT sequences, snippet
pipelines, and host->device prefetch.

Reference parity: `<ref>/data_loader.py` + `<ref>/data/prepare_train_data.py`
(SURVEY.md §2.1 R9/R11). The pipeline produces fixed-shape
NHWC numpy batches on host and overlaps H2D transfer with compute via a
double-buffered prefetcher; no TF queues.
"""

from davo_tpu.data.kitti import (  # noqa: F401
    KittiOdometry,
    parse_calib,
    parse_poses,
    write_poses_kitti,
)
from davo_tpu.data.synthetic import SyntheticSequence  # noqa: F401
from davo_tpu.data.snippets import (  # noqa: F401
    SnippetDataset,
    MultiSourceDataset,
    snippet_indices,
)
from davo_tpu.data.prefetch import device_prefetch  # noqa: F401
