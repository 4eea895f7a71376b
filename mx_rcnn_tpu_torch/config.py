"""Configuration system — the port's own copy of ``mx_rcnn_tpu/config.py``.

Same dataclasses, field names, defaults, presets and ``generate_config``
as the JAX package, so one config means the same thing in both packages
(``cfg.tpu.*`` included: the bucket shapes, ``COMPUTE_DTYPE`` and the RoI
settings live there).  Field names and defaults follow the reference's
``rcnn/config.py``; the container is a frozen (hashable) dataclass tree
assembled by a pure ``generate_config`` instead of a mutable easydict.

Fields that only the JAX package's TPU programs read (mesh axes, remat,
prefetch and loader knobs, ``DEVICE_PREP``) are kept so that configs
round-trip between the packages; the port ignores them (it always preps
on the device).  ``ASSIGN_FUSED`` selects the fused assign kernel in the
port too; its default stays the JAX package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors reference ``config.TRAIN``."""

    END2END: bool = True
    SHUFFLE: bool = True
    FLIP: bool = True

    # images per step and sampled RoIs per image
    BATCH_IMAGES: int = 1
    BATCH_ROIS: int = 128
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.0

    # bbox regression target normalization (folded into weights at save time)
    BBOX_NORMALIZATION_PRECOMPUTED: bool = True
    BBOX_MEANS: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    BBOX_STDS: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)

    # RPN anchor target assignment
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCH_SIZE: int = 256
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_ALLOWED_BORDER: int = 0
    RPN_ASSIGN_IOU_BF16: bool = False

    # RPN proposal generation (training-time Proposal op params);
    # CXX_PROPOSAL selects the NMS kernel over the plain NMS
    CXX_PROPOSAL: bool = True
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_MIN_SIZE: int = 16

    # optimizer (reference train_end2end defaults)
    LR: float = 0.001
    LR_STEP: Tuple[int, ...] = (7,)  # epochs at which lr decays 10x
    LR_FACTOR: float = 0.1
    MOMENTUM: float = 0.9
    WD: float = 0.0005
    CLIP_GRADIENT: float = 5.0
    OPT_ACC_DTYPE: str = "float32"
    WARMUP: bool = False
    WARMUP_LR: float = 0.0
    WARMUP_STEP: int = 0

    # Mask R-CNN
    MASK_SIZE: int = 28


@dataclass(frozen=True)
class TestConfig:
    """Mirrors reference ``config.TEST``."""

    HAS_RPN: bool = True
    BATCH_IMAGES: int = 1
    # selects the NMS kernel over the plain NMS inside ``propose``
    CXX_PROPOSAL: bool = True
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_MIN_SIZE: int = 16
    # final per-class detection NMS
    NMS: float = 0.3
    # score threshold applied in pred_eval
    THRESH: float = 1e-3
    MAX_PER_IMAGE: int = 100
    PROPOSAL: str = "rpn"
    MASK_PASTE: str = "native"


@dataclass(frozen=True)
class NetworkConfig:
    """Mirrors the reference's per-network preset dict."""

    NETWORK: str = "resnet50"
    PRETRAINED: str = "model/pretrained"
    PRETRAINED_EPOCH: int = 0
    PIXEL_MEANS: Tuple[float, float, float] = (123.68, 116.779, 103.939)
    PIXEL_STDS: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    IMAGE_STRIDE: int = 32
    RPN_FEAT_STRIDE: int = 16
    RCNN_FEAT_STRIDE: int = 16
    FIXED_PARAMS: Tuple[str, ...] = ("conv1", "bn1", "stage1", "gamma", "beta")
    FIXED_PARAMS_SHARED: Tuple[str, ...] = ("conv1", "bn1", "stage1", "stage2", "stage3", "gamma", "beta")
    ANCHOR_SCALES: Tuple[int, ...] = (8, 16, 32)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    HAS_FPN: bool = False
    # host-side 2x2 space-to-depth: images arrive as (H/2, W/2, 12) in
    # (di, dj, c) channel order; ResNet stems only
    HOST_S2D: bool = False
    FPN_FEAT_STRIDES: Tuple[int, ...] = (4, 8, 16, 32, 64)
    FPN_ANCHOR_SCALES: Tuple[int, ...] = (8,)
    FPN_OUT_CHANNELS: int = 256
    HAS_MASK: bool = False

    @property
    def NUM_ANCHORS(self) -> int:
        """Anchors per feature cell, derived from the scale/ratio tuples."""
        scales = self.FPN_ANCHOR_SCALES if self.HAS_FPN else self.ANCHOR_SCALES
        return len(self.ANCHOR_RATIOS) * len(scales)


@dataclass(frozen=True)
class DatasetConfig:
    """Mirrors the reference's per-dataset preset dict."""

    DATASET: str = "PascalVOC"
    IMAGE_SET: str = "2007_trainval"
    TEST_IMAGE_SET: str = "2007_test"
    ROOT_PATH: str = "data"
    DATASET_PATH: str = "data/VOCdevkit"
    NUM_CLASSES: int = 21  # includes __background__


@dataclass(frozen=True)
class TPUConfig:
    """Additions with no reference counterpart (the JAX package's name for
    the group is kept).  Images are bucketed into a few static padded
    shapes instead of the reference's executor rebinding."""

    # (short_side, long_side) scale buckets; first is the reference SCALES[0]
    SCALES: Tuple[Tuple[int, int], ...] = ((600, 1000),)
    # padded max gt boxes per image
    MAX_GT: int = 100
    MESH_AXIS_DATA: str = "data"
    MESH_AXIS_MODEL: str = "model"
    # activation/compute dtype of the network ("bfloat16" | "float32")
    COMPUTE_DTYPE: str = "bfloat16"
    ASSIGN_FUSED: bool = False
    # ROIAlign samples per bin axis (FPN/Mask presets get 2)
    ROI_SAMPLING_RATIO: int = 1
    # RoI pooling reduction: "avg", "max" or "exact"
    ROI_MODE: str = "avg"
    PREFETCH: int = 2
    EVAL_INFLIGHT: int = 2
    EVAL_HOST_WORKERS: int = 2
    PREFETCH_WATCHDOG_S: float = 600.0
    LOADER_WORKERS: int = 0
    REMAT_BACKBONE: bool = False
    DEVICE_PREP: bool = False
    DEVICE_PREP_DTYPE: str = "float32"


@dataclass(frozen=True)
class Config:
    """Root config."""

    network: NetworkConfig = field(default_factory=NetworkConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)

    @property
    def NUM_CLASSES(self) -> int:
        return self.dataset.NUM_CLASSES

    def replace(self, **kw) -> "Config":
        return replace(self, **kw)


_NETWORK_PRESETS = {
    "vgg16": dict(
        NETWORK="vgg16",
        IMAGE_STRIDE=0,
        RPN_FEAT_STRIDE=16,
        RCNN_FEAT_STRIDE=16,
        FIXED_PARAMS=("conv1", "conv2"),
        FIXED_PARAMS_SHARED=("conv1", "conv2", "conv3", "conv4", "conv5"),
        HAS_FPN=False,
    ),
    "resnet50_fpn": dict(
        NETWORK="resnet50",
        HOST_S2D=True,
        IMAGE_STRIDE=32,
        HAS_FPN=True,
        RCNN_FEAT_STRIDE=4,
        FPN_ANCHOR_SCALES=(8,),
        FIXED_PARAMS_SHARED=("conv1", "bn1", "stage1", "stage2", "stage3",
                             "stage4", "lateral", "post", "gamma", "beta"),
    ),
    "resnet101_fpn": dict(
        NETWORK="resnet101",
        HOST_S2D=True,
        IMAGE_STRIDE=32,
        HAS_FPN=True,
        RCNN_FEAT_STRIDE=4,
        FPN_ANCHOR_SCALES=(8,),
        FIXED_PARAMS_SHARED=("conv1", "bn1", "stage1", "stage2", "stage3",
                             "stage4", "lateral", "post", "gamma", "beta"),
    ),
    "resnet101_fpn_mask": dict(
        NETWORK="resnet101",
        HOST_S2D=True,
        IMAGE_STRIDE=32,
        HAS_FPN=True,
        HAS_MASK=True,
        RCNN_FEAT_STRIDE=4,
        FPN_ANCHOR_SCALES=(8,),
        FIXED_PARAMS_SHARED=("conv1", "bn1", "stage1", "stage2", "stage3",
                             "stage4", "lateral", "post", "gamma", "beta"),
    ),
}

for _depth in ("resnet50", "resnet101", "resnet152"):
    _NETWORK_PRESETS[_depth] = dict(
        NETWORK=_depth,
        HOST_S2D=True,
        IMAGE_STRIDE=32,
        FIXED_PARAMS=("conv1", "bn1", "stage1", "gamma", "beta"),
        FIXED_PARAMS_SHARED=("conv1", "bn1", "stage1", "stage2", "stage3",
                             "gamma", "beta"),
    )

_DATASET_PRESETS = {
    "PascalVOC": dict(
        DATASET="PascalVOC",
        IMAGE_SET="2007_trainval",
        TEST_IMAGE_SET="2007_test",
        ROOT_PATH="data",
        DATASET_PATH="data/VOCdevkit",
        NUM_CLASSES=21,
    ),
    "PascalVOC0712": dict(
        DATASET="PascalVOC",
        IMAGE_SET="2007_trainval+2012_trainval",
        TEST_IMAGE_SET="2007_test",
        ROOT_PATH="data",
        DATASET_PATH="data/VOCdevkit",
        NUM_CLASSES=21,
    ),
    "coco": dict(
        DATASET="coco",
        IMAGE_SET="train2017",
        TEST_IMAGE_SET="val2017",
        ROOT_PATH="data",
        DATASET_PATH="data/coco",
        NUM_CLASSES=81,
    ),
}


def generate_config(network: str, dataset: str, **overrides) -> Config:
    """Build a frozen Config from network+dataset preset names.

    ``overrides`` may address nested fields with double-underscore paths,
    e.g. ``generate_config('resnet50', 'PascalVOC', TRAIN__BATCH_IMAGES=2)``.
    """
    if network not in _NETWORK_PRESETS:
        raise KeyError(f"unknown network '{network}'; have {sorted(_NETWORK_PRESETS)}")
    if dataset not in _DATASET_PRESETS:
        raise KeyError(f"unknown dataset '{dataset}'; have {sorted(_DATASET_PRESETS)}")

    net = NetworkConfig(**_NETWORK_PRESETS[network])
    ds = DatasetConfig(**_DATASET_PRESETS[dataset])
    train = TrainConfig()
    test = TestConfig()
    tpu = TPUConfig()

    # COCO schedules differ from VOC in the reference scripts
    if dataset == "coco":
        train = replace(train, LR_STEP=(6,), BATCH_ROIS=128)
        tpu = replace(tpu, SCALES=((800, 1333),))

    # FPN/Mask configs keep the Mask R-CNN paper's 2-sample ROIAlign
    if net.HAS_FPN:
        tpu = replace(tpu, ROI_SAMPLING_RATIO=2)

    cfg = Config(network=net, dataset=ds, TRAIN=train, TEST=test, tpu=tpu)

    for key, val in overrides.items():
        parts = key.split("__")
        if len(parts) == 1:
            cfg = replace(cfg, **{parts[0]: val})
        elif len(parts) == 2:
            sub = getattr(cfg, parts[0])
            cfg = replace(cfg, **{parts[0]: replace(sub, **{parts[1]: val})})
        else:
            raise KeyError(f"override path too deep: {key}")
    return cfg


def list_networks():
    return sorted(_NETWORK_PRESETS)


def list_datasets():
    return sorted(_DATASET_PRESETS)


def config_to_dict(cfg: Config) -> dict:
    """Flatten for logging/serialization."""
    return dataclasses.asdict(cfg)
