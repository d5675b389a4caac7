"""Tensor ops: box math, batched NMS, letterbox preprocess, and the wrappers
of the hand-written CUDA kernels (B1 ``gather``, B2 ``decode``, B3 ``stem``;
build and launch plumbing in ``_cuda``)."""

from .boxes import iou_matrix, unletterbox_boxes  # noqa: F401
from .nms import batched_nms  # noqa: F401
from .preprocess import (  # noqa: F401
    LetterboxSpec,
    integer_axis_reduction,
    letterbox_numpy,
    letterbox_spec,
    preprocess_batch,
)
