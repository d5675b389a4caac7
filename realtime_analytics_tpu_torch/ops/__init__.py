"""Tensor ops: box math, batched NMS, letterbox preprocess, the int8
convolution (``int8``: im2col + ``torch._int_mm``), the tiling math
(``tiling``, numpy), and the wrappers of the hand-written CUDA kernels (B1
``gather``, B2 ``decode``, B3 ``stem``, B4 ``letterbox``; build and launch
plumbing in ``_cuda``)."""

from .boxes import iou_matrix, unletterbox_boxes  # noqa: F401
from .nms import batched_nms  # noqa: F401
from .preprocess import (  # noqa: F401
    LetterboxSpec,
    integer_axis_reduction,
    letterbox_numpy,
    letterbox_spec,
    preprocess_batch,
)
