"""The suppression mask's threshold-band cases (``chip_smoke.mask_band_cases``)
on the CPU.

Pairs of boxes whose IoU lies at or one float32 step beside the
threshold, degenerate boxes whose union is clamped at 1e-14, coordinates
at the scale of 1e5 and 1e-3, thresholds 0.0 and 1.0, and n of 65, 127
and 4097.  The oracle is the JAX package: ``ops.boxes.bbox_overlaps(...) >
thresh`` for the words of ``suppression_mask_plain`` (the plain version of
the ``nms_mask`` kernel), and ``ops.nms.nms_padded`` for the kept rows of
``nms_bitmask``'s CPU route.  This is bit logic: any difference is a bug,
and there is no tolerance.  ``chip_smoke.py`` runs the same cases through
the kernel on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mx_rcnn_tpu.ops.boxes import bbox_overlaps as jax_bbox_overlaps
from mx_rcnn_tpu.ops.nms import nms_padded as jax_nms_padded
from mx_rcnn_tpu_torch.kernels import nms_cuda

torch.set_num_threads(2)

CASES = chip_smoke.mask_band_cases()
MAX_OUT = 300


def unpack(words: np.ndarray, n: int) -> np.ndarray:
    """(n, ceil(n/64)) int64 words → (n, n) bool, bit j of word w at 64w+j."""
    bits = (words[..., None] >> np.arange(64, dtype=np.int64)) & 1
    return bits.reshape(n, -1)[:, :n].astype(bool)


@pytest.mark.parametrize("name", list(CASES))
def test_mask_band_case_matches_jax(name):
    boxes, thresh = CASES[name]
    n = boxes.shape[1]
    want = np.asarray(jax_bbox_overlaps(jnp.asarray(boxes[0]),
                                        jnp.asarray(boxes[0]))
                      > np.float32(thresh)) & np.triu(np.ones((n, n), bool), 1)
    tb = torch.from_numpy(boxes)
    words = nms_cuda.suppression_mask_plain(tb, thresh)
    np.testing.assert_array_equal(unpack(words[0].numpy(), n), want)

    valid = np.ones((1, n), bool)
    ki, km = nms_cuda.nms_bitmask(tb, torch.from_numpy(valid), MAX_OUT,
                                  thresh)
    ri, rm = jax_nms_padded(jnp.asarray(boxes[0]),
                            jnp.arange(n, 0, -1, dtype=jnp.float32), MAX_OUT,
                            thresh, valid=jnp.asarray(valid[0]))
    np.testing.assert_array_equal(ki[0].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(km[0].numpy(), np.asarray(rm))


@pytest.mark.parametrize("t", [0.7, 0.5, 0.3, 0.25, 0.01, 0.99])
def test_band_pairs_straddle_the_threshold(t):
    """Each threshold's pairs hold IoUs on both sides of it and within
    2^-16 of it (relative), and pairs at exactly float32(t)."""
    boxes, thresh = CASES[f"band-t={t}-n=4097"]
    iou = chip_smoke.iou32(boxes[0, 0:-1:2], boxes[0, 1::2])
    t32 = np.float32(t)
    near = iou[np.abs(iou.astype(np.float64) - t) <= t * 2.0 ** -16]
    assert thresh == t
    assert (near > t32).any() and (near < t32).any()
    assert (iou == t32).any()


@pytest.mark.cuda
def test_mask_band_cases_on_the_card():
    """The kernel on every band case: its upper words bitwise equal to the
    plain version's, its kept rows equal to ``nms_padded``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mask kernel has no CPU mode")
    from mx_rcnn_tpu_torch.ops.nms import nms_padded
    assert chip_smoke.check_mask_band(nms_cuda, nms_padded,
                                      torch.device("cuda")) == len(CASES)
