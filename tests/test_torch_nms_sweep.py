"""The NMS sweep's case matrix (``chip_smoke.sweep_cases``) on the CPU.

The oracle is the JAX package's ``ops.nms.nms_padded``, which
``nms_pallas`` delegates to off the TPU.  The port's ``nms_bitmask`` CPU
route and ``sweep_plain`` over ``suppression_mask_plain`` (the plain
versions of the two CUDA kernels) must give the same ``keep_idx`` and
``keep_mask`` arrays, padded slots included: this is bit logic, so any
difference is a bug and there is no tolerance.  ``chip_smoke.py`` runs
the same cases through the kernels on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mx_rcnn_tpu.ops.nms import nms_padded as jax_nms_padded
from mx_rcnn_tpu_torch.kernels import nms_cuda

torch.set_num_threads(2)

CASES = chip_smoke.sweep_cases()


def oracle(boxes, valid, max_out, thresh):
    """The JAX package's greedy NMS per image, boxes in index order."""
    n = boxes.shape[1]
    scores = jnp.arange(n, 0, -1, dtype=jnp.float32)
    outs = [jax_nms_padded(jnp.asarray(boxes[b]), scores, max_out, thresh,
                           valid=jnp.asarray(valid[b]))
            for b in range(boxes.shape[0])]
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_case_matches_jax(name):
    boxes, valid, max_out, thresh = CASES[name]
    want_idx, want_mask = oracle(boxes, valid, max_out, thresh)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    words = nms_cuda.suppression_mask_plain(tb, thresh)
    for ki, km in (nms_cuda.nms_bitmask(tb, tv, max_out, thresh),
                   nms_cuda.sweep_plain(words, tv, max_out)):
        np.testing.assert_array_equal(ki.numpy(), want_idx)
        np.testing.assert_array_equal(km.numpy(), want_mask)


def kept(name):
    boxes, valid, max_out, thresh = CASES[name]
    ki, km = oracle(boxes, valid, max_out, thresh)
    return [list(i[m]) for i, m in zip(ki, km)]


def test_sweep_cases_are_what_they_say():
    """The chains alternate, the cuts fall where the names put them."""
    assert kept("chain-cut-inside-a-block") == [list(range(0, 80, 2))]
    assert kept("chain-cut-at-a-block-edge") == [[0] + list(range(1, 64, 2))]
    assert kept("n=4097-chain") == [list(range(0, 4097, 2))]
    assert kept("disjoint-cut-at-64") == [list(range(64))]
    edges = kept("chains-across-63-64-and-127-128")[0]
    assert 63 not in edges and {58, 64, 70, 121, 127, 133} <= set(edges)
    # an invalid row neither is kept nor removes: the parity flips there
    holes = set(kept("invalid-rows-inside-chains")[0])
    assert {58, 60, 63, 65, 67, 69, 70, 125, 128, 130, 132} <= holes
    assert not {62, 64, 66, 68, 126, 127, 129, 133} & holes
    assert kept("invalid-first-row")[0][:3] == [1, 3, 5]
