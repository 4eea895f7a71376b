"""The assign case matrix (``chip_smoke.assign_cases``) on the CPU.

The oracle is the JAX package's ``assign_reduce_pallas`` in Pallas
interpret mode, image by image.  The port's ``assign_reduce`` CPU route and
the chain of its two kernels' plain versions (``assign_gtmax`` →
``assign_rows`` on CPU tensors) must match it by
``tests/test_assign_fused.py``'s rule: float outputs within ~2 f32 ulp,
argmax and the tie flag exact except where the deciding comparison sits
within an ulp of a tie.  Among themselves the port's plain versions agree
bitwise, and their partials are what the kernels' tiling makes.
``chip_smoke.py`` runs the same cases through the kernels on the card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mx_rcnn_tpu_torch.kernels import assign_cuda
from mx_rcnn_tpu_torch.ops.anchors import all_anchors, generate_anchors
from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps
from tests.test_torch_train_ops import ULP, check_discrete, jax_reduce
from mx_rcnn_tpu.ops.boxes import bbox_overlaps as j_bbox_overlaps

torch.set_num_threads(2)

CASES = chip_smoke.assign_cases(all_anchors, generate_anchors)


def tensors(name):
    return tuple(torch.from_numpy(x) for x in CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_assign_case_matches_jax(name):
    anchors, gt, valid, inside = CASES[name]
    args = tensors(name)
    routed = [x.numpy() for x in assign_cuda.assign_reduce(*args)]
    phase1 = assign_cuda.assign_gtmax(*args)
    chained = [x.numpy() for x in phase1[:3]
               + (assign_cuda.assign_rows(*args, *phase1[2:]),)]
    for b in range(gt.shape[0]):
        j_mx, j_am, j_gm, j_tie = jax_reduce(anchors, gt[b], valid[b],
                                             inside[b])
        ov = np.where(valid[b][None, :], np.asarray(j_bbox_overlaps(
            anchors, gt[b])), -1.0)
        for mx, am, gm, tie in (routed, chained):
            np.testing.assert_allclose(mx[b], j_mx, rtol=0, atol=ULP)
            np.testing.assert_allclose(gm[b], j_gm, rtol=0, atol=ULP)
            check_discrete(ov, j_gm, valid[b], j_am, am[b], f"argmax[{b}]")
            check_discrete(ov, j_gm, valid[b], j_tie, tie[b], f"tie[{b}]")


@pytest.mark.parametrize("name", list(CASES))
def test_assign_plain_versions_chain_to_the_dense_path(name):
    """assign_gtmax's and assign_rows' plain versions, chained, equal
    assign_reduce_plain bitwise; the partials are the per-tile maxima over
    inside anchors (-1 in invalid columns) and reduce to gt_max."""
    args = tensors(name)
    anchors, gt, valid, inside = args
    dense = assign_cuda.assign_reduce_plain(*args)
    phase1 = assign_cuda.gtmax_partials_plain(*args)
    tie = assign_cuda.rows_plain(*args, *phase1[2:])
    for x, y in zip(phase1[:3] + (tie,), dense, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    parts = phase1[3]
    b, g = valid.shape
    n = anchors.shape[0]
    tiles = assign_cuda.n_tiles(n)
    assert parts.shape == (b, tiles, g)
    assert torch.equal(parts.max(dim=1).values, phase1[2])
    assert (parts.transpose(1, 2)[~valid] == -1).all()
    ov = torch.where(valid[:, None, :] & inside[:, :, None],
                     bbox_overlaps(anchors, gt), -1.0)
    for t in range(tiles):
        span = slice(t * assign_cuda.TILE, (t + 1) * assign_cuda.TILE)
        assert torch.equal(parts[:, t], ov[:, span].max(dim=1).values)


def test_assign_cases_are_what_they_say():
    """The cases exercise what their names promise."""
    def reduce(name):
        return assign_cuda.assign_reduce_plain(*tensors(name))

    assert len(CASES["N=135 below one tile"][0]) < assign_cuda.TILE
    assert len(CASES["N=2304 nine tiles"][0]) == 9 * assign_cuda.TILE
    assert len(CASES["0 of 16 gt"][0]) % assign_cuda.TILE
    assert CASES["B=3 with holes"][1].shape[0] == 3
    assert CASES["last of 100 valid"][2][0].tolist() == [False] * 99 + [True]
    mx, am, gm, tie = reduce("none of 100 valid")
    assert (mx == -1).all() and (am == 0).all() and not tie.any()
    _, am, gm, tie = reduce("last of 100 valid")
    assert (am == 99).all() and tie.any() and (gm[0, :99] == -1).all()
    _, am, _, tie = reduce("duplicate gt")
    assert tie.any() and not (am == 1).any()       # ties go to gt 0
    _, _, gm, tie = reduce("all outside")
    assert (gm == -1).all() and not tie.any()
    # the whole-image gt's maximum is reached in several tiles; the copy
    # of an anchor is reached at IoU 1
    name = "gt max tied across tiles"
    _, _, gm, _ = reduce(name)
    parts = assign_cuda.gtmax_partials_plain(*tensors(name))[3]
    assert int((parts[0, :, 0] == gm[0, 0]).sum()) >= 2
    assert gm[0, 1] == 1
    _, _, gm, tie = reduce("gt overlapping nothing")
    assert gm[0, 0] == 0 and gm[0, 1] == 1 and int(tie.sum()) == 1


@pytest.mark.cuda
def test_assign_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the assign kernels have no CPU "
                    "mode")
    n0 = (assign_cuda.assign_gtmax.launches, assign_cuda.assign_rows.launches)
    for name in CASES:
        chip_smoke.check_assign(assign_cuda, name,
                                tuple(x.cuda() for x in tensors(name)))
    assert (assign_cuda.assign_gtmax.launches - n0[0],
            assign_cuda.assign_rows.launches - n0[1]) == (2 * len(CASES),) * 2
