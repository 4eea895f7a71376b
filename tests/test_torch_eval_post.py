"""The device post-process of the PyTorch port against the JAX package, on
the CPU: ``nms_ranked`` (batched over rows) against the JAX ``nms_ranked``
with ``use_pallas`` False and True (off the TPU the Pallas route delegates
to ``nms_padded``), and ``device_postprocess`` + ``device_dets_to_per_class``
against the JAX functions on the same seeded ``rois``/``cls_prob``/
``bbox_deltas``/``im_info``: exact score ties across classes at the cap,
fewer valid rows than the cap, invalid RoIs.  Dets within 1e-5 plus 1e-6
of their magnitude (the two libraries' ``exp`` may differ by a float32 ulp,
3e-5 at a coordinate of 256); the valid mask and the class column exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops import postprocess as jpost
from mx_rcnn_tpu.ops.nms import nms_ranked as j_nms_ranked

from mx_rcnn_tpu_torch.ops import nms as tnms
from mx_rcnn_tpu_torch.ops import postprocess as tpost

torch.set_num_threads(2)


def candidates(rng, rows, n, ties=False):
    ctr = rng.rand(rows, n, 2) * 200
    wh = rng.rand(rows, n, 2) * 60 + 4
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.rand(rows, n).astype(np.float32)
    if ties:   # runs of exactly equal scores
        scores = np.round(scores * 8) / 8
    valid = rng.rand(rows, n) > 0.2
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_nms_ranked_matches_jax(use_kernel, ties):
    rng = np.random.RandomState(3 + ties)
    boxes, scores, valid = candidates(rng, 5, 90, ties)
    valid[2] = False                    # a row with nothing to keep
    valid[3, 5:] = False                # fewer candidates than slots
    max_out, thresh = 24, 0.4
    dets, mask = tnms.nms_ranked(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), max_out, thresh,
                                 valid=torch.from_numpy(valid),
                                 use_kernel=use_kernel)
    for r in range(len(boxes)):
        jd, jm = jax.device_get(j_nms_ranked(
            jnp.asarray(boxes[r]), jnp.asarray(scores[r]), max_out, thresh,
            valid=jnp.asarray(valid[r]), use_pallas=use_kernel))
        np.testing.assert_array_equal(mask[r].numpy(), jm)
        np.testing.assert_allclose(dets[r].numpy(), jd, atol=1e-5, rtol=0)
    assert not mask[2].any() and mask[3].sum() <= 5


def head_outputs(rng, b, r, k, tie_classes=()):
    """Seeded forward outputs: rois in a 300×400 scaled frame, softmax
    scores, deltas, im_info; the classes in ``tie_classes`` carry the
    scores and deltas of class 1 (exact ties across classes)."""
    ctr = rng.rand(b, r, 2) * np.array([400, 300])
    wh = rng.rand(b, r, 2) * 120 + 8
    rois = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    logits = rng.randn(b, r, k).astype(np.float32) * 2
    if tie_classes:
        logits[..., 1] += 3.0          # the tied classes lead the ranking
    for c in tie_classes:
        logits[..., c] = logits[..., 1]
    prob = np.exp(logits - logits.max(-1, keepdims=True))
    prob = (prob / prob.sum(-1, keepdims=True)).astype(np.float32)
    deltas = (rng.randn(b, r, 4 * k) * 0.2).astype(np.float32)
    for c in tie_classes:
        deltas[..., 4 * c:4 * c + 4] = deltas[..., 4:8]
    im_info = np.array([[300, 400, 1.25], [288, 384, 0.8]][:b], np.float32)
    valid = rng.rand(b, r) > 0.1
    return rois, valid, prob, deltas, im_info


CASES = {
    # cap 9 of many: the cut splits a run of equal scores of classes 1, 2
    # and 3
    "ties-across-classes-at-cap": dict(r=60, k=6, ties=(2, 3), thresh=0.05,
                                       mpi=9),
    # fewer valid rows than the cap (a high threshold)
    "fewer-than-cap": dict(r=40, k=5, ties=(), thresh=0.6, mpi=30),
    "no-cap": dict(r=30, k=4, ties=(), thresh=0.1, mpi=0),
}


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_postprocess_matches_jax(case, use_kernel):
    c = CASES[case]
    rng = np.random.RandomState(len(case))
    rois, valid, prob, deltas, im_info = head_outputs(rng, 2, c["r"], c["k"],
                                                      c["ties"])
    valid[1, :] = False if case == "fewer-than-cap" else valid[1, :]
    kw = dict(num_classes=c["k"], thresh=c["thresh"], nms_thresh=0.3,
              max_per_image=c["mpi"])
    jd, jv = jax.device_get(jpost.device_postprocess(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(prob),
        jnp.asarray(deltas), jnp.asarray(im_info), use_pallas=use_kernel,
        **kw))
    td, tv = tpost.device_postprocess(
        *(torch.from_numpy(x) for x in (rois, valid, prob, deltas, im_info)),
        use_kernel=use_kernel, **kw)
    td, tv = td.numpy(), tv.numpy()
    assert td.shape == jd.shape
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td[..., 5], jd[..., 5])
    np.testing.assert_allclose(td, jd, atol=1e-5, rtol=1e-6)
    if case == "fewer-than-cap":
        assert 0 < tv[0].sum() < c["mpi"] and not tv[1].any()
    if case == "ties-across-classes-at-cap":
        # the cut falls inside a run of equal scores of different classes:
        # uncapped, more rows score the last kept score than were kept
        full, fv = tpost.device_postprocess(
            *(torch.from_numpy(x) for x in (rois, valid, prob, deltas,
                                            im_info)),
            **dict(kw, max_per_image=0))
        last = td[0, -1, 4]
        at_cut = full[0][fv[0]].numpy()
        at_cut = at_cut[at_cut[:, 4] == last]
        assert len(at_cut) > (td[0, :, 4] == last).sum()
        assert len(set(at_cut[:, 5].tolist())) > 1
    for b in range(2):
        tpc = tpost.device_dets_to_per_class(td[b], tv[b], c["k"])
        jpc = jpost.device_dets_to_per_class(jd[b], jv[b], c["k"])
        assert tpc[0] is None and jpc[0] is None
        for k in range(1, c["k"]):
            assert tpc[k].dtype == np.float32
            assert tpc[k].shape == jpc[k].shape
            np.testing.assert_allclose(tpc[k], jpc[k], atol=1e-5, rtol=1e-6)


@pytest.mark.cuda
def test_device_postprocess_kernel_route_on_the_card():
    """On the card the per-class rows go through the NMS kernels, one launch
    of each per call, and give what the plain route gives on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NMS kernels have no CPU mode")
    from mx_rcnn_tpu_torch.kernels import nms_cuda

    rng = np.random.RandomState(11)
    arrays = head_outputs(rng, 2, 300, 21, (2, 3))
    kw = dict(num_classes=21, thresh=1e-3, nms_thresh=0.3, max_per_image=100)
    want = tpost.device_postprocess(*(torch.from_numpy(x) for x in arrays),
                                    use_kernel=False, **kw)
    n0 = (nms_cuda.nms_mask.launches, nms_cuda.nms_sweep.launches)
    got = tpost.device_postprocess(*(torch.from_numpy(x).cuda()
                                     for x in arrays), use_kernel=True, **kw)
    assert (nms_cuda.nms_mask.launches - n0[0],
            nms_cuda.nms_sweep.launches - n0[1]) == (1, 1)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               atol=1e-3, rtol=1e-6)
