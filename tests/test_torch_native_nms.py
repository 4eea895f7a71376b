"""The port's native host NMS (``csrc/mxr_native.cpp``: ``mxr_nms``,
``mxr_bbox_overlaps``, bound in ``native.py``) against the JAX package's
native library (its C++ route, built here by g++) and against the port's
numpy ``ops/nms.py:nms``, its oracle, on the CPU.

* ``nms``: equal kept lists on seeded boxes with exact score ties (rows
  in row order), a zero-area and one-pixel (+1-area) boxes, thresholds
  0, 0.3, 0.7 and 1, and 0, 1 and 2 000 rows; against the JAX native one
  also with many zero-area and inverted (x2 < x1) boxes.  There the numpy
  oracle parts from both C++ routes, and by construction: a pair whose
  union is 0 (two zero-area boxes) has IoU 0/0 = NaN in numpy, which
  fails its ``<= thresh`` keep test, while the C++ skips a pair without
  overlap — the JAX package's numpy ``nms`` does the same as the port's
  (pinned below);
* ``bbox_overlaps``: bitwise equal to the JAX native one;
* ``per_class_nms`` at COCO's 81 classes on its default (the native NMS)
  equal to itself with the numpy NMS injected, and to the JAX
  ``per_class_nms`` on the same inputs;
* when the host library cannot be built (no compiler, a compile error),
  ``native.nms`` and the default ``per_class_nms`` raise ``RuntimeError``
  naming ``csrc/mxr_native.cpp``: no numpy fallback.
"""

import numpy as np
import pytest

from mx_rcnn_tpu import native as jnative
from mx_rcnn_tpu.ops import postprocess as jpost

from mx_rcnn_tpu_torch import native
from mx_rcnn_tpu_torch.kernels import _build
from mx_rcnn_tpu_torch.ops import postprocess as post
from mx_rcnn_tpu_torch.ops.nms import nms as np_nms


@pytest.fixture(scope="module")
def jax_native():
    assert jnative.available(), "the JAX native library is the reference"
    assert native.available()
    return jnative


def boxes_with_ties(rng, n: int, degenerate: bool = False) -> np.ndarray:
    """(n, 5) rows: integer corners (exact IoUs at the thresholds too),
    scores from a few levels (many exact ties), one-pixel boxes and one
    zero-area box; ``degenerate``: ~5% zero-area and ~3% inverted boxes."""
    xy = rng.randint(0, 200, (n, 2))
    wh = rng.randint(0, 60, (n, 2))
    dets = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if n > 3:
        one = rng.rand(n) < 0.05
        dets[one, 2:] = dets[one, :2]           # one pixel (+1 area = 1)
        zero = rng.rand(n) < (0.05 if degenerate else 0.0)
        zero[n // 2] = True
        dets[zero, 2] = dets[zero, 0] - 1.0     # zero area under +1 widths
        if degenerate:
            inv = rng.rand(n) < 0.03
            dets[inv, 2] = dets[inv, 0] - 5.0   # x2 < x1
    scores = rng.choice(np.float32([0.2, 0.5, 0.5, 0.9]), n)
    return np.concatenate([dets, scores[:, None]], 1).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 2, 37, 2000])
@pytest.mark.parametrize("thresh", [0.0, 0.3, 0.7, 1.0])
def test_nms_equals_jax_native_and_numpy(jax_native, n, thresh):
    rng = np.random.RandomState(n * 7 + int(thresh * 10))
    dets = boxes_with_ties(rng, n)
    got = native.nms(dets, thresh)
    assert isinstance(got, list) and all(isinstance(i, int) for i in got)
    assert got == jax_native.nms(dets, thresh)
    assert got == np_nms(dets, thresh)
    bad = boxes_with_ties(rng, n, degenerate=True)
    assert native.nms(bad, thresh) == jax_native.nms(bad, thresh)


def test_zero_union_pair_native_keeps_numpy_drops():
    """Two zero-area boxes: the C++ routes keep both (no overlap), the
    numpy NMS of both packages drops the second (IoU 0/0 = NaN)."""
    from mx_rcnn_tpu.ops.nms import nms as j_np_nms

    dets = np.float32([[10, 10, 9, 20, 0.9], [50, 50, 49, 60, 0.8],
                       [0, 0, 30, 30, 0.7]])
    assert native.nms(dets, 0.5) == jnative.nms(dets, 0.5) == [0, 1, 2]
    with np.errstate(invalid="ignore"):
        assert np_nms(dets, 0.5) == j_np_nms(dets, 0.5) == [0, 2]


def test_nms_tie_order_and_identical_boxes():
    """Equal scores keep row order (the stable sort, C.1); identical boxes
    suppress all but the first; a zero-area box overlaps nothing."""
    dets = np.float32([[0, 0, 9, 9, 0.5], [0, 0, 9, 9, 0.5],
                       [20, 20, 29, 29, 0.5], [0, 0, 9, 9, 0.9],
                       [5, 5, 4, 4, 0.9]])
    assert native.nms(dets, 0.3) == np_nms(dets, 0.3) == [3, 4, 2]
    assert native.nms(dets, 1.0) == np_nms(dets, 1.0) == [3, 4, 0, 1, 2]


def test_bbox_overlaps_bitwise_equal_to_jax_native(jax_native):
    rng = np.random.RandomState(3)
    boxes = boxes_with_ties(rng, 300)[:, :4]
    query = boxes_with_ties(rng, 40)[:, :4]
    got = native.bbox_overlaps(boxes, query)
    assert got.dtype == np.float32 and got.shape == (300, 40)
    np.testing.assert_array_equal(got, jax_native.bbox_overlaps(boxes,
                                                                query))
    assert native.bbox_overlaps(boxes[:0], query).shape == (0, 40)


def test_per_class_nms_at_81_classes_native_equals_numpy():
    rng = np.random.RandomState(11)
    r, k = 300, 81
    xy = rng.randint(0, 600, (r, 2))
    wh = rng.randint(8, 200, (r, 2))  # x2 >= x1 after the jitter
    boxes = np.tile(np.concatenate([xy, xy + wh], 1), (1, k)).astype(
        np.float32) + rng.randint(0, 8, (r, 4 * k)).astype(np.float32)
    scores = rng.choice(np.float32([0.0, 0.01, 0.06, 0.3, 0.3, 0.8]),
                        (r, k))
    valid = rng.rand(r) > 0.1
    for cap in (100, 0):
        got = post.per_class_nms(scores, boxes, valid, k, 0.05, 0.5, cap)
        want = post.per_class_nms(scores, boxes, valid, k, 0.05, 0.5, cap,
                                  nms_fn=np_nms)
        ref = jpost.per_class_nms(scores, boxes, valid, k, 0.05, 0.5, cap)
        assert got[0] is None
        n = 0
        for c in range(1, k):
            np.testing.assert_array_equal(got[c], want[c])
            np.testing.assert_array_equal(got[c], ref[c])
            n += len(got[c])
        assert n > 100


@pytest.mark.parametrize("fault", ["no_compiler", "compile_error"])
def test_unbuildable_library_raises_by_name(monkeypatch, tmp_path, fault):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    if fault == "no_compiler":
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    else:
        src = tmp_path / "csrc"
        src.mkdir()
        (src / "mxr_native.cpp").write_text("this is not C++;\n")
        monkeypatch.setattr(_build, "SRC_DIR", src)
    dets = np.float32([[0, 0, 9, 9, 0.9], [1, 1, 9, 9, 0.8]])
    with pytest.raises(RuntimeError, match=r"csrc/mxr_native\.cpp"):
        native.nms(dets, 0.3)
    assert not native.available()
    scores = np.float32([[0.1, 0.9], [0.2, 0.8]])
    boxes = np.tile(dets[:, :4], (1, 2))
    with pytest.raises(RuntimeError, match=r"csrc/mxr_native\.cpp"):
        post.per_class_nms(scores, boxes, np.ones(2, bool), 2, 0.05, 0.3,
                           100)
