"""The evaluation data path of the PyTorch port against the JAX package, on
the CPU: ``voc_ap``/``voc_eval`` (exactly equal APs on seeded detections
with duplicates, difficult objects and empty classes), ``PascalVOC``'s
``gt_roidb`` and its cache, ``write_results`` (byte-identical files), the
synthetic dataset's scorer, ``image_size`` against PIL, the PNG decoder
against ``cv2.imread`` on PNGs that cv2 wrote (gray, RGB, RGBA, odd sizes,
each filter type), ``get_image`` on ``make_mini_voc``'s JPEGs against the
JAX ``get_image``, and ``TestLoader``'s staged batches against the JAX
``TestLoader(device_prep=True)``'s.  Only the tests import cv2 and PIL's
encoder.
"""

import os
import pickle

import cv2
import numpy as np
import pytest

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.image import get_image as j_get_image
from mx_rcnn_tpu.data.loader import TestLoader as JTestLoader
from mx_rcnn_tpu.data.pascal_voc import PascalVOC as JPascalVOC
from mx_rcnn_tpu.data.pascal_voc import parse_voc_rec as j_parse_voc_rec
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSynthetic
from mx_rcnn_tpu.eval.voc_eval import voc_ap as j_voc_ap
from mx_rcnn_tpu.eval.voc_eval import voc_eval as j_voc_eval

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC, parse_voc_rec
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.eval.voc_eval import voc_ap, voc_eval
from tests.fixtures import make_mini_voc

TEST_SET = "2007_minitest"


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaldata")
    make_mini_voc(str(root / "VOCdevkit"))
    # one difficult object in the first test image's annotation
    ann = root / "VOCdevkit" / "VOC2007" / "Annotations" / "001000.xml"
    ann.write_text(ann.read_text().replace("<difficult>0</difficult>",
                                           "<difficult>1</difficult>", 1))
    return root


def both_imdbs(devkit, image_set=TEST_SET):
    vk = str(devkit / "VOCdevkit")
    return (PascalVOC(image_set, str(devkit / "port"), vk),
            JPascalVOC(image_set, str(devkit / "jax"), vk))


def random_dets(rng, imdb, with_dups=True):
    """Per class per image (N, 5) detections around the gt (jittered, so
    some hit and some miss), exact duplicates of some, and classes left
    empty."""
    dets = [[np.zeros((0, 5), np.float32) for _ in range(imdb.num_images)]
            for _ in range(imdb.num_classes)]
    for i in range(imdb.num_images):
        for o in parse_voc_rec(imdb.annotation_path(i)):
            k = imdb.classes.index(o["name"])
            n = rng.randint(1, 4)
            box = np.asarray(o["bbox"], np.float32) + rng.randn(n, 4) * 6
            score = rng.rand(n, 1).astype(np.float32)
            d = np.hstack([box, score]).astype(np.float32)
            if with_dups:
                d = np.vstack([d, d[:1]])            # a duplicate detection
            dets[k][i] = np.vstack([dets[k][i], d])
        k = rng.randint(1, imdb.num_classes)         # a false positive
        fp = np.hstack([rng.rand(1, 2) * 50, 60 + rng.rand(1, 2) * 50,
                        rng.rand(1, 1)]).astype(np.float32)
        dets[k][i] = np.vstack([dets[k][i], fp])
    return dets


@pytest.mark.parametrize("use_07", [True, False], ids=["voc07", "area"])
def test_voc_eval_matches_jax_exactly(devkit, use_07):
    imdb, _ = both_imdbs(devkit)
    recs = {i: parse_voc_rec(imdb.annotation_path(i))
            for i in range(imdb.num_images)}
    assert any(o["difficult"] for r in recs.values() for o in r)
    for seed in range(3):
        dets = random_dets(np.random.RandomState(seed), imdb)
        aps = []
        for k, cls in enumerate(imdb.classes[1:], 1):
            got = voc_eval(dets[k], recs, cls, 0.5, use_07)
            want = j_voc_eval(dets[k], recs, cls, 0.5, use_07)
            assert got == want, (seed, cls)
            aps.append(got)
        assert max(aps) > 0 and min(aps) == 0.0    # hits, and empty classes
    rng = np.random.RandomState(9)
    rec, prec = np.sort(rng.rand(30)), rng.rand(30)
    assert voc_ap(rec, prec, use_07) == j_voc_ap(rec, prec, use_07)


def test_parse_voc_rec_matches_jax(devkit):
    imdb, _ = both_imdbs(devkit)
    for i in range(imdb.num_images):
        path = imdb.annotation_path(i)
        assert parse_voc_rec(path) == j_parse_voc_rec(path)


@pytest.mark.parametrize("image_set", ["2007_trainval", TEST_SET])
def test_gt_roidb_matches_jax(devkit, image_set):
    """Boxes, classes, sizes and every other key equal, for the records and
    their flipped copies; either package reads the other's cache."""
    imdb, jimdb = both_imdbs(devkit, image_set)
    got, want = imdb.gt_roidb(), jimdb.gt_roidb()
    got_f = imdb.append_flipped_images(got)
    want_f = jimdb.append_flipped_images(want)
    assert len(got_f) == len(want_f) == 2 * imdb.num_images
    for g, w in zip(got_f, want_f, strict=True):
        assert set(g) == set(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key
    name = f"voc_{image_set}_gt_roidb.pkl"
    for a, b in (("port", "jax"), ("jax", "port")):
        with open(devkit / a / "cache" / name, "rb") as f:
            mine = pickle.load(f)
        with open(devkit / b / "cache" / name, "rb") as f:
            theirs = pickle.load(f)
        assert pickle.dumps(mine) == pickle.dumps(theirs)


def test_write_results_byte_identical(devkit, tmp_path):
    imdb, jimdb = both_imdbs(devkit)
    dets = random_dets(np.random.RandomState(4), imdb)
    imdb.write_results(dets, str(tmp_path / "port"))
    jimdb.write_results(dets, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 20
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
    assert imdb.evaluate_detections(dets) == jimdb.evaluate_detections(dets)


def test_synthetic_scorer_matches_jax():
    port = SyntheticDataset(num_images=4, num_classes=5, height=64, width=96)
    jax_ = JSynthetic(num_images=4, num_classes=5, height=64, width=96)
    dets = [[None] * 4] + [[np.zeros((0, 5), np.float32)] * 4
                           for _ in range(4)]
    rng = np.random.RandomState(2)
    for i, rec in enumerate(port.gt_roidb()):
        for b, c in zip(rec["boxes"], rec["gt_classes"]):
            d = np.hstack([b + rng.randn(4) * 3, rng.rand(1)])[None]
            dets[c][i] = np.vstack([dets[c][i], d.astype(np.float32)])
    assert port.evaluate_detections(dets) == jax_.evaluate_detections(dets)


def cv2_png(path, img, flt):
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER, flt])
    assert ok
    path.write_bytes(buf.tobytes())


PNG_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
               "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP,
               "avg": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
               "all": cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.mark.parametrize("filt", sorted(PNG_FILTERS))
@pytest.mark.parametrize("shape", [(37, 53), (29, 41, 3), (33, 17, 4),
                                   (1, 1, 3), (6, 1, 3)],
                         ids=["gray", "rgb-odd", "rgba", "1x1", "one-column"])
def test_png_decoder_matches_cv2(tmp_path, shape, filt):
    rng = np.random.RandomState(sum(shape))
    ramp = np.linspace(0, 200, shape[1]).reshape(1, -1, *([1] * (len(shape)
                                                               - 2)))
    img = (rng.rand(*shape) * 50 + ramp).astype(np.uint8)
    path = tmp_path / "im.png"
    cv2_png(path, img, PNG_FILTERS[filt])
    want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    got = timage.get_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timage.get_image(str(path), flipped=True),
                                  want[:, ::-1])
    assert timage.image_size(str(path)) == shape[:2]


def test_png_decoder_refuses_what_it_cannot_read(tmp_path):
    img = np.zeros((4, 5, 3), np.uint16)
    path = tmp_path / "deep.png"
    cv2.imwrite(str(path), img)                      # 16-bit samples
    with pytest.raises(ValueError, match="bit depth 16"):
        timage.get_image(str(path))
    bad = tmp_path / "bad.png"
    data = bytearray((tmp_path / "deep.png").read_bytes())
    data[20] ^= 0xFF                                  # inside IHDR: bad CRC
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        timage.get_image(str(bad))
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(40))
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        timage.get_image(str(tmp_path / "x.bmp"))
    with pytest.raises(FileNotFoundError):
        timage.get_image(str(tmp_path / "missing.jpg"))


def test_get_image_and_image_size_on_jpegs(devkit, tmp_path):
    """make_mini_voc's JPEGs: PIL's pixels through the port equal cv2's
    through the JAX package; the header size equals PIL's.  Also a PNG
    stored under a .jpg name (both packages sniff the content), and a
    progressive JPEG's size."""
    from PIL import Image

    jpg_dir = devkit / "VOCdevkit" / "VOC2007" / "JPEGImages"
    for name in sorted(os.listdir(jpg_dir)):
        path = str(jpg_dir / name)
        np.testing.assert_array_equal(timage.get_image(path),
                                      j_get_image(path))
        with Image.open(path) as im:
            assert timage.image_size(path) == (im.size[1], im.size[0])
    img = np.random.RandomState(0).randint(0, 256, (30, 45, 3), np.uint8)
    cv2_png(tmp_path / "png.jpg", img, PNG_FILTERS["all"])
    np.testing.assert_array_equal(timage.get_image(str(tmp_path / "png.jpg")),
                                  j_get_image(str(tmp_path / "png.jpg")))
    Image.fromarray(img).save(tmp_path / "prog.jpg", progressive=True)
    assert timage.image_size(str(tmp_path / "prog.jpg")) == (30, 45)


def test_get_image_without_pil_names_the_decoder(devkit, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    jpg = devkit / "VOCdevkit" / "VOC2007" / "JPEGImages" / "001000.jpg"
    with pytest.raises(RuntimeError, match="PIL"):
        timage.get_image(str(jpg))


def test_test_loader_matches_jax(devkit):
    """Staged raw uint8, sidecars, im_info, gt, indices and batch_valid
    equal the JAX loader's on its device-prep route, the padded last batch
    included (8 images in batches of 3)."""
    kw = dict(tpu__SCALES=((128, 192),), tpu__MAX_GT=8)
    cfg = generate_config("resnet50", "PascalVOC", **kw)
    jcfg = j_generate_config("resnet50", "PascalVOC", tpu__DEVICE_PREP=True,
                             **kw)
    imdb, jimdb = both_imdbs(devkit)
    got = list(TestLoader(imdb.gt_roidb(), cfg, batch_size=3))
    want = list(JTestLoader(jimdb.gt_roidb(), jcfg, batch_size=3,
                            device_prep=True))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    np.testing.assert_array_equal(got[-1]["batch_valid"], [1, 1, 0])
    np.testing.assert_array_equal(got[-1]["indices"], [6, 7, 7])


def test_test_loader_refuses_a_batch_of_two_orientations(tmp_path):
    cfg = generate_config("resnet50", "PascalVOC",
                          tpu__SCALES=((64, 96),), tpu__MAX_GT=4)
    rec = lambda h, w: {"image_array": np.zeros((h, w, 3), np.uint8),
                        "boxes": np.zeros((0, 4), np.float32),
                        "gt_classes": np.zeros((0,), np.int32)}
    loader = TestLoader([rec(40, 60), rec(60, 40)], cfg, batch_size=2)
    with pytest.raises(ValueError, match="one orientation"):
        next(iter(loader))
    assert [b["images"].shape[1:3] for b in TestLoader(
        [rec(40, 60), rec(60, 40)], cfg, batch_size=1)] == [(64, 96),
                                                            (96, 64)]


def test_smoke_devkit_reads_through_the_port(tmp_path):
    """``chip_smoke.py``'s devkit: its PNG writer (every filter type, one
    per row in turn) decodes exactly, through the port and through cv2,
    and ``PascalVOC`` reads the devkit with both orientations in
    ``TestLoader`` batches of two."""
    import chip_smoke

    img = np.random.RandomState(5).randint(0, 256, (23, 31, 3), np.uint8)
    data = chip_smoke.png_bytes(img)
    np.testing.assert_array_equal(timage.decode_png(data), img)
    (tmp_path / "a.png").write_bytes(data)
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(str(tmp_path / "a.png")), cv2.COLOR_BGR2RGB),
        img)
    devkit = chip_smoke.write_devkit(str(tmp_path), 0)
    imdb = PascalVOC(f"2007_{chip_smoke.EVAL_SPLIT}", str(tmp_path / "data"),
                     devkit)
    roidb = imdb.gt_roidb()
    assert [(r["height"], r["width"]) for r in roidb] == \
        list(chip_smoke.EVAL_SIZES)
    assert all(1 <= len(r["boxes"]) <= 3 for r in roidb)
    cfg = generate_config("resnet50", "PascalVOC", tpu__SCALES=((64, 96),),
                          tpu__MAX_GT=4)
    shapes = [b["images"].shape for b in TestLoader(roidb, cfg, batch_size=2)]
    assert shapes == [(2, 64, 96, 3), (2, 96, 64, 3)]
