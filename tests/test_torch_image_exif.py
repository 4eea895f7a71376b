"""EXIF orientation: a JPEG tagged with any Orientation (1-8) decodes
through the port's ``get_image`` to exactly what ``cv2.imread`` gives (the
JAX package's ``get_image``: the tag applied, then BGR→RGB), and
``image_size`` keeps the unrotated header size, as the JAX package's
records take it from PIL's ``size``."""

import numpy as np
import pytest

from mx_rcnn_tpu.data.image import get_image as j_get_image
from mx_rcnn_tpu_torch.data import image as timage


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(tmp_path, orientation):
    from PIL import Image

    rng = np.random.RandomState(orientation)
    img = rng.randint(0, 256, (40, 64, 3), np.uint8)
    img[:10, :20] = (250, 10, 10)  # an asymmetric block: any turn shows
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / f"o{orientation}.jpg")
    Image.fromarray(img).save(path, exif=exif, quality=95)

    got, want = timage.get_image(path), j_get_image(path)
    assert got.shape == want.shape
    assert got.shape == ((64, 40, 3) if orientation >= 5 else (40, 64, 3))
    np.testing.assert_array_equal(got, want)
    assert timage.image_size(path) == (40, 64)
    np.testing.assert_array_equal(timage.get_image(path, flipped=True),
                                  want[:, ::-1])
